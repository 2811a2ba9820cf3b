"""The plain reference against the program (said_tpu_torch, its plain
twins on the CPU) at the tiny configuration, on one set of weights."""

import statistics

import numpy as np
import pytest
import torch

from port_bench import harness, program, traffic
from port_bench.reference import sample
from port_bench.reference import train as ref_train
from port_bench.reference.said import Precision
from port_bench.weights import make_weights, reference_model

DATA = harness.BENCH_DIR / "tests" / "data"
CFG = harness.load_json(DATA / "configs" / "tiny.json")
CPU = torch.device("cpu")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def weights():
    return make_weights(CFG, 2**31 + 99, CPU)


def test_state_dict_names_agree(weights):
    model = program.build_model(CFG, weights, CPU)
    assert set(model.state_dict()) == set(weights)


def test_weights_follow_the_rule(weights):
    assert all(float(v.abs().max()) == 0 for k, v in weights.items() if k.endswith("bias"))
    w = weights["denoiser.model.middle_block.1.transformer_blocks.0.attn1.to_q.weight"]
    assert float(w.std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(weights["denoiser.model.out.0.weight"], torch.ones(192))


def test_serving_agrees(weights):
    model = program.build_model(CFG, weights, CPU)
    pipe = program.pipeline(model)
    clip = traffic.request_clips({"lengths_s": [0.5], "fps": 60, "sampling_rate": 16000}, 7, 32)[0]
    got = {}
    inner = model.get_audio_embedding
    model.get_audio_embedding = lambda *a, **k: got.setdefault("emb", inner(*a, **k))
    out = pipe.inference(program.process_audio(clip.wave), latents=clip.latents, num_inference_steps=4,
                         guidance_scale=2.0, solver="dpmpp_2m").result[0]
    ref = reference_model(CFG, weights, CPU)
    wave = torch.from_numpy(sample.normalise(clip.wave))
    emb = sample.embed(ref, wave, clip.frames, Precision())
    coeffs = sample.generate(ref, emb, torch.from_numpy(clip.latents), 4, 2.0, Precision())[0].numpy()
    assert rel(got["emb"], emb) < 1e-5
    assert np.abs(out - coeffs).max() < 1e-4
    low = sample.generate(ref, sample.embed(ref, wave, clip.frames, Precision("fp8")), torch.from_numpy(clip.latents),
                          4, 2.0, Precision("fp8"))[0].numpy()
    assert np.abs(low - coeffs).max() > 100 * np.abs(out - coeffs).max()


def leaf_gaps(mine: dict, ref: dict, names) -> dict:
    """Each leaf's gap between the two sides' norms, over the larger of the
    reference leaf's norm and the median reference leaf's."""
    norms = {n: float(ref[n].norm()) for n in names}
    floor = statistics.median(norms.values())
    return {n: abs(float(mine[n].norm()) - norms[n]) / max(norms[n], floor, 1e-30) for n in names}


def test_training_agrees(weights):
    spec = harness.load_json(DATA / "traffic" / "train_tiny.json")
    batches = traffic.train_batches(spec, 5, 32, CPU)[:2]
    model = program.build_model(CFG, weights, CPU)
    state, schedule = program.train_state(model, spec["optimizer"])
    gen = torch.Generator().manual_seed(3)
    losses = [program.train_step(state, schedule, b, gen)["loss"] for b in batches]
    ref = ref_train.run_steps(reference_model(CFG, weights, CPU), batches, torch.Generator().manual_seed(3),
                              Precision())
    assert losses == pytest.approx(ref["losses"], rel=1e-6)
    params = state.state_dict()["model"]
    names = list(ref["after"])
    gaps = leaf_gaps({n: params[n] - weights[n] for n in names},
                     {n: ref["after"][n] - ref["before"][n] for n in names}, names)
    assert max(gaps.values()) < 1e-3
