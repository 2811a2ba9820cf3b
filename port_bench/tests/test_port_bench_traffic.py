"""The traffic generator: the same inputs for a seed, others for another,
the same sizes for every seed."""

import numpy as np
import pytest
import torch

from port_bench import harness, traffic

MIXES = {n: harness.load_json(harness.BENCH_DIR / "traffic" / f"{n}.json") for n in ("sentences", "long_takes")}
# the training feed's generator, which the reference's training step is tested on
MIXES["train"] = harness.load_json(harness.BENCH_DIR / "tests" / "data" / "traffic" / "train_tiny.json")
SEED = 2**31 + 12345


def test_sentence_lengths_are_the_lognormal_quantiles():
    s = traffic.lengths_s(MIXES["sentences"])
    assert sorted(s)[0] == pytest.approx(1.58, abs=0.01) and max(s) == 10.0
    assert np.mean(s) == pytest.approx(4.47, abs=0.01)
    assert sorted(s) != s  # a fixed order, not sorted


@pytest.mark.parametrize("mix", ["sentences", "long_takes"])
def test_request_clips_repeat_for_a_seed_and_change_with_it(mix):
    spec = dict(MIXES[mix], lengths_s=[1.0, 2.0, 0.5])
    a, b, c = (traffic.request_clips(spec, s, 32) for s in (SEED, SEED, SEED + 1))
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x.wave, y.wave) and np.array_equal(x.latents, y.latents)
        assert not np.array_equal(x.wave, z.wave) and not np.array_equal(x.latents, z.latents)
        assert x.frames == z.frames == int(len(x.wave) / 16000 * 60) and len(x.wave) % 800 == 0
        assert x.latents.shape == (1, x.frames, 32)


def test_checked_positions_hold_the_longest():
    clips = traffic.request_clips(dict(MIXES["long_takes"], lengths_s=[2.0, 5.0, 8.0, 3.5, 6.5]), SEED, 4)
    for seed in range(5):
        pos = traffic.checked_positions(MIXES["long_takes"], seed, clips)
        assert len(pos) == 2 and 2 in pos
    assert traffic.checked_positions(MIXES["sentences"], SEED, clips) == list(range(5))


def test_train_windows_are_the_same_for_every_seed():
    spec = MIXES["train"]
    w = traffic.train_windows(spec)
    assert w == traffic.train_windows(spec) and len(w) == spec["cycle_steps"]
    assert all(spec["window_min"] <= x <= 600 for x in w)


def test_train_batches_repeat_for_a_seed_and_change_with_it():
    spec = dict(MIXES["train"], batch=2, cycle_steps=3)
    a, b, c = (traffic.train_batches(spec, s, 32, torch.device("cpu")) for s in (SEED, SEED, SEED + 7))
    assert sorted(x["window_real"] for x in a) == sorted(x["window_real"] for x in c)
    for x, y in zip(a, b):
        for k in ("waveform", "coeffs", "cond", "mask_time_indices"):
            assert torch.equal(x[k], y[k])
        assert x["coeffs"].shape[1] % spec["window_bucket"] == 0
        assert x["waveform"].shape[1] >= x["input_length"] == spec["sampling_rate"] * x["window_real"] // 60
        assert not x["mask_time_indices"][:, x["window_real"]:].any()
    assert any(not torch.equal(x["coeffs"], z["coeffs"]) for x, z in zip(a, c))


def test_time_mask_spans():
    m = traffic.time_mask(np.random.default_rng(0), 3, 150, 0.05, 10, 2)
    assert m.shape == (3, 150) and (m.sum(axis=1) >= 10).all() and (m.sum(axis=1) <= 20).all()
