"""Where the time of a denoise step goes on the card.

    python -m said_tpu_torch.profile_step [--repeats 5] [--out profile_step.json]

One cell per clip length (10 s and 30 s: 600 and 1800 frames) and
compute dtype (float32, bfloat16): the full-width SAID
(wav2vec2-base + the 192-channel UNet) with random weights from seed 0,
synthetic audio, batch 1 with CFG 2.0 (the UNet runs at batch 2 after its
first cross-attention). Per cell and repeat:

- ``prepare_ms``: ``SAIDPipeline.prepare`` (encoder, null embedding, K/V
  caches, timestep table) on the host clock, synchronised;
- ``step_ms``: the DDIM chain of ``STEPS`` steps (``diffusion.sampler``
  with the pipeline's denoiser), host clock over the chain / steps;
- under ``torch.profiler``, ``PROFILE_STEPS`` more steps:
  ``device_busy_ms`` per step (sum of the card's kernel and copy
  durations; the port runs one stream, so they do not overlap),
  ``launches`` per step, and device ms per step by kernel family.

``idle_share`` = 1 − device_busy_ms / step_ms (the profiled steps are
slower on the host, so the unprofiled step time is the denominator).
Repeats run interleaved over the cells; medians are printed, every
reading goes to ``--out`` as JSON. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from said_tpu_torch.cli._common import build_said_model, configure_precision, random_init_
from said_tpu_torch.diffusion.sampler import SamplerConfig, sample
from said_tpu_torch.models.said import SAMPLING_RATE, SAIDPipeline, process_audio

FPS = 60
CLIPS_S = (10.0, 30.0)
DTYPES = ("float32", "bfloat16")
STEPS, PROFILE_STEPS = 300, 20

# (substring of the lower-cased device event name, family); first match wins
FAMILIES = (
    ("geglu", "geglu_ffn (ours)"),
    ("_group_norm_fwd", "group_norm (ours)"),
    ("_layer_norm_fwd", "layer_norm (ours)"),
    ("strided_conv", "strided_conv_gelu (ours)"),
    ("gemm", "cuBLAS GEMM/GEMV"),
    ("gemv", "cuBLAS GEMM/GEMV"),
    ("nvjet", "cuBLAS GEMM/GEMV"),  # cuBLAS's Hopper tensor-core kernels
    ("softmax", "softmax"),
    ("catarray", "cat"),
    ("copy", "copy/cast"),
    ("memcpy", "copy/cast"),
    ("memset", "memset"),
    ("reduce", "reduce"),
    ("index", "gather/index"),
)


def family(name: str) -> str:
    lower = name.lower()
    for key, fam in FAMILIES:
        if key in lower:
            return fam
    return "elementwise/other"


class Cell:
    """One (clip, dtype) configuration with its prepared state."""

    def __init__(self, seconds: float, dtype: str, model):
        self.name = f"{dtype}_{seconds:g}s"
        self.pipe = SAIDPipeline(model)
        rng = np.random.default_rng(0)
        n = int(seconds * SAMPLING_RATE)
        t = np.arange(n) / SAMPLING_RATE
        voice = np.sin(2 * np.pi * 140 * t) * (1 + np.sin(2 * np.pi * 3 * t)) + 0.1 * rng.standard_normal(n)
        self.wave = torch.from_numpy(process_audio(voice.astype(np.float32))).cuda()
        self.frames = int(n / SAMPLING_RATE * FPS)
        self.latents = torch.from_numpy(rng.standard_normal((1, self.frames, 32)).astype(np.float32)).cuda()
        self.kv, self.table = self.prepare()

    def prepare(self):
        return self.pipe.prepare(self.wave, self.frames, True)

    @torch.no_grad()
    def chain(self, steps: int):
        unet, kv, table = self.pipe.model.unet, self.kv, self.table

        def denoise_fn(x, t):
            return unet(x, kv_caches=kv, emb=table[t], cfg_fold=True)

        config = SamplerConfig(num_inference_steps=steps, guidance_scale=2.0)
        return sample(self.pipe.schedule, denoise_fn, self.latents, config, cfg_folded=True)[0]


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profiled_step(cell: Cell, steps: int) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cell.chain(steps)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return {"device_busy_ms": None, "launches": None, "by_family_ms": None}
    by_family = {}
    for e in events:
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    return {
        "device_busy_ms": sum(by_family.values()),
        "launches": len(events) / steps,
        "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu)
    configure_precision("float32")
    cells = []
    for dtype in DTYPES:
        model = random_init_(build_said_model(dtype=dtype), seed=0).cuda().eval()
        cells += [Cell(s, dtype, model) for s in CLIPS_S]
    for cell in cells:  # warm-up: Triton compiles, cuBLAS heuristics, allocator
        cell.chain(5)
    readings = {c.name: [] for c in cells}
    for _ in range(args.repeats):
        for cell in cells:
            r = {"prepare_ms": host_ms(cell.prepare),
                 "step_ms": host_ms(lambda: cell.chain(STEPS)) / STEPS}
            r.update(profiled_step(cell, PROFILE_STEPS))
            readings[cell.name].append(r)

    summary = {}
    for name, rs in readings.items():
        med = {k: statistics.median(r[k] for r in rs) for k in ("prepare_ms", "step_ms")}
        med["step_ms_range"] = [min(r["step_ms"] for r in rs), max(r["step_ms"] for r in rs)]
        if rs[0]["device_busy_ms"] is not None:
            med["device_busy_ms"] = statistics.median(r["device_busy_ms"] for r in rs)
            med["launches"] = statistics.median(r["launches"] for r in rs)
            med["idle_share"] = 1.0 - med["device_busy_ms"] / med["step_ms"]
            fams = sorted({f for r in rs for f in r["by_family_ms"]})
            med["by_family_ms"] = {f: statistics.median(r["by_family_ms"].get(f, 0.0) for r in rs) for f in fams}
        summary[name] = med
        print(name, json.dumps(med))
    result = {"gpu": gpu, "args": vars(args), "summary": summary, "readings": readings}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
