"""Where the time of a denoise step goes on the card.

    python -m said_tpu_torch.profile_step [--repeats 5] [--out profile_step.json]
        [--cells float32_30s float32_60s] [--split_min_t 1024 100000]

One cell per clip length (10 s, 30 s, 60 s and 6 min: 600, 1800, 3600
and 21600 frames; the last two are past the dense limit, so their
self-attention runs the flash kernel, and the 6-min clip's encoder runs 12
flash layers at 12×64 in its prepare) and compute dtype (float32,
bfloat16): the full-width SAID
(wav2vec2-base + the 192-channel UNet) with random weights from seed 0,
synthetic audio, batch 1 with CFG 2.0 (the UNet runs at batch 2 after its
first cross-attention). One more cell is the eval protocol's batch in
length-bucketed mode: 8 copies of a 4.3-s clip (258 real frames) in a
512-frame bucket (``--length_bucket 256``), CFG 2.0, float32, so every
GroupNorm is the masked kernel. Per cell and repeat:

- ``prepare_ms``: ``SAIDPipeline.prepare`` (encoder, null embedding, K/V
  caches, timestep table) on the host clock, synchronised; then one more
  prepare under ``torch.profiler``: ``prepare_device_busy_ms`` and
  ``prepare_by_family_ms``, device ms by kernel family (the strided
  conv, LayerNorm and flash attention of the encoder among them);
- ``step_ms``: the DDIM chain of ``STEPS`` steps (``diffusion.sampler``
  with the pipeline's denoiser), host clock over the chain / steps; the
  6-min cells, whose step is some 10× longer, run ``LONG_STEPS`` (a
  DPM++ step calls the UNet as a DDIM step does);
- under ``torch.profiler``, ``PROFILE_STEPS`` (6 min: ``LONG_PROFILE_STEPS``) more steps:
  ``device_busy_ms`` per step (sum of the card's kernel and copy
  durations; the port runs one stream, so they do not overlap),
  ``launches`` per step, and device ms per step by kernel family.

``idle_share`` = 1 − device_busy_ms / step_ms (the profiled steps are
slower on the host, so the unprofiled step time is the denominator).
Repeats run interleaved over the cells; medians are printed, every
reading goes to ``--out`` as JSON. ``--cells`` runs only the cells named.
``--split_min_t`` compares GroupNorm plans: each cell runs once per value,
in turns, with rows longer than that many frames split in two launches
(``ops.norms._SPLIT_MIN_T``), and its readings are named with the value.
Needs a CUDA card.
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
from said_tpu_torch.ops import norms

FPS = 60
CLIPS_S = (10.0, 30.0, 60.0, 360.0)
DTYPES = ("float32", "bfloat16")
# the eval batch: (clip seconds, batch, length bucket), float32 only
EVAL_CELL = (4.3, 8, 256)
STEPS, PROFILE_STEPS = 300, 20
LONG_S, LONG_STEPS, LONG_PROFILE_STEPS = 360.0, 30, 5

# (substring of the lower-cased device event name, family); first match wins
FAMILIES = (
    ("flash_attention", "flash_attention (ours)"),
    ("geglu", "geglu_ffn (ours)"),
    # said::group_norm_kernel<…> (one launch), or the split's _group_norm_stats + _group_norm_apply
    ("group_norm", "group_norm (ours, plain or masked)"),
    # said::layer_norm_vec_kernel / layer_norm_scalar_kernel (csrc/layer_norm.cu);
    # also a checkout's Triton _layer_norm_fwd, for comparisons with it
    ("layer_norm", "layer_norm (ours)"),
    # said::strided_conv_gelu_{bf16,f32,fma}_kernel
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


def cell_name(seconds: float, dtype: str, batch: int = 1, bucket: int = 0) -> str:
    return f"{dtype}_{seconds:g}s" + (f"_b{batch}_bucket{bucket}" if bucket else "")


def set_split_min_t(t: int) -> None:
    """Rows longer than ``t`` frames take the two-launch GroupNorm plan."""
    norms._SPLIT_MIN_T = t
    norms.group_norm_plan.cache_clear()


class Cell:
    """One (clip, dtype, batch, bucket) configuration with its prepared
    state; ``bucket`` > 0 pads the window to a multiple of it and runs
    length-bucketed mode, as ``SAIDPipeline.inference`` does."""

    def __init__(self, seconds: float, dtype: str, model, batch: int = 1, bucket: int = 0):
        self.name = cell_name(seconds, dtype, batch, bucket)
        long = seconds >= LONG_S
        self.steps, self.profile_steps = (LONG_STEPS, LONG_PROFILE_STEPS) if long else (STEPS, PROFILE_STEPS)
        self.pipe = SAIDPipeline(model)
        rng = np.random.default_rng(0)
        n = int(seconds * SAMPLING_RATE)
        t = np.arange(n) / SAMPLING_RATE
        voice = np.sin(2 * np.pi * 140 * t) * (1 + np.sin(2 * np.pi * 3 * t)) + 0.1 * rng.standard_normal(n)
        wave = np.repeat(process_audio(voice.astype(np.float32)), batch, axis=0)
        self.frames = int(n / SAMPLING_RATE * FPS)
        self.real = (None, None)  # real samples and frames in bucketed mode
        if bucket:
            self.real = (n, self.frames)
            self.frames = -(-self.frames // bucket) * bucket
            wave = np.pad(wave, ((0, 0), (0, -(-self.frames * SAMPLING_RATE // FPS) - n)))
        self.wave = torch.from_numpy(wave).cuda()
        self.latents = torch.from_numpy(rng.standard_normal((batch, self.frames, 32)).astype(np.float32)).cuda()
        self.kv, self.table = self.prepare()

    def prepare(self):
        return self.pipe.prepare(self.wave, self.frames, True, *self.real)

    @torch.no_grad()
    def chain(self, steps: int):
        unet, kv, table, real = self.pipe.model.unet, self.kv, self.table, self.real[1]

        def denoise_fn(x, t):
            return unet(x, kv_caches=kv, emb=table[t], cfg_fold=True, seq_len_real=real)

        config = SamplerConfig(num_inference_steps=steps, guidance_scale=2.0)
        return sample(self.pipe.schedule, denoise_fn, self.latents, config, cfg_folded=True)[0]


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_profile(fn, calls: int = 1) -> dict:
    """Device ms a call of ``fn`` (run ``calls`` times) under the profiler:
    busy, launches and by kernel family; None where it saw no device event."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return {"device_busy_ms": None, "launches": None, "by_family_ms": None}
    by_family = {}
    for e in events:
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return {
        "device_busy_ms": sum(by_family.values()),
        "launches": len(events) / calls,
        "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
    }


def profiled_step(cell: Cell, steps: int) -> dict:
    return device_profile(lambda: cell.chain(steps), steps)


def profiled_prepare(cell: Cell) -> dict:
    p = device_profile(cell.prepare)
    return {"prepare_device_busy_ms": p["device_busy_ms"], "prepare_by_family_ms": p["by_family_ms"]}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--out", type=str, default="")
    parser.add_argument("--cells", nargs="+", default=None, metavar="NAME",
                        help="run only these cells (names as printed, e.g. float32_60s)")
    parser.add_argument("--split_min_t", type=int, nargs="+", default=None, metavar="T",
                        help="GroupNorm plans to compare, in turns: rows longer than T frames split")
    args = parser.parse_args(argv)
    specs = []  # (seconds, dtype, batch, bucket)
    for dtype in DTYPES:
        specs += [(s, dtype, 1, 0) for s in CLIPS_S]
        if dtype == "float32":
            seconds, batch, bucket = EVAL_CELL
            specs.append((seconds, dtype, batch, bucket))
    if args.cells:
        unknown = set(args.cells) - {cell_name(*s) for s in specs}
        if unknown:
            parser.error(f"unknown cells {sorted(unknown)}; known: {[cell_name(*s) for s in specs]}")
        specs = [s for s in specs if cell_name(*s) in args.cells]
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu)
    configure_precision("float32")
    models, cells = {}, []
    for seconds, dtype, batch, bucket in specs:
        if dtype not in models:
            models[dtype] = random_init_(build_said_model(dtype=dtype), seed=0).cuda().eval()
        cells.append(Cell(seconds, dtype, models[dtype], batch, bucket))
    shipped = norms._SPLIT_MIN_T
    plans = args.split_min_t or [shipped]
    runs = [(c.name if args.split_min_t is None else f"{c.name}_split_min_t{t}", c, t) for c in cells for t in plans]
    for _, cell, t in runs:  # warm-up: Triton compiles, cuBLAS heuristics, allocator
        set_split_min_t(t)
        cell.chain(5)
    readings = {name: [] for name, _, _ in runs}
    for _ in range(args.repeats):
        for name, cell, t in runs:
            set_split_min_t(t)
            r = {"prepare_ms": host_ms(cell.prepare),
                 "step_ms": host_ms(lambda: cell.chain(cell.steps)) / cell.steps}
            r.update(profiled_step(cell, cell.profile_steps))
            r.update(profiled_prepare(cell))
            readings[name].append(r)
    set_split_min_t(shipped)

    summary = {}
    for name, rs in readings.items():
        med = {k: statistics.median(r[k] for r in rs) for k in ("prepare_ms", "step_ms")}
        med["step_ms_range"] = [min(r["step_ms"] for r in rs), max(r["step_ms"] for r in rs)]
        profiled = [r for r in rs if r["device_busy_ms"] is not None]  # the profiler may return no device events
        med["profiled_repeats"] = len(profiled)
        if profiled:
            med["device_busy_ms"] = statistics.median(r["device_busy_ms"] for r in profiled)
            med["launches"] = statistics.median(r["launches"] for r in profiled)
            med["idle_share"] = 1.0 - med["device_busy_ms"] / med["step_ms"]
            fams = sorted({f for r in profiled for f in r["by_family_ms"]})
            med["by_family_ms"] = {f: statistics.median(r["by_family_ms"].get(f, 0.0) for r in profiled)
                                   for f in fams}
        prepared = [r for r in rs if r["prepare_device_busy_ms"] is not None]
        if prepared:
            med["prepare_device_busy_ms"] = statistics.median(r["prepare_device_busy_ms"] for r in prepared)
            fams = sorted({f for r in prepared for f in r["prepare_by_family_ms"]})
            med["prepare_by_family_ms"] = {f: statistics.median(r["prepare_by_family_ms"].get(f, 0.0)
                                                                for r in prepared) for f in fams}
        summary[name] = med
        print(name, json.dumps(med))
    result = {"gpu": gpu, "args": vars(args), "summary": summary, "readings": readings}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
