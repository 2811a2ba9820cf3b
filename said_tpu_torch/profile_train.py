"""Where the time of a training step goes on the card.

    python -m said_tpu_torch.profile_train [--repeats 3] [--steps 10] [--out profile_train.json]

One cell per compute dtype (float32, bfloat16): the full-width SAID
(wav2vec2-base frozen in train mode, the 192-channel UNet trainable) with
random weights from seed 0, one synthetic batch as the training CLI makes
it by default: 8 rows of a 300-frame window (5 s) padded to the
8-frame bucket (304 frames), spec-augment time masks, CFG dropout at 0.1.
Each repeat, per cell, in turns:

- ``step_ms``: ``train_step`` (loss, gradients, optimizer update, EMA),
  host clock over ``--steps`` steps, synchronised, / steps;
- under ``torch.profiler``, 3 more steps: ``device_busy_ms`` a step (the
  card's kernel and copy durations; one stream, so they do not overlap),
  ``launches`` a step, and device ms a step by kernel family
  (``profile_step.family``).

``idle_share`` = 1 − device_busy_ms / step_ms. Medians are printed, every
reading goes to ``--out`` as JSON; before the repeats, one step of each
cell is profiled on the host alone and its operators printed by self CPU
time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from said_tpu_torch.cli._common import build_said_model, configure_precision, random_init_
from said_tpu_torch.diffusion.schedule import DiffusionSchedule
from said_tpu_torch.models.said import SAMPLING_RATE, process_audio
from said_tpu_torch.models.wav2vec2 import compute_time_mask_indices
from said_tpu_torch.profile_step import device_profile, host_ms
from said_tpu_torch.train.said_train import TrainConfig, TrainState, train_step

FPS = 60
BATCH, WINDOW, BUCKET = 8, 300, 8
PROFILE_STEPS = 3


def make_batch(device) -> dict:
    """``said_loss``'s inputs for one bucketed batch, as the CLI builds them."""
    rng = np.random.default_rng(0)
    n = WINDOW * SAMPLING_RATE // FPS
    frames = -(-WINDOW // BUCKET) * BUCKET
    wave = process_audio(0.1 * rng.standard_normal((BATCH, n)).astype(np.float32))
    wave = np.pad(wave, ((0, 0), (0, -(-frames * SAMPLING_RATE // FPS) - n)))
    coeffs = np.pad(rng.uniform(0, 1, (BATCH, WINDOW, 32)).astype(np.float32), ((0, 0), (0, frames - WINDOW), (0, 0)))
    mask = np.pad(compute_time_mask_indices((BATCH, WINDOW), rng=rng), ((0, 0), (0, frames - WINDOW)))

    def dev(a):
        return torch.from_numpy(a).to(device)

    return {"waveform": dev(wave), "coeffs": dev(coeffs), "cond": dev(rng.uniform(size=BATCH) > 0.1), "std": None,
            "blendshape_delta": None, "mask_time_indices": dev(mask), "window_real": WINDOW, "input_length": n}


def make_cell(dtype: str, device) -> tuple:
    """A train state of the full-width model in ``dtype`` (random weights
    from seed 0) and its dropout generator."""
    model = random_init_(build_said_model(dtype=dtype), seed=0).to(device)
    return TrainState(model, TrainConfig()), torch.Generator(device=device).manual_seed(0)


def run_steps(cell: tuple, schedule: DiffusionSchedule, batch: dict, k: int) -> None:
    state, gen = cell
    for _ in range(k):
        train_step(state, schedule, batch, gen)


def step_ms(cell: tuple, schedule: DiffusionSchedule, batch: dict, k: int) -> float:
    """Host ms a train step over ``k`` steps, synchronised before and after."""
    return host_ms(lambda: run_steps(cell, schedule, batch, k)) / k


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu)
    configure_precision("float32")
    device = torch.device("cuda")
    schedule = DiffusionSchedule.create(1000)
    batch = make_batch(device)
    cells = {dtype: make_cell(dtype, device) for dtype in ("float32", "bfloat16")}
    for cell in cells.values():  # warm-up: cuBLAS heuristics, Triton, the allocator
        run_steps(cell, schedule, batch, 3)

    for name, cell in cells.items():  # what the host spends a step on, by operator
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run_steps(cell, schedule, batch, 1)
        print(f"{name}: host time of one step by operator (self CPU)")
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))

    readings = {name: [] for name in cells}
    for _ in range(args.repeats):
        for name, cell in cells.items():
            r = {"step_ms": step_ms(cell, schedule, batch, args.steps)}
            r.update(device_profile(lambda cell=cell: run_steps(cell, schedule, batch, PROFILE_STEPS), PROFILE_STEPS))
            readings[name].append(r)

    summary = {}
    for name, rs in readings.items():
        med = {"step_ms": statistics.median(r["step_ms"] for r in rs),
               "step_ms_range": [min(r["step_ms"] for r in rs), max(r["step_ms"] for r in rs)]}
        profiled = [r for r in rs if r["device_busy_ms"] is not None]
        if profiled:
            med["device_busy_ms"] = statistics.median(r["device_busy_ms"] for r in profiled)
            med["launches"] = statistics.median(r["launches"] for r in profiled)
            med["idle_share"] = 1.0 - med["device_busy_ms"] / med["step_ms"]
            fams = sorted({f for r in profiled for f in r["by_family_ms"]})
            med["by_family_ms"] = dict(sorted(
                ((f, statistics.median(r["by_family_ms"].get(f, 0.0) for r in profiled)) for f in fams),
                key=lambda kv: -kv[1]))
        summary[name] = med
        print(name, json.dumps(med))
    result = {"gpu": gpu, "args": vars(args), "batch": BATCH, "window": WINDOW, "summary": summary,
              "readings": readings}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
