"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no try/except around them):

1. Environment: torch/CUDA versions, the card's name and power limit;
   build the CUDA C++ kernels from ``said_tpu_torch/csrc`` and compile the
   Triton kernels, with their build times.
2. Every kernel of the main path against its plain PyTorch twin on the
   card, at the main path's shapes and at ragged ones, in float32 and
   bfloat16: max |kernel − plain| ≤ 1e-4 · max|plain| (f32) or
   2e-2 · max|plain| (bf16), in the working type; median CUDA-event times
   of kernel and twin, measured in turns.
3. One request through the real CLI ``main(argv)``: a synthetic 10-s WAV
   (600 frames), 1000 DDIM steps, CFG 2.0, float32, random weights from
   seed 0. The CSV must hold 600 rows under the 32 ARKit names, finite and
   in [0, 1]; the launch counters, zeroed just before, must read exactly
   GroupNorm 15·1000+1, LayerNorm 12·1000+26, GEGLU 4·1000, conv 6.
4. Card against CPU: the same seeded weights and injected latents on a
   4-s clip, 20 steps, through ``SAIDPipeline`` on cuda (kernels) and on
   cpu (plain twins): coefficient MAE ≤ 1e-4 and max ≤ 1e-3, with a
   denoiser output std > 1e-3 so the comparison cannot pass vacuously.
5. bfloat16 against float32 on the card, on phase 4's weights, clip and
   latents: the audio embedding and one CFG-folded denoiser call (t=999)
   computed in bf16 must lie within BF16_BOUND of the f32 results,
   relative to max |f32|. This catches a bf16 fault outside the kernels
   (casts, attention, the null embedding, the K/V caches), which the
   per-kernel checks cannot see.
6. A bfloat16 request (4-s clip, 100 steps): finite and in [0, 1]; its
   MAE against the float32 card run of the same request is printed. (The
   100-step chain amplifies rounding, so this number is not a check.)

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(2)

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from said_tpu_torch import _build  # noqa: E402
from said_tpu_torch.cli import inference as cli  # noqa: E402
from said_tpu_torch.cli._common import (  # noqa: E402
    ARKIT_BLENDSHAPES,
    build_said_model,
    configure_precision,
    random_init_,
)
from said_tpu_torch.models.said import SAIDPipeline, process_audio  # noqa: E402
from said_tpu_torch.ops import conv, ffn, norms  # noqa: E402

DEV = torch.device("cuda")
WORK = os.path.join(REPO, "build", "chip_smoke")
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 against f32 end to end (phase 5), relative to max |f32|: read 1.8e-2
# (embedding) and 1.2e-2 (denoiser) on an H100 and 2.3e-2 / 1.2e-2 on the
# CPU twins; a bf16 fault outside the kernels read 1.3e-1 on the CPU
BF16_BOUND = {"audio embedding": 5e-2, "denoiser output": 3e-2}
SR, FPS = 16000, 60

KERNELS = {  # name -> (wrapper, route, source, the TPU kernel it replaces: file:line, function)
    "group_norm": (norms.group_norm_kernel, "triton", "said_tpu_torch/ops/norms.py",
                   "said_tpu/ops/pallas_norms.py:79", "group_norm_pallas"),
    "layer_norm": (norms.layer_norm_kernel, "triton", "said_tpu_torch/ops/norms.py",
                   "said_tpu/ops/pallas_norms.py:441", "layer_norm_pallas"),
    "geglu_ffn": (ffn.geglu_ffn_kernel, "cuda", "said_tpu_torch/csrc/geglu_ffn.cu",
                  "said_tpu/ops/pallas_ffn.py:87", "geglu_ffn_pallas"),
    "strided_conv_gelu": (conv.strided_conv_gelu_kernel, "cuda", "said_tpu_torch/csrc/strided_conv_gelu.cu",
                          "said_tpu/ops/pallas_conv.py:133", "strided_conv_gelu_pallas"),
}


def check(ok, message):
    """Fail the run (a check that survives ``python -O``, unlike assert)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def randn(shape, seed, dtype=torch.float32, scale=1.0, offset=0.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale + offset
    return torch.from_numpy(a.astype(np.float32)).to(DEV, dtype)


def timed_pair(kernel_fn, plain_fn, iters=15, warmup=3):
    """Median CUDA-event milliseconds of kernel and plain, taken in turns."""
    for _ in range(warmup):
        kernel_fn()
        plain_fn()
    times = {"kernel": [], "plain": []}
    for _ in range(iters):
        for name, fn in (("plain", plain_fn), ("kernel", kernel_fn)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return float(np.median(times["kernel"])), float(np.median(times["plain"]))


def kernel_cases():
    """(kernel name, label, kernel thunk, plain thunk, headline?) per check."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        for i, shape in enumerate([(2, 600, 192), (1, 600, 512), (1, 600, 768), (2, 37, 192)]):
            c = shape[-1]
            x, w, b = randn(shape, 1, dt, 2.0, 0.5), randn((c,), 2), randn((c,), 3)
            cases.append(("layer_norm", f"{tag} {shape}",
                          lambda x=x, w=w, b=b: norms.layer_norm_kernel(x, w, b, 1e-5),
                          lambda x=x, w=w, b=b: norms.layer_norm_plain(x, w, b, 1e-5), i == 0 and tag == "f32"))
        gn = [((2, 600, 192), 32, 1e-5, "silu"), ((2, 600, 192), 32, 1e-6, "none"),
              ((1, 31999, 512), 512, 1e-5, "none"), ((2, 37, 192), 32, 1e-5, "silu")]
        for i, (shape, g, eps, act) in enumerate(gn):
            c = shape[-1]
            x, w, b = randn(shape, 4, dt, 2.0, 30.0), randn((c,), 5), randn((c,), 6)
            cases.append(("group_norm", f"{tag} {shape} G={g} eps={eps} {act}",
                          lambda x=x, g=g, w=w, b=b, eps=eps, act=act: norms.group_norm_kernel(x, g, w, b, eps, act),
                          lambda x=x, g=g, w=w, b=b, eps=eps, act=act: norms.group_norm_plain(x, g, w, b, eps, act),
                          i == 0 and tag == "f32"))
        for i, shape in enumerate([(2, 600, 192), (1, 600, 192), (2, 37, 192)]):
            x = randn(shape, 7, dt)
            w1, b1 = randn((1536, 192), 8, dt, 0.05), randn((1536,), 9, scale=0.1)
            w2, b2 = randn((192, 768), 10, dt, 0.05), randn((192,), 11, scale=0.1)
            cases.append(("geglu_ffn", f"{tag} {shape}",
                          lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ffn.geglu_ffn_kernel(x, w1, b1, w2, b2),
                          lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ffn.geglu_ffn_plain(x, w1, b1, w2, b2),
                          i == 0 and tag == "f32"))
        convs = [(3, 31999), (3, 15999), (3, 7999), (3, 3999), (2, 1999), (2, 999), (3, 8), (2, 8)]
        for i, (k, t_in) in enumerate(convs):
            x, w = randn((1, t_in, 512), 12, dt), randn((k, 512, 512), 13, dt, 0.03)
            cases.append(("strided_conv_gelu", f"{tag} K={k} T_in={t_in}",
                          lambda x=x, w=w: conv.strided_conv_gelu_kernel(x, w),
                          lambda x=x, w=w: conv.strided_conv_gelu_plain(x, w), i == 0 and tag == "f32"))
    return cases


def phase_kernels(record):
    print("\n== phase 2: kernels against their plain twins (card) ==")
    for name, label, kfn, pfn, headline in kernel_cases():
        got, ref = kfn(), pfn()
        torch.cuda.synchronize()
        dt = ref.dtype
        check(got.dtype == dt and got.shape == ref.shape, f"{name} {label}: dtype/shape differ from the twin")
        err = (got.float() - ref.float()).abs().max().item()
        bound = BOUND[dt] * ref.float().abs().max().item()
        ms, plain_ms = timed_pair(kfn, pfn)
        ok = err <= bound and np.isfinite(err)
        print(f"{name:18s} {label:40s} max_abs_err {err:.3e} bound {bound:.3e} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label}: max abs err {err} > bound {bound}")
        if headline:
            record[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=label)


def write_wav(path, seconds, seed):
    """Synthetic speech-like audio: AM-modulated harmonics plus noise."""
    from scipy.io import wavfile

    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voice = sum(np.sin(k * phase) / k for k in range(1, 8))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t)) ** 2
    x = 0.2 * voice * envelope + 0.01 * rng.standard_normal(t.shape)
    wavfile.write(path, SR, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def read_csv(path):
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], dtype=np.float64)


def phase_request(record, gpu_line):
    print("\n== phase 3: one 10-s request through the CLI (1000 DDIM steps, CFG 2.0, f32) ==")
    wav, out = os.path.join(WORK, "clip10s.wav"), os.path.join(WORK, "clip10s.csv")
    write_wav(wav, 10.0, seed=0)
    for fn, *_ in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["--device", "cuda", "--num_steps", "1000", "--guidance_scale", "2.0", "--dtype", "float32",
              "--seed", "0", "--weights_path", "", "--audio_path", wav, "--output_path", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, *_) in KERNELS.items()}
    header, coeffs = read_csv(out)
    print(f"request wall time {wall:.2f} s (model build + random init + prepare + 1000 steps + CSV) on {gpu_line}")
    print(f"launch counts in the request: {launches}")
    print(f"CSV: {coeffs.shape[0]} rows x {len(header)} columns, min {coeffs.min():.4f} max {coeffs.max():.4f} "
          f"std {coeffs.std():.4f}")
    check(tuple(header) == ARKIT_BLENDSHAPES, f"CSV header {header}")
    check(coeffs.shape == (600, 32), f"CSV holds {coeffs.shape}, expected (600, 32)")
    check(np.isfinite(coeffs).all() and coeffs.min() >= 0.0 and coeffs.max() <= 1.0, "CSV values not finite in [0, 1]")
    expected = {"group_norm": 15 * 1000 + 1, "layer_norm": 12 * 1000 + 26,
                "geglu_ffn": 4 * 1000, "strided_conv_gelu": 6}
    check(launches == expected, f"launch counts {launches} != {expected}")
    for name, n in launches.items():
        record[name]["launches"] = n
    return wall


def phase_card_vs_cpu():
    print("\n== phase 4: card (kernels) against CPU (plain twins), 4-s clip, 20 steps ==")
    configure_precision("float32")
    model = random_init_(build_said_model(), seed=0).eval()
    rng = np.random.default_rng(1)
    wave = process_audio(0.1 * rng.standard_normal(4 * SR).astype(np.float32))
    latents = rng.standard_normal((1, 240, 32)).astype(np.float32)
    kw = dict(num_inference_steps=20, guidance_scale=2.0, latents=latents)
    t0 = time.perf_counter()
    res_cpu = SAIDPipeline(model).inference(wave, **kw).result
    t_cpu = time.perf_counter() - t0
    pipe = SAIDPipeline(model.to(DEV))
    t0 = time.perf_counter()
    res_gpu = pipe.inference(wave, **kw).result
    t_gpu = time.perf_counter() - t0
    with torch.no_grad():
        kv, table = pipe.prepare(torch.from_numpy(wave).to(DEV), 240, True)
        eps = pipe.model.unet(torch.from_numpy(latents).to(DEV), kv_caches=kv, emb=table[999], cfg_fold=True)
    eps_std = eps.std().item()
    diff = np.abs(res_gpu - res_cpu)
    print(f"coefficient MAE {diff.mean():.3e} (bound 1e-4)  max {diff.max():.3e} (bound 1e-3)  "
          f"denoiser output std {eps_std:.4f} (must be > 1e-3)  cpu {t_cpu:.1f} s  card {t_gpu:.1f} s")
    check(res_gpu.shape == res_cpu.shape == (1, 240, 32), f"shapes {res_gpu.shape} / {res_cpu.shape}")
    check(eps_std > 1e-3, "denoiser output is degenerate; the comparison would be vacuous")
    check(diff.mean() <= 1e-4 and diff.max() <= 1e-3, f"card vs CPU MAE {diff.mean():.3e} / max {diff.max():.3e}")
    return model, wave, latents


def phase_bf16_vs_f32(model, wave, latents):
    print("\n== phase 5: bfloat16 against float32 on the card (phase 4's weights, clip and latents) ==")
    bf16 = build_said_model(dtype="bfloat16")
    bf16.load_state_dict(model.state_dict(), strict=True)
    wave_t, lat = torch.from_numpy(wave).to(DEV), torch.from_numpy(latents).to(DEV)
    out = {}
    with torch.no_grad():
        for m in (model, bf16.to(DEV).eval()):
            kv, table = SAIDPipeline(m).prepare(wave_t, 240, True)
            out[m.dtype] = {"audio embedding": m.get_audio_embedding(wave_t, 240).float(),
                            "denoiser output": m.unet(lat, kv_caches=kv, emb=table[999], cfg_fold=True).float()}
    for name, bound in BF16_BOUND.items():
        want, got = out[torch.float32][name], out[torch.bfloat16][name]
        rel_max = ((got - want).abs().max() / want.abs().max()).item()
        rel_mean = ((got - want).abs().mean() / want.abs().mean()).item()
        print(f"{name:16s} bf16 vs f32: max {rel_max:.3e} (bound {bound:.0e}) mean {rel_mean:.3e}, "
              f"relative to max / mean |f32|")
        check(got.shape == want.shape and np.isfinite(rel_max) and rel_max <= bound,
              f"bf16 {name} departs from f32 by {rel_max:.3e} > {bound}")


def phase_bf16():
    print("\n== phase 6: bfloat16 request (4-s clip, 100 steps) against the same f32 request ==")
    wav = os.path.join(WORK, "clip4s.wav")
    write_wav(wav, 4.0, seed=1)
    out = {}
    for dtype in ("float32", "bfloat16"):
        path = os.path.join(WORK, f"clip4s_{dtype}.csv")
        t0 = time.perf_counter()
        cli.main(["--device", "cuda", "--num_steps", "100", "--dtype", dtype, "--seed", "0",
                  "--weights_path", "", "--audio_path", wav, "--output_path", path])
        torch.cuda.synchronize()
        header, out[dtype] = read_csv(path)
        print(f"{dtype}: {out[dtype].shape} in {time.perf_counter() - t0:.2f} s")
    bf = out["bfloat16"]
    check(bf.shape == (240, 32) and np.isfinite(bf).all() and bf.min() >= 0.0 and bf.max() <= 1.0,
          "bf16 CSV is not (240, 32) finite values in [0, 1]")
    print(f"bf16 vs f32 coefficient MAE {np.abs(bf - out['float32']).mean():.3e} (for information)")


def main():
    os.makedirs(WORK, exist_ok=True)
    print("== phase 1: environment and build ==")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  CUDA {torch.version.cuda}")
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(gpu_line)
    t0 = time.perf_counter()
    _build.library()
    print(f"nvcc build of said_tpu_torch/csrc: {time.perf_counter() - t0:.1f} s")
    configure_precision("float32")
    t0 = time.perf_counter()
    x, w, b = randn((2, 8, 192), 0), randn((192,), 0), randn((192,), 0)
    norms.layer_norm_kernel(x, w, b)
    norms.group_norm_kernel(x, 32, w, b)
    torch.cuda.synchronize()
    print(f"Triton compile of the norm kernels: {time.perf_counter() - t0:.1f} s")

    record = {name: {"name": name, "route": route, "source": src, "replaces": rep, "replaces_function": fn}
              for name, (_, route, src, rep, fn) in KERNELS.items()}
    # the GroupNorm kernel also replaces the two-phase long-row form
    record["group_norm"]["also_replaces"] = "said_tpu/ops/pallas_norms.py:249 (group_norm_pallas_blocked)"
    phase_kernels(record)
    phase_request(record, gpu_line)
    model, wave, latents = phase_card_vs_cpu()
    phase_bf16_vs_f32(model, wave, latents)
    del model
    phase_bf16()

    print("\nall phases passed")
    print(gpu_line)
    print(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
