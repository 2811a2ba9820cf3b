"""The request loop: one client sends requests back to back, each as the
inference CLI runs one (raw waveform → fit to whole frames →
``process_audio`` → ``SAIDPipeline.inference`` → coefficients on the
host), cycling through the mix's clips, until the window's seconds have
passed; the window ends when the last request started inside it
completes.

Set-up: the weights from the seed, the program's model on the card, the
mix's clips, one short request (two steps) at each length of the cycle.
With a trace, each request and its ``prepare`` are timed synchronised,
and one profiler session follows the window, running one whole cycle of
the mix from its first position, the same requests in every run. After the window the program is freed, and the
reference generates every checked position's clip from the same weights,
waveform and latents: its audio embedding, its first denoiser output and
its coefficients are held against those the timed requests produced.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench import program, trace, traffic, work
from port_bench.reference import sample
from port_bench.reference.said import Precision
from port_bench.weights import make_weights, reference_model


# the numbers a run can compare; a cell's limits file names those it does
READINGS = ("emb_gap", "eps_gap", "coeff_gap", "coeff_mean_gap")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class Capture:
    """Keeps, for the request it is armed for, the audio embedding and the
    first denoiser output the timed path produced (a reference to each,
    no copy)."""

    def __init__(self, model):
        self.armed, self.got = None, {}
        self._embed, self._unet = model.get_audio_embedding, model.unet.forward
        model.get_audio_embedding, model.unet.forward = self.embed, self.unet

    def embed(self, *a, **k):
        out = self._embed(*a, **k)
        if self.armed is not None:
            self.got[self.armed] = {"emb": out}
        return out

    def unet(self, *a, **k):
        out = self._unet(*a, **k)
        if self.armed is not None and "eps" not in self.got[self.armed]:
            self.got[self.armed]["eps"] = out
        return out


class Spans:
    """Synchronised host time of each ``prepare`` (trace runs)."""

    def __init__(self, pipe, device):
        self.prepare_s = []
        inner = pipe.prepare

        def timed(*a, **k):
            sync(device)
            t0 = time.perf_counter()
            out = inner(*a, **k)
            sync(device)
            self.prepare_s.append(time.perf_counter() - t0)
            return out

        pipe.prepare = timed


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference, over the reference's largest magnitude."""
    a, b = a.float(), b.float().to(a.device)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    cfg, tr = cell.config, cell.traffic
    program.configure_precision(cfg["dtype"])
    weights = make_weights(cfg, seed, device)
    model = program.build_model(cfg, weights, device)
    pipe = program.pipeline(model)
    clips = traffic.request_clips(tr, seed, cfg["unet"]["in_channels"])
    checked = traffic.checked_positions(tr, seed, clips)
    sampling = dict(guidance_scale=tr["guidance_scale"], eta=tr["eta"], solver=tr["solver"], fps=tr["fps"])

    def request(clip, steps=tr["steps"]):
        wave, frames = program.fit_audio(clip.wave, tr["sampling_rate"], tr["fps"])
        out = pipe.inference(program.process_audio(wave), latents=clip.latents, num_inference_steps=steps,
                             **sampling)
        return out.result[0, :frames]

    for frames in sorted({c.frames for c in clips}):  # each length once: builds, compiles, caches
        request(next(c for c in clips if c.frames == frames), steps=2)
    capture = Capture(model)
    spans = Spans(pipe, device) if traced else None
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start

    done, outputs = [], {k: [] for k in checked}
    i = 0
    while time.perf_counter() - t0 < seconds:
        k = i % len(clips)
        capture.armed = k if k in checked and k not in capture.got else None
        t_issue = time.perf_counter()
        coeffs = request(clips[k])
        t_done = time.perf_counter()
        done.append({"position": k, "frames": clips[k].frames, "audio_s": clips[k].audio_s, "steps": tr["steps"],
                     "samples": len(clips[k].wave), "latency_s": t_done - t_issue, "end": t_done - t0})
        if k in outputs:
            outputs[k].append(coeffs)
        i += 1
    capture.armed = None
    window_s = done[-1]["end"]
    record = {"setup_s": setup_s, "window_s": window_s, "requests": done, "attempted": len(done), "config": cfg,
              "dtype": cfg["dtype"]}

    if traced:
        for r, p in zip(done, spans.prepare_s):
            r["prepare_s"] = p

        def session():
            for clip in clips:
                request(clip)

        before = program.launch_counts()
        record["session"] = trace.session(session)
        after = program.launch_counts()
        session_requests = [{"frames": c.frames, "steps": tr["steps"]} for c in clips]
        record["session"]["requests"] = session_requests
        record["session"]["launches"] = {n: after[n] - before.get(n, 0) for n in after}
        record["session"]["flash_calls"] = work.flash_calls(cfg, session_requests)

    record["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    captured = capture.got
    del pipe, model, capture, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    record["checks"] = compare(cfg, tr, weights, clips, outputs, device, captured)
    record["reference_s"] = time.perf_counter() - t_ref
    return record


def reference_outputs(cfg, tr, weights, clips, positions, device, mode: str = "f32") -> dict:
    """The reference's embedding, first denoiser output and coefficients of
    each position's clip, computed in ``mode``."""
    ref = reference_model(cfg, weights, device)
    prec = Precision(mode)
    out = {}
    with prec.backend():
        for k in positions:
            clip = clips[k]
            w = torch.from_numpy(sample.normalise(clip.wave)).to(device)
            emb = sample.embed(ref, w, clip.frames, prec)
            first = []
            coeffs = sample.generate(ref, emb, torch.from_numpy(clip.latents).to(device), tr["steps"],
                                     tr["guidance_scale"], prec, first)
            out[k] = {"emb": emb, "eps": first[0], "coeffs": coeffs[0]}
    return out


def worst(a: float, b: float) -> float:
    """The larger reading; NaN where either is NaN (``max`` would drop it)."""
    return a + b if a != a or b != b else max(a, b)


def compare(cfg, tr, weights, clips, outputs, device, captured=None) -> list:
    """The readings of a run: each checked request's coefficients (the
    largest gap, and the mean gap), and the first request of each checked
    position's audio embedding and first denoiser output (the largest gap
    over the reference's largest magnitude), against the reference, each
    the worst over the requests. A reading is NaN, and fails its limit,
    where no checked request ran, or where one ran and the capture holds
    nothing of it (a timed path that no longer calls what ``Capture``
    wraps)."""
    ref = reference_outputs(cfg, tr, weights, clips, [k for k in outputs if outputs[k]], device)
    nan = float("nan")
    emb = eps = coeff = coeff_mean = 0.0 if ref else nan
    for k, r in ref.items():
        got = (captured or {}).get(k, {})
        emb = worst(emb, gap(got["emb"], r["emb"]) if "emb" in got else nan)
        eps = worst(eps, gap(got["eps"], r["eps"]) if "eps" in got else nan)
        want = r["coeffs"].cpu().numpy()
        for c in outputs[k]:
            coeff = worst(coeff, float(np.abs(c - want).max()))
            coeff_mean = worst(coeff_mean, float(np.abs(c - want).mean()))
    return [("emb_gap", emb), ("eps_gap", eps), ("coeff_gap", coeff), ("coeff_mean_gap", coeff_mean)]


def control_checks(cell, seed: int, device, mode: str) -> list:
    """The checks with the reference computed in ``mode`` put in the
    program's place, on the seed's checked positions."""
    cfg, tr = cell.config, cell.traffic
    weights = make_weights(cfg, seed, device)
    clips = traffic.request_clips(tr, seed, cfg["unet"]["in_channels"])
    positions = traffic.checked_positions(tr, seed, clips)
    low = reference_outputs(cfg, tr, weights, clips, positions, device, mode)
    outputs = {k: [low[k]["coeffs"].cpu().numpy()] for k in positions}
    return compare(cfg, tr, weights, clips, outputs, device, low)
