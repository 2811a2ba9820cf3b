"""The one generator of every traffic mix, driven by the mix's data file
(``port_bench/traffic/<name>.json``).

Sizes come from the file alone, so every seed gets the same set of clip
lengths, windows and steps; the seed sets what is in them (the audio, the
initial latents, the coefficient curves, the condition flags and
spec-augment masks), and, for a training mix, the order of its steps.

Lengths are either listed (``lengths_s``) or the (i + ½)/n quantiles of
a log-normal (``lognormal``: median, sigma, count, clipped to [min, max]),
taken in the listed ``order``. A clip is a whole number of 3-frame groups
(800 samples at 16 kHz and 60 fps), so its frames are exact.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np
import torch

SAMPLES_PER_3_FRAMES = 800  # 16 kHz, 60 fps


def stream(seed: int, *key: int) -> np.random.Generator:
    """An independent numpy generator for (seed, key…)."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 63), *key]))


def lengths_s(spec: dict) -> List[float]:
    """The mix's clip lengths in seconds, in its order."""
    if "lengths_s" in spec:
        return [float(x) for x in spec["lengths_s"]]
    ln = spec["lognormal"]
    n = ln["count"]
    qs = [min(max(ln["median"] * math.exp(ln["sigma"] * NormalDist().inv_cdf((i + 0.5) / n)), ln["min"]), ln["max"])
          for i in range(n)]
    return [qs[i] for i in spec.get("order", range(n))]


def frames_of(seconds: float, fps: int = 60) -> int:
    """Whole 3-frame groups nearest to ``seconds``."""
    return max(3, 3 * round(seconds * fps / 3))


def speech(rng: np.random.Generator, n: int, sampling_rate: int = 16000) -> np.ndarray:
    """A speech-like waveform: a voiced tone whose pitch drifts, shaped by
    syllable-rate bursts and pauses, plus breath noise (float32, ±1)."""
    t = np.arange(n, dtype=np.float64) / sampling_rate
    f0 = rng.uniform(90.0, 220.0) * (1.0 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sampling_rate
    voiced = np.sin(phase) + 0.5 * np.sin(2 * phase + rng.uniform(0, np.pi)) + 0.25 * np.sin(3 * phase)
    syllables = np.clip(np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t + rng.uniform(0, np.pi)), 0.0, None)
    pauses = (np.sin(2 * np.pi * rng.uniform(0.1, 0.3) * t + rng.uniform(0, np.pi)) > -0.7).astype(np.float64)
    wave = 0.25 * voiced * syllables * pauses + 0.02 * rng.standard_normal(n)
    return wave.astype(np.float32)


@dataclasses.dataclass
class Clip:
    """One request's inputs: the raw waveform (host), its frames as the
    inference CLI counts them (``int(samples / rate · fps)`` in floating
    point, which can fall one short of the exact count) and the initial
    latents (1, frames, channels)."""

    wave: np.ndarray
    frames: int
    latents: np.ndarray

    @property
    def audio_s(self) -> float:
        return self.frames / 60.0


def request_clips(spec: dict, seed: int, channels: int) -> List[Clip]:
    """One clip a position of the mix's cycle."""
    clips = []
    for k, sec in enumerate(lengths_s(spec)):
        n = frames_of(sec, spec["fps"]) // 3 * SAMPLES_PER_3_FRAMES
        frames = int(n / spec["sampling_rate"] * spec["fps"])
        rng = stream(seed, 1, k)
        wave = speech(rng, n, spec["sampling_rate"])
        latents = rng.standard_normal((1, frames, channels)).astype(np.float32)
        clips.append(Clip(wave, frames, latents))
    return clips


def checked_positions(spec: dict, seed: int, clips: List[Clip]) -> List[int]:
    """The cycle positions whose requests the run compares with the
    reference: ``check.positions`` of them drawn from the seed, the
    longest clip always among them ("all": every position)."""
    n = spec["check"]["positions"]
    if n == "all" or n >= len(clips):
        return list(range(len(clips)))
    longest = max(range(len(clips)), key=lambda k: clips[k].frames)
    rest = [k for k in range(len(clips)) if k != longest]
    drawn = stream(seed, 2).choice(rest, size=n - 1, replace=False).tolist()
    return sorted([longest, *drawn])


# --------------------------------------------------------------- training


def train_windows(spec: dict) -> List[int]:
    """The window (real frames) of each step of the cycle, the same for
    every seed: the training loader's draw (``batch`` clips from the
    length table with replacement, a window in [window_min, shortest
    clip]; a window never below window_min) made with a fixed generator."""
    rng = np.random.default_rng(0)
    table = [frames_of(s) for s in lengths_s(spec["clips"])]
    out = []
    for _ in range(spec["cycle_steps"]):
        shortest = min(rng.choice(table, size=spec["batch"], replace=True))
        out.append(int(rng.integers(spec["window_min"], max(spec["window_min"], shortest) + 1)))
    return out


def time_mask(rng: np.random.Generator, batch: int, t: int, mask_prob: float, mask_length: int,
              min_masks: int) -> np.ndarray:
    """Spec-augment's time masks (HF ``_compute_mask_indices``, every row of
    length t): one rounding draw, spans of ``mask_length`` at distinct
    random starts. (B, t) bool, True = masked."""
    mask = np.zeros((batch, t), dtype=bool)
    epsilon = rng.random()
    n = max(int(mask_prob * t / mask_length + epsilon), min_masks)
    n = min(n, t // mask_length, t - (mask_length - 1))
    for i in range(batch):
        for s in rng.choice(t - (mask_length - 1), size=n, replace=False):
            mask[i, s: s + mask_length] = True
    return mask


def coefficient_curves(rng: np.random.Generator, batch: int, t: int, channels: int) -> np.ndarray:
    """Smooth blendshape curves in [0, 1]: a random walk low-passed over
    ~10 frames, squashed."""
    walk = np.cumsum(rng.standard_normal((batch, t + 20, channels)) * 0.3, axis=1)
    kernel = np.ones(10) / 10
    smooth = np.apply_along_axis(lambda v: np.convolve(v, kernel, mode="valid"), 1, walk)[:, :t]
    smooth -= smooth.mean(axis=1, keepdims=True)
    return (1.0 / (1.0 + np.exp(-smooth))).astype(np.float32)


def normalise(wave: np.ndarray) -> np.ndarray:
    """The training feed's per-row normalisation of (B, T) waveforms
    (Wav2Vec2Processor's): (x − mean) / √(var + 1e-7), float32."""
    mean = wave.mean(axis=-1, keepdims=True)
    return ((wave - mean) / np.sqrt(wave.var(axis=-1, keepdims=True) + 1e-7)).astype(np.float32)


def train_batches(spec: dict, seed: int, channels: int, device) -> List[dict]:
    """The cycle's batches as the training CLI feeds them (waveform
    normalised over its real samples, then everything padded to the frame
    bucket with the real lengths beside), in the seed's order."""
    windows = train_windows(spec)
    order = stream(seed, 3).permutation(len(windows)).tolist()
    sr, fps, bucket, b = spec["sampling_rate"], spec["fps"], spec["window_bucket"], spec["batch"]
    sa = spec["spec_augment"]
    out = []
    for j in order:
        t = windows[j]
        rng = stream(seed, 4, j)
        n = sr * t // fps
        target = -(-t // bucket) * bucket
        wave = normalise(np.stack([speech(rng, n, sr) for _ in range(b)]))
        wave = np.pad(wave, ((0, 0), (0, int(math.ceil(target * sr / fps)) - n)))
        coeffs = np.pad(coefficient_curves(rng, b, t, channels), ((0, 0), (0, target - t), (0, 0)))
        mask = np.pad(time_mask(rng, b, t, sa["mask_prob"], sa["mask_length"], sa["min_masks"]),
                      ((0, 0), (0, target - t)))
        cond = rng.uniform(size=b) > spec["uncond_prob"]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        out.append({"waveform": dev(wave), "coeffs": dev(coeffs), "cond": dev(cond), "std": None,
                    "blendshape_delta": None, "mask_time_indices": dev(mask), "window_real": t,
                    "input_length": n})
    return out
