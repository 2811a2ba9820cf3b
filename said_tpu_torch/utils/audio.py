"""WAV loading, resampling and the UNet's waveform fitting (numpy + scipy).

The port's own copy of ``said_tpu.utils.audio`` (``FittedWaveform``,
``load_audio``, ``resample``, ``fit_audio_unet``, lines 20-91 there): the
port imports nothing of the JAX package, whose ``said_tpu/__init__.py``
may pull in jax.

``load_audio`` reads PCM or float WAVs with ``scipy.io.wavfile``,
normalises integer PCM to [-1, 1] the way torchaudio does, averages
channels to mono and resamples with a polyphase FIR filter
(``scipy.signal.resample_poly``, the family torchaudio's
``functional.resample`` implements). ``fit_audio_unet`` is the
reference's padding rule (``said/util/audio.py:41-76``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class FittedWaveform:
    waveform: np.ndarray
    window_size: int


def load_audio(audio_path: str, sampling_rate: int) -> np.ndarray:
    """Load a WAV file → float32 mono waveform at ``sampling_rate``."""
    from scipy.io import wavfile

    sr, data = wavfile.read(audio_path)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)

    if data.ndim == 2:  # (T, channels) → mono mean
        data = data.mean(axis=1)

    if sr != sampling_rate:
        data = resample(data, sr, sampling_rate)
    return data.astype(np.float32)


def resample(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase FIR resampling (kaiser-windowed sinc)."""
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    return resample_poly(waveform, up, down).astype(np.float32)


def fit_audio_unet(
    waveform: np.ndarray, sampling_rate: int, fps: int, divisor_unet: int
) -> FittedWaveform:
    """Zero-pad so the coefficient-sequence length divides ``divisor_unet``.

    ``window_size`` is that of the ORIGINAL length (outputs are trimmed
    back to it), as in the reference.
    """
    gcd = math.gcd(sampling_rate, fps)
    divisor_waveform = sampling_rate // gcd * divisor_unet

    waveform_len = waveform.shape[0]
    window_len = int(waveform_len / sampling_rate * fps)
    waveform_len_fit = math.ceil(waveform_len / divisor_waveform) * divisor_waveform

    if waveform_len_fit > waveform_len:
        tmp = np.zeros(waveform_len_fit, dtype=waveform.dtype)
        tmp[:waveform_len] = waveform
        waveform = tmp

    return FittedWaveform(waveform=waveform, window_size=window_len)
