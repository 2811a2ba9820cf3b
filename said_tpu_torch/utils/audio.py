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
``compute_audio_beat_time`` (audio onsets for the beat-consistency
metric; ``onset_strength``, the mel filterbank and ``_peak_pick``) is the
copy of lines 94-266 there: librosa's ``onset_detect`` in numpy and
scipy.
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


def compute_audio_beat_time(waveform: np.ndarray, sampling_rate: int) -> np.ndarray:
    """Audio onset times in seconds — librosa-exact, librosa-free.

    Reproduces ``librosa.onset.onset_detect(y, sr, units="time")``
    (the reference's call, ``said/util/audio.py:79-96``) step for step
    from librosa 0.10's documented semantics:

    1. onset envelope: mel spectrogram (128 bands, n_fft 2048, hop 512,
       center-padded, power 2) → ``power_to_db`` (ref=1, top_db=80) →
       lag-1 positive flux, mean over bands → padded at the START by
       ``lag + n_fft // (2·hop)`` frames and truncated to the frame
       count (librosa's centering compensation, which aligns reported
       onsets with the true energy rise).
    2. the envelope is min-shifted and max-normalized to [0, 1]
       (``onset_detect(normalize=True)`` default).
    3. ``peak_pick`` with librosa's time-derived defaults —
       ``pre_max = 0.03·sr//hop``, ``post_max = 0.00·sr//hop + 1``,
       ``pre_avg = 0.10·sr//hop``, ``post_avg = 0.10·sr//hop + 1``,
       ``wait = 0.03·sr//hop``, ``delta = 0.07`` — using the same
       ndimage maximum/uniform filters (constant/-inf and nearest edge
       modes, ceil-origin) librosa uses.
    4. frame indices → seconds via ``frames·hop/sr``.
    """
    env, hop = onset_strength(waveform, sampling_rate)
    if not env.any():
        return np.array([], dtype=np.float64)
    env = env - env.min()
    env = env / (env.max() + np.finfo(np.float32).tiny)
    sr, h = sampling_rate, hop
    peaks = _peak_pick(
        env,
        pre_max=int(0.03 * sr // h),
        post_max=int(0.00 * sr // h) + 1,
        pre_avg=int(0.10 * sr // h),
        post_avg=int(0.10 * sr // h) + 1,
        delta=0.07,
        wait=int(0.03 * sr // h),
    )
    return peaks * hop / sampling_rate


def onset_strength(
    waveform: np.ndarray,
    sampling_rate: int,
    n_fft: int = 2048,
    hop: int = 512,
    n_mels: int = 128,
    lag: int = 1,
):
    """Spectral-flux onset envelope (librosa ``onset_strength`` semantics)."""
    x = np.asarray(waveform, dtype=np.float32)
    # Center-padded STFT with a periodic Hann window (librosa stft
    # defaults: center=True, pad_mode="constant").
    pad = n_fft // 2
    xp = np.pad(x, pad, mode="constant")
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(xp) - n_fft) // hop
    frames = np.lib.stride_tricks.sliding_window_view(xp, n_fft)[::hop][:n_frames]
    spec = np.abs(np.fft.rfft(frames * win, axis=1)) ** 2  # (frames, bins)

    mel_fb = _mel_filterbank(sampling_rate, n_fft, n_mels)  # (mels, bins)
    mspec = spec @ mel_fb.T  # (frames, mels)
    # power_to_db(ref=1.0, amin=1e-10, top_db=80)
    log_m = 10.0 * np.log10(np.maximum(mspec, 1e-10))
    log_m = np.maximum(log_m, log_m.max() - 80.0)

    # positive lag-difference flux, mean over mel bands
    diff = np.maximum(0.0, log_m[lag:] - log_m[:-lag])
    env = diff.mean(axis=1)
    # librosa's alignment: pad lag + n_fft//(2·hop) frames of zeros at
    # the start, truncate to the spectrogram frame count
    pad_width = lag + n_fft // (2 * hop)
    env = np.pad(env, (pad_width, 0), mode="constant")[:n_frames]
    return env.astype(np.float32), hop


def _hz_to_mel(f):
    # Slaney mel scale (librosa default, htk=False)
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (librosa-compatible)."""
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_min, mel_max = _hz_to_mel(0.0), _hz_to_mel(sr / 2.0)
    mel_pts = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


def _peak_pick(
    env: np.ndarray,
    pre_max: int,
    post_max: int,
    pre_avg: int,
    post_avg: int,
    delta: float,
    wait: int,
) -> np.ndarray:
    """librosa ``util.peak_pick``: ndimage moving max/mean + greedy wait.

    A frame is an onset if it equals the moving max over
    ``pre_max + post_max`` frames (constant/-inf edges, ceil-centered
    origin), is ≥ the moving mean over ``pre_avg + post_avg`` frames
    (nearest edges) plus ``delta``, and follows the previous onset by
    more than ``wait`` frames.
    """
    from scipy import ndimage

    if env.size == 0:
        return np.array([], dtype=np.int64)
    x = env.astype(np.float64)

    max_length = max(pre_max + post_max, 1)
    max_origin = int(np.ceil(0.5 * (pre_max - post_max)))
    mov_max = ndimage.maximum_filter1d(
        x, max_length, origin=max_origin, mode="constant", cval=-np.inf
    )
    avg_length = max(pre_avg + post_avg, 1)
    avg_origin = int(np.ceil(0.5 * (pre_avg - post_avg)))
    mov_avg = ndimage.uniform_filter1d(
        x, avg_length, origin=avg_origin, mode="nearest"
    )
    # librosa overwrites the filter's 'nearest'-edge values with TRUNCATED
    # means at both boundaries (the window clipped to the signal): the
    # first pre_avg and last post_avg frames, where the centered window
    # [i - pre_avg, i + post_avg) hangs off an end.
    n = x.shape[0]
    for i in range(min(pre_avg, n)):
        w = x[max(0, i - pre_avg) : i + post_avg]
        if w.size:
            mov_avg[i] = w.mean()
    for i in range(max(0, n - post_avg), n):
        w = x[max(0, i - pre_avg) : i + post_avg]
        if w.size:
            mov_avg[i] = w.mean()

    detections = (x == mov_max) & (x >= mov_avg + delta)
    peaks = []
    last = -np.inf
    for i in np.nonzero(detections)[0]:
        if i > last + wait:
            peaks.append(i)
            last = i
    return np.asarray(peaks, dtype=np.int64)
