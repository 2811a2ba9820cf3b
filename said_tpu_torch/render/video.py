"""Video muxing without ffmpeg: MJPEG-in-AVI with an optional PCM track.

The reference muxes frames and audio with moviepy/ffmpeg
(``script/render.py:142-148``). This is a self-contained RIFF/AVI writer
with the layout of the JAX package's ``said_tpu.render.video``: one
'vids' stream of JPEG frames (the port's own encoder, ``jpeg.py``)
interleaved with one 'auds' stream of 16-bit mono PCM, a frame's share of
the samples after each frame, and an ``idx1`` index. MJPEG AVI plays in
every mainstream player.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from said_tpu_torch.render.jpeg import encode_jpeg


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def write_mjpeg_avi(
    path: str,
    frames: List[np.ndarray],
    fps: int,
    audio: Optional[np.ndarray] = None,
    sample_rate: int = 16000,
    quality: int = 90,
) -> None:
    """Write (H, W, 3) uint8 frames (and an optional mono float waveform,
    clipped to [−1, 1]) as an MJPEG AVI."""
    if not frames:
        raise ValueError("no frames to write")
    height, width = frames[0].shape[:2]
    n_frames = len(frames)

    pcm = None
    if audio is not None:
        pcm = (np.clip(np.asarray(audio), -1, 1) * 32767.0).astype("<i2")
        samples_per_frame = sample_rate // fps

    jpegs = [encode_jpeg(f, quality) for f in frames]
    max_jpeg = max(len(j) for j in jpegs)

    avih = struct.pack(
        "<14I",
        1_000_000 // fps,  # microseconds per frame
        0,  # max bytes per sec (0 = unspecified)
        0,  # padding granularity
        0x10,  # flags: AVIF_HASINDEX
        n_frames,
        0,  # initial frames
        2 if pcm is not None else 1,  # streams
        max_jpeg,  # suggested buffer size
        width,
        height,
        0, 0, 0, 0,
    )
    strh_vids = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", b"MJPG", 0, 0, 0, 0,
        1, fps,  # scale, rate → fps
        0, n_frames, max_jpeg, 0xFFFFFFFF, 0,
        0, 0, width, height,
    )
    bmih = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG", width * height * 3, 0, 0, 0, 0)
    strl_vids = _list(b"strl", _chunk(b"strh", strh_vids) + _chunk(b"strf", bmih))

    strl_auds = b""
    if pcm is not None:
        block_align = 2  # mono 16-bit
        strh_auds = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh",
            b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0,
            1, sample_rate,
            0, len(pcm), 0, 0xFFFFFFFF, block_align,
            0, 0, 0, 0,
        )
        wfx = struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2, block_align, 16)
        strl_auds = _list(b"strl", _chunk(b"strh", strh_auds) + _chunk(b"strf", wfx))

    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl_vids + strl_auds)

    # movi (interleaved) and idx1; offsets from the start of "movi"
    parts, offset, idx_entries, audio_pos = [b"movi"], 4, [], 0

    def add(fourcc: bytes, payload: bytes) -> None:
        nonlocal offset
        idx_entries.append(fourcc + struct.pack("<III", 0x10, offset, len(payload)))
        parts.append(_chunk(fourcc, payload))
        offset += len(parts[-1])

    for i, jpeg in enumerate(jpegs):
        add(b"00dc", jpeg)
        if pcm is not None:
            hi = len(pcm) if i == n_frames - 1 else min(len(pcm), (i + 1) * samples_per_frame)
            if hi > audio_pos:
                add(b"01wb", pcm[audio_pos:hi].tobytes())
                audio_pos = hi

    movi = _chunk(b"LIST", b"".join(parts))
    riff_payload = b"AVI " + hdrl + movi + _chunk(b"idx1", b"".join(idx_entries))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
