"""Baseline JFIF encoder in numpy (the machine with the card has no PIL).

What PIL's ``save(..., format="JPEG", quality=90)`` writes, by the same
standard: the IJG tables of ITU-T T.81 Annex K scaled to the quality as
libjpeg's ``jpeg_set_quality`` scales them, 4:2:0 chroma (2×2 averages),
the Annex K Huffman tables, one interleaved scan of 16×16 MCUs (four Y
blocks, then Cb, then Cr). The DCT is the orthonormal 8×8 one in
floating point (libjpeg's default is an integer approximation of it).

Everything is vectorised over the blocks: the colour transform, the DCT
and quantisation as array products; the run-length symbols of all blocks
from one ``np.nonzero``; the Huffman codes packed into bits with
``np.repeat`` and ``np.packbits``. No Python loop runs per block or per
coefficient.
"""

from __future__ import annotations

import struct

import numpy as np

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32),
])

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# Annex K.3 Huffman tables: codes per length 1..16, then the symbols
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
))

# the orthonormal 8-point DCT-II: coefficients = D @ block @ Dᵀ
_DCT = np.sqrt(2.0 / 8) * np.cos(np.pi * np.outer(np.arange(8), 2 * np.arange(8) + 1) / 16)
_DCT[0] /= np.sqrt(2.0)


def quant_tables(quality: int):
    """(luma, chroma) quantisation tables in natural order, scaled as
    libjpeg's ``jpeg_quality_scaling`` and clamped to baseline's [1, 255]."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be in [1, 100], got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((base * scale + 50) // 100, 1, 255) for base in (_LUMA_Q, _CHROMA_Q))


def _huffman_codes(table):
    """Canonical codes of a (counts, symbols) table → (code, length) arrays
    indexed by symbol (256 entries)."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.uint64), np.zeros(256, np.uint64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


_CODES = {name: _huffman_codes(t) for name, t in
          (("dc0", _DC_LUMA), ("ac0", _AC_LUMA), ("dc1", _DC_CHROMA), ("ac1", _AC_CHROMA))}


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _headers(height: int, width: int, luma_q, chroma_q) -> bytes:
    jfif = _segment(0xFFE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))
    dqt = _segment(0xFFDB, bytes([0, *luma_q[ZIGZAG]]) + bytes([1, *chroma_q[ZIGZAG]]))
    sof = _segment(0xFFC0, struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = _segment(0xFFC4, b"".join(bytes([cls, *counts, *symbols]) for cls, (counts, symbols) in
                                    ((0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA), (0x11, _AC_CHROMA))))
    sos = _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return b"\xff\xd8" + jfif + dqt + sof + dht + sos


def _blocks(rgb: np.ndarray):
    """(H, W, 3) uint8 → (blocks, 8, 8) level-shifted samples in scan order
    and each block's component (0 Y, 1 Cb, 2 Cr); edges replicated to
    whole 16×16 MCUs."""
    h, w = rgb.shape[:2]
    mh, mw = -(-h // 16), -(-w // 16)
    x = np.pad(rgb.astype(np.float64), ((0, 16 * mh - h), (0, 16 * mw - w), (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b

    def half(c):  # 2×2 averages: 4:2:0
        return c.reshape(8 * mh, 2, 8 * mw, 2).mean(axis=(1, 3))

    ys = y.reshape(mh, 2, 8, mw, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(mh, mw, 4, 8, 8)
    cs = [half(c).reshape(mh, 8, mw, 8).transpose(0, 2, 1, 3)[:, :, None] for c in (cb, cr)]
    blocks = np.concatenate([ys, *cs], axis=2).reshape(-1, 8, 8)
    return blocks, np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category; 0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.uint64)


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The category's extra bits: v for v > 0, v − 1 in ``size`` bits else."""
    v = v.astype(np.int64)
    return np.where(v >= 0, v, v + (np.left_shift(1, size.astype(np.int64)) - 1)).astype(np.uint64)


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes (MSB first) → bytes, padded with 1-bits, 0xFF stuffed."""
    total = int(lengths.sum())
    item = np.repeat(np.arange(len(values)), lengths.astype(np.int64))
    starts = np.cumsum(lengths.astype(np.int64)) - lengths.astype(np.int64)
    shift = (lengths[item].astype(np.int64) - 1 - (np.arange(total) - starts[item])).astype(np.uint64)
    bits = ((values[item] >> shift) & np.uint64(1)).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 → a baseline JFIF file (4:2:0, standard tables)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"JPEG encoder takes (H, W, 3) uint8 frames, got {rgb.dtype} {rgb.shape}")
    height, width = rgb.shape[:2]
    luma_q, chroma_q = quant_tables(quality)
    blocks, comp = _blocks(rgb)
    coef = (_DCT @ blocks @ _DCT.T).reshape(-1, 64)
    q = np.where(comp[:, None] == 0, luma_q, chroma_q)
    zz = (np.sign(coef) * np.floor(np.abs(coef) / q + 0.5)).astype(np.int64)[:, ZIGZAG]
    chroma = comp > 0
    n = len(zz)

    # DC: the difference to the previous block of the same component
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    size = _size(diff)
    code = np.where(chroma, _CODES["dc1"][0][size], _CODES["dc0"][0][size])
    clen = np.where(chroma, _CODES["dc1"][1][size], _CODES["dc0"][1][size])
    dc_val, dc_len = (code << size) | _extra_bits(diff, size), clen + size

    # AC: (zero run, size) symbols; runs of 16 and more as ZRL codes ahead of the symbol
    blk, pos = np.nonzero(zz[:, 1:])
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, -1, np.concatenate([[-1], pos[:-1]]))
    run = pos - prev - 1
    v = zz[blk, pos + 1]
    size = _size(v)
    symbol = ((run % 16) << 4) + size.astype(np.int64)
    ch = chroma[blk]
    code = np.where(ch, _CODES["ac1"][0][symbol], _CODES["ac0"][0][symbol])
    clen = np.where(ch, _CODES["ac1"][1][symbol], _CODES["ac0"][1][symbol])
    zrl, zrl_len = np.where(ch, _CODES["ac1"][0][0xF0], _CODES["ac0"][0][0xF0]), \
        np.where(ch, _CODES["ac1"][1][0xF0], _CODES["ac0"][1][0xF0])
    nzrl = (run // 16).astype(np.uint64)
    zrls = np.zeros(len(blk), np.uint64)
    for k in range(1, 4):  # at most 3 ZRLs: a run is at most 62
        zrls = np.where(nzrl >= k, (zrls << zrl_len) | zrl, zrls)
    ac_len = nzrl * zrl_len + clen + size
    ac_val = (((zrls << clen) | code) << size) | _extra_bits(v, size)

    # EOB where a block's last nonzero coefficient comes before the 63rd
    last = np.full(n, -1)
    np.maximum.at(last, blk, pos)
    eob = np.nonzero(last < 62)[0]
    eob_val = np.where(chroma[eob], _CODES["ac1"][0][0], _CODES["ac0"][0][0])
    eob_len = np.where(chroma[eob], _CODES["ac1"][1][0], _CODES["ac0"][1][0])

    keys = np.concatenate([np.arange(n) * 64, blk * 64 + pos + 1, eob * 64 + 63])
    order = np.argsort(keys, kind="stable")
    values = np.concatenate([dc_val, ac_val, eob_val])[order]
    lengths = np.concatenate([dc_len, ac_len, eob_len])[order]
    return _headers(height, width, luma_q, chroma_q) + _pack(values, lengths) + b"\xff\xd9"
