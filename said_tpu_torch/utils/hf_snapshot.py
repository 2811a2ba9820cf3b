"""Read a Hugging Face model snapshot directory (e.g. a local copy of
``facebook/wav2vec2-base-960h``): ``model.safetensors`` or
``pytorch_model.bin``.

The safetensors reader is the port's own (the machine with the card has
no ``safetensors`` package). The format: an 8-byte little-endian header
length, a JSON header mapping each name to its dtype, shape and
``data_offsets`` (begin, end) into the buffer that follows, and the raw
little-endian tensors.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

SNAPSHOT_FILES = ("model.safetensors", "pytorch_model.bin")

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(data[8:8 + n])
    buffer = bytearray(data[8 + n:])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = 1
        for d in info["shape"]:
            count *= d
        if not 0 <= begin <= end <= len(buffer) or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} for {count} {info['dtype']}")
        if count:
            out[name] = torch.frombuffer(buffer, dtype=dtype, count=count, offset=begin).reshape(info["shape"]).clone()
        else:
            out[name] = torch.empty(info["shape"], dtype=dtype)
    return out


def snapshot_file(directory: str) -> Optional[str]:
    """The snapshot's weights file, or None if the directory has neither."""
    for name in SNAPSHOT_FILES:
        path = os.path.join(directory, name)
        if os.path.isfile(path):
            return path
    return None


def load_snapshot(directory: str) -> Dict[str, torch.Tensor]:
    """The state dict of a snapshot directory (``model.safetensors`` first)."""
    path = snapshot_file(directory)
    if path is None:
        raise FileNotFoundError(f"{directory!r} holds neither of {SNAPSHOT_FILES}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)
