"""The flash-attention probes on the card: Hopper counterparts of the five
Pallas probes of the JAX package's ``tools/`` (``attn_probe``,
``attn_probe2``, ``fullk_bound_probe``, ``int8_qk_probe``, ``vpu_probe``).

Each cuts the flash kernel K1 (``csrc/flash_attention.cu``) open at one
place and times the pieces on the card:

- ``flash_probe`` (``csrc/probes/flash_probe.cu``): K1's loop with three
  knobs, launched by the two modules that follow;
- ``flash_stages``: K1's loop cut after each softmax stage, per-head or
  packed layout (P1, P2);
- ``flash_shift``: K1's body with a ones-column denominator and the exp2
  shift as a knob (P3, P5);
- ``int8_qk`` (``csrc/probes/int8_qk.cu``): QK^T in int8 (P4);
- ``shift``: the shifts and the int8 quantization the probes compute
  outside their kernels; ``timing``: graph-replay timing on the card and
  the card's peaks.

The CLIs run as ``python -m said_tpu_torch.probes.<name>``, on the card by
default; ``--device cpu`` runs the plain versions for numerics only. The
kernels build into their own library (``_build.probe_library``), off the
serving and training paths: no request launches them.
"""

from __future__ import annotations

import torch

HEAD_DIM = 32  # the probes' head dim (the UNet's); the kernels take only this


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on the current
    device starting on a 16-byte boundary (the kernels copy 16-byte rows)."""
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: needs CUDA tensors, got one on {x.device}")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: input is on {x.device}, not the current device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and start on a 16-byte boundary")
