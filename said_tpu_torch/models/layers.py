"""Parameter-holding building blocks shared by the UNet and the encoder.

Parameters stay float32 (as in the JAX package); each layer computes in
the dtype of its input. Weight layouts are the reference's torch layouts,
so the model's ``state_dict`` uses the reference's names and shapes. A
weight in the compute dtype, or in the layout a GEMM or kernel wants, is
derived once and cached until the parameter changes (``Derived``): no
layer casts or re-lays out a weight on every call.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from said_tpu_torch.ops.norms import group_norm, group_norm_masked, layer_norm


class Derived:
    """A tensor derived from a parameter (re-laid out by ``fn``, then cast;
    the default ``fn`` only casts), rebuilt only when the parameter is
    replaced, moved or modified in place (its ``_version`` counter, which
    ``load_state_dict`` and the optimizer's in-place step bump).

    The cached tensor is built under ``no_grad``, so no gradient could
    reach the parameter through it: where grad mode is on and the
    parameter requires grad (training), the tensor is derived with
    autograd on every call and not cached."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor] = lambda p: p):
        self.fn = fn
        self._cache: Dict[torch.dtype, Tuple[tuple, torch.Tensor]] = {}

    def __call__(self, param: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if torch.is_grad_enabled() and param.requires_grad:
            return self.fn(param).to(dtype).contiguous()
        key = (param._version, param.data_ptr(), param.device)
        hit = self._cache.get(dtype)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, self.fn(param).to(dtype).contiguous())
            self._cache[dtype] = hit
        return hit[1]


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn from an explicit
    ``torch.Generator``: active only where a generator is passed (train
    mode), the identity otherwise, whatever ``self.training`` says. Kept:
    each element with probability 1 − p, scaled by 1/(1 − p), as flax's
    ``nn.Dropout``. No parameters, so ``state_dict`` keys are unchanged."""

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.p, generator)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout with rate ``p`` drawn from ``generator`` (None: identity)."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class Frames:
    """The real frames of a padded (B, T, ·) activation, for bucketed and
    mixed-length batches: ``real`` is one length for the whole batch (an
    int) or one per row ((B,) numpy array or int tensor).

    ``lengths`` is the (B,) int32 tensor on the device that the masked
    kernels take (for one length, ``batch`` rows of it; ``lens(b)`` gives
    the first b); ``zero(v)`` multiplies v by the 0/1 frame mask, in the
    compute dtype, as the JAX package zeroes pads. Building one uploads a
    per-row numpy array once; an int or a device tensor needs no copy.
    """

    def __init__(self, real, batch: int, t: int, device: torch.device, dtype: torch.dtype):
        self.real = real
        frame = torch.arange(t, device=device)
        if getattr(real, "ndim", 0) == 1:
            self.lengths = torch.as_tensor(real, device=device).to(torch.int32).contiguous()
            mask = frame[None, :] < self.lengths[:, None]
        else:
            n = int(real)
            self.lengths = torch.full((batch,), n, dtype=torch.int32, device=device)
            mask = (frame < n)[None]
        self.mask = mask[:, :, None].to(dtype)

    def lens(self, b: int) -> torch.Tensor:
        return self.lengths[:b]

    def zero(self, v: torch.Tensor) -> torch.Tensor:
        return v * self.mask

    def host(self):
        """The real length(s) as an int or a numpy array."""
        real = self.real
        return real.cpu().numpy() if isinstance(real, torch.Tensor) else real


class Dense(nn.Linear):
    """``nn.Linear`` computing in the input's dtype (flax ``nn.Dense(dtype)``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._weight, self._bias = Derived(), Derived()

    def weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        return self._weight(self.weight, dtype)

    def bias_as(self, dtype: torch.dtype):
        return None if self.bias is None else self._bias(self.bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight_as(x.dtype), self.bias_as(x.dtype))


class Conv1dSame(nn.Module):
    """Stride-1 SAME conv over channels-last (B, T, C), k ∈ {1, 3}.

    Holds a torch ``Conv1d`` weight (out, in, k) + bias. k=1 is a plain
    GEMM; k=3 (the JAX ``Conv3``, ``said_tpu/models/unet1d.py:115``) is
    one GEMM over the three shifted copies of the zero-padded input,
    concatenated on the channel axis, against the weight re-laid out to
    (out, 3·in). Plain PyTorch: the JAX package computes these outside any
    Pallas kernel too.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f"kernel_size must be 1 or 3, got {kernel_size}")
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        # (out, in, k) -> (out, k·in): tap-major, matching the concat below
        self._w = Derived(lambda w: w.permute(0, 2, 1).reshape(w.shape[0], -1))
        self._b = Derived()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.kernel_size == 3:
            xp = F.pad(x, (0, 0, 1, 1))
            x = torch.cat([xp[:, :-2], xp[:, 1:-1], xp[:, 2:]], dim=-1)
        return F.linear(x, self._w(self.weight, dt), self._b(self.bias, dt))


class GroupNorm32(nn.Module):
    """GroupNorm with f32 statistics over (B, T, C), optional fused SiLU
    (the JAX ``GroupNorm32``); runs through the GroupNorm kernel router, or
    the masked one when (B,) int32 real ``lengths`` are given."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5, act: str = "none"):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is None:
            return group_norm(x, self.num_groups, self.weight, self.bias, self.eps, self.act)
        return group_norm_masked(x, self.num_groups, self.weight, self.bias, lengths, self.eps, self.act)


class LayerNormF32(nn.Module):
    """LayerNorm with f32 statistics over the last axis; runs through the
    LayerNorm kernel router."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
