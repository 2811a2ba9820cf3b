"""Tensor ops: band tables, resampling, attention, and the kernel routers.

Kernel modules (``norms``, ``ffn``, ``conv``, ``attention``) each hold a router, the
plain PyTorch twin with the kernel's numerics, and the kernel wrapper
with its launch counter. Nothing here imports ``triton`` or builds a
kernel at import time.

A router whose input needs a gradient (grad mode on and an input that
requires grad) runs through a ``torch.autograd.Function``: its forward is
the same kernel or plain twin, its backward a PyTorch function, as the
JAX package's ``custom_vjp`` backward differentiates the jnp twin. The
kernels have no backward of their own, and their launch counters count
forward launches only. With grad disabled the serving path is unchanged.
"""

import torch


def needs_grad(*tensors) -> bool:
    """Whether a router call must record a gradient: grad mode is on and
    one of ``tensors`` (None entries skipped) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)
