"""Tensor ops: band tables, resampling, attention, and the kernel routers.

Kernel modules (``norms``, ``ffn``, ``conv``) each hold a router, the
plain PyTorch twin with the kernel's numerics, and the kernel wrapper
with its launch counter. Nothing here imports ``triton`` or builds a
kernel at import time.
"""
