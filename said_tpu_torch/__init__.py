"""said_tpu_torch — the PyTorch/CUDA port of ``said_tpu`` for NVIDIA Hopper.

The JAX package ``said_tpu`` stays the reference; this package mirrors
its layout and names so each counterpart is found where expected:

- ``said_tpu_torch.ops``       — band tables, align-corners resampling,
  dense/banded attention, and the routers + plain twins of the four
  hand-written kernels (LayerNorm, GroupNorm32(+SiLU), GEGLU feed-forward,
  stride-2 conv+GELU).
- ``said_tpu_torch.csrc``      — CUDA C++ sources for ``sm_90a``, built at
  first use by ``said_tpu_torch._build``.
- ``said_tpu_torch.diffusion`` — cosine schedule, DDIM step, CFG, and the
  sampler as a host loop.
- ``said_tpu_torch.models``    — UNet1D denoiser, Wav2Vec2 encoder, SAID +
  ``SAIDPipeline``.
- ``said_tpu_torch.convert``   — JAX parameter tree → this package's
  ``state_dict`` (the reference's torch names).
- ``said_tpu_torch.cli``       — ``inference`` (WAV → ARKit CSV).

Public functions keep the JAX package's channels-last (B, T, C) layout.
The package imports ``torch`` and never ``jax``, ``flax`` or ``pandas``.
On a CPU tensor every kernel router runs its plain PyTorch twin; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
