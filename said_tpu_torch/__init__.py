"""said_tpu_torch — the PyTorch/CUDA port of ``said_tpu`` for NVIDIA Hopper.

The JAX package ``said_tpu`` stays the reference; this package mirrors
its layout and names so each counterpart is found where expected:

- ``said_tpu_torch.ops``       — band tables, align-corners resampling,
  dense/banded attention, and the routers + plain twins of the five
  hand-written kernels (flash attention, LayerNorm, GroupNorm32(+SiLU),
  GEGLU feed-forward, stride-2 conv+GELU).
- ``said_tpu_torch.csrc``      — CUDA C++ sources for ``sm_90a``, built at
  first use by ``said_tpu_torch._build``.
- ``said_tpu_torch.diffusion`` — cosine schedule, DDIM step,
  DPM-Solver++(2M), CFG, and the sampler as a host loop.
- ``said_tpu_torch.models``    — UNet1D denoiser, Wav2Vec2 encoder, SAID +
  ``SAIDPipeline``.
- ``said_tpu_torch.convert``   — JAX parameter tree → this package's
  ``state_dict`` (the reference's torch names).
- ``said_tpu_torch.train``     — the denoiser's training loss, the
  optimizer (optax's clip + AdamW, written out), EMA and the train step.
- ``said_tpu_torch.core``      — train-state checkpoints, the ``.pth``
  export, the metrics log.
- ``said_tpu_torch.data``      — BlendVOCA discovery, the train and
  validation datasets and collates, the loader.
- ``said_tpu_torch.utils``     — WAV loading, the UNet's waveform fitting,
  blendshape CSVs.
- ``said_tpu_torch.cli``       — ``inference`` (WAV → ARKit CSV),
  ``test_inference`` (the eval protocol's generation), ``train``.

Public functions keep the JAX package's channels-last (B, T, C) layout.
The package imports ``torch`` and never ``jax``, ``flax``, ``pandas`` or
anything of ``said_tpu``.
On a CPU tensor every kernel router runs its plain PyTorch twin; on a
CUDA tensor it launches the kernel or raises. Where an input needs a
gradient, a router runs as a ``torch.autograd.Function`` whose backward
is a PyTorch function (the JAX package's ``custom_vjp`` backwards are
jnp too).
"""

__version__ = "0.1.0"
