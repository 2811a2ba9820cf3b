"""The evaluation VAE over blendshape-coefficient windows (BCVAE).

Port of ``said_tpu.models.vae`` (the reference's ``said/model/vae.py``):
encoder = four VALID Conv1d (+ BatchNorm, LeakyReLU 0.2) → the
channel-major flatten → three Linear (+ BatchNorm, LeakyReLU 0.01) →
``fc_mu`` / ``fc_logvar``; decoder = two Linear → unflatten to (4,
seq_len) → two stride-1 ConvTranspose1d (+ BatchNorm, LeakyReLU 0.2) and
two Conv1d → ReLU → Tanh. 120-frame windows of 32 coefficients, z 64.
Plain PyTorch: the JAX package runs these layers in flax, outside Pallas.

The module and parameter names are the reference torch model's
(``encoder.conv_layers.0.weight``, ``decoder.conv_layers.0`` a
ConvTranspose1d with weight (in, out, k), BatchNorm ``running_mean``,
``running_var`` and ``num_batches_tracked``), so a reference ``vae.pth``
loads with ``strict=True``. Tensors are channels-last (B, T, C) at the
public functions, as in the JAX package.

BatchNorm is the JAX package's (flax ``nn.BatchNorm``, momentum 0.9, eps
1e-5), not ``nn.BatchNorm1d``: in train mode it normalises with the
batch's statistics, its variance E[x²] − E[x]² clamped at 0 (flax's
``use_fast_variance``), and moves the running statistics to 0.9·old +
0.1·batch with that biased variance (torch would use the unbiased one).
Train mode is the ``train`` argument, never ``module.training``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# Biases that feed a BatchNorm through affine maps only (a conv or a
# Linear, directly or through the flatten): in train mode the batch mean
# removes them, so their gradient is exactly 0 and computes as rounding
# noise in f32 (which AdamW then normalises to a full-size step).
BATCHNORM_CANCELLED_BIASES = (
    "encoder.conv_layers.0.bias", "encoder.conv_layers.3.bias", "encoder.conv_layers.6.bias",
    "encoder.conv_layers.9.bias", "encoder.fc_layers.0.bias", "encoder.fc_layers.3.bias",
    "decoder.fc_layers.0.bias", "decoder.conv_layers.0.bias", "decoder.conv_layers.3.bias",
)


@dataclasses.dataclass
class BCVAEOutput:
    mean: torch.Tensor
    log_var: torch.Tensor
    latent: torch.Tensor
    coeffs_reconst: torch.Tensor


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over every axis but the feature axis (1)
    of (B, C) or (B, C, T), with the reference's parameter and buffer
    names."""

    momentum, eps = 0.9, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean.detach())
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var.detach())
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def _run(layers: nn.ModuleList, x: torch.Tensor, train: bool) -> torch.Tensor:
    for layer in layers:
        x = layer(x, train) if isinstance(layer, BatchNorm) else layer(x)
    return x


class BCEncoder(nn.Module):
    def __init__(self, in_channels: int = 32, seq_len: int = 120, z_dim: int = 64):
        super().__init__()
        self.conv_layers = nn.ModuleList([
            nn.Conv1d(in_channels, 32, 3), BatchNorm(32), nn.LeakyReLU(0.2),
            nn.Conv1d(32, 64, 3), BatchNorm(64), nn.LeakyReLU(0.2),
            nn.Conv1d(64, 64, 4, stride=2), BatchNorm(64), nn.LeakyReLU(0.2),
            nn.Conv1d(64, 32, 3),
        ])
        conv_len = (seq_len - 2 - 2 - 4) // 2 + 1 - 2
        self.fc_layers = nn.ModuleList([
            nn.Linear(32 * conv_len, 256), BatchNorm(256), nn.LeakyReLU(0.01),
            nn.Linear(256, 128), BatchNorm(128), nn.LeakyReLU(0.01),
            nn.Linear(128, z_dim),
        ])
        self.fc_mu = nn.Linear(z_dim, z_dim)
        self.fc_logvar = nn.Linear(z_dim, z_dim)

    def forward(self, coeffs: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """coeffs (B, T, C) → (mean, log_var), each (B, z_dim)."""
        x = _run(self.conv_layers, coeffs.transpose(1, 2), train)
        x = _run(self.fc_layers, x.flatten(1), train)  # (B, C, T) flattened channel-major, as torch does
        return self.fc_mu(x), self.fc_logvar(x)


class BCDecoder(nn.Module):
    def __init__(self, out_channels: int = 32, seq_len: int = 120, z_dim: int = 64):
        super().__init__()
        self.seq_len = seq_len
        self.fc_layers = nn.ModuleList([
            nn.Linear(z_dim, 2 * seq_len), BatchNorm(2 * seq_len), nn.LeakyReLU(0.01),
            nn.Linear(2 * seq_len, 4 * seq_len),
        ])
        self.conv_layers = nn.ModuleList([
            nn.ConvTranspose1d(4, 32, 3), BatchNorm(32), nn.LeakyReLU(0.2),
            nn.ConvTranspose1d(32, 32, 3), BatchNorm(32), nn.LeakyReLU(0.2),
            nn.Conv1d(32, 32, 3), nn.Conv1d(32, out_channels, 3),
        ])

    def forward(self, latent: torch.Tensor, train: bool = False) -> torch.Tensor:
        """latent (B, z_dim) → coeffs (B, seq_len, out_channels)."""
        x = _run(self.fc_layers, latent, train).reshape(latent.shape[0], 4, self.seq_len)
        x = _run(self.conv_layers, x, train)
        return torch.tanh(F.relu(x)).transpose(1, 2)


class BCVAE(nn.Module):
    """VAE over 120-frame windows of 32 blendshape coefficients."""

    def __init__(self, channels: int = 32, seq_len: int = 120, z_dim: int = 64):
        super().__init__()
        self.channels, self.seq_len, self.z_dim = channels, seq_len, z_dim
        self.encoder = BCEncoder(channels, seq_len, z_dim)
        self.decoder = BCDecoder(channels, seq_len, z_dim)

    def forward(
        self,
        coeffs: torch.Tensor,
        use_noise: bool = True,
        train: bool = False,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> BCVAEOutput:
        """Encode, reparametrize (ε injected as ``eps`` or drawn from
        ``generator``; ``use_noise=False``: z = mean) and decode."""
        mean, log_var = self.encoder(coeffs, train)
        latent = self.reparametrize(mean, log_var, eps, generator) if use_noise else mean
        return BCVAEOutput(mean=mean, log_var=log_var, latent=latent, coeffs_reconst=self.decoder(latent, train))

    def encode(self, coeffs: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(coeffs, train)

    def decode(self, latent: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder(latent, train)

    @staticmethod
    def reparametrize(mean: torch.Tensor, log_var: torch.Tensor, eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if eps is None:
            if generator is None:
                raise ValueError("use_noise=True needs an injected eps or a generator")
            eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        return mean + torch.exp(0.5 * log_var) * eps
