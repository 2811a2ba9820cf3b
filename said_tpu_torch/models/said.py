"""SAID: speech → blendshape coefficients by diffusion, and its pipeline.

Port of ``said_tpu.models.said``: ``SAID`` owns the parameters (the
Wav2Vec2 conditioner, the UNet denoiser, the learned null-conditioning
embedding) and ``SAIDPipeline.inference`` runs single-clip generation in
two stages:

- **prepare**, once per clip: encoder → null embedding → banded K/V
  caches → timestep-MLP table;
- **denoise**, a host loop of DDIM or DPM-Solver++(2M) steps, each one
  denoiser call with the CFG shared-prefix fold.

Parameter names are the reference's (``denoiser.model.…``,
``audio_encoder.…``, ``null_cond_emb``). Not ported yet: length
bucketing and mixed-length batches, sequence-parallel mode and
streaming; the TPU-only chunked denoise dispatch is not needed here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from said_tpu_torch.diffusion.sampler import SamplerConfig, sample
from said_tpu_torch.diffusion.schedule import DiffusionSchedule
from said_tpu_torch.models.layers import Dense
from said_tpu_torch.models.unet1d import (
    KVCache,
    UNet1DConditionModel,
    build_kv_caches,
    time_embed_table,
)
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

SAMPLING_RATE = 16000


@dataclasses.dataclass
class SAIDInferenceOutput:
    """result (B, T, C) in [0, 1]; intermediates (K, B, T, C) or None."""

    result: np.ndarray
    intermediates: Optional[np.ndarray] = None


class _Denoiser(nn.Module):
    """Holds the UNet under ``model`` (the reference's ``denoiser.model``)."""

    def __init__(self, unet: UNet1DConditionModel):
        super().__init__()
        self.model = unet


class SAID(nn.Module):
    """Parameters + forward passes (denoise, audio embedding).

    ``dtype`` is the compute dtype (float32 or bfloat16); parameters stay
    float32, as in the JAX package.
    """

    def __init__(
        self,
        audio_config: Wav2Vec2Config = Wav2Vec2Config(),
        in_channels: int = 32,
        feature_dim: int = -1,
        diffusion_steps: int = 1000,
        latent_scale: float = 1.0,
        prediction_type: str = "epsilon",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.audio_config = audio_config
        self.in_channels = in_channels
        self.feature_dim = feature_dim
        self.diffusion_steps = diffusion_steps
        self.latent_scale = latent_scale
        self.prediction_type = prediction_type
        self.dtype = dtype
        cross_dim = feature_dim if feature_dim > 0 else audio_config.hidden_size
        emb_dim = feature_dim if feature_dim > 0 else audio_config.output_hidden_size
        self.audio_encoder = Wav2Vec2Encoder(audio_config, dtype)
        self.denoiser = _Denoiser(
            UNet1DConditionModel(
                in_channels=in_channels, out_channels=in_channels,
                cross_attention_dim=cross_dim, dtype=dtype,
            )
        )
        self.null_cond_emb = nn.Parameter(torch.zeros(1, 1, emb_dim))
        self.audio_proj_layer = (
            Dense(audio_config.hidden_size, feature_dim) if feature_dim > 0 else None
        )

    @property
    def unet(self) -> UNet1DConditionModel:
        return self.denoiser.model

    def forward(self, noisy_samples, timesteps, audio_embedding, **kwargs) -> torch.Tensor:
        """Predict noise: (B, T, C), (B,), (B, S, E) → (B, T, C)."""
        return self.unet(noisy_samples, timesteps, audio_embedding, **kwargs)

    def get_audio_embedding(self, waveform: torch.Tensor, num_frames: Optional[int]) -> torch.Tensor:
        """(B, T_a) processed waveform → (B, num_frames, E) embedding."""
        feats = self.audio_encoder(waveform, num_frames)
        if self.audio_proj_layer is not None:
            feats = self.audio_proj_layer(feats)
        return feats

    def null_embedding(self, batch_size: int, seq_len: int) -> torch.Tensor:
        """Learned unconditional embedding, broadcast to (B, S, E)."""
        return self.null_cond_emb.to(self.dtype).expand(batch_size, seq_len, -1)


def process_audio(waveform: np.ndarray) -> np.ndarray:
    """Wav2Vec2Processor normalisation: per-utterance (x − mean)/√(var + 1e-7).
    Accepts (T,) or (B, T); returns (B, T) float32."""
    x = np.asarray(waveform, dtype=np.float32)
    if x.ndim == 1:
        x = x[None]
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + 1e-7)


class SAIDPipeline:
    """Runs inference on the host side: owns the model and the schedule."""

    def __init__(self, model: SAID, clip_sample: bool = True):
        self.model = model
        self.schedule = DiffusionSchedule.create(
            model.diffusion_steps, model.prediction_type, clip_sample
        )
        self.sampling_rate = SAMPLING_RATE

    @property
    def device(self) -> torch.device:
        return self.model.null_cond_emb.device

    @torch.no_grad()
    def prepare(
        self, waveform: torch.Tensor, window_size: int, do_cfg: bool
    ) -> Tuple[Dict[str, List[KVCache]], torch.Tensor]:
        """The loop-invariant stage: audio encoder, null embedding, banded
        K/V caches (CFG-doubled, uncond first) and the timestep table."""
        model = self.model
        audio_emb = model.get_audio_embedding(waveform, window_size)
        context = audio_emb
        if do_cfg:
            uncond = model.null_embedding(audio_emb.shape[0], audio_emb.shape[1])
            context = torch.cat([uncond, audio_emb])
        kv_caches = build_kv_caches(model.unet, context, window_size)
        emb_table = time_embed_table(model.unet, np.arange(model.diffusion_steps))
        return kv_caches, emb_table

    @torch.no_grad()
    def inference(
        self,
        waveform_processed: np.ndarray,
        init_samples: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        num_inference_steps: int = 100,
        strength: float = 1.0,
        guidance_scale: float = 2.5,
        guidance_rescale: float = 0.0,
        eta: float = 0.0,
        solver: str = "ddim",
        fps: int = 60,
        generator: Optional[torch.Generator] = None,
        latents: Optional[np.ndarray] = None,
        eta_noise: Optional[np.ndarray] = None,
        edit_noise: Optional[np.ndarray] = None,
        save_intermediate: bool = False,
    ) -> SAIDInferenceOutput:
        """Full inference (reference ``SAID.inference`` semantics).

        ``solver`` is "ddim" (the reference's sampler) or "dpmpp_2m"
        (DPM-Solver++(2M): deterministic, so ``eta`` must be 0).

        Random arrays may be injected, since torch and JAX draw different
        numbers from the same seed: ``latents`` (B, T, C) — without it and
        without ``init_samples`` they are drawn from ``generator``;
        ``eta_noise`` (K, B, T, C), one array per used step, for
        ``eta > 0``; ``edit_noise`` (B, T, C) for the editing path. With
        ``init_samples`` and no ``latents``, the inits are the latents.
        ``mask`` (1 = keep the init) applies with ``init_samples``.
        """
        dev = self.device
        wave = torch.as_tensor(np.array(waveform_processed, np.float32), device=dev)
        if wave.ndim == 1:
            wave = wave[None]
        b, t_a = wave.shape
        window_size = int(t_a / self.sampling_rate * fps)
        c = self.model.in_channels

        def on_dev(a):
            return None if a is None else torch.as_tensor(np.array(a, np.float32), device=dev)

        if latents is None:
            if init_samples is None:
                lat = torch.randn((b, window_size, c), generator=generator, device=dev)
            else:
                lat = on_dev(init_samples)
        else:
            lat = on_dev(latents)

        config = SamplerConfig(
            num_inference_steps=num_inference_steps,
            strength=strength,
            guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale,
            eta=eta,
            solver=solver,
        )
        kv_caches, emb_table = self.prepare(wave, window_size, config.do_cfg)
        unet = self.model.unet

        def denoise_fn(x, t):
            return unet(x, kv_caches=kv_caches, emb=emb_table[t], cfg_fold=config.do_cfg)

        result, interms = sample(
            self.schedule,
            denoise_fn,
            lat,
            config,
            init_samples=on_dev(init_samples),
            mask=on_dev(mask),
            latent_scale=self.model.latent_scale,
            save_intermediate=save_intermediate,
            cfg_folded=config.do_cfg,
            eta_noise=on_dev(eta_noise),
            edit_noise=on_dev(edit_noise),
            generator=generator,
        )
        return SAIDInferenceOutput(
            result=result.cpu().numpy(),
            intermediates=None if interms is None else interms.cpu().numpy(),
        )
