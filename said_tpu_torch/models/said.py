"""SAID: speech → blendshape coefficients by diffusion, and its pipeline.

Port of ``said_tpu.models.said``: ``SAID`` owns the parameters (the
Wav2Vec2 conditioner, the UNet denoiser, the learned null-conditioning
embedding) and ``SAIDPipeline.inference`` runs single-clip generation in
two stages:

- **prepare**, once per clip: encoder → null embedding → banded K/V
  caches → timestep-MLP table;
- **denoise**, a host loop of DDIM or DPM-Solver++(2M) steps, each one
  denoiser call with the CFG shared-prefix fold.

With ``length_bucket`` the clip is padded to a multiple of the bucket
and runs in length-bucketed mode; ``waveform_lengths`` adds mixed-length
batches (rows of different real lengths). Parameter names are the
reference's (``denoiser.model.…``, ``audio_encoder.…``,
``null_cond_emb``). ``SAIDPipeline.inference_streaming`` serves a clip of
any length as windows stitched through the editing path. With
``seq_group`` a clip's frames are sharded over the ranks of a process
group (sequence-parallel serving, the JAX ``seq_mesh``). The TPU-only
chunked denoise dispatch is not needed here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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
from said_tpu_torch.parallel.mesh import SlicedGenerator, randn
from said_tpu_torch.parallel.seq import frames_of, gather, shard_frames, sharded

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
    float32, as in the JAX package. ``remat``: gradient checkpointing of
    the UNet's blocks (training).
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
        remat: bool = False,
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
                cross_attention_dim=cross_dim, dtype=dtype, remat=remat,
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

    def get_audio_embedding(self, waveform: torch.Tensor, num_frames: Optional[int], input_length=None,
                            num_frames_real=None, mask_time_indices=None,
                            generator: Optional[torch.Generator] = None, seq_group=None) -> torch.Tensor:
        """(B, T_a) processed waveform → (B, num_frames, E) embedding; in
        bucketed mode ``input_length``/``num_frames_real`` are the real
        sample and frame counts (ints or (B,) numpy lengths).

        Training (the JAX ``get_audio_embedding`` with
        ``stop_encoder_grad``, said_tpu/models/said.py:129-155): the
        encoder is frozen, so it runs under ``no_grad`` and no gradient
        (nor its cost) reaches it; the trainable ``audio_proj_layer``
        follows. ``mask_time_indices`` (B, num_frames) bool applies
        spec-augment; ``generator`` runs the encoder in train mode
        (dropout and layerdrop drawn from it), None deterministic.

        ``seq_group``: the embedding of this rank's frames of the clip.
        Serving runs the encoder on them (frame-sharded); with real frame
        counts, spec-augment or a generator (sequence-parallel training,
        whose frozen encoder takes none of them frame-sharded) the encoder
        runs whole on every rank, on the replicated waveform, and the
        embedding is cut to the rank's frames. The trainable projection
        follows, on the rank's frames."""
        whole = sharded(seq_group) and not (num_frames_real is None and mask_time_indices is None
                                             and generator is None)
        with torch.no_grad():
            feats = self.audio_encoder(waveform, num_frames, input_length, num_frames_real, mask_time_indices,
                                       generator, None if whole else seq_group)
        if whole:
            feats = shard_frames(feats, seq_group)
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


def _denoise_lengths(window_real, do_cfg: bool):
    """Real frames per denoiser row: per-row lengths are tiled for the
    CFG-doubled batch (uncond rows first)."""
    if do_cfg and np.ndim(window_real) == 1:
        return np.concatenate([window_real, window_real])
    return window_real


def streaming_starts(total_frames: int, window_frames: int, overlap_frames: int) -> List[int]:
    """First frame of each window of :meth:`SAIDPipeline.inference_streaming`:
    a stride of ``window − overlap``, the last window moved back to end at
    the clip's last frame."""
    starts = [0]
    while starts[-1] + window_frames < total_frames:
        starts.append(min(starts[-1] + window_frames - overlap_frames, total_frames - window_frames))
    return starts


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
        self, waveform: torch.Tensor, window_size: int, do_cfg: bool, input_length=None, window_real=None,
        seq_group=None,
    ) -> Tuple[Dict[str, List[KVCache]], torch.Tensor]:
        """The loop-invariant stage: audio encoder, null embedding, banded
        K/V caches (CFG-doubled, uncond first) and the timestep table.
        Bucketed mode: ``input_length`` and ``window_real``, the real
        sample and frame counts (ints or (B,) numpy lengths).
        ``seq_group``: the encoder and the caches of this rank's frames."""
        model = self.model
        if (input_length is None) != (window_real is None):
            raise ValueError("bucketed mode needs both input_length and window_real")
        audio_emb = model.get_audio_embedding(waveform, window_size, input_length, window_real,
                                              seq_group=seq_group)
        context = audio_emb
        if do_cfg:
            uncond = model.null_embedding(audio_emb.shape[0], audio_emb.shape[1])
            context = torch.cat([uncond, audio_emb])
        seq = None if window_real is None else _denoise_lengths(window_real, do_cfg)
        kv_caches = build_kv_caches(model.unet, context, audio_emb.shape[1], seq_len_real=seq, seq_group=seq_group)
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
        length_bucket: int = 0,
        waveform_lengths: Optional[np.ndarray] = None,
        seq_group=None,
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

        ``length_bucket`` > 0: the window is padded to the next multiple of
        ``length_bucket`` frames and the waveform to match, and the clip
        runs in length-bucketed mode: its real frames equal an unpadded
        run, and the padded tail of the result is garbage (slice to the
        real window, as the CLIs do). Injected arrays are zero-padded to
        the padded window; drawn latents are drawn at its size.
        ``waveform_lengths`` (with ``length_bucket``): the real sample count
        of each row of ``waveform_processed``, a mixed-length batch; each
        row's real frames equal its own unpadded run.

        ``seq_group`` (a ``parallel.mesh.AxisGroup`` of the ranks that
        serve the clip; every rank calls with the same arguments):
        sequence-parallel sampling, the JAX ``seq_mesh``. The conv stack and
        the interpolation run unsharded on every rank; the encoder, the
        K/V caches and the denoise loop run on this rank's T/n frames
        (frame-sharded GroupNorm statistics, self-attention over gathered
        K/V), and the result is gathered: every rank returns the whole
        clip. Random arrays are drawn at the whole clip's shape from a
        generator seeded alike on every rank and sliced to the rank's
        frames (injected ones are sliced), so the result equals an
        unsharded run's. The group's size must divide the frame count
        (pad the clip via ``fit_audio_unet(divisor=...)``); exclusive with
        ``length_bucket``; no ``guidance_rescale`` (its std spans the
        clip). A group of one rank runs the normal route.
        """
        dev = self.device
        wave_np = np.array(waveform_processed, np.float32)
        if wave_np.ndim == 1:
            wave_np = wave_np[None]
        b, t_a = wave_np.shape
        window_size = int(t_a / self.sampling_rate * fps)
        c = self.model.in_channels

        dynamic = length_bucket > 0
        if seq_group is not None:
            # the JAX checks (said_tpu/models/said.py:586-597), before any work
            if dynamic:
                raise ValueError("seq_group is exclusive with length_bucket")
            if window_size % seq_group.size:
                raise ValueError(f"the seq axis size ({seq_group.size}) must divide the frame count "
                                 f"({window_size}); pad the clip via fit_audio_unet(divisor=...)")
            if guidance_rescale > 0.0:
                raise ValueError("guidance_rescale is not supported with seq_group (its std spans the whole clip)")
        sp = sharded(seq_group)
        window_real, t_a_real = window_size, t_a
        if waveform_lengths is not None:
            if not dynamic:
                raise ValueError("waveform_lengths requires length_bucket > 0")
            t_a_real = np.asarray(waveform_lengths, np.int64)
            if t_a_real.shape != (b,) or (t_a_real > t_a).any():
                raise ValueError(f"waveform_lengths must be ({b},) sample counts of at most {t_a}")
            window_real = (t_a_real / self.sampling_rate * fps).astype(np.int64)
            window_size = int(window_real.max())
        if dynamic:
            # the host checks what the kernels never read back: every
            # row keeps at least one real frame in every layer
            enc_real = self.model.audio_config.feature_extract_output_length(np.min(t_a_real))
            if np.min(window_real) < 1 or enc_real < 1:
                raise ValueError("every row needs at least one real frame in the encoder and the window")
            window_pad = int(np.ceil(window_size / length_bucket) * length_bucket)
            t_a_pad = max(int(np.ceil(window_pad * self.sampling_rate / fps)), t_a)
            wave_np = np.pad(wave_np, ((0, 0), (0, t_a_pad - t_a)))
            window_size, t_a = window_pad, t_a_pad
        wave = torch.as_tensor(wave_np, device=dev)

        # SP: this rank's frames, and draws of the whole clip sliced to them
        frames = frames_of(window_size, seq_group) if sp else slice(0, window_size)
        if sp:
            generator = SlicedGenerator(generator, 1, frames, window_size)

        def on_dev(a):
            if a is None:
                return None
            a = np.array(a, np.float32)
            if dynamic and a.shape[-2] < window_size:  # zero-pad the frame axis
                a = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, window_size - a.shape[-2]), (0, 0)])
            if sp:
                a = np.ascontiguousarray(a[..., frames, :])
            return torch.as_tensor(a, device=dev)

        if latents is None:
            if init_samples is None:
                lat = randn((b, frames.stop - frames.start, c), generator, dev)
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
        kv_caches, emb_table = self.prepare(
            wave, window_size, config.do_cfg,
            t_a_real if dynamic else None, window_real if dynamic else None, seq_group,
        )
        unet = self.model.unet
        seq = None
        if dynamic:
            seq = _denoise_lengths(window_real, config.do_cfg)
            # per-row lengths are uploaded once, here, for every step
            seq = torch.as_tensor(seq, dtype=torch.int32, device=dev) if np.ndim(seq) else int(seq)
        # the CFG fold takes one length for the batch; per-row lengths
        # run the unfolded path (their masks are per CFG row)
        fold = config.do_cfg and not isinstance(seq, torch.Tensor)

        def denoise_fn(x, t):
            return unet(x, kv_caches=kv_caches, emb=emb_table[t], cfg_fold=fold, seq_len_real=seq,
                        seq_group=seq_group)

        result, interms = sample(
            self.schedule,
            denoise_fn,
            lat,
            config,
            init_samples=on_dev(init_samples),
            mask=on_dev(mask),
            latent_scale=self.model.latent_scale,
            save_intermediate=save_intermediate,
            cfg_folded=fold,
            eta_noise=on_dev(eta_noise),
            edit_noise=on_dev(edit_noise),
            generator=generator,
        )
        if sp:
            result = gather(result, seq_group, dim=1)
            interms = None if interms is None else gather(interms, seq_group, dim=2)
        return SAIDInferenceOutput(
            result=result.cpu().numpy(),
            intermediates=None if interms is None else interms.cpu().numpy(),
        )

    def inference_streaming(
        self,
        waveform_processed: np.ndarray,
        window_frames: int = 3600,
        overlap_frames: int = 360,
        num_inference_steps: int = 100,
        guidance_scale: float = 2.5,
        guidance_rescale: float = 0.0,
        eta: float = 0.0,
        solver: str = "ddim",
        fps: int = 60,
        generator: Optional[torch.Generator] = None,
        window_noise: Optional[Sequence[Mapping[str, np.ndarray]]] = None,
    ) -> SAIDInferenceOutput:
        """Windowed long-clip serving (the JAX ``inference_streaming``,
        said_tpu/models/said.py:736): the clip is generated as successive
        ``window_frames``-frame windows; each window after the first runs
        the editing path with its leading frames pinned (mask 1) to the
        coefficients already generated for them, which the inpainting
        re-noising makes land on those values exactly at the last step, so
        windows join without seams. Self-attention then spans one window:
        work per clip-second is constant in clip length.

        ``window_frames`` must be a multiple of 3 (a frame is 800/3 samples
        at 16 kHz and 60 fps); ``0 < overlap_frames < window_frames``. The
        waveform is ``process_audio``-normalised over the whole clip. A clip
        that fits one window is a plain :meth:`inference` call.

        Randomness: every window draws from ``generator`` in turn (the JAX
        package splits one key a window). ``window_noise``, one mapping a
        window (:func:`streaming_starts` gives the windows), injects arrays
        that pass straight to :meth:`inference`: the first window's
        ``latents`` (B, window, C), a later window's ``edit_noise`` and
        ``eta_noise``. Returns the stitched (B, total_frames, C) result.
        """
        if window_frames % 3:
            raise ValueError("window_frames must be a multiple of 3 (a frame is 800/3 samples at 16 kHz / 60 fps, "
                             "so only 3-frame groups span whole samples)")
        if not 0 < overlap_frames < window_frames:
            raise ValueError(f"overlap_frames ({overlap_frames}) must be in (0, window_frames={window_frames})")
        wave = np.asarray(waveform_processed)
        if wave.ndim == 1:
            wave = wave[None]
        b, t_a = wave.shape
        total_frames = int(t_a / self.sampling_rate * fps)
        c = self.model.in_channels
        starts = streaming_starts(total_frames, window_frames, overlap_frames)
        if window_noise is not None and len(window_noise) != len(starts):
            raise ValueError(f"window_noise holds {len(window_noise)} windows, the clip has {len(starts)}")
        common = dict(num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                      guidance_rescale=guidance_rescale, eta=eta, solver=solver, fps=fps, generator=generator)

        def noise(k):
            return {} if window_noise is None else dict(window_noise[k])

        if total_frames <= window_frames:
            return self.inference(wave, **common, **noise(0))

        w = window_frames
        spf = self.sampling_rate / fps  # 800/3: not an integer
        wave_len = (w * self.sampling_rate) // fps  # exact: w % 3 == 0
        out = np.zeros((b, total_frames, c), np.float32)
        covered = 0
        for k, start in enumerate(starts):
            # the sample offset rounds to the nearest sample (a shift of at
            # most 1/3 sample); start + w ≤ total_frames keeps the slice in
            # the buffer
            s0 = min(int(round(start * spf)), t_a - wave_len)
            wave_k = wave[:, s0 : s0 + wave_len]
            if k == 0:
                out[:, :w] = self.inference(wave_k, **common, **noise(k)).result
            else:
                kept = covered - start  # the overlap; more only for the last window
                init = np.zeros((b, w, c), np.float32)
                init[:, :kept] = out[:, start:covered]
                mask = np.zeros((b, w, c), np.float32)
                mask[:, :kept] = 1.0
                res = self.inference(wave_k, init_samples=init, mask=mask, **common, **noise(k)).result
                out[:, covered : start + w] = res[:, kept:]
            covered = start + w
        return SAIDInferenceOutput(result=out, intermediates=None)
