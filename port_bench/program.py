"""What the benchmark takes from the program under test, ``said_tpu_torch``:
the model built from a configuration, the serving pipeline, the training
step, and the program's own kernel-launch counters. The only module of
the benchmark that imports the program.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict

import torch


def set_build_root(path: Path) -> None:
    """Build the kernels into, and load them and Triton's cache from,
    ``path`` (before anything loads)."""
    from said_tpu_torch import _build

    _build.set_build_root(path)


def configure_precision(dtype: str) -> None:
    from said_tpu_torch.cli._common import configure_precision as configure

    configure(dtype)


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The program's SAID at ``cfg``'s widths, in its compute dtype, holding
    a copy of ``weights``."""
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    audio = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["audio_encoder"].items()}
    unet = cfg["unet"]
    with torch.device(device):
        model = SAID(audio_config=Wav2Vec2Config(**audio), in_channels=unet["in_channels"],
                     diffusion_steps=cfg["diffusion_steps"], prediction_type=cfg["prediction_type"],
                     dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg["dtype"]])
    u = model.unet
    built = {"model_channels": u.model_channels, "num_head_channels": u.model_channels // u.num_heads,
             "in_channels": unet["in_channels"], "dropout": u.output_blocks[0][0].out_layers[2].p}
    if built != unet:
        raise ValueError(f"the program's UNet is {built}, the configuration states {unet}")
    model.load_state_dict(weights, strict=True)
    return model


def pipeline(model):
    from said_tpu_torch.models.said import SAIDPipeline

    return SAIDPipeline(model.eval())


def process_audio(wave):
    from said_tpu_torch.models.said import process_audio as process

    return process(wave)


def fit_audio(wave, sampling_rate: int, fps: int):
    """The CLI's fit of a clip: zero-padded to whole 60 fps frames; the
    frame count of the original length."""
    from said_tpu_torch.utils.audio import fit_audio_unet

    fit = fit_audio_unet(wave, sampling_rate, fps, 1)
    return fit.waveform, fit.window_size


def train_state(model, train: dict):
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.train.said_train import TrainConfig, TrainState

    config = TrainConfig(learning_rate=train["learning_rate"], warmup_steps=train["warmup_steps"],
                         grad_clip=train["grad_clip"], ema_decay=train["ema_decay"], weight_vel=train["weight_vel"])
    return TrainState(model, config), DiffusionSchedule.create(model.diffusion_steps, model.prediction_type)


def train_step(state, schedule, batch: dict, generator):
    from said_tpu_torch.train.said_train import train_step as step

    return step(state, schedule, batch, generator)


# the program's launch counters: (module, function) whose ``.launches``
# counts its kernel's launches
COUNTERS = {
    "flash_attention": ("said_tpu_torch.ops.attention", "flash_attention_kernel"),
    "geglu_ffn": ("said_tpu_torch.ops.ffn", "geglu_ffn_kernel"),
    "strided_conv_gelu": ("said_tpu_torch.ops.conv", "strided_conv_gelu_kernel"),
    "layer_norm": ("said_tpu_torch.ops.norms", "layer_norm_kernel"),
    "group_norm": ("said_tpu_torch.ops.norms", "group_norm_kernel"),
    "group_norm_masked": ("said_tpu_torch.ops.norms", "group_norm_masked_kernel"),
}


def launch_counts() -> Dict[str, int]:
    """Each counter the program still has, by name."""
    out = {}
    for name, (module, fn) in COUNTERS.items():
        try:
            out[name] = int(getattr(importlib.import_module(module), fn).launches)
        except (ImportError, AttributeError):
            continue
    return out
