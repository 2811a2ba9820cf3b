"""Shared CLI plumbing: model construction, weights (SAiD's, an HF
wav2vec2 snapshot's audio encoder, the BCVAE's), precision; the CSV I/O
of ``said_tpu_torch.utils.blendshape`` (a header of the 32 ARKit
blendshape names, then one row per 60 fps frame; no pandas).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES
from said_tpu_torch.models.layers import GroupNorm32, LayerNormF32
from said_tpu_torch.models.said import SAID
from said_tpu_torch.models.vae import BCVAE
from said_tpu_torch.utils.blendshape import (  # noqa: F401 (the CLIs' CSV I/O)
    load_blendshape_coeffs,
    save_blendshape_coeffs,
    save_blendshape_coeffs_image,
)
from said_tpu_torch.utils.hf_snapshot import load_snapshot, snapshot_file

# The CSV header: the order of said_tpu/data/assets/ARKit_blendshapes.txt.
ARKIT_BLENDSHAPES = tuple(BLENDSHAPE_CLASSES)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

ORBAX_REFUSAL = ("{path!r} is a directory without model.safetensors or pytorch_model.bin, so not an HF snapshot: "
                 "an orbax checkpoint directory is a JAX checkpoint format, which said_tpu_torch does not read; "
                 "export it to a reference-named .pth with said_tpu.core.checkpoint.export_said_to_torch")


def str2bool(v) -> bool:
    """Argparse bool that parses false/0/no/off as False."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "on"):
        return True
    if s in ("false", "0", "no", "n", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def configure_precision(dtype: str) -> None:
    """In float32 mode keep full f32 on the card: matmuls and cuDNN
    convolutions default to TF32 otherwise (cuDNN does by default), which
    keeps about three decimal digits."""
    if dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def build_said_model(
    prediction_type: str = "epsilon", feature_dim: int = -1, dtype: str = "float32", remat: bool = False
) -> SAID:
    """The full-width SAID model (wav2vec2-base + the 192-channel UNet);
    ``remat``: gradient checkpointing of the UNet's blocks (training)."""
    return SAID(feature_dim=feature_dim, prediction_type=prediction_type, dtype=DTYPES[dtype], remat=remat)


def random_init_(model: SAID, seed: int = 0) -> SAID:
    """Non-degenerate random weights (the JAX ``fast_init`` rule): biases 0,
    norm scales 1, everything else N(0, 0.02) from
    ``np.random.default_rng(seed)``, drawn in sorted parameter-name order.
    The positional conv's ``weight_g`` is set to ‖weight_v‖, so its
    effective weight is the drawn ``weight_v``.

    (Zero-initialised output convs would make the denoiser return exactly
    0, and every comparison would pass vacuously.)
    """
    norm_weights = {
        f"{name}.weight"
        for name, m in model.named_modules()
        if isinstance(m, (GroupNorm32, LayerNormF32))
    }
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in sorted(model.state_dict().items()):
        if name.endswith("bias"):
            a = np.zeros(p.shape, np.float32)
        elif name in norm_weights:
            a = np.ones(p.shape, np.float32)
        else:
            a = (rng.standard_normal(p.shape) * 0.02).astype(np.float32)
        sd[name] = torch.from_numpy(a)
    for name in [n for n in sd if n.endswith(".weight_g")]:
        v = sd[name[: -len("weight_g")] + "weight_v"].double()
        sd[name] = torch.sqrt((v**2).sum(dim=(0, 1), keepdim=True)).float()
    model.load_state_dict(sd, strict=True)
    return model


def _torch_names(sd):
    """Newer torch serialises weight norm through parametrizations; the
    port's modules keep ``weight_g``/``weight_v``."""
    renamed = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        renamed[k.replace("parametrizations.weight.original1", "weight_v")] = v
    return renamed


def load_audio_encoder_snapshot(model: SAID, directory: str) -> None:
    """Load the audio encoder from an HF wav2vec2 snapshot directory (names
    with or without the ``wav2vec2.`` prefix; ``lm_head.*`` and other
    extras are ignored). Every encoder tensor but ``masked_spec_embed``
    must be there, with the model's shape."""
    sd = load_snapshot(directory)
    prefix = "wav2vec2." if any(k.startswith("wav2vec2.") for k in sd) else ""
    sd = _torch_names({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    want = model.audio_encoder.state_dict()
    missing = sorted(k for k in want if k not in sd and k != "masked_spec_embed")
    if missing:
        raise KeyError(f"HF snapshot {directory!r} lacks audio-encoder tensors {missing[:5]} "
                       f"({len(missing)} in all)")
    model.audio_encoder.load_state_dict({k: sd[k] for k in want if k in sd}, strict=False)


def load_said_weights(model: SAID, weights_path: Optional[str], seed: int = 0) -> SAID:
    """Weights for SAID, by what ``weights_path`` names:

    - empty: random, by :func:`random_init_` from ``seed``;
    - a file: a reference-named torch state_dict (``SAiD.pth``, or the JAX
      package's ``export_said_to_torch`` output), loaded ``strict=True``;
    - a directory with ``model.safetensors`` or ``pytorch_model.bin``: an HF
      wav2vec2 snapshot (the reference's training init): the audio encoder
      from it, the rest random from ``seed``.

    Any other directory (an orbax checkpoint, a JAX format) raises
    ``ValueError``; a path that names nothing raises ``FileNotFoundError``.
    """
    if not weights_path:
        return random_init_(model, seed)
    if os.path.isdir(weights_path):
        if snapshot_file(weights_path) is None:
            raise ValueError(ORBAX_REFUSAL.format(path=weights_path))
        random_init_(model, seed)
        load_audio_encoder_snapshot(model, weights_path)
        return model
    if not os.path.isfile(weights_path):
        raise FileNotFoundError(f"weights file not found: {weights_path!r} (pass an empty path for random weights)")
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    model.load_state_dict(_torch_names(sd), strict=True)
    return model


def load_vae(weights_path: Optional[str], seed: int = 0, device: torch.device = torch.device("cuda")) -> BCVAE:
    """The BCVAE on ``device`` in eval mode: a reference ``vae.pth`` (or a
    ``train_vae`` export) loaded with ``strict=True``, or, with an empty
    path, PyTorch's default init drawn from ``seed``. A path that names no
    file raises ``FileNotFoundError``."""
    if not weights_path:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return BCVAE().to(device).eval()
    if not os.path.isfile(weights_path):
        raise FileNotFoundError(f"VAE weights file not found: {weights_path!r} (pass an empty path for random weights)")
    model = BCVAE()
    model.load_state_dict(torch.load(weights_path, map_location="cpu", weights_only=True), strict=True)
    return model.to(device).eval()
