"""Shared CLI plumbing: model construction, weights, precision, CSV I/O.

The CSV is written with the ``csv`` module (no pandas): a header of the
32 ARKit blendshape names, then one row per 60 fps frame.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Optional, Sequence

import numpy as np
import torch

from said_tpu_torch.models.layers import GroupNorm32, LayerNormF32
from said_tpu_torch.models.said import SAID

# The order of said_tpu/data/assets/ARKit_blendshapes.txt (the CSV header).
ARKIT_BLENDSHAPES = (
    "jawForward", "jawLeft", "jawRight", "jawOpen", "mouthClose",
    "mouthFunnel", "mouthPucker", "mouthLeft", "mouthRight",
    "mouthSmileLeft", "mouthSmileRight", "mouthFrownLeft", "mouthFrownRight",
    "mouthDimpleLeft", "mouthDimpleRight", "mouthStretchLeft",
    "mouthStretchRight", "mouthRollLower", "mouthRollUpper",
    "mouthShrugLower", "mouthShrugUpper", "mouthPressLeft", "mouthPressRight",
    "mouthLowerDownLeft", "mouthLowerDownRight", "mouthUpperUpLeft",
    "mouthUpperUpRight", "cheekPuff", "cheekSquintLeft", "cheekSquintRight",
    "noseSneerLeft", "noseSneerRight",
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    prediction_type: str = "epsilon", feature_dim: int = -1, dtype: str = "float32"
) -> SAID:
    """The full-width SAID model (wav2vec2-base + the 192-channel UNet)."""
    return SAID(feature_dim=feature_dim, prediction_type=prediction_type, dtype=DTYPES[dtype])


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


def load_said_weights(model: SAID, weights_path: Optional[str], seed: int = 0) -> SAID:
    """Load a reference-named torch state_dict (``SAiD.pth``, or the JAX
    package's ``export_said_to_torch`` output) with ``strict=True``; with an
    empty path, random-initialise with :func:`random_init_`. A path that
    names no file raises ``FileNotFoundError``."""
    if not weights_path:
        return random_init_(model, seed)
    if not os.path.isfile(weights_path):
        raise FileNotFoundError(f"weights file not found: {weights_path!r} (pass an empty path for random weights)")
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    # newer torch serialises weight norm through parametrizations
    renamed = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        renamed[k.replace("parametrizations.weight.original1", "weight_v")] = v
    model.load_state_dict(renamed, strict=True)
    return model


def save_blendshape_coeffs(coeffs: np.ndarray, classes: Sequence[str], output_path: str) -> None:
    """(T, C) array → CSV with the class-name header, one row per frame
    (each value as the shortest decimal that reads back to the same f32)."""
    coeffs = np.asarray(coeffs, np.float32)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(classes)
        writer.writerows([[str(v) for v in row] for row in coeffs])


def load_blendshape_coeffs(coeffs_path: str) -> np.ndarray:
    """CSV (header + one row per frame) → (T, C) float32 array."""
    with open(coeffs_path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return np.asarray(rows, dtype=np.float32).reshape(len(rows), -1)


def save_blendshape_coeffs_image(coeffs: np.ndarray, output_path: str) -> None:
    """(T, C) coefficients → grayscale PNG (classes × frames)."""
    from PIL import Image

    orig = (255 * np.asarray(coeffs).T).round()
    Image.fromarray(orig).convert("L").save(output_path)
