"""Blendshape-coefficient CSVs and the per-person deltas pickle.

The reference's CSV schema (``said/util/blendshape.py:36-70``): a header
of the 32 ARKit blendshape names, one row per 60 fps frame. Written and
read with the ``csv`` module (the machine with the card has no pandas);
the JAX package's ``said_tpu.utils.blendshape`` reads with pandas.
"""

from __future__ import annotations

import csv
import pickle
from typing import Dict, Sequence

import numpy as np


def load_blendshape_coeffs(coeffs_path: str) -> np.ndarray:
    """CSV (header + one row per frame) → (T, C) float32 array."""
    with open(coeffs_path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return np.asarray(rows, dtype=np.float32).reshape(len(rows), -1)


def save_blendshape_coeffs(coeffs: np.ndarray, classes: Sequence[str], output_path: str) -> None:
    """(T, C) array → CSV with the class-name header, one row per frame
    (each value as the shortest decimal that reads back to the same f32)."""
    coeffs = np.asarray(coeffs, np.float32)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(classes)
        writer.writerows([[str(v) for v in row] for row in coeffs])


def save_blendshape_coeffs_image(coeffs: np.ndarray, output_path: str) -> None:
    """(T, C) coefficients → grayscale PNG (classes × frames)."""
    from PIL import Image

    orig = (255 * np.asarray(coeffs).T).round()
    Image.fromarray(orig).convert("L").save(output_path)


def load_blendshape_deltas(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{person_id: {blendshape_name: (|V|, 3) delta}} from the pickle the
    dataset ships (a trusted file of the training data)."""
    with open(path, "rb") as f:
        return pickle.load(f)
