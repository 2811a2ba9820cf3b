"""Blendshape-coefficient CSVs and the per-person deltas pickle.

The reference's CSV schema (``said/util/blendshape.py:36-70``): a header
of the 32 ARKit blendshape names, one row per 60 fps frame. Written and
read with the ``csv`` module (the machine with the card has no pandas);
the JAX package's ``said_tpu.utils.blendshape`` reads with pandas. The
coefficient image is a PNG from the port's own writer (no PIL).
"""

from __future__ import annotations

import csv
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from said_tpu_torch.utils.png import write_png


def load_blendshape_coeffs_columns(coeffs_path: str) -> Tuple[np.ndarray, List[str]]:
    """CSV (header + one row per frame) → ((T, C) float32, column names)."""
    with open(coeffs_path, newline="") as f:
        header, *rows = list(csv.reader(f))
    return np.asarray(rows, dtype=np.float32).reshape(len(rows), len(header)), header


def load_blendshape_coeffs(coeffs_path: str) -> np.ndarray:
    """CSV (header + one row per frame) → (T, C) float32 array."""
    return load_blendshape_coeffs_columns(coeffs_path)[0]


def save_blendshape_coeffs(coeffs: np.ndarray, classes: Sequence[str], output_path: str) -> None:
    """(T, C) array → CSV with the class-name header, one row per frame
    (each value as the shortest decimal that reads back to the same f32)."""
    coeffs = np.asarray(coeffs, np.float32)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(classes)
        writer.writerows([[str(v) for v in row] for row in coeffs])


def save_blendshape_coeffs_image(coeffs: np.ndarray, output_path: str) -> None:
    """(T, C) coefficients → grayscale PNG (classes × frames), each value
    255·c rounded and clipped to [0, 255]."""
    write_png(output_path, np.clip((255 * np.asarray(coeffs).T).round(), 0, 255).astype(np.uint8))


def load_blendshape_deltas(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{person_id: {blendshape_name: (|V|, 3) delta}} from the pickle the
    dataset ships (a trusted file of the training data)."""
    with open(path, "rb") as f:
        return pickle.load(f)
