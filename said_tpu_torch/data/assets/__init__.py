"""The BlendVOCA/ARKit protocol tables, the port's own copy.

The same few-KB text tables as ``said_tpu/data/assets`` (reference
``data/README.md:1-30``), so the port runs without the JAX package:

- ``ARKit_blendshapes.txt``: the 32 ARKit blendshape names, the column
  order of every coefficients CSV;
- ``ARKit_landmarks.txt``, ``FLAME_landmarks.txt``,
  ``FLAME_head_landmarks.txt``: landmark vertex indices on the ARKit
  reference mesh, the FLAME template and the cropped FLAME head;
- ``FLAME_head_idx.txt``: the FLAME template's vertex indices of the head
  submesh, the crop every BlendVOCA mesh uses;
- ``coeffs_std.csv``: per-blendshape standard deviations of the
  pseudo-GT coefficients.

The CLIs' ``--*_path`` flags override each of them.
"""

from __future__ import annotations

from importlib import resources

_ASSETS = (
    "ARKit_blendshapes.txt",
    "ARKit_landmarks.txt",
    "FLAME_head_idx.txt",
    "FLAME_head_landmarks.txt",
    "FLAME_landmarks.txt",
    "coeffs_std.csv",
)


def asset_path(name: str) -> str:
    """Absolute path of one of the tables above."""
    if name not in _ASSETS:
        raise KeyError(f"unknown asset {name!r}; have {_ASSETS}")
    return str(resources.files(__package__).joinpath(name))
