"""Train-state checkpoints (resume) and the reference-compatible ``.pth``.

The JAX package saves the full train state with orbax under
``<output_dir>/ckpt/<epoch>`` and exports ``<output_dir>/<epoch>.pth``
(said_tpu/core/checkpoint.py:21, :126, :192). Here the train state
(model with its frozen encoder, optimizer count and moments, EMA, step)
is one ``torch.save`` file in the same directory, ``--resume`` takes that
directory, and the ``.pth`` holds the EMA weights under the reference's
names, loadable with ``strict=True`` by the port's and the reference's
models.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from said_tpu_torch.train.said_train import TrainState

STATE_FILE = "train_state.pt"


def save_train_state(ckpt_dir: str, state_dict: dict, epoch: int) -> str:
    """Save a train state's ``state_dict()`` to
    ``<ckpt_dir>/<epoch>/train_state.pt``; returns the checkpoint directory.
    (The caller takes the ``state_dict``: under tensor parallelism every
    rank of the model axis takes part in it, and one rank writes.)"""
    path = os.path.join(os.path.abspath(ckpt_dir), str(epoch))
    os.makedirs(path, exist_ok=True)
    torch.save(state_dict, os.path.join(path, STATE_FILE))
    return path


def restore_train_state(path: str, state: TrainState) -> None:
    """Load a checkpoint directory written by ``save_train_state`` into
    ``state`` (its tensors onto the model's device)."""
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    state.load_state_dict(saved)


def save_pth(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """A ``state_dict`` as a ``.pth`` file (tensors on the CPU)."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
