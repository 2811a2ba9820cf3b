"""Pseudo-GT blendshape coefficients by a whole-sequence QP per sentence.

Flag-compatible with ``said_tpu/cli/optimize_blendshape_coeffs.py`` (the
reference's ``script/optimize_blendshape_coeffs.py``): per person, the
blendshape matrix from its neutral and blendshape OBJs; per sentence,
the box- and smoothness-constrained QP over its whole mesh sequence
(each mesh cropped to the FLAME head vertices when ``--head_idx_path``
names a file), written as ``<output_dir>/<person>/sentenceXX.csv``. The
solver is ``optimize.qp``'s "auto": the native float64 one, or, if it
cannot be built, the float32 ADMM on ``--device`` with a warning; each
sentence's line says which ran. Path defaults stay in the working
directory; ``--compilation_cache_dir`` is TPU-only and not carried over.

    python -m said_tpu_torch.cli.optimize_blendshape_coeffs --neutrals_dir BlendVOCA/templates_head \\
        --blendshapes_dir BlendVOCA/blendshapes_head --mesh_seqs_dir BlendVOCA/unposedcleaneddata \\
        --output_dir BlendVOCA/blendshape_coeffs
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from said_tpu_torch.cli._common import parse_cli_args
from said_tpu_torch.data.assets import asset_path
from said_tpu_torch.data.blendvoca import (
    BLENDSHAPE_CLASSES,
    PERSON_IDS_TEST,
    PERSON_IDS_TRAIN,
    PERSON_IDS_VAL,
    SENTENCE_IDS,
    BlendVOCAPseudoGTOptDataset,
)
from said_tpu_torch.optimize.qp import OptimizationProblemFull
from said_tpu_torch.utils.blendshape import save_blendshape_coeffs
from said_tpu_torch.utils.parser import parse_list


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--neutrals_dir", type=str, default="templates_head")
    parser.add_argument("--blendshapes_dir", type=str, default="blendshapes_head")
    parser.add_argument("--mesh_seqs_dir", type=str, default="unposedcleaneddata")
    parser.add_argument("--blendshape_list_path", type=str, default=asset_path("ARKit_blendshapes.txt"))
    parser.add_argument("--head_idx_path", type=str, default=asset_path("FLAME_head_idx.txt"))
    parser.add_argument("--output_dir", "--blendshapes_coeffs_out_dir",  # the reference's name for it
                        type=str, default="blendshape_coeffs")
    parser.add_argument("--delta", type=float, default=0.1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the float32 ADMM, which runs if the native solver cannot be built")


def main(argv=None) -> dict:
    """Run the CLI; returns {(person, sentence): QPSolution}."""
    parser = argparse.ArgumentParser(description="Optimize pseudo-GT blendshape coefficients (PyTorch port)")
    add_arguments(parser)
    args = parse_cli_args(parser, argv)

    names = (parse_list(args.blendshape_list_path, str) if os.path.exists(args.blendshape_list_path)
             else BLENDSHAPE_CLASSES)
    head_idx = parse_list(args.head_idx_path, int) if os.path.exists(args.head_idx_path) else None
    dataset = BlendVOCAPseudoGTOptDataset(args.neutrals_dir, args.blendshapes_dir, args.mesh_seqs_dir, names)

    solutions = {}
    for pid in PERSON_IDS_TRAIN + PERSON_IDS_VAL + PERSON_IDS_TEST:
        try:
            neutral, blendshapes = dataset.get_blendshapes(pid)
        except FileNotFoundError:
            continue
        matrix = np.stack([blendshapes[name].vertices.reshape(-1) for name in names], axis=1)
        problem = OptimizationProblemFull(neutral.vertices.reshape(-1, 1), matrix, device=args.device)
        out_dir = os.path.join(args.output_dir, pid)
        os.makedirs(out_dir, exist_ok=True)
        for sid in SENTENCE_IDS:
            mesh_seq = dataset.get_mesh_seq(pid, sid)
            if not mesh_seq:
                continue
            verts = [(m.vertices[head_idx] if head_idx else m.vertices).reshape(-1, 1) for m in mesh_seq]
            solution = problem.solve(verts, delta=args.delta)
            save_blendshape_coeffs(solution.w, names, os.path.join(out_dir, f"sentence{sid:02}.csv"))
            print(f"{pid}/sentence{sid:02}: {solution.w.shape[0]} frames, solver {solution.solver}, "
                  f"{solution.iterations} iterations")
            solutions[pid, sid] = solution
    return solutions


if __name__ == "__main__":
    main()
