"""Build each person's neutral and blendshape meshes from the VOCASET
templates.

Flag-compatible with ``said_tpu/cli/preprocess_blendvoca.py`` (the
reference's ``script/preprocess_blendvoca.py``): each template
``<templates_dir>/<person>.ply`` is cropped to the FLAME head vertices,
saved as ``<neutrals_dir>/<person>.obj``, and the 32 ARKit blendshape
deltas of the deltas pickle are added to it, one OBJ each in
``<blendshapes_dir>/<person>/``. Persons without a template or deltas
are skipped. Host numpy only. ``--blendshapes_out_dir`` (the reference's
one-directory layout) sets both output directories. Path defaults stay in
the working directory; ``--compilation_cache_dir`` is TPU-only and not
carried over.

    python -m said_tpu_torch.cli.preprocess_blendvoca --templates_dir VOCA_Template \\
        --blendshape_deltas_path blendshape_deltas.pickle --blendshapes_out_dir BlendVOCA
"""

from __future__ import annotations

import argparse
import os

from said_tpu_torch.data.assets import asset_path
from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES, PERSON_IDS_TEST, PERSON_IDS_TRAIN, PERSON_IDS_VAL
from said_tpu_torch.utils.blendshape import load_blendshape_deltas
from said_tpu_torch.utils.mesh import create_mesh, get_submesh, load_mesh, save_mesh
from said_tpu_torch.utils.parser import parse_list


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--templates_dir", type=str, default="VOCA_Template")
    parser.add_argument("--blendshape_deltas_path", "--blendshape_residuals_path",  # the reference's name for it
                        type=str, default="blendshape_deltas.pickle")
    parser.add_argument("--head_idx_path", type=str, default=asset_path("FLAME_head_idx.txt"))
    parser.add_argument("--blendshapes_out_dir", type=str, default="",
                        help="one directory for templates_head/ and blendshapes_head/ (the reference's layout)")
    parser.add_argument("--neutrals_dir", type=str, default="templates_head")
    parser.add_argument("--blendshapes_dir", type=str, default="blendshapes_head")


def main(argv=None) -> list:
    """Run the CLI; returns the persons it processed."""
    parser = argparse.ArgumentParser(description="Preprocess the BlendVOCA blendshape meshes (PyTorch port)")
    add_arguments(parser)
    args = parser.parse_args(argv)
    if args.blendshapes_out_dir:
        args.neutrals_dir = os.path.join(args.blendshapes_out_dir, "templates_head")
        args.blendshapes_dir = os.path.join(args.blendshapes_out_dir, "blendshapes_head")

    head_idx = parse_list(args.head_idx_path, int)
    blendshape_deltas = load_blendshape_deltas(args.blendshape_deltas_path)
    os.makedirs(args.neutrals_dir, exist_ok=True)
    done = []
    for pid in PERSON_IDS_TRAIN + PERSON_IDS_VAL + PERSON_IDS_TEST:
        template_path = os.path.join(args.templates_dir, f"{pid}.ply")
        if not os.path.exists(template_path) or pid not in blendshape_deltas:
            continue  # partial checkouts are common; process what exists
        template = load_mesh(template_path)
        sub = get_submesh(template.vertices, template.faces, head_idx)
        save_mesh(create_mesh(sub.vertices, sub.faces), os.path.join(args.neutrals_dir, f"{pid}.obj"))
        out_dir = os.path.join(args.blendshapes_dir, pid)
        os.makedirs(out_dir, exist_ok=True)
        deltas = blendshape_deltas[pid]
        for name in BLENDSHAPE_CLASSES:
            save_mesh(create_mesh(sub.vertices + deltas[name], sub.faces), os.path.join(out_dir, f"{name}.obj"))
        print(f"processed {pid}")
        done.append(pid)
    return done


if __name__ == "__main__":
    main()
