"""Render every generated CSV of an evaluation directory to video.

Flag-compatible with ``said_tpu/cli/test_render.py`` (the reference's
``script/test_render.py``): for each test person with a directory under
``--coeffs_dir``, every ``sentenceXX<repeat>.csv`` whose part between
``sentenceXX`` and ``.csv`` fully matches ``--repeat_regex`` (and, with
``--repeat_index`` k ≥ 0, only ``sentenceXX-k.csv``) becomes
``<output_dir>/<person>/sentenceXX<repeat>.avi`` at 800×800 with the
sentence's WAV. One process renders everything (the reference restarted
Python per repeat for a pyrender leak). Path defaults stay in the working
directory; ``--compilation_cache_dir`` is TPU-only and not carried over.

    python -m said_tpu_torch.cli.test_render --audio_dir BlendVOCA/audio --coeffs_dir out \\
        --neutrals_dir BlendVOCA/templates_head --blendshapes_dir BlendVOCA/blendshapes_head
"""

from __future__ import annotations

import argparse
import os
import re

from said_tpu_torch.cli._common import parse_cli_args
from said_tpu_torch.cli.render import blendshape_names, load_blendshape_setup, render_video
from said_tpu_torch.data.assets import asset_path
from said_tpu_torch.data.blendvoca import PERSON_IDS_TEST, SENTENCE_IDS
from said_tpu_torch.render.rasterizer import Renderer
from said_tpu_torch.utils.audio import load_audio
from said_tpu_torch.utils.blendshape import load_blendshape_coeffs


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--audio_dir", type=str, default="audio")
    parser.add_argument("--coeffs_dir", type=str, default="out")
    parser.add_argument("--neutrals_dir", "--neutral_dir",  # the reference's name for it
                        type=str, default="templates_head")
    parser.add_argument("--blendshapes_dir", type=str, default="blendshapes_head")
    parser.add_argument("--blendshape_list_path", type=str, default=asset_path("ARKit_blendshapes.txt"))
    parser.add_argument("--output_dir", type=str, default="render_out")
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--repeat_index", type=int, default=-1,
                        help="render only sentenceXX-<idx>.csv files (-1 = all)")
    parser.add_argument("--repeat_regex", type=str, default="(-.+)?",
                        help="regex the part of the filename between sentenceXX and .csv must fully match "
                             "(reference script/test_render.py:62-67)")


def main(argv=None) -> dict:
    """Run the CLI; returns {output path: frames}."""
    parser = argparse.ArgumentParser(description="Render all evaluation outputs (PyTorch port)")
    add_arguments(parser)
    args = parse_cli_args(parser, argv)

    names = blendshape_names(args.blendshape_list_path)
    renderer = Renderer()
    rendered = {}
    for pid in PERSON_IDS_TEST:
        coeffs_dir = os.path.join(args.coeffs_dir, pid)
        if not os.path.isdir(coeffs_dir):
            continue
        neutral, matrix = load_blendshape_setup(os.path.join(args.neutrals_dir, f"{pid}.obj"),
                                                os.path.join(args.blendshapes_dir, pid), names)
        out_dir = os.path.join(args.output_dir, pid)
        os.makedirs(out_dir, exist_ok=True)
        for sid in SENTENCE_IDS:
            base = f"sentence{sid:02}"
            audio_path = os.path.join(args.audio_dir, pid, f"{base}.wav")
            audio = load_audio(audio_path, 16000) if os.path.exists(audio_path) else None
            for fname in sorted(os.listdir(coeffs_dir)):
                if not fname.startswith(base) or not fname.endswith(".csv"):
                    continue
                if args.repeat_index >= 0 and fname != f"{base}-{args.repeat_index}.csv":
                    continue
                if re.fullmatch(args.repeat_regex, fname[len(base):-len(".csv")]) is None:
                    continue
                out_path = os.path.join(out_dir, fname.replace(".csv", ".avi"))
                frames, _, _ = render_video(renderer, neutral, matrix,
                                            load_blendshape_coeffs(os.path.join(coeffs_dir, fname)),
                                            out_path, args.fps, audio)
                rendered[out_path] = len(frames)
                print(f"rendered {pid}/{fname}")
    return rendered


if __name__ == "__main__":
    main()
