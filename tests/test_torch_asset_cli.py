"""The port's four asset CLIs against the JAX package's, on the CPU.

One synthetic tree (two test persons; a 132-vertex template cropped to 110
head vertices; a 12-frame mesh sequence a person) goes through
``preprocess_blendvoca`` → ``optimize_blendshape_coeffs`` → ``render`` and
``test_render`` of both packages, with the reference's flag spellings (as
``tests/test_cli_assets.py``). Held: the same OBJ bytes, the same output
files, CSVs within 1e-6, the same frame counts, PNG frames equal pixel
for pixel, and the AVIs' audio chunks equal. Then the port's four CLIs
run once more in a subprocess in which jax, the JAX package, pandas, PIL
and safetensors cannot be imported.
"""

import os
import pickle
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image
from scipy.io import wavfile

from said_tpu.cli import optimize_blendshape_coeffs as j_optimize
from said_tpu.cli import preprocess_blendvoca as j_preprocess
from said_tpu.cli import render as j_render
from said_tpu.cli import test_render as j_test_render
from said_tpu_torch.cli import optimize_blendshape_coeffs, preprocess_blendvoca, render, test_render
from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES, PERSON_IDS_TEST
from said_tpu_torch.utils.blendshape import load_blendshape_coeffs, save_blendshape_coeffs
from said_tpu_torch.utils.mesh import create_mesh, load_mesh, save_mesh

ROWS, COLS = 11, 12  # the template grid: 132 vertices
FRAMES = 12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grid_mesh(rows, cols, span=0.12, seed=0):
    """A front-facing vertex grid with a bump (renders to visible pixels)."""
    x, y = np.meshgrid(np.linspace(-span / 2, span / 2, cols), np.linspace(-span / 2, span / 2, rows))
    z = 0.02 * np.exp(-(x**2 + y**2) / 0.002)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    verts += 1e-4 * np.random.default_rng(seed).standard_normal(verts.shape)
    faces = []
    for r in range(rows - 1):
        for c in range(cols - 1):
            i = r * cols + c
            faces += [[i, i + 1, i + cols], [i + 1, i + cols + 1, i + cols]]
    return create_mesh(verts, np.asarray(faces))


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def avi_chunks(path):
    """The movi list's (fourcc, payload) chunks of an AVI."""
    data = open(path, "rb").read()
    start = data.index(b"movi") + 4
    (size,) = struct.unpack("<I", data[start - 8:start - 4])
    out, i = [], start
    while i < start - 4 + size:
        fourcc, (n,) = data[i:i + 4], struct.unpack("<I", data[i + 4:i + 8])
        out.append((fourcc, data[i + 8:i + 8 + n]))
        i += 8 + n + n % 2
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    rng = np.random.default_rng(0)
    head_idx = np.sort(rng.choice(ROWS * COLS, 110, replace=False))
    (root / "head_idx.txt").write_text("".join(f"{i}\n" for i in head_idx))
    (root / "templates").mkdir()
    deltas = {}
    for k, pid in enumerate(PERSON_IDS_TEST):
        template = grid_mesh(ROWS, COLS, seed=k)
        save_mesh(template, str(root / "templates" / f"{pid}.ply"))
        deltas[pid] = {name: 0.004 * rng.standard_normal((len(head_idx), 3)) for name in BLENDSHAPE_CLASSES}
    with open(root / "deltas.pickle", "wb") as f:
        pickle.dump(deltas, f)

    # each person's sentence 1: the cropped template plus the deltas times smooth interior weights
    weights = np.clip(0.5 + np.cumsum(rng.standard_normal((FRAMES, 32)) * 0.02, axis=0), 0.1, 0.9)
    for k, pid in enumerate(PERSON_IDS_TEST):
        template = grid_mesh(ROWS, COLS, seed=k)
        seq = root / "seqs" / pid / "sentence01"
        seq.mkdir(parents=True)
        basis = np.stack([deltas[pid][n] for n in BLENDSHAPE_CLASSES], axis=-1)  # (V_head, 3, 32)
        for t in range(FRAMES):
            verts = template.vertices.copy()
            verts[head_idx] += basis @ weights[t]
            save_mesh(create_mesh(verts, template.faces), str(seq / f"{t:05}.ply"))
    t = np.arange(int(FRAMES / 60 * 16000)) / 16000
    wavfile.write(root / "clip.wav", 16000, (0.4 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16))
    return root, weights


def preprocess_argv(root, out):
    return ["--templates_dir", str(root / "templates"), "--blendshape_residuals_path", str(root / "deltas.pickle"),
            "--head_idx_path", str(root / "head_idx.txt"), "--blendshapes_out_dir", str(out)]


def optimize_argv(root, blend, out):
    return ["--neutrals_dir", str(blend / "templates_head"), "--blendshapes_dir", str(blend / "blendshapes_head"),
            "--mesh_seqs_dir", str(root / "seqs"), "--blendshape_list_path", "/nonexistent",
            "--head_idx_path", str(root / "head_idx.txt"), "--blendshapes_coeffs_out_dir", str(out)]


@pytest.fixture(scope="module")
def pipeline(tree):
    """preprocess and optimize of both packages: {"jax"|"port": root}."""
    root, _ = tree
    outs = {}
    for name, pre, opt in (("jax", j_preprocess, j_optimize), ("port", preprocess_blendvoca,
                                                                optimize_blendshape_coeffs)):
        out = root / name
        pre.main(preprocess_argv(root, out / "BlendVOCA"))
        opt.main(optimize_argv(root, out / "BlendVOCA", out / "coeffs"))
        outs[name] = out
    return outs


def test_preprocess_writes_the_same_obj_bytes(pipeline):
    jax_dir, port_dir = pipeline["jax"] / "BlendVOCA", pipeline["port"] / "BlendVOCA"
    assert files(jax_dir) == files(port_dir)
    assert len(files(port_dir)) == 2 * (1 + 32)
    for rel in files(jax_dir):
        assert (jax_dir / rel).read_bytes() == (port_dir / rel).read_bytes(), rel


def test_optimize_csvs_match_and_recover_the_weights(pipeline, tree):
    _, weights = tree
    jax_dir, port_dir = pipeline["jax"] / "coeffs", pipeline["port"] / "coeffs"
    assert files(jax_dir) == files(port_dir) == sorted(f"{pid}/sentence01.csv" for pid in PERSON_IDS_TEST)
    for rel in files(jax_dir):
        got, want = load_blendshape_coeffs(str(port_dir / rel)), load_blendshape_coeffs(str(jax_dir / rel))
        assert got.shape == (FRAMES, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, weights, rtol=0, atol=5e-3)


def test_optimize_reports_the_solver(tree, pipeline, tmp_path, capsys):
    root, _ = tree
    solutions = optimize_blendshape_coeffs.main(optimize_argv(root, pipeline["port"] / "BlendVOCA", tmp_path))
    assert {s.solver for s in solutions.values()} == {"native"}
    assert all(0 < s.iterations <= 20000 for s in solutions.values())
    assert "solver native" in capsys.readouterr().out


def test_render_matches_the_jax_cli(tree, pipeline, tmp_path):
    root, _ = tree
    pid = PERSON_IDS_TEST[0]
    blend = pipeline["port"] / "BlendVOCA"
    csv = str(pipeline["port"] / "coeffs" / pid / "sentence01.csv")
    target = tmp_path / "target.csv"
    save_blendshape_coeffs(np.clip(load_blendshape_coeffs(csv) + 0.05, 0, 1), BLENDSHAPE_CLASSES, str(target))
    results = {}
    for name, cli in (("jax", j_render), ("port", render)):
        cli.main(["--neutral_path", str(blend / "templates_head" / f"{pid}.obj"),
                  "--blendshapes_dir", str(blend / "blendshapes_head" / pid), "--blendshape_coeffs_path", csv,
                  "--blendshape_list_path", "/nonexistent", "--audio_path", str(root / "clip.wav"),
                  "--output_path", str(tmp_path / f"{name}.avi"), "--show_difference", "True",
                  "--target_diff_blendshape_coeffs_path", str(target), "--save_images", "True",
                  "--output_images_dir", str(tmp_path / f"{name}_png"), "--width", "96", "--height", "96"])
        results[name] = avi_chunks(tmp_path / f"{name}.avi")
    jax_chunks, port_chunks = results["jax"], results["port"]
    assert [c for c, _ in jax_chunks] == [c for c, _ in port_chunks]
    assert sum(c == b"00dc" for c, _ in port_chunks) == FRAMES
    assert [p for c, p in jax_chunks if c == b"01wb"] == [p for c, p in port_chunks if c == b"01wb"]
    assert files(tmp_path / "jax_png") == files(tmp_path / "port_png") == sorted(f"{i}.png" for i in range(FRAMES))
    for i in range(FRAMES):
        got = np.asarray(Image.open(tmp_path / "port_png" / f"{i}.png"))
        want = np.asarray(Image.open(tmp_path / "jax_png" / f"{i}.png"))
        np.testing.assert_array_equal(got, want)


def test_test_render_matches_the_jax_cli(pipeline, tmp_path):
    pid = PERSON_IDS_TEST[0]
    blend = pipeline["port"] / "BlendVOCA"
    coeffs = load_blendshape_coeffs(str(pipeline["port"] / "coeffs" / pid / "sentence01.csv"))[:3]
    (tmp_path / "gen" / pid).mkdir(parents=True)
    for fname in ("sentence01.csv", "sentence01-1.csv"):
        save_blendshape_coeffs(coeffs, BLENDSHAPE_CLASSES, str(tmp_path / "gen" / pid / fname))
    for regex, want in (("(-.+)?", ["sentence01-1.avi", "sentence01.avi"]), ("", ["sentence01.avi"])):
        counts = {}
        for name, cli in (("jax", j_test_render), ("port", test_render)):
            out = tmp_path / f"{name}_{len(want)}"
            cli.main(["--audio_dir", str(tmp_path / "no_audio"), "--coeffs_dir", str(tmp_path / "gen"),
                      "--neutral_dir", str(blend / "templates_head"), "--blendshapes_dir",
                      str(blend / "blendshapes_head"), "--blendshape_list_path", "/nonexistent",
                      "--output_dir", str(out), "--repeat_regex", regex])
            assert files(out) == [f"{pid}/{f}" for f in want]
            counts[name] = [sum(c == b"00dc" for c, _ in avi_chunks(out / pid / f)) for f in want]
        assert counts["jax"] == counts["port"] == [3] * len(want)


_BLOCKED_RUN = textwrap.dedent(
    """
    import importlib, sys

    BLOCKED = ("jax", "flax", "pandas", "sklearn", "said_tpu", "PIL", "safetensors")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    argv = sys.argv[1:]
    while argv:  # <cli> <args...> [--then <cli> <args...>]...
        cut = argv.index("--then") if "--then" in argv else len(argv)
        importlib.import_module("said_tpu_torch.cli." + argv[0]).main(argv[1:cut])
        argv = argv[cut + 1 :]
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    """
)


def test_asset_clis_run_without_jax_pandas_pil_safetensors(tree, tmp_path):
    root, _ = tree
    pid = PERSON_IDS_TEST[1]
    blend = tmp_path / "BlendVOCA"
    csv = tmp_path / "coeffs" / pid / "sentence01.csv"
    (tmp_path / "gen" / pid).mkdir(parents=True)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN,
         "preprocess_blendvoca", *preprocess_argv(root, blend), "--then",
         "optimize_blendshape_coeffs", *optimize_argv(root, blend, tmp_path / "coeffs"), "--then",
         "render", "--neutral_path", str(blend / "templates_head" / f"{pid}.obj"), "--blendshapes_dir",
         str(blend / "blendshapes_head" / pid), "--blendshape_coeffs_path", str(csv), "--audio_path",
         str(root / "clip.wav"), "--output_path", str(tmp_path / "out.avi"), "--save_images", "True",
         "--output_images_dir", str(tmp_path / "png"), "--width", "64", "--height", "64", "--then",
         "test_render", "--coeffs_dir", str(tmp_path / "no_coeffs"), "--output_dir", str(tmp_path / "eval")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert load_mesh(str(blend / "templates_head" / f"{pid}.obj")).vertices.shape == (110, 3)
    assert load_blendshape_coeffs(str(csv)).shape == (FRAMES, 32)
    assert sum(c == b"00dc" for c, _ in avi_chunks(tmp_path / "out.avi")) == FRAMES
    assert len(os.listdir(tmp_path / "png")) == FRAMES
