"""The port's mesh I/O, list parser, asset tables and coefficient files
against the JAX package's, on the CPU: OBJ and PLY (ascii, binary
little-endian, triangles and polygons) read to the same arrays, files
written byte for byte the same, ``get_submesh`` identical."""

import filecmp
import os
import struct

import numpy as np
import pytest
from PIL import Image

from said_tpu.data.assets import _ASSETS
from said_tpu.data.assets import asset_path as j_asset_path
from said_tpu.utils import blendshape as j_blendshape
from said_tpu.utils import mesh as j_mesh
from said_tpu.utils.parser import parse_list as j_parse_list
from said_tpu_torch.data.assets import asset_path
from said_tpu_torch.utils import blendshape, mesh
from said_tpu_torch.utils.parser import parse_list


def random_mesh(seed, n_verts=40, n_faces=60):
    rng = np.random.default_rng(seed)
    return mesh.create_mesh(rng.standard_normal((n_verts, 3)), rng.integers(0, n_verts, (n_faces, 3)))


def assert_same(got, want):
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.vertices.dtype == want.vertices.dtype and got.faces.dtype == want.faces.dtype


@pytest.mark.parametrize("ext", ["obj", "ply"])
def test_saved_files_are_byte_identical_and_round_trip(tmp_path, ext):
    m = random_mesh(0)
    mesh.save_mesh(m, str(tmp_path / f"port.{ext}"))
    j_mesh.save_mesh(j_mesh.Mesh(m.vertices, m.faces), str(tmp_path / f"jax.{ext}"))
    assert filecmp.cmp(tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}", shallow=False)
    got = mesh.load_mesh(str(tmp_path / f"port.{ext}"))
    assert_same(got, j_mesh.load_mesh(str(tmp_path / f"port.{ext}")))
    atol = 5e-9 if ext == "obj" else 1e-6  # 8 decimals / float32
    np.testing.assert_allclose(got.vertices, m.vertices, rtol=0, atol=atol * 10)
    np.testing.assert_array_equal(got.faces, m.faces)


def test_obj_with_polygons_and_texture_indices(tmp_path):
    path = tmp_path / "poly.obj"
    path.write_text("# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 2 0.25\nvt 0 0\n"
                    "f 1/1/1 2/1/1 3/1/1 4/1/1\nf 3 5 4\n")
    got = mesh.load_mesh(str(path))
    assert_same(got, j_mesh.load_mesh(str(path)))
    np.testing.assert_array_equal(got.faces, [[0, 1, 2], [0, 2, 3], [2, 4, 3]])


def test_ascii_ply(tmp_path):
    m = random_mesh(1, 12, 9)
    lines = ["ply", "format ascii 1.0", "comment made by hand", f"element vertex {len(m.vertices)}",
             "property float x", "property float y", "property float z", "property uchar red",
             f"element face {len(m.faces)}", "property list uchar int vertex_indices", "end_header"]
    lines += [f"{x:.6f} {y:.6f} {z:.6f} 7" for x, y, z in m.vertices]
    lines += [f"3 {a} {b} {c}" for a, b, c in m.faces]
    path = tmp_path / "a.ply"
    path.write_text("\n".join(lines) + "\n")
    got = mesh.load_mesh(str(path))
    assert_same(got, j_mesh.load_mesh(str(path)))
    np.testing.assert_array_equal(got.faces, m.faces)


@pytest.mark.parametrize("polygons", [False, True], ids=["triangles", "quads"])
def test_binary_ply_with_extra_properties(tmp_path, polygons):
    """double vertices with a colour, ushort-counted faces; quads go face
    by face (fan-triangulated), triangles in one read."""
    rng = np.random.default_rng(2)
    verts = rng.standard_normal((10, 3))
    faces = [[0, 1, 2, 3], [4, 5, 6, 7], [1, 8, 9, 2]] if polygons else [[0, 1, 2], [3, 4, 5], [7, 8, 9]]
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 10\nproperty double x\nproperty double y\n"
              "property double z\nproperty uchar red\nelement face 3\nproperty list ushort uint vertex_indices\n"
              "end_header\n").encode()
    body = b"".join(struct.pack("<dddB", *v, 9) for v in verts)
    body += b"".join(struct.pack(f"<H{len(f)}I", len(f), *f) for f in faces)
    path = tmp_path / "b.ply"
    path.write_bytes(header + body)
    got = mesh.load_mesh(str(path))
    assert_same(got, j_mesh.load_mesh(str(path)))
    np.testing.assert_array_equal(got.vertices, verts)
    assert got.faces.shape == ((6, 3) if polygons else (3, 3))


def test_get_submesh_is_identical():
    m = random_mesh(3, 50, 120)
    sub = np.random.default_rng(3).permutation(50)[:31]
    got, want = mesh.get_submesh(m.vertices, m.faces, sub), j_mesh.get_submesh(m.vertices, m.faces, sub)
    assert_same(got, want)
    assert 0 < len(got.faces) < 120


def test_unsupported_format_raises(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        mesh.load_mesh(str(tmp_path / "x.stl"))
    with pytest.raises(ValueError, match="unsupported"):
        mesh.save_mesh(random_mesh(4), str(tmp_path / "x.stl"))


@pytest.mark.parametrize("name", _ASSETS)
def test_assets_and_parse_list_equal_the_jax_packages(name):
    assert filecmp.cmp(asset_path(name), j_asset_path(name), shallow=False)
    if name.endswith(".txt"):
        cast = str if "blendshapes" in name else int
        assert parse_list(asset_path(name), cast) == j_parse_list(j_asset_path(name), cast)
    else:
        got, cols = blendshape.load_blendshape_coeffs_columns(asset_path(name))
        want, jcols = j_blendshape.load_blendshape_coeffs_columns(j_asset_path(name))
        np.testing.assert_array_equal(got, want)
        assert cols == jcols
    with pytest.raises(KeyError):
        asset_path("no_such_table.txt")


def test_coefficient_image_equals_the_jax_packages(tmp_path):
    coeffs = np.random.default_rng(5).uniform(-0.1, 1.1, (30, 32))
    coeffs[0, :4] = [0.5 / 255, 1.5 / 255, 0.0, 1.0]  # rounding ties
    blendshape.save_blendshape_coeffs_image(coeffs, str(tmp_path / "port.png"))
    j_blendshape.save_blendshape_coeffs_image(coeffs, str(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == (32, 30) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "jax.png")))
    assert os.path.getsize(tmp_path / "port.png") > 0
