"""Triangle-mesh I/O and submesh extraction, host numpy (no trimesh).

OBJ and PLY (ascii and binary little-endian) readers and writers for the
VOCASET/BlendVOCA assets: vertex positions and faces, read with the
reference's ``process=False, maintain_order=True`` semantics (no vertex
merging or reordering; ``said/util/mesh.py:17-31``). Files are written
byte for byte as the JAX package's ``said_tpu.utils.mesh`` writes them.

Binary PLY faces are parsed in one ``np.frombuffer`` when every face is a
triangle (every FLAME mesh), else face by face with fan triangulation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (|V|, 3) float
    faces: np.ndarray  # (|F|, 3) int


def load_mesh(mesh_path: str) -> Mesh:
    p = str(mesh_path)
    if p.lower().endswith(".obj"):
        return _load_obj(p)
    if p.lower().endswith(".ply"):
        return _load_ply(p)
    raise ValueError(f"unsupported mesh format: {p}")


def save_mesh(mesh: Mesh, out_path: str) -> None:
    p = str(out_path)
    if p.lower().endswith(".obj"):
        _save_obj(mesh, p)
    elif p.lower().endswith(".ply"):
        _save_ply(mesh, p)
    else:
        raise ValueError(f"unsupported mesh format: {p}")


def create_mesh(vertices: np.ndarray, faces: np.ndarray) -> Mesh:
    return Mesh(vertices=np.asarray(vertices, dtype=np.float64), faces=np.asarray(faces))


def get_submesh(vertices: np.ndarray, faces: np.ndarray, subindices: Sequence[int]) -> Mesh:
    """The submesh of the listed vertices (in their order), keeping the
    faces that lie wholly inside it, through a lookup table (the
    reference's ``list.index`` loop, ``said/util/mesh.py:34-64``, is
    O(F·V))."""
    subindices = np.asarray(subindices)
    vertices = np.asarray(vertices)
    remap = -np.ones(int(vertices.shape[0]), dtype=np.int64)
    remap[subindices] = np.arange(len(subindices))
    mapped = remap[np.asarray(faces)]
    keep = (mapped >= 0).all(axis=1)
    return Mesh(vertices=vertices[subindices], faces=mapped[keep])


# ------------------------------------------------------------------------ OBJ


def _load_obj(path: str) -> Mesh:
    vertices: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(vertices=np.asarray(vertices, dtype=np.float64),
                faces=np.asarray(faces, dtype=np.int64).reshape(-1, 3))


def _save_obj(mesh: Mesh, path: str) -> None:
    lines = [f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n" for v in np.asarray(mesh.vertices)]
    lines += [f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in np.asarray(mesh.faces)]
    with open(path, "w") as f:
        f.write("".join(lines))


# ------------------------------------------------------------------------ PLY

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_header(f):
    """(format, elements): each element a dict of name, count and props,
    a prop ``(type, name)`` or ``("list", count type, index type, name)``."""
    lines = []
    while True:
        line = f.readline().decode("ascii").strip()
        lines.append(line)
        if line == "end_header":
            break
    fmt, elements = "ascii", []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append({"name": parts[1], "count": int(parts[2]), "props": []})
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1]["props"].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1]["props"].append((parts[1], parts[2]))
    return fmt, elements


def _binary_faces(f, count: int, cnt_t: str, idx_t: str) -> np.ndarray:
    cnt_dt, idx_dt = np.dtype("<" + _PLY_DTYPES[cnt_t]), np.dtype("<" + _PLY_DTYPES[idx_t])
    triangles = np.dtype([("n", cnt_dt), ("idx", idx_dt, (3,))])
    start = f.tell()
    block = f.read(triangles.itemsize * count)
    if len(block) == triangles.itemsize * count:
        rows = np.frombuffer(block, dtype=triangles)
        if (rows["n"] == 3).all():
            return rows["idx"].astype(np.int64)
    f.seek(start)  # polygons: face by face, fan-triangulated
    out = []
    for _ in range(count):
        n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
        idx = np.frombuffer(f.read(idx_dt.itemsize * n), idx_dt)
        for k in range(1, n - 1):
            out.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(out, dtype=np.int64).reshape(-1, 3)


def _load_ply(path: str) -> Mesh:
    vertices = faces = None
    with open(path, "rb") as f:
        fmt, elements = _read_header(f)
        if fmt == "ascii":
            tokens = f.read().decode("ascii").split("\n")
            ti = 0
            for el in elements:
                rows = []
                for _ in range(el["count"]):
                    while not tokens[ti].strip():
                        ti += 1
                    rows.append(tokens[ti].split())
                    ti += 1
                if el["name"] == "vertex":
                    names = [p[1] for p in el["props"]]
                    xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                    vertices = np.array([[float(r[xi]), float(r[yi]), float(r[zi])] for r in rows])
                elif el["name"] == "face":
                    faces = np.array([[int(v) for v in r[1:4]] for r in rows])
        elif fmt == "binary_little_endian":
            for el in elements:
                if el["name"] == "face":
                    tag, cnt_t, idx_t, _ = el["props"][0]
                    if tag != "list":
                        raise ValueError(f"PLY face element without a vertex list in {path}")
                    faces = _binary_faces(f, el["count"], cnt_t, idx_t)
                    continue
                dt = np.dtype([(p[1], "<" + _PLY_DTYPES[p[0]]) for p in el["props"]])
                data = np.frombuffer(f.read(dt.itemsize * el["count"]), dtype=dt)
                if el["name"] == "vertex":  # any other fixed-size element is skipped
                    vertices = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float64)
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
    if vertices is None:
        raise ValueError(f"no vertex element in {path}")
    if faces is None:
        faces = np.zeros((0, 3), dtype=np.int64)
    return Mesh(vertices=vertices, faces=faces.astype(np.int64))


def _save_ply(mesh: Mesh, path: str) -> None:
    v = np.asarray(mesh.vertices, dtype="<f4")
    fc = np.asarray(mesh.faces, dtype="<i4").reshape(-1, 3)
    rows = np.empty(len(fc), dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
    rows["n"], rows["idx"] = 3, fc
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(fc)}\n"
              "property list uchar int vertex_indices\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(v.tobytes())
        f.write(rows.tobytes())
