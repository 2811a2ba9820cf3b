"""What every run shares: the manifest, a cell's files found by name, the
card check, the checks and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``, which names its loop, ``loops/<loop>.py``;
its limits are ``limits/<cell>.json``. Each metric of the manifest is
read from the run's record by ``metrics/<metric>.py``, or by the reader
of its stem (``reader``). Adding a cell, a
mix, a loop or a metric adds files and manifest entries and edits none.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
MANIFEST = REPO / "BENCHMARK.json"
# the build and kernel caches: one fixed directory inside the checkout
BUILD_ROOT = REPO / "build" / "port_bench"
# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "said_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: List[dict]  # the manifest's metrics this cell reports, e2e first


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, manifest: Optional[dict] = None, root: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the manifest with its files, found by name
    under ``root`` (the benchmark's folder)."""
    manifest = manifest if manifest is not None else load_json(MANIFEST)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in the manifest: {sorted(cells)}")
    w = cells[name]
    metrics = [dict(m, kind="end_to_end") for m in manifest["end_to_end"]]
    metrics += [dict(m, kind="per_layer") for m in manifest["per_layer"]]
    mine = [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"], config=load_json(root / "configs" / f"{w['config']}.json"),
                traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(root / "limits" / f"{name}.json"), metrics=mine)


def load_loop(name: str):
    return importlib.import_module(f"port_bench.loops.{name}")


def reader(metric: str):
    """``read(record)`` of ``metrics/<metric>.py``, or, where there is no
    such file, of ``metrics/<stem>.py``, the stem being the name up to its
    first dot: ``step_ms.bf16`` is read as ``step_ms`` is, in its own cells."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, record: dict, trace: bool) -> Dict[str, dict]:
    """The cell's metrics of the run's kind (end to end, or with a trace
    per layer), each ``{"value", "unit"}``; a reader that finds nothing to
    read returns None, and its metric is left out."""
    kind = "per_layer" if trace else "end_to_end"
    out = {}
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def reference_imports(directory: Path = BENCH_DIR / "reference") -> List[str]:
    """Imports of the program, JAX or the JAX package in the reference's
    sources."""
    bad = []
    banned = FORBIDDEN + ("said_tpu_torch",)
    for path in sorted(directory.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    return bad


def device_info(torch, chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "" without it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
