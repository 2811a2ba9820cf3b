"""No run loads JAX or the JAX package, and the reference imports none of
the program, JAX or the JAX package."""

import sys
import types

from port_bench import harness


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import said_tpu_torch.models.said  # noqa: F401

    assert not [n for n in harness.forbidden_modules() if n.startswith("said_tpu_torch")]
    monkeypatch.setitem(sys.modules, "said_tpu_torchish", types.ModuleType("said_tpu_torchish"))
    assert "said_tpu_torchish" not in harness.forbidden_modules()
    for name in ("jax", "jaxlib.xla_client", "flax", "said_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    assert harness.reference_imports() == []


def test_the_import_scan_finds_them(tmp_path):
    (tmp_path / "a.py").write_text("import said_tpu_torch.models\nfrom jax import numpy\nimport numpy\n")
    (tmp_path / "b.py").write_text("from said_tpu.ops import masks\n")
    assert harness.reference_imports(tmp_path) == ["a.py: said_tpu_torch.models", "a.py: jax", "b.py: said_tpu.ops"]


def test_the_benchmark_reads_no_record_of_the_jax_bench():
    for path in harness.BENCH_DIR.rglob("*.py"):
        text = path.read_text()
        for name in ("bench.py", "BENCH_r0", "MULTICHIP_r0", "BASELINE"):
            assert name not in text or path.name == "test_port_bench_imports.py", (path, name)
