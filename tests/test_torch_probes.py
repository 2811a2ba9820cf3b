"""The port's probes (``said_tpu_torch.probes``) against the JAX package's
Pallas probes in ``tools/``, on the CPU.

Every stage of ``tools/attn_probe.py`` and ``tools/int8_qk_probe.py``,
every mode of ``tools/attn_probe2.py`` and every variant of
``tools/fullk_bound_probe.py`` and ``tools/vpu_probe.py`` runs in Pallas
interpret mode (``attn_probe.build`` and ``attn_probe2.
packed_kernel_factory`` take no ``interpret`` argument, so
``pallas_call`` is patched to interpret for them) beside the port's plain
version, on the same numpy-seeded inputs, at the JAX probe's blocks
(128 × 128): T = 256, B·H = 12 or (2, 256, 6×32), and T = 200 where a
variant masks a ragged key tail. Bounds, relative to max |JAX|: 1e-5 in
f32, 2e-2 in bf16, for the bf16s variant in either dtype (it rounds its
scores to bf16 by definition) and for the int8 full stages (bf16 rounding
of p and of the output; the int8 stages' rint(p·127) flips where the two exp2s differ
in the last place); ``dot_int8`` is exact (int32 sums, f32 sums of
integers below 2^24). The shifts are held at 1e-6. Each CLI runs with
``--device cpu --t 256``. The probe kernels against their plain versions
on the card: ``tests/test_torch_kernels.py -k probe``.
"""

from __future__ import annotations

import functools
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from said_tpu.ops import pallas_attention as pa
from said_tpu_torch.probes import (
    attn_probe,
    attn_probe2,
    flash_probe,
    flash_shift,
    flash_stages,
    fullk_bound_probe,
    int8_qk,
    int8_qk_probe,
    shift,
    vpu_probe,
)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@functools.cache
def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(shape, dtype, seed=0, n=3):
    """The same seeded values for both: torch tensors and jax arrays."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    tdt, jdt = DTYPES[dtype]
    return [torch.from_numpy(a).to(tdt) for a in arrays], [jnp.asarray(a, jdt) for a in arrays]


def _assert_close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max |port − JAX| / max |JAX| = {err:.3e} > {tol}"


# ---------------------------------------------------------------- P1, P2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", flash_stages.STAGES)
def test_attn_probe_stage_against_jax(interpret, stage, dtype):
    (q, k, v), (jq, jk, jv) = _inputs((12, 256, 32), dtype)
    want = _tool("attn_probe").build(stage, 256, 128, 128, 2, 6, 32)(jq, jk, jv)
    got = flash_stages.flash_stages_plain(q, k, v, stage, "head", block_k=128)
    _assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["copy", "full"])
def test_attn_probe2_mode_against_jax(interpret, mode, dtype):
    (q, k, v), (jq, jk, jv) = _inputs((2, 256, 192), dtype, seed=1)
    want = _tool("attn_probe2").packed_kernel_factory(256, 128, 128, mode)(jq, jk, jv)
    got = flash_stages.flash_stages_plain(q, k, v, mode, "packed", block_k=128)
    _assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("stage", flash_stages.STAGES)
def test_stage_layouts_agree(stage):
    """The packed layout is the per-head one with its heads interleaved."""
    (q, k, v), _ = _inputs((2, 256, 192), "float32", seed=2)
    packed = flash_stages.flash_stages_plain(q, k, v, stage, "packed")
    heads = [x.reshape(2, 256, 6, 32).transpose(1, 2).reshape(12, 256, 32) for x in (q, k, v)]
    per_head = flash_stages.flash_stages_plain(*heads, stage, "head")
    torch.testing.assert_close(per_head.reshape(2, 6, 256, 32).transpose(1, 2).reshape(2, 256, 192), packed,
                               atol=0, rtol=0)


# ---------------------------------------------------------------- P3, P5


def _p3_jax(variant, jq, jk, jv):
    if variant == "prod":
        return pa._flash_tpu_packed(jq, jk, jv, num_heads=6, block_q=128, interpret=True)
    return _tool("fullk_bound_probe").fullk_bound(jq, jk, jv, num_heads=6, block_q=128, interpret=True)


@pytest.mark.parametrize("t", [256, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["prod", "bound"])
def test_fullk_bound_probe_against_jax(variant, dtype, t):
    (q, k, v), (jq, jk, jv) = _inputs((2, t, 192), dtype, seed=3)
    want = _p3_jax(variant, jq, jk, jv)
    a = shift.exp2_shift_bound(shift.fold_q(q), k, 6) if variant == "bound" else None
    got = flash_shift.flash_shift_plain(q, k, v, variant, a, shift.SHIFT_CLAMP, block_k=128)
    _assert_close(got, want, TOL[dtype])


def _p5_jax(variant, jq, jk, jv):
    if variant == "prod":
        return pa._flash_tpu_packed_blocked(jq, jk, jv, num_heads=6, block_q=128, block_k=128, interpret=True)
    tool = _tool("vpu_probe")
    m = tool.qk_shift_bound(jq, jk, 6) if variant == "bound" else None
    return tool.blocked_variant(jq, jk, jv, m, variant=variant, num_heads=6, block_q=128, block_k=128,
                                interpret=True)


# noexp at T = 200: the JAX variant's masked p is −inf, a NaN output; the
# port defines it as 0, so noexp is held at T = 256 only
@pytest.mark.parametrize("t", [256, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", flash_shift.VARIANTS)
def test_vpu_probe_variant_against_jax(variant, dtype, t):
    if variant == "noexp" and t == 200:
        (q, k, v), _ = _inputs((2, t, 192), dtype, seed=4)
        out = flash_shift.flash_shift_plain(q, k, v, "noexp")
        assert torch.isfinite(out.float()).all()
        return
    (q, k, v), (jq, jk, jv) = _inputs((2, t, 192), dtype, seed=4)
    want = _p5_jax(variant, jq, jk, jv)
    a = shift.qk_shift_bound(q, k, 6) if variant == "bound" else None
    got = flash_shift.flash_shift_plain(q, k, v, variant, a, shift.VPU_CLAMP, block_k=128)
    # bf16s rounds its scores and p to bf16 whatever the input dtype: the bf16 bound
    _assert_close(got, want, TOL["bfloat16" if variant == "bf16s" else dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [256, 600])
def test_shift_bounds_against_jax(dtype, t):
    (q, k, _), (jq, jk, _) = _inputs((2, t, 192), dtype, seed=5)
    k[1, 77, 32:64] *= 9.0  # a max-norm outlier key in one head
    jk = jnp.asarray(k.float().numpy(), DTYPES[dtype][1])
    qs = shift.fold_q(q)
    want = pa._exp2_shift_bound(jnp.asarray(qs.float().numpy(), DTYPES[dtype][1]), jk, 6)
    np.testing.assert_allclose(shift.exp2_shift_bound(qs, k, 6).numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = _tool("vpu_probe").qk_shift_bound(jq, jk, 6)
    np.testing.assert_allclose(shift.qk_shift_bound(q, k, 6).numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- P4


def _int8_case(t=256):
    rng = np.random.default_rng(6)
    q32, k32, v32 = (torch.from_numpy(rng.standard_normal((6, t, 32)).astype(np.float32)) for _ in range(3))
    return shift.int8_inputs(q32, k32, v32)


def _jax_args(x, stage):
    """The JAX stage's inputs: V with its ones column (1, or 127 in int8),
    none for the dot stages (the JAX dot stages take V and ignore it)."""
    def j(t):
        return jnp.asarray(t.numpy()) if t.dtype == torch.int8 else jnp.asarray(t.float().numpy(), jnp.bfloat16)

    q, k, v = int8_qk_probe.stage_args(x, stage)
    if v is None:
        jv = j(x.v_bf)
    else:
        jv = j(shift.with_ones_column(v, 127 if v.dtype == torch.int8 else 1.0))
    return (j(q), j(k), jv), (q, k, v)


@pytest.mark.parametrize("stage", int8_qk.STAGES)
def test_int8_qk_probe_stage_against_jax(stage):
    x = _int8_case()
    (jq, jk, jv), (q, k, v) = _jax_args(x, stage)
    int8 = "int8" in stage
    fn = _tool("int8_qk_probe").build(stage, 256, 128, 128, 1, 6, 32,
                                      dequant_log2=x.dequant_log2 if int8 else 0.0, pv_scale=x.pv_scale,
                                      interpret=True)
    want = fn(jq, jk, jv)
    got = int8_qk.int8_qk_plain(q, k, v, stage, x.dequant_log2, x.pv_scale, block_k=128)
    if stage == "dot_int8":
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    else:
        _assert_close(got, want, 2e-2)


def test_int8_inputs_follow_the_probe():
    """shift.int8_inputs against int8_qk_probe.main's lines, in numpy."""
    x = _int8_case(128)
    rng = np.random.default_rng(6)
    q32, k32, v32 = (rng.standard_normal((6, 128, 32)).astype(np.float32) for _ in range(3))
    sq, sk, sv = (float(np.abs(a).max() / 127.0) for a in (q32, k32, v32))
    np.testing.assert_array_equal(x.q_i8.numpy(), np.clip(np.rint(q32 / sq), -127, 127).astype(np.int8))
    np.testing.assert_array_equal(x.v_i8.numpy(), np.clip(np.rint(v32 / sv), -127, 127).astype(np.int8))
    assert math.isclose(x.dequant_log2, sq * sk * 32**-0.5 * shift.LOG2E, rel_tol=1e-6)
    assert math.isclose(x.pv_scale, sv * 127.0, rel_tol=1e-6)
    np.testing.assert_array_equal(x.q_bf.float().numpy(),
                                  np.asarray(jnp.asarray(q32 * 32**-0.5 * shift.LOG2E, jnp.bfloat16), np.float32))


# ------------------------------------------------- routers, CLIs, kernels


def test_wrappers_route_by_device():
    """On the CPU the routers take the plain versions; the kernels' wrappers
    refuse CPU tensors (they launch or raise, no fallback)."""
    (q, k, v), _ = _inputs((12, 256, 32), "bfloat16")
    torch.testing.assert_close(flash_stages.flash_stages(q, k, v, "full"),
                               flash_stages.flash_stages_plain(q, k, v, "full", block_k=128), atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_stages.flash_stages_kernel(q, k, v, "full")
    (q, k, v), _ = _inputs((2, 256, 192), "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        flash_shift.flash_shift_kernel(q, k, v, "prod")
    x = _int8_case()
    with pytest.raises(ValueError, match="CUDA"):
        int8_qk.int8_qk_kernel(x.q_i8, x.k_i8, None, "dot_int8")
    with pytest.raises(TypeError):
        int8_qk.int8_qk_kernel(x.q_bf, x.k_bf, None, "dot_int8")
    for fn in (flash_probe.flash_probe_kernel, int8_qk.int8_qk_kernel):
        assert fn.launches == 0


@pytest.mark.parametrize("cli,names", [
    (attn_probe, flash_stages.STAGES),
    (attn_probe2, ("packed full kernel max err vs dense", "copy", "full")),
    (fullk_bound_probe, ("bound vs prod", "prod vs f32 dense", "bound vs f32 dense")),
    (int8_qk_probe, int8_qk.STAGES),
    (vpu_probe, ("accuracy vs the production kernel", "prod", "nomax", "bf16s", "bound", "accuracy vs f32 dense",
                 "prod", "nomax", "bf16s", "bound")),
], ids=["attn_probe", "attn_probe2", "fullk_bound_probe", "int8_qk_probe", "vpu_probe"])
def test_cli_runs_on_the_cpu(cli, names, capsys):
    result = cli.main(["--device", "cpu", "--t", "256"])
    out = capsys.readouterr().out
    assert result["t"] == 256 and result["inputs"]["shape"][1] == 256
    at = 0
    for name in names:  # the tool's lines, in its order
        at = out.index(name, at) + len(name)
    assert "nan" not in out.lower()


@pytest.mark.parametrize("cli", [attn_probe, attn_probe2, int8_qk_probe], ids=["attn_probe", "attn_probe2",
                                                                             "int8_qk_probe"])
def test_cli_refuses_partial_tiles(cli):
    """The stage probes are defined on whole key tiles: a T that is no
    multiple of the kernel's tile is refused on either device."""
    with pytest.raises(SystemExit, match="key tile"):
        cli.main(["--device", "cpu", "--t", "200"])
