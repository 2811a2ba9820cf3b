"""QK^T in int8 inside the flash kernel (probe P4).

Port of the Pallas probe ``tools/int8_qk_probe.py::build`` (:54) as
``csrc/probes/int8_qk.cu`` (its source note says which products run on
which instruction and what bounds them). Per-head layout (B·H, T, 32);
stages ``dot_bf16`` / ``dot_int8`` (QK^T alone), ``full_bf16``,
``full_int8qk`` and ``full_int8qkpv``. The bf16 stages take Q pre-folded
by d^-1/2 · log2 e and V in bf16; the int8 stages int8 Q and K (and V for
``full_int8qkpv``) with ``dequant_log2`` and ``pv_scale``
(``shift.int8_inputs``). V is given without the JAX probe's ones column:
the kernel holds the column as a constant (1 in bf16, 127 in int8), and
so does the plain version. ``int8_qk`` routes: the plain version on the
CPU, the kernel on CUDA.
"""

from __future__ import annotations

import torch

from said_tpu_torch import _build
from said_tpu_torch.probes import HEAD_DIM, check_cuda

STAGES = ("dot_bf16", "dot_int8", "full_bf16", "full_int8qk", "full_int8qkpv")
ROW_TILE = 64
KEY_TILE = 128
MAX_INIT = -(2.0**30)  # the JAX stage's running max starts here, not at −inf


def _types(stage: str):
    """(dtype of Q and K, dtype of V or None) a stage takes."""
    qk = torch.int8 if "int8" in stage else torch.bfloat16
    v = None if stage.startswith("dot_") else torch.int8 if stage == "full_int8qkpv" else torch.bfloat16
    return qk, v


def int8_qk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor | None, stage: str,
                  dequant_log2: float = 0.0, pv_scale: float = 1.0, block_k: int = KEY_TILE) -> torch.Tensor:
    """Plain version of the int8 kernel with its numerics, over key blocks
    of ``block_k``: int8 products exact (float64 sums of int8 products),
    bf16 products as f32 sums; the dot stages sum every block's first 32
    score columns in f32; the full stages run the exp2 online softmax from
    a max of −2^30, p rounded to bf16 (or to rint(p·127) in int8 for
    ``full_int8qkpv``) before PV and the ones column. bf16 output."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: expected one of {STAGES}")
    int8 = "int8" in stage
    cast = torch.float64 if int8 else torch.float32
    qf, kf = q.to(cast), k.to(cast)
    scale = dequant_log2 if int8 else 1.0
    n, t, d = q.shape
    m = torch.full((n, t), MAX_INIT, device=q.device)
    den = torch.zeros((n, t), device=q.device)
    acc = torch.zeros((n, t, d), device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        sc = (qf @ kf[:, k0:k0 + block_k].transpose(1, 2)).float()  # exact for int8: |s| < 2^24
        if stage.startswith("dot_"):
            acc += sc[..., :d]
            continue
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * scale)
        p = torch.exp2((sc - m_new[..., None]) * scale)
        m = m_new
        if stage == "full_int8qkpv":
            pq = torch.round(p * 127.0).double()
            pv = (pq @ v[:, k0:k0 + block_k].double()).float()
            ones = (pq.sum(dim=-1) * 127.0).float()
        else:
            pb = p.to(torch.bfloat16).float()
            pv = pb @ v[:, k0:k0 + block_k].float()
            ones = pb.sum(dim=-1)
        acc = acc * alpha[..., None] + pv
        den = den * alpha + ones
    if stage.startswith("dot_"):
        return acc.to(torch.bfloat16)
    num = acc * pv_scale if stage == "full_int8qkpv" else acc
    return (num / den[..., None]).to(torch.bfloat16)


def int8_qk_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor | None, stage: str,
                   dequant_log2: float = 0.0, pv_scale: float = 1.0) -> torch.Tensor:
    """Launch ``said_probe_int8_qk`` on contiguous CUDA tensors q (BH, T,
    32), k (BH, S, 32) and, for the full stages, v (BH, S, 32), of the
    dtypes the stage takes; T a multiple of 64, S of 128."""
    name = "int8_qk_kernel"
    if stage not in STAGES:
        raise ValueError(f"{name}: stage {stage!r}: expected one of {STAGES}")
    qk_t, v_t = _types(stage)
    if q.dtype != qk_t or k.dtype != qk_t or (v is None) != (v_t is None) or (v is not None and v.dtype != v_t):
        raise TypeError(f"{name}: {stage} takes q, k {qk_t} and v {v_t}")
    if (q.dim() != 3 or k.dim() != 3 or q.shape[2] != HEAD_DIM or k.shape[0] != q.shape[0]
            or k.shape[2] != HEAD_DIM or (v is not None and v.shape != k.shape)):
        raise ValueError(f"{name}: needs q (BH, T, {HEAD_DIM}), k and v (BH, S, {HEAD_DIM})")
    bh, t, _ = q.shape
    s = k.shape[1]
    if t % ROW_TILE or s % KEY_TILE:
        raise ValueError(f"{name}: T = {t} must be a multiple of {ROW_TILE} and S = {s} of {KEY_TILE}")
    check_cuda(name, q, k, *([] if v is None else [v]))
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    err = _build.probe_library().said_probe_int8_qk(
        q.data_ptr(), k.data_ptr(), None if v is None else v.data_ptr(), out.data_ptr(), bh, t, s,
        STAGES.index(stage), float(dequant_log2), float(pv_scale), torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    int8_qk_kernel.launches += 1
    return out


int8_qk_kernel.launches = 0


def int8_qk(q, k, v, stage, dequant_log2=0.0, pv_scale=1.0):
    """The stage on q's device: the plain version on the CPU, the kernel on
    CUDA."""
    if q.device.type == "cpu":
        return int8_qk_plain(q, k, v, stage, dequant_log2, pv_scale)
    return int8_qk_kernel(q, k, v, stage, dequant_log2, pv_scale)
