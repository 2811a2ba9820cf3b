"""One ``torch.profiler`` session and what the benchmark reads from it.

A process runs one session (a second session in one process can lose
kernel records at its start). The session's events are reduced here to
plain numbers: the union of the card's kernel, copy and set intervals
(busy), the session's wall on the host clock, device seconds by kernel
family, and the idle gaps between device work, each named by the host
operator that was running when it began.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

# (substring of the lower-cased device event name, family); first match
# wins. Copied from the program's profile_step.FAMILIES.
FAMILIES = (
    ("flash_attention", "flash_attention (ours)"),
    ("geglu", "geglu_ffn (ours)"),
    ("group_norm", "group_norm (ours, plain or masked)"),
    ("layer_norm", "layer_norm (ours)"),
    ("strided_conv", "strided_conv_gelu (ours)"),
    ("gemm", "cuBLAS GEMM/GEMV"),
    ("gemv", "cuBLAS GEMM/GEMV"),
    ("nvjet", "cuBLAS GEMM/GEMV"),
    ("softmax", "softmax"),
    ("catarray", "cat"),
    ("copy", "copy/cast"),
    ("memcpy", "copy/cast"),
    ("memset", "memset"),
    ("reduce", "reduce"),
    ("index", "gather/index"),
)
ATTENTION_FAMILY = "flash_attention (ours)"
TOP = 10


def family(name: str) -> str:
    lower = name.lower()
    for key, fam in FAMILIES:
        if key in lower:
            return fam
    return "elementwise/other"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def session(fn: Callable[[], None]) -> dict:
    """Run ``fn`` under the profiler (host and card) and reduce what it
    recorded: ``window_s`` (host clock, synchronised), ``busy_s``,
    ``by_family_s``, ``kernels`` (device events), ``idle_gaps``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    # the raw events: the profiler's own event list takes minutes to build
    # for a session of some 10^5 host operators
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e9
        span, name = (start, start + e.duration_ns() / 1e9), e.name()
        if e.device_type() == cuda:
            device.append((span, name))
        elif not name.startswith(("cuda", "cu", "ProfilerStep")):
            host.append((span, name))
    by_family: Dict[str, float] = {}
    for (a, b), name in device:
        by_family[family(name)] = by_family.get(family(name), 0.0) + (b - a)
    busy = _union([s for s, _ in device])
    return {"window_s": window_s, "busy_s": sum(b - a for a, b in busy), "by_family_s": by_family,
            "kernels": len(device), "idle_gaps": _idle_gaps(busy, host)}


def _idle_gaps(busy: List[Tuple[float, float]], host) -> Dict[str, float]:
    """Seconds of the gaps between device work, summed by the innermost
    host operator open at each gap's start (one sweep over the operators
    in start order, with a stack of those still open)."""
    host = sorted(host)
    out: Dict[str, float] = {}
    stack: List[Tuple[float, str]] = []  # (end, name) of open operators, innermost last
    j = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while j < len(host) and host[j][0][0] <= a:
            (start, end), name = host[j]
            while stack and stack[-1][0] <= start:
                stack.pop()
            stack.append((end, name))
            j += 1
        while stack and stack[-1][0] <= a:
            stack.pop()
        name = stack[-1][1] if stack else "(host between operators)"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def breakdown(reduced: dict) -> dict:
    """The result line's ``breakdown``: the families that took most device
    time and the host operators that most device idle fell under."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(reduced["by_family_s"]), "idle_gaps": top(reduced["idle_gaps"])}
