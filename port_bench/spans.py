"""The benchmark's one reader of the program's own spans
(``said_tpu_torch.core.trace``): the spans its serving path recorded in
the run's profiler session.

The program records spans only while a profiler session is active, so
after a traced run its buffer holds the session's requests and nothing
else. They are taken where they match the session the loop ran (the
same number of ``said.request`` spans, each of the same frames and
steps, in order); otherwise, where the program has no such spans (an
untraced run, a program without the tracer) or they do not match, there
is nothing to read and every reader returns None.
"""

from __future__ import annotations

from typing import List, Optional

FIT_AUDIO, PROCESS_AUDIO, UPLOAD = "said.fit_audio", "said.process_audio", "said.upload"
REQUEST, PREPARE, DENOISE, STEP = "said.request", "said.prepare", "said.denoise", "said.denoise.step"


def port_spans() -> Optional[List[dict]]:
    """The program's buffered spans, or None where it has no tracer."""
    try:
        from said_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.spans()


def session_spans(record: dict) -> Optional[List[dict]]:
    """The spans of the session's requests, or None."""
    session = record.get("session")
    if not session or "requests" not in session:
        return None
    spans = port_spans()
    if not spans:
        return None
    got = [(s["attrs"].get("frames"), s["attrs"].get("steps")) for s in spans if s["name"] == REQUEST]
    want = [(r["frames"], r["steps"]) for r in session["requests"]]
    return spans if got and got == want else None


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def named(spans: List[dict], *names: str) -> List[dict]:
    return [s for s in spans if s["name"] in names]


def requests(spans: List[dict]) -> int:
    return len(named(spans, REQUEST))


def steps(spans: List[dict]) -> int:
    return len(named(spans, STEP))


def device_ms(spans: List[dict]) -> Optional[List[float]]:
    """Each span's device ms; None where there is no span or one has none
    (a span that ran on no CUDA device)."""
    out = [s["device_ms"] for s in spans]
    return out if out and None not in out else None
