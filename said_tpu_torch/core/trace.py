"""Spans of the serving path, recorded only while a ``torch.profiler``
session is active.

The switch is the profiler itself (``torch._C._autograd._profiler_enabled``):
there is no flag, variable or setting. With the profiler off, :func:`span`
is that one check and returns a shared do-nothing context; nothing is
recorded and nothing synchronises. With it on, a span

- opens a profiler range of its name (a CPU event of the session, so the
  kineto trace shows it on the device trace's own clock, and a device
  idle gap that begins inside it is named by it);
- records its name, its parent span, the id of its request and its host
  start and end on ``time.perf_counter_ns()``, the clock of the CLIs and
  the benchmark;
- on a CUDA device, records a timing event on the current stream at its
  start and at its end. The events are resolved to milliseconds by
  :func:`spans`, never while the span runs.

The range is a ``RecordScope.FUNCTION`` range (``_RecordFunctionFast``),
not ``torch.profiler.record_function``'s user scope: a user-scope range
also puts a ``gpu_user_annotation`` over its kernels on the device
timeline, an event of the card's type that readers summing the card's
events (busy time, launches) would count as device work. It is also ~10×
cheaper to open.

Spans go into a bounded buffer (:data:`MAX_SPANS`, oldest dropped first)
that holds no tensors. A root span (one opened with no span open) records
one clock pair, ``(perf_counter_ns, time_ns)``, that its descendants
share: kineto's host timestamps are Unix-epoch nanoseconds, so
``start_ns - clock[0] + clock[1]`` puts a span on the trace's clock. The
buffer is one thread's: the serving path runs its spans on one thread.

Each span name is one of the constants below; ``said.request`` opens a
new request id, which its descendants carry (``said.fit_audio`` and
``said.process_audio`` run before the request, and carry none).
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import List, Optional

import torch

FIT_AUDIO = "said.fit_audio"  # utils/audio.py::fit_audio_unet
PROCESS_AUDIO = "said.process_audio"  # models/said.py::process_audio
REQUEST = "said.request"  # SAIDPipeline.inference, whole
UPLOAD = "said.upload"  # inference's entry up to prepare: waveform and latents to the device
PREPARE = "said.prepare"  # SAIDPipeline.prepare
PREPARE_ENCODER = "said.prepare.encoder"  # the audio embedding
PREPARE_KV = "said.prepare.kv"  # null embedding and the banded K/V caches
PREPARE_TIME_TABLE = "said.prepare.time_table"  # the timestep-MLP table
DENOISE = "said.denoise"  # sampler.sample, whole
STEP = "said.denoise.step"  # one denoise step; attribute i
DOWNLOAD = "said.download"  # the result (and intermediates) to the host

MAX_SPANS = 1 << 16

_enabled = torch._C._autograd._profiler_enabled
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_open: List[dict] = []  # the spans now open, innermost last
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "range", "end_event", "stream")

    def __init__(self, name: str, device: Optional[torch.device], attrs: dict):
        parent = _open[-1] if _open else None
        if parent is None:
            clock = (time.perf_counter_ns(), time.time_ns())
            request = next(_request_ids) if name == REQUEST else None
        else:
            clock = parent["clock"]
            request = next(_request_ids) if name == REQUEST else parent["request"]
        self.rec = {"name": name, "id": next(_span_ids), "parent": None if parent is None else parent["id"],
                    "request": request, "start_ns": None, "end_ns": None, "clock": clock, "device_ms": None,
                    "attrs": attrs}
        self.stream = torch.cuda.current_stream(device) if device is not None and device.type == "cuda" else None
        self.range = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        rec = self.rec
        self.range.__enter__()
        if self.stream is not None:
            start, self.end_event = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            rec["_events"] = (start, self.end_event)
        rec["start_ns"] = time.perf_counter_ns()
        _open.append(rec)
        _buffer.append(rec)

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.perf_counter_ns()
        if self.stream is not None:
            self.end_event.record(self.stream)
        _open.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A context that records the span ``name`` while a profiler session
    is active, and does nothing otherwise. ``device``: where the span's
    work runs; on a CUDA device its stream is timed too. ``attrs``: plain
    numbers or strings kept with the span."""
    if not _enabled():
        return _OFF
    return _Span(name, device, attrs)


def spans() -> List[dict]:
    """The buffered spans, oldest first, as plain dicts: ``name``, ``id``,
    ``parent`` (a span id or None), ``request`` (a request id or None),
    ``start_ns`` and ``end_ns`` (host, ``perf_counter_ns``; ``end_ns`` None
    while open), ``clock`` (the root's ``(perf_counter_ns, time_ns)``
    pair), ``device_ms`` (the stream's milliseconds from the span's start
    to its end on a CUDA device, else None) and ``attrs``. Resolving a
    span's device time waits for its end event."""
    out = []
    for rec in list(_buffer):
        events = rec.get("_events")
        if events is not None and rec["end_ns"] is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
            del rec["_events"]
        out.append({k: (dict(v) if k == "attrs" else v) for k, v in rec.items() if k != "_events"})
    return out


def clear() -> None:
    """Empty the buffer (spans still open are kept out of it)."""
    _buffer.clear()
