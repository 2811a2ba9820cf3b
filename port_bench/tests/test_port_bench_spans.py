"""The readers of the program's spans (``spans.py``, ``metrics/
prepare_dev_ms``, ``step_dev_ms``, ``step_host_ms``, ``edge_ms``): their
values on hand-made spans, nothing to read where the spans are missing or
do not match the session, and their manifest entries."""

import time

import pytest
import torch

from port_bench import harness, spans
from port_bench.tests import test_port_bench_manifest as manifest_tests

STEMS = ("prepare_dev_ms", "step_dev_ms", "step_host_ms", "edge_ms")
CELLS = {".serve": ("said_f32.long_takes", "audio_s_per_s"), ".bf16": ("said_bf16.long_takes", "audio_s_per_s.bf16")}
LAYERS = {"prepare_dev_ms": "prepare", "step_dev_ms": "denoise loop", "step_host_ms": "denoise loop",
          "edge_ms": "request"}
MS = 1_000_000  # ns


def make_spans(requests):
    """A session's spans as the program records them: for each request
    (frames, steps, prepare device ms, denoise device ms, denoise host ms,
    edge host ms split over fit, process and upload), its tree."""
    out, ids, t = [], iter(range(1, 10**6)), 0

    def add(name, parent, request, host_ms, dev_ms=None, **attrs):
        nonlocal t
        s = {"name": name, "id": next(ids), "parent": parent, "request": request, "start_ns": t,
             "end_ns": t + round(host_ms * MS), "clock": (0, 0), "device_ms": dev_ms, "attrs": attrs}
        t = s["end_ns"]
        out.append(s)
        return s["id"]

    for k, (frames, steps, prep, den, den_host, edge) in enumerate(requests, 1):
        add(spans.FIT_AUDIO, None, None, edge / 4)
        add(spans.PROCESS_AUDIO, None, None, edge / 4)
        req = add(spans.REQUEST, None, k, 0.0, 0.0, frames=frames, samples=frames * 800 // 3, steps=steps,
                  dtype="float32")
        add(spans.UPLOAD, req, k, edge / 2, 0.1)
        add(spans.PREPARE, req, k, prep + 1.0, prep)
        den_id = add(spans.DENOISE, req, k, den_host, den)
        for i in range(steps):
            add(spans.STEP, den_id, k, 0.0, den / steps, i=i)
        add("said.download", req, k, 0.5, 0.4)
    return out


SESSION = [(7200, 25, 100.0, 1000.0, 400.0, 40.0), (18000, 25, 300.0, 3000.0, 500.0, 80.0)]
RECORD = {"session": {"requests": [{"frames": f, "steps": s} for f, s, *_ in SESSION]}}
WANT = {"prepare_dev_ms": 200.0, "step_dev_ms": 4000.0 / 50, "step_host_ms": 900.0 / 50, "edge_ms": 60.0}


@pytest.fixture
def session(monkeypatch):
    """Hands the readers ``got`` as the program's spans."""
    def use(got):
        monkeypatch.setattr(spans, "port_spans", lambda: got)
    return use


@pytest.mark.parametrize("stem", STEMS)
def test_readers_on_hand_made_spans(session, stem):
    session(make_spans(SESSION))
    assert harness.reader(stem)(RECORD) == pytest.approx(WANT[stem], rel=1e-9)


@pytest.mark.parametrize("suffix", sorted(CELLS))
@pytest.mark.parametrize("stem", STEMS)
def test_each_cells_name_reads_its_stem(session, stem, suffix):
    session(make_spans(SESSION))
    assert harness.reader(stem + suffix)(RECORD) == pytest.approx(WANT[stem], rel=1e-9)


@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("case", ["no spans", "no program tracer", "fewer requests", "other frames", "other steps",
                                  "no session"])
def test_nothing_to_read(session, stem, case):
    got = make_spans(SESSION)
    record = RECORD
    if case == "no spans":
        got = []
    elif case == "no program tracer":
        got = None
    elif case == "fewer requests":
        got = make_spans(SESSION[:1])
    elif case == "other frames":
        got = make_spans([(7201,) + SESSION[0][1:], SESSION[1]])
    elif case == "other steps":
        got = make_spans([SESSION[0], (18000, 20) + SESSION[1][2:]])
    else:
        record = {"requests": []}
    session(got)
    assert harness.reader(stem)(record) is None


@pytest.mark.parametrize("stem", ["prepare_dev_ms", "step_dev_ms"])
def test_no_device_time_nothing_to_read(session, stem):
    """Spans that ran on no CUDA device (the CPU) carry no device ms."""
    got = make_spans(SESSION)
    for s in got:
        s["device_ms"] = None
    session(got)
    assert harness.reader(stem)(RECORD) is None
    assert harness.reader("step_host_ms")(RECORD) == pytest.approx(WANT["step_host_ms"])


def test_nothing_to_read_in_an_untraced_cpu_run():
    """A ``--trace 0`` run on the CPU at the tiny configuration: no session,
    and the program recorded no span."""
    from said_tpu_torch.core import trace

    data = harness.BENCH_DIR / "tests" / "data"
    cell = harness.resolve("tiny.short", harness.load_json(data / "BENCHMARK.json"), data)
    trace.clear()
    record = harness.load_loop(cell.traffic["loop"]).run(cell, 2**31 + 5, 0.2, False, torch.device("cpu"),
                                                         time.perf_counter())
    assert record["requests"] and trace.spans() == []
    for stem in STEMS:
        assert harness.reader(stem)(record) is None


def test_the_port_buffer_is_read():
    """``port_spans`` reads the program's buffer, as plain dicts."""
    from said_tpu_torch.core import trace

    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span(trace.REQUEST, frames=3, steps=1):
            with trace.span(trace.STEP, i=0):
                pass
    got = spans.port_spans()
    trace.clear()
    assert [s["name"] for s in got] == [spans.REQUEST, spans.STEP]
    assert got[0]["attrs"] == {"frames": 3, "steps": 1} and got[1]["parent"] == got[0]["id"]


@pytest.mark.parametrize("suffix", sorted(CELLS))
@pytest.mark.parametrize("stem", STEMS)
def test_manifest_entries(stem, suffix):
    name = stem + suffix
    cell, moves = CELLS[suffix]
    entry = next(m for m in harness.load_json(harness.MANIFEST)["per_layer"] if m["name"] == name)
    assert entry == {"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                     "layer": LAYERS[stem], "moves": moves, "workloads": [cell]}
    assert entry in manifest_tests.METRICS  # the manifest's parametrised tests take it as it is
    assert any(m["name"] == name for m in harness.resolve(cell).metrics)
