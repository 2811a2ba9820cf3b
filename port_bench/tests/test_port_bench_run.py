"""Whole runs on the CPU at the tiny configuration (the look for a card
skipped): the result line and its checks, and runs whose timed path is
broken underneath coming out not correct."""

import json

import numpy as np
import pytest
import torch

from port_bench import harness, run

DATA = harness.BENCH_DIR / "tests" / "data"
MANIFEST = harness.load_json(DATA / "BENCHMARK.json")
SEED = 2**31 + 3


def cpu_run(cell, capsys, trace=0):
    result = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5", "--trace", str(trace)],
                      manifest=MANIFEST, root=DATA, device="cpu")
    out, err = capsys.readouterr()
    return result, out, err


def test_result_line(capsys):
    cell = "tiny.short"
    result, out, err = cpu_run(cell, capsys)
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True and line["attempted"] > 0
    assert "setup_s" in line["metrics"] and all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert [x.split()[1] for x in last] == list(line["checks"])


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "said_f32.long_takes", "--seed", "1", "--seconds", "1"])
    assert e.value.code == 2 and capsys.readouterr().out == ""


def stuck_step(monkeypatch):
    """A denoise step that returns its state unchanged."""
    from said_tpu_torch.diffusion import sampler

    make = sampler.make_step
    monkeypatch.setattr(sampler, "make_step", lambda *a, **k: (lambda lat, x0, i, n: (lat, make(*a, **k)(lat, x0, i, n)[1])))


def altered_answer(monkeypatch):
    """One coefficient of each answer altered where it is produced."""
    from said_tpu_torch.models.said import SAIDPipeline

    inner = SAIDPipeline.inference

    def inference(self, *a, **k):
        out = inner(self, *a, **k)
        out.result[0, 0, 0] = np.float32(1.0) - out.result[0, 0, 0]
        return out

    monkeypatch.setattr(SAIDPipeline, "inference", inference)


def nan_answer(monkeypatch):
    """One coefficient of each answer made NaN where it is produced."""
    from said_tpu_torch.models.said import SAIDPipeline

    inner = SAIDPipeline.inference

    def inference(self, *a, **k):
        out = inner(self, *a, **k)
        out.result[0, 0, 0] = np.float32("nan")
        return out

    monkeypatch.setattr(SAIDPipeline, "inference", inference)


def bypassed_capture(monkeypatch):
    """A timed path that no longer calls what the capture wraps (a replayed
    graph, say): the embedding and the denoiser output go unrecorded."""
    from port_bench.loops import request

    def install(self, model):
        self.armed, self.got = None, {}

    monkeypatch.setattr(request.Capture, "__init__", install)


def reading_dropped(monkeypatch):
    """A run whose comparison makes no reading of a number its limits name."""
    from port_bench.loops import request

    inner = request.compare
    monkeypatch.setattr(request, "compare", lambda *a, **k: [r for r in inner(*a, **k) if r[0] != "coeff_gap"])


@pytest.mark.parametrize("fault", [stuck_step, altered_answer, nan_answer, bypassed_capture, reading_dropped],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(fault, capsys, monkeypatch):
    fault(monkeypatch)
    result, _, err = cpu_run("tiny.short", capsys)
    assert result["correct"] is False and "FAILED" in err
