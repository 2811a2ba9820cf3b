"""The serving path's spans (``said_tpu_torch.core.trace``) on the CPU.

The tiny encoder and the 192-wide UNet, random weights
(``random_init_``), a 0.4-s clip (24 frames) as the CLI serves it
(``fit_audio_unet`` → ``process_audio`` → ``SAIDPipeline.inference``), 3
DDIM or DPM-Solver++(2M) steps, CFG 2.0, and one request in
length-bucketed mode. Under a ``torch.profiler``
session the spans form the documented tree; with no session nothing is
recorded and the coefficients are the same bits.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from said_tpu_torch.cli._common import random_init_
from said_tpu_torch.core import trace
from said_tpu_torch.models.said import SAID, SAIDPipeline, process_audio
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.utils.audio import fit_audio_unet

FRAMES, STEPS, C = 24, 3, 32
CASES = {"ddim": dict(solver="ddim"), "dpmpp_2m": dict(solver="dpmpp_2m"),
         "bucketed": dict(solver="dpmpp_2m", length_bucket=16)}
# each span's parent, by name (None: a root)
PARENT = {trace.FIT_AUDIO: None, trace.PROCESS_AUDIO: None, trace.REQUEST: None, trace.UPLOAD: trace.REQUEST,
          trace.PREPARE: trace.REQUEST, trace.PREPARE_ENCODER: trace.PREPARE, trace.PREPARE_KV: trace.PREPARE,
          trace.PREPARE_TIME_TABLE: trace.PREPARE, trace.DENOISE: trace.REQUEST, trace.STEP: trace.DENOISE,
          trace.DOWNLOAD: trace.REQUEST}


@pytest.fixture(scope="module")
def pipe():
    return SAIDPipeline(random_init_(SAID(audio_config=Wav2Vec2Config.tiny()), 0).eval())


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(0)
    t = np.arange(FRAMES * 800 // 3) / 16000
    raw = (np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    return raw, rng.standard_normal((1, FRAMES, C)).astype(np.float32)


def request(pipe, clip, case="dpmpp_2m"):
    raw, latents = clip
    fit = fit_audio_unet(raw, 16000, 60, 1)
    out = pipe.inference(process_audio(fit.waveform), latents=latents, num_inference_steps=STEPS,
                         guidance_scale=2.0, **CASES[case])
    return out.result[0, :fit.window_size]


def traced(fn):
    """Run ``fn`` in a CPU profiler session: (its value, the spans, the
    session's kineto events)."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        value = fn()
    return value, trace.spans(), list(prof.profiler.kineto_results.events())


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_tree(pipe, clip, case):
    _, spans, _ = traced(lambda: request(pipe, clip, case))
    by_id = {s["id"]: s for s in spans}
    names = collections.Counter(s["name"] for s in spans)
    assert names == {**{n: 1 for n in PARENT}, trace.STEP: STEPS}
    for s in spans:
        parent = by_id.get(s["parent"])
        assert (parent and parent["name"]) == PARENT[s["name"]], s
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        if parent:
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
            assert s["clock"] == parent["clock"]
    req = next(s for s in spans if s["name"] == trace.REQUEST)
    assert req["request"] is not None
    assert req["attrs"] == {"frames": FRAMES, "samples": FRAMES * 800 // 3, "steps": STEPS, "dtype": "float32"}
    assert [s["request"] for s in spans if s["name"] in (trace.FIT_AUDIO, trace.PROCESS_AUDIO)] == [None, None]
    assert {s["request"] for s in spans if s["name"] not in (trace.FIT_AUDIO, trace.PROCESS_AUDIO)} == \
        {req["request"]}
    assert [s["attrs"]["i"] for s in spans if s["name"] == trace.STEP] == list(range(STEPS))
    order = [s["name"] for s in spans if s["parent"] == req["id"]]
    assert order == [trace.UPLOAD, trace.PREPARE, trace.DENOISE, trace.DOWNLOAD]


def test_each_request_its_own_id(pipe, clip):
    _, spans, _ = traced(lambda: [request(pipe, clip) for _ in range(2)])
    reqs = [s for s in spans if s["name"] == trace.REQUEST]
    assert len(reqs) == 2 and reqs[0]["request"] != reqs[1]["request"]
    for r in reqs:
        assert sum(s["request"] == r["request"] and s["name"] == trace.STEP for s in spans) == STEPS


def test_streaming_windows_are_requests(pipe, clip):
    raw, _ = clip
    wave = np.concatenate([raw, raw, raw])  # 72 frames: 3 windows of 30 frames, 9 pinned
    out, spans, _ = traced(lambda: pipe.inference_streaming(
        process_audio(wave), window_frames=30, overlap_frames=9, num_inference_steps=2, guidance_scale=2.0,
        generator=torch.Generator().manual_seed(0)))
    reqs = [s for s in spans if s["name"] == trace.REQUEST]
    assert out.result.shape == (1, 3 * FRAMES, C)
    assert [r["attrs"]["frames"] for r in reqs] == [30, 30, 30]
    assert sum(s["name"] == trace.STEP for s in spans) == 3 * 2


def test_nothing_recorded_without_a_profiler(pipe, clip):
    trace.clear()
    assert trace.span(trace.REQUEST) is trace.span(trace.STEP, torch.device("cpu"), i=0)
    request(pipe, clip)
    assert trace.spans() == []


def test_the_buffer_keeps_its_bound(pipe, clip, monkeypatch):
    assert trace._buffer.maxlen == trace.MAX_SPANS
    monkeypatch.setattr(trace, "_buffer", collections.deque(maxlen=5))
    _, spans, _ = traced(lambda: request(pipe, clip))
    assert len(spans) == 5
    assert [s["name"] for s in spans] == [trace.DENOISE] + [trace.STEP] * STEPS + [trace.DOWNLOAD]


def test_spans_sit_on_the_profilers_clock(pipe, clip):
    """Each span's start, mapped through its clock pair, lies within 1 ms of
    the start of its own range in the kineto session."""
    _, spans, events = traced(lambda: request(pipe, clip))
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name() in PARENT:
            ranges[e.name()].append(e.start_ns())
    assert sorted(ranges) == sorted(PARENT)
    for name, starts in ranges.items():
        mine = [s["start_ns"] - s["clock"][0] + s["clock"][1] for s in spans if s["name"] == name]
        assert len(mine) == len(starts)
        for a, b in zip(sorted(mine), sorted(starts)):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_the_ranges_are_not_device_annotations(pipe, clip):
    """The spans' ranges are function-scope host events: a user-scope range
    would also lay an annotation of the card's type over its kernels."""
    _, _, events = traced(lambda: request(pipe, clip))
    mine = [e for e in events if e.name() in PARENT]
    assert mine and not any(e.is_user_annotation() for e in mine)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in mine)


@pytest.mark.parametrize("case", sorted(CASES))
def test_coefficients_unchanged_by_the_profiler(pipe, clip, case):
    plain = request(pipe, clip, case)
    profiled, spans, _ = traced(lambda: request(pipe, clip, case))
    assert spans and np.isfinite(plain).all() and np.array_equal(plain, profiled)


@pytest.mark.gpu
def test_device_time_on_the_card(clip):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gpu_pipe = SAIDPipeline(random_init_(SAID(audio_config=Wav2Vec2Config.tiny()), 0).cuda().eval())
    request(gpu_pipe, clip)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        request(gpu_pipe, clip)
    spans = trace.spans()
    host_only = {trace.FIT_AUDIO, trace.PROCESS_AUDIO}
    assert all((s["device_ms"] is None) == (s["name"] in host_only) for s in spans)
    dev = {s["name"]: s["device_ms"] for s in spans if s["name"] != trace.STEP}
    assert dev[trace.REQUEST] >= dev[trace.PREPARE] + dev[trace.DENOISE] > 0
