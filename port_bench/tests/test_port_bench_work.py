"""The work counts against counts of the plain model's products at tiny
shapes (torch's FLOP counter over the reference, 2 a multiply-add), and
the attention bound by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import harness, work
from port_bench.reference import said
from port_bench.reference.said import Precision

CFG = harness.load_json(harness.BENCH_DIR / "tests" / "data" / "configs" / "tiny.json")


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return said.SAiD(CFG).eval()


@pytest.mark.parametrize("frames", [30, 45])
def test_encoder_flops(model, frames):
    samples = frames // 3 * 800
    wave = torch.randn(2, samples)
    with torch.no_grad():
        n = counted(lambda: model.audio_encoder(wave, frames, Precision()))
    # the first conv contracts one input channel, which the counter takes
    # for an elementwise product: counted by hand
    a = CFG["audio_encoder"]
    conv0 = 2 * 2 * ((samples - a["conv_kernel"][0]) // a["conv_stride"][0] + 1) * a["conv_dim"][0] * a["conv_kernel"][0]
    assert work.encoder_flops(CFG, samples, frames, batch=2) == n + conv0


@pytest.mark.parametrize("frames", [24, 33])
def test_unet_flops_training_forward(model, frames):
    b = 3
    x, ctx = torch.randn(b, frames, 32), torch.randn(b, frames, CFG["audio_encoder"]["hidden_size"])
    t = torch.tensor([1, 500, 999])
    with torch.no_grad():
        n = counted(lambda: model.unet(x, t, ctx, Precision()))
    assert work.unet_flops(CFG, frames, b, b, training=True) == n


def test_serving_step_shares_the_first_block():
    full = work.unet_flops(CFG, 100, 2, 2, training=False)
    folded = work.unet_flops(CFG, 100, 2, 1, training=False)
    ch = CFG["unet"]["model_channels"]
    t = 100
    shared = 2.0 * t * 32 * ch * 3 + (2.0 * t * ch * ch * 3 * 2 + 2.0 * 4 * ch * ch) + (8.0 * t * ch * ch + 4.0 * t * t * ch)
    assert full - folded == pytest.approx(shared)


def test_attention_bound_by_hand():
    calls = [(2, 3000, 6, 32)]
    ops = 4 * 2 * 6 * 3000 * 3000 * 32
    assert work.attention_bound_s(calls, "bfloat16") == pytest.approx(ops / 989e12)
    short = [(1, 10, 1, 32)]
    assert work.attention_bound_s(short, "float32") == pytest.approx(4 * 10 * 32 * 4 / 3.35e12)


def test_flash_calls_only_past_the_dense_limit():
    reqs = [{"frames": 2048, "steps": 25}, {"frames": 7200, "steps": 25}]
    calls = work.flash_calls(harness.load_json(harness.BENCH_DIR / "configs" / "said_f32.json"), reqs)
    assert len(calls) == 12 + 25 * 4 and all(c[1] == 7200 for c in calls)
