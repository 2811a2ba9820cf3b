"""The rank side of the port's multi-rank CPU tests (not a test module).

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        tests/torch_parallel_worker.py {seq,data,seqtrain,tensor,combined} <work dir>

Each rank joins the gloo process group, runs the cases of its suite and
saves what it computed to ``<work dir>/<suite>_rank<r>.pt``; the test
modules (``tests/test_torch_seq_parallel.py``,
``tests/test_torch_data_parallel.py``,
``tests/test_torch_seq_parallel_train.py``,
``tests/test_torch_tensor_parallel.py``) compare those files with the
unsharded port and the JAX package. Inputs come from the seeded makers
below, which the tests call too. It imports only torch, numpy and the
port: the JAX package stays in the test process.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

# the JAX package's tiny test encoders: tests/test_seq_parallel.py's (SP)
# and tests/test_multichip.py's (DP)
SP_AUDIO = dict(conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=64, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=128, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, output_hidden_size=64)
DP_AUDIO = dict(conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=64, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, output_hidden_size=32)
# a clip of 34134 samples is 128 frames at 60 fps
SP_SAMPLES, SP_FRAMES = 34134, 128
GN_SHAPE = (2, 600, 192)
ATTN = dict(b=2, t=256, heads=2, d=32)
CONV_T = 600  # frames of the conv halo cases: 300 or 150 a rank, no multiple of 64


def rand(shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def attention_inputs():
    b, t, h, d = ATTN["b"], ATTN["t"], ATTN["heads"], ATTN["d"]
    return [rand((b, t, h * d), 10 + i) for i in range(3)]


def group_norm_inputs():
    c = GN_SHAPE[2]
    return rand(GN_SHAPE, 20, 2.0, 30.0), rand((c,), 21), rand((c,), 22)


def sp_wave():
    from said_tpu_torch.models.said import process_audio

    return process_audio(rand((1, SP_SAMPLES), 30))


def sp_latents():
    return rand((1, SP_FRAMES, 32), 31)


def sp_edit_request():
    """An editing request: inits, a mask that keeps every other frame, 60%
    strength, DDIM with eta 0.5 (its noise and the editing noise drawn
    from a seeded generator)."""
    mask = np.zeros((1, SP_FRAMES, 32), np.float32)
    mask[:, ::2] = 1.0
    return dict(init_samples=np.random.default_rng(32).uniform(0, 1, (1, SP_FRAMES, 32)).astype(np.float32),
                mask=mask, strength=0.6, eta=0.5, num_inference_steps=5, guidance_scale=2.0,
                generator=torch.Generator().manual_seed(33))


def _seeded(seed, build):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def make_conv3():
    from said_tpu_torch.models.layers import Conv1dSame

    def build():
        conv = Conv1dSame(64, 64, 3)
        torch.nn.init.normal_(conv.weight, std=0.05)
        torch.nn.init.normal_(conv.bias, std=0.05)
        return conv

    return _seeded(40, build)


def make_pos_conv():
    """The positional conv at wav2vec2-base's k = 128 (16 groups of 2 channels)."""
    from said_tpu_torch.models.wav2vec2 import PositionalConvEmbedding, Wav2Vec2Config

    def build():
        pos = PositionalConvEmbedding(Wav2Vec2Config(hidden_size=32))
        torch.nn.init.normal_(pos.conv.weight_v, std=0.05)
        torch.nn.init.normal_(pos.conv.bias, std=0.05)
        return pos

    return _seeded(41, build)


def make_encoder():
    from said_tpu_torch.cli._common import random_init_
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    return random_init_(SAID(audio_config=Wav2Vec2Config(**SP_AUDIO)), 42).audio_encoder.eval()


def make_unet():
    from said_tpu_torch.models.unet1d import UNet1DConditionModel

    def build():
        unet = UNet1DConditionModel(cross_attention_dim=64)
        for name, p in unet.named_parameters():
            torch.nn.init.normal_(p, std=0.02 if name.endswith("weight") else 0.01)
        return unet

    return _seeded(43, build)


def unet_inputs():
    return rand((2, SP_FRAMES, 32), 44), rand((2, SP_FRAMES, 64), 45), np.array([5, 700])


def dp_batch(b, window, seed, bucket=None):
    """A numpy batch of ``b`` rows: processed waveform, coefficients, cond,
    injected timesteps and noise; with ``bucket``, the first ``window``
    frames real in a ``bucket``-frame window."""
    from said_tpu_torch.models.said import process_audio

    rng = np.random.default_rng(seed)
    frames = bucket or window
    wave_real = 16000 * window // 60
    wave = process_audio(rng.standard_normal((b, wave_real)).astype(np.float32))
    wave = np.pad(wave, ((0, 0), (0, int(np.ceil(frames * 16000 / 60)) - wave_real)))
    return dict(waveform=wave, coeffs=rng.uniform(0, 1, (b, frames, 32)).astype(np.float32),
                cond=np.arange(b) % 3 != 1, timesteps=rng.integers(0, 1000, b),
                noise=rng.standard_normal((b, frames, 32)).astype(np.float32), wave_real=wave_real)


# ------------------------------------------------------------------ suites


def train_batch(seed, b=2, window=21, bucket=24, injected=False):
    """A bucketed train batch (numpy): ``window`` real frames of ``bucket``
    (21 of 24: the real length ends inside the second of two frame
    blocks), spec-augment masks, std reweighting and blendshape deltas;
    with ``injected``, timesteps and noise too."""
    from said_tpu_torch.models.wav2vec2 import compute_time_mask_indices

    batch = dp_batch(b, window, seed, bucket=bucket)
    mask = compute_time_mask_indices((b, window), rng=np.random.default_rng(seed + 1))
    out = dict(waveform=batch["waveform"], coeffs=batch["coeffs"], cond=batch["cond"],
               mask_time_indices=np.pad(mask, ((0, 0), (0, bucket - window))), window_real=window,
               input_length=batch["wave_real"], std=np.linspace(0.5, 2.0, 32).astype(np.float32),
               blendshape_delta=rand((b, 32, 20, 3), seed + 2))
    if injected:
        out.update(timesteps=batch["timesteps"], noise=batch["noise"])
    return out


def loss_inputs(batch, seq=None):
    """``said_loss``'s keyword inputs (torch) of a ``train_batch``: this
    rank's frames of the coefficients and the noise where ``seq`` splits
    them; waveform and masks whole."""
    from said_tpu_torch.parallel.seq import frames_of, sharded

    frames = frames_of(batch["coeffs"].shape[1], seq) if sharded(seq) else slice(None)
    skip = ("window_real", "input_length", "coeffs", "noise")
    kw = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items() if k not in skip}
    kw.update(coeffs=torch.from_numpy(np.ascontiguousarray(batch["coeffs"][:, frames])),
              window_real=batch["window_real"], input_length=batch["input_length"], seq_group=seq)
    if "noise" in batch:
        kw["noise"] = torch.from_numpy(np.ascontiguousarray(batch["noise"][:, frames]))
    return kw


def load_model(work, mesh=None, remat=False):
    """The tiny SAID with the test's weights (``said.pth``), sharded over the
    mesh's model axis."""
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from said_tpu_torch.parallel.tensor import shard_model_

    model = SAID(audio_config=Wav2Vec2Config(**DP_AUDIO), remat=remat)
    model.load_state_dict(torch.load(os.path.join(work, "said.pth"), weights_only=True), strict=True)
    shard_model_(model, None if mesh is None else mesh.model)
    return model


def _whole(model, named):
    """Whole tensors of a named dict of ``model``'s shards."""
    from said_tpu_torch.parallel.tensor import gather_state_dict

    tp = getattr(model, "tensor_parallel", None)
    return dict(named) if tp is None else gather_state_dict(named, tp.plan, tp.group)


def train_steps(work, mesh, batches, remat=False):
    """Train-mode steps (dropout, layerdrop, drawn timesteps and noise) on
    ``batches``, on this rank's share under ``mesh`` (None: one process):
    the losses, each step's gradients as the optimizer receives them
    (summed over the ranks, before the clip) and the parameters and EMA
    after, whole; and this rank's own parameters and EMA."""
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.train import said_train

    model = load_model(work, mesh, remat)
    state = said_train.TrainState(model, said_train.TrainConfig(learning_rate=1e-3))
    seen = []
    update = state.optimizer.update
    state.optimizer.update = lambda grads: (seen.append([g.clone() for g in grads]), update(grads))[1]
    gen = torch.Generator().manual_seed(54)
    schedule = DiffusionSchedule.create(1000)
    losses = []
    for batch in batches:
        kw = loss_inputs(batch, None if mesh is None else mesh.seq)
        metrics = said_train.train_step(state, schedule, kw, gen, None if mesh is None else mesh.data_seq)
        losses.append(metrics["loss"])
    names = list(state.params)
    return {"loss": torch.tensor(losses, dtype=torch.float64),
            "grads": [_whole(model, dict(zip(names, g))) for g in seen],
            "params": _whole(model, {n: p.detach().clone() for n, p in state.params.items()}),
            "ema": _whole(model, state.ema), "local_params": {n: p.detach().clone() for n, p in state.params.items()},
            "local_ema": {n: e.clone() for n, e in state.ema.items()}}


def deterministic_loss_and_grads(work, mesh, batch):
    """``said_loss`` with train=False and injected timesteps and noise, and
    its gradients: summed over the ranks of a model coordinate, whole."""
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.parallel.seq import all_sum
    from said_tpu_torch.train import said_train

    model = load_model(work, mesh)
    group = None if mesh is None else mesh.data_seq
    loss, _ = said_train.said_loss(model, DiffusionSchedule.create(1000), config=said_train.TrainConfig(),
                                   train=False, **loss_inputs(batch, None if mesh is None else mesh.seq))
    params = said_train.trainable_parameters(model)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: all_sum(torch.zeros_like(p) if g is None else g, group) for (n, p), g in zip(params.items(), grads)}
    return {"loss": all_sum(loss.detach(), group), "grads": _whole(model, grads)}


def _cli_argv(work):
    with open(os.path.join(work, "cli_argv.json")) as f:
        return json.load(f)


def _run_train_cli(work):
    """The train CLI with ``cli_argv.json``'s flags on the tiny model; the
    files this rank wrote, by writer."""
    from said_tpu_torch.cli import train as train_cli
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    writes = []
    for name in ("save_pth", "save_train_state", "MetricsWriter"):
        fn = getattr(train_cli, name)
        setattr(train_cli, name, lambda *a, fn=fn, name=name, **kw: (writes.append(name), fn(*a, **kw))[1])
    train_cli.build_said_model = lambda prediction_type, feature_dim, dtype, remat: SAID(
        audio_config=Wav2Vec2Config(**DP_AUDIO), prediction_type=prediction_type, remat=remat)
    train_cli.main(_cli_argv(work))
    return writes


def _seq_suite(ctx, work):
    from said_tpu_torch.models.said import SAID, SAIDPipeline
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from said_tpu_torch.ops.attention import flash_attention_flat_sp
    from said_tpu_torch.ops.norms import group_norm_sharded
    from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from said_tpu_torch.parallel.seq import gather, shard_frames

    seq = make_mesh(MeshConfig(data=1, seq=ctx.world), ctx).seq
    t = torch.from_numpy
    out = {}

    def sharded(fn, *xs):
        """fn on this rank's frames of each x, the result gathered."""
        return gather(fn(*(shard_frames(x, seq) for x in xs)), seq)

    q, k, v = (t(a) for a in attention_inputs())
    out["attention"] = sharded(lambda a, b, c: flash_attention_flat_sp(a, b, c, ATTN["heads"], seq), q, k, v)
    x, w, b = (t(a) for a in group_norm_inputs())
    for act in ("none", "silu"):
        out[f"group_norm_{act}"] = sharded(lambda a: group_norm_sharded(a, 32, w, b, 1e-6, act, seq), x)

    with torch.no_grad():
        conv, pos = make_conv3(), make_pos_conv()
        out["conv3"] = sharded(lambda a: conv(a, seq), t(rand((2, CONV_T, 64), 46)))
        out["pos_conv"] = sharded(lambda a: pos(a, seq), t(rand((2, CONV_T, 32), 47)))
        out["encoder"] = gather(make_encoder()(t(sp_wave()), SP_FRAMES, seq_group=seq), seq)
        unet = make_unet()
        sample, context, ts = unet_inputs()
        out["unet"] = sharded(lambda s, c: unet(s, t(ts), c, seq_group=seq), t(sample), t(context))

    if ctx.world == 2:  # the pipeline and the CLI against the JAX package's and one process
        model = SAID(audio_config=Wav2Vec2Config(**SP_AUDIO))
        model.load_state_dict(torch.load(os.path.join(work, "said.pth"), weights_only=True), strict=True)
        pipe = SAIDPipeline(model.eval())
        for solver in ("ddim", "dpmpp_2m"):
            out[f"pipeline_{solver}"] = torch.from_numpy(pipe.inference(
                sp_wave(), num_inference_steps=4, guidance_scale=2.0, solver=solver, latents=sp_latents(),
                seq_group=seq).result)
        out["pipeline_edit"] = torch.from_numpy(pipe.inference(sp_wave(), seq_group=seq, **sp_edit_request()).result)
        from said_tpu_torch.cli import inference

        inference.build_said_model = lambda *a, **kw: SAID(audio_config=Wav2Vec2Config(**SP_AUDIO))
        out["cli"] = torch.from_numpy(inference.main(_cli_argv(work)))
    return out


def _data_suite(ctx, work):
    from said_tpu_torch.cli import train as train_cli
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config, compute_time_mask_indices
    from said_tpu_torch.parallel.mesh import MeshConfig, SlicedGenerator, make_mesh, rank_rows
    from said_tpu_torch.train import said_train

    data = make_mesh(MeshConfig(data=ctx.world), ctx).data
    schedule = DiffusionSchedule.create(1000)
    sd = torch.load(os.path.join(work, "said.pth"), weights_only=True)
    out = {}

    def new_state():
        model = SAID(audio_config=Wav2Vec2Config(**DP_AUDIO))
        model.load_state_dict(sd, strict=True)
        state = said_train.TrainState(model, said_train.TrainConfig(learning_rate=1e-3))
        seen = []
        update = state.optimizer.update
        state.optimizer.update = lambda grads: (seen.append([g.clone() for g in grads]), update(grads))[1]
        return state, seen

    def inputs(batch, rows, **extra):
        np_rows = {k: batch[k][rows] for k in ("waveform", "coeffs", "cond")}
        out_ = {k: torch.from_numpy(np.asarray(v)) for k, v in np_rows.items()}
        for k, v in extra.items():
            out_[k] = None if v is None else torch.from_numpy(np.asarray(v)[rows])
        return out_

    # train mode (dropout, layerdrop, spec-augment; timesteps and noise
    # drawn), two steps: bucketed with masks, then std and blendshape deltas
    rng = np.random.default_rng(50)
    steps = [(dp_batch(4, 21, 51, bucket=24), dict(mask_time_indices=compute_time_mask_indices((4, 24), rng=rng))),
             (dp_batch(4, 24, 52), dict(blendshape_delta=rand((4, 32, 20, 3), 53)))]
    std = torch.from_numpy(np.linspace(0.5, 2.0, 32).astype(np.float32))
    for mode in ("dp", "one"):
        if mode == "one" and ctx.rank != 0:
            break
        state, seen = new_state()
        gen = torch.Generator().manual_seed(54)
        losses = []
        for batch, extra in steps:
            b = len(batch["cond"])
            rows = rank_rows(b, data.size, data.index) if mode == "dp" else slice(0, b)
            kw = inputs(batch, rows, **extra)
            kw["std"] = None if "blendshape_delta" not in extra else std
            kw.setdefault("blendshape_delta", None)
            if "mask_time_indices" in extra:
                kw.update(window_real=21, input_length=batch["wave_real"])
            if mode == "dp":
                kw["global_batch"] = b
                metrics = said_train.train_step(state, schedule, kw, SlicedGenerator(gen, 0, rows, b), data)
            else:
                metrics = said_train.train_step(state, schedule, kw, gen)
            losses.append(metrics["loss"])
        out[f"{mode}_loss"] = torch.tensor(losses, dtype=torch.float64)
        out[f"{mode}_grads"] = [dict(zip(state.params, g)) for g in seen]
        out[f"{mode}_params"] = {n: p.detach().clone() for n, p in state.params.items()}
        out[f"{mode}_ema"] = {n: e.clone() for n, e in state.ema.items()}

    # deterministic, injected timesteps and noise: against the JAX package
    batch = dp_batch(8, 16, 55)
    rows = rank_rows(8, data.size, data.index)
    model = SAID(audio_config=Wav2Vec2Config(**DP_AUDIO))
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        loss, _ = said_train.said_loss(model, schedule, std=None, blendshape_delta=None,
                                       config=said_train.TrainConfig(), train=False, global_batch=8,
                                       **inputs(batch, rows, timesteps=batch["timesteps"], noise=batch["noise"]))
    torch.distributed.all_reduce(loss, group=data.group)
    out["eval_loss"] = loss

    # the CLI, every write of this rank counted
    out["cli_writes"] = _run_train_cli(work)
    return out


SMALL_ROUTES = dict(DENSE_MAX=16, BWD_DENSE_MAX=16, BWD_BLOCK_K=8)  # 24 gathered keys: flash, 3 key blocks


def _seqtrain_suite(ctx, work):
    from said_tpu_torch.models.layers import Frames
    from said_tpu_torch.ops import attention
    from said_tpu_torch.ops.attention import flash_attention_flat_sp
    from said_tpu_torch.ops.norms import group_norm_sharded
    from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from said_tpu_torch.parallel.seq import gather, halo, shard_frames

    mesh = make_mesh(MeshConfig(data=1, seq=ctx.world), ctx)
    seq = mesh.seq
    out = {}

    def grads_of(fn, *xs, seed):
        """fn on this rank's frames of each x; the gradients of Σ w·fn
        (w drawn for the whole output, this rank's frames kept), gathered."""
        local = [shard_frames(torch.from_numpy(x), seq).requires_grad_() for x in xs]
        y = fn(*local)
        w = shard_frames(torch.from_numpy(rand(gather(y.detach(), seq).shape, seed)), seq)
        return gather(y.detach(), seq), [gather(g, seq) for g in torch.autograd.grad((y * w).sum(), local)]

    q, k, v = attention_inputs()
    out["flat_sp_grad"] = grads_of(lambda a, b, c: flash_attention_flat_sp(a, b, c, ATTN["heads"], seq), q, k, v,
                                   seed=60)
    x, w, b = group_norm_inputs()
    for real in (500, 250):  # the last real frame in the second block of frames, then the first
        for act in ("none", "silu"):
            wt, bt = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()

            def gn(a):
                lens = Frames(real, a.shape[0], a.shape[1], "cpu", a.dtype, seq.index * a.shape[1]).lens(a.shape[0])
                return group_norm_sharded(a, 32, wt, bt, 1e-6, act, seq, lens)

            y, (dx,) = grads_of(gn, x, seed=61)
            y = gn(shard_frames(torch.from_numpy(x), seq))
            wgrad = shard_frames(torch.from_numpy(rand(x.shape, 61)), seq)
            dw, db = torch.autograd.grad((y * wgrad).sum(), [wt, bt])
            out[f"group_norm_{real}_{act}"] = (gather(y.detach(), seq), dx, dw, db)
    hx = rand((2, 4, 3), 62)  # 2 frames a rank, halos of 3: frames of both ranks and the clip's zeros
    out["halo"] = grads_of(lambda a: halo(a, 3, 3, seq), hx, seed=63)
    out["gather"] = grads_of(lambda a: gather(a, seq) * (seq.index + 1.0), hx, seed=64)

    batch = train_batch(70)
    out["sp"] = train_steps(work, mesh, [batch])
    saved = {k: getattr(attention, k) for k in SMALL_ROUTES}
    for key, value in SMALL_ROUTES.items():
        setattr(attention, key, value)
    out["sp_small_routes"] = train_steps(work, mesh, [batch])
    if ctx.rank == 0:
        out["one_small_routes"] = train_steps(work, None, [batch])
    for key, value in saved.items():
        setattr(attention, key, value)
    if ctx.rank == 0:
        out["one"] = train_steps(work, None, [batch])
    out["deterministic"] = deterministic_loss_and_grads(work, mesh, train_batch(71, injected=True))
    out["cli_writes"] = _run_train_cli(work)
    return out


def _tensor_suite(ctx, work):
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from said_tpu_torch.train import said_train

    mesh = make_mesh(MeshConfig(data=1, model=ctx.world), ctx)
    model = load_model(work, mesh)
    out = {"shards": {k: v.clone() for k, v in model.state_dict().items() if k in model.tensor_parallel.plan},
           "plan": {k: (p.dim, p.blocks) for k, p in model.tensor_parallel.plan.items()}}
    batch = train_batch(72)
    out["tp"] = train_steps(work, mesh, [batch])
    if ctx.rank == 0:
        out["one"] = train_steps(work, None, [batch])
    out["deterministic"] = deterministic_loss_and_grads(work, mesh, train_batch(73, injected=True))
    # the validation step: deterministic, the fused GEGLU at the shard's width
    schedule = DiffusionSchedule.create(1000)
    evals = {}
    for mode, m in (("tp", mesh), ("one", None)):
        metrics = said_train.eval_step(load_model(work, m), schedule, loss_inputs(train_batch(74)),
                                       said_train.TrainConfig(), torch.Generator().manual_seed(75))
        evals[mode] = metrics
    out["eval"] = evals
    # a checkpoint's round trip: whole tensors out, this rank's shards back
    state = said_train.TrainState(load_model(work, mesh), said_train.TrainConfig(learning_rate=1e-3))
    said_train.train_step(state, schedule, loss_inputs(batch), torch.Generator().manual_seed(78))
    whole = state.state_dict()
    again = said_train.TrainState(load_model(work, mesh), said_train.TrainConfig(learning_rate=1e-3))
    again.load_state_dict(whole)
    mine, theirs = state.optimizer.state_dict(), again.optimizer.state_dict()
    out["resume"] = {"whole_shapes": {k: tuple(v.shape) for k, v in whole["model"].items()},
                     "identical": again.step == state.step and mine["count"] == theirs["count"]
                     and all(torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(mine[k], theirs[k]))
                     and all(torch.equal(p, again.params[n]) for n, p in state.params.items())
                     and all(torch.equal(e, again.ema[n]) for n, e in state.ema.items())}
    out["cli_writes"] = _run_train_cli(work)
    return out


def _combined_suite(ctx, work):
    from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=1, model=2, seq=2), ctx)
    batch = train_batch(76)
    out = {"coords": (mesh.model.index, mesh.seq.index), "mesh": train_steps(work, mesh, [batch]),
           "remat": train_steps(work, mesh, [batch], remat=True)}
    if ctx.rank == 0:
        out["one"] = train_steps(work, None, [batch])
    out["deterministic"] = deterministic_loss_and_grads(work, mesh, train_batch(77, injected=True))
    return out


def main():
    suite, work = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from said_tpu_torch.parallel.mesh import maybe_init_distributed, shutdown

    torch.set_num_threads(1)
    ctx = maybe_init_distributed("cpu")
    try:
        out = {"seq": _seq_suite, "data": _data_suite, "seqtrain": _seqtrain_suite, "tensor": _tensor_suite,
               "combined": _combined_suite}[suite](ctx, work)
        torch.save(out, os.path.join(work, f"{suite}_rank{ctx.rank}.pt"))
    finally:
        shutdown(ctx)


if __name__ == "__main__":
    main()
