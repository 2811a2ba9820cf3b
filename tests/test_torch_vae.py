"""The port's BCVAE, its weight bridge, its ELBO train step, the VAE
dataset and the β schedule, against the JAX package on the CPU.

Inputs come from numpy seeds; the JAX BCVAE's random init is carried
across with ``convert.bcvae_state_dict`` (whose inverse, the JAX
``convert_bcvae``, must give the trees back exactly), and ε is drawn once
from the JAX step's key and injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from said_tpu.data.blendvoca import BlendVOCAVAEDataset as JVAEDataset
from said_tpu.models.vae import BCVAE as JBCVAE
from said_tpu.train import vae_train as jvt
from said_tpu.utils.scheduler import frange_cycle_linear as j_frange
from said_tpu.utils.torch_import import convert_bcvae, load_state_dict
from said_tpu_torch.convert import bcvae_state_dict
from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES, PERSON_IDS_TRAIN, PERSON_IDS_VAL, BlendVOCAVAEDataset
from said_tpu_torch.models.vae import BATCHNORM_CANCELLED_BIASES, BCVAE
from said_tpu_torch.train import vae_train
from said_tpu_torch.utils.blendshape import save_blendshape_coeffs
from said_tpu_torch.utils.scheduler import frange_cycle_linear


def _trees(seed=0):
    """The JAX BCVAE, its params, and non-trivial BatchNorm statistics."""
    jm = JBCVAE()
    variables = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 120, 32)), use_noise=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    stats = {part: {name: {"mean": (rng.standard_normal(s["mean"].shape) * 0.1).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
                    for name, s in layers.items()} for part, layers in stats.items()}
    return jm, params, stats


def _port(params, stats):
    pm = BCVAE()
    pm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in bcvae_state_dict(params, stats).items()},
                       strict=True)
    return pm


def _coeffs(batch, seed):
    return np.random.default_rng(seed).uniform(0, 1, (batch, 120, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    return _trees()


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_state_dict_round_trips_through_convert_bcvae(trees, tmp_path):
    """``bcvae_state_dict`` → ``torch.save`` → the JAX package's
    ``convert_bcvae(load_state_dict(...))`` gives back the trees exactly,
    and the port's BCVAE (the reference's names) loads it strictly."""
    _, params, stats = trees
    path = str(tmp_path / "vae.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in bcvae_state_dict(params, stats).items()}, path)
    got_params, got_stats = convert_bcvae(load_state_dict(path))
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_stats, stats)
    pm = BCVAE()
    pm.load_state_dict(torch.load(path, weights_only=True), strict=True)
    assert pm.decoder.conv_layers[0].weight.shape == (4, 32, 3)  # ConvTranspose1d: (in, out, k)


def _rel_max(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_encode_decode_reconstruct_match_jax_in_eval_mode(trees):
    """Running statistics, z = mean and z from an injected ε: within 1e-5
    of max |JAX|."""
    jm, params, stats = trees
    pm = _port(params, stats)
    x = _coeffs(4, 1)
    v = {"params": params, "batch_stats": stats}
    eps = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    with torch.no_grad():
        mean, log_var = pm.encode(torch.from_numpy(x))
        j_mean, j_log_var = jm.apply(v, jnp.asarray(x), method=JBCVAE.encode)
        assert _rel_max(mean, j_mean) <= 1e-5 and _rel_max(log_var, j_log_var) <= 1e-5
        z = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
        assert _rel_max(pm.decode(torch.from_numpy(z)), jm.apply(v, jnp.asarray(z), method=JBCVAE.decode)) <= 1e-5
        for use_noise in (False, True):
            got = pm(torch.from_numpy(x), use_noise=use_noise, eps=torch.from_numpy(eps))
            j_eps = jnp.asarray(eps)
            want = jm.apply(v, jnp.asarray(x), use_noise=False) if not use_noise else None
            if use_noise:  # the JAX model draws ε from its key: decode its mean + σ·ε by hand
                want_latent = j_mean + jnp.exp(0.5 * j_log_var) * j_eps
                want_reconst = jm.apply(v, want_latent, method=JBCVAE.decode)
            else:
                want_latent, want_reconst = want.latent, want.coeffs_reconst
            assert _rel_max(got.latent, want_latent) <= 1e-5
            assert _rel_max(got.coeffs_reconst, want_reconst) <= 1e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# The JAX package's ELBO in float64 is the reference: on these inputs its
# own f32 loss departs from it by 1.2e-6 relative (the port's f32 by 5e-8)
# and its f32 gradients by up to 5e-5 relative L2 (the port's by 2.3e-5:
# the train-mode BatchNorm backward subtracts means of the gradient, a
# cancellation), so the port's f32 is held to the float64 result: the
# loss to 1e-6, every gradient to 1e-4; float64 against float64 holds the
# algorithm to 1e-12 and 1e-9.
BOUNDS = {torch.float32: {"loss": 1e-6, "grad": 1e-4, "stats": 1e-6},
          torch.float64: {"loss": 1e-12, "grad": 1e-9, "stats": 1e-12}}


@pytest.fixture(scope="module")
def elbo_reference(trees):
    """The JAX ``elbo_loss`` (train mode, z = mean) in float64: its parts,
    gradients and new ``batch_stats``, without and with a std."""
    _, params, stats = trees
    x = _coeffs(8, 4).astype(np.float64)
    config = jvt.VAETrainConfig(weight_vel=0.7)
    out = {}
    with jax.enable_x64(True):
        jm = JBCVAE(dtype=jnp.float64)
        p64, s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        for use_std in (False, True):
            std = np.random.default_rng(5).uniform(0.5, 1.5, 32) if use_std else None

            def loss_fn(p, std=std):
                return jvt.elbo_loss(jm, p, s64, jax.random.PRNGKey(0), jnp.asarray(x),
                                     None if std is None else jnp.asarray(std), config, 0.3, train=True,
                                     use_noise=False)

            (_, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p64)
            out[use_std] = x, std, jax.tree.map(np.asarray, (metrics, new_stats, grads))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("use_std", [False, True], ids=["plain", "std"])
def test_elbo_train_mode_matches_jax(trees, elbo_reference, dtype, use_std):
    """``elbo_loss`` in train mode with z = mean against the JAX package's
    in float64: the loss and its parts, every gradient (relative L2) and
    the moved running statistics within BOUNDS; the BatchNorm-cancelled
    biases' gradients (exactly 0) at most 1e-6 of the global norm."""
    _, params, stats = trees
    x, std, (j_metrics, j_stats, j_grads) = elbo_reference[use_std]
    bounds = BOUNDS[dtype]
    pm = _port(params, stats).to(dtype)
    loss, metrics = vae_train.elbo_loss(pm, torch.from_numpy(x).to(dtype),
                                        None if std is None else torch.from_numpy(std).to(dtype),
                                        vae_train.VAETrainConfig(weight_vel=0.7), 0.3, train=True, use_noise=False)
    for k, v in metrics.items():
        assert abs(float(v.detach()) - float(j_metrics[k])) <= bounds["loss"] * abs(float(j_metrics[k])), k
    names = [n for n, _ in pm.named_parameters()]
    grads = dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss, list(pm.parameters())))))
    want = bcvae_state_dict(j_grads, stats)
    norm = np.sqrt(sum((want[n] ** 2).sum() for n in names))
    for n in names:
        if n in BATCHNORM_CANCELLED_BIASES:
            assert np.abs(grads[n]).max() <= 1e-6 * norm and np.abs(want[n]).max() <= 1e-6 * norm, n
        else:
            assert _rel_l2(grads[n], want[n]) <= bounds["grad"], n
    got_stats = pm.state_dict()
    for n, a in bcvae_state_dict(params, j_stats).items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_stats[n].numpy(), a, rtol=0, atol=bounds["stats"] * max(np.abs(a).max(), 1.0),
                                       err_msg=n)
    assert int(got_stats["encoder.conv_layers.1.num_batches_tracked"]) == 1


# Two train steps: params, EMA and running statistics within ``rel`` of
# max |JAX| per tensor, plus ``of_step`` × the summed learning rates.
# float64 holds the flow (statistics, warm-up, clip, AdamW, EMA) tightly:
# its one slack is that the optimizer forms its scalars (learning rate,
# bias corrections) in f32 as optax does in an f32 program, where optax
# under x64 forms them in f64: 1 − 0.999^t in f32 is off by 1.3e-5
# relative at t = 2 (0.999 rounds, and the difference cancels), 1e-4 of
# a step is allowed. In f32, AdamW divides each gradient element by its own
# magnitude (+ 1e-8): an element whose gradient is near 1e-8 carries its
# f32 rounding (the gradients' error, above) into a visible share of its
# step, here up to 1.7e-3 of it; 1e-2 of a step is allowed. A
# BatchNorm-cancelled bias has a gradient of rounding noise, which AdamW
# in f32 normalises to up to a full step in either direction: held to
# |Δ| ≤ the summed learning rates.
STEP_BOUNDS = {torch.float32: {"rel": 1e-5, "of_step": 1e-2}, torch.float64: {"rel": 1e-9, "of_step": 1e-4}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_two_train_steps_match_jax(trees, dtype):
    """Two steps (warm-up 3 at lr 1e-2: the first update has lr 0, the
    second 1e-2/3; the clip acts), ε drawn from the JAX step's keys and
    injected, against the JAX ``make_train_step`` in the same dtype."""
    _, params, stats = trees
    np_dt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    bounds = STEP_BOUNDS[dtype]
    pm = _port(params, stats).to(dtype)
    config = jvt.VAETrainConfig(learning_rate=1e-2, warmup_steps=3)
    state = vae_train.VAETrainState(pm, vae_train.VAETrainConfig(learning_rate=1e-2, warmup_steps=3))
    lr_sum = 0.0
    with jax.enable_x64(dtype == torch.float64):
        jm = JBCVAE(dtype=jnp.dtype(np_dt))
        state_j = jvt.create_train_state(config, *jax.tree.map(lambda a: jnp.asarray(a, np_dt), (params, stats)))
        step_j = jax.jit(jvt.make_train_step(jm, config))
        for i in range(2):
            x = _coeffs(8, 10 + i).astype(np_dt)
            key = jax.random.PRNGKey(20 + i)
            # the JAX model's ε: jax.random.normal(key, mean.shape) inside reparametrize
            eps = np.array(jax.random.normal(key, (8, 64), jnp.dtype(np_dt)))
            lr_sum += state.optimizer.learning_rate(i)
            state_j, j_metrics = step_j(state_j, jnp.asarray(x), None, 0.5, key)
            metrics = vae_train.train_step(state, torch.from_numpy(x), None, 0.5, eps=torch.from_numpy(eps))
            assert abs(metrics["loss"] - float(j_metrics["loss"])) <= 1e-5 * abs(float(j_metrics["loss"]))
        j_params, j_ema, j_stats = jax.tree.map(np.asarray, (state_j.params, state_j.ema_params, state_j.batch_stats))
    sd = pm.state_dict()
    for label, got, want in (("params", {n: sd[n] for n in state.params}, bcvae_state_dict(j_params, stats)),
                             ("ema", state.ema, bcvae_state_dict(j_ema, stats)),
                             ("stats", sd, bcvae_state_dict(params, j_stats))):
        for n, t in got.items():
            if label == "stats" and not n.endswith(("running_mean", "running_var")):
                continue
            w = want[n]
            atol = bounds["rel"] * np.abs(w).max() + bounds["of_step"] * lr_sum
            if n in BATCHNORM_CANCELLED_BIASES and dtype == torch.float32:
                atol = 1.001 * lr_sum
            np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=atol, err_msg=f"{label} {n}")
    assert state.step == 2 and state.optimizer.count == 2


@pytest.mark.parametrize("n_iter,start,stop,n_cycle,ratio", [
    (1000, 0.0, 1.0, 10, 0.5), (20000, 0.0, 1.0, 10, 0.5), (37, 0.0, 0.7, 4, 0.3), (3, 0.0, 1.0, 10, 0.5),
    (10, 0.2, 1.0, 3, 1.0),
])
def test_frange_cycle_linear_is_bit_identical(n_iter, start, stop, n_cycle, ratio):
    got, want = frange_cycle_linear(n_iter, start, stop, n_cycle, ratio), j_frange(n_iter, start, stop, n_cycle, ratio)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _coeff_tree(root, frames=(130, 64, 200)):
    """Coefficient CSVs for 2 train persons and 1 val person, one sentence
    of the second train person with two repeats."""
    rng = np.random.default_rng(0)
    for pid, sentences in ((PERSON_IDS_TRAIN[0], {1: "", 2: ""}), (PERSON_IDS_TRAIN[1], {3: "-0", 4: ""}),
                           (PERSON_IDS_VAL[0], {1: ""})):
        (root / pid).mkdir(parents=True)
        for i, (sid, suffix) in enumerate(sentences.items()):
            names = [f"sentence{sid:02}{suffix}.csv"] + ([f"sentence{sid:02}-1.csv"] if suffix else [])
            for name in names:
                coeffs = rng.uniform(0, 1, (frames[i % len(frames)], 32)).astype(np.float32)
                save_blendshape_coeffs(coeffs, BLENDSHAPE_CLASSES, str(root / pid / name))
    return root


@pytest.mark.parametrize("dataset_type,kw", [("train", {}), ("train", {"zero_prob": 0.3}),
                                             ("val", {"hflip": False}), ("train", {"window_size": 60})])
def test_vae_dataset_items_are_bit_identical(tmp_path, dataset_type, kw):
    """The same seed gives the same discovery, window offsets, flips and
    zero-outs: every item of two passes equals the JAX package's."""
    root = str(_coeff_tree(tmp_path))
    got, want = (cls(root, dataset_type=dataset_type, seed=7, **kw) for cls in (BlendVOCAVAEDataset, JVAEDataset))
    assert [(p.person_id, p.sentence_id, p.blendshape_coeffs) for p in got.data_paths] == \
        [(p.person_id, p.sentence_id, p.blendshape_coeffs) for p in want.data_paths]
    assert len(got) == (5 if dataset_type == "train" else 1)
    for _ in range(2):
        for i in range(len(got)):
            a, b = got[i].blendshape_coeffs, want[i].blendshape_coeffs
            assert a.dtype == b.dtype and np.array_equal(a, b), i
    batch = BlendVOCAVAEDataset.collate_fn([got[0], got[1 % len(got)]])
    assert batch.blendshape_coeffs.shape == (2, kw.get("window_size", 120), 32)
