"""The port's evaluation stack against the JAX package, on the CPU: the
metrics (FD, WInD, multimodality, beat consistency), the torch Gaussian
mixture against sklearn's, the eval dataset, and the three BCVAE CLIs
(``test_evaluate``, ``inference_vae``, ``train_vae``).
"""

import ast
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from said_tpu.data.blendvoca import BlendVOCAEvalDataset as JEvalDataset
from said_tpu.eval import metrics as jmetrics
from said_tpu.models.vae import BCVAE as JBCVAE
from said_tpu.utils import audio as jaudio
from said_tpu_torch.cli import inference_vae, test_evaluate, train_vae
from said_tpu_torch.cli._common import load_blendshape_coeffs, load_vae
from said_tpu_torch.convert import bcvae_state_dict
from said_tpu_torch.data.blendvoca import (
    BLENDSHAPE_CLASSES,
    PERSON_IDS_TEST,
    PERSON_IDS_TRAIN,
    PERSON_IDS_VAL,
    BlendVOCAEvalDataset,
)
from said_tpu_torch.eval import metrics
from said_tpu_torch.utils import audio
from said_tpu_torch.utils.blendshape import save_blendshape_coeffs

SR = 16000
FRAMES = 150  # 31 windows of 120 frames a clip


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _gaussians(rng, d, k):
    a = rng.standard_normal((k, d, d)) * 0.3
    return [(rng.standard_normal(d), a[j] @ a[j].T + 0.5 * np.eye(d)) for j in range(k)]


def test_frechet_distance_and_multimodality_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((300, 16)), rng.standard_normal((250, 16)) * 1.3 + 0.2
    for got_stat, want_stat in ((metrics.get_statistic(x), jmetrics.get_statistic(x)),
                                (metrics.get_statistic(y), jmetrics.get_statistic(y))):
        assert np.array_equal(got_stat.mean, want_stat.mean) and np.array_equal(got_stat.cov, want_stat.cov)
    sx, sy = metrics.get_statistic(x), metrics.get_statistic(y)
    got = metrics.frechet_distance(sx.mean, sx.cov, sy.mean, sy.cov)
    assert _rel(got, jmetrics.frechet_distance(sx.mean, sx.cov, sy.mean, sy.cov)) <= 1e-9
    singular = np.zeros((16, 16))  # the eps-regularised fallback
    assert _rel(metrics.frechet_distance(sx.mean, singular, sy.mean, sy.cov),
                jmetrics.frechet_distance(sx.mean, singular, sy.mean, sy.cov)) <= 1e-9
    assert _rel(metrics.multimodality(list(x[:200]), list(y[:200])),
                jmetrics.multimodality(list(x[:200]), list(y[:200]))) <= 1e-9
    assert metrics.multimodality([], []) == jmetrics.multimodality([], []) == 0.0


def test_wind_matches_jax_on_the_same_mixtures():
    rng = np.random.default_rng(1)
    comps1, comps2 = _gaussians(rng, 8, 5), _gaussians(rng, 8, 4)
    w1, w2 = rng.dirichlet(np.ones(5)), rng.dirichlet(np.ones(4))
    got = metrics.wind([metrics.StatisticGMM(m, c, w) for (m, c), w in zip(comps1, w1)],
                       [metrics.StatisticGMM(m, c, w) for (m, c), w in zip(comps2, w2)])
    want = jmetrics.wind([jmetrics.StatisticGMM(m, c, w) for (m, c), w in zip(comps1, w1)],
                         [jmetrics.StatisticGMM(m, c, w) for (m, c), w in zip(comps2, w2)])
    assert _rel(got, want) <= 1e-9


def _speechy(seconds, seed):
    """Bursts of noise at a few onsets (so there are audio beats)."""
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal(int(seconds * SR))
    for t in rng.uniform(0.1, seconds - 0.3, 6):
        i = int(t * SR)
        x[i : i + 3000] += np.hanning(3000) * rng.standard_normal(3000) * 0.5
    return x.astype(np.float32)


def test_beats_match_jax():
    waves = [_speechy(2.5, s) for s in range(3)]
    rng = np.random.default_rng(3)
    coeffs = [np.cumsum(rng.standard_normal((150, 32)), axis=0).astype(np.float32) * 0.01 for _ in range(3)]
    for w in waves:
        got, want = audio.compute_audio_beat_time(w, SR), jaudio.compute_audio_beat_time(w, SR)
        assert got.shape == want.shape and got.size > 0 and np.abs(got - want).max() <= 1e-9
    got = metrics.beat_consistency_score(waves, coeffs, SR, 60, 0.1)
    want = jmetrics.beat_consistency_score(waves, coeffs, SR, 60, 0.1)
    assert want > 0 and abs(got - want) <= 1e-9


def test_gmm_matches_sklearn_on_separated_gaussians():
    """Five separated Gaussians in 64-d (1900 points): the torch mixture's
    weights and means within 1e-2 of sklearn's once components are
    matched, and WInD between two such fits within 1e-3 relative."""
    sklearn_mixture = pytest.importorskip("sklearn.mixture")
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((5, 64)) * 6
    sizes = [300, 500, 200, 400, 500]

    def draw(shift):
        return np.concatenate([c + shift + rng.standard_normal((n, 64)) * rng.uniform(0.5, 1.5, 64)
                               for c, n in zip(centers, sizes)])

    x, y = draw(0.0), draw(0.3)
    fits = {}
    for name, data, seed in (("x", x, 0), ("y", y, 1)):
        got = metrics.get_statistic_gmm(data, 5, torch.Generator().manual_seed(seed))
        sk = sklearn_mixture.GaussianMixture(5, random_state=seed).fit(data)
        want = [metrics.StatisticGMM(sk.means_[c], sk.covariances_[c], sk.weights_[c]) for c in range(5)]
        match = [int(np.argmin([np.abs(g.mean - w.mean).max() for g in got])) for w in want]
        assert sorted(match) == list(range(5))
        for j, w in zip(match, want):
            assert abs(got[j].weight - w.weight) <= 1e-2 and np.abs(got[j].mean - w.mean).max() <= 1e-2
        fits[name] = got, want
    assert _rel(metrics.wind(fits["x"][0], fits["y"][0]), metrics.wind(fits["x"][1], fits["y"][1])) <= 1e-3


def test_gmm_is_reproducible_from_its_generator():
    x = np.random.default_rng(2).standard_normal((400, 8))
    a, b = (metrics.get_statistic_gmm(x, 3, torch.Generator().manual_seed(5)) for _ in range(2))
    for ga, gb in zip(a, b):
        assert np.array_equal(ga.mean, gb.mean) and np.array_equal(ga.cov, gb.cov) and ga.weight == gb.weight
    assert sum(g.weight for g in a) == pytest.approx(1.0)


# ------------------------------------------------------------ the CLIs


def _write_wav(path, seconds, seed):
    from scipy.io import wavfile

    wavfile.write(path, SR, (_speechy(seconds, seed) * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def eval_split(tmp_path_factory):
    """2 test persons × 2 sentences of 150 frames: audio, the real CSVs,
    generated = real + noise in 2 repeats, a deltas pickle and a BCVAE
    ``.pth`` (the JAX init with random BatchNorm statistics)."""
    root = tmp_path_factory.mktemp("eval_split")
    rng = np.random.default_rng(0)
    deltas = {}
    for pid in PERSON_IDS_TEST:
        for sub in ("audio", "real", "gen"):
            (root / sub / pid).mkdir(parents=True)
        deltas[pid] = {name: rng.standard_normal((10, 3)).astype(np.float32) for name in BLENDSHAPE_CLASSES}
        for sid in (1, 2):
            _write_wav(str(root / "audio" / pid / f"sentence{sid:02}.wav"), FRAMES / 60, seed=sid)
            real = np.clip(0.5 + np.cumsum(rng.standard_normal((FRAMES, 32)), axis=0) * 0.02, 0, 1)
            save_blendshape_coeffs(real.astype(np.float32), BLENDSHAPE_CLASSES,
                                   str(root / "real" / pid / f"sentence{sid:02}.csv"))
            for k in range(2):
                gen = np.clip(real + rng.standard_normal(real.shape) * 0.05, 0, 1).astype(np.float32)
                save_blendshape_coeffs(gen, BLENDSHAPE_CLASSES, str(root / "gen" / pid / f"sentence{sid:02}-{k}.csv"))
    with open(root / "deltas.pkl", "wb") as f:
        pickle.dump(deltas, f)
    variables = JBCVAE().init({"params": jax.random.PRNGKey(3)}, np.zeros((1, 120, 32), np.float32), use_noise=False)
    params, stats = jax.tree.map(np.asarray, (variables["params"], variables["batch_stats"]))
    stats = jax.tree.map(lambda a: a + rng.uniform(0.0, 0.2, a.shape).astype(np.float32), stats)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in bcvae_state_dict(params, stats).items()},
               str(root / "vae.pth"))
    return root


def test_eval_dataset_items_are_bit_identical(eval_split):
    got = BlendVOCAEvalDataset(str(eval_split / "audio"), str(eval_split / "gen"), str(eval_split / "deltas.pkl"))
    want = JEvalDataset(str(eval_split / "audio"), str(eval_split / "gen"), str(eval_split / "deltas.pkl"),
                        preload=False)
    assert len(got) == len(want) == 8
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert (a.person_id, a.sentence_id) == (b.person_id, b.sentence_id)
        for x, y in ((a.waveform, b.waveform), (a.blendshape_coeffs, b.blendshape_coeffs),
                     (a.blendshape_delta, b.blendshape_delta)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_test_evaluate_matches_the_jax_cli(eval_split, capsys):
    """The same ``.pth`` and CSVs: FD and multimodality within 1e-6
    relative of the JAX CLI's, WInD finite, beat consistency and the
    vertex error equal; the legacy ``--eval_dir`` pair gives the same."""
    from said_tpu.cli import test_evaluate as j_test_evaluate

    common = ["--audio_dir", str(eval_split / "audio"), "--vae_weights_path", str(eval_split / "vae.pth"),
              "--wind_num_repeats", "2", "--beat_consistency", "--vertex_error",
              "--blendshape_residuals_path", str(eval_split / "deltas.pkl")]
    pair = ["--coeffs_dir", str(eval_split / "gen"), "--coeffs_real_dir", str(eval_split / "real")]
    got = test_evaluate.main(["--device", "cpu", *common, *pair])
    capsys.readouterr()
    j_test_evaluate.main(["--device", "cpu", *common, *pair])
    want = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("frechet_distance", "multimodality"):
        assert want[key] > 0 and _rel(got[key], want[key]) <= 1e-6, key
    for key in ("beat_consistency", "vertex_error"):
        assert _rel(got[key], want[key]) <= 1e-6, key
    assert np.isfinite(got["wind"]["mean"]) and got["wind"]["mean"] >= 0 and got["wind"]["std"] >= 0
    legacy = test_evaluate.main(["--device", "cpu", *common, "--eval_dir", str(eval_split / "gen"),
                                 "--coeffs_dir", str(eval_split / "real")])
    assert legacy == got


def test_generate_latents_info_batches_do_not_change_the_latents(eval_split):
    model = load_vae(str(eval_split / "vae.pth"), device=torch.device("cpu"))
    dataset = BlendVOCAEvalDataset(str(eval_split / "audio"), str(eval_split / "real"))
    a = test_evaluate.generate_latents_info(model, dataset, 1, padding=2)
    b = test_evaluate.generate_latents_info(model, dataset, 1, padding=2, encode_batch=7)
    assert len(a) == len(b) == 4 * (FRAMES - 120 + 1 - 2)
    for x, y in zip(a, b):
        assert (x.person_id, x.sentence_id, x.frame_start) == (y.person_id, y.sentence_id, y.frame_start)
        np.testing.assert_allclose(x.latent, y.latent, rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_noise", ["false", "true"])
def test_inference_vae_matches_the_jax_cli(eval_split, tmp_path, use_noise):
    """Without noise the CSV equals the JAX CLI's within 1e-5; with noise
    (ε from each package's own generator) it is a valid reconstruction."""
    from said_tpu.cli import inference_vae as j_inference_vae

    args = ["--weights_path", str(eval_split / "vae.pth"), "--use_noise", use_noise,
            "--blendshape_coeffs_path", str(eval_split / "real" / PERSON_IDS_TEST[0] / "sentence01.csv")]
    got = inference_vae.main(["--device", "cpu", "--output_path", str(tmp_path / "port.csv"), *args])
    j_inference_vae.main(["--device", "cpu", "--output_path", str(tmp_path / "jax.csv"), *args])
    want = load_blendshape_coeffs(str(tmp_path / "jax.csv"))
    assert got.shape == want.shape == (120, 32)
    np.testing.assert_array_equal(load_blendshape_coeffs(str(tmp_path / "port.csv")), got)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    if use_noise == "false":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_load_vae_paths(tmp_path):
    a, b = (load_vae("", seed=4, device=torch.device("cpu")) for _ in range(2))
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    with pytest.raises(FileNotFoundError, match="no_such.pth"):
        load_vae(str(tmp_path / "no_such.pth"), device=torch.device("cpu"))


def test_train_vae_runs_and_checkpoints(tmp_path):
    """Two epochs on a toy tree (2 train persons × 3 sentences, 1 val
    person): finite metrics lines for both epochs, validation at 2, and a
    train state that restores into a fresh one."""
    from said_tpu_torch.core.checkpoint import restore_train_state
    from said_tpu_torch.models.vae import BCVAE
    from said_tpu_torch.train.vae_train import VAETrainConfig, VAETrainState

    rng = np.random.default_rng(0)
    for pid, n in ((PERSON_IDS_TRAIN[0], 3), (PERSON_IDS_TRAIN[1], 3), (PERSON_IDS_VAL[0], 1)):
        (tmp_path / "coeffs" / pid).mkdir(parents=True)
        for sid in range(1, n + 1):
            save_blendshape_coeffs(rng.uniform(0, 1, (130, 32)).astype(np.float32), BLENDSHAPE_CLASSES,
                                   str(tmp_path / "coeffs" / pid / f"sentence{sid:02}.csv"))
    out = tmp_path / "out"
    state = train_vae.main(["--device", "cpu", "--coeffs_dir", str(tmp_path / "coeffs"), "--output_dir", str(out),
                            "--batch_size", "4", "--epochs", "2", "--val_period", "2", "--val_repeat", "1",
                            "--save_period", "2"])
    with open(out / "SAiD-VAE" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines] == [1, 2] and "Validation/loss" in lines[1]
    assert all(np.isfinite(v) for line in lines for v in line.values())
    assert state.step == 4 and state.optimizer.count == 4  # 6 items in batches of 4, 2 epochs
    fresh = VAETrainState(BCVAE(), VAETrainConfig())
    restore_train_state(str(out / "ckpt" / "2"), fresh)
    assert fresh.step == 4
    for (n, x), (_, y) in zip(state.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(x, y), n
