"""The port's flash attention (its plain version, on the CPU) against the
JAX package's TPU kernels K1 ``_flash_tpu_packed`` and K2
``_flash_tpu_packed_blocked``, run in interpret mode as
``tests/test_pallas_kernel.py`` runs them.

Inputs are made from numpy seeds and handed to both in float32. Bound:
atol 2e-5, rtol 1e-4, the JAX kernel tests' own. With lengths, rows below
each length must match and rows at or past it must be exactly zero (the
port zero-fills them; K1/K2 leave finite garbage in straddling blocks).
The adversarial cases mirror tests/test_pallas_kernel.py:194-292, where
K2's max-free exp2 shift is most at risk; the port's online softmax must
agree with it there too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from said_tpu.ops.pallas_attention import (
    _dense_reference,
    _flash_tpu_packed,
    _flash_tpu_packed_blocked,
)
from said_tpu_torch.ops import attention

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(t, s, b, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v


def _flat(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


def _k1(q, k, v, h, lengths=None):
    return np.asarray(_flash_tpu_packed(
        jnp.asarray(_flat(q)), jnp.asarray(_flat(k)), jnp.asarray(_flat(v)),
        None if lengths is None else jnp.asarray(lengths), num_heads=h, block_q=128,
        has_lens=lengths is not None, interpret=True,
    ))


def _k2(q, k, v, h, lengths=None):
    return np.asarray(_flash_tpu_packed_blocked(
        jnp.asarray(_flat(q)), jnp.asarray(_flat(k)), jnp.asarray(_flat(v)),
        None if lengths is None else jnp.asarray(lengths), num_heads=h, block_q=128,
        block_k=128, has_lens=lengths is not None, interpret=True,
    ))


def _plain(q, k, v, h, lengths=None):
    lens = None if lengths is None else torch.from_numpy(np.asarray(lengths, np.int32))
    return attention.flash_attention_plain(
        torch.from_numpy(_flat(q)), torch.from_numpy(_flat(k)), torch.from_numpy(_flat(v)), h, lens
    ).numpy()


def _dense(q, k, v, lengths=None):
    return np.asarray(_dense_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths=lengths)
                      ).reshape(q.shape[0], q.shape[1], -1)


_KERNELS = {"K1": _k1, "K2": _k2}


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t,s", [(256, 256), (300, 300), (256, 520)])
def test_flash_plain_matches_tpu_kernel(kernel, d, t, s):
    q, k, v = _qkv(t, s, b=2, h=2, d=d)
    np.testing.assert_allclose(_plain(q, k, v, 2), _KERNELS[kernel](q, k, v, 2), **TOL)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_flash_plain_runtime_lengths(kernel):
    q, k, v = _qkv(384, 384, b=3, h=2, d=32)
    lengths = np.array([384, 200, 129], np.int32)  # full, straddling, straddling
    got = _plain(q, k, v, 2, lengths)
    want = _KERNELS[kernel](q, k, v, 2, lengths)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)
        assert np.all(got[i, n:] == 0.0)


def test_flash_plain_outlier_key_off_the_landmarks():
    """A 50x-norm key at index 100 (not on K2's landmark stride)."""
    q, k, v = _qkv(384, 384, b=1, h=2, d=32)
    k[:, 100] *= 50.0
    got = _plain(q, k, v, 2)
    np.testing.assert_allclose(got, _k2(q, k, v, 2), **TOL)
    np.testing.assert_allclose(got, _dense(q, k, v), **TOL)
    assert np.all(np.isfinite(got))


def test_flash_plain_aligned_maxnorm_outlier():
    """A query aligned with a huge-norm key: softmax is one-hot there."""
    q, k, v = _qkv(384, 384, b=1, h=2, d=32)
    k[:, 37] = 40.0 * q[:, 5] / np.linalg.norm(q[:, 5], axis=-1, keepdims=True)
    got = _plain(q, k, v, 2)
    np.testing.assert_allclose(got, _k2(q, k, v, 2), **TOL)
    np.testing.assert_allclose(got, _dense(q, k, v), **TOL)


def test_flash_plain_all_scores_very_negative():
    """Every score far below zero; t = 300 straddles the key blocks."""
    rng = np.random.default_rng(7)
    b, h, d, t = 1, 2, 32, 300
    base = rng.standard_normal((1, 1, h, d))
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    k = (12.0 * base + 0.05 * rng.standard_normal((b, t, h, d))).astype(np.float32)
    q = (-12.0 * base + 0.05 * rng.standard_normal((b, t, h, d))).astype(np.float32)
    v = rng.standard_normal((b, t, h, d)).astype(np.float32)
    got = _plain(q, k, v, h)
    np.testing.assert_allclose(got, _k2(q, k, v, h), **TOL)
    np.testing.assert_allclose(got, _dense(q, k, v), **TOL)


def test_flash_plain_garbage_beyond_runtime_lengths():
    """Huge values in the padded keys must not reach the real rows."""
    q, k, v = _qkv(384, 384, b=2, h=2, d=32)
    lengths = np.array([384, 200], np.int32)
    k[1, 200:] = 1e4
    v[1, 200:] = 1e4
    got = _plain(q, k, v, 2, lengths)
    want = _k2(q, k, v, 2, lengths)
    ref = _dense(q, k, v, lengths)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)
        np.testing.assert_allclose(got[i, :n], ref[i, :n], **TOL)
    assert np.all(got[1, 200:] == 0.0) and np.all(np.isfinite(got))


def test_flash_plain_zero_length_row():
    """A length-0 row: no key runs, the output is zeros, never 0/0."""
    q, k, v = _qkv(256, 256, b=2, h=2, d=32)
    lengths = np.array([256, 0], np.int32)
    got = _plain(q, k, v, 2, lengths)
    np.testing.assert_allclose(got[0], _k2(q, k, v, 2, lengths)[0], **TOL)
    np.testing.assert_allclose(got[0], _dense(q, k, v)[0], **TOL)
    assert np.all(got[1] == 0.0) and np.all(np.isfinite(got))


def test_flash_plain_bf16_tracks_k1():
    """bf16 inputs: below 512 keys the plain version's running max is the
    row max, so its rounding of Q and of p to bf16 is K1's; what is left
    is f32 summation order and one bf16 rounding of the output."""
    q, k, v = _qkv(300, 300, b=2, h=2, d=32, seed=3)
    got = attention.flash_attention_plain(
        *(torch.from_numpy(_flat(x)).bfloat16() for x in (q, k, v)), 2).float().numpy()
    want = np.asarray(_flash_tpu_packed(
        *(jnp.asarray(_flat(x), jnp.bfloat16) for x in (q, k, v)), num_heads=2, block_q=128,
        interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
    assert np.abs(got - want).mean() < 1e-3
