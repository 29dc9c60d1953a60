"""Gaussian-integer RNS element ops (ops/gint.py; gpu_math.cuh:11-91)."""

import numpy as np
import jax.numpy as jnp

from matrix_fhe.ops import gint
from matrix_fhe.config import get_params


def _mk(rng, moduli, shape):
    return gint.GaussianIntRNS(
        jnp.asarray(np.stack([rng.integers(0, q, size=shape, dtype=np.uint64)
                              for q in moduli])),
        jnp.asarray(np.stack([rng.integers(0, q, size=shape, dtype=np.uint64)
                              for q in moduli])))


def test_gint_algebra_vs_python():
    p = get_params("tiny")
    moduli = p.moduli
    rng = np.random.default_rng(0)
    a = _mk(rng, moduli, (5,))
    b = _mk(rng, moduli, (5,))
    prod = gint.mul(a, b, moduli)
    for l, q in enumerate(moduli):
        ax, ay = np.asarray(a.x[l]).astype(object), np.asarray(a.y[l]).astype(object)
        bx, by = np.asarray(b.x[l]).astype(object), np.asarray(b.y[l]).astype(object)
        assert (np.asarray(prod.x[l]) == (ax * bx - ay * by) % q).all()
        assert (np.asarray(prod.y[l]) == (ax * by + ay * bx) % q).all()
    s = gint.add(a, b, moduli)
    d = gint.sub(s, b, moduli)
    np.testing.assert_array_equal(np.asarray(d.x), np.asarray(a.x))
    np.testing.assert_array_equal(np.asarray(d.y), np.asarray(a.y))


def test_gint_conj_and_neg_i():
    p = get_params("tiny")
    moduli = p.moduli
    rng = np.random.default_rng(1)
    a = _mk(rng, moduli, (4,))
    # conj(conj(a)) == a; (-i)^4 a == a; -i * i ... via four applications
    c2 = gint.conj(gint.conj(a, moduli), moduli)
    np.testing.assert_array_equal(np.asarray(c2.x), np.asarray(a.x))
    np.testing.assert_array_equal(np.asarray(c2.y), np.asarray(a.y))
    r = a
    for _ in range(4):
        r = gint.mul_by_neg_i(r, moduli)
    np.testing.assert_array_equal(np.asarray(r.x), np.asarray(a.x))
    np.testing.assert_array_equal(np.asarray(r.y), np.asarray(a.y))
    # -i * a computed via mul() against the literal (0, q-1) constant
    L = len(moduli)
    negi = gint.GaussianIntRNS(
        jnp.zeros((L, 4), dtype=jnp.uint64),
        jnp.asarray(np.stack([np.full(4, q - 1, dtype=np.uint64)
                              for q in moduli])))
    via_mul = gint.mul(a, negi, moduli)
    direct = gint.mul_by_neg_i(a, moduli)
    np.testing.assert_array_equal(np.asarray(via_mul.x), np.asarray(direct.x))
    np.testing.assert_array_equal(np.asarray(via_mul.y), np.asarray(direct.y))
