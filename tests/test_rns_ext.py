"""Exact float-assisted RNS basis extension (ops/rns_ext.py)."""

import numpy as np
import jax.numpy as jnp

from matrix_fhe.config import generate_ntt_primes, get_params
from matrix_fhe.ops.rns_ext import BasisExtender


def _primes():
    p = get_params("tiny")
    qs = list(p.moduli)
    extra = [q for q in generate_ntt_primes(6, 30, p.n, p.p)
             if q not in qs][:3]
    return qs, extra


def test_extend_small_centered_exact(rng):
    qs, ps = _primes()
    be = BasisExtender(qs, ps)
    bound = min(be.q_src // 8, 1 << 62)
    v = rng.integers(-bound, bound, size=(257,)).astype(object)
    x = jnp.asarray(np.stack([(v % q).astype(np.uint64) for q in qs]))
    out = np.asarray(be.extend(x))
    for r_i, r in enumerate(ps):
        np.testing.assert_array_equal(out[r_i], (v % r).astype(np.uint64))


def test_extend_full_range_class_preserved(rng):
    """For full-range inputs the representative may be x or x +- Q_src;
    extending back onto the source primes must reproduce the input, and the
    dst residues must agree with ONE consistent representative."""
    qs, ps = _primes()
    be_self = BasisExtender(qs, qs)
    be = BasisExtender(qs, ps)
    x_int = np.array([int.from_bytes(rng.bytes(16), "little") % be.q_src
                      for _ in range(513)], dtype=object)
    x = jnp.asarray(np.stack([(x_int % q).astype(np.uint64) for q in qs]))
    np.testing.assert_array_equal(np.asarray(be_self.extend(x)),
                                  np.asarray(x))
    out = np.asarray(be.extend(x)).astype(object)
    ok = np.zeros(x_int.shape, dtype=bool)
    for rep in (x_int, x_int - be.q_src, x_int + be.q_src):
        match = np.ones_like(ok)
        for r_i, r in enumerate(ps):
            match &= out[r_i] == rep % r
        ok |= match
    assert ok.all()
