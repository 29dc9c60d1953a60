"""The XLA-composed modular transforms against plain Python-integer
oracles, across rings and limb widths (28 to 60 bits).

  * XNTT forward/inverse/mul_s/mul_s_pair vs the schoolbook ring product,
    rings {nega, gl, gl2} x widths {28, 35, 45, 55};
  * WTransform forward/inverse/forward_pair vs the Vandermonde matvec;
  * FourStepNTT roundtrip + agreement with a naive negacyclic DFT at
    N in {2^10, 2^12} x widths {28, 35, 60}.
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import generate_ntt_primes, get_params
from matrix_fhe.ops import modmath as mm
from matrix_fhe.ops.ntt import RING_GL, RING_GL2, RING_NEGACYCLIC, XNTT
from matrix_fhe.ops.ntt_large import (FourStepNTT, FourStepPlan,
                                      _find_generator, generate_primes_1mod)
from matrix_fhe.ops.wcrt import WTransform
from matrix_fhe.tables import build_tables

WIDTHS = (28, 35, 45, 55)


@functools.lru_cache(maxsize=None)
def _params(bits: int):
    """The tiny geometry (n=8, phi=8) on two `bits`-wide limbs."""
    base = get_params("tiny")
    moduli = generate_ntt_primes(2, bits, base.n, base.p, below=True)
    return dataclasses.replace(base, name=f"tiny-{bits}bit", moduli=moduli)


def _polymul(a, b, q: int, wrap: int) -> np.ndarray:
    """Schoolbook product of trailing-axis polynomials mod (X^m - wrap)."""
    m = a.shape[-1]
    a, b = a.astype(object), b.astype(object)
    out = np.zeros(np.broadcast_shapes(a.shape, b.shape), dtype=object)
    for i in range(m):
        for j in range(m):
            t = a[..., i] * b[..., j]
            if i + j < m:
                out[..., i + j] += t
            else:
                out[..., i + j - m] += t * wrap
    return (out % q).astype(np.uint64)


@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL, RING_GL2])
def test_xntt_matches_schoolbook(ring, bits):
    p = _params(bits)
    xn = XNTT(p, ring=ring)
    m = 2 * p.n if ring == RING_GL2 else p.n
    rng = np.random.default_rng(bits)
    a = np.stack([rng.integers(0, q, (2, 3, m), dtype=np.uint64)
                  for q in p.moduli])
    s = np.stack([rng.integers(0, q, (2, m), dtype=np.uint64)
                  for q in p.moduli])
    ja = jnp.asarray(a)
    assert (np.asarray(xn.inverse(xn.forward(ja))) == a).all()
    c = mm.mont_consts_arrays(p.moduli, shape_suffix=(1, 1))
    s_mont = mm.to_mont(xn.forward(jnp.asarray(s)), c["q"], c["qinv_neg"],
                        c["r2"])
    got = np.asarray(xn.mul_s(ja, s_mont))
    for l, q in enumerate(p.moduli):
        want = _polymul(a[l], s[l][:, None, :], int(q), xn.wrap_constant(l))
        assert (got[l] == want).all(), (ring, bits, l)
    lo, hi = xn.mul_s_pair(*mm.pair_split(ja), *mm.pair_split(s_mont))
    assert (np.asarray(mm.pair_join(lo, hi)) == got).all()


@pytest.mark.parametrize("bits", WIDTHS)
def test_wcrt_matches_vandermonde(bits):
    p = _params(bits)
    t = build_tables(p)
    wt = WTransform(p, t)
    rng = np.random.default_rng(100 + bits)
    x = np.stack([rng.integers(0, q, (p.phi, 5), dtype=np.uint64)
                  for q in p.moduli])
    got = np.asarray(wt.forward(jnp.asarray(x)))
    for l, q in enumerate(p.moduli):
        want = (t.w_fwd[l].astype(object) @ x[l].astype(object)) % int(q)
        assert (got[l] == want.astype(np.uint64)).all(), (bits, l)
    assert (np.asarray(wt.inverse(jnp.asarray(got))) == x).all()
    lo, hi = wt.forward_pair(*mm.pair_split(jnp.asarray(x)))
    assert (np.asarray(mm.pair_join(lo, hi)) == got).all()


@functools.lru_cache(maxsize=None)
def _fourstep_primes(bits: int):
    return generate_primes_1mod(2, bits, 1 << 13)


@pytest.mark.parametrize("bits", (28, 35, 60))
@pytest.mark.parametrize("log_n", (10, 12))
def test_fourstep_matches_naive_negacyclic_dft(log_n, bits):
    """Exact roundtrip, and spectrum entries equal the naive evaluation
    sum_i x_i psi^(i(2k+1)) at the natural index k = k1 + n1*k2 of
    four-step position k1*n2 + k2."""
    n = 1 << log_n
    primes = _fourstep_primes(bits)
    plan = FourStepPlan.make(n, primes)
    ntt = FourStepNTT(plan)
    rng = np.random.default_rng(log_n * 100 + bits)
    x = np.stack([rng.integers(0, q, (2, n), dtype=np.uint64)
                  for q in primes])
    y = ntt.forward(jnp.asarray(x))
    assert (np.asarray(ntt.inverse(y)) == x).all()
    y = np.asarray(y)
    i = np.arange(n, dtype=np.int64)
    for l, q in enumerate(primes):
        psi = pow(_find_generator(q), (q - 1) // (2 * n), q)
        pw = np.array([pow(psi, e, q) for e in range(2 * n)], dtype=object)
        for pos in rng.integers(0, n, 4):
            k1, k2 = divmod(int(pos), plan.n2)
            k = k1 + plan.n1 * k2
            for b in range(2):
                want = int((x[l, b].astype(object)
                            * pw[(i * (2 * k + 1)) % (2 * n)]).sum() % q)
                assert int(y[l, b, pos]) == want, (log_n, bits, l, pos)
