"""Homomorphic trace GEMM vs an exact numpy/bigint oracle
(trace.cu:30-161, batched_trace.cu:37-197)."""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.models import trace


@pytest.fixture(scope="module")
def setup(rng):
    p = get_params("tiny")
    shape = (p.num_limbs, 4, p.n, p.n)  # 4 W-lanes batched
    mk = lambda: np.stack([rng.integers(0, q, size=shape[1:], dtype=np.uint64)
                           for q in p.moduli])
    return p, mk(), mk(), mk(), mk()


def _oracle_bprime(br, bi, q, n):
    bp_r = np.zeros_like(br)
    bp_i = np.zeros_like(bi)
    for j in range(n):
        j_dst = (n - j) % n
        for k in range(n):
            a = int(br[j, k])
            b = int(bi[j, k])
            if j == 0:
                bp_r[j_dst, k] = a
                bp_i[j_dst, k] = (q - b) % q
            else:
                bp_r[j_dst, k] = (q - b) % q
                bp_i[j_dst, k] = (q - a) % q
    return bp_r, bp_i


def test_map_bprime_matches_kernel(setup):
    p, ar, ai, br, bi = setup
    got_r, got_i = trace.map_b_to_bprime(jnp.asarray(br), jnp.asarray(bi), p)
    for l, q in enumerate(p.moduli):
        for w in range(br.shape[1]):
            wr, wi = _oracle_bprime(br[l, w], bi[l, w], q, p.n)
            assert (np.asarray(got_r)[l, w] == wr).all(), (l, w)
            assert (np.asarray(got_i)[l, w] == wi).all(), (l, w)


def test_trace_gemm_matches_oracle(setup):
    p, ar, ai, br, bi = setup
    bp_r, bp_i = trace.map_b_to_bprime(jnp.asarray(br), jnp.asarray(bi), p)
    cr, ci = trace.trace_gemm(jnp.asarray(ar), jnp.asarray(ai), bp_r, bp_i, p)
    n = p.n
    bpr = np.asarray(bp_r).astype(object)
    bpi = np.asarray(bp_i).astype(object)
    for l, q in enumerate(p.moduli):
        for w in range(ar.shape[1]):
            A = ar[l, w].astype(object) + 1j * 0  # keep exact ints
            prod_r = (ar[l, w].astype(object) @ bpr[l, w].T
                      - ai[l, w].astype(object) @ bpi[l, w].T)
            prod_i = (ar[l, w].astype(object) @ bpi[l, w].T
                      + ai[l, w].astype(object) @ bpr[l, w].T)
            want_r = (prod_r * n) % q
            want_i = (prod_i * n) % q
            assert (np.asarray(cr)[l, w].astype(object) == want_r).all(), (l, w)
            assert (np.asarray(ci)[l, w].astype(object) == want_i).all(), (l, w)


def test_rescale_by_delta(setup):
    p, ar, ai, _, _ = setup
    got_r, got_i = trace.rescale_by_delta(jnp.asarray(ar), jnp.asarray(ai), p)
    d = int(p.delta)
    for l, q in enumerate(p.moduli):
        inv = pow(d % q, -1, q)
        assert (np.asarray(got_r)[l].astype(object)
                == ar[l].astype(object) * inv % q).all()
        assert (np.asarray(got_i)[l].astype(object)
                == ai[l].astype(object) * inv % q).all()


def test_trace_semantics_diagonal(setup):
    """B' of the identity-scale matrix keeps C = n * A @ B'^T consistent under
    rescale: sanity that trace_matmul composes without error."""
    p, ar, ai, br, bi = setup
    cr, ci = trace.trace_matmul(jnp.asarray(ar), jnp.asarray(ai),
                                jnp.asarray(br), jnp.asarray(bi), p)
    assert cr.shape == ar.shape and ci.shape == ai.shape
