"""X-axis NTT oracles, ported from test/test_custom_ntt_roundtrip.cu:

  * forward/inverse roundtrip over full batch (both rings)
  * negacyclic polymul vs O(n^2) schoolbook with X^n = wrap_constant
    wraparound (test:256-319)
  * GL permutation scatter/gather roundtrip (ntt_core.cu:150-173)
"""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.tables import build_tables
from matrix_fhe.ops.ntt import XNTT, RING_GL, RING_NEGACYCLIC, apply_gl_perm
from matrix_fhe.ops import modmath as mm


@pytest.fixture(scope="module", params=["tiny", "small"])
def params(request):
    return get_params(request.param)


@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL])
def test_ntt_roundtrip_batched(params, rng, ring):
    x = np.stack([rng.integers(0, q, size=(5, 3, params.n), dtype=np.uint64)
                  for q in params.moduli])
    ntt = XNTT(params, ring=ring)
    back = np.asarray(ntt.inverse(ntt.forward(jnp.asarray(x))))
    assert (back == x).all()


@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL])
def test_ntt_polymul_vs_schoolbook(params, ring):
    """NTT-domain pointwise product == schoolbook product mod X^n - wrap."""
    n = params.n
    ntt = XNTT(params, ring=ring)
    L = params.num_limbs
    a = np.stack([[np.arange(1, n + 1, dtype=np.uint64) % q]
                  for q in params.moduli])  # [L,1,n]
    b = np.stack([[np.arange(3, n + 3, dtype=np.uint64) % q]
                  for q in params.moduli])

    fa = ntt.forward(jnp.asarray(a))
    fb = ntt.forward(jnp.asarray(b))
    # pointwise modular multiply per limb
    prods = []
    for l, q in enumerate(params.moduli):
        c = mm.MontConsts.make(int(q))
        prods.append(mm.mul_mod(fa[l], fb[l], mm.u64c(q),
                                mm.u64c(c.qinv_neg), mm.u64c(c.r2)))
    fc = jnp.stack(prods)
    got = np.asarray(ntt.inverse(fc))

    for l, q in enumerate(params.moduli):
        wrap = ntt.wrap_constant(l)
        ref = [0] * n
        for j in range(n):
            for k in range(n):
                p = int(a[l, 0, j]) * int(b[l, 0, k]) % q
                if j + k < n:
                    ref[j + k] = (ref[j + k] + p) % q
                else:
                    ref[j + k - n] = (ref[j + k - n] + p * wrap) % q
        assert got[l, 0].tolist() == ref, f"limb {l} ring {ring}"


def test_gl_perm_roundtrip(params, rng):
    t = build_tables(params)
    x = jnp.asarray(rng.integers(0, 100, size=(3, params.n), dtype=np.uint64))
    y = apply_gl_perm(x, t.gl_perm)
    back = apply_gl_perm(y, t.gl_inv_perm)
    assert (np.asarray(back) == np.asarray(x)).all()
    # forward map places index j at bit_reverse((5^j - 1)/4)
    m4 = 4 * params.n
    e = 1
    logn = params.n.bit_length() - 1
    for j in range(params.n):
        idx = (e - 1) // 4
        br = int(bin(idx + (1 << logn))[3:][::-1], 2) if logn else 0
        assert int(t.gl_perm[j]) == br
        e = e * 5 % m4
