"""Native C++ table generator vs the pure-Python oracle — outputs must be
bit-identical (the modular inverse is unique)."""

import numpy as np
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.native import tablegen
from matrix_fhe.ops.modmath import find_eta, find_psi_4n
from matrix_fhe.tables import (cyclotomic_two_primes, lagrange_inverse_mod,
                                   vandermonde_mod)

pytestmark = pytest.mark.skipif(not tablegen.available(),
                                reason="no native toolchain")


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_native_matches_python(preset):
    p = get_params(preset)
    f1, f2 = p.p_factors
    master = cyclotomic_two_primes(p.p, f1, f2)
    for q in p.moduli:
        eta = find_eta(q, p.p, f1, f2)
        roots = [pow(eta, e, q) for e in p.w_exponents]
        v_c, vi_c = tablegen.wcrt_tables(q, roots, master)
        v_py = vandermonde_mod(roots, q)
        vi_py = lagrange_inverse_mod(roots, master, q)
        assert (v_c == v_py).all()
        assert (vi_c == vi_py).all()


def test_native_root_searches():
    p = get_params("small")
    f1, f2 = p.p_factors
    for q in p.moduli:
        assert tablegen.find_eta(q, p.p, f1, f2) == find_eta(q, p.p, f1, f2)
        assert tablegen.find_psi4n(q, p.n) == find_psi_4n(q, p.n)


def test_native_ref_limb0_speed():
    """Full phi=512 limb via C++ — should be well under a second."""
    import time
    p = get_params("ref")
    f1, f2 = p.p_factors
    q = p.moduli[0]
    master = cyclotomic_two_primes(p.p, f1, f2)
    eta = find_eta(q, p.p, f1, f2)
    roots = [pow(eta, e, q) for e in p.w_exponents]
    t0 = time.time()
    v, vi = tablegen.wcrt_tables(q, roots, master)
    dt = time.time() - t0
    prod = (v.astype(object) @ vi.astype(object)) % q
    assert (prod == np.eye(512, dtype=object)).all()
    assert dt < 5.0, dt


# ---------------------------------------------------------------------------
# golden-model C++ oracle (native/golden.cpp): an INDEPENDENT native
# implementation cross-checking the JAX ops, mirroring the reference's
# host-side oracle pattern (test_custom_ntt_roundtrip.cu:169-319)
# ---------------------------------------------------------------------------

import jax.numpy as jnp

from matrix_fhe.native import golden
from matrix_fhe.config import get_params
from matrix_fhe.tables import build_tables
from matrix_fhe.models import rng as refrng

pytestmark_golden = pytest.mark.skipif(not golden.available(),
                                       reason="no C++ toolchain")


@pytest.mark.skipif(not golden.available(), reason="no C++ toolchain")
def test_golden_polymul_vs_xntt(rng):
    from matrix_fhe.ops.ntt import XNTT
    p = get_params("small")
    for ring in ("nega", "gl"):
        xn = XNTT(p, ring=ring)
        a = np.stack([rng.integers(0, q, size=(1, p.n), dtype=np.uint64)
                      for q in p.moduli])
        b = np.stack([rng.integers(0, q, size=(1, p.n), dtype=np.uint64)
                      for q in p.moduli])
        fa = np.asarray(xn.forward(jnp.asarray(a))).astype(object)
        fb = np.asarray(xn.forward(jnp.asarray(b))).astype(object)
        qcol = np.array(p.moduli, dtype=object).reshape(-1, 1, 1)
        prod = (fa * fb % qcol).astype(np.uint64)
        got = np.asarray(xn.inverse(jnp.asarray(prod)))
        for l, q in enumerate(p.moduli):
            want = golden.polymul_wrap(int(q), xn.wrap_constant(l),
                                       a[l, 0], b[l, 0])
            assert (got[l, 0] == want).all(), (ring, l)


@pytest.mark.skipif(not golden.available(), reason="no C++ toolchain")
def test_golden_wcrt_matvec(rng):
    p = get_params("small")
    t = build_tables(p)
    from matrix_fhe.ops.wcrt import WTransform
    wt = WTransform(p, t)
    x = np.stack([rng.integers(0, q, size=(p.phi,), dtype=np.uint64)
                  for q in p.moduli])
    got = np.asarray(wt.forward(jnp.asarray(x[:, :, None, None])))[..., 0, 0]
    for l, q in enumerate(p.moduli):
        want = golden.mod_matvec(int(q), t.w_fwd[l], x[l])
        assert (got[l] == want).all(), l


@pytest.mark.skipif(not golden.available(), reason="no C++ toolchain")
def test_golden_rng_streams():
    p = get_params("small")
    import jax
    got_u = np.asarray(jax.jit(lambda: refrng.uniform_a(p))())
    want_u = golden.uniform_a(p.num_limbs, p.phi, p.n, p.moduli)
    assert (got_u == want_u).all()
    got_t = np.asarray(jax.jit(lambda: refrng.ternary_secret(p))())
    want_t = golden.ternary_secret(p.num_limbs, p.phi, p.n, p.moduli)
    assert (got_t == want_t).all()


@pytest.mark.skipif(not golden.available(), reason="no C++ toolchain")
def test_golden_crt_compose(rng):
    p = get_params("small")
    t = build_tables(p)
    from matrix_fhe.ops.crt import CRTComposer
    comp = CRTComposer(t)
    moduli = np.asarray(p.moduli, dtype=np.uint64)
    xs = rng.integers(0, 1 << 60, size=(8,))
    for x in xs:
        x = int(x) - (1 << 59)
        res = np.array([x % int(q) for q in moduli], dtype=np.uint64)
        mag, neg = golden.crt_compose_centered(
            res, t.crt_m, t.crt_inv, moduli, t.crt_q_big, t.crt_q_half)
        val = 0
        for i, w in enumerate(mag):
            val |= int(w) << (64 * i)
        got = -val if neg else val
        assert got == x, (got, x)
        # cross-check the JAX composer too
        mag_j, neg_j = comp.compose_magnitude(
            jnp.asarray(res.reshape(-1, 1)))
        val_j = 0
        for i in range(len(mag_j) // 2):
            w = int(np.asarray(mag_j[2 * i])[0]) | (
                int(np.asarray(mag_j[2 * i + 1])[0]) << 32)
            val_j |= w << (64 * i)
        got_j = -val_j if bool(np.asarray(neg_j)[0]) else val_j
        assert got_j == x


@pytest.mark.skipif(not golden.available(), reason="no C++ toolchain")
@pytest.mark.parametrize("preset", ["tiny", "ref"])
def test_golden_gaussian_noise_bit_exact(preset):
    """Box-Muller noise stream: native libm (golden.cpp) vs the XLA f64 path
    (models/rng.gaussian_noise), bit-compared as mod-q integers at small AND
    ref moduli (HE.cu:581-627 contract)."""
    from matrix_fhe.config import get_params
    from matrix_fhe.models import rng as refrng

    p = get_params(preset)
    want = np.asarray(refrng.gaussian_noise(p))
    got = golden.gaussian_noise(p.num_limbs, p.phi, p.n, p.sigma, p.moduli)
    if preset == "ref":
        # full ref geometry is 11*512*64*64; compare a deterministic slice
        # plus global agreement statistics to keep the test fast
        np.testing.assert_array_equal(want[:, :8], got[:, :8])
    np.testing.assert_array_equal(want, got)
