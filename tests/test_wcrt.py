"""W-CRT transform oracles, ported from the reference test suite:

  * exact centered-integer roundtrip, max_err == 0
    (test/test_wcrt_roundtrip.cu:36-72)
  * basis-vector spot check against host-recomputed eta powers
    (test/test_custom_ntt_roundtrip.cu:169-254)
  * mod-q forward/inverse roundtrip per limb
"""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.tables import build_tables
from matrix_fhe.ops.wcrt import WTransform
from matrix_fhe.ops.crt import centered_i64_to_rns


@pytest.fixture(scope="module", params=["tiny", "small"])
def wt(request):
    p = get_params(request.param)
    return WTransform(p)


def test_tables_inverse_is_exact(wt):
    """V @ V^-1 == I mod q for every limb (the Lagrange inverse must equal
    the unique modular inverse the reference's Gauss-Jordan computes)."""
    t = wt.tables
    for l, q in enumerate(wt.params.moduli):
        v = t.w_fwd[l].astype(object)
        vi = t.w_inv[l].astype(object)
        prod = (v @ vi) % q
        eye = np.eye(wt.params.phi, dtype=object)
        assert (prod == eye).all(), f"limb {l}"


def test_wcrt_centered_roundtrip_exact():
    """Mirror of test_wcrt_roundtrip.cu: pattern (w+x+y)%17-8, err must be 0.

    Run at a single-limb preset (Q < 2^63): with multiple limbs the reference
    kernel's int64 saturation (he_big_to_i64_checked) destroys the limb-0
    congruence and the roundtrip cannot hold — see
    WTransform.forward_centered's fidelity note."""
    p = get_params("tiny1")
    wt1 = WTransform(p)
    n, phi = p.n, p.phi
    w_idx = np.arange(phi)[:, None, None]
    y_idx = np.arange(n)[None, :, None]
    x_idx = np.arange(n)[None, None, :]
    coeff = ((w_idx + x_idx + y_idx) % 17 - 8).astype(np.int64)
    ev = wt1.forward_centered(jnp.asarray(coeff))
    rt = wt1.inverse_centered(ev)
    assert (np.asarray(rt) == coeff).all()


def test_wcrt_centered_bit_parity_with_reference_kernel(wt):
    """forward_centered must reproduce the reference kernel bit-for-bit,
    *including* its saturation behavior on multi-limb chains
    (wntt_forward_centered_kernel + he_big_to_i64_checked)."""
    p = wt.params
    t = wt.tables
    phi, Q = p.phi, p.q_total
    rng = np.random.default_rng(3)
    v = rng.integers(-8, 9, size=(phi, 1, 1)).astype(np.int64)
    got = np.asarray(wt.forward_centered(jnp.asarray(v)))
    Ms = [Q // q for q in p.moduli]
    invs = [pow(M % q, -1, q) for M, q in zip(Ms, p.moduli)]
    I64MAX = 2**63 - 1
    for w in range(phi):
        acc = 0
        for l, q in enumerate(p.moduli):
            a = sum(int(v[r, 0, 0]) % q * int(t.w_fwd[l][w][r])
                    for r in range(phi)) % q
            acc = (acc + Ms[l] * (a * invs[l] % q)) % Q
        neg = acc > Q // 2
        mag = Q - acc if neg else acc
        if mag > I64MAX:
            want = -(2**63) if neg else I64MAX
        else:
            want = -mag if neg else mag
        assert int(got[w, 0, 0]) == want, w


def test_wcrt_modq_roundtrip(wt, rng):
    p = wt.params
    x = np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
                  for q in p.moduli])
    back = np.asarray(wt.inverse(wt.forward(jnp.asarray(x))))
    assert (back == x).all()


def test_wcrt_basis_vector_check(wt):
    """Forward of delta at coefficient r0 must equal root_w^r0 per lane
    (test_custom_ntt_roundtrip.cu:225-249)."""
    p = wt.params
    t = wt.tables
    r0 = min(3, p.phi - 1)
    coeff = np.zeros((p.phi, 1, 1), dtype=np.int64)
    coeff[r0, 0, 0] = 1
    rns = centered_i64_to_rns(jnp.asarray(coeff), p.moduli)
    ev = np.asarray(wt.forward(rns))
    for l, q in enumerate(p.moduli):
        eta = t.eta[l]
        for w in range(min(8, p.phi)):
            root = pow(eta, p.w_exponents[w], q)
            assert int(ev[l, w, 0, 0]) == pow(root, r0, q), (l, w)


def test_wdft_inverse_of_forward(wt, rng):
    p = wt.params
    re = rng.integers(-50, 50, size=(p.phi, p.n, p.n)).astype(np.float64)
    im = rng.integers(-50, 50, size=(p.phi, p.n, p.n)).astype(np.float64)
    er, ei = wt.dft_forward_pair(jnp.asarray(re), jnp.asarray(im))
    br, bi = wt.dft_inverse_pair(er, ei)
    assert np.max(np.abs(np.asarray(br) - re)) < 1e-6
    assert np.max(np.abs(np.asarray(bi) - im)) < 1e-6


def test_wdft_matches_direct_evaluation(wt):
    """Lane w of the forward W-DFT evaluates the coeff polynomial at
    zeta_p^(exp[w]) (init_wdft_tables semantics, HE.cu:275-310)."""
    p = wt.params
    rng = np.random.default_rng(7)
    re = rng.integers(-5, 5, size=(p.phi, 1, 1)).astype(np.float64)
    im = np.zeros_like(re)
    er, ei = wt.dft_forward_pair(jnp.asarray(re), jnp.asarray(im))
    for w in range(min(4, p.phi)):
        z = np.exp(2j * np.pi * p.w_exponents[w] / p.p)
        want = sum(re[r, 0, 0] * z ** r for r in range(p.phi))
        got = complex(np.asarray(er)[w, 0, 0], np.asarray(ei)[w, 0, 0])
        assert abs(got - want) < 1e-6 * max(1.0, abs(want))
