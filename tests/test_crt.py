"""Exact CRT compose / center-lift vs Python big ints
(oracle for encoder.cu:112-245 and HE.cu:964-1027)."""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.tables import build_tables
from matrix_fhe.ops.crt import CRTComposer, centered_i64_to_rns


@pytest.fixture(scope="module", params=["tiny", "ref"])
def setup(request):
    p = get_params(request.param)
    return p, CRTComposer(build_tables(p))


def _to_rns(vals, moduli):
    return np.stack([np.array([v % q for v in vals], dtype=np.uint64)
                     for q in moduli])


def test_compose_centered_small_values(setup):
    p, comp = setup
    Q = p.q_total
    vals = [0, 1, -1, 12345, -98765, 2**40, -(2**40), Q // 2 - 1 - Q,  # == -(Q//2+1) centered? keep explicit below
            ]
    vals = [0, 1, -1, 12345, -98765, 2**40, -(2**40)]
    rns = _to_rns(vals, p.moduli)
    got = np.asarray(comp.compose_centered_i64(jnp.asarray(rns)))
    assert got.tolist() == vals


def test_compose_center_boundary(setup):
    """Center-lift threshold is strict acc > Q/2 (encoder.cu:220)."""
    p, comp = setup
    Q = p.q_total
    half = Q // 2  # floor; Q odd
    vals_mod = [half, half + 1, Q - 1, 1, 0]
    want = [half if half <= 2**62 else None,
            half + 1 - Q, -1, 1, 0]
    rns = _to_rns(vals_mod, p.moduli)
    got = np.asarray(comp.compose_centered_i64(jnp.asarray(rns)))
    # entries too large for i64 saturate (he_big_to_i64_checked)
    for g, w in zip(got.tolist(), want):
        if w is None or abs(w) > 2**62:
            continue
        assert g == w


def test_compose_to_float_matches_bigint(setup, rng):
    p, comp = setup
    Q = p.q_total
    delta = p.delta
    vals = [int(rng.integers(-2**50, 2**50)) for _ in range(64)]
    rns = _to_rns(vals, p.moduli)
    got = np.asarray(comp.compose_to_float(jnp.asarray(rns), delta))
    want = np.array([v / delta for v in vals])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_compose_round_div_delta_exact(setup):
    p, comp = setup
    delta = int(p.delta)
    vals = [0, 1, delta // 2 - 1, delta // 2, delta // 2 + 1, delta,
            3 * delta + delta // 2, -(delta // 2 - 1), -(delta // 2),
            -(5 * delta + delta // 2 + 1), 7 * delta - 1]
    rns = _to_rns(vals, p.moduli)
    got = np.asarray(comp.compose_round_div_delta_i64(
        jnp.asarray(rns), float(delta)))
    # reference rounds |v|/Delta to nearest (half away from zero on the
    # magnitude), then applies sign (HE.cu:981-1004)
    want = [int(np.sign(v)) * ((abs(v) + delta // 2) // delta) for v in vals]
    assert got.tolist() == want


def test_centered_i64_to_rns_roundtrip(setup, rng):
    p, comp = setup
    vals = rng.integers(-2**40, 2**40, size=128).astype(np.int64)
    rns = centered_i64_to_rns(jnp.asarray(vals), p.moduli)
    back = np.asarray(comp.compose_centered_i64(rns))
    assert (back == vals).all()
