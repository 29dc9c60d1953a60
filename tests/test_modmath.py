"""Property tests for ops/modmath vs exact Python integers.

Mirrors the contract of the reference's device helpers
(include/core/common.cuh:12-39, include/backend/phantom_math.cuh:17-28):
every operation must be bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import REF_RNS_MODULI, get_params
from matrix_fhe.ops import modmath as mm

MODULI = list(REF_RNS_MODULI) + list(get_params("tiny").moduli)


def _rand_residues(rng, q, shape):
    return rng.integers(0, q, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("q", MODULI)
def test_add_sub_neg_mod(rng, q):
    a = _rand_residues(rng, q, 1024)
    b = _rand_residues(rng, q, 1024)
    qj = mm.u64c(q)
    got_add = np.asarray(mm.add_mod(jnp.asarray(a), jnp.asarray(b), qj))
    got_sub = np.asarray(mm.sub_mod(jnp.asarray(a), jnp.asarray(b), qj))
    got_neg = np.asarray(mm.neg_mod(jnp.asarray(a), qj))
    assert (got_add == (a.astype(object) + b) % q).all()
    assert (got_sub == (a.astype(object) - b) % q).all()
    assert (got_neg == (-a.astype(object)) % q).all()


def test_mulhi64(rng):
    a = rng.integers(0, 1 << 64, size=2048, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=2048, dtype=np.uint64)
    got = np.asarray(mm.mulhi64(jnp.asarray(a), jnp.asarray(b)))
    want = [(int(x) * int(y)) >> 64 for x, y in zip(a, b)]
    assert got.tolist() == want


@pytest.mark.parametrize("q", MODULI)
def test_mont_mul_and_mul_mod(rng, q):
    c = mm.MontConsts.make(q)
    a = _rand_residues(rng, q, 2048)
    b = _rand_residues(rng, q, 2048)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    qinv = mm.u64c(c.qinv_neg)
    r2 = mm.u64c(c.r2)
    qj = mm.u64c(q)

    got_mont = np.asarray(mm.mont_mul(aj, bj, qj, qinv))
    rinv = pow(1 << 64, -1, q)
    want_mont = [(int(x) * int(y) * rinv) % q for x, y in zip(a, b)]
    assert got_mont.tolist() == want_mont

    got_mul = np.asarray(mm.mul_mod(aj, bj, qj, qinv, r2))
    want_mul = [(int(x) * int(y)) % q for x, y in zip(a, b)]
    assert got_mul.tolist() == want_mul

    # mont-domain table trick: mont_mul(a, b*R) == a*b
    bR = jnp.asarray(np.array([int(x) * c.r_mod % q for x in b], dtype=np.uint64))
    got = np.asarray(mm.mont_mul(aj, bR, qj, qinv))
    assert got.tolist() == want_mul


def test_to_from_mont_roundtrip(rng):
    q = REF_RNS_MODULI[0]
    c = mm.MontConsts.make(q)
    a = _rand_residues(rng, q, 512)
    aj = jnp.asarray(a)
    am = mm.to_mont(aj, mm.u64c(q), mm.u64c(c.qinv_neg), mm.u64c(c.r2))
    back = mm.from_mont(am, mm.u64c(q), mm.u64c(c.qinv_neg))
    assert np.asarray(back).tolist() == a.tolist()


def test_root_searches_match_reference_algorithm():
    # psi4n: order-4n root with psi^(2n) == -1 (ntt_core.cu:49-70)
    for q in REF_RNS_MODULI[:3]:
        psi = mm.find_psi_4n(q, 64)
        assert pow(psi, 128, q) == q - 1
        assert pow(psi, 256, q) == 1
    # eta: exact order-771 root (HE.cu:119-133)
    eta = mm.find_eta(REF_RNS_MODULI[0], 771, 3, 257)
    assert pow(eta, 771, REF_RNS_MODULI[0]) == 1
    assert pow(eta, 771 // 3, REF_RNS_MODULI[0]) != 1
    assert pow(eta, 771 // 257, REF_RNS_MODULI[0]) != 1


def test_mont_consts_arrays_shapes():
    cs = mm.mont_consts_arrays(REF_RNS_MODULI, shape_suffix=(1, 1))
    assert cs["q"].shape == (11, 1, 1)
    assert int(cs["q"][0, 0, 0]) == REF_RNS_MODULI[0]
