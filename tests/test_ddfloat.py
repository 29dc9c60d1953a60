"""Fast-float (split-f32 / float-exact) paths vs the exact f64/bigint
oracles."""

import numpy as np
import jax
import jax.numpy as jnp

from matrix_fhe.config import get_params
from matrix_fhe.models.batched_encoder import BatchedEncoder
from matrix_fhe.ops import ddfloat as dd


def test_dd_matmul_accuracy(rng):
    a = jnp.asarray(rng.uniform(-3, 3, size=(64, 512)))
    b = jnp.asarray(rng.uniform(-3, 3, size=(512, 128)))
    want = np.asarray(jnp.einsum("ij,jk->ik", a, b))
    got = np.asarray(dd.dd_matmul(a, b))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5


def test_llround_f64_half_away(rng):
    x = jnp.asarray([0.5, -0.5, 1.5, -1.5, 2.49, -2.49, 0.0])
    got = np.asarray(dd.llround_f64(x))
    assert (got == np.array([1.0, -1.0, 2.0, -2.0, 2.0, -2.0, 0.0])).all()


def test_f64_mod_to_u64_exact(rng):
    q = (1 << 45) - 55
    v = rng.integers(-(1 << 50), 1 << 50, size=512)
    got = np.asarray(dd.f64_mod_to_u64(jnp.asarray(v.astype(np.float64)), q))
    want = (v % q).astype(np.uint64)
    assert (got == want).all()


def test_compose_scaled_matches_exact(rng):
    p = get_params("small")
    moduli = [int(q) for q in p.moduli]
    big_q = 1
    for q in moduli:
        big_q *= q
    # random centered integers |x| < delta * 2^8
    bound = int(p.delta) << 8
    xs = [int(x) for x in rng.integers(-bound, bound, size=256)]
    r_scaled = np.stack([
        np.array([(x % q) * pow((big_q // q) % q, q - 2, q) % q for x in xs],
                 dtype=np.uint64)
        for q in moduli])
    got = np.asarray(dd.compose_scaled_to_float(
        jnp.asarray(r_scaled), moduli, big_q, p.delta))
    want = np.array(xs, dtype=np.float64) / np.float64(p.delta)
    assert np.abs(got - want).max() < 1e-9


def test_fast_encode_decode_loopback(rng):
    p = get_params("small")
    be = BatchedEncoder(p)
    be_fast = BatchedEncoder(p)
    be_fast.encoder.fast_float = True
    be_fast.wt._inv_scaled  # materialize outside traces
    re = rng.uniform(-4, 4, size=(p.phi, p.n, p.n))
    im = rng.uniform(-4, 4, size=(p.phi, p.n, p.n))
    pr, pi = be_fast.encode_to_wntt_eval(jnp.asarray(re), jnp.asarray(im))
    dr, di = be_fast.decode_from_wntt_eval(pr, pi)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    # "small" preset Delta=2^25: quantization floor ~1e-3; the fast-float
    # transform error (~1e-6) must stay invisible under it
    assert err < 5e-3, err
    # and the fast encode must round-trip through the EXACT decoder too
    dr2, di2 = be.decode_from_wntt_eval(pr, pi)
    err2 = np.hypot(np.asarray(dr2) - re, np.asarray(di2) - im).max()
    assert err2 < 5e-3, err2
