"""Bit-parity of the deterministic RNG streams with a Python port of the
reference kernels (HE.cu:564-627, 690-713)."""

import math

import numpy as np
import jax.numpy as jnp

from matrix_fhe.config import get_params
from matrix_fhe.models import rng as r

M64 = (1 << 64) - 1


def _splitmix64_py(x):
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def test_uniform_a_matches_reference_lcg():
    p = get_params("tiny")
    L, W, n = p.num_limbs, p.phi, p.n
    got = np.asarray(r.uniform_a(p))
    assert got.shape == (L, W, n, n)
    for (l, w, y, x) in [(0, 0, 0, 0), (1, 3, 2, 5), (2, 7, 7, 7)]:
        idx = ((w * L + l) * n * n + y * n + x)
        seed = (123456789 + idx) & M64
        seed = (seed * 6364136223846793005 + 1442695040888963407) & M64
        assert int(got[l, w, y, x]) == seed % p.moduli[l]


def test_ternary_secret_matches_reference_hash():
    p = get_params("tiny")
    got = np.asarray(r.ternary_secret(p))
    for (l, w, x) in [(0, 0, 0), (1, 5, 3), (2, 7, 6)]:
        t = (w * 1315423911 + x * 2654435761) & M64
        rr = (t * 11400714819323198485 & M64) % 3
        q = p.moduli[l]
        want = 0 if rr == 0 else (1 if rr == 1 else q - 1)
        assert int(got[l, w, x]) == want
    # consistent across limbs
    c = np.asarray(got)
    for l in range(1, p.num_limbs):
        centered0 = np.where(c[0] == p.moduli[0] - 1, -1, c[0].astype(np.int64))
        centeredl = np.where(c[l] == p.moduli[l] - 1, -1, c[l].astype(np.int64))
        assert (centered0 == centeredl).all()


def test_gaussian_noise_matches_reference_boxmuller():
    p = get_params("tiny")
    got = np.asarray(r.gaussian_noise(p))
    n = p.n
    for (w, y, x) in [(0, 0, 0), (3, 1, 2), (7, 7, 7)]:
        cid = w * n * n + y * n + x
        seed = 0xD6E8FEB86659FD93 ^ cid
        r1 = _splitmix64_py(seed)
        r2 = _splitmix64_py(r1)
        inv53 = 1.0 / 9007199254740992.0
        u1 = ((r1 >> 11) + 1.0) * inv53
        u2 = ((r2 >> 11) + 1.0) * inv53
        mag = 3.2 * math.sqrt(-2.0 * math.log(u1))
        z = mag * math.cos(6.283185307179586 * u2)
        want = int(math.floor(z + 0.5)) if z >= 0 else int(math.ceil(z - 0.5))
        for l, q in enumerate(p.moduli):
            expect = want if want >= 0 else q + want
            assert int(got[l, w, y, x]) == expect, (l, w, y, x)


def test_gaussian_noise_statistics():
    p = get_params("small")
    got = np.asarray(r.gaussian_noise(p))[0].astype(np.int64)
    q = p.moduli[0]
    centered = np.where(got > q // 2, got - q, got)
    assert abs(centered.mean()) < 0.2
    assert 2.6 < centered.std() < 3.8  # sigma = 3.2


def test_fresh_streams_shapes():
    import jax
    p = get_params("tiny")
    k = jax.random.PRNGKey(0)
    assert r.fresh_uniform_a(k, p).shape == (p.num_limbs, p.phi, p.n, p.n)
    s = r.fresh_ternary_secret(k, p)
    assert s.shape == (p.num_limbs, p.phi, p.n)
    e = np.asarray(r.fresh_gaussian_noise(k, p))
    assert e.shape == (p.num_limbs, p.phi, p.n, p.n)
