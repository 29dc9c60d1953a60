"""Deterministic on-device randomness, bit-compatible with the reference.

The reference uses counter-based integer hashes so runs are reproducible
without seed plumbing (SURVEY §4):
  * uniform `a`: LCG of (123456789 + flat_index), flat index taken over the
    reference's matrix-major [W][L][y][x] layout (uniform_random_kernel,
    HE.cu:564-578);
  * ternary secret: weyl-style hash of (w, x) mapped to {0, +1, -1}
    (ternary_secret_kernel, HE.cu:690-713);
  * Gaussian noise sigma=3.2: splitmix64 -> Box-Muller -> llround, same
    integer in every limb (gaussian_noise_kernel, HE.cu:581-627).

All streams are pure integer (or integer-rounded) functions of position, so
zero-noise golden-vector parity with the CUDA reference is exact; the
Gaussian path additionally matches in f64 (XLA's f64 log/cos/sqrt agree
with CUDA's to the ulp for these magnitudes — and any ulp flip only perturbs
noise by ±1, which the scheme absorbs by design).

A production-grade jax.random (threefry) path is provided alongside for real
deployments (`fresh_*` functions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GLParams

U64 = jnp.uint64


def _iota4(params: GLParams):
    """Broadcasted index arrays (l, w, y, x) for shape [L, W, n, n]."""
    L, W, n = params.num_limbs, params.phi, params.n
    l = jax.lax.broadcasted_iota(U64, (L, W, n, n), 0)
    w = jax.lax.broadcasted_iota(U64, (L, W, n, n), 1)
    y = jax.lax.broadcasted_iota(U64, (L, W, n, n), 2)
    x = jax.lax.broadcasted_iota(U64, (L, W, n, n), 3)
    return l, w, y, x


def _moduli_col(params: GLParams, extra_dims: int) -> jnp.ndarray:
    q = np.array(params.moduli, dtype=np.uint64)
    return jnp.asarray(q.reshape((len(q),) + (1,) * extra_dims))


def uniform_a(params: GLParams) -> jnp.ndarray:
    """Reference-exact uniform polynomial in W-coeff domain, [L, W, n, n].

    Bit-for-bit port of uniform_random_kernel (HE.cu:564-578): the LCG seed
    is the flat index in the reference's [W][L][y][x] layout.  Implemented
    in u32-pair arithmetic with a float-assisted Barrett quotient (exact
    after sign/range corrections) — no 64-bit integer division.
    """
    U32 = jnp.uint32
    L, W, n = params.num_limbs, params.phi, params.n
    if min(int(q) for q in params.moduli) < (1 << 33):
        # quotient would overflow u32; small-parameter sets use the plain
        # u64 modulo (they are test-scale anyway)
        l, w, y, x = _iota4(params)
        idx_ref = ((w * np.uint64(L) + l) * np.uint64(n * n)
                   + y * np.uint64(n) + x)
        seed = np.uint64(123456789) + idx_ref
        seed = (seed * np.uint64(6364136223846793005)
                + np.uint64(1442695040888963407))
        return seed % _moduli_col(params, 3)
    shape = (L, W, n, n)
    l = jax.lax.broadcasted_iota(U32, shape, 0)
    w = jax.lax.broadcasted_iota(U32, shape, 1)
    y = jax.lax.broadcasted_iota(U32, shape, 2)
    x = jax.lax.broadcasted_iota(U32, shape, 3)
    idx = (w * np.uint32(L) + l) * np.uint32(n * n) + y * np.uint32(n) + x
    s0 = idx + np.uint32(123456789)          # < 2^32: single u32 word
    c1 = 6364136223846793005
    c2 = 1442695040888963407

    m16 = np.uint32(0xFFFF)

    def wide_mul_u32(a, bl32, bh32):
        """(hi, lo) of (a < 2^32) * (bh32*2^32 + bl32), b a constant."""
        a0 = a & m16
        a1 = a >> np.uint32(16)
        b0 = np.uint32(bl32 & 0xFFFF)
        b1 = np.uint32(bl32 >> 16)
        ll = a0 * b0
        lh = a0 * b1
        hl = a1 * b0
        hh = a1 * b1
        mid = (ll >> np.uint32(16)) + (lh & m16) + (hl & m16)
        lo = (ll & m16) | (mid << np.uint32(16))
        hi = (hh + (lh >> np.uint32(16)) + (hl >> np.uint32(16))
              + (mid >> np.uint32(16)) + a * np.uint32(bh32))
        return hi, lo

    # seed = s0 * c1 + c2 (mod 2^64) on u32 pairs
    hi, lo = wide_mul_u32(s0, c1 & 0xFFFFFFFF, c1 >> 32)
    lo2 = lo + np.uint32(c2 & 0xFFFFFFFF)
    hi = hi + np.uint32(c2 >> 32) + (lo2 < lo).astype(U32)
    lo = lo2
    # seed mod q per limb: Barrett with f64-assisted quotient, then exact
    # u32 corrections (quotient is off by at most ~2 either way)
    qs = np.asarray(params.moduli, dtype=np.uint64)
    ql = jnp.asarray((qs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                     ).reshape(L, 1, 1, 1)
    qh = jnp.asarray((qs >> np.uint64(32)).astype(np.uint32)
                     ).reshape(L, 1, 1, 1)
    qinv = jnp.asarray(1.0 / qs.astype(np.float64)).reshape(L, 1, 1, 1)
    f = lo.astype(jnp.float64) + hi.astype(jnp.float64) * np.float64(2.0**32)
    t = jnp.maximum(f * qinv - 2.0, 0.0)
    t32 = t.astype(U32)                       # quotient < 2^31 for q >= 2^34
    # r = seed - t*q (two-word), with q < 2^48; here q is a per-limb PLANE,
    # so inline the same 16-bit split against plane operands
    t0 = t32 & m16
    t1 = t32 >> np.uint32(16)
    q0 = ql & m16
    q1 = ql >> np.uint32(16)
    pll = t0 * q0
    plh = t0 * q1
    phl = t1 * q0
    phh = t1 * q1
    pmid = (pll >> np.uint32(16)) + (plh & m16) + (phl & m16)
    p_lo = (pll & m16) | (pmid << np.uint32(16))
    p_hi = (phh + (plh >> np.uint32(16)) + (phl >> np.uint32(16))
            + (pmid >> np.uint32(16)) + t32 * qh)
    borrow = (lo < p_lo).astype(U32)
    rl = lo - p_lo
    rh = hi - p_hi - borrow
    # up to ~4 subtractions of q remain (quotient was biased low by 2)
    for _ in range(4):
        ge = (rh > qh) | ((rh == qh) & (rl >= ql))
        b = ((rl < ql) & ge).astype(U32)
        rl = jnp.where(ge, rl - ql, rl)
        rh = jnp.where(ge, rh - qh - b, rh)
    return rl.astype(jnp.uint64) | (rh.astype(jnp.uint64) << jnp.uint64(32))


def uniform_a_pair(params: GLParams):
    """uniform_a as u32 (lo, hi) planes (hot-path format)."""
    from ..ops import modmath as mm

    return mm.pair_split(uniform_a(params))


def ternary_secret(params: GLParams) -> jnp.ndarray:
    """Reference-exact ternary secret in W-coeff domain, [L, W, n]
    (ternary_secret_kernel, HE.cu:690-713): value depends on (w, x) only and
    is mapped into every limb; 0 -> 0, 1 -> 1, 2 -> q-1."""
    L, W, n = params.num_limbs, params.phi, params.n
    w = jax.lax.broadcasted_iota(U64, (L, W, n), 1)
    x = jax.lax.broadcasted_iota(U64, (L, W, n), 2)
    t = w * np.uint64(1315423911) + x * np.uint64(2654435761)
    r = (t * np.uint64(11400714819323198485)) % np.uint64(3)
    q = _moduli_col(params, 2)
    return jnp.where(r == 0, jnp.zeros((), U64),
                     jnp.where(r == 1, jnp.ones((), U64), q - np.uint64(1)))


def splitmix64(x: jnp.ndarray) -> jnp.ndarray:
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def gaussian_noise(params: GLParams) -> jnp.ndarray:
    """Discrete Gaussian (sigma, Box-Muller, llround) in W-coeff domain,
    [L, W, n, n]; the same integer is mapped into every limb
    (gaussian_noise_kernel, HE.cu:581-627)."""
    L, W, n = params.num_limbs, params.phi, params.n
    w = jax.lax.broadcasted_iota(U64, (W, n, n), 0)
    y = jax.lax.broadcasted_iota(U64, (W, n, n), 1)
    x = jax.lax.broadcasted_iota(U64, (W, n, n), 2)
    coeff_id = w * np.uint64(n * n) + y * np.uint64(n) + x
    seed = np.uint64(0xD6E8FEB86659FD93) ^ coeff_id
    r1 = splitmix64(seed)
    r2 = splitmix64(r1)
    inv53 = np.float64(1.0 / 9007199254740992.0)  # 2^-53
    u1 = ((r1 >> np.uint64(11)).astype(jnp.float64) + 1.0) * inv53
    u2 = ((r2 >> np.uint64(11)).astype(jnp.float64) + 1.0) * inv53
    mag = params.sigma * jnp.sqrt(-2.0 * jnp.log(u1))
    z = mag * jnp.cos(np.float64(6.283185307179586) * u2)
    noise = llround(z)  # [W, n, n] int64
    q = _moduli_col(params, 3)
    pos = noise[None].astype(U64)
    neg = q - (-noise)[None].astype(U64)
    return jnp.where(noise[None] >= 0, pos, neg)


def llround(z: jnp.ndarray) -> jnp.ndarray:
    """C llround: round half away from zero -> int64 (jnp.round would round
    half to even)."""
    return jnp.where(z >= 0, jnp.floor(z + 0.5), jnp.ceil(z - 0.5)
                     ).astype(jnp.int64)


# ---------------------------------------------------------------------------
# Production path: proper counter-based PRNG (threefry) for real key material
# ---------------------------------------------------------------------------

def fresh_uniform_a(key: jax.Array, params: GLParams,
                    shape: tuple | None = None) -> jnp.ndarray:
    """shape: trailing (per-limb) dims; default (W, n, n).  Rectangular
    frames (e.g. the gl2 ring's [W, n, 2n] / 2D-tensor [W, 2n, 2n]) pass
    it explicitly."""
    L, W, n = params.num_limbs, params.phi, params.n
    shape = (W, n, n) if shape is None else tuple(shape)
    bits = jax.random.bits(key, (L,) + shape, dtype=jnp.uint64)
    return bits % _moduli_col(params, len(shape))  # negligible bias, q << 2^64


def fresh_ternary_secret(key: jax.Array, params: GLParams) -> jnp.ndarray:
    W, n = params.phi, params.n
    r = jax.random.randint(key, (W, n), 0, 3)
    q = _moduli_col(params, 2)
    r = jnp.broadcast_to(r[None], (params.num_limbs, W, n))
    return jnp.where(r == 0, jnp.zeros((), U64),
                     jnp.where(r == 1, jnp.ones((), U64), q - np.uint64(1)))


def fresh_gaussian_noise(key: jax.Array, params: GLParams,
                         shape: tuple | None = None) -> jnp.ndarray:
    """shape: trailing (per-limb) dims; default (W, n, n).  The same
    integer lands in every limb (limb-consistent small ring element)."""
    W, n = params.phi, params.n
    shape = (W, n, n) if shape is None else tuple(shape)
    z = jax.random.normal(key, shape, dtype=jnp.float64) * params.sigma
    noise = llround(z)
    q = _moduli_col(params, len(shape))
    return jnp.where(noise[None] >= 0, noise[None].astype(U64),
                     q - (-noise)[None].astype(U64))
