"""Double-float32 (hi+lo split) matrix products for the complex transform
paths, and f64-exact integer helpers for the u32-pair decode compose.

dd_matmul splits each f64 operand into (f32 hi, f32 lo = x - hi) and forms

    a @ b  ~=  sum_chunks f64(ah @ bh) + f64(ah @ bl + al @ bh)

the hi*hi term K-chunked with float64 combination so the f32 accumulator
never sees more than `K_CHUNK` terms (error ~2^-21 per chunk, ~2^-20
total), and the cross terms 2^-24-scaled so plain f32 accumulation
suffices.  The dropped lo*lo term is ~2^-48.  Every f32 product asks for
Precision.HIGHEST, so no TF32 rounding enters.

The exact-f64 paths (models/encoder.py, ops/crt.py) remain the oracles.
Gates: fast_float_default() covers the EXACT integer helpers (u32-pair
quantize, scaled inverse + mod-2^64 compose); dd_transforms_default()
covers the approximate split-f32 matmuls (opt-in only).
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
F64 = jnp.float64
K_CHUNK = 64
_HIGHEST = jax.lax.Precision.HIGHEST


# The ref roundtrip on the u32-pair path took 19.33 ms against 38.33 ms on
# the u64 path on one H100 80GB HBM3 at a 400 W power limit (PERF.md,
# fast_float A/B).
FAST_FLOAT = True


def fast_float_default() -> bool:
    """Default of every `fast_float=None` constructor argument: the exact
    u32-pair roundtrip (pair quantize, scaled inverse + mod-2^64 compose,
    cached parity streams) when True, the u64 path with the big-int
    compose when False.  Both are exact up to f64 ulps of the decode."""
    return FAST_FLOAT


def dd_transforms_default() -> bool:
    """Gate for the split-f32 complex transforms.  These carry a ~2^-20
    RELATIVE error floor (f32 accumulators round every partial sum), which
    breaks the reference driver's ABSOLUTE 1e-4 threshold at its 511-scale
    message magnitudes (src/main.cu:62-67,150) — so they are OPT-IN
    (MFHE_DD_TRANSFORMS=1), for workloads with O(1) message scales where
    the ~1e-6 absolute error is far inside budget."""
    return os.environ.get("MFHE_DD_TRANSFORMS", "") == "1"


def _split(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    hi = x.astype(F32)
    lo = (x - hi.astype(F64)).astype(F32)
    return hi, lo


def dd_matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """einsum('...ij,...jk->...ik', a, b) for f64 inputs via split-f32
    products; returns f64 with ~2^-20 relative accuracy."""
    ah, al = _split(a)
    bh, bl = _split(b)
    k = a.shape[-1]
    kc = min(K_CHUNK, k)
    ein = lambda x, y: jnp.einsum("...ij,...jk->...ik", x, y,
                                  precision=_HIGHEST,
                                  preferred_element_type=F32)
    main = None
    for c in range(0, k, kc):
        p = ein(ah[..., :, c:c + kc], bh[..., c:c + kc, :]).astype(F64)
        main = p if main is None else main + p
    cross = ein(ah, bl) + ein(al, bh)
    return main + cross.astype(F64)


def dd_cmatmul(ar, ai, br, bi) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Complex einsum('...ij,...jk->...ik') on f64 re/im parts."""
    rr = dd_matmul(ar, br) - dd_matmul(ai, bi)
    ri = dd_matmul(ar, bi) + dd_matmul(ai, br)
    return rr, ri


def llround_f64(x: jnp.ndarray) -> jnp.ndarray:
    """llround semantics (round half away from zero), result kept in f64
    (exact for |x| < 2^52)."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def f64_to_u32_exact(v: jnp.ndarray) -> jnp.ndarray:
    """Integer-valued f64 in [0, 2^32) -> u32, converted as 16-bit halves
    so only small-integer float->int conversions are needed."""
    hi16 = jnp.floor(v * np.float64(2.0 ** -16))
    lo16 = v - hi16 * np.float64(2.0 ** 16)
    return lo16.astype(jnp.uint32) | (hi16.astype(jnp.uint32)
                                      << jnp.uint32(16))


def f64_mod_to_pair(v: jnp.ndarray, q: int):
    """(integer-valued f64 v) mod q as u32 (lo, hi) planes, exactly, without
    64-bit integer ops.  Requires |v| < 2^52 / small-quotient bounds:
    |v|/q < 2^20.  All intermediate f64 products are integers < 2^53,
    hence exact."""
    inv = np.float64(1.0) / np.float64(q)
    t = jnp.floor(v * inv)
    m = v - t * np.float64(q)
    m = jnp.where(m < 0, m + q, m)
    m = jnp.where(m >= q, m - q, m)
    hi = jnp.floor(m * np.float64(2.0 ** -32))
    lo_f = m - hi * np.float64(2.0 ** 32)
    return f64_to_u32_exact(lo_f), hi.astype(jnp.uint32)


def f64_mod_to_u64(v: jnp.ndarray, q: int) -> jnp.ndarray:
    lo, hi = f64_mod_to_pair(v, q)
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)


def _mullo64_xla(al, ah, bl32: int, bh32: int):
    """(a * b) mod 2^64 on u32 planes, b a host constant."""
    m16 = np.uint32(0xFFFF)
    b0 = np.uint32(bl32 & 0xFFFF)
    b1 = np.uint32(bl32 >> 16)
    a0 = al & m16
    a1 = al >> np.uint32(16)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = (ll >> np.uint32(16)) + (lh & m16) + (hl & m16)
    lo = (ll & m16) | (mid << np.uint32(16))
    hi = hh + (lh >> np.uint32(16)) + (hl >> np.uint32(16)) \
        + (mid >> np.uint32(16))
    hi = hi + al * np.uint32(bh32) + ah * np.uint32(bl32)
    return lo, hi


def _add64_xla(al, ah, bl, bh):
    lo = al + bl
    hi = ah + bh + (lo < al).astype(jnp.uint32)
    return lo, hi


def compose_scaled_to_float(r_scaled: jnp.ndarray, moduli, big_q: int,
                            delta: float) -> jnp.ndarray:
    """Exact centered CRT compose / delta for PRE-SCALED residues
    r'_l = (x * M_l^{-1} mod q_l)  (the M^{-1} factor is folded into the
    W-CRT inverse tables by WTransform.inverse_scaled).

    Identity: sum_l r'_l * M_l = x + k*Q with k = round(sum_l r'_l / q_l)
    (the fractional part is x/Q ~ 2^-350, so f64 rounding is safe by ~50
    bits).  Since |x| <~ Delta * msg << 2^63, x is recovered exactly from
    its value mod 2^64, computed with u32-plane arithmetic.  This replaces
    the reference's 7-limb big-int fold (HE.cu:1007-1027) on the fast path.
    """
    lo32 = (r_scaled & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi32 = (r_scaled >> jnp.uint64(32)).astype(jnp.uint32)
    return compose_scaled_pair_to_float(lo32, hi32, moduli, big_q, delta)


def compose_scaled_pair_to_float(lo32, hi32, moduli, big_q: int,
                                 delta: float) -> jnp.ndarray:
    """compose_scaled_to_float on u32 lo/hi planes [L, ...]."""
    L = lo32.shape[0]
    acc_l = acc_h = None
    ksum = None
    for l in range(L):
        q = int(moduli[l])
        m64 = (big_q // q) % (1 << 64)
        pl, ph = _mullo64_xla(lo32[l], hi32[l], m64 & 0xFFFFFFFF, m64 >> 32)
        if acc_l is None:
            acc_l, acc_h = pl, ph
        else:
            acc_l, acc_h = _add64_xla(acc_l, acc_h, pl, ph)
        term = (lo32[l].astype(F64)
                + hi32[l].astype(F64) * np.float64(2.0 ** 32)) / np.float64(q)
        ksum = term if ksum is None else ksum + term
    k = jnp.round(ksum).astype(jnp.uint32)
    q64 = big_q % (1 << 64)
    kl, kh = _mullo64_xla(k, jnp.zeros_like(k), q64 & 0xFFFFFFFF, q64 >> 32)
    # y = acc - k*Q (mod 2^64)
    borrow = (acc_l < kl).astype(jnp.uint32)
    yl = acc_l - kl
    yh = acc_h - kh - borrow
    # centered signed interpretation (|x| << 2^63)
    v = yl.astype(F64) + jax.lax.bitcast_convert_type(
        yh, jnp.int32).astype(F64) * np.float64(2.0 ** 32)
    return v / np.float64(delta)
