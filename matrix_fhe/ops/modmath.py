"""Exact 64-bit modular arithmetic.

The reference does element-wise modular arithmetic with `unsigned __int128 %`
on CUDA (include/core/common.cuh:20-24, noted there as un-optimized).
Division is the expensive part, so the hot path never divides:

  * add/sub mod q: single conditional subtract (q < 2^63, no wraparound).
  * mul mod q: Montgomery REDC with R = 2^64.  The needed 64x64->128 high
    product is built from four exact 32-bit-half products.  All constant
    tables (NTT twiddles, W-CRT Vandermonde rows, secret keys) are stored in
    the Montgomery domain so that one REDC computes a plain-domain product:
    mont_mul(a, b*R mod q) == a*b mod q.

Everything operates on jnp.uint64 arrays of any shape; the modulus may be a
scalar or a broadcastable array (for per-limb batched ops).

Host-side helpers (Python ints, exact) mirror the reference's table-building
math: pow/inv (common.cuh:26-39), the order-4n root search
(ntt_core.cu:49-70) and the order-p eta search (HE.cu:119-133).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

U64 = jnp.uint64
_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def to_u64(x) -> jnp.ndarray:
    """Convert Python ints / sequences / numpy arrays to jnp.uint64 (values
    may exceed 2^63; route through numpy which accepts the full u64 range)."""
    return jnp.asarray(np.asarray(x, dtype=np.uint64))


def u64c(val: int) -> np.uint64:
    """A uint64 scalar constant from a Python int (masked to 64 bits)."""
    return np.uint64(val & 0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# Element-wise mod-q ops (q < 2^63)
# ---------------------------------------------------------------------------

def add_mod(a, b, q):
    s = a + b
    return jnp.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    return jnp.where(a >= b, a - b, a + (q - b))


def neg_mod(a, q):
    return jnp.where(a == 0, a, q - a)


def mulhi64(a, b):
    """Exact high 64 bits of a*b for uint64 inputs (four 32-bit products)."""
    a0 = a & _M32
    a1 = a >> _S32
    b0 = b & _M32
    b1 = b >> _S32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> _S32) + (p01 & _M32) + (p10 & _M32)
    return p11 + (p01 >> _S32) + (p10 >> _S32) + (mid >> _S32)


def mont_mul(a, b, q, qinv_neg):
    """Montgomery product a*b*R^-1 mod q, R = 2^64.

    Requires a*b < q*R (always true for a,b < 2^63).  `qinv_neg` is
    -q^-1 mod 2^64.  Result is fully reduced (< q).
    """
    lo = a * b
    hi = mulhi64(a, b)
    m = lo * qinv_neg
    mq_hi = mulhi64(m, q)
    carry = (lo != 0).astype(U64)  # lo + (m*q)_lo == 2^64 exactly when lo != 0
    t = hi + mq_hi + carry
    return jnp.where(t >= q, t - q, t)


def mul_mod(a, b, q, qinv_neg, r2):
    """Plain-domain a*b mod q via two REDCs (r2 = R^2 mod q)."""
    return mont_mul(mont_mul(a, b, q, qinv_neg), r2, q, qinv_neg)


def to_mont(a, q, qinv_neg, r2):
    """a -> a*R mod q."""
    return mont_mul(a, r2, q, qinv_neg)


def from_mont(a, q, qinv_neg):
    """a*R -> a mod q (REDC against 1)."""
    one = jnp.ones((), U64)
    return mont_mul(a, one, q, qinv_neg)


# ---------------------------------------------------------------------------
# Per-modulus constants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MontConsts:
    """Montgomery constants for one modulus (host-computed, exact)."""

    q: int
    qinv_neg: int  # -q^-1 mod 2^64
    r_mod: int     # 2^64 mod q
    r2: int        # (2^64)^2 mod q

    @classmethod
    def make(cls, q: int) -> "MontConsts":
        if q % 2 == 0 or q >= 1 << 63:
            raise ValueError("modulus must be odd and < 2^63")
        r = 1 << 64
        qinv = pow(q, -1, r)
        return cls(q=q, qinv_neg=(r - qinv) % r, r_mod=r % q, r2=(r % q) ** 2 % q)


def mont_consts_arrays(moduli: Sequence[int], shape_suffix=()):
    """Stack per-limb constants into uint64 arrays of shape [L, *1s] that
    broadcast against data shaped [L, ...suffix]."""
    cs = [MontConsts.make(int(q)) for q in moduli]
    expand = (len(moduli),) + (1,) * len(shape_suffix)

    def pack(vals):
        return jnp.asarray(np.array([v & 0xFFFFFFFFFFFFFFFF for v in vals],
                                    dtype=np.uint64).reshape(expand))

    return {
        "q": pack([c.q for c in cs]),
        "qinv_neg": pack([c.qinv_neg for c in cs]),
        "r_mod": pack([c.r_mod for c in cs]),
        "r2": pack([c.r2 for c in cs]),
    }


# ---------------------------------------------------------------------------
# Host math (exact Python ints) — mirrors the reference table builders
# ---------------------------------------------------------------------------

def host_pow_mod(base: int, exp: int, mod: int) -> int:
    return pow(base, exp, mod)


def host_inv_mod(x: int, mod: int) -> int:
    return pow(x, mod - 2, mod)  # mod prime (common.cuh:37-39)


def find_psi_4n(q: int, n: int) -> int:
    """Smallest-root order-4n element with psi^(2n) == -1.

    Mirrors ntt_core.cu:49-70 (root candidates from 2 upward) so tables are
    bit-identical to the reference's.
    """
    order = 4 * n
    if (q - 1) % order != 0:
        raise ValueError(f"modulus {q} does not support NTT size {n}")
    root = 2
    while root <= 100000:
        g = pow(root, (q - 1) // order, q)
        if pow(g, 2 * n, q) == q - 1:
            return g
        root += 1
    raise ValueError(f"failed to find psi4n for mod {q}")


def find_eta(q: int, p: int, f1: int, f2: int) -> int:
    """Order-p root search, mirroring h_find_eta (HE.cu:119-133): smallest
    generator g from 2 upward with eta = g^((q-1)/p) of exact order p."""
    exp = (q - 1) // p
    for g in range(2, q):
        eta = pow(g, exp, q)
        if eta == 1:
            continue
        if pow(eta, p, q) != 1:
            continue
        if pow(eta, p // f1, q) == 1:
            continue
        if pow(eta, p // f2, q) == 1:
            continue
        return eta
    raise ValueError("failed to find eta for W-CRT")


# ---------------------------------------------------------------------------
# u32-pair (lo, hi) element-wise mod ops — the fast-float roundtrip's word
# format (models/he.py): residues stay as u32 planes between stages and use
# these (q passed as u32 plane pair ql/qh with qh < 2^16).
# ---------------------------------------------------------------------------

def pair_split(x):
    """uint64 -> (lo, hi) u32 planes."""
    return ((x & u64c(0xFFFFFFFF)).astype(jnp.uint32),
            (x >> np.uint64(32)).astype(jnp.uint32))


def pair_join(lo, hi):
    return lo.astype(U64) | (hi.astype(U64) << np.uint64(32))


def pair_add_mod(al, ah, bl, bh, ql, qh):
    U32 = jnp.uint32
    sl = al + bl
    sh = ah + bh + (sl < al).astype(U32)
    ge = (sh > qh) | ((sh == qh) & (sl >= ql))
    borrow = ((sl < ql) & ge).astype(U32)
    return (jnp.where(ge, sl - ql, sl), jnp.where(ge, sh - qh - borrow, sh))


def pair_sub_mod(al, ah, bl, bh, ql, qh):
    U32 = jnp.uint32
    lt = (ah < bh) | ((ah == bh) & (al < bl))
    # a + q when a < b (no overflow: a < q, a + q < 2q < 2^49)
    cl = al + ql
    ch = ah + qh + (cl < al).astype(U32)
    al2 = jnp.where(lt, cl, al)
    ah2 = jnp.where(lt, ch, ah)
    borrow = (al2 < bl).astype(U32)
    return (al2 - bl, ah2 - bh - borrow)


def pair_consts(moduli, extra_dims: int):
    """(ql, qh) u32 plane constants shaped [L, 1, 1, ...]."""
    q = np.asarray(moduli, dtype=np.uint64)
    shape = (len(q),) + (1,) * extra_dims
    return (jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                        ).reshape(shape),
            jnp.asarray((q >> np.uint64(32)).astype(np.uint32)
                        ).reshape(shape))
