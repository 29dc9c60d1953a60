"""Exact RNS -> Z CRT reconstruction with center-lift.

Re-designs the reference's fixed 7x64-bit big-int carry chains
(encoder.cu:53-245 big_* helpers + crt_compose_centerlift_big_kernel, and the
duplicated he_big_* family in HE.cu:859-1027) for vector lanes: big integers are
held as a static list of 32-bit digits stored in uint64 lanes so every
partial product m_digit * t_digit is exact and column sums never overflow.

    acc = sum_l  M_l * ((x_l * inv_l) mod q_l)   (mod Q, reduced per step)
    centered = acc > Q/2 ? -(Q - acc) : acc

All loops are static Python loops over <= ~2*limbs64+2 digits — XLA sees a
flat elementwise graph, fully vectorized over the coefficient array.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .modmath import U64, mont_mul, MontConsts

if TYPE_CHECKING:  # avoid tables <-> ops cycle at import time
    from ..tables import GLTables

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def _u64_words_to_digits(words: np.ndarray) -> np.ndarray:
    """[..., W] uint64 words -> [..., 2W] uint32-valued digits (in u64)."""
    lo = words & _M32
    hi = words >> _S32
    out = np.empty(words.shape[:-1] + (2 * words.shape[-1],), dtype=np.uint64)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


class CRTComposer:
    """Device-side exact CRT compose / center-lift for one parameter set."""

    def __init__(self, tables: "GLTables"):
        p = tables.params
        self.moduli = p.moduli
        self.n_digits = 2 * tables.crt_limbs64
        # M_i digit tables: [L, D] (host numpy -> device on first use)
        self.m_digits = jnp.asarray(_u64_words_to_digits(tables.crt_m))
        self.q_digits = jnp.asarray(_u64_words_to_digits(tables.crt_q_big[None])[0])
        self.q_half_digits = jnp.asarray(
            _u64_words_to_digits(tables.crt_q_half[None])[0])
        # inv_i in Montgomery form so one REDC gives (x * inv) mod q
        mont = [MontConsts.make(int(q)) for q in p.moduli]
        self.qs = jnp.asarray(np.array([m.q for m in mont], dtype=np.uint64))
        self.qinvs = jnp.asarray(
            np.array([m.qinv_neg for m in mont], dtype=np.uint64))
        self.inv_mont = jnp.asarray(np.array(
            [int(tables.crt_inv[l]) * mont[l].r_mod % mont[l].q
             for l in range(len(p.moduli))], dtype=np.uint64))

    # -- digit-vector helpers (static unrolled, digits are u64 arrays < 2^32) --

    def _normalize(self, cols: List[jnp.ndarray]) -> List[jnp.ndarray]:
        out = []
        carry = None
        for c in cols:
            if carry is not None:
                c = c + carry
            out.append(c & _M32)
            carry = c >> _S32
        return out

    def _ge(self, a: List[jnp.ndarray], b: jnp.ndarray) -> jnp.ndarray:
        """Lexicographic a >= b for digit vectors (b: [D] constant)."""
        ge = jnp.ones_like(a[0], dtype=bool)
        for i in range(len(a)):  # least -> most significant; MS decides last
            ge = jnp.where(a[i] == b[i], ge, a[i] > b[i])
        return ge

    def _gt(self, a: List[jnp.ndarray], b: jnp.ndarray) -> jnp.ndarray:
        gt = jnp.zeros_like(a[0], dtype=bool)
        for i in range(len(a)):
            gt = jnp.where(a[i] == b[i], gt, a[i] > b[i])
        return gt

    def _sub(self, a: List[jnp.ndarray], b, mask) -> List[jnp.ndarray]:
        """a - b where mask, digitwise with borrow (b: [D] constant digits)."""
        out = []
        borrow = jnp.zeros_like(a[0])
        for i in range(len(a)):
            bi = jnp.where(mask, b[i], jnp.zeros_like(b[i])) + borrow
            under = a[i] < bi
            out.append(jnp.where(under, a[i] + (jnp.uint64(1) << _S32) - bi,
                                 a[i] - bi))
            borrow = under.astype(U64)
        return out

    def _rsub(self, b: jnp.ndarray, a: List[jnp.ndarray]) -> List[jnp.ndarray]:
        """b - a (b: [D] constant digits, assumes b >= a)."""
        out = []
        borrow = jnp.zeros_like(a[0])
        for i in range(len(a)):
            ai = a[i] + borrow
            under = b[i] < ai
            out.append(jnp.where(under, b[i] + (jnp.uint64(1) << _S32) - ai,
                                 b[i] - ai))
            borrow = under.astype(U64)
        return out

    # -- main compose --------------------------------------------------------

    def compose_magnitude(self, x_rns: jnp.ndarray
                          ) -> Tuple[List[jnp.ndarray], jnp.ndarray]:
        """x_rns: [L, ...] uint64 residues -> (digits list [D] of [...], neg).

        digits hold |centered value|; neg marks acc > Q/2 (strict, matching
        encoder.cu:219-225).
        """
        L = x_rns.shape[0]
        D = self.n_digits
        shape = x_rns.shape[1:]
        acc = [jnp.zeros(shape, U64) for _ in range(D)]
        for l in range(L):
            t = mont_mul(x_rns[l], self.inv_mont[l], self.qs[l], self.qinvs[l])
            t0 = t & _M32
            t1 = t >> _S32
            cols = [jnp.zeros(shape, U64) for _ in range(D + 2)]
            for d in range(D):
                md = self.m_digits[l, d]
                p0 = md * t0
                p1 = md * t1
                cols[d] = cols[d] + (p0 & _M32)
                cols[d + 1] = cols[d + 1] + (p0 >> _S32) + (p1 & _M32)
                cols[d + 2] = cols[d + 2] + (p1 >> _S32)
            term = self._normalize(cols)[:D]  # M_l*t < Q fits in D digits
            # acc += term, then conditional -Q (mirrors encoder.cu:130-134)
            acc = self._normalize([a + b for a, b in zip(acc, term)])
            ge = self._ge(acc, self.q_digits)
            acc = self._sub(acc, self.q_digits, ge)
        neg = self._gt(acc, self.q_half_digits)
        mag = []
        qa = self._rsub(self.q_digits, acc)
        for i in range(D):
            mag.append(jnp.where(neg, qa[i], acc[i]))
        return mag, neg

    def compose_to_float(self, x_rns: jnp.ndarray, delta: float) -> jnp.ndarray:
        """Centered value / delta as float64 (compose_big_pair_to_complex_by_
        delta_kernel semantics, HE.cu:1007-1027: f64 fold from the most
        significant 64-bit word downward)."""
        mag, neg = self.compose_magnitude(x_rns)
        v = jnp.zeros(x_rns.shape[1:], jnp.float64)
        two64 = jnp.float64(18446744073709551616.0)
        for i in range(self.n_digits // 2 - 1, -1, -1):
            word = mag[2 * i] | (mag[2 * i + 1] << _S32)
            v = v * two64 + word.astype(jnp.float64)
        v = jnp.where(neg, -v, v)
        return v / jnp.float64(delta)

    def compose_centered_i64(self, x_rns: jnp.ndarray) -> jnp.ndarray:
        """Centered value as int64 assuming it fits (low-word semantics with
        saturation, he_big_to_i64_checked HE.cu:904-915)."""
        mag, neg = self.compose_magnitude(x_rns)
        low = (mag[0] | (mag[1] << _S32)).astype(jnp.uint64)
        over = jnp.zeros_like(neg)
        for i in range(2, self.n_digits):
            over = over | (mag[i] != 0)
        over = over | (low > jnp.uint64(0x7FFFFFFFFFFFFFFF))
        v = low.astype(jnp.int64)
        v = jnp.where(neg, -v, v)
        imax = jnp.int64(0x7FFFFFFFFFFFFFFF)
        imin = jnp.int64(-0x8000000000000000)
        return jnp.where(over, jnp.where(neg, imin, imax), v)

    def compose_round_div_delta_i64(self, x_rns: jnp.ndarray, delta: float
                                    ) -> jnp.ndarray:
        """Exact nearest-integer |v|/Delta with sign, Delta a power of two
        (round_big_centered_by_delta_kernel, HE.cu:964-1005)."""
        shift = int(delta).bit_length() - 1
        assert float(1 << shift) == delta, "delta must be a power of two"
        mag, neg = self.compose_magnitude(x_rns)
        if shift > 0:
            # add 2^(shift-1) then shift right by `shift`
            add_digit = (shift - 1) // 32
            add_val = np.uint64(1 << ((shift - 1) % 32))
            cols = list(mag)
            cols[add_digit] = cols[add_digit] + add_val
            cols = self._normalize(cols)
            digit_sh, bit_sh = shift // 32, np.uint64(shift % 32)
            shifted = []
            for i in range(self.n_digits):
                lo_idx = i + digit_sh
                lo = cols[lo_idx] if lo_idx < self.n_digits else jnp.zeros_like(cols[0])
                hi = cols[lo_idx + 1] if lo_idx + 1 < self.n_digits else jnp.zeros_like(cols[0])
                if int(bit_sh) == 0:
                    shifted.append(lo)
                else:
                    shifted.append(((lo >> bit_sh) |
                                    (hi << (_S32 - bit_sh))) & _M32)
            mag = shifted
        low = (mag[0] | (mag[1] << _S32)).astype(jnp.uint64)
        over = jnp.zeros_like(neg)
        for i in range(2, self.n_digits):
            over = over | (mag[i] != 0)
        over = over | (low > jnp.uint64(0x7FFFFFFFFFFFFFFF))
        v = jnp.where(neg, -(low.astype(jnp.int64)), low.astype(jnp.int64))
        imax = jnp.int64(0x7FFFFFFFFFFFFFFF)
        imin = jnp.int64(-0x8000000000000000)
        return jnp.where(over, jnp.where(neg, imin, imax), v)


def centered_i64_to_rns(x: jnp.ndarray, moduli: Sequence[int]) -> jnp.ndarray:
    """Centered int64 [...]- > residues [L, ...] uint64
    (centered_int_to_rns_matrix_kernel, HE.cu:815-835)."""
    outs = []
    for q in moduli:
        qq = jnp.int64(int(q))
        m = x % qq
        m = jnp.where(m < 0, m + qq, m)
        outs.append(m.astype(U64))
    return jnp.stack(outs, axis=0)
