"""Large-N negacyclic NTT via the four-step (Bailey) factorization.

The reference has no large-N NTT of its own — its production X-axis path
host-loops phantom's fnwt_1d over 32,768 tiny polys (ntt_core.cu:443-460) and
its logical packed degree is PACK_N = 32768 (config.h:17).  The BASELINE
configs, however, demand N = 2^14..2^17 NTT throughput and a multi-host
coefficient-sharded variant.  Factor N = n1 * n2 and run

    stage 1: per-column cyclic DFT_n1 as [n1 x n1] chunked-int8 matmuls
    twiddle: elementwise Montgomery multiply by w_N^(i2*k1)
    stage 2: per-row  cyclic DFT_n2 as [n2 x n2] chunked-int8 matmuls

so ~all arithmetic is int8 matrix products.  Negacyclic (X^N + 1) is the
psi_2N pre/post twist.  Forward output is in "four-step order" (k1-major
digit transpose); the inverse consumes the same order, and pointwise
(convolution) use is order-independent — callers needing natural order use
`natural_order=True`.

The distributed variant (parallel/dist_ntt.py) shards n1 across devices and
exchanges with all_to_all between the stages.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .modmath import MontConsts, mont_mul
from .modmatmul import (CHUNK_BITS, chunk_decompose, chunked_dot_combine,
                        limb_runs, num_chunks, pow2r_table)


def _is_prime(x: int) -> bool:
    from ..config import _is_prime as ip
    return ip(x)


def generate_primes_1mod(count: int, bits: int, modulus: int) -> Tuple[int, ...]:
    """`count` distinct primes == 1 (mod modulus) of bit length exactly
    `bits` (searched DOWNWARD from 2^bits, Lattigo-style, matching the
    reference's convention: its "35-bit" moduli are < 2^35, config.h:27-31).

    The width drives the per-modmul digit grid (ceil(bits/7) int8 digits a
    side), so a "35-bit" request must not return 36-bit primes — the old
    upward search did exactly that and silently paid a 6x6 grid where the
    5x5 one suffices."""
    primes = []
    q = ((1 << bits) // modulus) * modulus + 1
    while q >= (1 << bits):
        q -= modulus
    floor = 1 << (bits - 1)
    while len(primes) < count and q > floor:
        if _is_prime(q):
            primes.append(q)
        q -= modulus
    if len(primes) < count:
        raise ValueError(
            f"not enough {bits}-bit primes == 1 mod {modulus}")
    return tuple(primes)


@dataclasses.dataclass(frozen=True)
class FourStepPlan:
    n: int
    n1: int
    n2: int
    moduli: Tuple[int, ...]
    negacyclic: bool = True

    @staticmethod
    def make(n: int, moduli: Sequence[int], negacyclic: bool = True,
             n1: int | None = None) -> "FourStepPlan":
        if n & (n - 1):
            raise ValueError("N must be a power of two")
        if n1 is None:
            half = n.bit_length() - 1
            n1 = 1 << (half // 2)
        return FourStepPlan(n=n, n1=n1, n2=n // n1,
                            moduli=tuple(int(q) for q in moduli),
                            negacyclic=negacyclic)


class FourStepNTT:
    """Batched forward/inverse NTT over [L, B, N] uint64 arrays."""

    def __init__(self, plan: FourStepPlan):
        self.plan = plan
        n, n1, n2 = plan.n, plan.n1, plan.n2
        L = len(plan.moduli)
        order = 2 * n if plan.negacyclic else n
        t1f = np.empty((L, n1, n1), dtype=np.uint64)
        t1i = np.empty((L, n1, n1), dtype=np.uint64)
        t2f = np.empty((L, n2, n2), dtype=np.uint64)
        t2i = np.empty((L, n2, n2), dtype=np.uint64)
        twf = np.empty((L, n2, n1), dtype=np.uint64)  # [i2, k1]
        twi = np.empty((L, n1, n2), dtype=np.uint64)  # [k1, i2]
        twist_f = np.empty((L, n), dtype=np.uint64)
        twist_i = np.empty((L, n), dtype=np.uint64)
        self._mont = [MontConsts.make(q) for q in plan.moduli]
        # exponent grids: every table entry is a power of one root, so the
        # tables are gathers from per-limb power lists (exact, host-side)
        e1 = np.outer(np.arange(n1), np.arange(n1))
        e2 = np.outer(np.arange(n2), np.arange(n2))
        etw = np.outer(np.arange(n2), np.arange(n1))       # i2 * k1 < n
        for l, q in enumerate(plan.moduli):
            if (q - 1) % order:
                raise ValueError(f"modulus {q} lacks order-{order} root")
            g = _find_generator(q)
            w_n = pow(g, (q - 1) // n, q)       # order-n root
            w1 = pow(w_n, n2, q)                 # order n1
            w2 = pow(w_n, n1, q)                 # order n2
            n_inv = pow(n, q - 2, q)
            r = self._mont[l].r_mod
            p1 = _powers(w1, n1, q)
            p2 = _powers(w2, n2, q)
            t1f[l] = p1[e1 % n1]
            # fold n^-1 into the inverse stage-1 table (applied last)
            t1i[l] = np.array([v * n_inv % q for v in p1.tolist()],
                              dtype=np.uint64)[(-e1) % n1]
            t2f[l] = p2[e2 % n2]
            t2i[l] = p2[(-e2) % n2]
            # Montgomery-form twiddles w_n^(i2*k1) and w_n^-(i2*k1)
            pn_r = np.array([v * r % q for v in _powers(w_n, n, q).tolist()],
                            dtype=np.uint64)
            twf[l] = pn_r[etw]
            twi[l] = pn_r[(-etw.T) % n]
            if plan.negacyclic:
                psi = pow(g, (q - 1) // (2 * n), q)
                # psi^n = g^((q-1)/2) = -1 for any generator g
                assert pow(psi, n, q) == q - 1
                psi_inv = pow(psi, q - 2, q)
                twist_f[l] = [v * r % q for v in _powers(psi, n, q).tolist()]
                twist_i[l] = [v * r % q
                              for v in _powers(psi_inv, n, q).tolist()]
        self._t1f, self._t1i = t1f, t1i
        self._t2f, self._t2i = t2f, t2i
        self._twf = jnp.asarray(twf.reshape(L, 1, n2, n1))
        self._twi = jnp.asarray(twi.reshape(L, 1, n1, n2))
        if plan.negacyclic:
            self._twist_f = jnp.asarray(twist_f.reshape(L, 1, n))
            self._twist_i = jnp.asarray(twist_i.reshape(L, 1, n))
        self._q3 = jnp.asarray(np.array(plan.moduli, np.uint64).reshape(L, 1, 1))
        self._qi3 = jnp.asarray(np.array(
            [m.qinv_neg for m in self._mont], np.uint64).reshape(L, 1, 1))
        self._q4 = self._q3[..., None]
        self._qi4 = self._qi3[..., None]
        # pre-chunked stage tables per limb run
        self._runs = []
        for lo, hi, c in limb_runs(plan.moduli):
            run_mod = plan.moduli[lo:hi]
            self._runs.append({
                "lo": lo, "hi": hi, "chunks": c,
                "t1f": chunk_decompose(jnp.asarray(t1f[lo:hi]), c),
                "t1i": chunk_decompose(jnp.asarray(t1i[lo:hi]), c),
                "t2f": chunk_decompose(jnp.asarray(t2f[lo:hi]), c),
                "t2i": chunk_decompose(jnp.asarray(t2i[lo:hi]), c),
                "consts": _consts4(run_mod, c),
            })

    # -- internals -------------------------------------------------------------

    def _stage(self, x: jnp.ndarray, which: str, contract_axis: int
               ) -> jnp.ndarray:
        """Contract `contract_axis` (2 or 3) of [L,B,d2,d3] with the stage
        table; output axes: [L, B, (other), k]."""
        outs = []
        batch = ((0,), (0,))
        for run in self._runs:
            d = x[run["lo"]:run["hi"]]
            c = run["chunks"]
            dch = chunk_decompose(d, c)
            tch = run[which]

            def dot_fn(t, dd):
                return jax.lax.dot_general(
                    dd, t, (((contract_axis,), (2,)), batch),
                    preferred_element_type=jnp.int32)

            klen = tch.shape[-1]
            widen = klen * (127 ** 2) * c >= (1 << 31)
            outs.append(chunked_dot_combine(tch, dch,
                                            lambda t, dd: dot_fn(t, dd),
                                            run["consts"], widen))
        return jnp.concatenate(outs) if len(outs) > 1 else outs[0]

    # -- public ------------------------------------------------------------------

    def forward(self, x: jnp.ndarray) -> jnp.ndarray:
        """[L, B, N] uint64 -> four-step-order spectrum [L, B, N]."""
        p = self.plan
        L, B = x.shape[0], x.shape[1]
        if p.negacyclic:
            x = mont_mul(x, self._twist_f, self._q3, self._qi3)
        x = x.reshape(L, B, p.n1, p.n2)
        y = self._stage(x, "t1f", 2)              # [L, B, i2, k1]
        y = mont_mul(y, self._twf, self._q4, self._qi4)
        z = self._stage(y, "t2f", 2)              # [L, B, k1, k2]
        return z.reshape(L, B, p.n)

    def inverse(self, xf: jnp.ndarray) -> jnp.ndarray:
        """Four-step-order spectrum -> [L, B, N] natural-order coefficients."""
        p = self.plan
        L, B = xf.shape[0], xf.shape[1]
        z = xf.reshape(L, B, p.n1, p.n2)
        y = self._stage(z, "t2i", 3)              # [L, B, k1, i2]
        y = mont_mul(y, self._twi, self._q4, self._qi4)
        w = self._stage(y, "t1i", 2)              # [L, B, i2, i1]
        x = jnp.swapaxes(w, 2, 3).reshape(L, B, p.n)
        if p.negacyclic:
            x = mont_mul(x, self._twist_i, self._q3, self._qi3)
        return x

    def pointwise_mul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Spectral pointwise product (order-independent); b plain domain."""
        r2 = jnp.asarray(np.array([m.r2 for m in self._mont],
                                  np.uint64).reshape(-1, 1, 1))
        bm = mont_mul(b, r2, self._q3, self._qi3)
        return mont_mul(a, bm, self._q3, self._qi3)


def _powers(base: int, count: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(count-1)] mod q as uint64."""
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * base % q
    return np.array(out, dtype=np.uint64)


def _find_generator(q: int) -> int:
    """Smallest primitive root mod prime q (exact factorization of q-1)."""
    phi = q - 1
    fac = _factorize(phi)
    for g in range(2, 1 << 20):
        if all(pow(g, phi // f, q) != 1 for f in fac):
            return g
    raise ValueError("no generator found")


@functools.lru_cache(maxsize=None)
def _factorize(x: int) -> Tuple[int, ...]:
    fs = []
    d = 2
    while d * d <= x:
        if x % d == 0:
            fs.append(d)
            while x % d == 0:
                x //= d
        d += 1
    if x > 1:
        fs.append(x)
    return tuple(fs)


def _consts4(moduli, chunks):
    L = len(moduli)
    suffix = (1, 1, 1)
    return {
        "q": jnp.asarray(np.array(moduli, np.uint64).reshape(L, *suffix)),
        "qinv_neg": jnp.asarray(np.array(
            [MontConsts.make(int(q)).qinv_neg for q in moduli],
            np.uint64).reshape(L, *suffix)),
        "pow2r": pow2r_table(moduli, 2 * chunks - 1, shape_suffix=suffix),
    }
