"""RNS basis extension (fast base conversion) for key switching.

The reference reserves three P-primes "for key switching" (config.h:43-52)
but never builds the machinery; this module provides the core:
given x's residues over a source basis Q_s = prod(q_l), produce residues of
a bounded representative over any target basis:

    r'_l = x_l * (Q_s/q_l)^{-1} mod q_l          (per-limb Montgomery mul)
    k    = round(sum_l r'_l / q_l)                (f64 quotient estimate)
    x~   = sum_l r'_l * (Q_s/q_l)  -  k * Q_s     (the centered representative,
                                                   |x~| <= Q_s; k may be off
                                                   by 1 only when x~ is within
                                                   f64 noise of +-Q_s/2, which
                                                   just flips to the other
                                                   equivalent representative)
    out_r = x~ mod r  for each target prime r     (limb-loop of mont muls)

This is the float-assisted exact FBC (no alpha*Q_s approximation error of
the textbook method) — the same k-quotient trick as the decode compose
(ops/ddfloat.py), batched over arbitrary trailing element axes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import modmath as mm

F64 = jnp.float64


class BasisExtender:
    """x mod Q_src (limb-major [Ls, ...]) -> bounded-representative residues
    over dst_moduli ([Ld, ...])."""

    def __init__(self, src_moduli: Sequence[int], dst_moduli: Sequence[int]):
        self.src = tuple(int(q) for q in src_moduli)
        self.dst = tuple(int(r) for r in dst_moduli)
        q_src = 1
        for q in self.src:
            q_src *= q
        self.q_src = q_src
        ls, ld = len(self.src), len(self.dst)
        # (Q/q_l)^{-1} mod q_l, in Montgomery form for one mont_mul
        inv = np.zeros(ls, dtype=np.uint64)
        for l, q in enumerate(self.src):
            m = q_src // q
            inv[l] = pow(m % q, -1, q) * ((1 << 64) % q) % q
        self._inv_mont = jnp.asarray(inv)
        qs = np.array(self.src, dtype=np.uint64)
        self._q_src_arr = qs
        self._qinv_neg = np.array(
            [mm.MontConsts.make(q).qinv_neg for q in self.src],
            dtype=np.uint64)
        self._inv_q_f64 = np.array([1.0 / q for q in self.src])
        # per (src l, dst r): (Q/q_l) mod r, Montgomery form of r
        mlr = np.zeros((ls, ld), dtype=np.uint64)
        qsr = np.zeros(ld, dtype=np.uint64)
        for r_i, r in enumerate(self.dst):
            for l, q in enumerate(self.src):
                mlr[l, r_i] = (q_src // q) % r * ((1 << 64) % r) % r
            qsr[r_i] = (q_src % r) * ((1 << 64) % r) % r
        self._m_mod_r_mont = mlr
        self._qsrc_mod_r_mont = qsr
        self._rd = np.array(self.dst, dtype=np.uint64)
        self._rd_qinv = np.array(
            [mm.MontConsts.make(r).qinv_neg for r in self.dst],
            dtype=np.uint64)

    def scaled_residues(self, x: jnp.ndarray
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(r'_l planes [Ls, ...], k [ ...] u32)."""
        suf = (1,) * (x.ndim - 1)
        q = jnp.asarray(self._q_src_arr.reshape((-1,) + suf))
        qi = jnp.asarray(self._qinv_neg.reshape((-1,) + suf))
        inv = jnp.asarray(self._inv_mont.reshape((-1,) + suf))
        rp = mm.mont_mul(x, inv, q, qi)
        invq = jnp.asarray(self._inv_q_f64.reshape((-1,) + suf))
        k = jnp.round(jnp.sum(rp.astype(F64) * invq, axis=0))
        return rp, k.astype(jnp.uint32)

    def extend(self, x: jnp.ndarray,
               dst_slice: Tuple[int, int] | None = None) -> jnp.ndarray:
        """[Ls, ...] -> [Ld, ...]: residues of the bounded representative.

        The source-limb accumulation is vectorized over Ls (one mont_mul +
        one exact u64 sum + one reduction instead of an Ls-long chain of
        mont_mul/add_mod ops): Ls * r < 2^63 for every basis here, so the
        plain sum cannot wrap.  ~Ls x fewer HLO ops per target limb — the
        keyswitch pipeline builds dnum * Ld of these (compile time).

        dst_slice=(lo, hi) emits only target limbs lo:hi — the limb-chunked
        key-switch streaming path (he_matmul2) extends one chunk at a time
        to bound peak HBM; compose with extend_from to share the src-side
        scaled residues across chunks."""
        rp, k = self.scaled_residues(x)
        return self.extend_from(rp, k, dst_slice)

    def extend_from(self, rp: jnp.ndarray, k: jnp.ndarray,
                    dst_slice: Tuple[int, int] | None = None) -> jnp.ndarray:
        """Second half of extend(): (rp, k) from scaled_residues ->
        dst-limb residues.  Splitting lets limb-chunked callers compute the
        src-side work once and stream the dst chunks."""
        lo, hi = (0, len(self.dst)) if dst_slice is None else dst_slice
        suf = (1,) * (rp.ndim - 1)
        ku = k.astype(jnp.uint64)
        # broadcast over BOTH limb axes: [Ls, Ld, ...] elementwise + one
        # reduction; XLA fuses the chain so the [Ls, Ld, ...] intermediate
        # never materializes, and the HLO is Ld x smaller than the unrolled
        # per-target loop this replaces.
        rd0 = jnp.asarray(self._rd[lo:hi].reshape((-1,) + suf))   # [Ld, ...]
        qi0 = jnp.asarray(self._rd_qinv[lo:hi].reshape((-1,) + suf))
        # r'_l may exceed r: reduce first (r'_l < q_l < 2^48)
        t = rp[:, None] % rd0[None]                               # [Ls, Ld, ...]
        m = jnp.asarray(self._m_mod_r_mont[:, lo:hi].reshape(
            (self._m_mod_r_mont.shape[0], hi - lo) + suf))
        terms = mm.mont_mul(t, m, rd0[None], qi0[None])
        acc = jnp.sum(terms, axis=0) % rd0   # Ls terms < max(dst r) <= 2^55
        kq = mm.mont_mul(ku[None] % rd0, jnp.asarray(
            self._qsrc_mod_r_mont[lo:hi].reshape((-1,) + suf)), rd0, qi0)
        return mm.sub_mod(acc, kq, rd0)
