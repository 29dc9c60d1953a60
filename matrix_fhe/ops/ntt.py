"""X-axis NTT (degree-n polynomial axis) as exact modular matmuls.

The reference drives this axis two ways (selected by kDbgUsePhantomXY,
HE.cu:25,1224-1242):
  * production: phantom-fhe's fnwt_1d/inwt_1d negacyclic (X^n+1) NTT, host-
    looped over 32,768 polys (ntt_core.cu:443-460) — the known launch-bound
    hot spot;
  * GL path: beta = psi_4n twist (beta^n = +-i) + 6 stage-per-launch cyclic
    butterflies (ntt_core.cu:394-481), realizing the X^n = i ring.

Here a full-ciphertext X transform is ONE batched [*, n] @ [n, n]^T chunked
int8 matmul per limb group — no host loops, no launch storm.  Because the
stored ciphertext never contains NTT-internal ordering (encrypt does
fwd -> pointwise -> inv before storing, HE.cu:1505-1530), exact integer
convolution semantics — which these matmuls provide — is all that bit-exact
parity requires.

Also provides the GL 5^j-orbit permutation (apply_gl_perm,
ntt_core.cu:150-173,258-269) and negacyclic_polymul convenience.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import GLParams
from ..tables import GLTables, build_tables
from . import modmath as mm
from .modmatmul import BatchedModTransform

RING_NEGACYCLIC = "nega"  # X^n + 1 (production / phantom parity ring)
RING_GL = "gl"            # X^n = psi4n^n (= +-i) GL twist ring
RING_GL2 = "gl2"          # the GL ring's integral double form X^{2n} + 1
#   (Z[i][X]/(X^n - i) ~= Z[X]/(X^{2n}+1) via i = X^n; tables.py
#   build_gl2_x_tables) — same algebra as "gl" but with one global integer
#   coefficient ring, so key switching / FBC apply (keyswitch.py:70-77).


class XNTT:
    """Forward/inverse length-n transform along the trailing axis of
    [L, ..., n] uint64 arrays, batched over everything else."""

    def __init__(self, params: GLParams, ring: str = RING_NEGACYCLIC,
                 tables: GLTables | None = None):
        t = tables or build_tables(params)
        self.params = params
        self.ring = ring
        if ring == RING_NEGACYCLIC:
            fwd, inv = t.x_fwd_nega, t.x_inv_nega
        elif ring == RING_GL:
            fwd, inv = t.x_fwd_gl, t.x_inv_gl
        elif ring == RING_GL2:
            from ..tables import build_gl2_x_tables
            fwd, inv = build_gl2_x_tables(t)
        else:
            raise ValueError(f"unknown ring {ring!r}")
        self._fwd = BatchedModTransform(fwd, params.moduli, side="right")
        self._inv = BatchedModTransform(inv, params.moduli, side="right")

    def _apply(self, trans, x: jnp.ndarray) -> jnp.ndarray:
        L = x.shape[0]
        n = x.shape[-1]
        return trans(x.reshape(L, -1, n)).reshape(x.shape)

    def forward(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._apply(self._fwd, x)

    def inverse(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._apply(self._inv, x)

    def mul_s(self, a: jnp.ndarray, s_mont: jnp.ndarray) -> jnp.ndarray:
        """t = iNTT_X(NTT_X(a) * s), the encrypt/decrypt hot path
        (pointwise_mul_s_kernel + xy NTT round trip, HE.cu:509-531,
        1509-1526).  a: [L, W, ..., n] u64 X-coeff; s_mont: [L, W, n] u64,
        X-NTT domain, Montgomery form, broadcast over the middle axes."""
        n = a.shape[-1]
        L = a.shape[0]
        q = jnp.asarray(np.asarray(self.params.moduli, np.uint64)
                        ).reshape((L,) + (1,) * (a.ndim - 1))
        qinv = jnp.asarray(np.array(
            [mm.MontConsts.make(int(m)).qinv_neg
             for m in self.params.moduli], np.uint64)
            ).reshape((L,) + (1,) * (a.ndim - 1))
        s_b = s_mont.reshape(s_mont.shape[:2] + (1,) * (a.ndim - 3) + (n,))
        t_ntt = mm.mont_mul(self.forward(a), s_b, q, qinv)
        return self.inverse(t_ntt)

    def mul_s_pair(self, al, ah, sl, sh):
        """mul_s on u32 lo/hi planes: a [L, W, n, n], s [L, W, n]."""
        t = self.mul_s(mm.pair_join(al, ah), mm.pair_join(sl, sh))
        return mm.pair_split(t)

    def wrap_constant(self, limb: int) -> int:
        """The X^n wraparound constant of this ring mod q_limb: q-1 for
        negacyclic, psi4n^n for GL (test_custom_ntt_roundtrip.cu:260-261)."""
        q = int(self.params.moduli[limb])
        if self.ring in (RING_NEGACYCLIC, RING_GL2):
            return q - 1  # gl2: X^{2n} = -1 (double-degree negacyclic)
        t = build_tables(self.params)
        return pow(t.psi4n[limb], self.params.n, q)


def apply_gl_perm(x: jnp.ndarray, perm) -> jnp.ndarray:
    """Permute the trailing axis: out[..., perm[j]] = x[..., j].

    Mirrors gl_perm_kernel (ntt_core.cu:258-269); pass tables.gl_perm for the
    forward 5^j-orbit -> bit-reversed mapping and tables.gl_inv_perm to undo
    it (apply_gl_perm wrapper, ntt_core.cu:433-441).
    """
    p = np.asarray(perm)
    gather = np.empty_like(p)
    gather[p] = np.arange(p.size)  # out[..., i] = x[..., gather[i]]
    return jnp.take(x, jnp.asarray(gather), axis=-1)
