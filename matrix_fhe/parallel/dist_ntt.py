"""Coefficient-sharded four-step NTT over a device mesh.

The BASELINE multi-host config (N = 2^17, residue/coeff-partitioned NTT with
all-to-all stage exchange) has no reference implementation (SURVEY §5); this
is the design:

  * the [n1, n2] view of each polynomial is sharded on the i2 (column) axis;
  * stage 1 (contract i1) and the twiddle multiply are fully local;
  * ONE all_to_all redistributes from i2-sharded to k1-sharded between the
    stages (the classic distributed-FFT transpose) — this is the only
    communication;
  * stage 2 (contract i2) is local again; output is the four-step-order
    spectrum sharded on the leading k1 digit, i.e. contiguous slices.

RNS-limb sharding needs no code at all: limbs are independent end-to-end
(shard the leading L axis with NamedSharding; psum appears only in decode's
CRT compose).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.modmath import mont_mul
from ..ops.ntt_large import FourStepNTT, FourStepPlan


class DistFourStepNTT:
    """Forward/inverse negacyclic NTT of [L, B, N] arrays, N-axis sharded
    over `axis` of `mesh`."""

    def __init__(self, plan: FourStepPlan, mesh: Mesh, axis: str = "coeff"):
        self.plan = plan
        self.mesh = mesh
        self.axis = axis
        self.d = mesh.shape[axis]
        if plan.n2 % self.d or plan.n1 % self.d:
            raise ValueError("n1 and n2 must be divisible by the mesh axis")
        self.local = FourStepNTT(plan)  # reuse tables/chunks; stages re-dispatched
        self._build()

    def _build(self):
        plan, d, axis = self.plan, self.d, self.axis
        n1, n2, L = plan.n1, plan.n2, len(plan.moduli)
        loc = self.local
        mesh = self.mesh

        # twiddle/twist tables sharded on their i2 / flat-N axes
        twf = loc._twf.reshape(L, 1, n2, n1)     # [i2, k1] -> shard i2
        twi = loc._twi.reshape(L, 1, n1, n2)     # [k1, i2] -> shard k1? see inverse
        twist_f = loc._twist_f.reshape(L, 1, n1, n2) if plan.negacyclic else None
        twist_i = loc._twist_i.reshape(L, 1, n1, n2) if plan.negacyclic else None

        pspec_x = P(None, None, None, axis)          # [L, B, n1, n2-sharded]
        pspec_tw = P(None, None, axis, None)         # [L, 1, i2-sharded, n1]
        pspec_twi = P(None, None, axis, None)        # [L, 1, k1-sharded, n2]
        pspec_twist = P(None, None, None, axis)
        pspec_out = P(None, None, axis, None)        # [L, B, k1-sharded, n2]

        q3, qi3 = loc._q3, loc._qi3
        q4, qi4 = loc._q4, loc._qi4

        def fwd_local(x, twf_l, twist_l):
            # x: [L, B, n1, n2/d] local block
            if plan.negacyclic:
                x = mont_mul(x, twist_l, q4, qi4)
            y = self.local._stage(x, "t1f", 2)              # [L, B, m, n1]
            y = mont_mul(y, twf_l, q4, qi4)
            # redistribute: split k1 (axis 3) across devices, gather i2 (axis 2)
            y = jax.lax.all_to_all(y, axis, split_axis=3, concat_axis=2,
                                   tiled=True)
            z = self.local._stage(y, "t2f", 2)              # [L, B, n1/d, n2]
            return z

        def inv_local(z, twi_l, twist_l):
            # z: [L, B, n1/d, n2] local (k1-sharded four-step spectrum)
            y = self.local._stage(z, "t2i", 3)              # [L, B, n1/d, i2]
            y = mont_mul(y, twi_l, q4, qi4)
            # redistribute: split i2 (axis 3), gather k1 (axis 2)
            y = jax.lax.all_to_all(y, axis, split_axis=3, concat_axis=2,
                                   tiled=True)
            # now [L, B, n1, i2/d]; contract k1 (axis 2)
            w = self.local._stage(y, "t1i", 2)              # [L, B, m, n1] (i1 last)
            x = jnp.swapaxes(w, 2, 3)                # [L, B, n1, i2/d]
            if plan.negacyclic:
                x = mont_mul(x, twist_l, q4, qi4)
            return x

        in_specs_f = (pspec_x, pspec_tw, pspec_twist)
        self._fwd_sm = jax.jit(shard_map(
            fwd_local, mesh=mesh,
            in_specs=in_specs_f, out_specs=pspec_out))
        in_specs_i = (pspec_out, pspec_twi, pspec_twist)
        self._inv_sm = jax.jit(shard_map(
            inv_local, mesh=mesh,
            in_specs=in_specs_i, out_specs=pspec_x))
        self._twf_r = twf
        self._twi_r = twi
        self._twist_f_r = twist_f if plan.negacyclic else jnp.zeros((L, 1, n1, n2), jnp.uint64)
        self._twist_i_r = twist_i if plan.negacyclic else jnp.zeros((L, 1, n1, n2), jnp.uint64)

    def forward(self, x: jnp.ndarray) -> jnp.ndarray:
        """[L, B, N] -> four-step-order spectrum [L, B, N] (k1-sharded)."""
        p = self.plan
        L, B = x.shape[0], x.shape[1]
        x4 = x.reshape(L, B, p.n1, p.n2)
        z = self._fwd_sm(x4, self._twf_r, self._twist_f_r)
        return z.reshape(L, B, p.n)

    def inverse(self, xf: jnp.ndarray) -> jnp.ndarray:
        p = self.plan
        L, B = xf.shape[0], xf.shape[1]
        z4 = xf.reshape(L, B, p.n1, p.n2)
        x = self._inv_sm(z4, self._twi_r, self._twist_i_r)
        return x.reshape(L, B, p.n)
