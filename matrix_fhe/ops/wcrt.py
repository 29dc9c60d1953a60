"""W-axis transforms: mod-q W-CRT (Phi_p evaluation) and complex W-DFT.

The reference evaluates/interpolates the W axis with one output element per
thread and an O(phi) inner loop (wntt_forward_matrix_kernel HE.cu:716-747,
wntt_inverse_matrix_kernel HE.cu:751-781, wdft_* HE.cu:1116-1202).  Here both
directions are plain [phi x phi] @ [phi x M] matrix products:

  * mod-q path: exact chunked int8 matmuls (ops/modmatmul.py) against the
    per-limb Vandermonde tables V[l] / V[l]^-1;
  * complex path: float64 matmuls, which reproduce the reference's double
    math.

Canonical data layout here is limb-major [L, W, n, n] (the reference is
W-major, HE.cuh:17-33); limb-major puts the modulus batch axis first for
batched integer dots and for zero-communication limb sharding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import GLParams
from ..tables import GLTables, build_tables
from . import modmath as mm
from .crt import CRTComposer, centered_i64_to_rns
from .modmatmul import BatchedModTransform


class WTransform:
    """Forward/inverse W-CRT over all RNS limbs + complex W-DFT.

    The mod-q matmuls are the XLA-composed chunked-int8 products of
    ops/modmatmul.py (bit-exact)."""

    def __init__(self, params: GLParams, tables: GLTables | None = None):
        from .ddfloat import dd_transforms_default

        self._dd_transforms = dd_transforms_default()
        self.params = params
        t = tables or build_tables(params)
        self.tables = t
        self._fwd = BatchedModTransform(t.w_fwd, params.moduli, side="left")
        self._inv = BatchedModTransform(t.w_inv, params.moduli, side="left")
        # limb-0-only inverse for the centered test path (HE.cu:1101)
        self._inv0 = BatchedModTransform(t.w_inv[:1], params.moduli[:1],
                                         side="left")
        self._composer = CRTComposer(t)
        # complex tables as separate f64 re/im parts
        self._dft_re = jnp.asarray(t.wdft.real)
        self._dft_im = jnp.asarray(t.wdft.imag)
        self._idft_re = jnp.asarray(t.wdft_inv.real)
        self._idft_im = jnp.asarray(t.wdft_inv.imag)

    def forward_pair(self, lo32, hi32):
        """forward() on u32 lo/hi planes [L, W, ...]."""
        return mm.pair_split(self.forward(mm.pair_join(lo32, hi32)))

    # -- mod-q path ----------------------------------------------------------

    def forward(self, x: jnp.ndarray) -> jnp.ndarray:
        """[L, W, ...] uint64 coeff -> eval (out[w] = sum_r V[w,r] x[r])."""
        L, W = x.shape[0], x.shape[1]
        return self._fwd(x.reshape(L, W, -1)).reshape(x.shape)

    def inverse(self, x: jnp.ndarray) -> jnp.ndarray:
        """[L, W, ...] uint64 eval -> coeff (out[r] = sum_w V^-1[r,w] x[w])."""
        L, W = x.shape[0], x.shape[1]
        return self._inv(x.reshape(L, W, -1)).reshape(x.shape)

    @functools.cached_property
    def _inv_scaled(self):
        """Inverse transform with the CRT constant M_l^{-1} mod q_l folded
        into the tables, so the fast float-exact decode compose
        (ops/ddfloat.compose_scaled_to_float) needs no per-element modmul.
        NOTE: must be materialized OUTSIDE any jit trace (jnp constants are
        created here); BatchedEncoder touches it eagerly on the fast path."""
        t = self.tables
        p = self.params
        scaled = np.empty_like(t.w_inv)
        for l, q in enumerate(p.moduli):
            q = int(q)
            scaled[l] = (t.w_inv[l].astype(object) * int(t.crt_inv[l]) % q
                         ).astype(np.uint64)
        return BatchedModTransform(scaled, p.moduli, side="left")

    def inverse_scaled_compose_pair(self, lo32, hi32, delta):
        """inverse_scaled + centered CRT compose / delta: u32-pair eval
        residues [L, W, ...] -> f64 [W, ...]."""
        from .ddfloat import compose_scaled_to_float

        p = self.params
        big_q = 1
        for q in p.moduli:
            big_q *= int(q)
        s = self.inverse_scaled(mm.pair_join(lo32, hi32))
        L, W = lo32.shape[0], lo32.shape[1]
        return compose_scaled_to_float(
            s.reshape(L, W, -1), p.moduli, big_q, delta
        ).reshape(lo32.shape[1:])

    def inverse_scaled(self, x: jnp.ndarray) -> jnp.ndarray:
        """inverse() with outputs pre-multiplied by M_l^{-1} mod q_l."""
        L, W = x.shape[0], x.shape[1]
        return self._inv_scaled(x.reshape(L, W, -1)).reshape(x.shape)

    # -- centered-integer path (test oracles; HE.cu:1029-1114) ----------------

    def forward_centered(self, x_centered: jnp.ndarray) -> jnp.ndarray:
        """int64 [W, ...] coeff -> centered int64 eval via all limbs + exact
        CRT compose (wntt_forward_centered_kernel, HE.cu:1029-1081), including
        its int64 saturation semantics (he_big_to_i64_checked, HE.cu:904-915).

        Fidelity note: per-limb eta roots are searched independently
        (HE.cu:119-133), so the CRT-composed evaluation is a ~Q-sized integer
        whenever num_limbs > 1; the reference kernel then *saturates* to
        INT64_MAX/MIN, which breaks the limb-0 congruence that
        wntt_inverse_centered (HE.cu:1083-1114, limb 0 only) relies on.  The
        centered roundtrip oracle is therefore only exactly invertible when
        Q < 2^63 (e.g. the single-limb "tiny1" preset); this port reproduces
        the reference behavior bit-for-bit either way."""
        rns = centered_i64_to_rns(x_centered, self.params.moduli)
        ev = self.forward(rns)
        return self._composer.compose_centered_i64(ev)

    def inverse_centered(self, x_centered: jnp.ndarray) -> jnp.ndarray:
        """int64 [W, ...] eval -> centered int64 coeff using limb 0 only
        (wntt_inverse_centered_kernel, HE.cu:1083-1114)."""
        q0 = int(self.params.moduli[0])
        qq = jnp.int64(q0)
        m = x_centered % qq
        m = jnp.where(m < 0, m + qq, m).astype(jnp.uint64)
        ev = self._inv0(m[None].reshape(1, x_centered.shape[0], -1))
        ev = ev.reshape(x_centered.shape)
        half = jnp.uint64(q0 >> 1)
        centered = jnp.where(ev > half,
                             ev.astype(jnp.int64) - qq, ev.astype(jnp.int64))
        return centered

    # -- complex path ----------------------------------------------------------

    def _cmatmul(self, mr, mi, xr, xi) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Complex [W,W] @ [W,M] as four real f64 matmuls (split-f32
        products when dd transforms are opted in; see ops/ddfloat.py)."""
        if self._dd_transforms:
            from .ddfloat import dd_cmatmul
            return dd_cmatmul(mr, mi, xr, xi)
        yr = mr @ xr - mi @ xi
        yi = mr @ xi + mi @ xr
        return yr, yi

    def dft_forward_pair(self, re, im) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """f64/int pair [W, ...] coeff -> eval (wdft_forward_pair_kernel)."""
        shape = re.shape
        xr = re.reshape(shape[0], -1).astype(jnp.float64)
        xi = im.reshape(shape[0], -1).astype(jnp.float64)
        yr, yi = self._cmatmul(self._dft_re, self._dft_im, xr, xi)
        return yr.reshape(shape), yi.reshape(shape)

    def dft_inverse_pair(self, re, im) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """f64 pair [W, ...] eval -> coeff (wdft_inverse_pair_kernel /
        w_idft_kernel, batched_encoder.cu:104-123)."""
        shape = re.shape
        xr = re.reshape(shape[0], -1).astype(jnp.float64)
        xi = im.reshape(shape[0], -1).astype(jnp.float64)
        yr, yi = self._cmatmul(self._idft_re, self._idft_im, xr, xi)
        return yr.reshape(shape), yi.reshape(shape)

    @property
    def composer(self) -> CRTComposer:
        return self._composer
