"""Batched encoder: 512 complex matrices -> W-CRT-eval packed plaintext.

Port of BatchedEncoder::encode_to_wntt_eval (batched_encoder.cu:161-228) as a
single fused, jittable function — the reference's 512-iteration host loop of
per-lane idft2 (with per-call cudaMalloc) becomes one batched einsum:

  1) per-lane XY-IDFT (V^-1 M V^-T)               [W, n, n] complex
  2) complex W-IDFT along the W axis               (w_idft_kernel)
  3) scale by Delta, llround, split into RNS       (quantize_coeff_to_rns)
  4) mod-q W-CRT forward to evaluation layout      (wntt_forward_matrix)

Canonical output layout is limb-major [L, W, n, n] (the reference emits
W-major [W][L][n^2]; see ops/wcrt.py for the layout rationale).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import GLParams
from ..tables import GLTables, build_tables
from ..ops.wcrt import WTransform
from .encoder import Encoder


class BatchedEncoder:
    def __init__(self, params: GLParams, tables: GLTables | None = None,
                 wt: WTransform | None = None,
                 fast_float: bool | None = None):
        t = tables or build_tables(params)
        self.params = params
        self.encoder = Encoder(params, t, fast_float=fast_float)
        self.wt = wt or WTransform(params, t)
        if self.encoder.fast_float:
            self.wt._inv_scaled  # materialize eagerly (never inside a trace)

    def encode_to_wntt_eval(self, m_re: jnp.ndarray, m_im: jnp.ndarray
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """[W, n, n] f64 pair -> ([L, W, n, n] u64, [L, W, n, n] u64)."""
        xr, xi = self.encoder.idft2(m_re, m_im)              # XY-IDFT per lane
        cr, ci = self.wt.dft_inverse_pair(xr, xi)            # W-IDFT (complex)
        rr, ri = self.encoder.quantize(cr, ci)               # scale+round+RNS
        return self.wt.forward(rr), self.wt.forward(ri)      # mod-q W-NTT

    def decode_from_wntt_eval(self, ev_re: jnp.ndarray, ev_im: jnp.ndarray,
                              delta_override: float | None = None
                              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Inverse of encode_to_wntt_eval (the plaintext half of
        decode_eval_pair_to_complex, HE.cu:1619-1689): W-CRT inverse, exact
        CRT compose / Delta, complex W-DFT, per-lane XY decode.

        Fast path: the W-CRT inverse runs with M_l^{-1} folded into its
        tables and the centered compose/Delta happens via the float-exact
        mod-2^64 fold (ops/ddfloat.compose_scaled_to_float) instead of the
        7-limb big-int chain — bit-different in f64 ulps only."""
        delta = self.params.delta if delta_override is None else delta_override
        # the fast mod-2^64 compose (ops/ddfloat.py) recovers x from its
        # value mod 2^64 and so requires |x| < 2^63; Delta^2-scaled
        # homomorphic products (delta_override) exceed that at ref scale ->
        # route them through the exact big-int compose
        if self.encoder.fast_float and delta_override is None:
            from ..ops.ddfloat import compose_scaled_to_float
            p = self.params
            big_q = 1
            for q in p.moduli:
                big_q *= int(q)
            both = jnp.stack([ev_re, ev_im], axis=2)         # [L, W, 2, n, n]
            s2 = self.wt.inverse_scaled(both)
            f2 = compose_scaled_to_float(s2, p.moduli, big_q, delta)
            fr, fi = f2[:, 0], f2[:, 1]
        else:
            cr = self.wt.inverse(ev_re)
            ci = self.wt.inverse(ev_im)
            fr, fi = (self.encoder.dequantize_exact(cr, ci)
                      if delta_override is None else
                      self.encoder.dequantize_exact_delta(cr, ci, delta))
        er, ei = self.wt.dft_forward_pair(fr, fi)
        return self.encoder.dft2(er, ei)

    def unpack_eval(self, ev_re, ev_im):
        """Identity passthrough (unpack_eval_p17 degenerated to a copy,
        batched_encoder.cu:230-243)."""
        return ev_re, ev_im

    # -- u32-pair path (fast_float) -------------------------------------------

    def encode_pair(self, m_re, m_im):
        """encode_to_wntt_eval producing u32 (lo, hi) plane pairs."""
        xr, xi = self.encoder.idft2(m_re, m_im)
        cr, ci = self.wt.dft_inverse_pair(xr, xi)
        (rl, rh), (il, ih) = self.encoder.quantize_pair(cr, ci)
        return self.wt.forward_pair(rl, rh), self.wt.forward_pair(il, ih)

    def decode_pair(self, re_pair, im_pair):
        """decode_from_wntt_eval from u32 (lo, hi) plane pairs."""
        (rl, rh), (il, ih) = re_pair, im_pair
        # one stacked pass over both components
        bl = jnp.stack([rl, il], axis=2)                 # [L, W, 2, n, n]
        bh = jnp.stack([rh, ih], axis=2)
        f2 = self.wt.inverse_scaled_compose_pair(bl, bh, self.params.delta)
        er, ei = self.wt.dft_forward_pair(f2[:, 0], f2[:, 1])
        return self.encoder.dft2(er, ei)
