"""Single-lane sigma-embedding encoder (CKKS-style, power-of-5 Vandermonde).

Port of the reference Encoder (src/core/encoder.cu:329-501): a 64x64 complex
message matrix is mapped to XY-coefficient space by V^-1 @ M @ V^-T where
V[j][k] = zeta_4n^(5^j * k), then scaled by Delta and split into RNS.

All lanes are batched with einsum over the leading W axis instead of the
reference's per-lane host loop with per-call cudaMalloc
(batched_encoder.cu:192-196, HE.cu:1675-1679); float64 reproduces the
reference's double math.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import GLParams
from ..tables import GLTables, build_tables
from ..ops.crt import CRTComposer
from .rng import llround

F64 = jnp.float64


def _cm(ar, ai, br, bi) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Complex matmul over trailing two dims with leading batch: a @ b."""
    rr = jnp.einsum("...ij,...jk->...ik", ar, br) - \
        jnp.einsum("...ij,...jk->...ik", ai, bi)
    ri = jnp.einsum("...ij,...jk->...ik", ar, bi) + \
        jnp.einsum("...ij,...jk->...ik", ai, br)
    return rr, ri


class Encoder:
    """sigma-embedding over one (or a batch of) n x n complex matrices."""

    def __init__(self, params: GLParams, tables: GLTables | None = None,
                 fast_float: bool | None = None,
                 dd_transforms: bool | None = None):
        from ..ops.ddfloat import dd_transforms_default, fast_float_default

        self.params = params
        t = tables or build_tables(params)
        self.tables = t
        self._v_re = jnp.asarray(t.enc_v.real)
        self._v_im = jnp.asarray(t.enc_v.imag)
        self._vi_re = jnp.asarray(t.enc_v_inv.real)
        self._vi_im = jnp.asarray(t.enc_v_inv.imag)
        self._composer = CRTComposer(t)
        self.fast_float = (fast_float_default() if fast_float is None
                           else fast_float)
        self.dd_transforms = (dd_transforms_default() if dd_transforms is None
                              else dd_transforms)

    def _cm(self, ar, ai, br, bi):
        if self.dd_transforms:
            from ..ops.ddfloat import dd_cmatmul
            return dd_cmatmul(ar, ai, br, bi)
        return _cm(ar, ai, br, bi)

    # -- complex transforms (batch over leading dims) -------------------------

    def _sandwich(self, vr, vi, m_re, m_im):
        """V @ M @ V^T over a [W, n, n] batch, phrased as two WIDE 2-D
        matmuls ([n, n] @ [n, W*n]) instead of a batched small-K einsum;
        the summation order per output is identical, so results are
        bit-identical to the naive einsum."""
        if m_re.ndim == 2:          # single lane: keep the simple form
            tr, ti = self._cm(vr, vi, m_re, m_im)
            return self._cm(tr, ti, vr.T, vi.T)

        def cm2d(ar, ai, br, bi):
            return (ar @ br - ai @ bi, ar @ bi + ai @ br)

        W, n = m_re.shape[0], m_re.shape[-1]
        mr = jnp.swapaxes(m_re, 0, 1).reshape(n, -1)
        mi = jnp.swapaxes(m_im, 0, 1).reshape(n, -1)
        tr, ti = cm2d(vr, vi, mr, mi)                    # [n(i'), W*n(j)]
        sr = jnp.transpose(tr.reshape(n, W, n), (2, 1, 0)).reshape(n, -1)
        si = jnp.transpose(ti.reshape(n, W, n), (2, 1, 0)).reshape(n, -1)
        ur, ui = cm2d(vr, vi, sr, si)                    # [n(j'), W*n(i')]
        return (jnp.transpose(ur.reshape(n, W, n), (1, 2, 0)),
                jnp.transpose(ui.reshape(n, W, n), (1, 2, 0)))

    def idft2(self, m_re, m_im) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """V^-1 @ M @ (V^-1)^T  (encoder.cu:460-467)."""
        if self.dd_transforms:
            tr, ti = self._cm(self._vi_re, self._vi_im,
                              m_re.astype(F64), m_im.astype(F64))
            return self._cm(tr, ti, self._vi_re.T, self._vi_im.T)
        return self._sandwich(self._vi_re, self._vi_im,
                              m_re.astype(F64), m_im.astype(F64))

    def dft2(self, e_re, e_im) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """V @ E @ V^T  (decode_from_eval_complex, encoder.cu:492-501)."""
        if self.dd_transforms:
            tr, ti = self._cm(self._v_re, self._v_im,
                              e_re.astype(F64), e_im.astype(F64))
            return self._cm(tr, ti, self._v_re.T, self._v_im.T)
        return self._sandwich(self._v_re, self._v_im,
                              e_re.astype(F64), e_im.astype(F64))

    # -- quantize / RNS ---------------------------------------------------------

    def quantize(self, c_re, c_im) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """llround(x * Delta) split into RNS limbs: [..., n, n] f64 ->
        [L, ..., n, n] uint64 (quantize_soa_kernel, encoder.cu:36-50)."""
        delta = np.float64(self.params.delta)
        if self.fast_float:
            # pure-f64 exact path: no 64-bit integer modulo
            # (valid while |x*Delta| < 2^52; ref magnitudes are ~2^46)
            from ..ops import modmath as mm
            (rl, rh), (il, ih) = self.quantize_pair(c_re, c_im)
            return mm.pair_join(rl, rh), mm.pair_join(il, ih)
        ir = llround(c_re * delta)
        ii = llround(c_im * delta)
        outs_r, outs_i = [], []
        for q in self.params.moduli:
            qq = jnp.int64(int(q))
            mr = ir % qq
            mi = ii % qq
            outs_r.append(jnp.where(mr < 0, mr + qq, mr).astype(jnp.uint64))
            outs_i.append(jnp.where(mi < 0, mi + qq, mi).astype(jnp.uint64))
        return jnp.stack(outs_r), jnp.stack(outs_i)

    def quantize_pair(self, c_re, c_im):
        """quantize() returning u32 (lo, hi) plane pairs (fast path only)."""
        from ..ops.ddfloat import f64_mod_to_pair, llround_f64
        delta = np.float64(self.params.delta)
        vr = llround_f64(c_re * delta)
        vi = llround_f64(c_im * delta)
        prs = [f64_mod_to_pair(vr, int(q)) for q in self.params.moduli]
        pis = [f64_mod_to_pair(vi, int(q)) for q in self.params.moduli]
        return ((jnp.stack([p[0] for p in prs]),
                 jnp.stack([p[1] for p in prs])),
                (jnp.stack([p[0] for p in pis]),
                 jnp.stack([p[1] for p in pis])))

    def encode(self, m_re, m_im):
        """Full lane encode: complex matrix -> RNS pair in XY-eval basis
        (Encoder::encode, encoder.cu:446-458)."""
        cr, ci = self.idft2(m_re, m_im)
        return self.quantize(cr, ci)

    def dequantize_exact(self, rns_re, rns_im):
        """Exact big-int CRT -> f64 / Delta (dequantize_exact_kernel,
        encoder.cu:112-150); inputs [L, ..., n, n]."""
        return self.dequantize_exact_delta(rns_re, rns_im, self.params.delta)

    def dequantize_exact_delta(self, rns_re, rns_im, delta):
        """dequantize_exact with an explicit scale (e.g. Delta^2 for
        un-rescaled homomorphic products)."""
        return (self._composer.compose_to_float(rns_re, delta),
                self._composer.compose_to_float(rns_im, delta))

    def decode_lane_from_rns_eval(self, rns_re, rns_im):
        """encoder.cu:470-490: exact dequantize then V E V^T."""
        er, ei = self.dequantize_exact(rns_re, rns_im)
        return self.dft2(er, ei)
