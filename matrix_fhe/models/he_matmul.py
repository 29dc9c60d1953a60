"""Ciphertext-level homomorphic matrix multiplication via the field trace.

The reference exports the trace-GEMM kernels (trace.cuh:11-25,
batched_trace.cuh:18-49, Theorems 3.8/3.9 per batched_trace.cuh:8-9) but no
driver ever composes them with encryption.  This module wires the full
capability end to end:

    encrypt(X), encrypt(Y) -> trace_matmul_tensor -> decrypt_trace_matmul
        -> decode  ==  Y^H @ X  per packed lane (max err ~ quantization)

Design notes (all verified by exact mod-q identity tests in
tests/test_he_matmul.py):

 * The scheme packs slot w's matrix as the W-CRT evaluation at eta^exp[w];
   the re/im split happens in W-coefficient space, so a per-lane "formal
   conjugation" of the (re, im) RNS pair actually conjugates the *flipped*
   lane (eta^-exp[w]).  The Galois conjugation therefore needs the lane
   permutation flip(w): exp[flip(w)] = -exp[w] mod p IN ADDITION to the
   per-lane component map - without it the per-lane GEMM computes
   A_w (X) B_{flip(w)} (lane-crossed garbage).  The reference's batched
   kernels (blockIdx.z = lane) lack this; it only shows up when the op is
   actually run, which the reference never does.

 * The X-axis half of the B' map (conj + X^-1 + (-i) twist on X-coefficient
   rows, map_Bprime_Xinv_twist_kernel trace.cu:30-73) is NOT multiplicative
   over the component GL ring Z_q[X]/(X^n - i_q) (the substitution X->X^-1
   lands in the ring with wrap i_q^-1).  It therefore cannot be pushed
   through `a * s`.  But the map acts on the operand axis that SURVIVES the
   trace contraction, so it commutes through the GEMM to a cheap post-map
   PM on output columns (negate index, x(-i) pair twist).  What remains on
   the B operand is conj(flip(.)) - both genuinely multiplicative - and
   every key product in the decrypt identity reduces to a *real* product
   with s or flip(s):

     C = PM(E0 + E1R (*) flip(s)) + PM(E1L + E2 (*) flip(s)) (*) s

   with E0 = G(bA, cFL(bB)), E1R = G(bA, cFL(aB)), E1L = G(aA, cFL(bB)),
   E2 = G(aA, cFL(aB)), G the n-scaled complex modular GEMM
   (trace_gemm), cFL = conj(flip(.)), (*) the GL ring product along the
   named output axis.  (E0..E2) is the matmul analog of the raw tensor
   (d0, d1, d2) - the reference has no relinearization/key-switch apparatus
   either (SURVEY 2.11), so the tensor decrypts with the secret key's
   two-sided action exactly like d0 + d1 s + d2 s^2 does.

 * Rescale: multiplying by Delta^-1 mod q (rescale_by_delta, trace.cu:132-161)
   is only exact when Delta | v; on a generic product it adds k*Q/Delta
   garbage.  The Delta^2 scale is instead divided out at decode
   (decode_from_wntt_eval(delta_override=Delta^2)) - the mathematically
   sound form of the reference's (never-exercised) rescale step.

Requires ring="gl" contexts: the trace theorems hold in the X^n = i ring
(the "nega" production ring's X-products have different wrap semantics).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GLParams
from ..ops import modmath as mm
from . import trace as tr
from .he import Ciphertext, HEContext, SecretKey


class MatmulTensor(NamedTuple):
    """Raw homomorphic-GEMM tensor (transposed per-lane frame: axis -2 = the
    left operand's X axis, axis -1 = the right operand's X axis)."""
    e0_re: jnp.ndarray
    e0_im: jnp.ndarray
    e1l_re: jnp.ndarray
    e1l_im: jnp.ndarray
    e1r_re: jnp.ndarray
    e1r_im: jnp.ndarray
    e2_re: jnp.ndarray
    e2_im: jnp.ndarray


def conj_flip_perm(params: GLParams) -> np.ndarray:
    """Lane permutation of the W-axis Galois conjugation:
    exp[flip(w)] == -exp[w] (mod p)."""
    exps = np.asarray(params.w_exponents)
    flip = np.empty(len(exps), dtype=np.int64)
    for w, e in enumerate(exps):
        (idx,) = np.nonzero(exps == (-int(e)) % params.p)
        flip[w] = idx[0]
    return flip


def _t(x):
    return jnp.swapaxes(x, -1, -2)


class HEMatmul:
    """Homomorphic C = Y^H @ X on packed 64x64 lanes (ring="gl" contexts)."""

    def __init__(self, ctx: HEContext):
        if ctx.ring != "gl":
            raise ValueError("trace matmul requires a ring='gl' HEContext "
                             "(X^n = i; Theorems 3.8/3.9)")
        self.ctx = ctx
        self.params = ctx.params
        self._flip = jnp.asarray(conj_flip_perm(ctx.params))
        n = ctx.params.n
        self._negk = jnp.asarray((-np.arange(n)) % n)
        self._col0 = jnp.asarray(
            (np.arange(n) == 0).reshape((1,) * 3 + (n,)))

    # -- building blocks -----------------------------------------------------

    def _cfl(self, re, im):
        """conj(flip(.)): W-lane flip + pair conjugation (multiplicative)."""
        q = self.ctx._c4["q"]
        fr = jnp.take(re, self._flip, axis=1)
        fi = jnp.take(im, self._flip, axis=1)
        return fr, mm.neg_mod(fi, q)

    def _postmap(self, re, im):
        """PM: output-column k -> -k mod n, x(-i) on columns k != 0 (the
        X^-1 + twist half of map_Bprime_Xinv_twist_kernel, commuted through
        the GEMM to the output)."""
        q = self.ctx._c4["q"]
        a = jnp.take(re, self._negk, axis=-1)
        b = jnp.take(im, self._negk, axis=-1)
        # -i * (a + ib) = b - ia on k != 0; identity on k == 0
        return (jnp.where(self._col0, a, b),
                jnp.where(self._col0, b, mm.neg_mod(a, q)))

    def _mul_s_cols(self, re, im, s_mont):
        """GL ring product by a real key along axis -1 (the frame's column
        X axis)."""
        return (self.ctx.xntt.mul_s(re, s_mont),
                self.ctx.xntt.mul_s(im, s_mont))

    def _mul_s_rows(self, re, im, s_mont):
        r = self.ctx.xntt.mul_s(_t(re), s_mont)
        i = self.ctx.xntt.mul_s(_t(im), s_mont)
        return _t(r), _t(i)

    # -- the op --------------------------------------------------------------

    def tensor_fn(self, ctX_re: Ciphertext, ctX_im: Ciphertext,
                  ctY_re: Ciphertext, ctY_im: Ciphertext) -> MatmulTensor:
        """The homomorphic (secret-key-free) half: four n-scaled complex
        modular GEMMs of the X components against conj(flip(Y)) components
        (batched_trace.cu:99-158 machinery as exact int8 matmuls)."""
        p = self.params
        bX = (_t(ctX_re.b), _t(ctX_im.b))
        aX = (_t(ctX_re.a), _t(ctX_im.a))
        bY = self._cfl(_t(ctY_re.b), _t(ctY_im.b))
        aY = self._cfl(_t(ctY_re.a), _t(ctY_im.a))
        e0 = tr.trace_gemm(*bX, *bY, p)
        e1l = tr.trace_gemm(*aX, *bY, p)
        e1r = tr.trace_gemm(*bX, *aY, p)
        e2 = tr.trace_gemm(*aX, *aY, p)
        return MatmulTensor(*e0, *e1l, *e1r, *e2)

    def decrypt_fn(self, tt: MatmulTensor, sk: SecretKey
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """C = PM(E0 + E1R*flip(s)) + PM(E1L + E2*flip(s))*s, returned in
        ciphertext orientation, W-eval / XY-coeff, Delta^2-scaled."""
        q = self.ctx._c4["q"]
        s = sk.s_mont
        fs = jnp.take(s, self._flip, axis=1)
        t_r, t_i = self._mul_s_cols(tt.e1r_re, tt.e1r_im, fs)
        top = self._postmap(mm.add_mod(tt.e0_re, t_r, q),
                            mm.add_mod(tt.e0_im, t_i, q))
        u_r, u_i = self._mul_s_cols(tt.e2_re, tt.e2_im, fs)
        bot = self._postmap(mm.add_mod(tt.e1l_re, u_r, q),
                            mm.add_mod(tt.e1l_im, u_i, q))
        bot = self._mul_s_rows(*bot, s)
        return (_t(mm.add_mod(top[0], bot[0], q)),
                _t(mm.add_mod(top[1], bot[1], q)))

    @functools.cached_property
    def _tensor_jit(self):
        return jax.jit(self.tensor_fn)

    @functools.cached_property
    def _decrypt_jit(self):
        return jax.jit(self.decrypt_fn)

    @functools.cached_property
    def _decode_jit(self):
        d2 = float(self.params.delta) ** 2

        def f(cr, ci):
            return self.ctx.batched_encoder.decode_from_wntt_eval(
                cr, ci, delta_override=d2)
        return jax.jit(f)

    def matmul(self, ctX: Tuple[Ciphertext, Ciphertext],
               ctY: Tuple[Ciphertext, Ciphertext]) -> MatmulTensor:
        """Homomorphic tensor for C = Y^H @ X (per lane)."""
        return self._tensor_jit(ctX[0], ctX[1], ctY[0], ctY[1])

    def decrypt_and_decode(self, tt: MatmulTensor, sk: SecretKey
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """[W, n, n] complex result pair; == Y^H @ X up to quantization and
        tensor noise."""
        cr, ci = self._decrypt_jit(tt, sk)
        return self._decode_jit(cr, ci)
