"""HE over the integral double form of the GL ring ("gl2").

The reference's GL ring Z[i][X]/(X^n - i) (ntt_core.cu:175-198, selected by
kDbgUsePhantomXY=false) is isomorphic over the integers to the negacyclic
ring of doubled degree:

    Z[i][X]/(X^n - i)  ~=  D := Z[X]/(X^{2n} + 1),     i |-> X^n,

with a Gaussian coefficient a + b*i landing in integer slots j and n+j (see
tables.build_gl2_x_tables).  Round 2 established that the folded per-limb GL
picture admits NO key switching (the wrap constant i_q differs per modulus,
keyswitch.py:70-77); in the D form every coefficient is a plain integer, so
the full leveled apparatus — relinearization, rescale, Galois — applies to
GL-packed data.  This module is the scheme core for that form; it has no
reference counterpart (the reference never composes its trace-GEMM with
encryption at all, SURVEY §2.13).

Packing per W lane: the 64x64 complex matrix M is the 2D evaluation of a
GL_Y (x) GL_X element (encoder.cu:460-467 sandwich); here the X factor is
doubled, so a plaintext is one integer array [L, W, n, 2n] whose complex
X-coefficients c = a + i*b occupy x-slots j (re) and n+j (im).  The re/im
ciphertext PAIR of the folded scheme becomes ONE ciphertext of the same
total size.  The Y factor keeps wrap Y^n = i = X^n — an element of the
integral ring Z[Y, X]/(Y^n - X^n, X^{2n} + 1).

Randomness is the fresh threefry path only: there is no reference bitstream
to be parity with (beyond-reference subsystem).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GLParams
from ..ops import modmath as mm
from ..ops.ntt import RING_GL2, XNTT
from ..ops.wcrt import WTransform
from ..tables import build_tables
from .encoder import Encoder
from .rng import llround

U64 = jnp.uint64


class Ciphertext2(NamedTuple):
    """(b, a), W-CRT-eval / X2-coeff domain, [L, W, y, 2n]."""
    b: jnp.ndarray
    a: jnp.ndarray


class SecretKey2(NamedTuple):
    s_mont: jnp.ndarray   # [L, W, 2n] X2-NTT x W-eval, Montgomery form
    s_sign: jnp.ndarray   # [W, 2n] int8 ternary pattern (for switch keys)


class Gl2Context:
    """Transforms + jitted pipelines for gl2-ring HE on one parameter set."""

    def __init__(self, params: GLParams, zero_noise: bool = False):
        self.params = params
        self.ring = RING_GL2
        self.zero_noise = zero_noise
        self.tables = build_tables(params)
        self.wt = WTransform(params, self.tables)
        self.xntt = XNTT(params, ring=RING_GL2, tables=self.tables)
        self.encoder = Encoder(params, self.tables, fast_float=False)
        self._c4 = mm.mont_consts_arrays(params.moduli, shape_suffix=(1, 1, 1))
        self._c3 = mm.mont_consts_arrays(params.moduli, shape_suffix=(1, 1))
        self.m = 2 * params.n  # X-axis ring dimension of D

    # -- key generation ------------------------------------------------------

    def generate_secret_key(self, key: jax.Array) -> SecretKey2:
        p = self.params
        sign = (jax.random.randint(key, (p.phi, self.m), 0, 3,
                                   dtype=jnp.int32) - 1).astype(jnp.int8)
        return self._finish_key_jit(sign)

    @functools.cached_property
    def _finish_key_jit(self):
        def f(sign):
            s_res = self._ternary_residues(sign, self.params.moduli)
            s_ntt = self.xntt.forward(self.wt.forward(s_res))
            c = self._c3
            return SecretKey2(
                mm.to_mont(s_ntt, c["q"], c["qinv_neg"], c["r2"]), sign)
        return jax.jit(f)

    @staticmethod
    def _ternary_residues(sign: jnp.ndarray, moduli) -> jnp.ndarray:
        """[W, m] int8 in {-1,0,1} -> per-limb residues [L, W, m] u64."""
        s = sign.astype(jnp.int64)[None]
        q = jnp.asarray(np.asarray(moduli, np.uint64)).reshape(-1, 1, 1)
        return jnp.where(s < 0, q + s.astype(U64) , s.astype(U64))

    # -- encode / decode -----------------------------------------------------

    def _quantize_real(self, c: jnp.ndarray) -> jnp.ndarray:
        """llround(c * Delta) -> RNS residues [L, ...] (integer-exact while
        |c*Delta| < 2^52, the same contract as Encoder.quantize)."""
        v = llround(c * np.float64(self.params.delta))
        outs = []
        for q in self.params.moduli:
            qq = jnp.int64(int(q))
            r = v % qq
            outs.append(jnp.where(r < 0, r + qq, r).astype(U64))
        return jnp.stack(outs)

    def encode_fn(self, m_re: jnp.ndarray, m_im: jnp.ndarray) -> jnp.ndarray:
        """[W, n, n] complex pair -> packed plaintext [L, W, n, 2n] u64 in
        (W-eval, X2-coeff).  Same pipeline as BatchedEncoder
        (batched_encoder.cu:161-228) with the re/im split replaced by the
        i = X^n slot packing."""
        n = self.params.n
        xr, xi = self.encoder.idft2(m_re, m_im)        # per-lane XY-IDFT
        cr, ci = self.wt.dft_inverse_pair(xr, xi)      # complex W-IDFT
        packed = jnp.concatenate([cr, ci], axis=-1)    # [W, n, 2n] f64
        return self.wt.forward(self._quantize_real(packed))

    def decode_fn(self, ev: jnp.ndarray,
                  delta_override: float | None = None
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """[L, W, y, 2n] (W-eval, X2-coeff) -> complex [W, y, n] pair."""
        n = self.params.n
        delta = (self.params.delta if delta_override is None
                 else delta_override)
        wc = self.wt.inverse(ev)
        f = self.encoder._composer.compose_to_float(wc, delta)
        cr, ci = f[..., :n], f[..., n:]
        er, ei = self.wt.dft_forward_pair(cr, ci)
        return self.encoder.dft2(er, ei)

    # -- encrypt / decrypt ---------------------------------------------------

    def _fresh_uniform(self, key: jax.Array, shape) -> jnp.ndarray:
        outs = []
        for q in self.params.moduli:
            key, sub = jax.random.split(key)
            outs.append(jax.random.randint(
                sub, shape, 0, int(q), dtype=jnp.int64).astype(U64))
        return jnp.stack(outs)

    def _fresh_gaussian(self, key: jax.Array, shape) -> jnp.ndarray:
        """Discrete Gaussian sigma=3.2 (HE.cu:615), same integer in every
        limb (limb-consistent small element)."""
        g = jnp.round(jax.random.normal(key, shape, dtype=jnp.float32)
                      * np.float32(self.params.sigma)).astype(jnp.int64)
        q = jnp.asarray(np.asarray(self.params.moduli, np.uint64)
                        ).reshape((-1,) + (1,) * len(shape))
        gb = jnp.broadcast_to(g[None], (len(self.params.moduli),) + shape)
        return jnp.where(gb < 0, q + gb.astype(U64), gb.astype(U64))

    def encrypt_fn(self, m: jnp.ndarray, sk: SecretKey2, key: jax.Array
                   ) -> Ciphertext2:
        """m: [L, W, y, 2n] W-eval packed plaintext."""
        p = self.params
        y = m.shape[2]
        ka, ke = jax.random.split(key)
        a_coeff = self._fresh_uniform(ka, (p.phi, y, self.m))
        a_eval = self.wt.forward(a_coeff)
        t = self.xntt.mul_s(a_eval, sk.s_mont)
        c = self._c4
        if self.zero_noise:
            e_eval = jnp.zeros_like(m)
        else:
            e_eval = self.wt.forward(
                self._fresh_gaussian(ke, (p.phi, y, self.m)))
        b = mm.add_mod(mm.sub_mod(m, t, c["q"]), e_eval, c["q"])
        return Ciphertext2(b=b, a=a_eval)

    def decrypt_to_eval_fn(self, ct: Ciphertext2, sk: SecretKey2
                           ) -> jnp.ndarray:
        c = self._c4
        return mm.add_mod(ct.b, self.xntt.mul_s(ct.a, sk.s_mont), c["q"])

    # -- jitted conveniences -------------------------------------------------

    @functools.cached_property
    def _encode_jit(self):
        return jax.jit(self.encode_fn)

    def encode(self, m_re, m_im):
        return self._encode_jit(m_re, m_im)

    @functools.cached_property
    def _decode_jit(self):
        return jax.jit(self.decode_fn, static_argnames=("delta_override",))

    def decode(self, ev, delta_override=None):
        return self._decode_jit(ev, delta_override=delta_override)

    @functools.cached_property
    def _encrypt_jit(self):
        return jax.jit(self.encrypt_fn)

    def encrypt(self, m, sk: SecretKey2, key: jax.Array) -> Ciphertext2:
        return self._encrypt_jit(m, sk, key)

    @functools.cached_property
    def _decrypt_jit(self):
        return jax.jit(self.decrypt_to_eval_fn)

    def decrypt_to_eval(self, ct: Ciphertext2, sk: SecretKey2) -> jnp.ndarray:
        return self._decrypt_jit(ct, sk)

    def decrypt_and_decode(self, ct: Ciphertext2, sk: SecretKey2,
                           delta_override: float | None = None):
        return self.decode(self.decrypt_to_eval(ct, sk),
                           delta_override=delta_override)
