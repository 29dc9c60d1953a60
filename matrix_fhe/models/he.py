"""RLWE Matrix-FHE scheme core (keygen / encrypt / decrypt / add / mul).

Port of src/core/HE.cu's host API (HE.cuh:51-112) as pure jitted JAX
functions over ciphertext pytrees:

  * generate_secret_key (HE.cu:1272-1307): ternary s in W-coeff ->
    W-CRT eval -> X-NTT; stored in Montgomery form so the pointwise
    a (*) s products are single REDCs.
  * encrypt / encrypt_pair (HE.cu:1370-1552): a ~ U (reference LCG) in
    W-coeff -> W-eval -> X-NTT; e ~ discrete Gaussian -> W-eval;
    t = iNTT_X(NTT_X(a) (*) s); b = m - t + e.  Ciphertext stores (b, a) in
    W-eval / X-coeff domain, exactly like the reference — NTT-internal
    ordering never reaches stored data, so exact integer convolution
    semantics gives bit-exact parity.
  * decrypt_to_eval (HE.cu:1553-1601): m' = b + iNTT_X(NTT_X(a) (*) s).
  * decrypt_and_decode (HE.cu:1619-1708): W-CRT inverse -> exact big-int CRT
    compose / Delta -> complex W-DFT -> per-lane sigma decode.
  * add_ciphertexts / multiply_ciphertexts_raw (HE.cu:631-669,1710-1740).

Layout: limb-major [L, W, n, n] uint64 (reference is W-major, HE.cuh:17-33).
Debug hooks mirrored from HE.cu:25-26: `ring` selects the X-axis ring
(kDbgUsePhantomXY: "nega" = phantom X^n+1 production path, "gl" = X^n=i) and
`zero_noise` mirrors kDbgZeroNoise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GLParams, get_params
from ..tables import build_tables
from ..ops import modmath as mm
from ..ops.ntt import XNTT, RING_NEGACYCLIC
from ..ops.wcrt import WTransform
from .batched_encoder import BatchedEncoder
from . import rng as refrng

U64 = jnp.uint64


class Ciphertext(NamedTuple):
    """(b, a) pair, W-CRT-eval / X-coeff domain, limb-major [L, W, n, n]."""
    b: jnp.ndarray
    a: jnp.ndarray


class SecretKey(NamedTuple):
    """s in X-NTT x W-eval domain, Montgomery form, [L, W, n]."""
    s_mont: jnp.ndarray


class HEContext:
    """All tables, transforms and jitted pipelines for one parameter set.

    The reference equivalent is the init_he_backend() global singleton
    (HE.cu:318-408); here it is an explicit object so multiple parameter sets
    coexist and everything stays functionally pure under jit.
    """

    def __init__(self, params: GLParams, ring: str = RING_NEGACYCLIC,
                 zero_noise: bool = False,
                 fast_float: bool | None = None,
                 cache_parity_streams: bool = True):
        """fast_float: None = the package default (ops/ddfloat.py); True
        runs the roundtrip on the u32-pair path with the float-exact decode
        compose, False on the u64 path with the exact big-int compose.

        cache_parity_streams: the reference-parity RNG streams
        (uniform_random_kernel / gaussian_noise_kernel, HE.cu:564-627) are
        SEEDLESS deterministic functions of position — i.e. constants of
        the parameter set, recomputed per encrypt by the reference only
        because its CUDA kernels have nowhere to cache them.  With True
        (default) the fast-float roundtrip builds their W-eval forms once
        like every other table.  Real-crypto deployments use the fresh
        threefry path (encrypt_pair(key=...)), which always generates
        per-call randomness."""
        self.params = params
        self.ring = ring
        self.zero_noise = zero_noise
        self.cache_parity_streams = cache_parity_streams
        self.tables = build_tables(params)
        self.wt = WTransform(params, self.tables)
        self.xntt = XNTT(params, ring=ring, tables=self.tables)
        self.batched_encoder = BatchedEncoder(params, self.tables, self.wt,
                                              fast_float=fast_float)
        self.encoder = self.batched_encoder.encoder
        # per-limb Montgomery constants broadcastable over [L, W, n, n]
        self._c4 = mm.mont_consts_arrays(params.moduli, shape_suffix=(1, 1, 1))
        self._c3 = mm.mont_consts_arrays(params.moduli, shape_suffix=(1, 1))

    # -- helpers ---------------------------------------------------------------

    def _pointwise_mul_s(self, a_ntt: jnp.ndarray, s_mont: jnp.ndarray
                         ) -> jnp.ndarray:
        """t = a (*) s in X-NTT domain (pointwise_mul_s_kernel, HE.cu:509-531);
        s broadcasts over the y axis."""
        c = self._c4
        return mm.mont_mul(a_ntt, s_mont[:, :, None, :], c["q"], c["qinv_neg"])

    def _to_mont4(self, x):
        c = self._c4
        return mm.to_mont(x, c["q"], c["qinv_neg"], c["r2"])

    # -- key generation ---------------------------------------------------------

    @functools.cached_property
    def _keygen_jit(self):
        def keygen(_):
            s_coeff = refrng.ternary_secret(self.params)      # [L, W, n]
            s_eval = self.wt.forward(s_coeff)                  # W-CRT eval
            s_ntt = self.xntt.forward(s_eval)                  # X-NTT
            c = self._c3
            return SecretKey(mm.to_mont(s_ntt, c["q"], c["qinv_neg"], c["r2"]))
        return jax.jit(keygen)

    def generate_secret_key(self, key: Optional[jax.Array] = None) -> SecretKey:
        """Deterministic reference-parity key (HE.cu:1272-1307); pass a
        jax.random key for fresh threefry-based key material instead."""
        if key is None:
            return self._keygen_jit(0)
        s_coeff = refrng.fresh_ternary_secret(key, self.params)
        s_ntt = self.xntt.forward(self.wt.forward(s_coeff))
        c = self._c3
        return SecretKey(mm.to_mont(s_ntt, c["q"], c["qinv_neg"], c["r2"]))

    # -- encrypt -----------------------------------------------------------------

    def _encrypt_core(self, msgs, sk: SecretKey, a_coeff, noises):
        """Shared-`a` encryption of one or more packed messages
        (encrypt_pair, HE.cu:1455-1552)."""
        c = self._c4
        a_eval = self.wt.forward(a_coeff)
        t = self.xntt.mul_s(a_eval, sk.s_mont)
        cts = []
        for m, e_coeff in zip(msgs, noises):
            if self.zero_noise:
                e_eval = jnp.zeros_like(m)
            else:
                e_eval = self.wt.forward(e_coeff)
            b = mm.add_mod(mm.sub_mod(m, t, c["q"]), e_eval, c["q"])
            cts.append(Ciphertext(b=b, a=a_eval))
        return tuple(cts)

    @functools.cached_property
    def _encrypt_pair_jit(self):
        def f(m_re, m_im, sk):
            a_coeff = refrng.uniform_a(self.params)
            e = refrng.gaussian_noise(self.params)
            # independent errors: the reference calls the same deterministic
            # kernel twice, so e_re == e_im there as well (HE.cu:1516-1517)
            return self._encrypt_core((m_re, m_im), sk, a_coeff, (e, e))
        return jax.jit(f)

    def encrypt_pair(self, m_re, m_im, sk: SecretKey,
                     key: Optional[jax.Array] = None
                     ) -> Tuple[Ciphertext, Ciphertext]:
        """Encrypt a packed complex pair sharing one `a` (HE.cuh:91-92)."""
        if key is None:
            return self._encrypt_pair_jit(m_re, m_im, sk)
        ka, k1, k2 = jax.random.split(key, 3)
        a_coeff = refrng.fresh_uniform_a(ka, self.params)
        noises = (refrng.fresh_gaussian_noise(k1, self.params),
                  refrng.fresh_gaussian_noise(k2, self.params))
        return self._encrypt_core((m_re, m_im), sk, a_coeff, noises)

    @functools.cached_property
    def _encrypt_jit(self):
        def f(m, sk):
            a_coeff = refrng.uniform_a(self.params)
            e = refrng.gaussian_noise(self.params)
            return self._encrypt_core((m,), sk, a_coeff, (e,))[0]
        return jax.jit(f)

    def encrypt(self, m, sk: SecretKey) -> Ciphertext:
        """Single-message encrypt (HE.cu:1370-1453)."""
        return self._encrypt_jit(m, sk)

    # -- decrypt -----------------------------------------------------------------

    @functools.cached_property
    def _decrypt_to_eval_jit(self):
        return jax.jit(self._decrypt_fn)

    def decrypt_to_eval(self, ct: Ciphertext, sk: SecretKey) -> jnp.ndarray:
        """b + a*s in W-eval / X-coeff domain (HE.cu:1553-1601)."""
        return self._decrypt_to_eval_jit(ct, sk)

    @functools.cached_property
    def _decrypt_and_decode_jit(self):
        def f(ct_re: Ciphertext, ct_im: Ciphertext, sk: SecretKey):
            ev_re = self._decrypt_to_eval_jit(ct_re, sk)
            ev_im = self._decrypt_to_eval_jit(ct_im, sk)
            return self.batched_encoder.decode_from_wntt_eval(ev_re, ev_im)
        return jax.jit(f)

    def decrypt_and_decode(self, ct_re: Ciphertext, ct_im: Ciphertext,
                           sk: SecretKey) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Full decode to complex matrices [W, n, n] (HE.cu:1691-1708)."""
        return self._decrypt_and_decode_jit(ct_re, ct_im, sk)

    # -- homomorphic ops -----------------------------------------------------------

    @functools.cached_property
    def _add_jit(self):
        def f(ct1: Ciphertext, ct2: Ciphertext):
            c = self._c4
            return Ciphertext(b=mm.add_mod(ct1.b, ct2.b, c["q"]),
                              a=mm.add_mod(ct1.a, ct2.a, c["q"]))
        return jax.jit(f)

    def add_ciphertexts(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """Pointwise addition (add_ct_kernel, HE.cu:631-644)."""
        return self._add_jit(ct1, ct2)

    @functools.cached_property
    def _mul_raw_jit(self):
        def f(ct1: Ciphertext, ct2: Ciphertext):
            c = self._c4
            q, qi = c["q"], c["qinv_neg"]
            b1m = self._to_mont4(ct1.b)
            a1m = self._to_mont4(ct1.a)
            d0 = mm.mont_mul(b1m, ct2.b, q, qi)
            d1 = mm.add_mod(mm.mont_mul(b1m, ct2.a, q, qi),
                            mm.mont_mul(a1m, ct2.b, q, qi), q)
            d2 = mm.mont_mul(a1m, ct2.a, q, qi)
            return d0, d1, d2
        return jax.jit(f)

    def multiply_ciphertexts_raw(self, ct1: Ciphertext, ct2: Ciphertext):
        """Tensor product (d0, d1, d2) = (b1b2, b1a2+a1b2, a1a2) — no
        relinearization/rescale exists in the reference either
        (mul_tensor_kernel, HE.cu:647-669)."""
        return self._mul_raw_jit(ct1, ct2)

    @functools.cached_property
    def _mul_plain_jit(self):
        def f(ct: Ciphertext, m: jnp.ndarray):
            c = self._c4
            q, qi = c["q"], c["qinv_neg"]
            hatm = mm.to_mont(self.xntt.forward(m), q, qi, c["r2"])
            b = self.xntt.inverse(
                mm.mont_mul(self.xntt.forward(ct.b), hatm, q, qi))
            a = self.xntt.inverse(
                mm.mont_mul(self.xntt.forward(ct.a), hatm, q, qi))
            return Ciphertext(b=b, a=a)
        return jax.jit(f)

    def multiply_plain(self, ct: Ciphertext, m: jnp.ndarray) -> Ciphertext:
        """Exact ring product of a ciphertext with a PLAINTEXT element m
        (same stored layout as encrypt's message: W-eval, X-coeff,
        limb-major).  No key material needed, no fresh noise — the
        existing noise is multiplied by m, and the plaintext scale
        multiplies (decode with delta_override).  Standard CKKS
        const/mask multiply; no reference counterpart."""
        return self._mul_plain_jit(ct, jnp.asarray(m))

    @functools.cached_property
    def _add_plain_jit(self):
        def f(ct: Ciphertext, m: jnp.ndarray):
            return Ciphertext(b=mm.add_mod(ct.b, m, self._c4["q"]),
                              a=ct.a)
        return jax.jit(f)

    def add_plain(self, ct: Ciphertext, m: jnp.ndarray) -> Ciphertext:
        """ct + plaintext m (stored layout; m must carry the ciphertext's
        scale)."""
        return self._add_plain_jit(ct, jnp.asarray(m))

    # -- convenience ------------------------------------------------------------

    def roundtrip_fn(self, m_re, m_im, sk: SecretKey):
        """Pure (un-jitted) full pipeline, for composition under vmap /
        sharding annotations (parallel/pipeline.py)."""
        if self.batched_encoder.encoder.fast_float:
            return self._roundtrip_pair_fn(m_re, m_im, sk)
        pr, pi = self.batched_encoder.encode_to_wntt_eval(m_re, m_im)
        a_coeff = refrng.uniform_a(self.params)
        e = refrng.gaussian_noise(self.params)
        ct_re, ct_im = self._encrypt_core((pr, pi), sk, a_coeff, (e, e))
        ev_re, ev_im = self.decrypt_pair_to_eval(ct_re, ct_im, sk)
        return self.batched_encoder.decode_from_wntt_eval(ev_re, ev_im)

    def _parity_stream(self, name: str, build):
        """Build-once cache for the deterministic parity streams.  If first
        touched INSIDE a trace (e.g. a sharded pipeline tracing
        roundtrip_fn directly), compute inline without caching — caching a
        tracer would poison later calls."""
        cached = getattr(self, name, None)
        if cached is not None:
            return cached
        val = jax.jit(build)()
        # Public-API trace detection: under an enclosing
        # trace jit inlines and returns tracers — use the value but never
        # cache it (a cached tracer would poison later calls).
        if any(isinstance(leaf, jax.core.Tracer)
               for leaf in jax.tree_util.tree_leaves(val)):
            return val
        val = jax.block_until_ready(val)
        setattr(self, name, val)
        return val

    @property
    def _parity_a_eval_pair(self):
        return self._parity_stream(
            "_parity_a_eval_cache",
            lambda: self.wt.forward_pair(*refrng.uniform_a_pair(self.params)))

    @property
    def _parity_e_eval_pair(self):
        return self._parity_stream(
            "_parity_e_eval_cache",
            lambda: self.wt.forward_pair(
                *mm.pair_split(refrng.gaussian_noise(self.params))))

    def _roundtrip_pair_fn(self, m_re, m_im, sk: SecretKey, streams=None):
        """Pair-native (u32 lo/hi plane) roundtrip with the float-exact
        decode compose.  `streams` = ((ael, aeh), (eel, eeh) | None): the
        pre-built parity stream tables, passed as ARGUMENTS (closure
        constants of this size would be baked into the executable)."""
        be = self.batched_encoder
        (prl, prh), (pil, pih) = be.encode_pair(m_re, m_im)
        if streams is not None:
            ael, aeh = streams[0]
        else:
            al, ah = refrng.uniform_a_pair(self.params)
            ael, aeh = self.wt.forward_pair(al, ah)
        sl, sh = mm.pair_split(sk.s_mont)
        tl, th = self.xntt.mul_s_pair(ael, aeh, sl, sh)
        ql, qh = mm.pair_consts(self.params.moduli, m_re.ndim)
        if self.zero_noise:
            eel = eeh = None
        elif streams is not None and streams[1] is not None:
            eel, eeh = streams[1]
        else:
            e = refrng.gaussian_noise(self.params)
            el, eh = mm.pair_split(e)
            eel, eeh = self.wt.forward_pair(el, eh)
        evs = []
        for ml, mh in ((prl, prh), (pil, pih)):
            bl, bh = mm.pair_sub_mod(ml, mh, tl, th, ql, qh)
            if eel is not None:
                bl, bh = mm.pair_add_mod(bl, bh, eel, eeh, ql, qh)
            # decrypt: ev = b + a*s (the compiler shares t with encrypt)
            evs.append(mm.pair_add_mod(bl, bh, tl, th, ql, qh))
        return be.decode_pair(evs[0], evs[1])

    def _decrypt_fn(self, ct: Ciphertext, sk: SecretKey):
        c = self._c4
        t = self.xntt.mul_s(ct.a, sk.s_mont)
        return mm.add_mod(ct.b, t, c["q"])

    def decrypt_pair_to_eval(self, ct_re: Ciphertext, ct_im: Ciphertext,
                             sk: SecretKey):
        """Decrypt a pair produced by encrypt_pair, which shares one `a`
        (HE.cu:1455-1552): a*s is computed once for both halves."""
        c = self._c4
        t = self.xntt.mul_s(ct_re.a, sk.s_mont)
        return (mm.add_mod(ct_re.b, t, c["q"]),
                mm.add_mod(ct_im.b, t, c["q"]))

    @functools.cached_property
    def _roundtrip_jit(self):
        return jax.jit(self.roundtrip_fn)

    @functools.cached_property
    def _roundtrip_streams_jit(self):
        def f(m_re, m_im, sk, streams):
            return self._roundtrip_pair_fn(m_re, m_im, sk, streams=streams)
        return jax.jit(f)

    def roundtrip_program(self, m_re, m_im, sk: SecretKey):
        """(jitted function, arguments) that one roundtrip() call runs —
        for lowering it, e.g. to read compiled.memory_analysis()."""
        if (self.cache_parity_streams
                and self.batched_encoder.encoder.fast_float):
            streams = (self._parity_a_eval_pair,
                       None if self.zero_noise else self._parity_e_eval_pair)
            return self._roundtrip_streams_jit, (m_re, m_im, sk, streams)
        return self._roundtrip_jit, (m_re, m_im, sk)

    def roundtrip(self, m_re, m_im, sk: SecretKey):
        """encode -> encrypt -> decrypt -> decode, one fused jit
        (src/main.cu:31-157 pipeline)."""
        fn, args = self.roundtrip_program(m_re, m_im, sk)
        return fn(*args)


@functools.lru_cache(maxsize=None)
def init_he_backend(params_name: str = "ref", ring: str = RING_NEGACYCLIC,
                    zero_noise: bool = False) -> HEContext:
    """Reference-style singleton constructor (init_he_backend, HE.cu:318)."""
    return HEContext(get_params(params_name), ring=ring, zero_noise=zero_noise)
