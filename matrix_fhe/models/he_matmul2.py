"""Ciphertext-in / ciphertext-out homomorphic GEMM (gl2 double ring).

Round 2's `he_matmul` computes the trace-GEMM tensor in the folded GL ring,
where the output (E0, E1L, E1R, E2) can only be opened by a two-sided
secret-key action — the folded ring admits no key switching
(keyswitch.py:70-77).  In the integral double form D = Z[X]/(X^{2n}+1)
(models/he2.py) the whole op becomes standard:

  1. sigma = full complex conjugation = the ring automorphism
     (W -> W^-1, Y -> Y^-1, X -> X^-1) of the packing ring
     Z[W]/Phi_p (x) Z[Y,X]/(Y^n - X^n, X^{2n}+1): a lane flip + an exact
     integer coefficient permutation-with-signs (no per-limb i_q constants).
  2. The trace contraction over the Y factor is bilinear in coefficients:
     T = Tr_Y(sigma(mY) (.)_Y mX) lives in the 2D tensor ring
     D_{X1} (x) D_{X2}, computed as one modular GEMM per (limb, lane):
     T[x1,x2] = n * sum_y RY(u)[y,x1] * TW(v)[y,x2]  with RY the Y-index
     reversal and TW the Y^n = X^n wrap twist (the analog of
     map_Bprime_Xinv_twist_kernel + trace_gemm, trace.cu:30-131 — but on
     ciphertext components).
  3. Component keys: T = E00 + E01*(1(x)s) + E10*(ss(x)1) + E11*(ss(x)s),
     ss = sigma(s).  The 2D tensor ring is an honest integral negacyclic^2
     ring, so RNS-hybrid key switching applies verbatim: two switch keys
     (targets ss(x)1 and ss(x)s, both ENCRYPTED UNDER 1(x)s) relinearize it
     to a rank-1 pair (B, A) with B + A*(1(x)s) = T.
  4. Repack: the ring map rho: D_{X1} (x) D_{X2} -> packing ring, X1 |-> Y
     (valid since Y^{2n} = (X^n)^2 = -1) folds row y+n onto row y with an
     X^n twist — a 2-term integer add, no transform.  rho commutes with
     (1(x)s), so (rho B, rho A) is a STANDARD gl2 ciphertext of C = Y^H X:
     decrypt with the plain secret key, decode with Delta^2, and keep
     computing on it (it composes with multiply/relinearize/rescale).

The reference's trace kernels are plaintext-only and never run
(SURVEY §2.13).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import modmath as mm
from .he_matmul import conj_flip_perm
from .he2 import Ciphertext2, Gl2Context, SecretKey2
from .keyswitch import RelinContext

U64 = jnp.uint64


class GemmTensor2(NamedTuple):
    """2D tensor-ring components [L, W, 2n, 2n] (W-eval, X1/X2-coeff);
    keys (1, 1(x)s, ss(x)1, ss(x)s)."""
    e00: jnp.ndarray
    e01: jnp.ndarray
    e10: jnp.ndarray
    e11: jnp.ndarray


class GemmRelinKey(NamedTuple):
    """Per-digit switch keys over QP, (W-eval, 2D X-NTT) Montgomery form:
    k1 encrypts g_i * (sigma(s) (x) 1), k2 encrypts g_i * (sigma(s) (x) s),
    both under (1 (x) s)."""
    b1: Tuple[jnp.ndarray, ...]
    a1: Tuple[jnp.ndarray, ...]
    b2: Tuple[jnp.ndarray, ...]
    a2: Tuple[jnp.ndarray, ...]


def _sigma_index_maps(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather indices + sign for the coefficient action of
    (Y -> Y^-1, X -> X^-1) on a [y, x] frame (y-dim n, x-dim 2n):
    out[y', x'] = sign[y', x'] * z[YI[y', x'], XI[y', x']].

    Monomial algebra (Y^n = X^n, X^{2n} = -1):
      Y^{-y} = -Y^{n-y} X^n (y >= 1);  X^{-x} = -X^{2n-x} (x >= 1).
    """
    m = 2 * n
    YI = np.zeros((n, m), dtype=np.int32)
    XI = np.zeros((n, m), dtype=np.int32)
    SG = np.zeros((n, m), dtype=np.int8)
    for yp in range(n):
        for xp in range(m):
            if yp == 0:
                y = 0
                if xp == 0:
                    x, s = 0, 1
                else:
                    x, s = m - xp, -1
            else:
                y = n - yp
                if xp == n:
                    x, s = 0, -1
                elif xp < n:
                    x, s = n - xp, -1       # x in [1, n]
                else:
                    x, s = 3 * n - xp, 1    # x in (n, 2n)
            YI[yp, xp] = y
            XI[yp, xp] = x
            SG[yp, xp] = s
    return YI, XI, SG


def _shift_xn(z: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Multiply by X^n along the trailing axis (wrap X^{2n} = -1)."""
    m = z.shape[-1]
    n = m // 2
    rolled = jnp.roll(z, n, axis=-1)
    x = jnp.arange(m) < n
    return jnp.where(x, mm.neg_mod(rolled, q), rolled)


class HEMatmul2:
    """Homomorphic C = Y^H @ X per packed lane, ciphertext in / out."""

    def __init__(self, ctx: Gl2Context):
        self.ctx = ctx
        p = ctx.params
        self.n = p.n
        self.m = 2 * p.n
        self._flip = jnp.asarray(conj_flip_perm(p))
        YI, XI, SG = _sigma_index_maps(p.n)
        self._sYI = jnp.asarray(YI)
        self._sXI = jnp.asarray(XI)
        self._sNEG = jnp.asarray(SG < 0)
        # y-reversal for the trace pairing
        self._ry = jnp.asarray((-np.arange(p.n)) % p.n)
        # chunked modular GEMM constants: n * 2^{8c} * 2^64 mod q (one
        # mont_mul folds chunk scale, the trace's n factor, and reduction)
        bits = p.max_modulus_bits
        self.n_chunks = -(-bits // 8)
        fold = np.empty((self.n_chunks, p.num_limbs), dtype=np.uint64)
        for c in range(self.n_chunks):
            for l, q in enumerate(p.moduli):
                fold[c, l] = (p.n << (8 * c)) % int(q) * ((1 << 64) % int(q)
                                                          ) % int(q)
        self._fold = jnp.asarray(fold)

    # -- component maps ------------------------------------------------------

    def _sigma(self, z: jnp.ndarray) -> jnp.ndarray:
        """Full conjugation on a component [L, W, y, x]: W-lane flip +
        (Y -> Y^-1, X -> X^-1) coefficient gather."""
        q = self.ctx._c4["q"]
        zf = jnp.take(z, self._flip, axis=1)
        g = zf[:, :, self._sYI, self._sXI]
        return jnp.where(self._sNEG, mm.neg_mod(g, q), g)

    def _tw(self, z: jnp.ndarray) -> jnp.ndarray:
        """TW: X^n twist on Y-rows >= 1 (the Y^n = X^n wrap of the trace
        pairing), identity on row 0."""
        q = self.ctx._c4["q"]
        sh = _shift_xn(z, q)
        row0 = jnp.arange(self.n).reshape(1, 1, -1, 1) == 0
        return jnp.where(row0, z, sh)

    def _ry_map(self, z: jnp.ndarray) -> jnp.ndarray:
        return jnp.take(z, self._ry, axis=2)

    def _mod_gemm(self, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        """E[l,w,x1,x2] = n * sum_y u[l,w,y,x1] * v[l,w,y,x2] mod q_l.
        8-bit chunks of u keep every u64 partial sum exact
        (2^8 * q * n < 2^64 for q < 2^50, n <= 64)."""
        c = self.ctx._c4
        acc = None
        for ci in range(self.n_chunks):
            uc = (u >> U64(8 * ci)) & U64(0xFF)
            part = jnp.einsum("lwya,lwyb->lwab", uc, v)
            fold = self._fold[ci].reshape(-1, 1, 1, 1)
            term = mm.mont_mul(part, fold, c["q"], c["qinv_neg"])
            acc = term if acc is None else mm.add_mod(acc, term, c["q"])
        return acc

    # -- the tensor op -------------------------------------------------------

    def _gemm2x2(self, u1, u2, v1, v2):
        """The four tensor products e_ij = n * U_i^T @ V_j mod q."""
        return (self._mod_gemm(u1, v1), self._mod_gemm(u1, v2),
                self._mod_gemm(u2, v1), self._mod_gemm(u2, v2))

    def tensor_fn(self, ctX: Ciphertext2, ctY: Ciphertext2) -> GemmTensor2:
        sy_b = self._ry_map(self._sigma(ctY.b))
        sy_a = self._ry_map(self._sigma(ctY.a))
        x_b = self._tw(ctX.b)
        x_a = self._tw(ctX.a)
        e00, e01, e10, e11 = self._gemm2x2(sy_b, sy_a, x_b, x_a)
        return GemmTensor2(e00=e00, e01=e01, e10=e10, e11=e11)

    # -- secret-side identities (tests / debugging) --------------------------

    def _sigma_s_mont(self, sk: SecretKey2) -> jnp.ndarray:
        """sigma(s) in (W-eval, X-NTT) Montgomery form over Q: lane flip +
        NTT slot reversal (slot k evals at psi^{2k+1}; negating the
        exponent maps k -> 2n-1-k)."""
        return jnp.take(sk.s_mont, self._flip, axis=1)[:, :, ::-1]

    def _mul_x2(self, z, s_mont):
        return self.ctx.xntt.mul_s(z, s_mont)

    def _mul_x1(self, z, s_mont):
        t = self.ctx.xntt.mul_s(jnp.swapaxes(z, -1, -2), s_mont)
        return jnp.swapaxes(t, -1, -2)

    def decrypt_tensor_fn(self, tt: GemmTensor2, sk: SecretKey2
                          ) -> jnp.ndarray:
        """Two-sided opening of the raw tensor (the gl2 analog of
        he_matmul.decrypt_fn) + rho repack -> packed plaintext
        [L, W, n, 2n].  Reference point for the key-switched path."""
        q = self.ctx._c4["q"]
        ss = self._sigma_s_mont(sk)
        top = mm.add_mod(tt.e00, self._mul_x2(tt.e01, sk.s_mont), q)
        bot = mm.add_mod(tt.e10, self._mul_x2(tt.e11, sk.s_mont), q)
        t = mm.add_mod(top, self._mul_x1(bot, ss), q)
        return self.repack_fn(t)

    # -- repack --------------------------------------------------------------

    def repack_fn(self, t: jnp.ndarray) -> jnp.ndarray:
        """rho: [L, W, 2n, 2n] tensor-ring element -> [L, W, n, 2n] packed
        frame: X1 |-> Y, row y+n folds onto row y with an X^n twist."""
        q = self.ctx._c4["q"]
        lo, hi = t[:, :, :self.n], t[:, :, self.n:]
        return mm.add_mod(lo, _shift_xn(hi, q), q)

    @functools.cached_property
    def _tensor_jit(self):
        return jax.jit(self.tensor_fn)

    def matmul_tensor(self, ctX: Ciphertext2, ctY: Ciphertext2
                      ) -> GemmTensor2:
        return self._tensor_jit(ctX, ctY)


class Gl2Conj:
    """Homomorphic complex conjugation of every packed value.

    The joint automorphism sigma = (W -> W^-1, Y -> Y^-1, X -> X^-1) of
    the packing ring, applied to ciphertext components + ONE key switch
    from sigma(s) back to s.  NOTE sigma is NOT a composition of per-axis
    maps: X -> X^-1 fixing Y fails the Y^n = X^n relation ((k-1)n must be
    0 mod 4n, so X-only Galois indices are k = 1 mod 4 — the slot-rotation
    orbit, XGaloisKeys), and Y -> Y^-1 fixing X fails it symmetrically.
    Only the joint inversion is an automorphism."""

    def __init__(self, hm: HEMatmul2, rc, sk: SecretKey2, key: jax.Array):
        self.hm = hm
        self.rc = rc
        s_res = Gl2Context._ternary_residues(sk.s_sign,
                                             hm.ctx.params.moduli)
        s_hat = rc._lift_ternary(s_res)
        ss_hat = jnp.take(s_hat, hm._flip, axis=1)[:, :, ::-1]
        self._ksk = rc.gen_switch_key(ss_hat, s_res, key)

    @functools.cached_property
    def _apply_jit(self):
        hm, rc = self.hm, self.rc

        def f(ct: Ciphertext2, ksk):
            q = rc._cq["q"]
            tb = hm._sigma(ct.b)
            ta = hm._sigma(ct.a)
            kb, ka = rc.key_switch_d2(ta, ksk)
            return Ciphertext2(b=mm.add_mod(tb, kb, q), a=ka)
        return jax.jit(f)

    def apply(self, ct: Ciphertext2) -> Ciphertext2:
        return self._apply_jit(ct, self._ksk)


class Gl2GemmRelin:
    """Switch keys + relinearization for GemmTensor2 -> standard gl2
    ciphertext.  Reuses RelinContext's gadget / base-conversion / ModDown
    (models/keyswitch.py) over the 2D tensor ring."""

    def __init__(self, hm: HEMatmul2, rc: RelinContext | None = None,
                 chunk_limbs: int = 0):
        """chunk_limbs: QP limbs per streamed keygen / relinearize chunk
        (0 = auto: one chunk when the full QP accumulator is < 1 GB, else
        ~512 MB chunks)."""
        self.hm = hm
        self.ctx = hm.ctx
        self.rc = rc or RelinContext(hm.ctx)
        self.chunk_limbs = chunk_limbs

    # -- 2D transforms -------------------------------------------------------

    def _ntt2d(self, z, xntt):
        t = xntt.forward(z)
        return jnp.swapaxes(xntt.forward(jnp.swapaxes(t, -1, -2)), -1, -2)

    def _intt2d(self, z, xntt):
        t = xntt.inverse(z)
        return jnp.swapaxes(xntt.inverse(jnp.swapaxes(t, -1, -2)), -1, -2)

    # -- key generation ------------------------------------------------------

    # -- limb chunking (round 5) ---------------------------------------------
    #
    # At ref scale with the dnum=1 auto-P basis, ONE [Lqp, W, m, m] u64
    # plane is 1.7 GB and the keys alone are 6.8 GB: a per-digit jit (whose
    # working set is ~6 such planes) does not fit a 16 GB device in
    # gen_keys.  Every per-limb stage of
    # the pipeline — W-CRT, 2D X-NTT, key products, the dst side of basis
    # extension — is independent across limbs, so both keygen and
    # relinearization stream QP limb chunks through chunk-sized transform
    # contexts, bounding peak HBM at keys + O(chunk) temporaries.

    def _chunk_ctx(self, lo: int, hi: int):
        """(params, xntt, wt, mont-consts) over qp_moduli[lo:hi]."""
        rc = self.rc
        if (lo, hi) == (0, len(rc.qp_moduli)):
            return rc.ext_params, rc.xntt_qp, rc.wt_qp, rc._cqp
        cache = self.__dict__.setdefault("_chunk_ctx_cache", {})
        if (lo, hi) not in cache:
            import dataclasses

            from ..ops.ntt import XNTT
            from ..ops.wcrt import WTransform
            from ..tables import build_tables
            sub = dataclasses.replace(
                rc.ext_params, name=f"{rc.ext_params.name}-c{lo}.{hi}",
                moduli=rc.qp_moduli[lo:hi])
            t = build_tables(sub)
            cache[(lo, hi)] = (sub, XNTT(sub, ring=self.ctx.ring, tables=t),
                               WTransform(sub, t),
                               mm.mont_consts_arrays(sub.moduli,
                                                     shape_suffix=(1, 1, 1)))
        return cache[(lo, hi)]

    def _qp_chunks(self):
        """Limb-chunk bounds over QP, aligned to the Q|P boundary."""
        rc = self.rc
        Lqp = len(rc.qp_moduli)
        per_limb = rc.ext_params.phi * self.hm.m * self.hm.m * 8
        target = self.chunk_limbs
        if target <= 0:
            if Lqp * per_limb <= (1 << 30):
                return [(0, Lqp)]
            target = max(1, (1 << 29) // per_limb)
        bounds = []
        for seg_lo, seg_hi in ((0, rc.L), (rc.L, Lqp)):
            lo = seg_lo
            while lo < seg_hi:
                bounds.append((lo, min(lo + target, seg_hi)))
                lo += target
        return bounds

    def _gen_key_chunk_jit(self, which: int, lo: int, hi: int):
        """One (target, digit) switch-key pair restricted to QP limbs
        lo:hi, fully jitted.  The uniform component is sampled DIRECTLY in
        the (W-eval, 2D X-NTT) domain — the transform is a per-limb
        bijection, so uniform-in-eval == uniform-in-coeff and the 2D NTT
        of a [Lqp, W, m, m] plane disappears from keygen entirely.  Limb
        l's stream is keyed fold_in(ka, l), making the key material
        independent of the chunking."""
        cache = self.__dict__.setdefault("_gen_key_jit_cache", {})
        if (which, lo, hi) in cache:
            return cache[(which, lo, hi)]
        sub, xntt, wt, cc = self._chunk_ctx(lo, hi)
        from . import rng as refrng

        def step(ka, ke, s_hat_c, ss_hat_c, g_c):
            q, qi, r2 = cc["q"], cc["qinv_neg"], cc["r2"]
            Lc, W, m = s_hat_c.shape
            frame = (W, m, m)
            bits = jax.vmap(lambda l: jax.random.bits(
                jax.random.fold_in(ka, l), frame, dtype=jnp.uint64))(
                    jnp.arange(lo, hi))
            a_mont = mm.to_mont(bits % q, q, qi, r2)
            a_s = mm.mont_mul(a_mont, s_hat_c[:, :, None, :], q, qi)
            # gaussian noise is limb-consistent (same z every limb), so the
            # same ke reproduces it identically in every chunk
            e = refrng.fresh_gaussian_noise(ke, sub, shape=frame)
            e_hat = self._ntt2d(wt.forward(e), xntt)
            g_mont = mm.to_mont(g_c.reshape(-1, 1, 1, 1), q, qi, r2)
            if which == 1:
                # g * (sigma(s) (x) 1): broadcast along x2 stays fused
                gt = mm.mont_mul(g_mont, ss_hat_c[:, :, :, None], q, qi)
            else:
                # g * (sigma(s) (x) s)
                ss_mont = mm.to_mont(ss_hat_c, q[..., 0], qi[..., 0],
                                     r2[..., 0])
                t2 = mm.mont_mul(ss_mont[:, :, :, None],
                                 jnp.broadcast_to(s_hat_c[:, :, None, :],
                                                  (Lc, W, m, m)),
                                 q, qi)
                gt = mm.mont_mul(g_mont, t2, q, qi)
            b = mm.add_mod(mm.sub_mod(e_hat, a_s, q), gt, q)
            return mm.to_mont(b, q, qi, r2), a_mont

        cache[(which, lo, hi)] = jax.jit(step)
        return cache[(which, lo, hi)]

    def gen_keys(self, sk: SecretKey2, key: jax.Array) -> GemmRelinKey:
        rc = self.rc
        # s and sigma(s) lifted over QP in (W-eval, X-NTT)
        s_res = Gl2Context._ternary_residues(sk.s_sign,
                                             self.ctx.params.moduli)
        s_hat = rc._lift_ternary(s_res)                     # [Lqp, W, 2n]
        ss_hat = jnp.take(s_hat, self.hm._flip, axis=1)[:, :, ::-1]
        chunks = self._qp_chunks()
        outs = {"b1": [], "a1": [], "b2": [], "a2": []}
        for which, bk, ak in ((1, "b1", "a1"), (2, "b2", "a2")):
            for i in range(rc.dnum):
                key, ka, ke = jax.random.split(key, 3)
                g = jnp.asarray(rc._g_consts[i])
                bs, as_ = [], []
                for lo, hi in chunks:
                    b, a = self._gen_key_chunk_jit(which, lo, hi)(
                        ka, ke, s_hat[lo:hi], ss_hat[lo:hi], g[lo:hi])
                    # fence each chunk so at most one program's working set
                    # is in flight on top of the accumulated keys
                    jax.block_until_ready(a)
                    bs.append(b)
                    as_.append(a)
                outs[bk].append(bs[0] if len(bs) == 1
                                else jnp.concatenate(bs))
                outs[ak].append(as_[0] if len(as_) == 1
                                else jnp.concatenate(as_))
        return GemmRelinKey(b1=tuple(outs["b1"]), a1=tuple(outs["a1"]),
                            b2=tuple(outs["b2"]), a2=tuple(outs["a2"]))

    # -- relinearize + repack ------------------------------------------------

    def relinearize_fn(self, tt: GemmTensor2, ks: GemmRelinKey
                       ) -> Ciphertext2:
        rc = self.rc
        ctx = self.ctx
        cqp = rc._cqp
        q, qi = cqp["q"], cqp["qinv_neg"]
        cq = rc._cq
        wc10 = ctx.wt.inverse(tt.e10)
        wc11 = ctx.wt.inverse(tt.e11)
        accs = [None] * 4   # u0, u1, v0, v1 over QP, NTT domain
        for i, g in enumerate(rc.groups):
            gi = jnp.asarray(list(g))
            for src, b_k, a_k, o0, o1 in ((wc10, ks.b1, ks.a1, 0, 1),
                                          (wc11, ks.b2, ks.a2, 2, 3)):
                digit = rc._extenders[i].extend(src[gi])
                hat = self._ntt2d(rc.wt_qp.forward(digit), rc.xntt_qp)
                tb = mm.mont_mul(hat, b_k[i], q, qi)
                ta = mm.mont_mul(hat, a_k[i], q, qi)
                accs[o0] = tb if accs[o0] is None else mm.add_mod(
                    accs[o0], tb, q)
                accs[o1] = ta if accs[o1] is None else mm.add_mod(
                    accs[o1], ta, q)
        outs = []
        for acc in accs:
            c = rc.wt_qp.inverse(self._intt2d(acc, rc.xntt_qp))
            outs.append(ctx.wt.forward(rc._mod_down(c)))
        u0, u1, v0, v1 = outs
        b2d = mm.add_mod(tt.e00, mm.add_mod(u0, v0, cq["q"]), cq["q"])
        a2d = mm.add_mod(tt.e01, mm.add_mod(u1, v1, cq["q"]), cq["q"])
        return Ciphertext2(b=self.hm.repack_fn(b2d),
                           a=self.hm.repack_fn(a2d))

    @functools.cached_property
    def _relin_jit(self):
        return jax.jit(self.relinearize_fn)

    # -- streamed single-device variant --------------------------------------

    def _relin_chunk_jit(self, lo: int, hi: int):
        """All dnum digits' products for QP limbs lo:hi: (rp_i, k_i) from
        the shared scaled_residues -> extend chunk -> QP transforms ->
        key products -> accumulate -> back to (W-coeff, X-coeff).  Returns
        the chunk rows of the two coefficient-domain accumulators."""
        cache = self.__dict__.setdefault("_relin_chunk_cache", {})
        if (lo, hi) in cache:
            return cache[(lo, hi)]
        rc = self.rc
        _, xntt, wt, cc = self._chunk_ctx(lo, hi)

        def body(rps, ks_, b_keys, a_keys):
            q, qi = cc["q"], cc["qinv_neg"]
            u0 = u1 = None
            for i in range(rc.dnum):
                digit = rc._extenders[i].extend_from(rps[i], ks_[i],
                                                     dst_slice=(lo, hi))
                hat = self._ntt2d(wt.forward(digit), xntt)
                tb = mm.mont_mul(hat, b_keys[i], q, qi)
                ta = mm.mont_mul(hat, a_keys[i], q, qi)
                u0 = tb if u0 is None else mm.add_mod(u0, tb, q)
                u1 = ta if u1 is None else mm.add_mod(u1, ta, q)
            return (wt.inverse(self._intt2d(u0, xntt)),
                    wt.inverse(self._intt2d(u1, xntt)))

        cache[(lo, hi)] = jax.jit(body)
        return cache[(lo, hi)]

    @functools.cached_property
    def _relin_pre_jit(self):
        """wt-inverse of one tensor component + the per-digit src-side
        scaled residues (shared by every chunk).  Donates the component:
        the streamed path consumes the tensor."""
        rc = self.rc

        def pre(e):
            wc = self.ctx.wt.inverse(e)
            rps, ks_ = [], []
            for i, g in enumerate(rc.groups):
                rp, k = rc._extenders[i].scaled_residues(
                    wc[jnp.asarray(list(g))])
                rps.append(rp)
                ks_.append(k)
            return rps, ks_

        return jax.jit(pre, donate_argnums=(0,))

    @functools.cached_property
    def _relin_down_jit(self):
        """ModDown one QP coefficient-domain accumulator -> [L] W-eval
        (donates the 1.7 GB accumulator)."""
        rc, ctx = self.rc, self.ctx

        def down(k):
            return ctx.wt.forward(rc._mod_down(k))

        return jax.jit(down, donate_argnums=(0,))

    @functools.cached_property
    def _relin_combine_jit(self):
        rc = self.rc

        def comb(e_const, u, v):
            q = rc._cq["q"]
            return self.hm.repack_fn(
                mm.add_mod(e_const, mm.add_mod(u, v, q), q))

        return jax.jit(comb)

    @functools.cached_property
    def _write_chunk_jit(self):
        def w(full, part, lo):
            return jax.lax.dynamic_update_slice_in_dim(full, part, lo,
                                                       axis=0)
        return jax.jit(w, donate_argnums=(0,))

    def relinearize_streamed(self, tt: GemmTensor2, ks: GemmRelinKey
                             ) -> Ciphertext2:
        """relinearize_fn with the QP work streamed limb-chunk by
        limb-chunk (same bits as the fused graph given the same tt/ks —
        pinned by tests/test_he_matmul2.py).  Peak HBM = keys + two
        [Lqp, ...] accumulators + ONE chunk's transients, instead of the
        fused program's ~3x-keys working set (sized for a 16 GB device at
        ref scale).  CONSUMES tt.e10/tt.e11
        (donated into the src-side residues)."""
        rc = self.rc
        Lqp = len(rc.qp_moduli)
        W = rc.ext_params.phi
        shape = (Lqp, W, self.hm.m, self.hm.m)
        chunks = self._qp_chunks()
        outs = []
        for e_hi, b_keys, a_keys in ((tt.e10, ks.b1, ks.a1),
                                     (tt.e11, ks.b2, ks.a2)):
            rps, ks_ = self._relin_pre_jit(e_hi)
            k0 = jnp.zeros(shape, dtype=jnp.uint64)
            k1 = jnp.zeros(shape, dtype=jnp.uint64)
            for lo, hi in chunks:
                c0, c1 = self._relin_chunk_jit(lo, hi)(
                    rps, ks_, [b[lo:hi] for b in b_keys],
                    [a[lo:hi] for a in a_keys])
                k0 = self._write_chunk_jit(k0, c0, lo)
                k1 = self._write_chunk_jit(k1, c1, lo)
                # fence: bound in-flight chunk programs to one
                jax.block_until_ready(k1)
            outs.append(self._relin_down_jit(k0))
            outs.append(self._relin_down_jit(k1))
        u0, u1, v0, v1 = outs
        return Ciphertext2(b=self._relin_combine_jit(tt.e00, u0, v0),
                           a=self._relin_combine_jit(tt.e01, u1, v1))

    def _use_streamed(self) -> bool:
        """Stream when the full QP accumulator exceeds 1 GB."""
        rc = self.rc
        per_limb = rc.ext_params.phi * self.hm.m * self.hm.m * 8
        return len(rc.qp_moduli) * per_limb > (1 << 30)

    def relinearize(self, tt: GemmTensor2, ks: GemmRelinKey) -> Ciphertext2:
        if self._use_streamed():
            return self.relinearize_streamed(tt, ks)
        return self._relin_jit(tt, ks)

    # -- the headline op -----------------------------------------------------

    def matmul(self, ctX: Ciphertext2, ctY: Ciphertext2, ks: GemmRelinKey
               ) -> Ciphertext2:
        """encrypt(X), encrypt(Y) -> standard ciphertext of Y^H X (per
        lane), Delta^2-scaled: decode with delta_override=Delta^2."""
        return self.relinearize(self.hm.matmul_tensor(ctX, ctY), ks)
