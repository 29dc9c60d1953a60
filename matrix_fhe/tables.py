"""One-time precomputed tables for a GLParams set.

The reference builds these host-side at init (HE.cu:237-403 init_wntt_tables /
init_wdft_tables, ntt_core.cu:75-198, encoder.cu:329-444):

  * W-CRT Vandermonde V[l][w][r] = eta_l^(exp[w]*r) mod q_l and its inverse.
    The reference Gauss-Jordan-inverts (O(phi^3) per limb, HE.cu:135-185).
    We exploit structure instead: the evaluation points are exactly *all*
    primitive p-th roots of unity, so the master polynomial is the
    cyclotomic Phi_p(X) and V^-1 falls out of Lagrange interpolation in
    O(phi^2) exact integer ops — the modular inverse is unique, so the
    result is bit-identical to the reference's.
  * complex W-DFT matrix and inverse (decode semantics; HE.cu:275-310).
  * X-axis NTT matrices: cyclic DFT_n, negacyclic (psi_2n twist; the
    "phantom" production ring X^n+1) and GL (beta=psi_4n twist, X^n = i ring;
    ntt_core.cu:175-198).
  * GL 5^j-orbit <-> bit-reversal permutation (ntt_core.cu:150-173).
  * sigma-embedding encoder matrices (power-of-5 Vandermonde over 4n-th
    roots; encoder.cu:425-444).
  * exact-CRT big-int tables M_i = Q/q_i, inv_i = M_i^-1 mod q_i, Q, Q/2
    (encoder.cu:341-421).

Heavy parts can optionally be served by the native C++ builder
(native/tablegen.cpp) — results are identical; Python is the fallback and
the oracle.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .config import GLParams
from .ops.modmath import MontConsts, find_eta, find_psi_4n


# ---------------------------------------------------------------------------
# Cyclotomic polynomial and Lagrange inversion
# ---------------------------------------------------------------------------

def _poly_mul(a: List[int], b: List[int]) -> List[int]:
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] += ai * bj
    return out


def _poly_divexact(a: List[int], b: List[int]) -> List[int]:
    """Exact division of integer polynomials (b monic up to +-1 lead)."""
    a = list(a)
    out = [0] * (len(a) - len(b) + 1)
    for k in range(len(out) - 1, -1, -1):
        c = a[k + len(b) - 1] // b[-1]
        out[k] = c
        if c:
            for j, bj in enumerate(b):
                a[k + j] -= c * bj
    assert all(v == 0 for v in a), "inexact polynomial division"
    return out


@functools.lru_cache(maxsize=None)
def cyclotomic_two_primes(p: int, f1: int, f2: int) -> Tuple[int, ...]:
    """Coefficients of Phi_p(X) for p = f1*f2 (distinct odd primes):
    Phi_p = (X^p - 1)(X - 1) / ((X^f1 - 1)(X^f2 - 1))."""
    xp = [-1] + [0] * (p - 1) + [1]
    x1 = [-1, 1]
    num = _poly_mul(xp, x1)
    d1 = [-1] + [0] * (f1 - 1) + [1]
    d2 = [-1] + [0] * (f2 - 1) + [1]
    den = _poly_mul(d1, d2)
    out = _poly_divexact(num, den)
    assert len(out) == (f1 - 1) * (f2 - 1) + 1 and out[-1] == 1
    return tuple(out)


def vandermonde_mod(roots: Sequence[int], q: int) -> np.ndarray:
    """V[w][r] = roots[w]^r mod q, r < len(roots); uint64 [phi, phi]."""
    phi = len(roots)
    v = np.empty((phi, phi), dtype=np.uint64)
    for w, x in enumerate(roots):
        cur = 1
        for r in range(phi):
            v[w, r] = cur
            cur = cur * x % q
    return v


def lagrange_inverse_mod(roots: Sequence[int], master: Sequence[int], q: int
                         ) -> np.ndarray:
    """Inverse of the Vandermonde V[w][r]=x_w^r when the x_w are exactly the
    roots of the monic `master` polynomial (here Phi_p mod q).

    (V^-1)[r][w] = coeff_r( master / (X - x_w) ) * master'(x_w)^-1 mod q.
    """
    phi = len(roots)
    m = [c % q for c in master]
    dm = [(k * m[k]) % q for k in range(1, phi + 1)]  # derivative coeffs
    inv = np.empty((phi, phi), dtype=np.uint64)
    for w, x in enumerate(roots):
        # synthetic division master / (X - x): quotient degree phi-1
        qc = [0] * phi
        qc[phi - 1] = m[phi]  # == 1
        for k in range(phi - 1, 0, -1):
            qc[k - 1] = (m[k] + x * qc[k]) % q
        # master'(x) by Horner
        acc = 0
        for c in reversed(dm):
            acc = (acc * x + c) % q
        s = pow(acc, q - 2, q)
        for r in range(phi):
            inv[r, w] = qc[r] * s % q
    return inv


# ---------------------------------------------------------------------------
# Table container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GLTables:
    """All host-precomputed tables (numpy; device placement happens lazily in
    the ops that consume them)."""

    params: GLParams

    # per-limb roots
    eta: Tuple[int, ...]
    psi4n: Tuple[int, ...]

    # W-CRT (mod q): [L, phi, phi] uint64
    w_fwd: np.ndarray
    w_inv: np.ndarray

    # complex W-DFT: [phi, phi] complex128 (decode semantics, HE.cu:275-310)
    wdft: np.ndarray
    wdft_inv: np.ndarray

    # X-axis transforms: [L, n, n] uint64 (k-major rows: out[k]=sum_x T[k,x] a[x])
    x_fwd_nega: np.ndarray   # negacyclic X^n+1 (production "phantom" ring)
    x_inv_nega: np.ndarray
    x_fwd_gl: np.ndarray     # GL ring X^n = psi4n^n (= +-i)
    x_inv_gl: np.ndarray

    # GL 5^j orbit <-> bit-reversal permutation (ntt_core.cu:150-173)
    gl_perm: np.ndarray      # [n] int32
    gl_inv_perm: np.ndarray

    # sigma-embedding encoder matrices (complex128 [n, n])
    enc_v: np.ndarray        # V[j][k] = zeta_4n^(5^j * k)
    enc_v_inv: np.ndarray    # V^-1[k][j] = conj(zeta^(5^j))^k / n

    # exact CRT compose tables
    crt_limbs64: int                 # big-int width in u64 words (ref: 7)
    crt_m: np.ndarray                # [L, limbs64] uint64 — M_i = Q/q_i
    crt_inv: np.ndarray              # [L] uint64 — M_i^-1 mod q_i
    crt_q_big: np.ndarray            # [limbs64] uint64 — Q
    crt_q_half: np.ndarray           # [limbs64] uint64 — Q >> 1

    @property
    def mont(self) -> Tuple[MontConsts, ...]:
        return tuple(MontConsts.make(int(q)) for q in self.params.moduli)


def _int_to_limbs64(x: int, limbs: int) -> np.ndarray:
    out = np.empty(limbs, dtype=np.uint64)
    for i in range(limbs):
        out[i] = x & 0xFFFFFFFFFFFFFFFF
        x >>= 64
    assert x == 0
    return out


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def build_tables(params: GLParams) -> GLTables:
    n, p = params.n, params.p
    f1, f2 = params.p_factors
    phi = params.phi
    moduli = params.moduli
    L = len(moduli)
    exps = params.w_exponents
    master = cyclotomic_two_primes(p, f1, f2)

    native = _native_builder()

    # ---- W-CRT mod-q tables -------------------------------------------------
    etas = []
    w_fwd = np.empty((L, phi, phi), dtype=np.uint64)
    w_inv = np.empty((L, phi, phi), dtype=np.uint64)
    for l, q in enumerate(moduli):
        eta = find_eta(q, p, f1, f2)
        etas.append(eta)
        roots = [pow(eta, e, q) for e in exps]
        if native is not None:
            v, vi = native.wcrt_tables(q, roots, master)
        else:
            v = vandermonde_mod(roots, q)
            vi = lagrange_inverse_mod(roots, master, q)
        w_fwd[l] = v
        w_inv[l] = vi

    # ---- complex W-DFT ------------------------------------------------------
    ang = 2.0 * np.pi * np.array(exps, dtype=np.float64) / float(p)
    croots = np.cos(ang) + 1j * np.sin(ang)
    wdft = np.empty((phi, phi), dtype=np.complex128)
    for w in range(phi):
        # iterated products, matching the reference's table build
        cur = 1.0 + 0.0j
        for r in range(phi):
            wdft[w, r] = cur
            cur *= croots[w]
    wdft_inv = np.linalg.inv(wdft)

    # ---- X-axis transforms ---------------------------------------------------
    x_fwd_nega = np.empty((L, n, n), dtype=np.uint64)
    x_inv_nega = np.empty((L, n, n), dtype=np.uint64)
    x_fwd_gl = np.empty((L, n, n), dtype=np.uint64)
    x_inv_gl = np.empty((L, n, n), dtype=np.uint64)
    psis = []
    for l, q in enumerate(moduli):
        psi4 = find_psi_4n(q, n)
        psis.append(psi4)
        psi2 = pow(psi4, 2, q)          # order 2n: negacyclic twist
        omega = pow(psi4, 4, q)         # order n: cyclic twiddle
        n_inv = pow(n, q - 2, q)
        om_pows = [pow(omega, k, q) for k in range(n)]
        psi2_pows = [pow(psi2, x, q) for x in range(n)]
        psi4_pows = [pow(psi4, x, q) for x in range(n)]
        psi2_ipows = [pow(psi2_pows[x], q - 2, q) for x in range(n)]
        psi4_ipows = [pow(psi4_pows[x], q - 2, q) for x in range(n)]
        for k in range(n):
            for x in range(n):
                wkx = om_pows[(k * x) % n]
                wikx = om_pows[(-k * x) % n]
                x_fwd_nega[l, k, x] = psi2_pows[x] * wkx % q
                x_inv_nega[l, k, x] = n_inv * psi2_ipows[k] % q * wikx % q
                x_fwd_gl[l, k, x] = psi4_pows[x] * wkx % q
                x_inv_gl[l, k, x] = n_inv * psi4_ipows[k] % q * wikx % q
    # note: inverse tables are [x_out, k_in] shaped — rows indexed by output
    # coefficient; both are consumed as out = T @ in.

    # ---- GL permutation (ntt_core.cu:150-173) -------------------------------
    logn = n.bit_length() - 1
    m4 = 4 * n
    gl_perm = np.zeros(n, dtype=np.int32)
    gl_inv_perm = np.zeros(n, dtype=np.int32)
    e = 1 % m4
    for j in range(n):
        idx = (e - 1) // 4
        tgt = _bit_reverse(idx, logn)
        gl_perm[j] = tgt
        gl_inv_perm[tgt] = j
        e = e * 5 % m4

    # ---- encoder matrices (encoder.cu:425-444) ------------------------------
    enc_v = np.empty((n, n), dtype=np.complex128)
    enc_v_inv = np.empty((n, n), dtype=np.complex128)
    for j in range(n):
        ex = pow(5, j, 4 * n)
        z = np.exp(2j * np.pi * ex / (4.0 * n))
        zi = np.conj(z)
        c = 1.0 + 0.0j
        ci = 1.0 + 0.0j
        for k in range(n):
            enc_v[j, k] = c
            enc_v_inv[k, j] = ci / n
            c *= z
            ci *= zi

    # ---- exact CRT tables (encoder.cu:341-421) ------------------------------
    Q = 1
    for q in moduli:
        Q *= q
    limbs64 = max(1, -(-Q.bit_length() // 64))
    crt_m = np.empty((L, limbs64), dtype=np.uint64)
    crt_inv = np.empty(L, dtype=np.uint64)
    for l, q in enumerate(moduli):
        Mi = Q // q
        crt_m[l] = _int_to_limbs64(Mi, limbs64)
        crt_inv[l] = pow(Mi % q, q - 2, q)

    return GLTables(
        params=params,
        eta=tuple(etas),
        psi4n=tuple(psis),
        w_fwd=w_fwd,
        w_inv=w_inv,
        wdft=wdft,
        wdft_inv=wdft_inv,
        x_fwd_nega=x_fwd_nega,
        x_inv_nega=x_inv_nega,
        x_fwd_gl=x_fwd_gl,
        x_inv_gl=x_inv_gl,
        gl_perm=gl_perm,
        gl_inv_perm=gl_inv_perm,
        enc_v=enc_v,
        enc_v_inv=enc_v_inv,
        crt_limbs64=limbs64,
        crt_m=crt_m,
        crt_inv=crt_inv,
        crt_q_big=_int_to_limbs64(Q, limbs64),
        crt_q_half=_int_to_limbs64(Q >> 1, limbs64),
    )


def _native_builder():
    """Load the C++ table builder if available (matrix_fhe/native)."""
    try:
        from .native import tablegen  # noqa: WPS433
        return tablegen if tablegen.available() else None
    except Exception:
        return None


def build_gl2_x_tables(tables: GLTables) -> Tuple[np.ndarray, np.ndarray]:
    """Dense transform tables for the DOUBLE ring D = Z[X]/(X^{2n} + 1).

    Central identity (this framework's, no reference counterpart): the GL
    ring Z[i][X]/(X^n - i) the reference builds per limb with a modular
    wrap constant i_q (ntt_core.cu:175-198) is isomorphic over the INTEGERS
    to the negacyclic ring of doubled degree,

        Z[i][X]/(X^n - i)  ~=  Z[X]/(X^{2n} + 1),   i |-> X^n,

    (a + b*i coefficients land in slots j and n+j).  Unlike the folded
    per-limb picture, the right-hand side has one global integer coefficient
    ring, so RNS digit decomposition / ModDown — i.e. key switching — is
    valid (the obstruction found in round 2: keyswitch.py:70-77).

    The dim-2n negacyclic NTT needs a primitive 4n-th root: exactly the
    psi_4n the GL twist already requires (config.h's q = 1 mod lcm(4n, p)
    guarantee), so every preset supports it with no new prime constraints.

    Returns (fwd, inv): [L, 2n, 2n] uint64, out = T @ in convention, slot k
    evaluating at psi4n^(2k+1).
    """
    params = tables.params
    n = params.n
    m = 2 * n
    L = len(params.moduli)
    fwd = np.empty((L, m, m), dtype=np.uint64)
    inv = np.empty((L, m, m), dtype=np.uint64)
    for l, q in enumerate(params.moduli):
        q = int(q)
        psi = int(tables.psi4n[l])          # order 4n = 2m: negacyclic twist
        omega = psi * psi % q               # order m: cyclic twiddle
        m_inv = pow(m, q - 2, q)
        om = [pow(omega, k, q) for k in range(m)]
        ps = [pow(psi, x, q) for x in range(m)]
        psi_inv = [pow(x, q - 2, q) for x in ps]
        for k in range(m):
            for x in range(m):
                fwd[l, k, x] = ps[x] * om[(k * x) % m] % q
                inv[l, x, k] = m_inv * psi_inv[x] % q * om[(-k * x) % m] % q
    return fwd, inv
