"""Homomorphic matrix-multiplication primitive via the algebraic field trace.

Port of src/core/trace.cu (single lane) and src/core/batched_trace.cu
(blockIdx.z = W lane) — C = A * (B')^T over Gaussian-integer RNS where
B' = conj(B(X^-1, Y)) under the X^n = i twist (Theorems 3.8/3.9 per
batched_trace.cuh:8-9).  Exported-but-never-called in the reference; here it
is a first-class batched op:

  * map_b_to_bprime: row permutation j -> (-j mod n), conjugation, and the
    -i scalar on off-diagonal rows (map_Bprime_Xinv_twist_kernel,
    trace.cu:30-73);
  * trace_gemm: n * A @ (B')^T as complex modular GEMMs via the exact
    chunked-int8 machinery (vs. the reference's naive per-thread O(n)
    loop, trace.cu:77-131);
  * rescale_by_delta: per-limb multiply by Delta^-1 (trace.cu:132-161).

Inputs are limb-major [L, ..., n, n] uint64 (any batch dims between the limb
axis and the matrix axes — e.g. [L, W, n, n] for the batched variant).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GLParams
from ..ops import modmath as mm
from ..ops.modmatmul import (chunk_decompose, chunked_dot_combine,
                             limb_runs, pow2r_table)


def map_b_to_bprime(b_re: jnp.ndarray, b_im: jnp.ndarray, params: GLParams
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """B -> B' (conj + X^-1 twist).  [L, ..., n(row j), n(col k)] uint64."""
    n = params.n
    q = _q_bcast(params, b_re.ndim)
    # dst row j_dst receives src row (n - j_dst) mod n
    src = (-np.arange(n)) % n
    a = jnp.take(b_re, jnp.asarray(src), axis=-2)
    b = jnp.take(b_im, jnp.asarray(src), axis=-2)
    is_row0 = (np.arange(n) == 0).reshape((1,) * (b_re.ndim - 2) + (n, 1))
    is_row0 = jnp.asarray(is_row0)
    bp_re = jnp.where(is_row0, a, mm.neg_mod(b, q))
    bp_im = jnp.where(is_row0, mm.neg_mod(b, q), mm.neg_mod(a, q))
    return bp_re, bp_im


def trace_gemm(a_re, a_im, bp_re, bp_im, params: GLParams
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """C = n * A @ (B')^T, complex modular, exact.

    out[.., row, col] = n * sum_t A[.., row, t] * B'[.., col, t] mod q
    (trace_gemm_ABpT_rns_kernel contracts the shared column index t).
    """
    moduli = params.moduli
    n = params.n
    outs_r, outs_i = [], []
    for lo, hi, c in limb_runs(moduli):
        run_mod = tuple(int(q) for q in moduli[lo:hi])
        sl = slice(lo, hi)
        rr = _cgemm_run(a_re[sl], a_im[sl], bp_re[sl], bp_im[sl],
                        run_mod, c, a_re.ndim)
        outs_r.append(rr[0])
        outs_i.append(rr[1])
    c_re = jnp.concatenate(outs_r) if len(outs_r) > 1 else outs_r[0]
    c_im = jnp.concatenate(outs_i) if len(outs_i) > 1 else outs_i[0]
    # scale by n (mod q), matching trace.cu:116-118
    consts = mm.mont_consts_arrays(moduli, shape_suffix=(1,) * (a_re.ndim - 1))
    n_mont = _scalar_mont(moduli, n, a_re.ndim)
    c_re = mm.mont_mul(c_re, n_mont, consts["q"], consts["qinv_neg"])
    c_im = mm.mont_mul(c_im, n_mont, consts["q"], consts["qinv_neg"])
    return c_re, c_im


def rescale_by_delta(c_re, c_im, params: GLParams,
                     inv: Sequence[int] | None = None):
    """Multiply by Delta^-1 mod q per limb (rescale_by_delta_rns).  By default
    the exact per-limb inverse of Delta is used for every limb (the reference
    API plumbs only three scalars and zeros the rest, trace.cu:146-160)."""
    moduli = params.moduli
    if inv is None:
        d = int(params.delta)
        inv = [pow(d % q, -1, q) for q in moduli]
    consts = mm.mont_consts_arrays(moduli, shape_suffix=(1,) * (c_re.ndim - 1))
    shape = (len(moduli),) + (1,) * (c_re.ndim - 1)
    inv_mont = jnp.asarray(np.array(
        [int(v) * ((1 << 64) % q) % q for v, q in zip(inv, moduli)],
        dtype=np.uint64).reshape(shape))
    return (mm.mont_mul(c_re, inv_mont, consts["q"], consts["qinv_neg"]),
            mm.mont_mul(c_im, inv_mont, consts["q"], consts["qinv_neg"]))


def trace_matmul(a_re, a_im, b_re, b_im, params: GLParams, rescale=True):
    """Full homomorphic-GEMM plaintext primitive: map, GEMM, rescale."""
    bp_re, bp_im = map_b_to_bprime(b_re, b_im, params)
    c_re, c_im = trace_gemm(a_re, a_im, bp_re, bp_im, params)
    if rescale:
        c_re, c_im = rescale_by_delta(c_re, c_im, params)
    return c_re, c_im


# ---------------------------------------------------------------------------


def _q_bcast(params: GLParams, ndim: int) -> jnp.ndarray:
    q = np.array(params.moduli, dtype=np.uint64)
    return jnp.asarray(q.reshape((len(q),) + (1,) * (ndim - 1)))


def _scalar_mont(moduli, value: int, ndim: int) -> jnp.ndarray:
    shape = (len(moduli),) + (1,) * (ndim - 1)
    vals = [value % q * ((1 << 64) % q) % q for q in moduli]
    return jnp.asarray(np.array(vals, dtype=np.uint64).reshape(shape))


def _cgemm_run(ar, ai, br, bi, run_mod, chunks, ndim):
    """Complex modular GEMM for one equal-chunk-count limb run.

    Shapes [g, ..., n, n]; contraction over the last axis of both operands.
    """
    batch_axes = tuple(range(ndim - 2))
    dims = (((ndim - 1,), (ndim - 1,)), (batch_axes, batch_axes))

    def dot_fn(x, y):
        return jax.lax.dot_general(x, y, dims,
                                   preferred_element_type=jnp.int32)

    qs = np.array(run_mod, dtype=np.uint64)
    suffix = (1,) * (ndim - 1)
    consts = {
        "q": jnp.asarray(qs.reshape((len(run_mod),) + suffix)),
        "qinv_neg": jnp.asarray(np.array(
            [mm.MontConsts.make(q).qinv_neg for q in run_mod],
            dtype=np.uint64).reshape((len(run_mod),) + suffix)),
        "pow2r": pow2r_table(run_mod, 2 * chunks - 1,
                             shape_suffix=suffix),
    }
    arc = chunk_decompose(ar, chunks)
    aic = chunk_decompose(ai, chunks)
    brc = chunk_decompose(br, chunks)
    bic = chunk_decompose(bi, chunks)
    k = ar.shape[-1]
    widen = k * (127 ** 2) * chunks >= (1 << 31)
    arbr = chunked_dot_combine(arc, brc, dot_fn, consts, widen)
    aibi = chunked_dot_combine(aic, bic, dot_fn, consts, widen)
    arbi = chunked_dot_combine(arc, bic, dot_fn, consts, widen)
    aibr = chunked_dot_combine(aic, brc, dot_fn, consts, widen)
    q = consts["q"]
    return (mm.sub_mod(arbr, aibi, q), mm.add_mod(arbi, aibr, q))
