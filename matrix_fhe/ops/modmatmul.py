"""Exact modular matrix multiplication on integer matmul units.

The reference's hottest loops are dense modular matvecs executed one output
element per CUDA thread with an O(K) `__int128 %` loop:
  * the 512-point W-CRT transform (HE.cu:716-781, wntt_forward/inverse_matrix),
  * the X-axis NTT when written as a matrix (ntt_core.cu:271-338),
  * the homomorphic trace GEMM (trace.cu:77-131, batched_trace.cu:99-158).

These are *matmuls*.  No matmul unit has a modular mode, so we make the
integer product exact by 7-bit chunk decomposition:

    a = sum_i a_i 2^(7i),  b = sum_j b_j 2^(7j),   a_i, b_j in [0,127]

    (A @ B)[w,m] = sum_{i,j} 2^(7(i+j)) * sum_r A_i[w,r] B_j[r,m]

Each inner sum is an int8 x int8 -> int32 dot_general: products are < 2^14
and K <= 2^15 rows keeps the i32 accumulator exact (2^14 * 2^15 < 2^31 with
headroom).  Partial results are grouped by diagonal s = i+j (still exact in
int32 for K <= 2^12; for larger K the per-diagonal sums are widened first)
and folded back mod q with one Montgomery multiply per diagonal against the
precomputed constant 2^(7s) * R mod q.

This gives bit-exact residues while running ~all FLOPs as int8 matmuls.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .modmath import U64, mont_mul, MontConsts

CHUNK_BITS = 7
_CHUNK_MASK = np.uint64((1 << CHUNK_BITS) - 1)


def num_chunks(bits: int, chunk_bits: int = CHUNK_BITS) -> int:
    return -(-bits // chunk_bits)


def chunk_decompose(x: jnp.ndarray, chunks: int, chunk_bits: int = CHUNK_BITS
                    ) -> jnp.ndarray:
    """Split uint64 array into `chunks` int8 planes; output [chunks, *x.shape]."""
    planes = [((x >> np.uint64(chunk_bits * i)) & np.uint64((1 << chunk_bits) - 1)
               ).astype(jnp.int8) for i in range(chunks)]
    return jnp.stack(planes, axis=0)


def pow2r_table(moduli: Sequence[int], total_chunks: int,
                chunk_bits: int = CHUNK_BITS, shape_suffix=(1, 1)) -> jnp.ndarray:
    """[S, L, 1, 1] uint64 table of 2^(chunk_bits*s) * R mod q_l (Montgomery
    form of the chunk radix powers)."""
    rows = []
    for s in range(total_chunks):
        row = []
        for q in moduli:
            r_mod = (1 << 64) % q
            row.append((1 << (chunk_bits * s)) * r_mod % q)
        rows.append(row)
    arr = np.array(rows, dtype=np.uint64)
    return jnp.asarray(arr.reshape((total_chunks, len(moduli)) + tuple(shape_suffix)))


def _dot_i8(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched int8 matmul with exact int32 accumulation: [B,W,R]@[B,R,M]."""
    return jax.lax.dot_general(
        a, b,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )


def _dot_i8_rhs(d: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """[B,M,X] x [B,K,X] -> [B,M,K] contracting the shared last axis."""
    return jax.lax.dot_general(
        d, t,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )


def modmatmul_chunked(table_chunks: jnp.ndarray,
                      data_chunks: jnp.ndarray,
                      q: jnp.ndarray,
                      qinv_neg: jnp.ndarray,
                      pow2r: jnp.ndarray,
                      widen: bool = False) -> jnp.ndarray:
    """Exact (table @ data) mod q from pre-chunked int8 operands.

    table_chunks: [ct, B, W, R] int8    (B = modulus batch, e.g. RNS limbs)
    data_chunks:  [cd, B, R, M] int8
    q, qinv_neg:  [B, 1, 1] uint64
    pow2r:        [ct+cd-1, B, 1, 1] uint64 — 2^(7s)*R mod q
    widen:        accumulate diagonals in uint64 instead of int32 (needed
                  when R * 127^2 * min(ct,cd) could exceed 2^31).
    Returns [B, W, M] uint64, fully reduced mod q.
    """
    ct = table_chunks.shape[0]
    cd = data_chunks.shape[0]
    n_diag = ct + cd - 1
    diags = [None] * n_diag
    for i in range(ct):
        for j in range(cd):
            p = _dot_i8(table_chunks[i], data_chunks[j])
            if widen:
                p = p.astype(U64)
            s = i + j
            diags[s] = p if diags[s] is None else diags[s] + p

    out = None
    for s in range(n_diag):
        d = diags[s].astype(U64) if not widen else diags[s]
        term = mont_mul(d, pow2r[s], q, qinv_neg)
        out = term if out is None else jnp.where(out + term >= q,
                                                 out + term - q, out + term)
    return out


def modmatmul(table: jnp.ndarray, data: jnp.ndarray,
              moduli: Sequence[int],
              table_bits: int, data_bits: int,
              chunk_bits: int = CHUNK_BITS) -> jnp.ndarray:
    """Convenience wrapper chunking both operands on the fly.

    table: [B, W, R] uint64, data: [B, R, M] uint64 with B == len(moduli).
    """
    ct = num_chunks(table_bits, chunk_bits)
    cd = num_chunks(data_bits, chunk_bits)
    B = len(moduli)
    consts = _matmul_consts(tuple(int(m) for m in moduli), ct + cd - 1, chunk_bits)
    k = table.shape[-1]
    widen = k * (127 ** 2) * min(ct, cd) >= (1 << 31)
    return modmatmul_chunked(
        chunk_decompose(table, ct, chunk_bits),
        chunk_decompose(data, cd, chunk_bits),
        consts["q"], consts["qinv_neg"], consts["pow2r"], widen=widen)


def limb_runs(moduli: Sequence[int], chunk_bits: int = CHUNK_BITS):
    """Contiguous runs of limbs with equal chunk count: [(lo, hi, chunks)]."""
    bits = [int(q).bit_length() for q in moduli]
    chunks = [num_chunks(b, chunk_bits) for b in bits]
    runs = []
    start = 0
    for i in range(1, len(moduli) + 1):
        if i == len(moduli) or chunks[i] != chunks[start]:
            runs.append((start, i, chunks[start]))
            start = i
    return runs


class BatchedModTransform:
    """A fixed per-limb modular linear transform as chunked int8 matmuls.

    Holds pre-chunked int8 copies of the transform tables T[l] (one matrix
    per RNS limb), with limbs grouped into runs of equal chunk count so a
    45-bit limb doesn't force 7x7 chunk products onto the 35-bit limbs.

    side='left':  out[l, w, m] = sum_r T[l][w, r] * D[l, r, m]   (W-CRT)
    side='right': out[l, m, k] = sum_x D[l, m, x] * T[l][k, x]   (X-NTT,
                  contracting the trailing coefficient axis with no data
                  transpose)
    """

    def __init__(self, tables_u64: np.ndarray, moduli: Sequence[int],
                 side: str = "left", chunk_bits: int = CHUNK_BITS):
        assert side in ("left", "right")
        assert tables_u64.shape[0] == len(moduli)
        self.side = side
        self.chunk_bits = chunk_bits
        # contraction length: T's trailing axis in both orientations
        self.contract_len = tables_u64.shape[2]
        runs = limb_runs(moduli, chunk_bits)
        self._runs = []
        for lo, hi, c in runs:
            run_moduli = tuple(int(q) for q in moduli[lo:hi])
            tbl = jnp.asarray(tables_u64[lo:hi])
            self._runs.append({
                "lo": lo, "hi": hi, "chunks": c,
                "table_chunks": chunk_decompose(tbl, c, chunk_bits),
                "consts": _matmul_consts(run_moduli, 2 * c - 1, chunk_bits),
            })

    def __call__(self, data: jnp.ndarray) -> jnp.ndarray:
        """data: [L, R, M] (left) or [L, M, R] (right) uint64 -> same shape
        with the transformed axis replaced by the table's output axis."""
        outs = []
        for run in self._runs:
            d = data[run["lo"]:run["hi"]]
            c = run["chunks"]
            dch = chunk_decompose(d, c, self.chunk_bits)
            widen = self.contract_len * (127 ** 2) * c >= (1 << 31)
            outs.append(_apply_chunked(
                run["table_chunks"], dch, run["consts"], self.side, widen))
        return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


def chunked_dot_combine(tch, dch, dot_fn, consts, widen,
                        chunk_bits: int = CHUNK_BITS,
                        diag_bound_bits: int = 26):
    """Generic exact chunked product: dot_fn contracts one int8 table chunk
    against one int8 data chunk; diagonals are folded mod q via Montgomery.

    Lean combine: consecutive diagonals are first packed into uint64
    "groups" with plain shifts/adds —

        G = sum_{s in group} S_s * 2^(chunk_bits*(s-s0))   (exact, < 2^63)

    — so only ONE Montgomery multiply per group (against 2^(7*s0)*R mod q)
    touches the modular domain, instead of one per diagonal.  With 26-bit
    diagonal bounds and 7-bit chunks a group holds up to 6 diagonals, cutting
    the element-wise u64 work ~4x.

    consts entries must broadcast against dot_fn's output shape; "pow2r" is
    indexed by diagonal s."""
    ct, cd = tch.shape[0], dch.shape[0]
    n_diag = ct + cd - 1
    diags = [None] * n_diag
    for i in range(ct):
        for j in range(cd):
            p = dot_fn(tch[i], dch[j])
            if widen:
                p = p.astype(U64)
            s = i + j
            diags[s] = p if diags[s] is None else diags[s] + p
    q = consts["q"]
    qinv = consts["qinv_neg"]
    pow2r = consts["pow2r"]
    # max diagonals per group so the packed value stays < 2^63
    bound = 40 if widen else diag_bound_bits
    per_group = max(1, (63 - bound - 1) // chunk_bits + 1)
    out = None
    for g0 in range(0, n_diag, per_group):
        grp = None
        for k, s in enumerate(range(g0, min(g0 + per_group, n_diag))):
            d = diags[s].astype(U64) if not widen else diags[s]
            d = d << np.uint64(chunk_bits * k) if k else d
            grp = d if grp is None else grp + d
        term = mont_mul(grp, pow2r[g0], q, qinv)
        if out is None:
            out = term
        else:
            t2 = out + term
            out = jnp.where(t2 >= q, t2 - q, t2)
    return out


def _apply_chunked(tch, dch, consts, side, widen):
    if side == "left":
        dot_fn = lambda t, d: _dot_i8(t, d)  # noqa: E731
    else:
        dot_fn = lambda t, d: _dot_i8_rhs(d, t)  # noqa: E731
    return chunked_dot_combine(tch, dch, dot_fn, consts, widen)


def _matmul_consts(moduli: tuple, total_chunks: int, chunk_bits: int):
    qs = np.array(moduli, dtype=np.uint64).reshape(len(moduli), 1, 1)
    qinv = np.array([MontConsts.make(int(q)).qinv_neg for q in moduli],
                    dtype=np.uint64).reshape(len(moduli), 1, 1)
    return {
        "q": jnp.asarray(qs),
        "qinv_neg": jnp.asarray(qinv),
        "pow2r": pow2r_table(moduli, total_chunks, chunk_bits),
    }

