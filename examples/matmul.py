#!/usr/bin/env python
"""Homomorphic matrix-multiplication demo at reference parameters.

Encrypts two batches of 512 packed 64x64 complex matrices, runs the
homomorphic trace-GEMM tensor op (the capability the reference exports but
never exercises, trace.cuh/batched_trace.cuh), decrypts with the two-sided
key action, and checks  C == Y^H @ X  per lane.

Run:  python examples/matmul.py  [preset]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    preset = sys.argv[1] if len(sys.argv) > 1 else "ref"
    import jax
    import jax.numpy as jnp
    import numpy as np

    from matrix_fhe.config import get_params
    from matrix_fhe.models.he import HEContext
    from matrix_fhe.models.he_matmul import HEMatmul

    p = get_params(preset)
    print(f"[matmul] preset={preset}: n={p.n}, phi={p.phi}, L={len(p.moduli)}")
    t0 = time.time()
    ctx = HEContext(p, ring="gl")
    hm = HEMatmul(ctx)
    sk = ctx.generate_secret_key(key=jax.random.key(3))
    print(f"[matmul] init {time.time()-t0:.1f}s")

    rng = np.random.default_rng(7)
    W, n = p.phi, p.n
    A = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    B = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))

    t0 = time.time()
    pA = ctx.batched_encoder.encode_to_wntt_eval(
        jnp.asarray(A.real), jnp.asarray(A.imag))
    pB = ctx.batched_encoder.encode_to_wntt_eval(
        jnp.asarray(B.real), jnp.asarray(B.imag))
    ctA = ctx.encrypt_pair(*pA, sk, key=jax.random.key(11))
    ctB = ctx.encrypt_pair(*pB, sk, key=jax.random.key(12))
    jax.block_until_ready(ctA)
    print(f"[matmul] encode+encrypt {time.time()-t0:.1f}s")

    t0 = time.time()
    tt = hm.matmul(ctA, ctB)
    jax.block_until_ready(tt.e0_re)
    t_gemm = time.time() - t0
    t0 = time.time()
    dr, di = hm.decrypt_and_decode(tt, sk)
    jax.block_until_ready(dr)
    t_dec = time.time() - t0

    C = np.asarray(dr) + 1j * np.asarray(di)
    ref = np.conj(np.swapaxes(B, 1, 2)) @ A
    err = np.abs(C - ref).max()
    print(f"[matmul] homomorphic GEMM {t_gemm*1e3:.1f} ms "
          f"(first call incl. compile), decrypt+decode {t_dec*1e3:.1f} ms")
    print(f"[matmul] max |C - Y^H X| = {err:.3e}  "
          f"(ref magnitude {np.abs(ref).max():.2f})")
    ok = err < (1e-4 if preset == "ref" else 0.5)
    print("[matmul] PASS" if ok else "[matmul] FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
