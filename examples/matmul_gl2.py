#!/usr/bin/env python
"""Ciphertext-in / ciphertext-out homomorphic matrix multiplication.

The round-3 flagship: encrypt two batches of phi packed n x n complex
matrices in the gl2 double ring (models/he2.py — Z[X]/(X^{2n}+1), the
integral form of the reference's folded GL ring), run the 2D trace-GEMM
tensor op, RELINEARIZE it with the GemmRelinKey pair (models/he_matmul2.py,
Gl2GemmRelin), and decrypt the resulting STANDARD rank-1 ciphertext with
the plain secret key:  decode(decrypt(ct_out)) == Y^H @ X per lane.

The reference exports its trace kernels but never runs them against
encryption (trace.cuh:11-25, SURVEY 2.13); its folded ring admits no key
switching at all, so this op has no reference counterpart.

Run:  python examples/matmul_gl2.py [preset]      (default "mid")

"mid" = reference geometry (n=64, phi=512, doubled X axis m=128) on a
4-limb chain.  Memory at full "ref" (Lqp=14, dnum=4): the two switch-key
families alone are dnum*2 * [14, 512, 128, 128] u64 ~ 7.5 GB — use the
streamed/sharded key-switch paths (examples/relinearize.py) for that
chain; "mid" fits one device comfortably.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    preset = sys.argv[1] if len(sys.argv) > 1 else "mid"
    import jax
    import jax.numpy as jnp
    import numpy as np

    from matrix_fhe.config import get_params
    from matrix_fhe.models.he2 import Gl2Context
    from matrix_fhe.models.he_matmul2 import Gl2GemmRelin, HEMatmul2

    p = get_params(preset)
    print(f"[gl2-gemm] preset={preset}: n={p.n} (m={2*p.n}), phi={p.phi}, "
          f"L={len(p.moduli)}")
    t0 = time.time()
    ctx = Gl2Context(p)
    hm = HEMatmul2(ctx)
    # MFHE_AUTO_P=1: grid-aware generated P basis (dnum=1) instead of a
    # preset-pinned one — REQUIRED at "ref" scale: the pinned parity P
    # gives dnum=4 and ~27 GB of [m, m]-grid switch keys (4x HBM); the
    # auto basis fits one device (~6.7 GB keys at Lqp=25)
    if os.environ.get("MFHE_AUTO_P") == "1":
        from matrix_fhe.models.keyswitch import RelinContext
        gr = Gl2GemmRelin(hm, RelinContext(ctx, p_moduli="auto"))
    else:
        gr = Gl2GemmRelin(hm)
    sk = ctx.generate_secret_key(jax.random.key(1))
    ks = gr.gen_keys(sk, jax.random.key(9))
    jax.block_until_ready(ks.b1)
    print(f"[gl2-gemm] init + switch-key gen {time.time()-t0:.1f}s "
          f"(dnum={gr.rc.dnum})")

    rng = np.random.default_rng(7)
    W, n = p.phi, p.n
    X = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    Y = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    C = np.conj(np.swapaxes(Y, -1, -2)) @ X

    t0 = time.time()
    ctX = ctx.encrypt(ctx.encode(jnp.asarray(X.real), jnp.asarray(X.imag)),
                      sk, jax.random.key(2))
    ctY = ctx.encrypt(ctx.encode(jnp.asarray(Y.real), jnp.asarray(Y.imag)),
                      sk, jax.random.key(4))
    jax.block_until_ready(ctX.b)
    print(f"[gl2-gemm] encode+encrypt {time.time()-t0:.1f}s")

    # GEMM -> relinearize -> standard ciphertext (first call compiles)
    t0 = time.time()
    ct_out = gr.matmul(ctX, ctY, ks)
    jax.block_until_ready(ct_out.b)
    print(f"[gl2-gemm] gemm+relin first(+compile) {time.time()-t0:.1f}s")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        ct_out = gr.matmul(ctX, ctY, ks)
    jax.block_until_ready(ct_out.b)
    dt = (time.perf_counter() - t0) / iters
    print(f"[gl2-gemm] gemm+relin steady {dt*1e3:.1f} ms "
          f"({W} lanes of {n}x{n} complex GEMM)")

    t0 = time.time()
    dr, di = ctx.decrypt_and_decode(ct_out, sk,
                                    delta_override=float(p.delta) ** 2)
    err = np.hypot(np.asarray(dr) - C.real, np.asarray(di) - C.imag).max()
    rel = err / np.abs(C).max()
    print(f"[gl2-gemm] decrypt+decode {time.time()-t0:.1f}s")
    # baseline: the two-sided tensor decrypt (no relinearization) — the
    # additional error of the standard-ciphertext path is pure key-switch
    # noise and must stay within ~2x of it (tests/test_he_matmul2.py)
    tt = hm.matmul_tensor(ctX, ctY)
    br, bi = ctx.decode(hm.decrypt_tensor_fn(tt, sk),
                        delta_override=float(p.delta) ** 2)
    base_err = np.hypot(np.asarray(br) - C.real,
                        np.asarray(bi) - C.imag).max()
    print(f"[gl2-gemm] max err {err:.3e} (rel {rel:.3e}) vs Y^H X; "
          f"two-sided baseline {base_err:.3e}")
    ok = err < 2 * base_err + 0.1
    print(f"[gl2-gemm] {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
