#!/usr/bin/env python
"""Relinearized homomorphic multiplication at reference parameters.

Activates the P basis the reference reserves but never uses
(config.h:43-52): encrypt two packed messages, tensor-multiply, key-switch
the d2 component with an RNS-hybrid relinearization key, and verify the
resulting STANDARD rank-1 ciphertext decrypts to the exact ring product of
the plaintexts (+ key-switch noise, reported).

Run:  python examples/relinearize.py [preset]     (default "mid")

"mid" = the reference geometry (n=64, phi=512) with a 4-limb chain.

The full 11-limb "ref" chain (dnum=4, ~1.9 GB of relin keys) runs via the
STREAMED key switch (RelinContext.multiply_relinearize_streamed): one jit
step per digit with donated accumulators caps peak HBM at keys + ONE
[14, 512, 64, 64] digit transient (~235 MB) instead of all four, fitting a
16 GB device.  Memory model at ref: ct pair 0.74 GB + keys 1.88 GB +
tensor/accumulators ~1.0 GB + digit transient ~0.7 GB ~= 4.4 GB peak.
Multi-device: the same op is bit-exact under W-lane or RNS-limb sharding
(tests/test_keyswitch.py::test_multidigit_chain_sharded_and_streamed);
limb sharding also distributes the key storage.
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
    from matrix_fhe.models.he import HEContext
    from matrix_fhe.models.keyswitch import RelinContext
    from matrix_fhe.models import rng as refrng
    from matrix_fhe.ops import modmath as mm

    p = get_params(preset)
    print(f"[relin] preset={preset}: n={p.n}, phi={p.phi}, L={len(p.moduli)}, "
          f"P primes={p.p_moduli or 'generated'}")
    t0 = time.time()
    ctx = HEContext(p, ring="nega")
    # MFHE_AUTO_P=1: grid-aware generated P basis instead of the
    # reference's parity-pinned reserved primes — at ref: 14 x 28-bit
    # P, dnum=1, keys 1.88 -> 0.84 GB
    auto_p = os.environ.get("MFHE_AUTO_P") == "1"
    rc = RelinContext(ctx, p_moduli="auto" if auto_p else None)
    sk = ctx.generate_secret_key()
    s_coeff = refrng.ternary_secret(p)
    rlk = rc.gen_relin_key(jnp.asarray(s_coeff), jax.random.key(5))
    jax.block_until_ready(rlk.b[0])
    print(f"[relin] init+keygen {time.time()-t0:.1f}s  "
          f"(dnum={rc.dnum}, groups={rc.groups})")

    rng = np.random.default_rng(9)
    m1 = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 30, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    m2 = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 30, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct1 = ctx.encrypt(m1, sk)
    ct2 = ctx.encrypt(m2, sk)

    # big chains stream the digit loop (bounded peak HBM; see docstring);
    # small chains keep the fused single-jit graph
    # MFHE_RELIN_STREAM=1/0 overrides; default: stream at "ref" (the
    # pinned-P fused graph needs ~7.5 GB of transients there)
    streamed = (os.environ.get("MFHE_RELIN_STREAM")
                or ("1" if preset == "ref" else "0")) != "0"
    mul = (rc.multiply_relinearize_streamed if streamed
           else rc.multiply_relinearize)
    print(f"[relin] path = {'streamed' if streamed else 'fused'}")
    t0 = time.time()
    ct = mul(ct1, ct2, rlk)
    jax.block_until_ready(ct.b)
    print(f"[relin] multiply+relinearize {time.time()-t0:.1f}s "
          f"(first call incl. compile)")
    t0 = time.perf_counter()
    for _ in range(3):
        ct = mul(ct1, ct2, rlk)
    jax.block_until_ready(ct.b)
    print(f"[relin] steady-state multiply+relinearize "
          f"{(time.perf_counter()-t0-0.03)/3*1e3:.1f} ms")

    got = ctx.decrypt_to_eval(ct, sk)
    p1 = ctx.decrypt_to_eval(ct1, sk)
    p2 = ctx.decrypt_to_eval(ct2, sk)
    c4 = ctx._c4
    h1 = ctx.xntt.forward(p1)
    h2 = ctx.xntt.forward(p2)
    want = ctx.xntt.inverse(mm.mont_mul(
        mm.to_mont(h1, c4["q"], c4["qinv_neg"], c4["r2"]), h2,
        c4["q"], c4["qinv_neg"]))
    diff = mm.sub_mod(got, want, c4["q"])
    # key-switch noise, measured in the W-coeff domain at limb 0 (the error
    # element is limb-consistent and small)
    dw = np.asarray(ctx.wt.inverse(diff))
    q0 = int(p.moduli[0])
    v = dw[0].astype(np.int64)
    v = np.where(v > q0 // 2, v - q0, v)
    mag = int(np.abs(v).max())
    print(f"[relin] |relinearization noise| max = {mag} "
          f"(Delta = 2^{int(np.log2(p.delta))}; noise/Delta = "
          f"{mag/p.delta:.2e})")
    ok = mag < (1 << 25)
    print("[relin] PASS" if ok else "[relin] FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
