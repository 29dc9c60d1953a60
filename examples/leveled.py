#!/usr/bin/env python
"""Leveled homomorphic computation with automatic scale management.

Drives models/leveled.py (the SEAL-style context chain) through a depth-2
circuit at reference geometry:

    z = x * y            (relinearized, scale Delta^2)
    z = rescale(z)       (level 1, scale Delta^2 / q_dropped)
    w = z * mod_switch(x, 1)
    w = rotate(w, j)     (Galois at the reduced level; full=log-size keys)

and verifies the result against the exact plaintext ring oracle.

Run:  python examples/leveled.py [preset]      (default "mid")
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
    from matrix_fhe.models.leveled import LeveledChain
    from matrix_fhe.models.keyswitch import w_automorphism_perm
    from matrix_fhe.ops import modmath as mm

    p = get_params(preset)
    t0 = time.time()
    chain = LeveledChain(p, ring="nega", key=jax.random.key(0))
    print(f"[leveled] preset={preset}: chain depth {chain.depth}, "
          f"P basis {[int(q).bit_length() for q in chain.rc(0).p_moduli]}"
          f" (dnum={chain.rc(0).dnum})")

    rng = np.random.default_rng(3)

    def msg():
        c = rng.integers(0, 1 << 16, size=(p.phi, p.n, p.n))
        return chain.ctx(0).wt.forward(jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli])))

    x, y = chain.encrypt(msg()), chain.encrypt(msg())
    print(f"[leveled] init+keys+encrypt {time.time()-t0:.1f}s")

    t0 = time.time()
    z = chain.multiply(x, y)
    zr = chain.rescale(z)
    w = chain.multiply(zr, chain.mod_switch(x, 1))
    j = next(c for c in range(2, p.p) if np.gcd(c, p.p) == 1)
    w = chain.rotate(w, j, full=True)
    got = chain.decrypt_to_eval(w)
    jax.block_until_ready(got)
    print(f"[leveled] depth-2 + rotate + decrypt {time.time()-t0:.1f}s "
          f"(level {w.level}, scale 2^{np.log2(w.scale):.1f})")

    # plaintext oracle on the same chain contexts
    def ring_mul(cx, a, b):
        c4 = cx._c4
        ha, hb = cx.xntt.forward(a), cx.xntt.forward(b)
        return cx.xntt.inverse(mm.mont_mul(
            mm.to_mont(ha, c4["q"], c4["qinv_neg"], c4["r2"]), hb,
            c4["q"], c4["qinv_neg"]))

    c0, c1 = chain.ctx(0), chain.ctx(1)
    px = c0.decrypt_to_eval(x.ct, chain.sk(0))
    py = c0.decrypt_to_eval(y.ct, chain.sk(0))
    pz = c1.decrypt_to_eval(zr.ct, chain.sk(1))  # includes rescale rounding
    want = ring_mul(c1, pz, px[:-1])
    perm = w_automorphism_perm(chain.params_at(1), j)
    want = want[:, jnp.asarray(perm)]
    diff = mm.sub_mod(got, want, c1._c4["q"])
    from matrix_fhe.utils.debug import composed_magnitude
    mag = composed_magnitude(c1, diff)  # exact bigint noise meter
    ok = mag < 1 << 40
    print(f"[leveled] |ct - oracle| composed max = {mag} "
          f"({'OK' if ok else 'FAIL'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
