

def test_plaintext_ops_exact():
    """multiply_plain / add_plain: EXACT ring identities (no fresh noise):
    decrypt(ct (*) m) == decrypt(ct) (*) m and decrypt(ct + m) ==
    decrypt(ct) + m, bit-for-bit."""
    import numpy as np
    import jax.numpy as jnp

    from matrix_fhe.config import get_params
    from matrix_fhe.models.he import HEContext
    from matrix_fhe.ops import modmath as mm

    p = get_params("tiny")
    ctx = HEContext(p, ring="nega")
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(77)

    def elem(bits):
        c = rng.integers(0, 1 << bits, size=(p.phi, p.n, p.n))
        return jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli]))

    msg = ctx.wt.forward(elem(16))
    m = ctx.wt.forward(elem(12))
    ct = ctx.encrypt(msg, sk)
    c4 = ctx._c4
    q, qi, r2 = c4["q"], c4["qinv_neg"], c4["r2"]

    got = ctx.decrypt_to_eval(ctx.multiply_plain(ct, m), sk)
    plain = ctx.decrypt_to_eval(ct, sk)
    hm = mm.to_mont(ctx.xntt.forward(m), q, qi, r2)
    want = ctx.xntt.inverse(mm.mont_mul(ctx.xntt.forward(plain), hm, q, qi))
    assert (np.asarray(got) == np.asarray(want)).all()

    got2 = ctx.decrypt_to_eval(ctx.add_plain(ct, m), sk)
    want2 = mm.add_mod(plain, m, q)
    assert (np.asarray(got2) == np.asarray(want2)).all()
