"""utils/ debug + observability helpers."""

def test_noise_magnitude_utility():
    """utils.debug.noise_magnitude: zero for a zero-noise context, small
    for a real encryption."""
    import numpy as np
    import jax.numpy as jnp

    from matrix_fhe.config import get_params
    from matrix_fhe.models.he import HEContext
    from matrix_fhe.utils import debug as dbg

    p = get_params("tiny")
    rng = np.random.default_rng(5)
    c = rng.integers(0, 1 << 16, size=(p.phi, p.n, p.n))
    for zero_noise, bound in ((True, 0), (False, 10_000)):
        ctx = HEContext(p, ring="nega", zero_noise=zero_noise)
        sk = ctx.generate_secret_key()
        m = ctx.wt.forward(jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli])))
        ct = ctx.encrypt(m, sk)
        mag = dbg.noise_magnitude(ctx, ct, sk, m)
        assert mag <= bound, (zero_noise, mag)
