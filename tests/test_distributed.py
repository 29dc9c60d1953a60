"""Multi-device validation on the virtual 8-CPU mesh:

  * coefficient-sharded four-step NTT == single-device result, bit-exact
  * dp x tp sharded full pipeline == unsharded pipeline
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.models.he import HEContext
from matrix_fhe.ops.ntt_large import (FourStepNTT, FourStepPlan,
                                          generate_primes_1mod)
from matrix_fhe.parallel import mesh as meshlib
from matrix_fhe.parallel.dist_ntt import DistFourStepNTT
from matrix_fhe.parallel.pipeline import ShardedPipeline


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_dist_ntt_matches_single_device(rng):
    primes = generate_primes_1mod(2, 35, 1 << 11)
    plan = FourStepPlan.make(1024, primes, negacyclic=True)
    mesh = meshlib.make_mesh({"coeff": 8})
    dist = DistFourStepNTT(plan, mesh)
    single = FourStepNTT(plan)
    x = np.stack([rng.integers(0, q, size=(2, 1024), dtype=np.uint64)
                  for q in primes])
    xj = jnp.asarray(x)
    f_dist = np.asarray(dist.forward(xj))
    f_single = np.asarray(single.forward(xj))
    assert (f_dist == f_single).all()
    back = np.asarray(dist.inverse(jnp.asarray(f_dist)))
    assert (back == x).all()


@pytest.mark.parametrize("d", [2, 4, 8])
def test_dist_ntt_coeff_mesh_sizes(rng, d):
    """Coefficient meshes of 2, 4 and 8 devices at N=4096 (n1 = n2 = 64):
    bit-exact against the single-device transform, exact roundtrip."""
    primes = generate_primes_1mod(2, 35, 1 << 13)
    plan = FourStepPlan.make(4096, primes)
    dist = DistFourStepNTT(plan, meshlib.make_mesh({"coeff": d}))
    x = jnp.asarray(np.stack([rng.integers(0, q, size=(2, plan.n),
                                           dtype=np.uint64)
                              for q in primes]))
    f = dist.forward(x)
    assert (np.asarray(f) == np.asarray(FourStepNTT(plan).forward(x))).all()
    assert (np.asarray(dist.inverse(f)) == np.asarray(x)).all()


def test_sharded_pipeline_matches_unsharded():
    p = get_params("tiny")  # W = 8 lanes -> tp=4 shards of 2
    ctx = HEContext(p)
    sk = ctx.generate_secret_key()
    mesh = meshlib.make_mesh({"dp": 2, "tp": 4})
    sp = ShardedPipeline(ctx, mesh)
    rng = np.random.default_rng(21)
    B = 4
    re = rng.uniform(-2, 2, size=(B, p.phi, p.n, p.n))
    im = rng.uniform(-2, 2, size=(B, p.phi, p.n, p.n))
    dr, di = sp.roundtrip(jnp.asarray(re), jnp.asarray(im), sk)
    # unsharded single-message reference
    dr0, di0 = ctx.roundtrip(jnp.asarray(re[0]), jnp.asarray(im[0]), sk)
    np.testing.assert_allclose(np.asarray(dr)[0], np.asarray(dr0),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(di)[0], np.asarray(di0),
                               rtol=0, atol=1e-9)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    assert err < 0.5


def test_mesh_factoring():
    assert meshlib.factor_mesh(8) == {"dp": 2, "tp": 4}
    assert meshlib.factor_mesh(1) == {"dp": 1, "tp": 1}
    assert meshlib.factor_mesh(7) == {"dp": 1, "tp": 7}


def test_keyswitch_sharded_matches_unsharded(rng):
    """Relinearized multiply under a W-sharded mesh == replicated result,
    bit-exact (GSPMD places the W-contraction collectives)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from matrix_fhe.models.he import Ciphertext
    from matrix_fhe.models.keyswitch import RelinContext
    from matrix_fhe.models import rng as refrng

    p = get_params("tiny")
    ctx = HEContext(p, ring="nega")
    rc = RelinContext(ctx)
    sk = ctx.generate_secret_key()
    rlk = rc.gen_relin_key(
        jnp.asarray(refrng.ternary_secret(p)), jax.random.key(5))
    c = rng.integers(0, 1 << 16, size=(p.phi, p.n, p.n))
    coeffs = jnp.asarray(np.stack(
        [(c % int(q)).astype(np.uint64) for q in p.moduli]))
    ct1 = ctx.encrypt(ctx.wt.forward(coeffs), sk)
    ct2 = ctx.encrypt(ctx.wt.forward(coeffs), sk)

    want = rc.multiply_relinearize(ct1, ct2, rlk)

    mesh = meshlib.make_mesh({"tp": 8})
    s_ct = NamedSharding(mesh, P(None, "tp", None, None))   # shard W lanes
    rep = NamedSharding(mesh, P())
    f = jax.jit(rc._multiply_relinearize_fn,
                in_shardings=(Ciphertext(s_ct, s_ct),
                              Ciphertext(s_ct, s_ct),
                              jax.tree.map(lambda _: rep, rlk)),
                out_shardings=Ciphertext(s_ct, s_ct))
    got = f(ct1, ct2, rlk)
    np.testing.assert_array_equal(np.asarray(want.b), np.asarray(got.b))
    np.testing.assert_array_equal(np.asarray(want.a), np.asarray(got.a))
