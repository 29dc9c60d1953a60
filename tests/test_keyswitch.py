"""Relinearization / RNS-hybrid key switching (models/keyswitch.py) — the
P-basis machinery the reference reserves moduli for but never builds."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.models.he import HEContext
from matrix_fhe.models.keyswitch import RelinContext
from matrix_fhe.models import rng as refrng
from matrix_fhe.ops import modmath as mm


@pytest.fixture(scope="module")
def setup():
    p = get_params("tiny")
    ctx = HEContext(p, ring="nega")        # the production X-ring
    rc = RelinContext(ctx)
    sk = ctx.generate_secret_key()
    s_coeff = refrng.ternary_secret(p)     # same deterministic stream
    rlk = rc.gen_relin_key(jnp.asarray(s_coeff), jax.random.key(5))
    return p, ctx, rc, sk, rlk


def _composed_mag(ctx, diff, moduli):
    """max |centered CRT-composed| of a mod-Q array, measured in the
    W-COEFF domain (a small ring element has FULL-RANGE W-eval lane
    values; the integer smallness lives in its coefficients)."""
    dw = np.asarray(ctx.wt.inverse(diff)).astype(object)
    big_q = 1
    for q in moduli:
        big_q *= int(q)
    val = np.zeros(dw.shape[1:], dtype=object)
    for l, q in enumerate(moduli):
        q = int(q)
        m = big_q // q
        val = (val + dw[l] * (pow(m, -1, q) * m % big_q)) % big_q
    val = np.where(val > big_q // 2, val - big_q, val)
    return int(np.abs(val).max())


def test_key_switch_identity(setup, rng):
    """kb + ka*s must equal d2*s^2 up to key-switch noise << q."""
    p, ctx, rc, sk, rlk = setup
    d2 = jnp.asarray(np.stack(
        [rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
         for q in p.moduli]))
    kb, ka = rc.key_switch_d2(d2, rlk)
    # lhs = kb + ka (*) s ; rhs = d2 (*) s (*) s  (ring products along X)
    c = ctx._c4
    q4 = c["q"]
    lhs = mm.add_mod(kb, ctx.xntt.mul_s(ka, sk.s_mont), q4)
    rhs = ctx.xntt.mul_s(ctx.xntt.mul_s(d2, sk.s_mont), sk.s_mont)
    diff = mm.sub_mod(lhs, rhs, q4)
    # error = ModDown representative slop <= ~(1 + nnz(s)) plus the
    # D*e/P noise (~2^-20 for tiny); measured 51
    mag = _composed_mag(ctx, diff, p.moduli)
    assert mag < 10_000, f"key-switch noise too large: {mag:.3e}"


def test_multiply_relinearize_end_to_end(setup, rng):
    """Full homomorphic multiply -> rank-1 standard ciphertext whose
    decryption equals the RING product of the decrypted plaintexts, up to
    the key-switch + tensor noise (measured against the plaintext product
    computed with the same exact NTT machinery)."""
    p, ctx, rc, sk, rlk = setup
    rng_np = rng

    def enc(key):
        m = jnp.asarray(np.stack(
            [rng_np.integers(0, 1 << 20, size=(p.phi, p.n, p.n))
             .astype(np.uint64) for _ in p.moduli]))
        return ctx.encrypt(m, sk), m

    ct1, m1 = enc(21)
    ct2, m2 = enc(22)
    ct = rc.multiply_relinearize(ct1, ct2, rlk)
    assert ct.b.shape == ct1.b.shape             # rank-1, standard layout
    got = ctx.decrypt_to_eval(ct, sk)
    # plaintext ring product of the true decryptions (incl. their noise)
    p1 = ctx.decrypt_to_eval(ct1, sk)
    p2 = ctx.decrypt_to_eval(ct2, sk)
    c4 = ctx._c4
    h1 = ctx.xntt.forward(p1)
    h2 = ctx.xntt.forward(p2)
    want = ctx.xntt.inverse(mm.mont_mul(
        mm.to_mont(h1, c4["q"], c4["qinv_neg"], c4["r2"]), h2,
        c4["q"], c4["qinv_neg"]))
    diff = mm.sub_mod(got, want, c4["q"])
    # relinearization noise only (the tensor part is exact here)
    mag = _composed_mag(ctx, diff, p.moduli)
    assert mag < 100_000, mag


def test_rekey_switch(setup, rng):
    """General key switching: move a ciphertext from secret s_old to s (the
    fixture key) via a switching key for s_old."""
    p, ctx, rc, sk, rlk = setup
    # fresh old key
    k_old = jax.random.key(77)
    sk_old = ctx.generate_secret_key(k_old)
    s_old_coeff = refrng.fresh_ternary_secret(k_old, p)
    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 20, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk_old)
    # switching key: encrypts s_old under s
    s_old_hat = rc._lift_ternary(jnp.asarray(s_old_coeff))
    swk = rc.gen_switch_key(s_old_hat, jnp.asarray(refrng.ternary_secret(p)),
                            jax.random.key(6))
    kb, ka = rc.key_switch_d2(ct.a, swk)
    from matrix_fhe.models.he import Ciphertext
    c4 = ctx._c4
    ct_new = Ciphertext(b=mm.add_mod(ct.b, kb, c4["q"]), a=ka)
    got = ctx.decrypt_to_eval(ct_new, sk)
    want = ctx.decrypt_to_eval(ct, sk_old)
    diff = mm.sub_mod(got, want, c4["q"])
    assert _composed_mag(ctx, diff, p.moduli) < 10_000


def test_galois_slot_rotation(setup, rng):
    """Homomorphic W-slot automorphism: tau_j(ct) decrypts to the lane
    permutation of the plaintext (rotation over the packing group)."""
    from matrix_fhe.models.keyswitch import GaloisKeys, w_automorphism_perm

    p, ctx, rc, sk, rlk = setup
    j = None
    for cand in range(2, p.p):
        if np.gcd(cand, p.p) == 1:
            j = cand
            break
    gk = GaloisKeys(rc, jnp.asarray(refrng.ternary_secret(p)), [j],
                    jax.random.key(8))
    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 20, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk)
    ct_rot = gk.apply(ct, j)
    got = ctx.decrypt_to_eval(ct_rot, sk)
    perm = w_automorphism_perm(p, j)
    want = ctx.decrypt_to_eval(ct, sk)[:, jnp.asarray(perm)]
    diff = mm.sub_mod(got, want, ctx._c4["q"])
    assert _composed_mag(ctx, diff, p.moduli) < 10_000


def test_rescale_divides_by_last_prime(setup, rng):
    """True rescale: ct' over Q/q_last decrypts to round(m/q_last) (+-1
    slop), the operation the reference's rescale_by_delta gestures at but
    gets wrong for non-divisible values."""
    from matrix_fhe.models.keyswitch import Rescaler, rescale_ciphertext
    import dataclasses
    from matrix_fhe.models.he import HEContext as HECtx

    p, ctx, rc, sk, rlk = setup
    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 24, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk)
    ct2 = rescale_ciphertext(ctx, ct)
    assert ct2.b.shape[0] == len(p.moduli) - 1
    # decrypt on the reduced chain
    p_red = dataclasses.replace(p, name=p.name + "-red",
                                moduli=p.moduli[:-1])
    ctx2 = HECtx(p_red, ring=ctx.ring)
    from matrix_fhe.models.he import SecretKey
    sk2 = SecretKey(s_mont=sk.s_mont[:-1])
    got = ctx2.decrypt_to_eval(ct2, sk2)
    # oracle: round(decrypt(ct) / q_last), computed exactly per coefficient
    full = ctx.decrypt_to_eval(ct, sk)
    fw = np.asarray(ctx.wt.inverse(full)).astype(object)
    big_q = 1
    for q in p.moduli:
        big_q *= int(q)
    val = np.zeros(fw.shape[1:], dtype=object)
    for l, q in enumerate(p.moduli):
        q = int(q)
        mm_ = big_q // q
        val = (val + fw[l] * (pow(mm_, -1, q) * mm_ % big_q)) % big_q
    val = np.where(val > big_q // 2, val - big_q, val)
    q_last = int(p.moduli[-1])
    # exact integer round-to-nearest
    want_int = (val + q_last // 2) // q_last
    gw = np.asarray(ctx2.wt.inverse(got)).astype(object)
    big_q2 = big_q // q_last
    got_int = np.zeros(gw.shape[1:], dtype=object)
    for l, q in enumerate(p_red.moduli):
        q = int(q)
        mm_ = big_q2 // q
        got_int = (got_int + gw[l] * (pow(mm_, -1, q) * mm_ % big_q2)) % big_q2
    got_int = np.where(got_int > big_q2 // 2, got_int - big_q2, got_int)
    d = np.abs(got_int - want_int)
    # per-component division slop is +-1, but the a-component's slop is
    # multiplied by s at decrypt: bound ~ nnz(s) (measured <= 9 at tiny)
    assert int(d.max()) <= 64, int(d.max())


def test_depth2_chain(setup, rng):
    """Leveled composition: (ct1*ct2 -> relin -> rescale) * ct3 -> relin,
    decrypted on the reduced chain, vs an exact plaintext oracle
    (ring products + exact bigint round-division)."""
    import dataclasses
    from matrix_fhe.models.he import HEContext as HECtx, SecretKey
    from matrix_fhe.models.keyswitch import (RelinContext,
                                                 rescale_ciphertext)

    p, ctx, rc, sk, rlk = setup

    def enc(seed):
        # realistic plaintexts are SMALL-COEFFICIENT ring elements (Delta-
        # scaled encodings), LIMB-CONSISTENT: one integer coefficient array
        # reduced mod every q (independent per-limb randoms are not an
        # element and compose to Q/2-scale garbage)
        c = rng.integers(0, 1 << 18, size=(p.phi, p.n, p.n))
        coeffs = jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli]))
        return ctx.encrypt(ctx.wt.forward(coeffs), sk)

    ct1, ct2, ct3 = enc(1), enc(2), enc(3)
    prod = rc.multiply_relinearize(ct1, ct2, rlk)
    prod_r = rescale_ciphertext(ctx, prod)

    # level-1 context (reduced chain) + its own relin key (same secret)
    p_red = dataclasses.replace(p, name=p.name + "-r1", moduli=p.moduli[:-1])
    ctx1 = HECtx(p_red, ring=ctx.ring)
    rc1 = RelinContext(ctx1)
    s_coeff = refrng.ternary_secret(p)
    rlk1 = rc1.gen_relin_key(jnp.asarray(s_coeff[:-1]), jax.random.key(9))
    sk1 = SecretKey(s_mont=sk.s_mont[:-1])
    from matrix_fhe.models.he import Ciphertext
    ct3_r = Ciphertext(b=ct3.b[:-1], a=ct3.a[:-1])   # drop the limb of ct3
    out = rc1.multiply_relinearize(prod_r, ct3_r, rlk1)

    got = ctx1.decrypt_to_eval(out, sk1)

    # ---- exact plaintext oracle ----
    def ring_mul(cx, a, b):
        c4 = cx._c4
        ha = cx.xntt.forward(a)
        hb = cx.xntt.forward(b)
        return cx.xntt.inverse(mm.mont_mul(
            mm.to_mont(ha, c4["q"], c4["qinv_neg"], c4["r2"]), hb,
            c4["q"], c4["qinv_neg"]))

    p1 = ctx.decrypt_to_eval(ct1, sk)
    p2 = ctx.decrypt_to_eval(ct2, sk)
    p3 = ctx.decrypt_to_eval(ct3, sk)
    w12 = ring_mul(ctx, p1, p2)
    # exact round-division by q_last, coefficient domain, bigint
    w12c = np.asarray(ctx.wt.inverse(w12)).astype(object)
    big_q = 1
    for q in p.moduli:
        big_q *= int(q)
    val = np.zeros(w12c.shape[1:], dtype=object)
    for l, q in enumerate(p.moduli):
        q = int(q)
        m_ = big_q // q
        val = (val + w12c[l] * (pow(m_, -1, q) * m_ % big_q)) % big_q
    val = np.where(val > big_q // 2, val - big_q, val)
    q_last = int(p.moduli[-1])
    w12r_int = (val + q_last // 2) // q_last
    w12r = jnp.asarray(np.stack(
        [(w12r_int % int(q)).astype(np.uint64) for q in p_red.moduli]))
    w12r = ctx1.wt.forward(w12r)
    want = ring_mul(ctx1, w12r, p3[:-1])
    diff = mm.sub_mod(got, want, ctx1._c4["q"])
    mag = _composed_mag(ctx1, diff, p_red.moduli)
    # error ~ (rescale slop ~ nnz(s)) * |m3| + ks noise: m3 < 2^18 =>
    # bound ~ 2^18 * 64 * conv ~ 2^30; measure against a safe ceiling
    assert mag < 1 << 36, mag


def test_streamed_matches_fused(setup, rng):
    """multiply_relinearize_streamed (the bounded-memory per-digit path
    for big chains) is bit-identical to the fused graph."""
    p, ctx, rc, sk, rlk = setup
    c = rng.integers(0, 1 << 14, size=(p.phi, p.n, p.n))
    coeffs = jnp.asarray(np.stack(
        [(c % int(q)).astype(np.uint64) for q in p.moduli]))
    ct1 = ctx.encrypt(ctx.wt.forward(coeffs), sk)
    ct2 = ctx.encrypt(ctx.wt.forward(coeffs), sk)
    want = rc.multiply_relinearize(ct1, ct2, rlk)
    got = rc.multiply_relinearize_streamed(ct1, ct2, rlk)
    np.testing.assert_array_equal(np.asarray(want.b), np.asarray(got.b))
    np.testing.assert_array_equal(np.asarray(want.a), np.asarray(got.a))


def test_multidigit_chain_sharded_and_streamed(rng):
    """dnum >= 2 gadget (the ref chain's shape) at
    the "small" preset: fused == streamed == W-sharded == QP-limb-sharded,
    all bit-exact.  Limb sharding distributes the switch keys (the ref
    chain's ~2 GB rlk) with zero communication until ModDown."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from matrix_fhe.models.he import Ciphertext
    from matrix_fhe.parallel import mesh as meshlib

    from matrix_fhe.config import generate_ntt_primes

    p = get_params("small")
    ctx = HEContext(p, ring="nega")
    # explicit 4-prime P basis: Lqp = 8 divides the 4-way limb mesh
    cand = [q for q in generate_ntt_primes(8, 34, p.n, p.p)
            if q not in p.moduli]
    rc = RelinContext(ctx, p_moduli=cand[:4])
    assert rc.dnum >= 2, "preset no longer exercises a multi-digit gadget"
    sk = ctx.generate_secret_key()
    rlk = rc.gen_relin_key(
        jnp.asarray(refrng.ternary_secret(p)), jax.random.key(5))
    c = rng.integers(0, 1 << 14, size=(p.phi, p.n, p.n))
    coeffs = jnp.asarray(np.stack(
        [(c % int(q)).astype(np.uint64) for q in p.moduli]))
    ct1 = ctx.encrypt(ctx.wt.forward(coeffs), sk)
    ct2 = ctx.encrypt(ctx.wt.forward(coeffs), sk)

    want = rc.multiply_relinearize(ct1, ct2, rlk)
    got_s = rc.multiply_relinearize_streamed(ct1, ct2, rlk)
    np.testing.assert_array_equal(np.asarray(want.b), np.asarray(got_s.b))
    np.testing.assert_array_equal(np.asarray(want.a), np.asarray(got_s.a))

    for name, spec in (("tp", P(None, "tp", None, None)),     # W lanes
                       ("lp", P("lp", None, None, None))):    # RNS limbs
        mesh = meshlib.make_mesh({name: 4})
        s_ct = NamedSharding(mesh, spec)
        s_key = NamedSharding(mesh, spec)
        f = jax.jit(rc._multiply_relinearize_fn,
                    in_shardings=(Ciphertext(s_ct, s_ct),
                                  Ciphertext(s_ct, s_ct),
                                  jax.tree.map(lambda _: s_key, rlk)),
                    out_shardings=Ciphertext(s_ct, s_ct))
        got = f(ct1, ct2, rlk)
        np.testing.assert_array_equal(np.asarray(want.b), np.asarray(got.b))
        np.testing.assert_array_equal(np.asarray(want.a), np.asarray(got.a))


def test_x_galois_automorphism(setup, rng):
    """Homomorphic X-axis automorphism tau: X -> X^k (new in round 3; no
    reference counterpart): decrypt(tau_k(ct)) == tau_k(decrypt(ct)) up to
    key-switch noise."""
    from matrix_fhe.models.keyswitch import (XGaloisKeys,
                                                 x_automorphism_maps)

    p, ctx, rc, sk, rlk = setup
    k = 3
    xg = XGaloisKeys(rc, jnp.asarray(refrng.ternary_secret(p)), [k],
                     jax.random.key(13))
    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 20, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk)
    got = ctx.decrypt_to_eval(xg.apply(ct, k), sk)
    gi, sg, _ = x_automorphism_maps(p.n, k)
    plain = ctx.decrypt_to_eval(ct, sk)
    t = jnp.take(plain, jnp.asarray(gi), axis=-1)
    want = jnp.where(jnp.asarray(sg < 0), mm.neg_mod(t, ctx._c4["q"]), t)
    diff = mm.sub_mod(got, want, ctx._c4["q"])
    assert _composed_mag(ctx, diff, p.moduli) < 10_000


def test_rotate_multiply_rescale_composition(setup, rng):
    """rotation o (multiply+relinearize) o rescale chain: every leveled
    op composes on the same ciphertext."""
    from matrix_fhe.models.keyswitch import (GaloisKeys, Rescaler,
                                                 rescale_ciphertext,
                                                 w_automorphism_perm)

    p, ctx, rc, sk, rlk = setup
    j = next(c for c in range(2, p.p) if np.gcd(c, p.p) == 1)
    gk = GaloisKeys(rc, jnp.asarray(refrng.ternary_secret(p)), [j],
                    jax.random.key(21))
    c = rng.integers(0, 1 << 13, size=(p.phi, p.n, p.n))
    coeffs = jnp.asarray(np.stack(
        [(c % int(q)).astype(np.uint64) for q in p.moduli]))
    ct = ctx.encrypt(ctx.wt.forward(coeffs), sk)
    prod = rc.multiply_relinearize(ct, ct, rlk)
    resc = rescale_ciphertext(ctx, prod, Rescaler(p.moduli))
    # rotation on the REDUCED chain: rebuild the keyswitch machinery on the
    # dropped-limb parameter set (leveled context chain)
    import dataclasses as dc

    from matrix_fhe.config import register_params
    from matrix_fhe.models.he import HEContext
    from matrix_fhe.models.keyswitch import RelinContext
    p2 = dc.replace(p, name=p.name + "-lvl1", moduli=p.moduli[:-1])
    register_params(p2)
    ctx2 = HEContext(p2, ring="nega")
    rc2 = RelinContext(ctx2)
    gk2 = GaloisKeys(rc2, jnp.asarray(refrng.ternary_secret(p2)), [j],
                     jax.random.key(22))
    from matrix_fhe.models.he import Ciphertext
    sk2 = ctx2.generate_secret_key()   # same deterministic parity stream
    ct_rot = gk2.apply(Ciphertext(b=resc.b, a=resc.a), j)
    got = ctx2.decrypt_to_eval(ct_rot, sk2)
    # oracle: rotate the decrypted rescaled plaintext
    perm = w_automorphism_perm(p2, j)
    want = ctx2.decrypt_to_eval(resc, sk2)[:, jnp.asarray(perm)]
    diff = mm.sub_mod(got, want, ctx2._c4["q"])
    assert _composed_mag(ctx2, diff, p2.moduli) < 100_000


def test_switch_key_serialization(setup, rng, tmp_path):
    """Checkpoint/resume of the switching-key material (relin + Galois):
    the subsystem the reference has none of (SURVEY §5) extended to the
    round-2/3 key types.  Restored keys must be bit-identical and the
    rehydrated Galois sets (perm tables re-derived, no keygen) must apply
    identically."""
    from matrix_fhe.models.keyswitch import GaloisKeys, XGaloisKeys
    from matrix_fhe.utils import serialization as ser

    p, ctx, rc, sk, rlk = setup
    path = str(tmp_path / "rlk.npz")
    ser.save_relin_key(path, rlk, rc)
    rlk2 = ser.load_relin_key(path, rc)
    for x, y in zip(rlk.b + rlk.a, rlk2.b + rlk2.a):
        assert (np.asarray(x) == np.asarray(y)).all()

    s_coeff = jnp.asarray(refrng.ternary_secret(p))
    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 20, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk)

    j = next(c for c in range(2, p.p) if np.gcd(c, p.p) == 1)
    gk = GaloisKeys(rc, s_coeff, [j], jax.random.key(31))
    gpath = str(tmp_path / "gk.npz")
    ser.save_galois_keys(gpath, gk)
    gk2 = ser.load_galois_keys(gpath, rc)
    a1, a2 = gk.apply(ct, j), gk2.apply(ct, j)
    assert (np.asarray(a1.b) == np.asarray(a2.b)).all()
    assert (np.asarray(a1.a) == np.asarray(a2.a)).all()

    xg = XGaloisKeys(rc, s_coeff, [3], jax.random.key(32))
    xpath = str(tmp_path / "xg.npz")
    ser.save_galois_keys(xpath, xg)
    xg2 = ser.load_x_galois_keys(xpath, rc)
    b1, b2 = xg.apply(ct, 3), xg2.apply(ct, 3)
    assert (np.asarray(b1.b) == np.asarray(b2.b)).all()
    assert (np.asarray(b1.a) == np.asarray(b2.a)).all()


def test_grid_aware_default_p_basis():
    """The generated key-switch extension basis is chosen by the int8
    digit-grid cost model (round 3): dnum * sum(ceil(bits/7)^2 over QP),
    subject to P > every limb-group product.  At 'mid' this must beat the
    old 3 x 44-bit default (dnum=2, cost 542) by picking narrow primes."""
    import dataclasses as dc

    from matrix_fhe.models.keyswitch import (_default_p_moduli,
                                                 _greedy_groups, _grid,
                                                 _prod)

    for name in ("tiny", "mid"):
        p = get_params(name)
        ps = _default_p_moduli(dc.replace(p, p_moduli=()))
        qs = [int(q) for q in p.moduli]
        big_p = _prod(ps)
        groups = _greedy_groups(qs, big_p)
        # noise guarantee holds
        for g in groups:
            assert _prod(qs[l] for l in g) < big_p
        cost = len(groups) * (sum(_grid(q.bit_length()) for q in qs)
                              + sum(_grid(q.bit_length()) for q in ps))
        # old default: 3 primes one bit under the widest Q limb
        old_w = max(q.bit_length() for q in qs) - 1
        old_groups = _greedy_groups(qs, (1 << old_w) ** 3)
        old_cost = len(old_groups) * (
            sum(_grid(q.bit_length()) for q in qs) + 3 * _grid(old_w + 1))
        assert cost < old_cost, (name, cost, old_cost)


def test_switch_key_serialization_rejects_mismatch(setup, tmp_path):
    """Wrong-context and wrong-axis loads must raise, not decrypt garbage:
    relin keys are fingerprinted against the QP ext_params (Q chain AND P
    basis), and Galois checkpoints carry a w/x kind tag."""
    from matrix_fhe.config import generate_ntt_primes
    from matrix_fhe.models.keyswitch import RelinContext, XGaloisKeys
    from matrix_fhe.utils import serialization as ser

    p, ctx, rc, sk, rlk = setup
    path = str(tmp_path / "rlk.npz")
    ser.save_relin_key(path, rlk, rc)
    # same Q chain, different P basis -> different ext_params fingerprint
    cand = generate_ntt_primes(len(p.moduli) + 6, 33, p.n, p.p)
    other = [q for q in cand if q not in p.moduli][:3]
    rc2 = RelinContext(ctx, p_moduli=other)
    with pytest.raises(ValueError, match="checkpoint was written"):
        ser.load_relin_key(path, rc2)

    xg = XGaloisKeys(rc, jnp.asarray(refrng.ternary_secret(p)), [3],
                     jax.random.key(40))
    xpath = str(tmp_path / "xg.npz")
    ser.save_galois_keys(xpath, xg)
    with pytest.raises(ValueError, match="load_x_galois_keys"):
        ser.load_galois_keys(xpath, rc)


def test_leveled_chain(setup, rng):
    """LeveledChain = the depth-2 dance as API: per-level contexts/keys
    from one secret, scale bookkeeping, level guards — and bit-equality
    with the manually-constructed machinery it wraps."""
    from matrix_fhe.models.leveled import LeveledChain

    p, ctx, rc, sk, rlk = setup
    chain = LeveledChain(p, ring="nega", key=jax.random.key(0))

    def msg(bits=16):
        c = rng.integers(0, 1 << bits, size=(p.phi, p.n, p.n))
        return chain.ctx(0).wt.forward(jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli])))

    x, y = chain.encrypt(msg()), chain.encrypt(msg())
    assert x.scale == float(p.delta)

    z = chain.multiply(x, y)
    assert z.level == 0 and z.scale == float(p.delta) ** 2

    # manual replica using the module fixture's context must agree bit-exact
    manual_rlk = rc.gen_relin_key(jnp.asarray(refrng.ternary_secret(p)),
                                  jax.random.fold_in(jax.random.key(0), 0))
    manual = rc.multiply_relinearize(x.ct, y.ct, manual_rlk)
    assert (np.asarray(manual.b) == np.asarray(z.ct.b)).all()
    assert (np.asarray(manual.a) == np.asarray(z.ct.a)).all()

    zr = chain.rescale(z)
    q_last = int(p.moduli[-1])
    assert zr.level == 1
    assert abs(zr.scale - float(p.delta) ** 2 / q_last) < 1e-6 * zr.scale

    with pytest.raises(ValueError, match="level mismatch"):
        chain.multiply(zr, x)
    with pytest.raises(ValueError, match="scale mismatch"):
        chain.add(x, z)

    x1 = chain.mod_switch(x, 1)
    w = chain.multiply(zr, x1)           # depth 2, standard ciphertext
    assert w.level == 1 and w.ct.b.shape[0] == len(p.moduli) - 1

    j = next(c for c in range(2, p.p) if np.gcd(c, p.p) == 1)
    rot = chain.rotate(w, j)             # Galois at a reduced level
    _ = chain.decrypt_to_eval(rot)       # decrypts without error
    rot2 = chain.rotate(w, j, full=True)  # shared log-size key set
    _ = chain.decrypt_to_eval(rot2)


def test_complex_pair_multiply(setup, rng):
    """Homomorphic complex Hadamard product of packed Gaussian pairs
    (3-mult Karatsuba over multiply_relinearize) vs the exact ring oracle
    on the decrypted plaintexts."""
    p, ctx, rc, sk, rlk = setup

    def enc():
        c = rng.integers(0, 1 << 16, size=(p.phi, p.n, p.n))
        coeffs = jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli]))
        return ctx.encrypt(ctx.wt.forward(coeffs), sk)

    r1, i1, r2, i2 = enc(), enc(), enc(), enc()
    outr, outi = rc.multiply_relinearize_pair(r1, i1, r2, i2, rlk)

    c4 = ctx._c4
    q, qi, r2m = c4["q"], c4["qinv_neg"], c4["r2"]

    def ring_mul(a, b):
        ha = ctx.xntt.forward(a)
        hb = ctx.xntt.forward(b)
        return ctx.xntt.inverse(mm.mont_mul(
            mm.to_mont(ha, q, qi, r2m), hb, q, qi))

    pr1, pi1 = ctx.decrypt_to_eval(r1, sk), ctx.decrypt_to_eval(i1, sk)
    pr2, pi2 = ctx.decrypt_to_eval(r2, sk), ctx.decrypt_to_eval(i2, sk)
    want_r = mm.sub_mod(ring_mul(pr1, pr2), ring_mul(pi1, pi2), q)
    want_i = mm.add_mod(ring_mul(pr1, pi2), ring_mul(pi1, pr2), q)

    for got, want in ((outr, want_r), (outi, want_i)):
        diff = mm.sub_mod(ctx.decrypt_to_eval(got, sk), want, q)
        assert _composed_mag(ctx, diff, p.moduli) < 1 << 36


def test_full_galois_keys_cover_every_rotation(setup, rng):
    """FullGaloisKeys: ~log2(phi(p)) stored keys realize EVERY unit
    rotation via the Z2 x Z_{q-1} power-of-two decomposition; each
    composed rotation must decrypt to the same slot permutation as the
    direct single-key oracle."""
    from matrix_fhe.models.keyswitch import (FullGaloisKeys,
                                                 w_automorphism_perm)

    p, ctx, rc, sk, rlk = setup
    fk = FullGaloisKeys(rc, jnp.asarray(refrng.ternary_secret(p)),
                        jax.random.key(51))
    # key count is logarithmic: 1 + ceil(log2(q-1)) indices stored
    assert len(fk._gk._keys) <= 2 + (p.p // 3 - 2).bit_length()

    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 20, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk)
    plain = ctx.decrypt_to_eval(ct, sk)
    units = [j for j in range(1, p.p) if np.gcd(j, p.p) == 1]
    assert len(units) == p.phi
    for j in units:
        got = ctx.decrypt_to_eval(fk.apply(ct, j), sk)
        perm = w_automorphism_perm(p, j)
        want = plain[:, jnp.asarray(perm)]
        diff = mm.sub_mod(got, want, ctx._c4["q"])
        # noise: up to 1 + log2(q-1) key-switch hops
        assert _composed_mag(ctx, diff, p.moduli) < 100_000, j


def test_full_galois_keys_serialization(setup, rng, tmp_path):
    from matrix_fhe.models.keyswitch import FullGaloisKeys
    from matrix_fhe.utils import serialization as ser

    p, ctx, rc, sk, rlk = setup
    fk = FullGaloisKeys(rc, jnp.asarray(refrng.ternary_secret(p)),
                        jax.random.key(52))
    path = str(tmp_path / "fk.npz")
    ser.save_full_galois_keys(path, fk)
    fk2 = ser.load_full_galois_keys(path, rc)
    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 20, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk)
    j = next(c for c in range(2, p.p) if np.gcd(c, p.p) == 1)
    a1, a2 = fk.apply(ct, j), fk2.apply(ct, j)
    assert (np.asarray(a1.b) == np.asarray(a2.b)).all()
    assert (np.asarray(a1.a) == np.asarray(a2.a)).all()


def test_leveled_chain_complex_pair(setup, rng):
    """Chain-level complex pair ops: wiring equals the direct
    multiply_relinearize_pair bit-exactly; scale bookkeeping tracks the
    product and the rescale."""
    from matrix_fhe.models.leveled import LeveledChain

    p, ctx, rc, sk, rlk = setup
    chain = LeveledChain(p, ring="nega", key=jax.random.key(0))

    def enc_msg():
        c = rng.integers(0, 1 << 12, size=(p.phi, p.n, p.n))
        return chain.ctx(0).wt.forward(jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli])))

    a = chain.encrypt_complex(enc_msg(), enc_msg())
    b = chain.encrypt_complex(enc_msg(), enc_msg())
    prod = chain.multiply_complex(a, b)
    assert prod[0].scale == float(p.delta) ** 2

    manual_rlk = rc.gen_relin_key(jnp.asarray(refrng.ternary_secret(p)),
                                  jax.random.fold_in(jax.random.key(0), 0))
    mr, mi = rc.multiply_relinearize_pair(a[0].ct, a[1].ct,
                                          b[0].ct, b[1].ct, manual_rlk)
    assert (np.asarray(mr.b) == np.asarray(prod[0].ct.b)).all()
    assert (np.asarray(mi.b) == np.asarray(prod[1].ct.b)).all()

    rr = chain.rescale_pair(prod)
    assert rr[0].level == rr[1].level == 1
    assert abs(rr[0].scale
               - float(p.delta) ** 2 / int(p.moduli[-1])) < 1e-6 * rr[0].scale


def test_slot_sum_reduces_all_lanes(setup, rng):
    """EvalSum: every W slot of slot_sum(ct) equals the sum of ALL lanes
    of the plaintext (log2-many rotate-and-add passes)."""
    from matrix_fhe.models.keyswitch import FullGaloisKeys

    p, ctx, rc, sk, rlk = setup
    fk = FullGaloisKeys(rc, jnp.asarray(refrng.ternary_secret(p)),
                        jax.random.key(60))
    m = jnp.asarray(np.stack(
        [rng.integers(0, 1 << 18, size=(p.phi, p.n, p.n)).astype(np.uint64)
         for _ in p.moduli]))
    ct = ctx.encrypt(m, sk)
    got = ctx.decrypt_to_eval(fk.slot_sum(ct), sk)
    plain = ctx.decrypt_to_eval(ct, sk)
    q = ctx._c4["q"]
    lane_sum = plain[:, :1]
    for w in range(1, p.phi):
        lane_sum = mm.add_mod(lane_sum, plain[:, w:w + 1], q)
    want = jnp.broadcast_to(lane_sum, plain.shape)
    diff = mm.sub_mod(got, want, q)
    # noise: ~phi(p) accumulated key-switch units
    assert _composed_mag(ctx, diff, p.moduli) < 1_000_000


def test_leveled_chain_complex_encode_decode(setup, rng):
    """encrypt_complex on ENCODED complex matrices decodes back through
    decrypt_decode_complex at the pair's scale."""
    from matrix_fhe.models.leveled import LeveledChain

    p, ctx, rc, sk, rlk = setup
    chain = LeveledChain(p, ring="nega", key=jax.random.key(0))
    c0 = chain.ctx(0)
    re = rng.uniform(-2, 2, size=(p.phi, p.n, p.n))
    im = rng.uniform(-2, 2, size=(p.phi, p.n, p.n))
    pr, pi = c0.batched_encoder.encode_to_wntt_eval(
        jnp.asarray(re), jnp.asarray(im))
    pair = chain.encrypt_complex(pr, pi)
    dr, di = chain.decrypt_decode_complex(pair)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    # tiny's Delta = 2^12: fresh-encryption noise decodes to ~1e-1;
    # the ref preset (Delta = 2^35) meets 1e-4 (src/main.cu:150)
    assert err < 0.2, err
