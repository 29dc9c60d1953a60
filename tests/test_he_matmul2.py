"""gl2 double ring + ciphertext-in/ciphertext-out homomorphic GEMM.

The round-2 obstruction (keyswitch.py: the folded GL ring admits no key
switching) is resolved by the integral double form D = Z[X]/(X^{2n}+1)
(models/he2.py, tables.build_gl2_x_tables).  These tests pin:

  * the gl2 X transform is the exact X^{2n}+1 negacyclic NTT;
  * encode/decode and encrypt/decrypt roundtrips in the double ring;
  * the 2D trace-GEMM tensor's two-sided decrypt identity EXACTLY mod q;
  * the flagship: GEMM -> relinearize -> STANDARD ciphertext -> plain
    decrypt/decode == Y^H X (the reference's trace op never even runs
    against encryption, SURVEY 2.13 — and round 2's he_matmul output could
    not be key-switched at all);
  * composability: a second GEMM consumed the first one's output ciphertext.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.ops import modmath as mm
from matrix_fhe.ops.ntt import XNTT
from matrix_fhe.models.he2 import Ciphertext2, Gl2Context
from matrix_fhe.models.he_matmul2 import Gl2GemmRelin, HEMatmul2


@pytest.fixture(scope="module")
def setup():
    p = get_params("tiny")
    ctx = Gl2Context(p)
    hm = HEMatmul2(ctx)
    rng = np.random.default_rng(31)
    W, n = p.phi, p.n
    X = rng.uniform(-2, 2, (W, n, n)) + 1j * rng.uniform(-2, 2, (W, n, n))
    Y = rng.uniform(-2, 2, (W, n, n)) + 1j * rng.uniform(-2, 2, (W, n, n))
    mX = ctx.encode(jnp.asarray(X.real), jnp.asarray(X.imag))
    mY = ctx.encode(jnp.asarray(Y.real), jnp.asarray(Y.imag))
    sk = ctx.generate_secret_key(jax.random.key(1))
    ctX = ctx.encrypt(mX, sk, jax.random.key(2))
    ctY = ctx.encrypt(mY, sk, jax.random.key(4))
    C = np.conj(np.swapaxes(Y, -1, -2)) @ X
    return p, ctx, hm, X, Y, C, mX, mY, sk, ctX, ctY


def test_gl2_ntt_is_exact_double_negacyclic():
    """Roundtrip + schoolbook X^{2n}+1 polymul oracle (the gl2 analog of
    test_custom_ntt_roundtrip.cu:256-319)."""
    p = get_params("tiny")
    xn = XNTT(p, ring="gl2")
    m = 2 * p.n
    rng = np.random.default_rng(0)
    a = np.stack([rng.integers(0, q, (3, m), dtype=np.uint64)
                  for q in p.moduli])
    b = np.stack([rng.integers(0, q, (3, m), dtype=np.uint64)
                  for q in p.moduli])
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert (np.asarray(xn.inverse(xn.forward(ja))) == a).all()
    c = mm.mont_consts_arrays(p.moduli, shape_suffix=(1, 1))
    fam = mm.to_mont(xn.forward(ja), c["q"], c["qinv_neg"], c["r2"])
    prod = np.asarray(xn.inverse(
        mm.mont_mul(fam, xn.forward(jb), c["q"], c["qinv_neg"])))
    for l, q in enumerate(p.moduli):
        q = int(q)
        for r in range(3):
            ref = [0] * m
            for i in range(m):
                for j in range(m):
                    k, v = i + j, int(a[l, r, i]) * int(b[l, r, j])
                    if k >= m:
                        k, v = k - m, -v
                    ref[k] = (ref[k] + v) % q
            assert (np.array(ref, dtype=np.uint64) == prod[l, r]).all()


def test_encode_decode_loopback(setup):
    p, ctx, _, X, _, _, mX, _, _, _, _ = setup
    dr, di = ctx.decode(mX)
    err = np.hypot(np.asarray(dr) - X.real, np.asarray(di) - X.imag).max()
    assert err < 2e-2


def test_encrypt_decrypt_roundtrip(setup):
    p, ctx, _, X, _, _, _, _, sk, ctX, _ = setup
    dr, di = ctx.decrypt_and_decode(ctX, sk)
    err = np.hypot(np.asarray(dr) - X.real, np.asarray(di) - X.imag).max()
    assert err < 0.2


def test_zero_key_plaintext_gemm(setup):
    """Zero a-part: the tensor path reduces to the plaintext pairing and
    must reproduce Y^H X (packing + sigma + trace-pairing + repack)."""
    p, ctx, hm, X, Y, C, mX, mY, _, _, _ = setup
    z = jnp.zeros_like(mX)
    tt = hm.tensor_fn(Ciphertext2(b=mX, a=z), Ciphertext2(b=mY, a=z))
    dr, di = ctx.decode(hm.repack_fn(tt.e00),
                        delta_override=float(p.delta) ** 2)
    err = np.hypot(np.asarray(dr) - C.real, np.asarray(di) - C.imag).max()
    assert err < 0.15


def test_two_sided_tensor_identity_exact(setup):
    """decrypt_tensor(tensor(ctX, ctY)) == pairing of the decrypted
    plaintexts, BIT-EXACT mod q (key algebra of the 2D tensor)."""
    p, ctx, hm, _, _, _, _, _, sk, ctX, ctY = setup
    tt = hm.tensor_fn(ctX, ctY)
    lhs = np.asarray(hm.decrypt_tensor_fn(tt, sk))
    mYp = ctx.decrypt_to_eval(ctY, sk)
    mXp = ctx.decrypt_to_eval(ctX, sk)
    rhs = np.asarray(hm.repack_fn(
        hm._mod_gemm(hm._ry_map(hm._sigma(mYp)), hm._tw(mXp))))
    assert (lhs == rhs).all()


@pytest.fixture(scope="module")
def relin(setup):
    _, ctx, hm = setup[:3]
    gr = Gl2GemmRelin(hm)
    ks = gr.gen_keys(setup[8], jax.random.key(9))
    return gr, ks


def test_ct_in_ct_out_gemm(setup, relin):
    """The flagship: standard ciphertext out, opened by the plain secret
    key, equals Y^H X with keyswitch noise ~ the two-sided baseline."""
    p, ctx, hm, X, Y, C, _, _, sk, ctX, ctY = setup
    gr, ks = relin
    tt = hm.tensor_fn(ctX, ctY)
    base = ctx.decode(hm.decrypt_tensor_fn(tt, sk),
                      delta_override=float(p.delta) ** 2)
    base_err = np.hypot(np.asarray(base[0]) - C.real,
                        np.asarray(base[1]) - C.imag).max()
    ct_out = gr.matmul(ctX, ctY, ks)
    assert ct_out.b.shape == ctX.b.shape
    dr, di = ctx.decrypt_and_decode(ct_out, sk,
                                    delta_override=float(p.delta) ** 2)
    err = np.hypot(np.asarray(dr) - C.real, np.asarray(di) - C.imag).max()
    assert err < 2 * base_err + 0.1


def test_gemm_of_gemm_composes(setup, relin):
    """ct(C) from one GEMM feeds a second GEMM: D = C^H C, depth 2, all
    standard ciphertexts (impossible in the folded ring / round 2)."""
    p, ctx, hm, X, Y, C, _, _, sk, ctX, ctY = setup
    gr, ks = relin
    ctC = gr.matmul(ctX, ctY, ks)
    ctD = gr.matmul(ctC, ctC, ks)
    dr, di = ctx.decrypt_and_decode(ctD, sk,
                                    delta_override=float(p.delta) ** 4)
    D = np.conj(np.swapaxes(C, -1, -2)) @ C
    err = np.hypot(np.asarray(dr) - D.real, np.asarray(di) - D.imag).max()
    assert err / np.abs(D).max() < 0.05


def test_gl2_x_slot_rotation_and_conjugation(setup):
    """X-axis Galois on gl2 packing: tau_5 rotates each matrix's columns
    (the X-slot 5-orbit); tau_{-1} + the W-lane flip is full homomorphic
    complex conjugation of every packed value."""
    from matrix_fhe.models.keyswitch import RelinContext, XGaloisKeys

    p, ctx, hm, X, Y, C, mX, mY, sk, ctX, ctY = setup
    rc = RelinContext(ctx)
    s_res = np.asarray(jnp.asarray(
        ctx._ternary_residues(sk.s_sign, p.moduli)))
    xg = XGaloisKeys(rc, jnp.asarray(s_res), [5], jax.random.key(33))

    # column rotation: new column j holds old column j+1 (X -> X^5 maps
    # eval at zeta^{5^j} to the original's eval at zeta^{5^{j+1}})
    ct_rot = xg.apply(ctX, 5)
    dr, di = ctx.decrypt_and_decode(ct_rot, sk)
    want = np.roll(X, -1, axis=-1)
    err = np.hypot(np.asarray(dr) - want.real, np.asarray(di) - want.imag
                   ).max()
    assert err < 0.5

    # full conjugation: the JOINT (W, Y, X)-inversion + one key switch
    # (per-axis compositions are not automorphisms of Y^n = X^n — see
    # Gl2Conj docstring)
    from matrix_fhe.models.he_matmul2 import Gl2Conj
    cj = Gl2Conj(hm, rc, sk, jax.random.key(34))
    ct_c = cj.apply(ctX)
    dr, di = ctx.decrypt_and_decode(ct_c, sk)
    err = np.hypot(np.asarray(dr) - X.real, np.asarray(di) + X.imag).max()
    assert err < 0.5


def test_relinearize_streamed_matches_fused(setup, relin):
    """The limb-chunked streamed relinearization (round 5: bounds peak HBM
    for the ref-scale flagship) == the fused graph, bit-exact
    on both components, forced to 1-limb chunks to exercise the chunk
    transforms, the dst-sliced basis extension, and the accumulator
    writes."""
    p, ctx, hm, X, Y, C, _, _, sk, ctX, ctY = setup
    gr, ks = relin
    gr1 = Gl2GemmRelin(hm, gr.rc, chunk_limbs=1)
    want = gr.relinearize_fn(hm.tensor_fn(ctX, ctY), ks)
    # streamed consumes its tensor (donated) — build a fresh one
    got = gr1.relinearize_streamed(hm.tensor_fn(ctX, ctY), ks)
    np.testing.assert_array_equal(np.asarray(want.b), np.asarray(got.b))
    np.testing.assert_array_equal(np.asarray(want.a), np.asarray(got.a))


def test_gen_keys_chunk_invariant(setup):
    """Key material is independent of the limb chunking (per-limb
    fold_in streams): 1-limb chunks == one full chunk, bit-exact."""
    p, ctx, hm, *_ = setup
    sk = setup[8]
    gr = Gl2GemmRelin(hm)
    gr.chunk_limbs = len(gr.rc.qp_moduli)
    k_full = gr.gen_keys(sk, jax.random.key(9))
    gr2 = Gl2GemmRelin(hm, gr.rc, chunk_limbs=1)
    k_chunk = gr2.gen_keys(sk, jax.random.key(9))
    for a, b in zip(jax.tree.leaves(k_full), jax.tree.leaves(k_chunk)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
