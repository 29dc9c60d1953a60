"""Ciphertext-level homomorphic matrix multiplication (models/he_matmul.py).

The reference exports the trace kernels but never composes them with
encryption (SURVEY 2.13); these tests pin the full capability:
encrypt -> tensor -> decrypt -> decode == Y^H @ X per packed lane.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.models.he import Ciphertext, HEContext
from matrix_fhe.models.he_matmul import HEMatmul, conj_flip_perm
from matrix_fhe.models import trace as tr


@pytest.fixture(scope="module")
def setup():
    p = get_params("tiny")
    ctx = HEContext(p, ring="gl")
    hm = HEMatmul(ctx)
    rng = np.random.default_rng(5)
    W, n = p.phi, p.n
    A = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    B = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    pA = ctx.batched_encoder.encode_to_wntt_eval(
        jnp.asarray(A.real), jnp.asarray(A.imag))
    pB = ctx.batched_encoder.encode_to_wntt_eval(
        jnp.asarray(B.real), jnp.asarray(B.imag))
    return p, ctx, hm, A, B, pA, pB


def test_conj_flip_perm_involution():
    p = get_params("tiny")
    flip = conj_flip_perm(p)
    exps = np.asarray(p.w_exponents)
    assert (flip[flip] == np.arange(len(flip))).all()
    assert ((exps[flip] + exps) % p.p == 0).all()


def test_zero_key_matmul_decodes(setup):
    """sk=0 / a=0 isolation (test_encode_decode_wcrt.cu style): the E0 term
    alone must decode to Y^H @ X up to quantization."""
    p, ctx, hm, A, B, pA, pB = setup
    zeros = jnp.zeros_like(pA[0])
    ctA = (Ciphertext(b=pA[0], a=zeros), Ciphertext(b=pA[1], a=zeros))
    ctB = (Ciphertext(b=pB[0], a=zeros), Ciphertext(b=pB[1], a=zeros))
    sk = ctx.generate_secret_key()
    tt = hm.matmul(ctA, ctB)
    dr, di = hm.decrypt_and_decode(tt, sk)
    C = np.asarray(dr) + 1j * np.asarray(di)
    ref = np.conj(np.swapaxes(B, 1, 2)) @ A
    assert np.abs(C - ref).max() < 0.1


def test_tensor_decrypt_identity_exact(setup):
    """The two-sided-key decrypt formula == trace-GEMM of the decrypted
    plaintexts, bit-exactly mod q (the factoring identities)."""
    p, ctx, hm, A, B, pA, pB = setup
    sk = ctx.generate_secret_key(key=jax.random.key(3))
    ctA = ctx.encrypt_pair(*pA, sk, key=jax.random.key(11))
    ctB = ctx.encrypt_pair(*pB, sk, key=jax.random.key(12))
    mAr, mAi = ctx.decrypt_pair_to_eval(*ctA, sk)
    mBr, mBi = ctx.decrypt_pair_to_eval(*ctB, sk)
    T = lambda x: jnp.swapaxes(x, -1, -2)
    want = hm._postmap(*tr.trace_gemm(T(mAr), T(mAi),
                                      *hm._cfl(T(mBr), T(mBi)), p))
    tt = hm.matmul(ctA, ctB)
    Cr, Ci = hm.decrypt_fn(tt, sk)
    np.testing.assert_array_equal(np.asarray(Cr), np.asarray(T(want[0])))
    np.testing.assert_array_equal(np.asarray(Ci), np.asarray(T(want[1])))


def test_homomorphic_matmul_end_to_end(setup):
    """encrypt -> homomorphic GEMM tensor -> decrypt -> decode ~= Y^H @ X.

    tiny's Delta = 2^12 gives ~5% product-noise error (the single roundtrip
    is already ~0.07); ref-scale Delta = 2^35 makes this ~1e-6
    (examples/matmul.py)."""
    p, ctx, hm, A, B, pA, pB = setup
    sk = ctx.generate_secret_key(key=jax.random.key(3))
    ctA = ctx.encrypt_pair(*pA, sk, key=jax.random.key(11))
    ctB = ctx.encrypt_pair(*pB, sk, key=jax.random.key(12))
    tt = hm.matmul(ctA, ctB)
    dr, di = hm.decrypt_and_decode(tt, sk)
    C = np.asarray(dr) + 1j * np.asarray(di)
    ref = np.conj(np.swapaxes(B, 1, 2)) @ A
    assert np.abs(C - ref).max() < 0.35


def test_requires_gl_ring():
    p = get_params("tiny")
    ctx = HEContext(p, ring="nega")
    with pytest.raises(ValueError):
        HEMatmul(ctx)


def test_matmul_tensor_serialization(setup, tmp_path):
    p, ctx, hm, A, B, pA, pB = setup
    from matrix_fhe.utils import serialization as ser

    sk = ctx.generate_secret_key(key=jax.random.key(3))
    ctA = ctx.encrypt_pair(*pA, sk, key=jax.random.key(11))
    ctB = ctx.encrypt_pair(*pB, sk, key=jax.random.key(12))
    tt = hm.matmul(ctA, ctB)
    path = str(tmp_path / "tensor.npz")
    ser.save_matmul_tensor(path, tt, p)
    tt2 = ser.load_matmul_tensor(path, p)
    for a, b in zip(tt, tt2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
