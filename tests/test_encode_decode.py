"""Encode -> decode loopback through the full decode machinery without
encryption — the zero-key isolation oracle of test_encode_decode_wcrt.cu:29-116
(sk = 0 and ct.a = 0 make decrypt the identity there; here we feed the packed
plaintext straight into the decode half)."""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.models.batched_encoder import BatchedEncoder
from matrix_fhe.models.encoder import Encoder


@pytest.fixture(scope="module", params=["tiny", "small"])
def be(request):
    return BatchedEncoder(get_params(request.param))


def _test_message(p, scale=1.0):
    n2 = p.n * p.n
    ell = np.arange(p.phi)[:, None].astype(np.float64)
    i = np.arange(n2)[None, :].astype(np.float64)
    re = (ell + i * 0.0001) * scale
    im = (ell - i * 0.0001) * scale
    return (re.reshape(p.phi, p.n, p.n), im.reshape(p.phi, p.n, p.n))


def test_batched_encode_decode_loopback(be):
    p = be.params
    re, im = _test_message(p)
    pr, pi = be.encode_to_wntt_eval(jnp.asarray(re), jnp.asarray(im))
    assert pr.shape == (p.num_limbs, p.phi, p.n, p.n)
    dr, di = be.decode_from_wntt_eval(pr, pi)
    # threshold mirrors test_encode_decode_wcrt.cu:115 (1e-3), scaled to the
    # tiny preset's smaller Delta
    tol = 1e-3 if p.delta >= 2**30 else 0.35
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    assert err < tol, err


def test_lane_encoder_roundtrip():
    p = get_params("tiny")
    enc = Encoder(p)
    rng = np.random.default_rng(5)
    re = rng.uniform(-3, 3, size=(p.n, p.n))
    im = rng.uniform(-3, 3, size=(p.n, p.n))
    rr, ri = enc.encode(jnp.asarray(re), jnp.asarray(im))
    dr, di = enc.decode_lane_from_rns_eval(rr, ri)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    assert err < 0.05, err  # Delta = 2^12 on tiny


def test_encoder_matrices_are_inverse():
    p = get_params("small")
    enc = Encoder(p)
    v = np.asarray(enc.tables.enc_v)
    vi = np.asarray(enc.tables.enc_v_inv)
    assert np.abs(v @ vi - np.eye(p.n)).max() < 1e-10


def test_idft2_dft2_roundtrip():
    p = get_params("small")
    enc = Encoder(p)
    rng = np.random.default_rng(6)
    re = rng.uniform(-2, 2, size=(3, p.n, p.n))
    im = rng.uniform(-2, 2, size=(3, p.n, p.n))
    cr, ci = enc.idft2(jnp.asarray(re), jnp.asarray(im))
    br, bi = enc.dft2(cr, ci)
    assert np.abs(np.asarray(br) - re).max() < 1e-9
    assert np.abs(np.asarray(bi) - im).max() < 1e-9


def test_zero_key_full_decrypt_fixture():
    """The reference's exact isolation fixture (test_encode_decode_wcrt.cu:
    68-86): sk = 0 AND ct.a = 0 makes decrypt the identity, so the encoded
    message driven through the FULL decrypt_and_decode machinery must come
    back below the 1e-3 test threshold."""
    import jax.numpy as jnp
    from matrix_fhe.config import get_params
    from matrix_fhe.models.he import Ciphertext, HEContext, SecretKey

    p = get_params("tiny")
    ctx = HEContext(p)
    rng = np.random.default_rng(2)
    re = rng.uniform(-2, 2, size=(p.phi, p.n, p.n))
    im = rng.uniform(-2, 2, size=(p.phi, p.n, p.n))
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(re),
                                                     jnp.asarray(im))
    zeros = jnp.zeros_like(pr)
    sk0 = SecretKey(s_mont=jnp.zeros((p.num_limbs, p.phi, p.n),
                                     dtype=jnp.uint64))
    ct_re = Ciphertext(b=pr, a=zeros)
    ct_im = Ciphertext(b=pi, a=zeros)
    dr, di = ctx.decrypt_and_decode(ct_re, ct_im, sk0)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    # the reference's 1e-3 bound assumes Delta = 2^35; tiny runs at
    # Delta = 2^12, whose quantization floor alone is ~6e-3
    assert err < 1e-2, err
