"""Full scheme pipeline oracles:

  * zero-noise encrypt -> decrypt is the exact identity on packed plaintexts
    (integer-exact; this is the bit-parity surface vs the CUDA reference)
  * real-noise full pipeline encode->encrypt->decrypt->decode max complex
    error (test_encode_encrypt_decrypt_decode_wcrt.cu:29-109, src/main.cu)
  * homomorphic addition decrypts to the sum
  * tensor multiply matches (b+as)-style expansion identities elementwise
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matrix_fhe.config import get_params
from matrix_fhe.models.he import HEContext
from matrix_fhe.ops.ntt import RING_GL, RING_NEGACYCLIC


def _message(p):
    n2 = p.n * p.n
    ell = np.arange(p.phi)[:, None].astype(np.float64)
    i = np.arange(n2)[None, :].astype(np.float64)
    re = (ell * 0.5 + i * 0.0001).reshape(p.phi, p.n, p.n)
    im = (ell * 0.5 - i * 0.0001).reshape(p.phi, p.n, p.n)
    return re, im


@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL])
def test_zero_noise_encrypt_decrypt_exact(ring):
    p = get_params("tiny")
    ctx = HEContext(p, ring=ring, zero_noise=True)
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(11)
    m = np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
                  for q in p.moduli])
    ct = ctx.encrypt(jnp.asarray(m), sk)
    got = np.asarray(ctx.decrypt_to_eval(ct, sk))
    assert (got == m).all(), "zero-noise decrypt must be the exact identity"


def test_noise_encrypt_decrypt_small_error():
    """With real noise, decrypt differs from the plaintext by W-NTT(e): check
    the error is exactly the transformed reference Gaussian stream."""
    p = get_params("tiny")
    ctx = HEContext(p, zero_noise=False)
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(12)
    m = np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
                  for q in p.moduli])
    ct = ctx.encrypt(jnp.asarray(m), sk)
    got = np.asarray(ctx.decrypt_to_eval(ct, sk))
    from matrix_fhe.models import rng as refrng
    e = refrng.gaussian_noise(p)
    e_eval = np.asarray(ctx.wt.forward(e))
    q = np.array(p.moduli, dtype=np.uint64).reshape(-1, 1, 1, 1)
    want = (m.astype(object) + e_eval.astype(object)) % q.astype(object)
    assert (got.astype(object) == want).all()


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_full_pipeline_roundtrip(preset):
    """encode -> encrypt -> decrypt -> decode (src/main.cu:31-157)."""
    p = get_params(preset)
    ctx = HEContext(p)
    sk = ctx.generate_secret_key()
    re, im = _message(p)
    dr, di = ctx.roundtrip(jnp.asarray(re), jnp.asarray(im), sk)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    # reference threshold is 1e-4 at Delta=2^35; tiny/small use smaller Delta
    # so noise/Delta is proportionally larger
    tol = {"tiny": 0.5, "small": 0.05}[preset]
    assert err < tol, err


@pytest.mark.parametrize("fast", [False, True])
def test_roundtrip_word_formats(fast):
    """HEContext.roundtrip on the u64 path (fast_float=False) and on the
    u32-pair path with cached parity streams (fast_float=True)."""
    p = get_params("small")
    ctx = HEContext(p, fast_float=fast)
    sk = ctx.generate_secret_key()
    re, im = _message(p)
    fn, args = ctx.roundtrip_program(jnp.asarray(re), jnp.asarray(im), sk)
    assert len(args) == (4 if fast else 3)     # streams ride as arguments
    dr, di = ctx.roundtrip(jnp.asarray(re), jnp.asarray(im), sk)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    assert err < 0.05, err


def test_homomorphic_add():
    p = get_params("tiny")
    ctx = HEContext(p, zero_noise=True)
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(13)
    m1 = np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
                   for q in p.moduli])
    m2 = np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
                   for q in p.moduli])
    ct1 = ctx.encrypt(jnp.asarray(m1), sk)
    ct2 = ctx.encrypt(jnp.asarray(m2), sk)
    ct = ctx.add_ciphertexts(ct1, ct2)
    got = np.asarray(ctx.decrypt_to_eval(ct, sk)).astype(object)
    q = np.array(p.moduli, dtype=np.uint64).reshape(-1, 1, 1, 1).astype(object)
    want = (m1.astype(object) + m2.astype(object)) % q
    assert (got == want).all()


def test_tensor_multiply_raw():
    """d0,d1,d2 must equal the element-wise tensor products
    (mul_tensor_kernel, HE.cu:647-669)."""
    p = get_params("tiny")
    ctx = HEContext(p, zero_noise=True)
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(14)
    m1 = np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
                   for q in p.moduli])
    m2 = np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n), dtype=np.uint64)
                   for q in p.moduli])
    ct1 = ctx.encrypt(jnp.asarray(m1), sk)
    ct2 = ctx.encrypt(jnp.asarray(m2), sk)
    d0, d1, d2 = ctx.multiply_ciphertexts_raw(ct1, ct2)
    b1 = np.asarray(ct1.b).astype(object)
    a1 = np.asarray(ct1.a).astype(object)
    b2 = np.asarray(ct2.b).astype(object)
    a2 = np.asarray(ct2.a).astype(object)
    q = np.array(p.moduli, dtype=np.uint64).reshape(-1, 1, 1, 1).astype(object)
    assert (np.asarray(d0).astype(object) == b1 * b2 % q).all()
    assert (np.asarray(d1).astype(object) == (b1 * a2 + a1 * b2) % q).all()
    assert (np.asarray(d2).astype(object) == a1 * a2 % q).all()


def test_encrypt_pair_shares_a():
    p = get_params("tiny")
    ctx = HEContext(p)
    sk = ctx.generate_secret_key()
    re, im = _message(p)
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(re),
                                                     jnp.asarray(im))
    ct_re, ct_im = ctx.encrypt_pair(pr, pi, sk)
    assert (np.asarray(ct_re.a) == np.asarray(ct_im.a)).all()


def test_fresh_randomness_pipeline():
    p = get_params("tiny")
    ctx = HEContext(p)
    key = jax.random.PRNGKey(42)
    k1, k2 = jax.random.split(key)
    sk = ctx.generate_secret_key(k1)
    re, im = _message(p)
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(re),
                                                     jnp.asarray(im))
    ct_re, ct_im = ctx.encrypt_pair(pr, pi, sk, key=k2)
    dr, di = ctx.decrypt_and_decode(ct_re, ct_im, sk)
    err = np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max()
    assert err < 0.5, err


def test_pair_native_roundtrip_matches_u64_path():
    """The u32-pair fast roundtrip (fast_float=True, selected via the public
    HEContext flag) vs the u64-path composition of the same stages."""
    from matrix_fhe.models import rng as refrng

    p = get_params("small")
    ctx = HEContext(p, fast_float=True)
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(3)
    re = jnp.asarray(rng.uniform(-4, 4, size=(p.phi, p.n, p.n)))
    im = jnp.asarray(rng.uniform(-4, 4, size=(p.phi, p.n, p.n)))
    dr, di = ctx._roundtrip_pair_fn(re, im, sk)
    err = np.hypot(np.asarray(dr) - np.asarray(re),
                   np.asarray(di) - np.asarray(im)).max()
    assert err < 0.05, err
    # the u64-path composition must agree to f64 noise
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re, im)
    a_coeff = refrng.uniform_a(p)
    e = refrng.gaussian_noise(p)
    ct_re, ct_im = ctx._encrypt_core((pr, pi), sk, a_coeff, (e, e))
    ev_re, ev_im = ctx.decrypt_pair_to_eval(ct_re, ct_im, sk)
    dr2, di2 = ctx.batched_encoder.decode_from_wntt_eval(ev_re, ev_im)
    assert np.abs(np.asarray(dr) - np.asarray(dr2)).max() < 1e-9
    assert np.abs(np.asarray(di) - np.asarray(di2)).max() < 1e-9


def test_debug_hooks():
    """Moduli-readback + sanity counters (HE.cu:410-422,1204-1222 parity)."""
    from matrix_fhe.utils import debug

    ctx = HEContext(get_params("tiny"))
    assert debug.check_moduli(ctx)
    x = jnp.asarray(np.array([0, 1, 2, 0, 5], dtype=np.uint64))
    assert debug.count_nonzero(x) == 3
    hi = jnp.asarray(np.array([[0, 0], [1, 0], [0, 0]], dtype=np.uint64))
    assert debug.count_over_i64(hi) == 1
