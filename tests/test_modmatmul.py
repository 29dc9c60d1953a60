"""Exactness tests for the chunked int8 modular matmul against Python
big-int matrix products (the oracle the reference implicitly defines via its
__int128 per-element loops, HE.cu:716-781)."""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.config import REF_RNS_MODULI
from matrix_fhe.ops import modmatmul as mmm


def _oracle(table, data, q):
    t = table.astype(object)
    d = data.astype(object)
    return (t @ d) % q


@pytest.mark.parametrize("bits,k,m", [(35, 64, 32), (45, 64, 32), (45, 512, 16)])
def test_modmatmul_exact(rng, bits, k, m):
    moduli = [q for q in REF_RNS_MODULI if q.bit_length() == bits] or \
             [REF_RNS_MODULI[0]]
    moduli = moduli[:3]
    B = len(moduli)
    w = 48
    table = np.stack([rng.integers(0, q, size=(w, k), dtype=np.uint64)
                      for q in moduli])
    data = np.stack([rng.integers(0, q, size=(k, m), dtype=np.uint64)
                     for q in moduli])
    got = np.asarray(mmm.modmatmul(jnp.asarray(table), jnp.asarray(data),
                                   moduli, bits, bits))
    for b, q in enumerate(moduli):
        want = _oracle(table[b], data[b], q)
        assert (got[b].astype(object) == want).all(), f"limb {b} mismatch"


def test_chunk_decompose_roundtrip(rng):
    x = rng.integers(0, 1 << 45, size=(4, 8), dtype=np.uint64)
    ch = np.asarray(mmm.chunk_decompose(jnp.asarray(x), mmm.num_chunks(45)))
    recon = sum(ch[i].astype(object) * (1 << (7 * i)) for i in range(ch.shape[0]))
    assert (recon == x.astype(object)).all()
    assert ch.max() <= 127 and ch.min() >= 0


def test_modmatmul_mixed_small_modulus(rng):
    # tiny moduli (tests use ~30-bit primes) must also be exact
    from matrix_fhe.config import get_params
    moduli = list(get_params("tiny").moduli)
    k, m, w = 8, 8, 8
    table = np.stack([rng.integers(0, q, size=(w, k), dtype=np.uint64)
                      for q in moduli])
    data = np.stack([rng.integers(0, q, size=(k, m), dtype=np.uint64)
                     for q in moduli])
    bits = max(q.bit_length() for q in moduli)
    got = np.asarray(mmm.modmatmul(jnp.asarray(table), jnp.asarray(data),
                                   moduli, bits, bits))
    for b, q in enumerate(moduli):
        assert (got[b].astype(object) == _oracle(table[b], data[b], q)).all()
