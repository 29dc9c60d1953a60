"""Four-step large-N NTT: roundtrip, natural-order DFT cross-check, and
negacyclic convolution vs schoolbook (BASELINE.md measurement-config shapes,
scaled down for CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest

from matrix_fhe.ops.ntt_large import (FourStepNTT, FourStepPlan,
                                          generate_primes_1mod)


@pytest.fixture(scope="module")
def primes():
    # two 35-bit primes == 1 mod 2^12 (supports N up to 2^11 negacyclic)
    return generate_primes_1mod(2, 35, 1 << 12)


@pytest.mark.parametrize("n,nega", [(64, True), (256, True), (1024, True),
                                    (256, False)])
def test_roundtrip(primes, rng, n, nega):
    plan = FourStepPlan.make(n, primes, negacyclic=nega)
    ntt = FourStepNTT(plan)
    x = np.stack([rng.integers(0, q, size=(3, n), dtype=np.uint64)
                  for q in primes])
    back = np.asarray(ntt.inverse(ntt.forward(jnp.asarray(x))))
    assert (back == x).all()


def test_forward_matches_dft_matrix(primes, rng):
    """Four-step order must be the digit transpose k = k1 + n1*k2 of the
    plain cyclic DFT."""
    n = 64
    plan = FourStepPlan.make(n, primes[:1], negacyclic=False)
    ntt = FourStepNTT(plan)
    q = primes[0]
    x = rng.integers(0, q, size=(1, 1, n), dtype=np.uint64)
    got = np.asarray(ntt.forward(jnp.asarray(x)))[0, 0]
    from matrix_fhe.ops.ntt_large import _find_generator
    g = _find_generator(q)
    w = pow(g, (q - 1) // n, q)
    want = [sum(int(x[0, 0, i]) * pow(w, i * k % n, q) for i in range(n)) % q
            for k in range(n)]
    n1, n2 = plan.n1, plan.n2
    for k1 in range(n1):
        for k2 in range(n2):
            assert int(got[k1 * n2 + k2]) == want[k1 + n1 * k2]


def test_negacyclic_convolution(primes, rng):
    n = 128
    plan = FourStepPlan.make(n, primes, negacyclic=True)
    ntt = FourStepNTT(plan)
    a = np.stack([rng.integers(0, q, size=(1, n), dtype=np.uint64)
                  for q in primes])
    b = np.stack([rng.integers(0, q, size=(1, n), dtype=np.uint64)
                  for q in primes])
    fa = ntt.forward(jnp.asarray(a))
    fb = ntt.forward(jnp.asarray(b))
    fc = ntt.pointwise_mul(fa, fb)
    got = np.asarray(ntt.inverse(fc))
    for l, q in enumerate(primes):
        ref = [0] * n
        for i in range(n):
            for j in range(n):
                p = int(a[l, 0, i]) * int(b[l, 0, j]) % q
                if i + j < n:
                    ref[i + j] = (ref[i + j] + p) % q
                else:
                    ref[i + j - n] = (ref[i + j - n] - p) % q
        assert got[l, 0].tolist() == ref, f"limb {l}"


def test_prime_generator():
    ps = generate_primes_1mod(3, 35, 1 << 17)
    assert len(set(ps)) == 3
    for q in ps:
        assert (q - 1) % (1 << 17) == 0 and q.bit_length() in (35, 36)


def test_prime_generator_width_contract():
    """generate_primes_1mod(bits=k) must return bit-length-EXACTLY-k primes:
    the width drives the int8 digit grid (ceil(bits/7) a side), and the old
    upward search silently returned (k+1)-bit primes — a 6x6 grid where 5x5
    suffices."""
    from matrix_fhe.ops.ntt_large import generate_primes_1mod
    for bits, m in ((35, 1 << 17), (28, 1 << 17), (23, 1 << 11)):
        for q in generate_primes_1mod(4, bits, m):
            assert int(q).bit_length() == bits
            assert q % m == 1
