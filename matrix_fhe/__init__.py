"""matrix_fhe — Matrix-FHE (GL/CKKS-variant) framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
Shaibk/Matrix-FHE-GPU reference (CUDA/C++): packing phi(p)=512 complex 64x64
matrices into one RLWE ciphertext over Z_Q[X,W] (X: negacyclic degree-64
polynomial axis; W: prime-cyclotomic Phi_p(W) axis evaluated by a dense CRT
transform), with an 11-limb RNS modulus chain.

Design stance:
  * Residues are uint64 JAX arrays; hot element-wise modular arithmetic uses
    Montgomery multiplication built from 32-bit-split high products
    (ops/modmath.py).
  * The dense W-CRT transform, the X-axis NTT and the homomorphic trace GEMM
    are *exact* modular matrix multiplications, computed as 7-bit chunk
    decompositions into int8 dot_generals with int32 accumulation
    (ops/modmatmul.py) — the reference's per-element O(phi) loops
    (HE.cu:716-781) become batched integer matmuls.
  * The complex sigma-embedding encode/decode path runs in float64, which
    reproduces the reference's double math.
  * Host-side one-time table generation (eta/psi root search, 512x512
    Gauss-Jordan inverse mod q, CRT big-int tables) is native C++
    (native/tablegen.cpp) loaded via ctypes, with a pure-Python fallback.
  * Multi-device scaling is expressed with jax.sharding.Mesh + NamedSharding
    (parallel/): RNS-limb / W-lane / ciphertext-batch axes, and a
    coefficient-sharded four-step NTT using shard_map + all_to_all.

This package requires jax_enable_x64; importing it turns the flag on.
"""

import os as _os

import jax as _jax

# 64-bit integers (and f64) are load-bearing for exact RNS arithmetic.
# This must happen before any tracing; importing the package opts in.
_jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """Persistent XLA compile-cache directory: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else the fixed <checkout>/.cache/xla.
    The path is part of the cache key, so it must not move between runs."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return _os.path.normpath(_os.path.join(
        _os.path.dirname(_os.path.abspath(__file__)), "..", ".cache", "xla"))


# The chunked-matmul pipelines are large graphs; the persistent cache lets
# repeated processes (bench, examples, tests) skip the one-time compile.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import GLParams, get_params, REF_PARAMS_NAME  # noqa: E402,F401

__version__ = "0.1.0"

_LAZY = {
    "Ciphertext": ".models.he",
    "SecretKey": ".models.he",
    "HEContext": ".models.he",
    "init_he_backend": ".models.he",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        return getattr(mod, name)
    raise AttributeError(name)
