"""Key / ciphertext serialization (checkpoint-resume).

The reference has none — keys and ciphertexts live only in device memory for
one process lifetime (SURVEY §5).  Here: a compact .npz container with a
params fingerprint so a restored object is guaranteed to match its context.
"""

from __future__ import annotations

import hashlib
import json
from typing import Union

import jax.numpy as jnp
import numpy as np

from ..config import GLParams
from ..models.he import Ciphertext, SecretKey


def params_fingerprint(p: GLParams) -> str:
    blob = json.dumps({
        "n": p.n, "p": p.p, "moduli": list(p.moduli), "delta": p.delta,
    }, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_ciphertext(path: str, ct: Ciphertext, params: GLParams) -> None:
    np.savez_compressed(path, b=np.asarray(ct.b), a=np.asarray(ct.a),
                        fp=params_fingerprint(params))


def load_ciphertext(path: str, params: GLParams) -> Ciphertext:
    z = np.load(path)
    _check(z, params)
    return Ciphertext(b=jnp.asarray(z["b"]), a=jnp.asarray(z["a"]))


def save_secret_key(path: str, sk: SecretKey, params: GLParams) -> None:
    np.savez_compressed(path, s_mont=np.asarray(sk.s_mont),
                        fp=params_fingerprint(params))


def load_secret_key(path: str, params: GLParams) -> SecretKey:
    z = np.load(path)
    _check(z, params)
    return SecretKey(s_mont=jnp.asarray(z["s_mont"]))


def _check(z, params: GLParams) -> None:
    fp = str(z["fp"])
    want = params_fingerprint(params)
    if fp != want:
        raise ValueError(
            f"checkpoint was written for params {fp}, context has {want}")


def save_matmul_tensor(path: str, tt, params: GLParams) -> None:
    """Checkpoint a homomorphic-GEMM tensor (models/he_matmul.MatmulTensor):
    the rank-2 object a server ships back for two-sided-key decryption."""
    np.savez_compressed(path, fp=params_fingerprint(params),
                        **{k: np.asarray(v) for k, v in tt._asdict().items()})


def load_matmul_tensor(path: str, params: GLParams):
    from ..models.he_matmul import MatmulTensor
    z = np.load(path)
    _check(z, params)
    return MatmulTensor(**{k: jnp.asarray(z[k])
                           for k in MatmulTensor._fields})


# -- switching / rotation keys (models/keyswitch.py) -------------------------
#
# Switching keys live over the extended QP basis, so they are fingerprinted
# against the RelinContext's ext_params (Q chain AND P basis): a key restored
# into a context with a different P basis is garbage, not just mismatched.

def _pack_relin(rk, prefix: str = "") -> dict:
    arrs = {f"{prefix}dnum": np.asarray(len(rk.b))}
    for i, (b, a) in enumerate(zip(rk.b, rk.a)):
        arrs[f"{prefix}b{i}"] = np.asarray(b)
        arrs[f"{prefix}a{i}"] = np.asarray(a)
    return arrs


def _unpack_relin(z, prefix: str = ""):
    from ..models.keyswitch import RelinKey
    d = int(z[f"{prefix}dnum"])
    return RelinKey(
        b=tuple(jnp.asarray(z[f"{prefix}b{i}"]) for i in range(d)),
        a=tuple(jnp.asarray(z[f"{prefix}a{i}"]) for i in range(d)))


def save_relin_key(path: str, rk, rc) -> None:
    """Checkpoint a switching key (RelinKey: dnum (b, a) digit pairs)."""
    np.savez_compressed(path, fp=params_fingerprint(rc.ext_params),
                        **_pack_relin(rk))


def load_relin_key(path: str, rc):
    z = np.load(path)
    _check(z, rc.ext_params)
    return _unpack_relin(z)


def save_galois_keys(path: str, gk, _kind: str | None = None) -> None:
    """Checkpoint a GaloisKeys / XGaloisKeys set: only the per-index
    switching keys travel; permutation/sign tables are pure functions of
    the parameter set and are re-derived on load.  The file carries a
    kind tag ("w"/"x") so loading with the wrong-axis loader raises
    instead of silently building wrong rotation keys."""
    from ..models.keyswitch import FullGaloisKeys, XGaloisKeys
    if isinstance(gk, FullGaloisKeys) and _kind is None:
        # a bare FullGaloisKeys has no _keys attribute — delegate
        # instead of failing with an opaque AttributeError.
        save_full_galois_keys(path, gk)
        return
    kind = _kind or ("x" if isinstance(gk, XGaloisKeys) else "w")
    arrs = {"idx": np.asarray(sorted(gk._keys)), "kind": np.asarray(kind)}
    for j in sorted(gk._keys):
        arrs.update(_pack_relin(gk._keys[j], prefix=f"k{j}_"))
    np.savez_compressed(path, fp=params_fingerprint(gk.rc.ext_params),
                        **arrs)


def _load_key_dict(path: str, rc, kind: str) -> dict:
    z = np.load(path)
    _check(z, rc.ext_params)
    got = str(z["kind"]) if "kind" in z else kind
    if got != kind:
        loader = {"x": "load_x_galois_keys", "w": "load_galois_keys",
                  "w-full": "load_full_galois_keys"}.get(got, "?")
        raise ValueError(
            f"checkpoint holds {got!r}-kind Galois keys; use {loader}")
    return {int(j): _unpack_relin(z, prefix=f"k{int(j)}_")
            for j in z["idx"]}


def load_galois_keys(path: str, rc):
    """Restore a W-axis GaloisKeys set into `rc` (no key generation)."""
    from ..models.keyswitch import GaloisKeys, w_automorphism_perm
    keys = _load_key_dict(path, rc, "w")
    gk = object.__new__(GaloisKeys)
    gk.rc = rc
    gk._keys = keys
    gk._perms = {j: jnp.asarray(w_automorphism_perm(rc.ctx.params, j))
                 for j in keys}
    return gk


def save_full_galois_keys(path: str, fk) -> None:
    """Checkpoint a FullGaloisKeys set (the inner generator-tower keys;
    group tables are a pure function of p and rebuild on load).  Tagged
    'w-full' so the plain-GaloisKeys loader rejects it and vice versa."""
    save_galois_keys(path, fk._gk, _kind="w-full")


def load_full_galois_keys(path: str, rc):
    from ..models.keyswitch import FullGaloisKeys, GaloisKeys, \
        w_automorphism_perm
    fk = object.__new__(FullGaloisKeys)
    fk._init_tables(rc.ctx.params.p)
    keys = _load_key_dict(path, rc, "w-full")
    gk = object.__new__(GaloisKeys)
    gk.rc = rc
    gk._keys = keys
    gk._perms = {j: jnp.asarray(w_automorphism_perm(rc.ctx.params, j))
                 for j in keys}
    fk._gk = gk
    return fk


def load_x_galois_keys(path: str, rc):
    """Restore an X-axis XGaloisKeys set into `rc`."""
    from ..models.keyswitch import XGaloisKeys, x_automorphism_maps
    keys = _load_key_dict(path, rc, "x")
    gk = object.__new__(XGaloisKeys)
    gk.rc = rc
    gk.x_dim = rc.x_dim
    gk._keys = keys
    gk._maps = {}
    for k in keys:
        gi, sg, _perm = x_automorphism_maps(gk.x_dim, k)
        gk._maps[k] = (jnp.asarray(gi), jnp.asarray(sg < 0))
    return gk
