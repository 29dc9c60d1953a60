"""Device-mesh helpers.

The reference is strictly single-GPU (SURVEY §2, parallelism inventory: no
NCCL/MPI, no multi-device partitioning); multi-device scaling here is
designed from scratch on jax.sharding.  Meshes take jax.devices() in order:
the devices of one host are all-to-all peers, so the mesh follows the
algorithm alone.

  axes
    dp    — data parallel over independent ciphertexts / messages
    tp    — tensor parallel over the W (lane) axis: W-CRT matmuls become
            sharded matmuls; XLA inserts the psum/all-gather
    coeff — coefficient-sharded large-N NTT (explicit all_to_all in
            parallel/dist_ntt.py)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Dict[str, int], devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from {'dp': 2, 'tp': 4}-style shape; validates the device
    count."""
    devs = list(devices) if devices is not None else list(jax.devices())
    total = int(np.prod(list(shape.values())))
    if total > len(devs):
        raise ValueError(f"mesh {shape} needs {total} devices, "
                         f"have {len(devs)}")
    arr = np.array(devs[:total]).reshape(tuple(shape.values()))
    return Mesh(arr, tuple(shape.keys()))


def factor_mesh(n_devices: int, want_dp: int = 2) -> Dict[str, int]:
    """Split n_devices into (dp, tp) with dp | n_devices."""
    dp = want_dp if n_devices % want_dp == 0 and n_devices >= want_dp else 1
    return {"dp": dp, "tp": n_devices // dp}


def msg_sharding(mesh: Mesh) -> NamedSharding:
    """Message batch [B, W, n, n]: batch over dp, matrix rows (y) over tp.

    Audit: tp over the W lane axis fights every
    W-CRT contraction (6 all-reduces of full eval arrays per roundtrip);
    tp over the y matrix axis keeps the same collective count but moves it
    to the small complex transforms — measured 2x cheaper on the virtual
    mesh.  dp remains the zero-communication axis of choice."""
    return NamedSharding(mesh, P("dp", None, "tp", None))


def packed_sharding(mesh: Mesh) -> NamedSharding:
    """Packed plaintext / ciphertext component batch [B, L, W, n, n]
    (same tp-axis choice as msg_sharding)."""
    return NamedSharding(mesh, P("dp", None, None, "tp", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
