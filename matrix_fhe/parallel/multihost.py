"""Multi-process execution support.

The reference is a single-process, single-GPU library (SURVEY §5: no
NCCL/MPI anywhere).  Here a deployment across processes or hosts is:

  * `jax.distributed.initialize` once per process, with an explicit
    coordinator address, process count and process id;
  * a hybrid mesh: data-parallel axes vary slowest and map across
    processes, limb/lane/coefficient axes map within a process's devices —
    collectives implied by W-contractions and the dist-NTT all_to_all then
    stay inside one host, and only dp batches cross hosts;
  * host-local <-> global array plumbing via jax.make_array_from_callback
    (each process materializes only its shard).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or MFHE_COORDINATOR /
    MFHE_NUM_PROCS / MFHE_PROC_ID.

    Returns True if multi-process mode is active.  Safe to call when
    single-process (no coordinator configured): does nothing.  All three
    values are required; gloo collectives are enabled automatically on the
    CPU backend.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "MFHE_COORDINATOR")
    if num_processes is None and "MFHE_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["MFHE_NUM_PROCS"])
    if process_id is None and "MFHE_PROC_ID" in os.environ:
        process_id = int(os.environ["MFHE_PROC_ID"])

    if coordinator_address is None or not num_processes or num_processes < 2:
        return False
    # NOTE: must not touch the XLA backend before initialize(); inspect the
    # requested platform instead of jax.default_backend()
    plat = (jax.config.jax_platforms or
            os.environ.get("JAX_PLATFORMS", ""))
    if str(plat).startswith("cpu"):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int],
                devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with `dcn_axes` across processes (slowest-varying) and
    `ici_axes` within each process's devices.

    Single-process: degenerates to one flat mesh over local devices (dcn
    axes of size 1 are kept so PartitionSpecs stay identical either way).
    """
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    if devices is None and jax.process_count() > 1:
        try:
            from jax.experimental import mesh_utils
            arr = mesh_utils.create_hybrid_device_mesh(
                mesh_shape=tuple(ici_axes.values()),
                dcn_mesh_shape=(tuple(dcn_axes.values())
                                or (jax.process_count(),)),
            )
            return Mesh(arr.reshape(shape), names)
        except ValueError:
            # devices without slice structure: process-major ordering
            # gives the same host-locality property
            devs = sorted(jax.devices(),
                          key=lambda d: (d.process_index, d.id))
            return Mesh(np.array(devs).reshape(shape), names)
    devs = list(devices) if devices is not None else list(jax.devices())
    total = int(np.prod(shape))
    if total > len(devs):
        raise ValueError(f"mesh {dict(**dcn_axes, **ici_axes)} needs {total} "
                         f"devices, have {len(devs)}")
    return Mesh(np.array(devs[:total]).reshape(shape), names)


def global_from_host_data(full: np.ndarray, mesh: Mesh, spec: P):
    """Build a globally-sharded jax.Array from a numpy array every host can
    materialize (deterministic inputs): each host uploads only its shards."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(full.shape, sharding,
                                        lambda idx: full[idx])


def local_shards(arr) -> Tuple[Tuple[tuple, np.ndarray], ...]:
    """(global-index, data) for this host's addressable shards."""
    return tuple((s.index, np.asarray(s.data))
                 for s in arr.addressable_shards)
