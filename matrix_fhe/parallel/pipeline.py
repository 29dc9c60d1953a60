"""Sharded end-to-end HE pipelines.

Data parallel (dp) over a batch of packed messages/ciphertexts plus tensor
parallel (tp) over the matrix-row (y) axis: arrays are annotated with
NamedSharding
and the whole encode->encrypt->decrypt->decode step runs under one jit — XLA
inserts the collectives implied by the W-contracting matmuls (pick a mesh,
annotate shardings, let the compiler place collectives).  The reference has
no multi-device story at all (SURVEY §2 parallelism inventory).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..models.he import HEContext, SecretKey
from . import mesh as meshlib


class ShardedPipeline:
    """Batched, mesh-sharded roundtrip for one HEContext.

    Message batches are [B, W, n, n] float64 pairs: B is sharded over 'dp',
    the matrix-row (y) axis over 'tp' (P("dp", None, "tp", None) /
    P("dp", None, None, "tp", None) for packed RNS tensors — the W axis is
    replicated so the W-contracting matmuls need no collective); the secret
    key is replicated.
    """

    def __init__(self, ctx: HEContext, mesh: Mesh):
        self.ctx = ctx
        self.mesh = mesh
        self._msg_s = meshlib.msg_sharding(mesh)
        self._rep = meshlib.replicated(mesh)
        batched = jax.vmap(ctx.roundtrip_fn, in_axes=(0, 0, None))
        self._roundtrip = jax.jit(
            batched,
            in_shardings=(self._msg_s, self._msg_s, self._rep),
            out_shardings=(self._msg_s, self._msg_s),
        )

    def roundtrip(self, m_re: jnp.ndarray, m_im: jnp.ndarray, sk: SecretKey):
        """[B, W, n, n] f64 pair -> decoded [B, W, n, n] pair, dp x tp
        sharded."""
        return self._roundtrip(m_re, m_im, sk)
