"""Multi-chip serving: data-parallel kmer_to_occ over a device mesh.

The KModel's probe tables (Bloom bank, coupled bit arrays, rest store — tens
of MB even at genome scale) replicate onto every chip; query batches shard
over the mesh's "shard" axis.  Every op in the query program is
batch-parallel, so the SPMD partitioner runs each chip on its slice of the
batch against its local table copy — zero collectives, linear scaling.  This
is the device form of the reference's OpenMP query fan-out
(/root/reference/kmodel.hpp:90-98): threads over cores becomes lanes over
chips.

Answers are bit-identical to the single-chip and host paths (asserted in
tests/test_sharded.py on a virtual CPU mesh).
"""

from __future__ import annotations

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kmcex.query.device_model import DeviceKModel


class ShardedKModelServer(DeviceKModel):
    """DeviceKModel with the model replicated and queries batch-sharded
    across ``mesh``.  Same API: ``kmer_to_occ(packed_u64_array)``."""

    def __init__(self, km, mesh: Mesh, tile: int | None = None):
        n = int(mesh.devices.size)
        if n & (n - 1):
            raise ValueError("mesh size must be a power of two (tile padding)")
        self.mesh = mesh
        super().__init__(
            km,
            sharding=NamedSharding(mesh, P()),          # tables: replicated
            in_sharding=NamedSharding(mesh, P("shard")),  # queries: sharded
        )
        if tile:
            if tile % n:
                raise ValueError(
                    f"tile={tile} must be a multiple of the mesh size {n} "
                    "(full tiles shard over the batch axis; only short tails "
                    "are padded)"
                )
            self.TILE = tile


def make_server(km, n_devices: int | None = None, devices=None,
                tile: int | None = None) -> ShardedKModelServer:
    """Convenience: mesh over all (or the first n) devices + server."""
    from kmcex.parallel.sharded import make_mesh

    return ShardedKModelServer(km, make_mesh(n_devices, devices), tile=tile)
