"""Splitting a batch of bootstraps across devices (counterpart of
`tfhe_tpu/parallel/`)."""
from .mesh import (Mesh, Replicated, make_mesh, pbs_sharding_specs, replicate_tree,
                   shard_lwe_batch, shard_map_kspbs, shard_server_key_tree)

__all__ = ["Mesh", "Replicated", "make_mesh", "pbs_sharding_specs", "replicate_tree",
           "shard_lwe_batch", "shard_map_kspbs", "shard_server_key_tree"]
