from instruct_jax.parallel.mesh import (make_mesh, shard_dataset,
                                        chain_sharding, replicate)

__all__ = ["make_mesh", "shard_dataset", "chain_sharding", "replicate"]
