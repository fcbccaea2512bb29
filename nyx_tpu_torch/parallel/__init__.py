from .mesh import Mesh, ensemble_mesh, run_on_shards, shard_ensemble

__all__ = ["Mesh", "ensemble_mesh", "run_on_shards", "shard_ensemble"]
