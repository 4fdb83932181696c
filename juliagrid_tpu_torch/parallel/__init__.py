"""Scenario batching, and its sharding over a mesh of ranks (see batch.py
and mesh.py)."""

from .batch import (batched_dc_solve, batched_nr_solve, batched_se_solve,
                    shard_scenarios, sharded_nr_solve, sharded_se_solve)
from .mesh import Mesh, launch, scenario_mesh

__all__ = [
    "Mesh", "batched_dc_solve", "batched_nr_solve", "batched_se_solve",
    "launch", "scenario_mesh", "shard_scenarios", "sharded_nr_solve",
    "sharded_se_solve",
]
