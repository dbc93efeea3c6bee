"""Sharded execution over ``torch.distributed`` (the port of
``repro.distributed``).

Studies: ``execute_plan_sharded`` runs a plan shard-local on every rank of
a process group and leaves each table output on its ranks
(``ShardedTable``); ``launch`` spawns the ranks on one host.

Models: ``sharding`` holds the reference's layout rules (TP, EP, DP,
ZeRO-1; specs a leaf) and a rank's blocks, ``hints`` the ambient mesh
(``launch.mesh.Mesh``) that the model code reads, ``pipeline`` GPipe
(``gpipe``, ``pipeline_transformer``), and ``comm`` the collectives of
both, those of the models differentiable.
"""
from repro_torch.distributed.pipeline import (ShardedTable,
                                              execute_plan_sharded, gpipe,
                                              pad_tables_for_mesh,
                                              pipeline_transformer,
                                              shard_rows)

__all__ = ["ShardedTable", "execute_plan_sharded", "pad_tables_for_mesh",
           "shard_rows", "gpipe", "pipeline_transformer"]
