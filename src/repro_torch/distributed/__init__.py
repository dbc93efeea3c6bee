"""Sharded study execution over ``torch.distributed`` (the port of the
study side of ``repro.distributed``): ``execute_plan_sharded`` runs a plan
shard-local on every rank of a process group and leaves each table output
on its ranks (``ShardedTable``), ``comm`` holds its
collectives and ``launch`` spawns the ranks on one host.  Model sharding
(``sharding.py``, ``hints.py``, ``gpipe``) is not ported yet (ROADMAP A9).
"""
from repro_torch.distributed.pipeline import (ShardedTable,
                                              execute_plan_sharded,
                                              pad_tables_for_mesh,
                                              shard_rows)

__all__ = ["ShardedTable", "execute_plan_sharded", "pad_tables_for_mesh",
           "shard_rows"]
