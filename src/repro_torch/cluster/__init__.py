"""Multi-host cluster layer: sharded snapshot store + locality scheduling.

  shardmap.py  -- consistent-hash ring (virtual nodes, replication)
  snapstore.py -- two-tier sharded WS store (local / remote shard / origin)
  node.py      -- WorkerNode: Orchestrator + Router + policy + L1 cache
  scheduler.py -- ClusterRouter: fleet admission, locality placement,
                  node-failure rerouting, ring rebalance
  demand.py    -- DemandAggregator: fleet-wide demand forecasts pushed to
                  the owner shards ahead of spillover
"""
from .demand import DemandAggregator, DemandConfig
from .node import NodeDownError, WorkerNode
from .scheduler import (ClusterInvocation, ClusterRouter, NoAliveNodeError,
                        ScheduleConfig, build_fleet)
from .shardmap import ConsistentHashRing, stable_hash
from .snapstore import ShardedSnapshotStore, TransferModel
