"""Host-side parameter service: a real multi-process HiPS deployment
(port of geomx_tpu/service/).

The process-topology backend the reference needed actual servers for:
genuinely asynchronous tiers (MixedSync), cross-process deployments and
PS-style elasticity.  It mirrors the reference's process roles
(SURVEY.md §1 "Node roles"): workers push to their party's local
server; local servers aggregate and relay to the global server; pulls
flow back down — over TCP with length-prefixed frames, priority send
queues (P3), per-hop compression, and heartbeat liveness.  Frames are
byte-identical to the JAX package's, so the two packages' servers,
clients and schedulers interoperate in one fleet.  The many-party
global tier shards its keys by hash range over several servers, behind a
scheduler-owned versioned map (``sharded.py``, ``shardmap.py``).
"""

from geomx_tpu_torch.service.client import GeoPSClient, WrongShardError
from geomx_tpu_torch.service.protocol import Msg, MsgType
from geomx_tpu_torch.service.scheduler import GeoScheduler, SchedulerClient
from geomx_tpu_torch.service.server import GeoPSServer
from geomx_tpu_torch.service.sharded import (ShardedGlobalClient,
                                             start_sharded_global_tier)
from geomx_tpu_torch.service.shardmap import ShardMap

__all__ = ["Msg", "MsgType", "GeoPSServer", "GeoPSClient",
           "GeoScheduler", "SchedulerClient", "ShardMap",
           "ShardedGlobalClient", "WrongShardError",
           "start_sharded_global_tier"]
