"""The sharded pipeline of the port on ``torch.distributed``.

Port of ``buildingsegment_tpu/dist/``: one process a shard of the
Morton-sorted cloud, ring halos between neighbouring ranks, and
collective label tables (:mod:`.mesh`, :mod:`.halo`, :mod:`.sharded`).
"""

from buildingsegment_tpu_torch.dist.halo import halo_pad, ring_halo
from buildingsegment_tpu_torch.dist.mesh import (
    POINTS_AXIS, ShardGroup, make_mesh, make_multihost_mesh, shard_rows,
    spawn,
)
from buildingsegment_tpu_torch.dist.sharded import (
    sharded_grow_body, sharded_pipeline, sharded_seg_body,
    sharded_stats_body,
)

__all__ = [
    "POINTS_AXIS", "ShardGroup", "make_mesh", "make_multihost_mesh",
    "shard_rows", "spawn", "halo_pad", "ring_halo", "sharded_pipeline",
    "sharded_seg_body", "sharded_stats_body", "sharded_grow_body",
]
