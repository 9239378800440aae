"""Multi-device tracing over `torch.distributed` (counterpart of
`gradus_tpu/parallel/`): the ray mesh and its collectives, the sharded
trace, render, line profile and emissivity, B1 under the mesh, the
multichip step, and `spawn`, which starts a mesh's ranks on this host."""

from gradus_tpu_torch.parallel.launch import spawn
from gradus_tpu_torch.parallel.mesh import RayMesh, all_gather, pmax, pmin, psum, ray_mesh, shard_rows
from gradus_tpu_torch.parallel.multichip import multichip_step, render_tile
from gradus_tpu_torch.parallel.sharded import (
    pad_to_multiple,
    sharded_emissivity,
    sharded_lineprofile,
    sharded_pallas_trace,
    sharded_render,
    sharded_trace,
)
