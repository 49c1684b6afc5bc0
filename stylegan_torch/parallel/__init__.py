"""Data and spatial parallelism over ranks (the port's counterpart of
``stylegan_tpu/parallel``): one process per device, joined by
``torch.distributed``.  The spatial path is the serving forward
(``spatial.py``); the 2-D (data, spatial) train step is not ported yet."""

from .distributed import (average_gradients, broadcast_, global_shard,
                          host_count, host_index, initialize_distributed,
                          is_multihost, replicate, spawn)
from .mesh import (Mesh, compatible_mesh_size, create_mesh, device_count,
                   resolve_max_devices)
from .spatial import (SPATIAL_AXIS, build_spatial_sample_fn,
                      create_spatial_mesh, gather_rows, spatial_hbm_estimate)

__all__ = ["Mesh", "create_mesh", "device_count", "compatible_mesh_size",
           "resolve_max_devices", "host_count", "host_index",
           "initialize_distributed", "is_multihost", "global_shard",
           "replicate", "broadcast_", "average_gradients", "spawn",
           "SPATIAL_AXIS", "create_spatial_mesh", "build_spatial_sample_fn",
           "gather_rows", "spatial_hbm_estimate"]
