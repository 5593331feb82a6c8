from repro_torch.sharding.ctx import (Mesh, configure, grid_mesh,  # noqa: F401
                                     head_plan, reset, shard)
