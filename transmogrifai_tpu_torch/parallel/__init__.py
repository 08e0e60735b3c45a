from .mesh import (make_mesh, shard_cv_inputs, data_sharding,  # noqa: F401
                   process_default_mesh, set_process_mesh, mesh_if_multi,
                   mesh_topology)
