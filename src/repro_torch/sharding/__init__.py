from repro_torch.sharding.flat import (EDGE_AXIS, POD_AXIS, Mesh,  # noqa: F401
                                       edge_traffic, is_hier,
                                       make_hier_mesh, make_pod_mesh,
                                       mesh_reduce, mesh_shape, mesh_size,
                                       podwise_bank_sums, podwise_sums,
                                       shard_rows)
