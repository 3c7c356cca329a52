from repro_torch.sharding.flat import (EDGE_AXIS, POD_AXIS, Mesh,  # noqa: F401
                                       edge_traffic, is_hier,
                                       make_hier_mesh, make_pod_mesh,
                                       mesh_reduce, mesh_shape, mesh_size,
                                       podwise_bank_sums, podwise_sums,
                                       shard_rows)
from repro_torch.sharding.rules import (add_fsdp, batch_spec,  # noqa: F401
                                        cache_specs, param_specs,
                                        spec_for_path)
