from dvd_tpu_torch.parallel.mesh import (
    batch_slice,
    init_distributed,
    make_mesh,
    param_sharding_rules,
    shard_params,
)

__all__ = ["batch_slice", "init_distributed", "make_mesh",
           "param_sharding_rules", "shard_params"]
