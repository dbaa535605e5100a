from dl_ofdm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather_params, make_mesh, param_sharding_rules, shard_batch,
    shard_dims, shard_params)
