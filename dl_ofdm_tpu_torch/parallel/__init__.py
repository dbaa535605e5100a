from dl_ofdm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, shard_batch, param_sharding_rules, shard_params)
