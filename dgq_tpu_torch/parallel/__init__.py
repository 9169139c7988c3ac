"""Multi-process scaling over torch.distributed (port of `dgq_tpu/parallel/`):
data parallelism, prompt sharding and channel parallelism (`mesh.
shard_params_tp`, the cut layers' rule in `tp`)."""

from dgq_tpu_torch.parallel.mesh import (  # noqa: F401
    init_multihost,
    gather_params_tp,
    make_mesh,
    shard_batch,
    shard_params_tp,
    shard_prompts,
    sync_mean,
)
