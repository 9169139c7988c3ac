"""Multi-process scaling over torch.distributed (port of `dgq_tpu/parallel/`):
data parallelism and prompt sharding. Channel parallelism waits for ROADMAP
queue 1, item 17b."""

from dgq_tpu_torch.parallel.mesh import (  # noqa: F401
    init_multihost,
    make_mesh,
    shard_batch,
    shard_prompts,
    sync_mean,
)
