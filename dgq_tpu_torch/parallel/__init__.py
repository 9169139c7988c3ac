"""Multi-process scaling (port of `dgq_tpu/parallel/`). Only the prompt
sharding of the evaluation CLI is ported; the device mesh waits for ROADMAP
queue 1, item 17."""

from dgq_tpu_torch.parallel.mesh import shard_prompts  # noqa: F401
