"""Prompt sharding for embarrassingly parallel evaluation (port of
`shard_prompts` in `dgq_tpu/parallel/mesh.py`). The device mesh, the batch
and parameter sharding and `sync_mean` wait for ROADMAP queue 1, item 17."""
from __future__ import annotations


def shard_prompts(prompts: list, rank: int, world_size: int) -> list:
    """Process `rank` handles its contiguous slice of the prompt list (the
    reference's gen4eval_SD.py:235 scheme)."""
    n = len(prompts)
    per = (n + world_size - 1) // world_size
    return prompts[rank * per : (rank + 1) * per]
