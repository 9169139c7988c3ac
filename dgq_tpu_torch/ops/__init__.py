"""Hot-path ops: attention with hand-written CUDA kernels (csrc/) and their plain versions."""
