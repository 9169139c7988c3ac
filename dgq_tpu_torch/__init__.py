"""dgq_tpu_torch: the PyTorch/CUDA port of dgq_tpu, for one NVIDIA H100.

The JAX package `dgq_tpu` is the reference; this package mirrors its module
paths and function names and keeps its public layouts (NHWC activations,
(B*H, T, D) attention inputs), so each part is tested against its JAX
counterpart on the same inputs. The plain tensor code is PyTorch; the Pallas
TPU kernels on the ported path are hand-written CUDA C++ for sm_90a
(`csrc/`), built at first use. This package imports no JAX.
"""

from dgq_tpu_torch.models.qconfig import GroupQParams, QConfig, QState  # noqa: F401
from dgq_tpu_torch.quant.affine import QParams  # noqa: F401
