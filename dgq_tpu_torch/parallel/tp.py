"""Channel parallelism: the layers of a weight cut by `parallel.mesh.
shard_params_tp` (the port's counterpart of the JAX package's tp axis, where
GSPMD partitions each matmul and conv and inserts the collectives).

A cut layer's params dict carries a `TPShard` under the key "tp": its tp
group, the group's size, this rank's place in it and the layer's whole out
count. The layer's own rows of 'w' (and 'b') are
[index * out / tp, (index + 1) * out / tp). The rule of every cut layer:

  * its input is whole (replicated over the tp group); the rank computes its
    own out channels over the full reduction axis, so each output element is
    the unsharded layer's up to the GEMM's choice of algorithm for a
    narrower N;
  * the out channels are gathered along the channel axis (last: NHWC
    activations, (..., O) linears), so every rank again holds the whole
    output, and attention, norms, residuals and every quantizer downstream
    run replicated.

Two autograd functions carry the gradients: `copy_to_tp` is the identity
forward and sums the input's gradient over the tp group backward (each
rank's is the part from its own out channels); `gather_from_tp` all-gathers
forward and takes the rank's own slice backward, summing nothing (the layers
downstream are replicated, so every rank holds the whole, identical
gradient). `torch.distributed.nn.functional.all_gather` sums in its backward
and would hand each rank tp times its gradient.

The gather is one `all_gather_into_tensor` on every backend: gloo takes CUDA
tensors for it (PyTorch 2.11, two ranks sharing an H100; gloo also takes
them for all_reduce and broadcast), so no backend copies through the host.

Every rank of a tp group runs the same forward, so the collectives of its
cut layers meet in the same order; a caller that runs a cut layer on one
rank alone hangs. The int8, codes-fold and group-conv routes refuse a cut
layer (`refuse_sharded`): no entry point of either package sends a sharded
weight there.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch
import torch.distributed as dist


def held_weakly(group):
    """A weak reference to a process group (None for None). torch.distributed
    owns its groups: `destroy_process_group` then frees them, and their
    backend's threads stop there, whatever meshes and marks a process still
    holds (`parallel.mesh.leave_multihost`)."""
    return None if group is None else weakref.ref(group)


@dataclasses.dataclass(frozen=True, init=False)
class TPShard:
    """The mark of a cut layer: the tp process group (None in a rule check
    without a process group, and once the group is destroyed; held weakly,
    `held_weakly`), its size, this rank's index in it, and the layer's whole
    out count."""
    group_ref: Optional[weakref.ref]
    tp: int
    index: int
    out: int

    def __init__(self, group, tp: int, index: int, out: int):
        for name, value in (("group_ref", held_weakly(group)), ("tp", tp), ("index", index),
                            ("out", out)):
            object.__setattr__(self, name, value)

    @property
    def group(self):
        return None if self.group_ref is None else self.group_ref()

    @property
    def rows(self) -> slice:
        """This rank's rows of the whole out axis."""
        per = self.out // self.tp
        return slice(self.index * per, (self.index + 1) * per)


def out_count(p: dict) -> int:
    """A conv's or linear's whole out count: the mark's on a cut layer, else
    axis 0 of its weight."""
    return p["tp"].out if "tp" in p else p["w"].shape[0]


def refuse_sharded(p: dict, route: str) -> None:
    """Raise when a cut layer reaches `route`, a path with no tp form."""
    if "tp" in p:
        raise NotImplementedError(
            f"a channel-parallel layer (shard_params_tp, tp={p['tp'].tp}) reached {route}: no "
            f"entry point of either package sends a sharded weight there; gather the weights "
            f"first (parallel.mesh.gather_params_tp)")


def all_gather_rows(x: torch.Tensor, mark: TPShard) -> torch.Tensor:
    """The tp group's tensors x concatenated along axis 0, in index order,
    on every rank of the group."""
    x = x.contiguous()
    out = x.new_empty((mark.tp * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mark.group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mark):
        ctx.mark = mark
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mark.group)
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mark):
        ctx.mark = mark
        parts = all_gather_rows(y.unsqueeze(0), mark)  # (tp, ...)
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.mark.rows], None


def copy_to_tp(x: torch.Tensor, mark: TPShard) -> torch.Tensor:
    """x as it is; backward, its gradient summed over the tp group."""
    return _CopyToTP.apply(x, mark)


def gather_from_tp(y: torch.Tensor, mark: TPShard) -> torch.Tensor:
    """The tp group's out channels y (last axis) gathered into the whole
    output; backward, the rank's own slice of the gradient."""
    return _GatherFromTP.apply(y, mark)


def column_parallel(fn, p: dict, x: torch.Tensor, *args) -> torch.Tensor:
    """fn(p, x, *args) of a cut layer by the rule above: fn runs on the
    rank's own rows of the weights (a params dict without the mark) and
    the whole input, and its last axis is gathered over the tp group."""
    mark = p["tp"]
    local = {k: v for k, v in p.items() if k != "tp"}
    return gather_from_tp(fn(local, copy_to_tp(x, mark), *args), mark)
