"""Data and channel parallelism over `torch.distributed` (port of
`dgq_tpu/parallel/mesh.py`).

The JAX package runs one process over an in-process device `Mesh` and lets
GSPMD insert the collectives. The port runs one process per rank, started by
`torchrun` (or SLURM), and calls the collectives where the math needs them:

  * `init_multihost` joins the process group from explicit arguments,
    torchrun's environment or SLURM's;
  * `make_mesh` describes the run (`Mesh`: dp, tp, rank, world, the dp
    and tp groups and the rank's device); rank = d * tp + t, the layout of
    the JAX package's `devices.reshape(dp, tp)`;
  * `shard_batch` / `batch_rows` give rank r its contiguous rows
    [r n/dp, (r+1) n/dp), the layout of JAX's `NamedSharding(P("dp"))`;
  * `sync_mean` averages a tree over the world (the reference's
    `allaverage`); `all_reduce_sum_`, `broadcast_` and `barrier` are the
    collectives the reconstruction walk calls;
  * `batch_split` / `batch_reduce_` make a reduction over a batch whose
    rows the ranks share (the real-time softmax quantizer's delta) run over
    every rank's rows, as GSPMD keeps it global in the JAX package;
  * `shard_prompts` slices a prompt list over independent processes;
  * `shard_params_tp` cuts each weight's out channels over the tp group and
    marks the layer, whose forward then takes the column-parallel rule of
    `parallel.tp`; `gather_params_tp` puts the whole tensors back together
    for a write;
  * `leave_multihost` ends a rank's part: a barrier, then the groups
    destroyed and their threads joined before the process exits.

Backend rule: NCCL when every rank of a node has a card of its own; gloo on
the CPU or when ranks share a card (NCCL refuses two ranks on one device;
gloo takes CUDA tensors for all_reduce, broadcast and all_gather). A
collective that fails raises: nothing falls back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import weakref
from typing import Optional

import torch
import torch.distributed as dist

from dgq_tpu_torch.parallel.tp import TPShard, all_gather_rows, held_weakly
from dgq_tpu_torch.quant.affine import QParams


def _env_int(*names: str) -> Optional[int]:
    """The first of the environment variables `names` that is set, as an int."""
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def node_tasks(world: int) -> int:
    """The most ranks any node runs: torchrun's LOCAL_WORLD_SIZE; else the
    largest count of SLURM_TASKS_PER_NODE, which SLURM always sets ('4(x2)':
    4 on each of 2 nodes; '2(x3),1'); else `world` (one node). Every rank
    reads the same value, so every rank picks the same backend."""
    found = _env_int("LOCAL_WORLD_SIZE")
    if found is not None:
        return found
    if "SLURM_TASKS_PER_NODE" in os.environ:
        return max(int(part.split("(")[0])
                   for part in os.environ["SLURM_TASKS_PER_NODE"].split(","))
    return world


def local_rank() -> int:
    """This process's rank on its node: torchrun's LOCAL_RANK, SLURM's
    SLURM_LOCALID, else its global rank."""
    found = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    if found is not None:
        return found
    return dist.get_rank() if dist.is_initialized() else 0


def pick_backend(device: str, local_world: int) -> str:
    """NCCL when each of a node's `local_world` ranks (`node_tasks`) has a
    card of its own, gloo on the CPU or when ranks share a card."""
    if device == "cpu" or torch.cuda.device_count() < local_world:
        return "gloo"
    return "nccl"


def rank_device(device: str) -> str:
    """The device this rank runs on: 'cpu', or cuda:{local rank} (modulo the
    node's cards, so ranks that share one card all take cuda:0)."""
    if device == "cpu":
        return "cpu"
    return f"cuda:{local_rank() % max(torch.cuda.device_count(), 1)}"


def describe_rank(device: str) -> str:
    """'rank r of w: backend b, device d', for each rank's first log line."""
    return (f"rank {dist.get_rank()} of {dist.get_world_size()}: backend "
            f"{dist.get_backend()}, device {rank_device(device)}")


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None, process_id: Optional[int] = None,
                   device: str = "cuda") -> bool:
    """Join the process group, the counterpart of the reference's linklink
    SLURM / TCP init. Reads, in this order: the explicit arguments
    (`coordinator_address` 'host:port', or an init method such as
    'tcp://host:port' or 'file:///path'); torchrun's MASTER_ADDR /
    MASTER_PORT / RANK / WORLD_SIZE / LOCAL_RANK; SLURM's SLURM_PROCID /
    SLURM_NTASKS / SLURM_LOCALID (the address still from MASTER_ADDR /
    MASTER_PORT). Returns False when none of these is set, True once the
    group is up (at once when it already is). The backend follows
    `pick_backend`; a CUDA rank then takes its card (`rank_device`)."""
    if dist.is_initialized():
        return True
    rank = process_id if process_id is not None else _env_int("RANK", "SLURM_PROCID")
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE",
                                                                      "SLURM_NTASKS")
    if coordinator_address is not None:
        init = coordinator_address if "://" in coordinator_address else (
            f"tcp://{coordinator_address}")
    elif "MASTER_ADDR" in os.environ:
        init = "env://"  # torchrun's agent may host the store: connect as it says
    elif rank is not None or world is not None:
        raise RuntimeError(f"rank {rank} of {world} found in the environment, but no "
                           f"rendezvous: export MASTER_ADDR and MASTER_PORT (the address and "
                           f"a free port of rank 0's host), or launch with torchrun")
    else:
        return False
    if rank is None or world is None:
        raise RuntimeError(f"a rendezvous ({init}) without a rank and a world size: pass "
                           f"process_id / num_processes, or set RANK and WORLD_SIZE")
    backend = pick_backend(device, node_tasks(world))
    if device != "cpu":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    return True


@dataclasses.dataclass(frozen=True, init=False)
class Mesh:
    """A (dp, tp) run: this process's rank of the world, rank = d * tp + t;
    `group`, the dp group (the dp ranks that share t; the world when tp = 1,
    None in a world of one); `tp_group`, the tp group (the tp ranks that
    share d; None when tp = 1); and the rank's device. The groups are held
    weakly (`parallel.tp.held_weakly`): both are None once the process group
    is destroyed."""
    dp: int
    tp: int
    rank: int
    world: int
    group_ref: Optional[weakref.ref]
    device: str
    tp_group_ref: Optional[weakref.ref]

    def __init__(self, dp: int, tp: int, rank: int, world: int, group, device: str,
                 tp_group=None):
        for name, value in (("dp", dp), ("tp", tp), ("rank", rank), ("world", world),
                            ("group_ref", held_weakly(group)), ("device", device),
                            ("tp_group_ref", held_weakly(tp_group))):
            object.__setattr__(self, name, value)

    @property
    def group(self):
        return None if self.group_ref is None else self.group_ref()

    @property
    def tp_group(self):
        return None if self.tp_group_ref is None else self.tp_group_ref()

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def _groups(dp: int, tp: int, rank: int) -> tuple:
    """(dp group, tp group) of `rank`. Every rank makes every group, in the
    same order (all dp groups, then all tp groups), as `new_group` needs."""
    if tp == 1:
        return dist.group.WORLD, None
    dp_group = tp_group = None
    for t in range(tp):
        group = dist.new_group([d * tp + t for d in range(dp)])
        if rank % tp == t:
            dp_group = group
    for d in range(dp):
        group = dist.new_group(list(range(d * tp, (d + 1) * tp)))
        if rank // tp == d:
            tp_group = group
    return dp_group, tp_group


def make_mesh(dp: Optional[int] = None, tp: int = 1, multihost: bool = False,
              device: str = "cuda", program: str = "<module>") -> Mesh:
    """The (dp, tp) mesh over the process group, joined first (from the
    environment, `init_multihost`) when dp * tp > 1 or `multihost`; dp None
    takes every rank. Raises unless the world holds dp * tp ranks, naming the
    torchrun line that starts `program`."""
    if multihost or (dp or 1) * tp > 1:
        init_multihost(device=device)
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    dp = world // tp if dp is None else dp
    if world != dp * tp:
        raise RuntimeError(
            f"dp={dp} tp={tp} needs a process group of {dp * tp} ranks; this process is in "
            f"one of {world}. Start one process per rank with torchrun: `torchrun "
            f"--nproc_per_node {dp * tp} -m {program} ...` (or under SLURM with MASTER_ADDR "
            f"and MASTER_PORT exported)")
    rank = dist.get_rank() if up else 0
    dp_group, tp_group = _groups(dp, tp, rank) if up else (None, None)
    return Mesh(dp, tp, rank, world, dp_group, rank_device(device), tp_group)


def batch_rows(mesh: Optional[Mesh], n: int) -> slice:
    """Rank r's contiguous rows of a batch of n: [r n/dp, (r+1) n/dp), the
    layout of JAX's NamedSharding(P("dp")); all of them without a mesh or
    with dp = 1. n must divide by dp."""
    if mesh is None or mesh.dp == 1:
        return slice(0, n)
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not shard over dp={mesh.dp}")
    per = n // mesh.dp
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def shard_batch(mesh: Optional[Mesh], tree):
    """Every tensor (or array) of `tree` (dicts, tuples and lists of them)
    cut to this rank's rows of its leading axis (`batch_rows`)."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return tree[batch_rows(mesh, tree.shape[0])]


def _collective_device(mesh: Optional[Mesh]) -> str:
    if mesh is not None:
        return mesh.device
    return f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "cpu"


def sync_mean(mesh: Optional[Mesh], tree):
    """The mean of each leaf of a per-process tree over the world (the
    reference's `allaverage`: all_reduce, divide by the world size): every
    process passes its own statistic (a tensor of any shape, or a Python
    number) and receives the mean, a float32 / float64 tensor on the leaf's
    device or a float. In a world of one: the tree itself."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    world = dist.get_world_size()
    where = _collective_device(mesh)

    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(leaf(x) for x in v)
        if torch.is_tensor(v):
            dtype = torch.float64 if v.dtype == torch.float64 else torch.float32
            t = v.detach().to(where, dtype).clone()
        else:
            t = torch.tensor(float(v), dtype=torch.float64, device=where)
        dist.all_reduce(t)
        t /= world
        return t.to(v.device) if torch.is_tensor(v) else float(t)
    return leaf(tree)


@torch.no_grad()
def _flat(tensors: list, collective) -> None:
    """collective(one flat buffer of `tensors`), copied back into them."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_reduce_sum_(mesh: Mesh, tensors: list) -> None:
    """Sum `tensors` (one dtype, one device) over the dp group, in place,
    in one collective."""
    _flat(tensors, lambda flat: dist.all_reduce(flat, group=mesh.group))


def all_reduce_tp_(mesh: Mesh, tensors: list) -> None:
    """Sum `tensors` (one dtype, one device) over the tp group, in place,
    in one collective."""
    _flat(tensors, lambda flat: dist.all_reduce(flat, group=mesh.tp_group))


def broadcast_(mesh: Mesh, tensors: list) -> None:
    """The values of `tensors` on dp rank 0 of this rank's dp group (global
    rank t, where the rank's own tp shard lives too) on every rank of the
    group, in place."""
    _flat(tensors, lambda flat: dist.broadcast(flat, mesh.tp_rank, group=mesh.group))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh (nothing without one)."""
    if mesh is not None and mesh.world > 1:
        dist.barrier()


def leave_multihost() -> None:
    """Leave the process group, the last call of a rank: a barrier, so that
    no rank closes its connections while a peer still runs a collective over
    them, then every group destroyed. Meshes and layer marks hold their
    groups weakly, so the groups are freed here and their backend's threads
    joined: a gloo rank that reached the interpreter's exit with them still
    running could abort there ("terminate called without an active
    exception", exit code -6). Nothing without a process group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# The process group of a data-parallel run that splits each batch's rows over
# its ranks while `batch_split` is open; None otherwise.
_BATCH_GROUP: list = [None]


@contextlib.contextmanager
def batch_split(mesh: Optional[Mesh]):
    """Within the block each rank of `mesh` runs its own rows of batches
    that are, whole, one function of all their rows: a reduction over the
    batch (`batch_reduce_`) then runs over every rank's rows. Without a
    mesh, or with dp = 1, nothing changes."""
    saved = _BATCH_GROUP[0]
    _BATCH_GROUP[0] = mesh.group if mesh is not None and mesh.dp > 1 else None
    try:
        yield
    finally:
        _BATCH_GROUP[0] = saved


def batch_reduce_(t: torch.Tensor, op: str) -> torch.Tensor:
    """t, a "min" or "max" over this rank's rows of a batch, made the same
    reduction over every rank's rows, in place on t's device, inside
    `batch_split`; t unchanged outside it. Returns t."""
    group = _BATCH_GROUP[0]
    if group is not None:
        dist.all_reduce(t, op={"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op],
                        group=group)
    return t


def _cut(v, mark: Optional[TPShard], device):
    """v on `device`: the mark's rows of it, as a new tensor, where v is a
    tensor whose axis 0 is the layer's whole out count (a QParams field by
    field); v whole otherwise."""
    if isinstance(v, QParams):
        return QParams(*(_cut(f, mark, device) for f in v))
    if not torch.is_tensor(v):
        return v
    if mark is not None and v.dim() >= 1 and v.shape[0] == mark.out:
        part = v[mark.rows]
        return torch.empty(part.shape, dtype=part.dtype, device=device).copy_(part)
    return v.to(device)


def shard_params_tp(mesh: Optional[Mesh], tree: dict, like: Optional[dict] = None) -> dict:
    """The JAX package's `shard_params_tp` in the port's layouts: the out
    axis is axis 0 (OIHW convs, (O, I) linears), where JAX's HWIO / (I, O)
    put it last. A layer whose weight has 2 or more dimensions and an out
    count O that divides by tp keeps rows [t O/tp, (t+1) O/tp) of every
    leaf whose axis 0 is O (the weight and its bias) and is marked with a
    `parallel.tp.TPShard`; every other leaf is replicated. Each leaf is put
    on the mesh's device, a cut one as a fresh copy of the rank's rows, so
    weights built on the host reach the card one shard at a time.

    like: the rank's cut params; `tree` is then a dict keyed by layer name of
    tensors or QParams (weight scales, AdaRound offsets) in the whole
    layers' shapes, cut where `like`'s layers are. The identity without a
    mesh or with tp = 1. Needs no process group."""
    if mesh is None or mesh.tp == 1:
        return tree
    out = {}
    for name, v in tree.items():
        if like is not None:
            out[name] = _cut(v, (like.get(name) or {}).get("tp"), mesh.device)
            continue
        w = v.get("w")
        cut = torch.is_tensor(w) and w.dim() >= 2 and w.shape[0] % mesh.tp == 0
        mark = TPShard(mesh.tp_group, mesh.tp, mesh.tp_rank, w.shape[0]) if cut else None
        out[name] = {k: _cut(x, mark, mesh.device) for k, x in v.items()}
        if cut:
            out[name]["tp"] = mark
    return out


def _joined(v, mark: Optional[TPShard]):
    """v on the host, gathered over the mark's group where its axis 0 is
    the rank's rows of the layer's out axis (a QParams field by field)."""
    if isinstance(v, QParams):
        return QParams(*(_joined(f, mark) for f in v))
    if not torch.is_tensor(v):
        return v
    if mark is not None and v.dim() >= 1 and v.shape[0] == mark.out // mark.tp:
        v = all_gather_rows(v.detach(), mark)
    return v.cpu()


def gather_params_tp(mesh: Optional[Mesh], tree: dict, like: Optional[dict] = None) -> dict:
    """The whole tensors of a tree that `shard_params_tp` cut, on the host,
    the marks dropped: every cut leaf all-gathered over its tp group and
    moved to the host at once, so the card never holds more than one whole
    leaf beside the shards (the JAX package gets the same from `np.asarray`
    of a sharded array). `like` as in `shard_params_tp`. A collective: every
    rank of every tp group calls it. The identity without a mesh or with
    tp = 1."""
    if mesh is None or mesh.tp == 1:
        return tree
    if like is not None:
        return {name: _joined(v, (like.get(name) or {}).get("tp")) for name, v in tree.items()}
    return {name: {k: _joined(x, p.get("tp")) for k, x in p.items() if k != "tp"}
            for name, p in tree.items()}


def shard_prompts(prompts: list, rank: int, world_size: int) -> list:
    """Process `rank` handles its contiguous slice of the prompt list (the
    reference's gen4eval_SD.py:235 scheme)."""
    n = len(prompts)
    per = (n + world_size - 1) // world_size
    return prompts[rank * per : (rank + 1) * per]
