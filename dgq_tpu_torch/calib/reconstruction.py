"""AdaRound / BRECQ weight reconstruction (port of
`dgq_tpu/calib/reconstruction.py`).

Walk the UNet's reconstruction units (ResnetBlock2D and
BasicTransformerBlock as blocks, the other convs and linears as lone
layers) in forward order, and for each optimise AdaRound offsets for `iters`
Adam steps against the fp unit's outputs, the inputs taken from the
quantized prefix (asym: the units before it hard-rounded with their learned
offsets).

The PyTorch form:
  * a capture runs the UNet with a `CaptureUntil` record, which ends the
    forward once the unit is recorded (the JAX package lets XLA drop what
    follows). Captures repeat per unit, the fp targets included, so no more
    than one unit's activations are held at a time, and the
    quantized-prefix capture is re-run as earlier units freeze;
  * the optimisation is a Python loop of `torch.optim.Adam` steps (the JAX
    package scans an optax Adam: the same update rule) through the unit's
    plain layers. The kernel wrappers refuse a tensor that requires grad,
    so no gradient can pass through a kernel unseen;
  * `batch_indices` is the one place the loops draw: a `torch.Generator`
    seeded from the run's seed and the unit's index. The same seed draws
    other batches than the JAX package's `jax.random` stream;
  * a unit's captures are held on the card, as the JAX package holds them
    on its device, or, when they would not fit beside what the card holds
    (`hold_on_host`), in pinned host memory, from which each Adam step's
    rows are copied to the card ahead of the step (`_RowFeed`). The rows
    are the same values either way, so the losses and offsets are too;
  * data parallelism (`calibrate_weights(mesh=)`, one process a rank): a
    rank captures only its contiguous slice of the samples (the JAX
    package's P("dp") layout), every rank draws the same global indices,
    computes the loss over those in its slice weighted by their share of the
    batch, and the gradients are summed over the dp group before each Adam
    update: the global batch's gradient, which GSPMD computes for the JAX
    package. When the sample count does not divide by dp, every rank holds
    every sample, as the JAX package replicates them;
  * channel parallelism (a mesh with tp > 1, the weights cut by
    `parallel.mesh.shard_params_tp`): a rank's offsets are its rows of each
    cut layer's, the unit's forward gathers every cut layer's out channels
    (`parallel.tp`), so the reconstruction loss is whole on every rank of a
    tp group, and each rank adds the rounding regularizer of its own
    offsets; the gradients are summed over the dp group only. The broadcasts
    of offsets run over the dp group from the rank of the same tp index, and
    a partial save gathers a unit's offsets first (rank 0 writes).

A key is a tuple of ints, `(seed,)` for a run and `(seed, u_idx)` for its
unit u_idx, standing where the JAX package folds a `jax.random` key.
"""
from __future__ import annotations

import dataclasses
import os
from contextlib import nullcontext
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dgq_tpu_torch.calib.weight_calib import EXCLUDED_LAYERS, fold_weight_quant
from dgq_tpu_torch.models.layers import (
    basic_transformer_block,
    quant_conv2d,
    quant_linear,
    resnet_block,
    silu,
    timestep_embedding,
)
from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.models.unet_sd import (
    NUM_HEADS,
    CaptureUntil,
    StopForward,
    inject_at,
    unet_sd_apply,
)
from dgq_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    all_reduce_tp_,
    barrier,
    batch_rows,
    broadcast_,
    gather_params_tp,
    shard_params_tp,
)
from dgq_tpu_torch.quant.adaround import (
    adaround_init_alpha,
    adaround_quant,
    linear_temp_decay,
    rounding_reg_loss,
)
from dgq_tpu_torch.quant.affine import QParams, fake_quant

TIB_STREAM = 987  # the temporal block's key: (seed, 987)


@dataclasses.dataclass(frozen=True)
class ReconUnit:
    kind: str          # 'resnet' | 'transformer' | 'layer' | 'tib'
    name: str          # record key / layer name
    layers: tuple      # quantizable sublayer names
    meta: tuple = ()   # for 'layer': (layer_kind, conv meta)
    sum_axis: int = -1  # the reference lp_loss sums torch axis 1; see recon_units
    heads: int = NUM_HEADS  # attention heads (SDXL: channels / min(64, base))


def recon_units(spec) -> list[ReconUnit]:
    """The reconstruction units in forward-execution order."""
    qlayers = [(n, k, m) for n, k, m in spec if k in ("conv", "linear")]
    units: list[ReconUnit] = []
    seen = set()

    # SDXL's head count is per block (inner_dim / min(64, base)); SD v1.4
    # has 8 everywhere
    is_sdxl = any(n == "add_embedding.linear_1" for n, _, _ in spec)
    base = next(m[1] for n, k, m in spec if n == "conv_in")
    to_q_dim = {n[: -len(".attn1.to_q")]: m[0] for n, k, m in qlayers
                if n.endswith(".attn1.to_q")}

    def heads_for(prefix: str) -> int:
        return to_q_dim[prefix] // min(64, base) if is_sdxl else NUM_HEADS

    def block_prefix(name):
        for marker in (".resnets.", ".transformer_blocks."):
            if marker in name:
                head, tail = name.split(marker, 1)
                idx = tail.split(".", 1)[0]
                return head + marker + idx, ("resnet" if marker == ".resnets." else "transformer")
        return None, None

    for name, kind, meta in qlayers:
        prefix, bkind = block_prefix(name)
        if prefix is None:
            if name in EXCLUDED_LAYERS:
                continue  # conv_in / conv_out are never quantized
            # a lone linear acts on (B, T, C): the reference sums torch axis
            # 1 (T), ours 1; a conv's torch axis 1 is C, ours -1; the time
            # embedding acts on (B, C)
            sum_axis = 1 if kind == "linear" else -1
            if name.startswith("time_embedding"):
                sum_axis = -1
            units.append(ReconUnit("layer", name, (name,), (kind, meta), sum_axis))
        elif prefix not in seen:
            seen.add(prefix)
            sub = [n for n, k, m in qlayers if n.startswith(prefix + ".")]
            # resnet NHWC: torch sum(1) = C -> ours -1; transformer (B, T, C):
            # torch sum(1) = T -> ours 1
            sum_axis = -1 if bkind == "resnet" else 1
            heads = heads_for(prefix) if bkind == "transformer" else NUM_HEADS
            units.append(ReconUnit(bkind, prefix, tuple(sub), (), sum_axis, heads))
    return units


def make_unit_apply(unit: ReconUnit, cfg: QConfig, with_qstate: bool = False) -> Callable:
    """(params, *inputs) -> output for one unit; with_qstate=True gives
    (params, qstate, *inputs) -> output, for the activation-delta mode."""
    if unit.kind == "resnet":
        has_shortcut = any(l.endswith("conv_shortcut") for l in unit.layers)
        fn = lambda p, qs, x, temb: resnet_block(  # noqa: E731
            p, unit.name, x, temb, qs, cfg, has_shortcut)
    elif unit.kind == "transformer":
        fn = lambda p, qs, x, ehs: basic_transformer_block(  # noqa: E731
            p, unit.name, x, ehs, unit.heads, qs, cfg)
    else:
        lkind, meta = unit.meta
        if lkind == "conv":
            _, _, _, stride, pad = meta
            fn = lambda p, qs, x: quant_conv2d(  # noqa: E731
                p[unit.name], x, unit.name, qs, cfg, stride, pad)
        else:
            fn = lambda p, qs, x: quant_linear(p[unit.name], x, unit.name, qs, cfg)  # noqa: E731
    if with_qstate:
        return fn
    return lambda p, *inputs: fn(p, None, *inputs)


def _sub_params(params: dict, unit: ReconUnit) -> dict:
    """Every params entry a unit's apply touches (its norms included)."""
    if unit.kind == "layer":
        return {unit.name: params[unit.name]}
    return {k: v for k, v in params.items() if k.startswith(unit.name + ".")}


def batch_indices(key: tuple, iters: int, batch_size: int, n: int) -> torch.Tensor:
    """The sample indices of every step of one Adam loop, (iters, batch_size)
    int64 on the CPU, drawn uniformly from [0, n) by a `torch.Generator`
    seeded from `key`. The only draw of the reconstruction loops."""
    seed = 0
    for part in key:
        seed = (seed * 1_000_003 + int(part) + 1) % 2 ** 62
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (iters, batch_size), generator=g)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s gradient at 0 (1; torch.abs gives 0)."""
    return torch.where(x >= 0, x, -x)


def _round_on(step: int, warmup: float, iters: int) -> bool:
    """step >= warmup * iters, compared in float32 as the JAX package does."""
    return bool(np.float32(step) >= np.float32(warmup * iters))


def _reg(alphas: dict, step: int, iters: int, warmup: float) -> torch.Tensor:
    """The rounding regularizer of every layer at this step's temperature,
    summed in the key order in which the JAX package sees a dict."""
    device = next(iter(alphas.values())).device
    b = linear_temp_decay(torch.full((), float(step), device=device), iters, warmup)
    return sum(rounding_reg_loss(alphas[n], b) for n in sorted(alphas))


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part of a data-parallel walk: samples [lo, hi) of n (the
    cached tensors hold only those), and the mesh whose dp group sums the
    gradients."""
    mesh: object
    lo: int
    hi: int
    n: int


def _shard(mesh, n: int) -> Optional[Shard]:
    """The rank's Shard of n samples, or None when it holds them all (no
    mesh, dp = 1, or n % dp != 0, where the JAX package replicates)."""
    if mesh is None or mesh.dp == 1 or n % mesh.dp:
        return None
    rows = batch_rows(mesh, n)
    return Shard(mesh, rows.start, rows.stop, n)


def _reg_fn(alphas: dict, iters: int, w: float, warmup: float) -> Callable:
    """step -> w times the rounding regularizer from step warmup * iters on,
    None before."""
    def reg_fn(step):
        return w * _reg(alphas, step, iters, warmup) if _round_on(step, warmup, iters) else None
    return reg_fn


CAPTURES = ("auto", "device", "host")
FEED_DEPTH = 3  # the host form's ring of row buffers: rows copied up to two steps ahead


def hold_on_host(projected: int, free: int) -> bool:
    """The placement rule of `calibrate_weights(captures="auto")` on a card:
    a unit's captures (`projected` bytes: its inputs, outputs and Fisher
    weights over the rank's samples) are held in pinned host memory when
    they exceed half of the `free` bytes of the card, and on the card
    otherwise. The other half is left to what the unit's Adam loop and the
    walk's later capture forwards and folds allocate."""
    return projected > free // 2


def _free_bytes(device) -> int:
    """The bytes a new allocation on the card can take: the free bytes
    `mem_get_info` reports and the blocks PyTorch's allocator holds unused
    (the capture forward has just returned its activations there)."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def host_memory() -> dict:
    """The host's /proc/meminfo in bytes by field ("MemTotal",
    "MemAvailable", ...: the fields given in kB); empty where it cannot be
    read."""
    try:
        with open("/proc/meminfo") as f:
            fields = [l.split() for l in f]
    except OSError:
        return {}
    return {w[0].rstrip(":"): int(w[1]) * 1024 for w in fields if len(w) == 3 and w[2] == "kB"}


def check_host_room(projected: int, mem: dict) -> None:
    """Raises when a unit's `projected` bytes of host captures exceed the
    host's MemAvailable in `mem` (`host_memory()`): page-locking them would
    fault in every page, and the kernel's OOM killer would end the process
    without a word. Checks nothing where /proc/meminfo was not read."""
    if "MemAvailable" in mem and projected > mem["MemAvailable"]:
        raise RuntimeError(
            f"a unit's captures need {projected} bytes of pinned host memory, more than "
            f"the host's MemAvailable of {mem['MemAvailable']} bytes (MemTotal "
            f"{mem.get('MemTotal', 'unknown')} bytes)")


class _Captures:
    """Where one unit's captures are held, and the host memory that holds
    them. `place` decides once, at the unit's first capture chunk:
    `captures` "device" or "host" as given; "auto" by `hold_on_host` on a
    card, and on the device on the CPU, where the host is the device. The
    decision and its bytes go to `progress`.

    On a card, host captures are page-locked: `empty` registers each tensor
    with cudaHostRegister (PyTorch's pinned allocator rounds a block up to
    a power of two: 48.75 GiB of inputs would take 64), and `close`
    unregisters them once the card has finished every copy from or into
    them. Host captures larger than the host's MemAvailable raise before
    any is allocated (`check_host_room`), and so does a registration that
    fails; nothing falls back to pageable memory."""

    def __init__(self, device, captures: str, n: int, fisher: bool,
                 progress: Optional[Callable[[str], None]] = None):
        self.device, self.captures, self.n, self.fisher = device, captures, n, fisher
        self.progress = progress
        self.host: Optional[bool] = None  # undecided until the first capture chunk
        self.projected = 0
        self._pinned: list = []

    def place(self, inputs: tuple, output: torch.Tensor) -> None:
        """Decides from the first capture chunk's inputs and output: the
        bytes a sample (with the f32 Fisher weights of the output under a
        Fisher loss) times the rank's sample count."""
        rows = output.shape[0]
        sample = (sum(x.nbytes for x in inputs) + output.nbytes) // rows
        if self.fisher:
            sample += output.numel() // rows * 4
        self.projected = sample * self.n
        card = self.device.type == "cuda"
        if self.captures == "auto":
            free = _free_bytes(self.device) if card else 0
            self.host = card and hold_on_host(self.projected, free)
            why = f"free {free / 2 ** 30:.2f} GiB on the card" if card else "the CPU computes"
        else:
            self.host = self.captures == "host"
            why = f'captures="{self.captures}"'
        where = (("in pinned host memory" if card else "in host memory") if self.host
                 else ("on the card" if card else "on the CPU"))
        if self.progress:
            self.progress(f"captures: {self.projected / 2 ** 30:.2f} GiB {where} ({why})")
        if self.host and card:
            check_host_room(self.projected, host_memory())

    @property
    def form(self) -> str:
        return "host" if self.host else "device"

    def empty(self, shape: tuple, dtype) -> torch.Tensor:
        if not self.host:
            return torch.empty(shape, dtype=dtype, device=self.device)
        t = torch.empty(shape, dtype=dtype)
        if self.device.type == "cuda" and t.nbytes:
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostRegister(t.data_ptr(), t.nbytes, 0)
            if err != cudart.cudaError.success:
                raise RuntimeError(
                    f"pinning {t.nbytes} bytes of host memory for a unit's captures failed "
                    f"({err}), beside {sum(p.nbytes for p in self._pinned)} bytes pinned "
                    f"already; the host's MemTotal is "
                    f"{host_memory().get('MemTotal', 'unknown')} bytes")
            self._pinned.append(t)
        return t

    def ready(self) -> None:
        """Waits for the copies into host captures: the one synchronisation
        before the Adam loop reads them."""
        if self.host and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        if self._pinned:
            torch.cuda.synchronize(self.device)
            cudart = torch.cuda.cudart()
            for t in self._pinned:
                cudart.cudaHostUnregister(t.data_ptr())
            self._pinned = []


class _RowFeed:
    """Each Adam step's rows of the cached tensors `data`: for step k the
    samples `rows[k]` (CPU int64) of every one, on `device`.

    Device form (host=False): the data lie on the device, and a step
    gathers its rows there. Host form: the data lie in host memory, and
    step k's rows are copied, one contiguous row at a time, into slot
    k % FEED_DEPTH of a ring of buffers on the device, FEED_DEPTH - 1 steps
    ahead of the step that reads them, on a stream of their own when the
    device is a card. Two events a slot keep the order: a step waits for
    its slot's copies (`copied`), and a slot is refilled only after the
    step that read it has run its backward (`freed`). The rows come
    straight from the (pinned) capture tensors: nothing is gathered on the
    host. Either form gives the step the same values."""

    def __init__(self, data: tuple, rows, device, host: bool):
        self.data, self.rows, self.device, self.host = data, rows, device, host
        if not host:
            self.idx = rows.to(device) if torch.is_tensor(rows) else [r.to(device) for r in rows]
            return
        size = max((len(r) for r in rows), default=0)
        self.ring = [tuple(torch.empty((size,) + x.shape[1:], dtype=x.dtype, device=device)
                           for x in data) for _ in range(min(FEED_DEPTH, len(rows)))]
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        if self.stream is not None:
            self.copied = [torch.cuda.Event() for _ in self.ring]
            self.freed = [torch.cuda.Event() for _ in self.ring]
            # The ring was allocated on the compute stream, from blocks its
            # queued kernels may still use: the first fills wait for them.
            self.stream.wait_stream(torch.cuda.current_stream(device))
        for k in range(len(self.ring)):
            self._fill(k)

    def _fill(self, k: int) -> None:
        slot = k % len(self.ring)
        ctx = torch.cuda.stream(self.stream) if self.stream is not None else nullcontext()
        with ctx:
            if self.stream is not None and k >= len(self.ring):
                self.stream.wait_event(self.freed[slot])
            for j, i in enumerate(self.rows[k].tolist()):
                for buf, x in zip(self.ring[slot], self.data):
                    buf[j].copy_(x[i], non_blocking=True)
            if self.stream is not None:
                self.copied[slot].record(self.stream)

    def get(self, k: int) -> tuple:
        if not self.host:
            return tuple(x[self.idx[k]] for x in self.data)
        slot = k % len(self.ring)
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_event(self.copied[slot])
        m = len(self.rows[k])
        return tuple(buf[:m] for buf in self.ring[slot])

    def done(self, k: int) -> None:
        """Step k has run its backward: its slot takes step k + depth's rows."""
        if not self.host:
            return
        slot = k % len(self.ring)
        if self.stream is not None:
            self.freed[slot].record(torch.cuda.current_stream(self.device))
        if k + len(self.ring) < len(self.rows):
            self._fill(k + len(self.ring))

    def close(self) -> None:
        """The compute stream waits for every copy issued (a dp rank's step
        without rows of its own never waited for its slot)."""
        if self.host and self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


def _adam_loop(leaves: dict, key: tuple, iters: int, batch_size: int, n: int, device,
               data: tuple, rec_fn: Callable, lr: float, schedule: Optional[Callable] = None,
               reg_fn: Optional[Callable] = None, shard: Optional[Shard] = None,
               mesh=None, host: bool = False):
    """Adam over the tensors of `leaves` (made leaves that require grad):
    each step's loss is rec_fn(rows), the reconstruction loss (a mean over
    the samples drawn), rows holding the step's samples of each tensor of
    `data` (the cached tensors, on `device` or, with host=True, in host
    memory: `_RowFeed`), plus reg_fn(step) where that is not None.
    schedule(step) -> the step's learning rate. Returns the losses, (iters,)
    on the device.

    With a shard, every rank draws the same global indices (of shard.n);
    rec_fn takes the ones in its slice, re-based, and its mean is weighted
    by their share of the batch; the regularizer enters on the ranks that
    hold the first slice; the gradients are summed over the dp group before
    each update, and the losses once at the end. A rank that holds none of a
    step's indices adds zeros. The slices are cut on the host here, so no
    step waits for the device.

    With a mesh of tp > 1 the leaves are the rank's shards of the offsets:
    rec_fn is whole on every rank of the tp group, reg_fn covers the rank's
    own shards, and the losses returned are the reconstruction loss plus the
    regularizer summed over the tp group (the two are summed apart, so the
    replicated reconstruction loss is counted once)."""
    params = list(leaves.values())
    opt = torch.optim.Adam(params, lr=lr)
    idx = batch_indices(key, iters, batch_size, n if shard is None else shard.n)
    if shard is None:
        rows, weights = idx, [None] * iters
    else:
        rows = [row[(row >= shard.lo) & (row < shard.hi)] - shard.lo for row in idx]
        weights = [len(m) / batch_size for m in rows]
    regularizes = shard is None or shard.lo == 0
    zero = torch.zeros((), device=device)
    recs, regs = [], []
    feed = _RowFeed(data, rows, device, host)
    try:
        for step in range(iters):
            if schedule is not None:
                for group in opt.param_groups:
                    group["lr"] = schedule(step)
            with torch.enable_grad():
                if weights[step] is None:
                    rec = rec_fn(feed.get(step))
                elif weights[step]:
                    rec = rec_fn(feed.get(step)) * weights[step]
                else:
                    rec = zero
                reg = reg_fn(step) if reg_fn is not None and regularizes else None
                loss = rec if reg is None else rec + reg
            opt.zero_grad(set_to_none=True)
            if loss.requires_grad:
                loss.backward()
            feed.done(step)
            if shard is not None:
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                all_reduce_sum_(shard.mesh, [p.grad for p in params])
            opt.step()
            recs.append(rec.detach())
            regs.append(zero if reg is None else reg.detach())
    finally:
        feed.close()
    if not recs:
        return torch.zeros(0, device=device)
    rec_out, reg_out = torch.stack(recs), torch.stack(regs)
    if shard is not None:
        all_reduce_sum_(shard.mesh, [rec_out, reg_out])
    if mesh is not None and mesh.tp > 1:
        all_reduce_tp_(mesh, [reg_out])
    return rec_out + reg_out


def _host_form(captures: str) -> bool:
    if captures not in ("device", "host"):
        raise ValueError(f'captures must be "device" or "host", not {captures!r}')
    return captures == "host"


def cosine_decay(lr: float, iters: int) -> Callable:
    """optax.cosine_decay_schedule(lr, iters): lr (1 + cos(pi min(step,
    iters) / iters)) / 2, in float32."""
    def schedule(step: int) -> float:
        count = np.float32(min(step, iters))
        decay = np.float32(0.5) * (np.float32(1.0)
                                   + np.cos(np.float32(np.pi) * count / np.float32(iters)))
        return float(np.float32(lr) * decay)
    return schedule


def reconstruct_unit_act_deltas(key: tuple, unit: ReconUnit, params_q: dict, qstate_unit: dict,
                                cached_inputs: tuple, cached_outputs: torch.Tensor,
                                cfg: QConfig, iters: int = 20000, batch_size: int = 32,
                                p_norm: float = 2.0, lr: float = 4e-5, captures: str = "device"):
    """Activation-delta reconstruction (the reference's use_aq branch): Adam
    with a cosine-annealed learning rate on the unit's activation-quantizer
    deltas, Lp loss against the fp outputs. params_q: weight-folded params;
    qstate_unit: {'a': {name: per-tensor QParams}, 'sm': ...} for this unit.
    captures: "device" (the cached tensors on the deltas' device) or "host"
    (in host memory, each step's rows copied to the device: `_RowFeed`).
    Returns (the optimised qstate subset, the losses)."""
    apply_fn = make_unit_apply(unit, cfg.replace(use_aq=True), with_qstate=True)
    sub = _sub_params(params_q, unit)
    deltas = {n: qp.delta.detach().clone().requires_grad_(True)
              for n, qp in qstate_unit["a"].items()}
    zps = {n: qp.zero_point for n, qp in qstate_unit["a"].items()}
    sm = qstate_unit.get("sm", {})

    def rec_fn(rows):
        qs = {"a": {n: QParams(deltas[n], zps[n]) for n in deltas}, "sm": sm}
        pred = apply_fn(sub, qs, *rows[:-1])
        return torch.mean(torch.sum(_abs(pred - rows[-1]) ** p_norm, dim=unit.sum_axis))

    losses = _adam_loop(deltas, key, iters, batch_size, cached_outputs.shape[0],
                        next(iter(deltas.values())).device,
                        tuple(cached_inputs) + (cached_outputs,), rec_fn, lr,
                        cosine_decay(lr, iters), host=_host_form(captures))
    return ({"a": {n: QParams(deltas[n].detach(), zps[n]) for n in deltas}, "sm": sm},
            losses)


def capture_unit_io(params: dict, cali_batch: tuple, unit_name: str, cfg: QConfig,
                    unet_apply=unet_sd_apply, want_inputs: bool = True):
    """Run the UNet on one calibration batch as far as `unit_name` and return
    the unit's (inputs, output); want_inputs=False returns ((), output).

    cali_batch: the UNet's positional tensors after `params`: SD (sample, t,
    ehs), SDXL (sample, t, ehs, text_embeds, time_ids)."""
    rec = CaptureUntil(unit_name)
    with torch.no_grad():
        try:
            unet_apply(params, *cali_batch, qstate=None, cfg=cfg, record=rec)
        except StopForward:
            pass
    if unit_name not in rec:
        raise KeyError(f"{unit_name} is no reconstruction unit of this UNet")
    ins, out = rec[unit_name]
    return (ins, out) if want_inputs else ((), out)


class _OutShape(dict):
    """A `record` that keeps only the shape of one unit's output, and lets
    the forward run on."""

    def __init__(self, key: str):
        super().__init__()
        self.key = key

    def __setitem__(self, key, value):
        if key == self.key:
            super().__setitem__(key, value[1].shape)


def capture_unit_grad(params_fp: dict, params_q_prefix: dict, cali_batch: tuple,
                      unit_name: str, cfg: QConfig, unet_apply=unet_sd_apply,
                      mean_over: Optional[int] = None) -> torch.Tensor:
    """|dKL/d(unit output)| + 1, the Fisher weighting: KL(softmax(fp) ||
    softmax(quantized)) over the channel axis, batchmean by `mean_over` (the
    batch's leading size when None; a dp rank passes the size of the whole
    capture chunk its rows belong to), differentiated at a zero injected at
    the unit's output of the quantized net (weights quantized up to and
    including the unit). The zero takes its shape from the unit's output in
    the fp forward."""
    batch = tuple(cali_batch)
    shape = _OutShape(unit_name)
    with torch.no_grad():
        out_fp = unet_apply(params_fp, *batch, qstate=None, cfg=cfg, record=shape)
        p_fp = torch.softmax(out_fp.float(), dim=-1)
        logp = torch.log(p_fp + 1e-12)
        del out_fp
    if unit_name not in shape:
        raise KeyError(f"{unit_name} is no reconstruction unit of this UNet")
    d = torch.zeros(shape[unit_name], dtype=torch.float32, device=p_fp.device,
                    requires_grad=True)
    with torch.enable_grad(), inject_at({unit_name: d}):
        out_q = unet_apply(params_q_prefix, *batch, qstate=None, cfg=cfg)
        logq = torch.log_softmax(out_q.float(), dim=-1)
        loss = torch.sum(p_fp * (logp - logq)) / (mean_over or batch[0].shape[0])
    (g,) = torch.autograd.grad(loss, d)
    return torch.abs(g) + 1.0


def _soft_params(params: dict, sub: dict, layers, wqp, alphas: dict, bits: int) -> dict:
    """`sub` with each layer's weight soft-rounded by its offsets."""
    pq = dict(sub)
    for n in layers:
        pq[n] = dict(sub[n])
        pq[n]["w"] = adaround_quant(params[n]["w"], wqp[n], alphas[n], bits, soft=True)
    return pq


def _init_alphas(params: dict, wqp, layers) -> dict:
    with torch.no_grad():
        return {n: adaround_init_alpha(params[n]["w"], wqp[n].delta).requires_grad_(True)
                for n in layers}


def reconstruct_unit(key: tuple, unit: ReconUnit, params: dict, wqp: Dict[str, QParams],
                     cached_inputs: tuple, cached_outputs: torch.Tensor, cfg: QConfig,
                     iters: int = 20000, batch_size: int = 32, w: float = 0.01,
                     warmup: float = 0.2, p_norm: float = 2.0, lr: float = 1e-3,
                     opt_mode: str = "mse", cached_grads: Optional[torch.Tensor] = None,
                     shard: Optional[Shard] = None, mesh=None, captures: str = "device"):
    """Optimise one unit's AdaRound offsets. Returns ({layer: alpha}, the
    losses (iters,)). With a shard the cached tensors hold this rank's
    samples only; with a mesh of tp > 1 the offsets are the rank's shards
    (`_adam_loop`). captures: "device" (the cached tensors on the weights'
    device) or "host" (in host memory, pinned on a card; each step's rows
    copied to the device ahead of the step: `_RowFeed`).

    Loss: the reconstruction loss plus, from step warmup * iters on, w times
    the rounding regularizer at its annealed temperature. opt_mode: 'mse'
    (|pred - out|^p summed over unit.sum_axis, then the mean), 'fisher_diag'
    or 'fisher_full' (both need cached_grads from capture_unit_grad)."""
    apply_fn = make_unit_apply(unit, cfg)
    sub = _sub_params(params, unit)
    alphas = _init_alphas(params, wqp, unit.layers)
    if opt_mode != "mse" and cached_grads is None:
        raise ValueError("the fisher modes need cached_grads")

    def rec_loss(pred, bout, bgrad):
        if opt_mode == "mse":
            return torch.mean(torch.sum(_abs(pred - bout) ** p_norm, dim=unit.sum_axis))
        if opt_mode == "fisher_diag":
            return torch.mean(torch.sum((pred - bout) ** 2 * bgrad ** 2, dim=unit.sum_axis))
        a = _abs(pred - bout)
        g = _abs(bgrad)
        dot = torch.sum(a * g, dim=tuple(range(1, pred.dim())))
        return torch.mean(dot.reshape((-1,) + (1,) * (pred.dim() - 1)) * a * g) / 100.0

    k = len(cached_inputs)
    data = tuple(cached_inputs) + (cached_outputs,) + (
        () if cached_grads is None else (cached_grads,))

    def rec_fn(rows):
        pq = _soft_params(params, sub, unit.layers, wqp, alphas, cfg.w_bits)
        pred = apply_fn(pq, *rows[:k])
        return rec_loss(pred, rows[k], rows[k + 1] if cached_grads is not None else None)

    losses = _adam_loop(alphas, key, iters, batch_size, cached_outputs.shape[0],
                        next(iter(alphas.values())).device, data, rec_fn, lr,
                        reg_fn=_reg_fn(alphas, iters, w, warmup), shard=shard, mesh=mesh,
                        host=_host_form(captures))
    return {n: a.detach() for n, a in alphas.items()}, losses


def tib_unit(spec) -> ReconUnit:
    """The temporal-information block (TFMQ): the time-embedding MLP and
    every resnet's time_emb_proj, reconstructed jointly against the fp tuple
    of all time_emb_proj outputs."""
    layers = ["time_embedding.linear_1", "time_embedding.linear_2"] + [
        n for n, k, _ in spec if k == "linear" and n.endswith(".time_emb_proj")]
    return ReconUnit("tib", "time_embedding", tuple(layers), (), -1)


def make_tib_apply(spec, cfg: QConfig) -> Callable:
    """(params, timesteps) -> the tuple of every time_emb_proj output: t ->
    sinusoidal projection -> embedding MLP -> silu -> each projection."""
    proj_names = [n for n, k, _ in spec if k == "linear" and n.endswith(".time_emb_proj")]

    def apply_fn(p, timesteps):
        base = p["time_embedding.linear_1"]["w"].shape[1]
        t_emb = timestep_embedding(timesteps, base)
        emb = quant_linear(p["time_embedding.linear_1"], t_emb, "time_embedding.linear_1",
                           None, cfg)
        emb = quant_linear(p["time_embedding.linear_2"], silu(emb), "time_embedding.linear_2",
                           None, cfg)
        temb = silu(emb)
        return tuple(quant_linear(p[n], temb, n, None, cfg) for n in proj_names)

    return apply_fn


def reconstruct_tib(key: tuple, params: dict, spec, wqp: Dict[str, QParams],
                    timesteps: torch.Tensor, cfg: QConfig, iters: int = 20000,
                    batch_size: int = 32, w: float = 0.01, warmup: float = 0.2,
                    p_norm: float = 2.0, lr: float = 1e-3, mesh=None):
    """Joint AdaRound over the temporal-information block, the loss summed
    over its output tuple. Returns ({layer: alpha}, the losses). mesh: as in
    `reconstruct_unit`."""
    unit = tib_unit(spec)
    apply_fn = make_tib_apply(spec, cfg)
    sub = {n: params[n] for n in unit.layers}
    alphas = _init_alphas(params, wqp, unit.layers)
    with torch.no_grad():
        fp_outs = apply_fn(sub, timesteps)

    def rec_fn(rows):
        preds = apply_fn(_soft_params(params, sub, unit.layers, wqp, alphas, cfg.w_bits),
                         rows[0])
        return sum(torch.mean(torch.sum(_abs(pr - tg) ** p_norm, dim=-1))
                   for pr, tg in zip(preds, rows[1:]))

    losses = _adam_loop(alphas, key, iters, batch_size, timesteps.shape[0], timesteps.device,
                        (timesteps,) + tuple(fp_outs), rec_fn, lr,
                        reg_fn=_reg_fn(alphas, iters, w, warmup), mesh=mesh)
    return {n: a.detach() for n, a in alphas.items()}, losses


def _partial_name(unit: ReconUnit, layer: str) -> str:
    rel = "layer" if layer == unit.name else layer[len(unit.name) + 1:]
    return f"{rel}.wqtizer.alpha"


def _alpha_to_jax(a: torch.Tensor) -> np.ndarray:
    """An offset in the JAX package's layout (HWIO conv, (I, O) linear), as
    its partial saves hold it."""
    a = a.detach().cpu()
    return np.ascontiguousarray((a.permute(2, 3, 1, 0) if a.dim() == 4 else a.t()).numpy())


def _alpha_from_jax(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _load_partial(partial_dir: str, unit: ReconUnit, device) -> Optional[dict]:
    """The offsets of a unit's partial save ({layer: alpha} in the port's
    layout), or None when there is none."""
    from dgq_tpu_torch.io.dgq_ckpt import load_pth

    path = os.path.join(partial_dir, f"{unit.name}.pth")
    if not os.path.exists(path):
        return None
    out = {}
    for k, v in load_pth(path).items():
        rel = k[: -len(".wqtizer.alpha")]
        out[unit.name if rel == "layer" else f"{unit.name}.{rel}"] = _alpha_from_jax(v, device)
    return out


def _save_partial(partial_dir: str, unit: ReconUnit, alphas: dict) -> None:
    """One unit's offsets as the JAX package saves them: `<unit>.pth` with
    keys '<rel>.wqtizer.alpha' ('layer' for a lone layer), HWIO / (I, O)."""
    from dgq_tpu_torch.io.dgq_ckpt import save_pth

    os.makedirs(partial_dir, exist_ok=True)
    save_pth({_partial_name(unit, n): _alpha_to_jax(a) for n, a in alphas.items()},
             os.path.join(partial_dir, f"{unit.name}.pth"))


@torch.no_grad()
def unit_error(unit: ReconUnit, params: dict, wqp: Dict[str, QParams], alphas: dict,
               inputs: tuple, target: torch.Tensor, cfg: QConfig, chunk: int = 8) -> tuple:
    """(learned, nearest): the mean squared error of the unit's output against
    `target` on the cached `inputs`, its layers hard-rounded by `alphas`, and
    with nearest rounding; `chunk` samples a forward, moved to the weights'
    device first (captures held in host memory). Not part of the walk:
    a caller that wants to judge the learned rounding calls it. On weights
    cut over channels every rank of the tp group calls it with its shards,
    and each gets the whole unit's error (the unit's output is gathered)."""
    apply_fn = make_unit_apply(unit, cfg)
    sub = _sub_params(params, unit)
    device = params[unit.layers[0]]["w"].device
    errs = []
    for learned in (True, False):
        pq = dict(sub)
        for n in unit.layers:
            w = params[n]["w"]
            pq[n] = dict(sub[n], w=adaround_quant(w, wqp[n], alphas[n], cfg.w_bits, soft=False)
                         if learned else fake_quant(w, wqp[n], cfg.w_bits))
        total = 0.0
        for i in range(0, target.shape[0], chunk):
            pred = apply_fn(pq, *(x[i:i + chunk].to(device) for x in inputs))
            total += float(((pred - target[i:i + chunk].to(device)) ** 2).sum())
        errs.append(total / target.numel())
    return tuple(errs)


def calibrate_weights(params: dict, spec, cfg: QConfig, wqp: Dict[str, QParams],
                      cali_data: tuple, iters: int = 20000, batch_size: int = 32,
                      w: float = 0.01, warmup: float = 0.2, asym: bool = True,
                      capture_batch: int = 8, seed: int = 0, unet_apply=unet_sd_apply,
                      progress: Optional[Callable[[str], None]] = None,
                      max_units: Optional[int] = None, partial_dir: Optional[str] = None,
                      tib_recon: bool = False, opt_mode: str = "mse",
                      mesh=None, captures: str = "auto") -> Dict[str, torch.Tensor]:
    """The whole weight-reconstruction pass. Returns the AdaRound offsets of
    every reconstructed layer (in the weights' layout).

    cali_data: the stacked UNet inputs (SD: samples NHWC, timesteps, ehs),
    moved to the weights' device. One unit's captures (its inputs and
    outputs over the rank's samples, and its Fisher weights) are held on
    that device too, as the JAX package holds them on its device, or in
    pinned host memory: captures="auto" decides once a unit, at its first
    capture chunk, by `hold_on_host` (on a card: host when they exceed half
    of the card's free bytes; on the CPU always the device) and logs the
    decision to `progress`; "device" and "host" force a form. Each chunk is
    copied into host captures as it is made (no card tensor of the whole
    size), and the Adam loop copies each step's rows back ahead of the step
    (`_RowFeed`): the losses and offsets are those of the on-card form.
    max_units limits the walk (debug and tests). partial_dir keeps one .pth a
    unit as it completes and resumes a unit whose save exists. tib_recon
    reconstructs the temporal-information block jointly first and takes its
    layers out of the per-unit walks, which then see them hard-rounded.

    mesh: a `parallel.mesh.Mesh`, one process a rank. A rank captures
    (and weighs by Fisher) only its dp slice of the samples, so it holds
    n / dp of each unit's captures, and the Adam loops sum the gradients
    over the dp group (`_adam_loop`); every rank of a dp group ends each
    unit with the same offsets. When n % dp != 0 every rank holds every
    sample and runs the whole loop, and dp rank 0's offsets are broadcast
    over the dp group. The temporal block runs on every rank, then dp rank
    0's offsets are broadcast. With tp > 1 `params` and `wqp` are the
    rank's shards (`shard_params_tp`) and so are the offsets returned. Only
    rank 0 writes the partial saves, the whole offsets gathered over each
    tp group (a barrier after each); every rank reads them on resume and
    keeps its rows."""
    if captures not in CAPTURES:
        raise ValueError(f"captures must be one of {CAPTURES}, not {captures!r}")
    units = recon_units(spec)
    if max_units is not None:
        units = units[:max_units]
    key = (seed,)
    device = params["conv_in"]["w"].device
    cali_data = tuple(x.to(device) for x in cali_data)
    all_alphas: Dict[str, torch.Tensor] = {}
    n = cali_data[0].shape[0]
    shard = _shard(mesh, n)
    lo, hi = (0, n) if shard is None else (shard.lo, shard.hi)
    shared = mesh is not None and mesh.dp > 1

    params_units = params
    if tib_recon:
        if progress:
            progress("reconstructing temporal information block (TFMQ)")
        tib_layers = set(tib_unit(spec).layers)
        tib_alphas, _ = reconstruct_tib(
            key + (TIB_STREAM,), params, spec, wqp, cali_data[1], cfg, iters=iters,
            batch_size=batch_size, w=w, warmup=warmup, mesh=mesh)
        if shared:
            broadcast_(mesh, list(tib_alphas.values()))
        all_alphas.update(tib_alphas)
        units = [dataclasses.replace(u, layers=tuple(l for l in u.layers if l not in tib_layers))
                 for u in units]
        units = [u for u in units if u.layers]
        # the per-unit walks see the temporal block hard-rounded inside each
        # unit's forward too, as it behaves at deployment
        with torch.no_grad():
            params_units = fold_weight_quant(params, {k: wqp[k] for k in tib_layers}, spec, cfg,
                                             alphas=tib_alphas, soft=False)

    def chunks():
        """(start, stop, size of its whole chunk) of each capture chunk, cut
        to this rank's samples [lo, hi)."""
        for i in range(0, n, capture_batch):
            s, e = max(i, lo), min(i + capture_batch, hi)
            if s < e:
                yield s, e, min(i + capture_batch, n) - i

    def batched_capture(p, unit_name, store, want_inputs=True, want_output=True):
        """The unit's (inputs, output) over the rank's samples (() / None
        where not wanted), each chunk copied into tensors that `store` makes
        at the first (no second copy for a concatenation). A unit's first
        chunk decides its placement (`_Captures.place`) from its inputs and
        output."""
        wholes = None
        for s, e, _ in chunks():
            bi, bo = capture_unit_io(p, tuple(x[s:e] for x in cali_data), unit_name, cfg,
                                     unet_apply, want_inputs=want_inputs or store.host is None)
            if store.host is None:
                store.place(bi, bo)
            parts = (bi if want_inputs else ()) + ((bo,) if want_output else ())
            if wholes is None:
                wholes = tuple(store.empty((hi - lo,) + x.shape[1:], x.dtype) for x in parts)
            for whole, part in zip(wholes, parts):
                whole[s - lo:e - lo].copy_(part, non_blocking=True)
            del bi, bo, parts
        store.ready()
        return (wholes[:len(wholes) - want_output], wholes[-1] if want_output else None)

    for u_idx, unit in enumerate(units):
        if partial_dir:
            part = _load_partial(partial_dir, unit, device)
            if part is not None:
                part = shard_params_tp(mesh, part, like=params)
                # the asym prefix then quantizes with the loaded offsets, as
                # a continuous run would
                all_alphas.update(part)
                if progress:
                    progress(f"[{u_idx + 1}/{len(units)}] {unit.name}: "
                             f"resumed from partial save ({len(part)} layers)")
                continue
        if progress:
            progress(f"[{u_idx + 1}/{len(units)}] reconstructing {unit.name}")
        # the asym path replaces the fp inputs with the quantized prefix's
        replace_inputs = asym and bool(all_alphas)
        store = _Captures(device, captures, hi - lo, opt_mode != "mse", progress)
        try:
            fp_inputs, fp_out = batched_capture(params, unit.name, store,
                                                want_inputs=not replace_inputs)
            if replace_inputs:
                with torch.no_grad():
                    pq = fold_weight_quant(params, {k: wqp[k] for k in all_alphas}, spec, cfg,
                                           alphas=all_alphas, soft=False)
                q_inputs, _ = batched_capture(pq, unit.name, store, want_output=False)
                del pq
            else:
                q_inputs = fp_inputs
            del fp_inputs
            cached_grads = None
            if opt_mode != "mse":
                # |dKL/d(unit out)| + 1 with the prefix and the unit itself
                # hard-quantized, batchmean over the whole capture chunk
                fold_names = set(all_alphas) | set(unit.layers)
                with torch.no_grad():
                    pq_g = fold_weight_quant(params, {k: wqp[k] for k in fold_names if k in wqp},
                                             spec, cfg, alphas=all_alphas, soft=False)
                cached_grads = store.empty(fp_out.shape, torch.float32)
                for s, e, size in chunks():
                    cached_grads[s - lo:e - lo].copy_(capture_unit_grad(
                        params, pq_g, tuple(x[s:e] for x in cali_data), unit.name, cfg,
                        unet_apply, mean_over=size), non_blocking=True)
                store.ready()
                del pq_g
            alphas, _ = reconstruct_unit(
                key + (u_idx,), unit, params_units, wqp, q_inputs, fp_out, cfg, iters=iters,
                batch_size=batch_size, w=w, warmup=warmup, opt_mode=opt_mode,
                cached_grads=cached_grads, shard=shard, mesh=mesh, captures=store.form)
            del q_inputs, fp_out, cached_grads
        finally:
            store.close()
        if shared and shard is None:
            broadcast_(mesh, list(alphas.values()))
        all_alphas.update(alphas)
        if partial_dir:
            whole = gather_params_tp(mesh, alphas, like=params)
            if mesh is None or mesh.rank == 0:
                _save_partial(partial_dir, unit, whole)
            barrier(mesh)
    return all_alphas
