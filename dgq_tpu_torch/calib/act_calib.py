"""Activation calibration: lazy scale init, EMA running stats and DGQ's
group-wise (k-means) quantization, per denoising-timestep chunk, and the
time-aware stacking of the per-timestep qstates (port of
`dgq_tpu/calib/act_calib.py`).

  * activations are observed through the taps of `models.qconfig`: each
    forward runs under a `TapCollector` that names the taps it wants and
    reduces them where they are published (min/max, `update_group_stats`),
    so a full-width forward keeps no more than it needs;
  * scale init keeps the reference's sequential lazy-init semantics
    (earlier quantizers are live while later ones initialize) by chunks of
    `init_chunk` taps, one forward a chunk;
  * group statistics are reductions at the tap; only the k-means runs on
    the host (`quant.groups`).

Output: {"act_{t}": qstate} with qstate = {"a": {name: QParams |
GroupQParams}, "sm": {name: delta}}, which `io.dgq_ckpt` writes in the
reference's checkpoint format and `stack_time_qstates` stacks on a leading
[T] axis for the sampler.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from dgq_tpu_torch.models.qconfig import (
    GroupQParams,
    QConfig,
    QState,
    TapCollector,
    collect_act_taps,
)
from dgq_tpu_torch.models.unet_sd import unet_sd_apply
from dgq_tpu_torch.quant.affine import QParams, minmax_qparams_from_range
from dgq_tpu_torch.quant.groups import init_group_stats, kmeans_group_qparams, update_group_stats
from dgq_tpu_torch.quant.log2 import log2_ema_update, log2_init_delta
from dgq_tpu_torch.quant.scalers import Scaler, init_scale


def attention_prefixes(spec) -> list[str]:
    """Attention module prefixes (e.g. '....attn1') from the layer spec."""
    return [n[: -len(".to_q")] for n, k, _ in spec if n.endswith(".to_q")]


def act_qpoint_names(spec) -> list[str]:
    """Every conv/linear input aqtizer plus the attention aqtizer_q/k/v.
    conv_in/conv_out have none (their activations are never quantized)."""
    names = [
        n for n, k, _ in spec
        if k in ("conv", "linear") and n not in ("conv_in", "conv_out")
    ]
    for p in attention_prefixes(spec):
        names += [f"{p}.aqtizer_q", f"{p}.aqtizer_k", f"{p}.aqtizer_v"]
    return names


def softmax_qpoint_names(spec) -> list[str]:
    return [f"{p}.aqtizer_w" for p in attention_prefixes(spec)]


def conv_meta_by_name(spec) -> dict:
    return {n: m for n, k, m in spec if k == "conv"}


# ------------------------------------------------------------ collectors ----
# A calibration batch is the tuple of positional UNet inputs after `params`:
# SD (sample, t, ehs); SDXL-turbo (sample, t, ehs, text_embeds, time_ids).
@torch.no_grad()
def _run(params, qstate, batch, cfg: QConfig, unet_apply, collector: TapCollector) -> dict:
    with collect_act_taps(collector):
        unet_apply(params, *batch, qstate=qstate, cfg=cfg)
    return collector.store


def _minmax(name, x, prev):
    return torch.stack([x.min(), x.max()]).float()


def _group_stats(name, x, prev):
    """Running GroupStats of a rank >= 3 tap (None for lower ranks: those
    keep their per-tensor scale)."""
    if x.dim() < 3:
        return None
    if prev is None:
        prev = init_group_stats(tuple(x.shape), device=x.device)
    return update_group_stats(prev, x)


def tap_execution_order(params, cali_batch, cfg, unet_apply=unet_sd_apply) -> list[str]:
    """Every tap name in the order a forward publishes it. The JAX package
    reads this from a trace (`jax.eval_shape`), which costs no compute; here
    it costs one forward on `cali_batch` (no quantizer state; the taps made
    only for collectors are not made)."""
    return list(_run(params, None, _to(cali_batch, _device_of(params)), cfg, unet_apply,
                     TapCollector(shapes_only=True)))


def _to(batch, device) -> tuple:
    return tuple(torch.as_tensor(x).to(device) for x in batch)


def _device_of(params):
    return params["conv_in"]["w"].device


# ------------------------------------------------------------------ init ----
def init_act_qstate(params: dict, init_batch: tuple, spec, cfg: QConfig,
                    scaler: Scaler = Scaler.MINMAX, chunk: int = 32,
                    unet_apply=unet_sd_apply) -> tuple[QState, Dict[str, tuple]]:
    """The reference's lazy init: every activation quantizer's scale from
    one batch, in execution order, `chunk` taps a forward, with the
    quantizers of earlier chunks live (chunk 1 is the reference's exact
    sequence). Returns (qstate, ranges) with ranges[name] = (x_min, x_max)
    as Python floats, the seed of the EMA passes."""
    device = _device_of(params)
    init_batch = _to(init_batch, device)
    sm_names = set(softmax_qpoint_names(spec))
    order = tap_execution_order(params, init_batch, cfg, unet_apply)
    qstate: QState = {"a": {}, "sm": {}}
    ranges: Dict[str, tuple] = {}
    run_cfg = cfg.replace(use_aq=True)
    for i in range(0, len(order), chunk):
        names = order[i:i + chunk]
        taps = _run(params, qstate, init_batch, run_cfg, unet_apply, TapCollector(names))
        for n in names:
            x = taps.pop(n)
            if n in sm_names:
                if cfg.t2i_log_quant:
                    if not cfg.t2i_real_time:
                        qstate["sm"][n] = log2_init_delta(x, cfg.softmax_bits)
                else:
                    qstate["a"][n] = init_scale(x, cfg.softmax_bits, scaler, always_zero=True)
                    ranges[n] = (float(x.min()), float(x.max()))
            else:
                qstate["a"][n] = init_scale(x, cfg.a_bits, scaler)
                ranges[n] = (float(x.min()), float(x.max()))
            del x
    return qstate, ranges


# --------------------------------------------------------- running stats ----
def ema_update_qstate(params: dict, qstate: QState, ranges: Dict[str, tuple], batches: list,
                      cfg: QConfig, spec, momentum: float = 0.95,
                      unet_apply=unet_sd_apply) -> tuple[QState, Dict[str, tuple]]:
    """Running-stat passes: an EMA of each point's global min/max on the
    host, minmax scales re-derived after every batch (batch granularity, as
    the JAX package). Static-log2 softmax points (qstate["sm"], under
    t2i_log_quant without real_time) move their delta by an EMA of the batch
    max instead."""
    device = _device_of(params)
    run_cfg = cfg.replace(use_aq=True)
    names = tuple(n for n in qstate["a"] if n in ranges)
    sm_static = (tuple(sorted(qstate["sm"]))
                 if cfg.t2i_log_quant and not cfg.t2i_real_time else ())
    sm_names = set(softmax_qpoint_names(spec))
    every = names + sm_static
    for batch in batches:
        taps = _run(params, qstate, _to(batch, device), run_cfg, unet_apply,
                    TapCollector(every, _minmax))
        mm = torch.stack([taps[n] for n in every]).cpu().numpy()  # one pull a batch
        if sm_static:
            new_sm = dict(qstate["sm"])
            for j, n in enumerate(sm_static, start=len(names)):
                new_sm[n] = log2_ema_update(new_sm[n], torch.tensor(mm[j, 1]), momentum)
            qstate = {**qstate, "sm": new_sm}
        new_a = dict(qstate["a"])
        new_ranges = dict(ranges)
        for j, n in enumerate(names):
            bmin, bmax = float(mm[j, 0]), float(mm[j, 1])
            x_min = ranges[n][0] * momentum + bmin * (1 - momentum)
            x_max = ranges[n][1] * momentum + bmax * (1 - momentum)
            new_ranges[n] = (x_min, x_max)
            # softmax (aqtizer_w) points: softmax bits, always_zero
            bits = cfg.softmax_bits if n in sm_names else cfg.a_bits
            qp = minmax_qparams_from_range(x_min, x_max, bits, always_zero=n in sm_names)
            new_a[n] = QParams(qp.delta.to(device), qp.zero_point.to(device))
        qstate = {**qstate, "a": new_a}
        ranges = new_ranges
    return qstate, ranges


# ------------------------------------------------------------ group path ----
def group_calibrate_qstate(params: dict, qstate: QState, batches: list, cfg: QConfig, spec,
                           group_num: int, mode: str = "minmax",
                           unet_apply=unet_sd_apply) -> tuple[QState, tuple]:
    """DGQ group quantization for one timestep chunk: per-axis min/max over
    the batches (convs on their im2col-unfolded input), k-means over the
    channels, per-cluster scales expanded back to per-channel GroupQParams.
    Points whose activations are rank < 3 keep their per-tensor scales.

    Returns (qstate, group conv names), the names for
    QConfig.group_conv_layers."""
    device = _device_of(params)
    conv_names = tuple(n for n, k, _ in spec if k == "conv")
    group_cfg = cfg.replace(use_aq=True, group_conv_layers=conv_names)
    names = act_qpoint_names(spec)
    collector = TapCollector(names, _group_stats)
    for batch in batches:
        _run(params, qstate, _to(batch, device), group_cfg, unet_apply, collector)
    stats = collector.store
    groupable = [n for n in names if stats.get(n) is not None]

    level = 2 ** cfg.a_bits
    new_a = dict(qstate["a"])
    group_layers = []
    ones = torch.ones((1,), device=device)
    zeros = torch.zeros((1,), device=device)
    for n in groupable:
        qp, _, in_wise = kmeans_group_qparams(stats[n], group_num, level, mode)
        d = qp.delta.reshape(-1).to(device)
        z = qp.zero_point.reshape(-1).to(device)
        # the unused axis is canonicalized to size-(1,) ones / zeros, as
        # io.dgq_ckpt.act_dict_to_qstate gives it on load
        new_a[n] = (GroupQParams(ones, zeros, d, z) if in_wise
                    else GroupQParams(d, z, ones, zeros))
        if n in conv_names:
            group_layers.append(n)
    return {**qstate, "a": new_a}, tuple(sorted(group_layers))


# ------------------------------------------------------------- driver -------
def calibrate_activations(params_wq: dict, spec, cfg: QConfig, a_cali_data: tuple,
                          interval: int, group_num: int = 0, group_mode: str = "minmax",
                          running_stat: bool = True, batch_size: int = 8,
                          scaler: Scaler = Scaler.MINMAX, init_chunk: int = 32, seed: int = 0,
                          unet_apply=unet_sd_apply,
                          progress=None) -> tuple[Dict[str, QState], tuple]:
    """Per-timestep-chunk activation calibration (the reference's
    cali_model_aq loop); group_num > 1 takes DGQ's group path.

    a_cali_data: the positional UNet inputs (tensors or arrays), ordered so
    that samples [t*interval : (t+1)*interval] belong to denoising call t.
    Batch picks and orders come from `np.random.RandomState(seed)`, as in
    the JAX package."""
    rng = np.random.RandomState(seed)
    data = tuple(torch.as_tensor(x) for x in a_cali_data)
    n_total = data[0].shape[0]
    out: Dict[str, QState] = {}
    group_layers: tuple = ()
    n_slots = n_total // interval
    for tslot in range(n_slots):
        if progress:
            progress(f"activation calibration: timestep chunk {tslot}")
        chunk = tuple(x[tslot * interval:(tslot + 1) * interval] for x in data)
        n = chunk[0].shape[0]
        bs = min(batch_size, n)
        inds = torch.from_numpy(rng.choice(n, bs, replace=False))
        qstate, ranges = init_act_qstate(params_wq, tuple(x[inds] for x in chunk), spec, cfg,
                                         scaler, init_chunk, unet_apply)
        order = torch.from_numpy(rng.permutation(n))
        batches = [tuple(x[order[i:i + bs]] for x in chunk) for i in range(0, n, bs)]
        if group_num and group_num > 1:
            qstate, gl = group_calibrate_qstate(params_wq, qstate, batches, cfg, spec,
                                                group_num, mode=group_mode,
                                                unet_apply=unet_apply)
            group_layers = tuple(sorted(set(group_layers) | set(gl)))
        elif running_stat:
            qstate, ranges = ema_update_qstate(params_wq, qstate, ranges, batches, cfg, spec,
                                               unet_apply=unet_apply)
        out[f"act_{tslot}"] = qstate
    if progress:
        progress(f"activation calibration: {n_slots} timestep chunks done")
    return out, group_layers


def stack_time_qstates(per_t: Dict[str, QState]) -> QState:
    """{'act_0': qs, 'act_1': qs, ...} -> one qstate whose leaves carry a
    leading [T] slot axis, which the sampler indexes per step (the
    reference swaps in act_{t} per step instead).

    Leaves are broadcast to their common shape before stacking: k-means may
    pick the mid axis at one timestep and the last axis at another for the
    same layer, leaving the unused GroupQParams axis as size-(1,) ones on one
    side and full-length values on the other, and ones broadcast losslessly.
    Such mixed-axis layers are logged: every slot then has a full-length
    delta_last, which `ops.group_conv.fused_eligible` refuses, so
    group_conv_impl='fused' takes the taps path for that layer at every
    timestep, as the JAX package's gate does."""
    ordered = [per_t[f"act_{i}"] for i in range(len(per_t))]

    def stack(xs):
        shape = torch.broadcast_shapes(*(x.shape for x in xs))
        return torch.stack([x.expand(shape) for x in xs])

    def stack_leaf(leaves):
        first = leaves[0]
        if isinstance(first, GroupQParams):
            return GroupQParams(*(stack([getattr(q, f) for q in leaves]) for f in (
                "delta_mid", "zp_mid", "delta_last", "zp_last")))
        if isinstance(first, QParams):
            return QParams(stack([q.delta for q in leaves]), stack([q.zero_point for q in leaves]))
        return stack(leaves)

    mixed = sorted(
        name for name, qp in ordered[0].get("a", {}).items()
        if isinstance(qp, GroupQParams)
        and len({q["a"][name].delta_last.numel() > 1 for q in ordered}) > 1)
    if mixed:
        logging.getLogger("dgq_tpu_torch").info(
            "mixed-axis group layers (k-means picked different axes across "
            "timesteps; fused kernel ineligible, taps path used): %s", mixed)
    return {key: {name: stack_leaf([q[key][name] for q in ordered])
                  for name in ordered[0][key]}
            for key in ("a", "sm") if key in ordered[0]}


# ------------------------------------------------------------ comparison ----
# Two calibrations of one net (two devices, two packages, or perturbed
# inputs) compared leaf by leaf. Leaves may be torch tensors or arrays, so a
# state of the JAX package compares as it is.
def _f64(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float64)


def state_leaves(per_t: Dict[str, QState]) -> dict:
    """{(slot, key, name): (delta, zero_point)} as float64 arrays. A group
    quantizer is taken as its effective (C_mid, C_last) grid, delta_mid *
    delta_last and zp_mid + zp_last, so two states compare on whichever axis
    each grouped; a log2 softmax delta has zero point 0."""
    out = {}
    for slot, qs in per_t.items():
        for key in ("a", "sm"):
            for name, v in qs.get(key, {}).items():
                if hasattr(v, "delta_mid"):
                    d = _f64(v.delta_mid).reshape(-1, 1) * _f64(v.delta_last).reshape(1, -1)
                    z = _f64(v.zp_mid).reshape(-1, 1) + _f64(v.zp_last).reshape(1, -1)
                elif hasattr(v, "delta"):
                    d, z = _f64(v.delta), _f64(v.zero_point)
                else:
                    d, z = _f64(v), np.zeros(1)
                out[(slot, key, name)] = (d, z)
    return out


def group_axes(per_t: Dict[str, QState]) -> dict:
    """{(slot, name): True where k-means grouped the last axis}."""
    return {(slot, name): _f64(v.delta_last).size > 1 for slot, qs in per_t.items()
            for name, v in qs["a"].items() if hasattr(v, "delta_mid")}


def moved_leaves(a: Dict[str, QState], b: Dict[str, QState], rtol: float = 1e-5) -> set:
    """The (slot, key, name) leaves where b departs from a: another shape,
    any zero point that differs, or a delta off by more than rtol of a's."""
    la, lb = state_leaves(a), state_leaves(b)
    if la.keys() != lb.keys():
        raise ValueError("states with different quantizers")
    out = set()
    for k, (d, z) in la.items():
        d2, z2 = lb[k]
        if (d.shape != d2.shape or not np.array_equal(z, z2)
                or np.any(np.abs(d - d2) > rtol * np.abs(d))):
            out.add(k)
    return out


def state_gap(a: Dict[str, QState], b: Dict[str, QState]) -> tuple[float, float]:
    """(largest |delta difference|, largest |zero point difference|) over
    the leaves of two states with the same quantizers."""
    la, lb = state_leaves(a), state_leaves(b)
    if la.keys() != lb.keys():
        raise ValueError("states with different quantizers")
    gd = gz = 0.0
    for k, (d, z) in la.items():
        gd = max(gd, float(np.max(np.abs(d - lb[k][0]), initial=0.0)))
        gz = max(gz, float(np.max(np.abs(z - lb[k][1]), initial=0.0)))
    return gd, gz
