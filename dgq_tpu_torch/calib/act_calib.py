"""Activation quantization-point names and the time-aware stacking of
per-timestep qstates (port of the naming helpers and `stack_time_qstates`
of `dgq_tpu/calib/act_calib.py`; activation calibration itself waits for
slice 5)."""
from __future__ import annotations

import logging
from typing import Dict

import torch

from dgq_tpu_torch.models.qconfig import GroupQParams, QState
from dgq_tpu_torch.quant.affine import QParams


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
