"""Synthetic quantizer state for benchmarks and smoke runs (port of
`dgq_tpu/utils/synthetic.py`): the shapes and dtypes a real calibration
produces, without running calibration."""
from __future__ import annotations

import torch

from dgq_tpu_torch.calib.act_calib import act_qpoint_names, softmax_qpoint_names
from dgq_tpu_torch.models.qconfig import GroupQParams
from dgq_tpu_torch.quant.affine import QParams


def synthetic_group_qstate(spec, t_slots: int, time_aware: bool, dtype, device="cuda"):
    """Group (g > 1) activation qparams: every k x k conv gets mid-axis
    (C*kh*kw) group scales, every other point per-tensor ones; `sm` is empty
    (the flagship quantizes the softmax in real time). The group count does
    not appear: saved group checkpoints expand per-cluster scales to
    per-channel tensors, so the shapes are the same for any g > 1.

    Returns (qstate, group_conv_layer_names)."""
    lead = (t_slots,) if time_aware else ()

    def full(shape, v):
        return torch.full(lead + shape, v, dtype=dtype, device=device)

    conv_meta = {n: m for n, k, m in spec if k == "conv"}
    a, group_layers = {}, []
    for n in act_qpoint_names(spec):
        m = conv_meta.get(n)
        if m is not None and m[2] > 1:
            ckk = m[0] * m[2] * m[2]
            a[n] = GroupQParams(full((ckk,), 0.05), full((ckk,), 128.0),
                                full((1,), 1.0), full((1,), 0.0))
            group_layers.append(n)
        else:
            a[n] = QParams(full((), 0.05), full((), 128.0))
    return {"a": a, "sm": {}}, tuple(sorted(group_layers))


def synthetic_pertensor_qstate(spec, t_slots: int, time_aware: bool, dtype,
                               device="cuda"):
    """Per-tensor A8 qparams for every activation point (the g=1 config),
    plus uniform always-zero softmax quantizers (delta 1/255, zp 0) on every
    aqtizer_w, as the reference's g=1 policy quantizes the softmax."""
    shape = (t_slots,) if time_aware else ()

    def full(v):
        return torch.full(shape, v, dtype=dtype, device=device)

    a = {n: QParams(full(0.05), full(128.0)) for n in act_qpoint_names(spec)}
    for n in softmax_qpoint_names(spec):
        a[n] = QParams(full(1.0 / 255.0), full(0.0))
    return {"a": a, "sm": {}}
