"""Synthetic quantizer state for benchmarks and smoke runs (port of
`dgq_tpu/utils/synthetic.py`): the shapes and dtypes a real calibration
produces, without running calibration."""
from __future__ import annotations

import torch

from dgq_tpu_torch.calib.act_calib import act_qpoint_names, softmax_qpoint_names
from dgq_tpu_torch.models.qconfig import GroupQParams, joint_act_sites
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


def synthetic_mmdit_qstate(spec, t_slots: int, dtype=torch.float32, device="cuda",
                           groups: int = 8) -> dict:
    """W4A8 g=8 activation qparams of an MMDiT (`models.mmdit_sd3`), time
    aware with `t_slots` slots: the input of every quantized linear
    (`joint_act_sites`) takes group factors over its last axis, as `quantize_act
    --group_num 8` gives a linear whose k-means grouped the in-channels
    (delta_mid, zp_mid ones / zeros (1,); delta_last, zp_last (C,), channel
    j in group j % groups, the group's delta 0.05 2^((g - 3.5) / 7) a little
    apart from slot to slot, zero point 128); the joint q, k and v take
    per-tensor (0.05, 128). `sm` is empty (the softmax is quantized in real
    time)."""
    cin = {n: m[0] for n, k, m in spec if k == "linear"}
    slots = torch.arange(t_slots, dtype=dtype, device=device)[:, None]
    a = {}
    for n in joint_act_sites(spec):
        if n in cin:
            g = torch.arange(cin[n], device=device) % groups
            delta = 0.05 * 2.0 ** ((g.to(dtype) - 3.5) / 7) * (1 + 0.01 * slots)
            a[n] = GroupQParams(torch.ones(t_slots, 1, dtype=dtype, device=device),
                                torch.zeros(t_slots, 1, dtype=dtype, device=device),
                                delta, torch.full_like(delta, 128.0))
        else:
            a[n] = QParams(torch.full((t_slots,), 0.05, dtype=dtype, device=device),
                           torch.full((t_slots,), 128.0, dtype=dtype, device=device))
    return {"a": a, "sm": {}}
