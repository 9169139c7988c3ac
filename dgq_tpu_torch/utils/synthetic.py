"""Synthetic quantizer state for benchmarks and smoke runs (port of
`dgq_tpu/utils/synthetic.py:synthetic_pertensor_qstate`): the shapes and
dtypes a real g=1 calibration produces, without running calibration."""
from __future__ import annotations

import torch

from dgq_tpu_torch.calib.act_calib import act_qpoint_names, softmax_qpoint_names
from dgq_tpu_torch.quant.affine import QParams


def synthetic_pertensor_qstate(spec, t_slots: int, time_aware: bool, dtype,
                               device="cpu"):
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
