"""Activation quantization-point names (port of the naming helpers of
`dgq_tpu/calib/act_calib.py`; activation calibration itself waits for
slice 5)."""
from __future__ import annotations


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
