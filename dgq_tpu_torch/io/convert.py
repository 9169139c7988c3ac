"""The weight bridge: JAX-layout numpy pytrees -> torch tensors.

The JAX package keeps conv weights HWIO and linear weights (I, O); the port
keeps PyTorch's OIHW and (O, I) (`F.conv2d` / `F.linear`). Callers turn a
JAX pytree into numpy first (`jax.tree.map(np.asarray, tree)`), so this
module needs no JAX.

The packed int8 entries of the int8 deploy path cross over too: 'w_q8' is
(K, N) int8 in the JAX package and (N, K) here, 'w_q8c' is HWIO there and
OIHW here, and 'w_d', 'w_z', 'w_ksum' are per-out-channel vectors in both.
They keep their own dtypes (int8 codes, f32 scales) whatever `dtype` says.

Head-slot packed attention projections (`pack_attention_heads` on either
side) cross as they are: the bridge goes by the spec's names and kinds, not
by its widths, and the JAX package's zero columns of an (I, H*dp) weight are
the port's zero rows of (H*dp, I), so packing commutes with the bridge bit
for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from dgq_tpu_torch.models.qconfig import GroupQParams
from dgq_tpu_torch.quant.affine import QParams


PACKED_VECTORS = ("w_d", "w_z", "w_ksum")


def conv_w_to_torch(w) -> np.ndarray:
    """HWIO -> OIHW (inverse of the JAX `conv_w_to_jax`)."""
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no native bf16: go through f32 (exact)
        t = torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    else:
        t = torch.tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def params_from_numpy(params_np: dict, spec, device="cuda",
                      dtype: torch.dtype = torch.float32) -> dict:
    """JAX-layout numpy params (by the layer spec) -> torch params:
    conv {'w': OIHW, 'b'}, linear {'w': (O, I), 'b'}, norms unchanged."""
    params = {}
    for name, kind, _ in spec:
        p = params_np[name]
        if kind in ("conv", "linear"):
            w = np.asarray(p["w"])
            w = conv_w_to_torch(w) if kind == "conv" else w.T
            b = p.get("b")
            params[name] = {"w": _tensor(w, device, dtype),
                            "b": None if b is None else _tensor(b, device, dtype)}
            if "w_q8" in p:
                params[name]["w_q8"] = _tensor(np.ascontiguousarray(np.asarray(p["w_q8"]).T),
                                               device)
            if "w_q8c" in p:
                params[name]["w_q8c"] = _tensor(
                    np.ascontiguousarray(conv_w_to_torch(p["w_q8c"])), device)
            for leaf in PACKED_VECTORS:
                if leaf in p:
                    params[name][leaf] = _tensor(p[leaf], device)
        else:
            params[name] = {"scale": _tensor(p["scale"], device, dtype),
                            "bias": _tensor(p["bias"], device, dtype)}
    return params


def params_to_numpy(params: dict, spec) -> dict:
    """Inverse of params_from_numpy: torch params -> JAX-layout f32 numpy
    (HWIO convs, (I, O) linears), e.g. to run the same weights in JAX."""
    def leaf_np(key, v):
        if v is None:
            return None
        v = v.detach().cpu()
        return v.numpy() if key in ("w_q8", "w_q8c") else v.float().numpy()

    out = {}
    for name, kind, _ in spec:
        p = {k: leaf_np(k, v) for k, v in params[name].items()}
        if kind == "conv":
            p["w"] = np.transpose(p["w"], (2, 3, 1, 0))
        elif kind == "linear":
            p["w"] = p["w"].T
        if "w_q8" in p:
            p["w_q8"] = np.ascontiguousarray(p["w_q8"].T)
        if "w_q8c" in p:
            p["w_q8c"] = np.transpose(p["w_q8c"], (2, 3, 1, 0))
        out[name] = p
    return out


def qstate_from_numpy(qstate_np: dict, device="cuda") -> dict:
    """Activation quantizer state with numpy leaves (QParams-like objects,
    GroupQParams-like objects or bare deltas, each with an optional leading
    [T] slot axis) -> the port's QState. Dtypes are kept."""
    def leaf(x):
        if hasattr(x, "delta_mid"):
            return GroupQParams(*(_tensor(a, device) for a in (
                x.delta_mid, x.zp_mid, x.delta_last, x.zp_last)))
        if hasattr(x, "delta"):
            return QParams(_tensor(x.delta, device), _tensor(x.zero_point, device))
        return _tensor(x, device)

    return {key: {name: leaf(v) for name, v in sub.items()}
            for key, sub in qstate_np.items()}
