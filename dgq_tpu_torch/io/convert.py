"""The weight bridge: JAX-layout numpy pytrees -> torch tensors, and torch
state dicts (a reference UNet's, a checkpoint's per-out-channel weight
qparams) -> the port's params (port of `dgq_tpu/io/convert.py`).

The JAX package keeps conv weights HWIO and linear weights (I, O); the port
keeps PyTorch's OIHW and (O, I) (`F.conv2d` / `F.linear`). Callers turn a
JAX pytree into numpy first (`jax.tree.map(np.asarray, tree)`), so this
module needs no JAX.

The packed int8 entries of the int8 deploy path cross over too: 'w_q8' is
(K, N) int8 in the JAX package and (N, K) here, 'w_q8c' is HWIO there and
OIHW here, and 'w_d', 'w_z', 'w_ksum' are per-out-channel vectors in both.
They keep their own dtypes (int8 codes, f32 scales) whatever `dtype` says.

A torch state dict is already in the port's layouts, so
`torch_unet_to_params` / `params_to_torch_unet` only rename and move
tensors, and `channel_qp_to_torch` keeps a per-out-channel qparam at
(O, 1, 1, 1) / (O, 1), where the JAX package turns it to (1, 1, 1, O) /
(1, O) for its HWIO / (I, O) weights.

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
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
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


def reference_layout(key: str, v: torch.Tensor) -> torch.Tensor:
    """A params leaf viewed in the JAX package's layout: a conv weight 'w'
    (OIHW) as HWIO, a linear 'w' (O, I) as (I, O), the packed codes 'w_q8'
    as (K, N) and 'w_q8c' as HWIO; every other leaf as it is. A view, no
    copy, on the leaf's own device."""
    if key in ("w", "w_q8c") and v.dim() == 4:
        return v.permute(2, 3, 1, 0)
    if key in ("w", "w_q8") and v.dim() == 2:
        return v.t()
    return v


def params_to_numpy(params: dict, spec) -> dict:
    """Inverse of params_from_numpy: torch params -> JAX-layout f32 numpy
    (HWIO convs, (I, O) linears), e.g. to run the same weights in JAX."""
    def leaf_np(key, v):
        if v is None:
            return None
        v = reference_layout(key, v.detach().cpu())
        if key == "w_q8":
            return np.ascontiguousarray(v.numpy())
        return v.numpy() if key == "w_q8c" else v.float().numpy()

    return {name: {k: leaf_np(k, v) for k, v in params[name].items()} for name, _, _ in spec}


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


def channel_qp_to_torch(arr, kind: str, device="cuda") -> torch.Tensor:
    """Per-out-channel wqtizer delta / zero point as the port's weights take
    it: (O, 1, 1, 1) for a conv, (O, 1) for a linear, out channel first
    whatever shape it came in (the reference's own shapes pass unchanged).
    Scalars pass through."""
    a = np.asarray(arr)
    if a.ndim and a.size > 1:
        a = a.reshape((-1, 1, 1, 1) if kind == "conv" else (-1, 1))
    return _tensor(a, device)


def torch_unet_to_params(state: dict, spec, device="cuda") -> dict:
    """A plain (unquantized) reference UNet state dict ('<path>.weight' /
    '.bias' -> arrays or tensors) -> the port's params, by the layer spec."""
    params = {}
    for name, kind, _ in spec:
        w = _tensor(state[f"{name}.weight"], device)
        b = state.get(f"{name}.bias")
        if kind in ("conv", "linear"):
            params[name] = {"w": w, "b": None if b is None else _tensor(b, device)}
        else:
            params[name] = {"scale": w, "bias": _tensor(state[f"{name}.bias"], device)}
    return params


def params_to_torch_unet(params: dict, spec) -> dict:
    """Inverse of torch_unet_to_params: {'<path>.weight' / '.bias': CPU
    tensor}, dtypes kept (for torch.save)."""
    state = {}
    for name, kind, _ in spec:
        p = params[name]
        w, b = (p["w"], p.get("b")) if kind in ("conv", "linear") else (p["scale"], p["bias"])
        state[f"{name}.weight"] = w.detach().cpu()
        if b is not None:
            state[f"{name}.bias"] = b.detach().cpu()
    return state


# ------------------------------------------------------------ the scorers ---
def inception_params_from_numpy(params_np: dict, device="cuda") -> dict:
    """The JAX package's Inception params (numpy: HWIO conv 'w', 'b', and an
    (I, O) 'fc' head) -> the port's (OIHW, (O, I)), bit for bit."""
    out = {}
    for name, p in params_np.items():
        w = np.asarray(p["w"])
        w = conv_w_to_torch(w) if w.ndim == 4 else w.T
        out[name] = {"w": _tensor(np.ascontiguousarray(w), device),
                     "b": _tensor(np.asarray(p["b"]), device)}
    return out


def inception_params_to_numpy(params: dict) -> dict:
    """Inverse of inception_params_from_numpy: the port's Inception params
    -> the JAX package's layouts, f32 numpy."""
    out = {}
    for name, p in params.items():
        w = p["w"].detach().cpu().float()
        w = w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()
        out[name] = {"w": np.ascontiguousarray(w.numpy()),
                     "b": p["b"].detach().cpu().float().numpy()}
    return out


def tree_to_torch(tree: dict, device="cuda") -> dict:
    """A nested dict of numpy arrays under checkpoint names (the open_clip and
    ImageReward trees, the same in both packages) -> torch tensors on
    `device`, layouts and dtypes kept."""
    return {k: tree_to_torch(v, device) if isinstance(v, dict) else _tensor(v, device)
            for k, v in tree.items()}
