"""Bit-compatible readers and writers of the DGQ .pth checkpoint formats
(port of `dgq_tpu/io/dgq_ckpt.py`).

  weight-only `cali_ckpt.pth_weight_only`:
      {'weight': {'model.<path>.w', 'model.<path>.b',
                  'model.<path>.wqtizer.delta/zero_point[/alpha]',
                  'model.<norm path>.weight/bias', ...}}
  activation `cali_ckpt_activation_w{W}a{A}g{G}.pth`:
      {'act_0': {'model.<path>.aqtizer*.delta/zero_point'}, ..., 'act_{T-1}'}
  merged `*_merged`: activation dict + 'weight' key injected.

The reference's tensors are in the port's layouts (OIHW convs, (O, I)
linears, (O, 1, 1, 1) / (O, 1) weight qparams), so reading keeps every
array's bits and shape and only renames. `load_pth` turns every tensor into
float32 numpy, as the JAX package's does; `merge_ckpts` keeps the raw
tensors and their dtypes. The loaders put tensors on `device` (default the
card); the writers take tensors on any device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dgq_tpu_torch.io.convert import _tensor, channel_qp_to_torch
from dgq_tpu_torch.models.qconfig import GroupQParams, QState
from dgq_tpu_torch.quant.affine import QParams

PREFIX = "model."


def load_pth(path: str) -> dict:
    """torch.load, every tensor as float32 numpy (nested dicts kept)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)

    def rec(d):
        if isinstance(d, dict):
            return {k: rec(v) for k, v in d.items()}
        if torch.is_tensor(d):
            return d.detach().cpu().float().numpy()
        return d

    return rec(ckpt)


def _cpu(x) -> torch.Tensor:
    """A CPU tensor that owns exactly its elements: torch.save writes a
    view's whole storage, so a slice of a larger tensor is copied out."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x.detach().cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t


def save_pth(obj: dict, path: str) -> None:
    """torch.save with numpy arrays and device tensors as CPU tensors."""
    def rec(d):
        if isinstance(d, dict):
            return {k: rec(v) for k, v in d.items()}
        if isinstance(d, (np.ndarray, torch.Tensor)):
            return _cpu(d)
        return d

    torch.save(rec(obj), path)


# ----------------------------------------------------------- weight side ----
def weight_ckpt_to_params(state: Dict[str, np.ndarray], spec, device="cuda"):
    """The reference weight dict -> (params, wqp, alphas).

    params carry the float weights ('model.<path>.w'); `fold_weight_quant`
    (with `alphas=`, soft=False, where a layer has AdaRound offsets)
    reproduces the quantized weights. alphas are in the weight's layout."""
    params: dict = {}
    wqp: Dict[str, QParams] = {}
    alphas: Dict[str, torch.Tensor] = {}
    for name, kind, _ in spec:
        if kind in ("conv", "linear"):
            b = state.get(f"{PREFIX}{name}.b")
            params[name] = {"w": _tensor(state[f"{PREFIX}{name}.w"], device),
                            "b": None if b is None else _tensor(b, device)}
            dk = f"{PREFIX}{name}.wqtizer.delta"
            if dk in state:
                zp = state.get(f"{PREFIX}{name}.wqtizer.zero_point", np.zeros((), np.float32))
                wqp[name] = QParams(channel_qp_to_torch(state[dk], kind, device),
                                    channel_qp_to_torch(zp, kind, device))
            ak = f"{PREFIX}{name}.wqtizer.alpha"
            if ak in state:
                alphas[name] = _tensor(state[ak], device)
        else:
            params[name] = {"scale": _tensor(state[f"{PREFIX}{name}.weight"], device),
                            "bias": _tensor(state[f"{PREFIX}{name}.bias"], device)}
    return params, wqp, alphas


def params_to_weight_ckpt(params: dict, wqp: Dict[str, QParams], spec,
                          alphas: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The reference weight dict (CPU tensors) from the port's structures.

    original_w / original_b are not written: the reference keeps them as
    plain tensors, never in its state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, kind, _ in spec:
        p = params[name]
        if kind not in ("conv", "linear"):
            out[f"{PREFIX}{name}.weight"] = _cpu(p["scale"])
            out[f"{PREFIX}{name}.bias"] = _cpu(p["bias"])
            continue
        out[f"{PREFIX}{name}.w"] = _cpu(p["w"])
        if p.get("b") is not None:
            out[f"{PREFIX}{name}.b"] = _cpu(p["b"])
        if name in wqp:
            shape = (-1, 1, 1, 1) if kind == "conv" else (-1, 1)
            out[f"{PREFIX}{name}.wqtizer.delta"] = _cpu(wqp[name].delta).reshape(shape)
            out[f"{PREFIX}{name}.wqtizer.zero_point"] = _cpu(wqp[name].zero_point).reshape(shape)
        if alphas and name in alphas:
            out[f"{PREFIX}{name}.wqtizer.alpha"] = _cpu(alphas[name])
    return out


# ------------------------------------------------------- activation side ----
def _act_key_to_name(key: str) -> Optional[str]:
    """'model.<path>.aqtizer[_q/k/v/w].delta' -> the quant-point name."""
    if not key.startswith(PREFIX) or not key.endswith(".delta"):
        return None
    body = key[len(PREFIX):-len(".delta")]
    if body.endswith(".aqtizer"):
        return body[: -len(".aqtizer")]
    for suf in ("_q", "_k", "_v", "_w"):
        if body.endswith(f".aqtizer{suf}"):
            return body  # attention points keep the aqtizer_x suffix
    return None


def _name_to_act_key(name: str) -> str:
    if ".aqtizer_" in name:
        return f"{PREFIX}{name}"
    return f"{PREFIX}{name}.aqtizer"


def act_dict_to_qstate(act: Dict[str, np.ndarray], spec, device="cuda") -> tuple[QState, tuple]:
    """One 'act_{t}' dict -> (qstate {'a': ..., 'sm': ...}, group conv names).

    Rank-3 deltas are group params: (1, C, 1) mid-axis clusters, (1, 1, C)
    last-axis clusters; both become GroupQParams. A delta without a zero
    point is a calibrated log2 softmax delta and goes to 'sm' (the
    reference's own saver drops these; they are kept so that a static-log2
    configuration survives a round trip). Other deltas are per-tensor."""
    conv_names = {n for n, k, _ in spec if k == "conv"}
    a: dict = {}
    sm: dict = {}
    group_layers = []

    def vec(x):
        return _tensor(np.asarray(x).reshape(-1), device)

    def unit(v):
        return torch.full((1,), v, dtype=torch.float32, device=device)

    for key in act:
        name = _act_key_to_name(key)
        if name is None:
            continue
        delta = np.asarray(act[key])
        zp_key = _name_to_act_key(name) + ".zero_point"
        if zp_key not in act:
            sm[name] = _tensor(delta.reshape(()), device)
            continue
        zp = np.asarray(act[zp_key])
        if delta.ndim >= 3:
            if delta.shape[-1] == 1:  # (1, C, 1): mid axis
                a[name] = GroupQParams(vec(delta), vec(zp), unit(1.0), unit(0.0))
            else:  # (1, 1, C): last axis
                a[name] = GroupQParams(unit(1.0), unit(0.0), vec(delta), vec(zp))
            if name in conv_names:
                group_layers.append(name)
        else:
            a[name] = QParams(_tensor(delta.reshape(()), device), _tensor(zp.reshape(()), device))
    return {"a": a, "sm": sm}, tuple(sorted(group_layers))


def qstate_to_act_dict(qstate: QState, spec) -> Dict[str, torch.Tensor]:
    """Inverse of act_dict_to_qstate, in the reference's shapes."""
    out: Dict[str, torch.Tensor] = {}
    for name, qp in qstate.get("a", {}).items():
        base = _name_to_act_key(name)
        if isinstance(qp, GroupQParams):
            dm, dl = _cpu(qp.delta_mid), _cpu(qp.delta_last)
            if dm.numel() > 1 and bool((dl == 1.0).all()):
                out[f"{base}.delta"] = dm.reshape(1, -1, 1)
                out[f"{base}.zero_point"] = _cpu(qp.zp_mid).reshape(1, -1, 1)
            else:
                out[f"{base}.delta"] = dl.reshape(1, 1, -1)
                out[f"{base}.zero_point"] = _cpu(qp.zp_last).reshape(1, 1, -1)
        else:
            out[f"{base}.delta"] = _cpu(qp.delta)
            out[f"{base}.zero_point"] = _cpu(qp.zero_point)
    for name, delta in qstate.get("sm", {}).items():
        # a softmax quantizer is either uniform ('a') or log2 ('sm'): both
        # would write the same key, so a point in both is refused
        if name in qstate.get("a", {}):
            raise ValueError(
                f"{name} has both a uniform ('a') and a log2 ('sm') "
                f"quantizer state; the checkpoint key can hold only one")
        out[f"{_name_to_act_key(name)}.delta"] = _cpu(delta)
    return out


# --------------------------------------------------------------- loaders ----
def load_weight_only(path: str, spec, device="cuda"):
    ckpt = load_pth(path)
    state = ckpt["weight"] if "weight" in ckpt else ckpt
    return weight_ckpt_to_params(state, spec, device)


def load_merged(path: str, spec, device="cuda"):
    """A merged (or activation-only) checkpoint -> (params | None,
    wqp | None, alphas | None, {'act_t': qstate}, group_layers)."""
    ckpt = load_pth(path)
    params = wqp = alphas = None
    if "weight" in ckpt:
        params, wqp, alphas = weight_ckpt_to_params(ckpt.pop("weight"), spec, device)
    per_t = {}
    group_layers: tuple = ()
    for key in ckpt:
        if key.startswith("act_"):
            qs, gl = act_dict_to_qstate(ckpt[key], spec, device)
            per_t[key] = qs
            group_layers = tuple(sorted(set(group_layers) | set(gl)))
    return params, wqp, alphas, per_t, group_layers


def save_weight_only(path: str, params, wqp, spec, alphas=None) -> None:
    save_pth({"weight": params_to_weight_ckpt(params, wqp, spec, alphas)}, path)


def save_act_ckpt(path: str, per_t: Dict[str, QState], spec,
                  weight_dict: Optional[dict] = None) -> None:
    obj = {k: qstate_to_act_dict(v, spec) for k, v in per_t.items()}
    if weight_dict is not None:
        obj["weight"] = weight_dict
    save_pth(obj, path)


def save_merged(path: str, params, wqp, spec, per_t: Dict[str, QState],
                alphas=None) -> None:
    """A merged checkpoint ({'weight': ..., 'act_t': ...}) in one write."""
    save_act_ckpt(path, per_t, spec,
                  weight_dict=params_to_weight_ckpt(params, wqp, spec, alphas))


def merge_ckpts(weight_path: str, act_path: str, out_path: str) -> None:
    """The activation dict with the weight dict injected under 'weight', on
    the raw torch objects: an fp16 / bf16 checkpoint stays in its dtype."""
    w = torch.load(weight_path, map_location="cpu", weights_only=False)
    a = torch.load(act_path, map_location="cpu", weights_only=False)
    a["weight"] = w["weight"] if isinstance(w, dict) and "weight" in w else w
    torch.save(a, out_path)
