"""InceptionV3 FID feature extractor (pool3, 2048-d) on tensors (port of
`dgq_tpu/eval/inception.py`).

pytorch-fid's extractor is torchvision's InceptionV3 with three FID-specific
pooling changes (pytorch_fid/inception.py): the branch_pool of
InceptionA / C / E averages over 3x3 windows with count_include_pad=False;
the second InceptionE (Mixed_7c) max-pools in its pool branch; the features
are the 2048-d global average before fc.

Here it is a function over a params dict: every BasicConv2d is conv + bias
(BatchNorm folded at conversion) + ReLU, OIHW weights, `fc` an (O, I)
linear. The functions take and give NHWC tensors, as `models/layers.py`
does; inside, the network runs NCHW for `F.conv2d`. `load_pt_inception`
reads pytorch-fid's pt_inception-2015-12-05-6726825d.pth from a local file
and folds BN; `init_inception` draws the same structure from a
`torch.Generator`. The extractor runs in float32 (`eval.common.strict_f32`).

Preprocessing is pytorch-fid's default: uint8 [0, 255] -> [0, 1], bilinear
resize to 299x299 without antialiasing (JAX's `jax.image.resize`, see
`eval.common.resize`), then scaled to [-1, 1].
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dgq_tpu_torch.eval.common import resize, strict_f32


def _conv(name, cin, cout, k, s=(1, 1), p=(0, 0)):
    k = (k, k) if isinstance(k, int) else k
    return (name, cin, cout, k, s, p)


def _inception_a(pre: str, cin: int, pool_features: int):
    return [
        _conv(f"{pre}.branch1x1", cin, 64, 1),
        _conv(f"{pre}.branch5x5_1", cin, 48, 1),
        _conv(f"{pre}.branch5x5_2", 48, 64, 5, p=(2, 2)),
        _conv(f"{pre}.branch3x3dbl_1", cin, 64, 1),
        _conv(f"{pre}.branch3x3dbl_2", 64, 96, 3, p=(1, 1)),
        _conv(f"{pre}.branch3x3dbl_3", 96, 96, 3, p=(1, 1)),
        _conv(f"{pre}.branch_pool", cin, pool_features, 1),
    ]


def _inception_b(pre: str, cin: int):
    return [
        _conv(f"{pre}.branch3x3", cin, 384, 3, s=(2, 2)),
        _conv(f"{pre}.branch3x3dbl_1", cin, 64, 1),
        _conv(f"{pre}.branch3x3dbl_2", 64, 96, 3, p=(1, 1)),
        _conv(f"{pre}.branch3x3dbl_3", 96, 96, 3, s=(2, 2)),
    ]


def _inception_c(pre: str, cin: int, c7: int):
    return [
        _conv(f"{pre}.branch1x1", cin, 192, 1),
        _conv(f"{pre}.branch7x7_1", cin, c7, 1),
        _conv(f"{pre}.branch7x7_2", c7, c7, (1, 7), p=(0, 3)),
        _conv(f"{pre}.branch7x7_3", c7, 192, (7, 1), p=(3, 0)),
        _conv(f"{pre}.branch7x7dbl_1", cin, c7, 1),
        _conv(f"{pre}.branch7x7dbl_2", c7, c7, (7, 1), p=(3, 0)),
        _conv(f"{pre}.branch7x7dbl_3", c7, c7, (1, 7), p=(0, 3)),
        _conv(f"{pre}.branch7x7dbl_4", c7, c7, (7, 1), p=(3, 0)),
        _conv(f"{pre}.branch7x7dbl_5", c7, 192, (1, 7), p=(0, 3)),
        _conv(f"{pre}.branch_pool", cin, 192, 1),
    ]


def _inception_d(pre: str, cin: int):
    return [
        _conv(f"{pre}.branch3x3_1", cin, 192, 1),
        _conv(f"{pre}.branch3x3_2", 192, 320, 3, s=(2, 2)),
        _conv(f"{pre}.branch7x7x3_1", cin, 192, 1),
        _conv(f"{pre}.branch7x7x3_2", 192, 192, (1, 7), p=(0, 3)),
        _conv(f"{pre}.branch7x7x3_3", 192, 192, (7, 1), p=(3, 0)),
        _conv(f"{pre}.branch7x7x3_4", 192, 192, 3, s=(2, 2)),
    ]


def _inception_e(pre: str, cin: int):
    return [
        _conv(f"{pre}.branch1x1", cin, 320, 1),
        _conv(f"{pre}.branch3x3_1", cin, 384, 1),
        _conv(f"{pre}.branch3x3_2a", 384, 384, (1, 3), p=(0, 1)),
        _conv(f"{pre}.branch3x3_2b", 384, 384, (3, 1), p=(1, 0)),
        _conv(f"{pre}.branch3x3dbl_1", cin, 448, 1),
        _conv(f"{pre}.branch3x3dbl_2", 448, 384, 3, p=(1, 1)),
        _conv(f"{pre}.branch3x3dbl_3a", 384, 384, (1, 3), p=(0, 1)),
        _conv(f"{pre}.branch3x3dbl_3b", 384, 384, (3, 1), p=(1, 0)),
        _conv(f"{pre}.branch_pool", cin, 192, 1),
    ]


def inception_spec() -> List[Tuple]:
    """All 94 BasicConv2d convs of the InceptionV3 backbone:
    (name, cin, cout, (kh, kw), (sh, sw), (ph, pw))."""
    spec = [
        _conv("Conv2d_1a_3x3", 3, 32, 3, s=(2, 2)),
        _conv("Conv2d_2a_3x3", 32, 32, 3),
        _conv("Conv2d_2b_3x3", 32, 64, 3, p=(1, 1)),
        _conv("Conv2d_3b_1x1", 64, 80, 1),
        _conv("Conv2d_4a_3x3", 80, 192, 3),
    ]
    spec += _inception_a("Mixed_5b", 192, 32)
    spec += _inception_a("Mixed_5c", 256, 64)
    spec += _inception_a("Mixed_5d", 288, 64)
    spec += _inception_b("Mixed_6a", 288)
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
        spec += _inception_c(name, 768, c7)
    spec += _inception_d("Mixed_7a", 768)
    spec += _inception_e("Mixed_7b", 1280)
    spec += _inception_e("Mixed_7c", 2048)
    return spec


_SPEC = {s[0]: s for s in inception_spec()}


# ------------------------------------------------------------- leaf ops (NCHW)
def _conv_relu(params: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """BasicConv2d with BN folded: conv + bias + ReLU."""
    _, _, _, _, s, p = _SPEC[name]
    return F.relu(F.conv2d(x, params[name]["w"], params[name]["b"], stride=s, padding=p))


def _max_pool(x: torch.Tensor, k: int, s: int, p: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, k, s, p)


def _avg_pool_3x3_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 s1 p1 average pool with count_include_pad=False (pytorch-fid's
    FIDInceptionA / C / E_1)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _apply_a(params, pre, x):
    b1 = _conv_relu(params, f"{pre}.branch1x1", x)
    b5 = _conv_relu(params, f"{pre}.branch5x5_2", _conv_relu(params, f"{pre}.branch5x5_1", x))
    b3 = x
    for i in (1, 2, 3):
        b3 = _conv_relu(params, f"{pre}.branch3x3dbl_{i}", b3)
    bp = _conv_relu(params, f"{pre}.branch_pool", _avg_pool_3x3_nopad(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _apply_b(params, pre, x):
    b3 = _conv_relu(params, f"{pre}.branch3x3", x)
    bd = x
    for i in (1, 2, 3):
        bd = _conv_relu(params, f"{pre}.branch3x3dbl_{i}", bd)
    return torch.cat([b3, bd, _max_pool(x, 3, 2)], dim=1)


def _apply_c(params, pre, x):
    b1 = _conv_relu(params, f"{pre}.branch1x1", x)
    b7 = x
    for i in (1, 2, 3):
        b7 = _conv_relu(params, f"{pre}.branch7x7_{i}", b7)
    bd = x
    for i in (1, 2, 3, 4, 5):
        bd = _conv_relu(params, f"{pre}.branch7x7dbl_{i}", bd)
    bp = _conv_relu(params, f"{pre}.branch_pool", _avg_pool_3x3_nopad(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _apply_d(params, pre, x):
    b3 = _conv_relu(params, f"{pre}.branch3x3_2", _conv_relu(params, f"{pre}.branch3x3_1", x))
    b7 = x
    for i in (1, 2, 3, 4):
        b7 = _conv_relu(params, f"{pre}.branch7x7x3_{i}", b7)
    return torch.cat([b3, b7, _max_pool(x, 3, 2)], dim=1)


def _apply_e(params, pre, x, pool: str):
    b1 = _conv_relu(params, f"{pre}.branch1x1", x)
    b3 = _conv_relu(params, f"{pre}.branch3x3_1", x)
    b3 = torch.cat([_conv_relu(params, f"{pre}.branch3x3_2a", b3),
                    _conv_relu(params, f"{pre}.branch3x3_2b", b3)], dim=1)
    bd = _conv_relu(params, f"{pre}.branch3x3dbl_2", _conv_relu(params, f"{pre}.branch3x3dbl_1",
                                                               x))
    bd = torch.cat([_conv_relu(params, f"{pre}.branch3x3dbl_3a", bd),
                    _conv_relu(params, f"{pre}.branch3x3dbl_3b", bd)], dim=1)
    pooled = _max_pool(x, 3, 1, 1) if pool == "max" else _avg_pool_3x3_nopad(x)
    bp = _conv_relu(params, f"{pre}.branch_pool", pooled)
    return torch.cat([b1, b3, bd, bp], dim=1)


# --------------------------------------------------------------- forward ----
@strict_f32
def preprocess_images(images, device=None) -> torch.Tensor:
    """uint8 (N, H, W, 3) [0, 255] or float [0, 1] (numpy or tensor) ->
    (N, 299, 299, 3) f32 in [-1, 1], on `device` (the input's by default)."""
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                        device=device)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    x = x.float()
    if tuple(x.shape[1:3]) != (299, 299):
        x = resize(x, 299, 299, "bilinear", antialias=False)
    return 2.0 * x - 1.0


@strict_f32
def inception_pool3(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(N, 299, 299, 3) in [-1, 1] -> (N, 2048) pool3 features."""
    x = x.permute(0, 3, 1, 2).contiguous()
    for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
        x = _conv_relu(params, name, x)
    x = _max_pool(x, 3, 2)
    x = _conv_relu(params, "Conv2d_4a_3x3", _conv_relu(params, "Conv2d_3b_1x1", x))
    x = _max_pool(x, 3, 2)
    for pre in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _apply_a(params, pre, x)
    x = _apply_b(params, "Mixed_6a", x)
    for pre in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _apply_c(params, pre, x)
    x = _apply_d(params, "Mixed_7a", x)
    x = _apply_e(params, "Mixed_7b", x, pool="avg")
    x = _apply_e(params, "Mixed_7c", x, pool="max")  # FIDInceptionE_2
    return x.mean(dim=(2, 3))


def _device_of(params: Dict):
    return params["Conv2d_1a_3x3"]["w"].device


def fid_features(params: Dict, images, batch_size: int = 32) -> np.ndarray:
    """Images (numpy, N first) -> (N, 2048) features, batch by batch on the
    params' device."""
    images = np.asarray(images)
    dev = _device_of(params)
    return np.concatenate([
        inception_pool3(params, preprocess_images(images[i : i + batch_size], dev)).cpu().numpy()
        for i in range(0, len(images), batch_size)], axis=0)


@strict_f32
def _probs(params: Dict, x: torch.Tensor) -> torch.Tensor:
    feats = inception_pool3(params, x)
    return torch.softmax(F.linear(feats, params["fc"]["w"], params["fc"]["b"]), dim=-1)


def inception_probs(params: Dict, images, batch_size: int = 32) -> np.ndarray:
    """Images -> (N, num_classes) softmax probabilities for the Inception
    Score (the reference's torch-fidelity --isc path). Needs the
    checkpoint's fc head (params['fc'])."""
    if "fc" not in params:
        raise ValueError("params have no fc head; load a full pt_inception checkpoint to "
                         "compute IS")
    images = np.asarray(images)
    dev = _device_of(params)
    return np.concatenate([
        _probs(params, preprocess_images(images[i : i + batch_size], dev)).cpu().numpy()
        for i in range(0, len(images), batch_size)], axis=0)


# ------------------------------------------------------ params/conversion ---
def init_inception(generator: torch.Generator, device="cuda",
                   dtype: torch.dtype = torch.float32) -> Dict:
    """Random He-init params from `generator` (tests, runs without weights:
    relative FID only)."""
    params = {}
    for name, cin, cout, k, _, _ in inception_spec():
        fan_in = cin * k[0] * k[1]
        w = torch.randn((cout, cin, k[0], k[1]), generator=generator, device=generator.device,
                        dtype=dtype) * float(np.sqrt(2.0 / fan_in))
        params[name] = {"w": w.to(device), "b": torch.zeros(cout, dtype=dtype, device=device)}
    return params


def torch_inception_to_params(state: Dict[str, np.ndarray], bn_eps: float = 1e-3,
                              device="cuda") -> Dict:
    """A pytorch-fid / torchvision inception_v3 state dict (numpy values) ->
    the port's params, each BasicConv2d's BatchNorm folded into its conv in
    numpy f32, as the JAX package folds it:

        w' = w * gamma / sqrt(var + eps),  b' = beta - mean * gamma / sqrt(var + eps)

    Keys: '<name>.conv.weight' (OIHW, kept), '<name>.bn.{weight, bias,
    running_mean, running_var}'; 'fc.weight' / 'fc.bias' become the (O, I)
    head used only by IS; AuxLogits keys are ignored."""
    params = {}
    for name, cin, cout, k, _, _ in inception_spec():
        w = np.asarray(state[f"{name}.conv.weight"], np.float32)
        gamma = np.asarray(state[f"{name}.bn.weight"], np.float32)
        beta = np.asarray(state[f"{name}.bn.bias"], np.float32)
        mean = np.asarray(state[f"{name}.bn.running_mean"], np.float32)
        var = np.asarray(state[f"{name}.bn.running_var"], np.float32)
        scale = gamma / np.sqrt(var + bn_eps)
        w = w * scale[:, None, None, None]
        b = beta - mean * scale
        assert w.shape == (cout, cin, k[0], k[1]), (name, w.shape)
        params[name] = {"w": torch.from_numpy(np.ascontiguousarray(w)).to(device),
                        "b": torch.from_numpy(b).to(device)}
    if "fc.weight" in state:
        params["fc"] = {"w": torch.from_numpy(np.asarray(state["fc.weight"], np.float32)).to(
                            device),
                        "b": torch.from_numpy(np.asarray(state["fc.bias"], np.float32)).to(
                            device)}
    return params


def load_pt_inception(path: str, device="cuda") -> Dict:
    """Load pytorch-fid's FID Inception checkpoint
    (pt_inception-2015-12-05-6726825d.pth) from a local file."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return torch_inception_to_params(
        {k: v.numpy() for k, v in state.items() if hasattr(v, "numpy")}, device=device)
