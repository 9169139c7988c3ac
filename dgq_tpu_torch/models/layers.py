"""NHWC layer primitives with quantization hook points (port of the deploy
half of `dgq_tpu/models/layers.py`).

Activations stay NHWC, as in the JAX package, so the two compare like with
like; a conv views its input as NCHW with `permute` (a channels_last view,
no copy) and runs `F.conv2d` on OIHW weights. Weights arrive already
fake-quantized (folded at load); activation quantizers apply through
`aq_apply`. Attention runs the fused kernels (`ops.attention`) when
`cfg.use_pallas_attention`, and the materialized softmax otherwise.

Linears and 1x1 convs dispatch in the JAX package's order: the int8 deploy
path (`cfg.use_int8_matmul`, packed weights and a per-tensor activation
scale: the K6 kernel `ops.int8_matmul`, or the library route
`int8_impl="xla"`), then the codes fold (`cfg.fold_act_dequant`), then
fake-quant.

Group-mode convs (`cfg.group_conv_layers`) quantize the unfolded input, where
each (channel, tap) of the c-major mid axis k = c*kh*kw + i*kw + j has its
own scale. The JAX package reads its HWIO weights as (taps, C, O) by a plain
reshape; here `_w_hwio` makes that view of the OIHW weights with a permute,
and each group path reshapes it to (taps, C, O) or (taps*C, O).

Params are dicts: conv {'w': OIHW, 'b': (O,)}, linear {'w': (O, I), 'b'},
norms {'scale', 'bias'}.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from dgq_tpu_torch.models.qconfig import (
    GroupQParams,
    QConfig,
    QState,
    aq_apply,
    softmax_q_apply,
)
from dgq_tpu_torch.ops.attention import fused_attention
from dgq_tpu_torch.ops.group_conv import fused_eligible, group_quant_conv, matmul_f32acc
from dgq_tpu_torch.ops.int8_matmul import quantized_matmul
from dgq_tpu_torch.quant.affine import QParams, fake_quant, quant_bounds, ste_round


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x, p["w"].to(x.dtype))
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC conv with OIHW weights."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype), stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def _out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int):
    return (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1


def _tap_slices(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """The kh*kw strided slices (B, H', W', C) of the zero-padded input, in
    (i, j) order."""
    _, h, w, _ = x.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    return [xp[:, i:i + (ho - 1) * stride + 1:stride, j:j + (wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]


def _w_hwio(p) -> torch.Tensor:
    """The (kh, kw, C, O) view of an OIHW conv weight."""
    return p["w"].permute(2, 3, 1, 0)


def unfold_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """NHWC im2col -> (B, C*kh*kw, L) with the mid axis c-major (c, i, j),
    as `F.unfold` gives on NCHW."""
    b, c = x.shape[0], x.shape[3]
    pt = torch.stack(_tap_slices(x, kh, kw, stride, padding), dim=0)  # (taps, B, H', W', C)
    return pt.permute(1, 4, 0, 2, 3).reshape(b, c * kh * kw, -1)


def conv2d_unfolded(p, x_unf: torch.Tensor, out_hw) -> torch.Tensor:
    """Conv as a matmul over the unfolded input (B, CKK, L) -> NHWC."""
    o = p["w"].shape[0]
    w_unf = p["w"].reshape(o, -1).t()  # OIHW flattens c-major, as unfold_nhwc
    y = torch.matmul(x_unf.transpose(1, 2), w_unf.to(x_unf.dtype))
    if p.get("b") is not None:
        y = y + p["b"]
    return y.reshape(x_unf.shape[0], out_hw[0], out_hw[1], o)


def _group_tap_scales(gqp, c, kh, kw, ho, wo):
    """Group scales -> per-tap broadcastable forms: (dm2, zm2) of shape
    (C or 1, kh*kw or 1) over the c-major mid axis, and (dl4, zl4) of shape
    (1, H', W', 1) or (1, 1, 1, 1) over output locations."""
    if isinstance(gqp, GroupQParams):
        dm, zm = gqp.delta_mid.reshape(-1), gqp.zp_mid.reshape(-1)
        dl, zl = gqp.delta_last.reshape(-1), gqp.zp_last.reshape(-1)
    else:  # plain QParams: uniform over taps
        dm, zm = gqp.delta.reshape(-1), gqp.zero_point.reshape(-1)
        zm = zm.expand(dm.shape) if zm.numel() != dm.numel() else zm
        dl, zl = torch.ones(1, device=dm.device), torch.zeros(1, device=dm.device)
    if dm.numel() == c * kh * kw:
        dm2, zm2 = dm.reshape(c, kh * kw), zm.reshape(c, kh * kw)
    elif dm.numel() == c:
        dm2, zm2 = dm.reshape(c, 1), zm.reshape(c, 1)
    elif dm.numel() == 1:
        dm2, zm2 = dm.reshape(1, 1), zm.reshape(1, 1)
    else:
        raise ValueError(f"group conv delta size {dm.numel()} is none of C*kh*kw="
                         f"{c * kh * kw}, C={c}, or 1")
    if dl.numel() == ho * wo:
        dl4, zl4 = dl.reshape(1, ho, wo, 1), zl.reshape(1, ho, wo, 1)
    elif dl.numel() == 1:
        dl4, zl4 = dl.reshape(1, 1, 1, 1), zl.reshape(1, 1, 1, 1)
    else:
        raise ValueError(f"group conv delta_last size {dl.numel()} is neither H'*W'="
                         f"{ho * wo} nor 1")
    return dm2, zm2, dl4, zl4


def group_quant_conv2d_im2col(p, x: torch.Tensor, gqp, cfg: QConfig, stride: int = 1,
                              padding: int = 0) -> torch.Tensor:
    """Group-quantized conv as one tap-major quantized im2col and one matmul:
    the kh*kw fake-quantized tap slices are concatenated along the channel
    axis in (i, j, c) order and contracted against the (kh*kw*C, O) weight."""
    o, c, kh, kw = p["w"].shape
    b, h, w, _ = x.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    dm2, zm2, dl4, zl4 = _group_tap_scales(gqp, c, kh, kw, ho, wo)
    cols = []
    for ij, xs in enumerate(_tap_slices(x, kh, kw, stride, padding)):
        d_ij = dm2[:, ij % dm2.shape[1]].reshape(1, 1, 1, -1) * dl4
        z_ij = zm2[:, ij % zm2.shape[1]].reshape(1, 1, 1, -1) + zl4
        cols.append(fake_quant(xs, QParams(d_ij, z_ij), cfg.a_bits))
    big = torch.cat(cols, dim=-1)  # (B, H', W', kh*kw*C)
    w2 = _w_hwio(p).reshape(kh * kw * c, o).to(big.dtype)
    y = matmul_f32acc(big.reshape(-1, kh * kw * c), w2).reshape(b, ho, wo, o)
    if p.get("b") is not None:
        y = y + p["b"]
    return y.to(x.dtype)


def group_quant_conv2d_taps(p, x: torch.Tensor, gqp, cfg: QConfig, stride: int = 1,
                            padding: int = 0) -> torch.Tensor:
    """Group-quantized conv without the im2col tensor: per tap (i, j), the
    strided slice is quantized to codes with that tap's scales and contracted
    against w[i, j] as a 1x1 matmul; the f32 sum over taps equals the unfold
    result. The dequantize half of fake-quant is folded away:

        fq(x) . w = dl[l] * (q' @ (dm . w)),
        q' = clip(round(x / (dm . dl)), -(zm + zl), 2^b - 1 - (zm + zl))

    The (fractional) zero point stays in the clip bounds, so q' is an integer
    except at the clip boundaries and no output correction is needed; adding
    it to the codes instead would leave a per-channel bias under a bf16
    matmul. The codes are cast to the input dtype before the matmul (integers
    below 2^b are exact in bf16)."""
    o, c, kh, kw = p["w"].shape
    b, h, w, _ = x.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    dm2, zm2, dl4, zl4 = _group_tap_scales(gqp, c, kh, kw, ho, wo)
    nb, pb = quant_bounds(cfg.a_bits, False, False)
    ncols, taps = dm2.shape[1], kh * kw
    # (taps, C or 1, 1) per-tap channel scales, folded into the weight
    dm_t = dm2.expand(-1, taps).t()[:, :, None]
    ws = (_w_hwio(p).reshape(taps, c, o).float() * dm_t).to(x.dtype)
    rdm2 = 1.0 / dm2.float()
    rdl4 = 1.0 / dl4.float()
    acc = torch.zeros(b * ho * wo, o, dtype=torch.float32, device=x.device)
    for ij, xs in enumerate(_tap_slices(x, kh, kw, stride, padding)):
        rd_ij = rdm2[:, ij % ncols].reshape(1, 1, 1, -1) * rdl4
        z_ij = zm2[:, ij % ncols].reshape(1, 1, 1, -1) + zl4
        q = torch.clamp(ste_round(xs.float() * rd_ij), nb - z_ij, pb - z_ij).to(x.dtype)
        acc = acc + matmul_f32acc(q.reshape(-1, c), ws[ij])
    acc = dl4 * acc.reshape(b, ho, wo, o)
    if p.get("b") is not None:
        acc = acc + p["b"]
    return acc.to(x.dtype)


def _group_quant_conv2d(p, x, name, qstate, cfg, stride, padding):
    """The group branch of quant_conv2d, by cfg.group_conv_impl. 'fused'
    launches the kernel where `fused_eligible` holds and takes the taps path
    elsewhere (the stride-2 downsamplers), as the JAX package does."""
    o, c, kh, kw = p["w"].shape
    gqp = (qstate or {}).get("a", {}).get(name)
    impl = cfg.group_conv_impl
    if gqp is not None and impl == "fused" and fused_eligible(
            x.shape, o, kh, kw, stride, padding, gqp):
        # the mid axis is c-major (c, i, j); the kernel wants (tap, channel)
        dm = gqp.delta_mid.reshape(c, kh * kw).t()
        zm = gqp.zp_mid.reshape(c, kh * kw).t()
        return group_quant_conv(x.contiguous(), _w_hwio(p), dm, zm, gqp.delta_last,
                                gqp.zp_last, p.get("b"), kh=kh, kw=kw, padding=padding,
                                a_bits=cfg.a_bits)
    if gqp is not None and impl in ("fused", "taps"):
        return group_quant_conv2d_taps(p, x, gqp, cfg, stride, padding)
    if gqp is not None and impl == "im2col":
        return group_quant_conv2d_im2col(p, x, gqp, cfg, stride, padding)
    x_unf = unfold_nhwc(x, kh, kw, stride, padding)
    if isinstance(gqp, QParams) and gqp.delta.numel() == c and c != 1:
        # per-channel (C,) plain QParams on a group-listed layer: delta[c]
        # applies to every tap of channel c, so expand it to the c-major mid
        # axis (a bare (C,) would broadcast against the location axis L)
        d = gqp.delta.reshape(-1).repeat_interleave(kh * kw)
        z = gqp.zero_point.reshape(-1).expand(c).repeat_interleave(kh * kw)
        x_unf = fake_quant(x_unf, QParams(d.reshape(1, -1, 1), z.reshape(1, -1, 1)), cfg.a_bits)
    else:
        x_unf = aq_apply(qstate, cfg, name, x_unf)
    return conv2d_unfolded(p, x_unf.to(x.dtype), _out_hw(x.shape[1], x.shape[2], kh, kw,
                                                         stride, padding))


def quant_conv2d(p, x: torch.Tensor, name: str, qstate: Optional[QState], cfg: QConfig,
                 stride: int = 1, padding: int = 0) -> torch.Tensor:
    """QuantLayer-conv forward. Group-mode layers (cfg.group_conv_layers)
    quantize the unfolded input. Otherwise, in order: a stride-1 1x1 conv with
    packed weights and a per-tensor scale runs as an int8 matmul; a per-tensor
    scale under cfg.fold_act_dequant takes the codes fold; else the activation
    fake-quant applies elementwise and the conv keeps the activation's own
    dtype (the quantizer's f32 delta would otherwise upcast a bf16 run)."""
    if name in cfg.group_conv_layers and cfg.use_aq:
        return _group_quant_conv2d(p, x, name, qstate, cfg, stride, padding)
    qp = _int8_qp(p, qstate, cfg, name)
    if (qp is not None and tuple(p["w"].shape[2:]) == (1, 1) and stride == 1 and padding == 0
            and "w_q8" in p and cfg.use_int8_matmul):
        b, h, w, c = x.shape
        y = _int8_dispatch(p, x.reshape(b * h * w, c), qp, cfg)
        if y is not None:
            return y.reshape(b, h, w, y.shape[-1])
    qpf = _fold_qp(qstate, cfg, name)
    if qpf is not None:
        return _codes_conv2d(p, x, qpf, cfg, stride, padding)
    return conv2d(p, aq_apply(qstate, cfg, name, x).to(x.dtype), stride, padding)


def _fold_qp(qstate, cfg: QConfig, name: str):
    """Per-tensor activation QParams eligible for the codes-fold deploy path
    (per-channel and group scales stay on the fake-quant path)."""
    if qstate is None or not cfg.use_aq or not cfg.fold_act_dequant:
        return None
    qp = qstate.get("a", {}).get(name)
    if not isinstance(qp, QParams) or qp.delta.dim() != 0 or qp.zero_point.dim() != 0:
        return None
    return qp


def _fold_codes(x: torch.Tensor, qp: QParams, bits: int):
    """Shifted integer codes q' = clip(round(x/delta), -zp, PB-zp) in the
    input dtype, and delta as f32. delta * q' == fake_quant(x) exactly: the
    zero point lives in the clip bounds, the dequantize multiply moves to the
    consumer's epilogue, and zero padding of q' dequantizes to 0.0. The codes
    are integers in [-PB, PB], exact in bf16 for bits <= 8."""
    nb, pb = quant_bounds(bits, False, False)
    d = qp.delta.float()
    z = qp.zero_point.float()
    q = torch.clamp(ste_round(x.float() * (1.0 / d)), nb - z, pb - z)
    return q.to(x.dtype), d


def _codes_linear(p, x: torch.Tensor, qp: QParams, cfg: QConfig) -> torch.Tensor:
    """Codes fold for a linear: the f32 accumulator is scaled by delta before
    the bias and the cast, as in the JAX package."""
    q, d = _fold_codes(x, qp, cfg.a_bits)
    y = matmul_f32acc(q.reshape(-1, q.shape[-1]), p["w"].to(q.dtype).t()) * d
    if p.get("b") is not None:
        y = y + p["b"]
    return y.reshape(x.shape[:-1] + (y.shape[-1],)).to(x.dtype)


def _codes_conv2d(p, x: torch.Tensor, qp: QParams, cfg: QConfig, stride: int,
                  padding: int) -> torch.Tensor:
    """Codes fold for a conv. The JAX package asks its conv for an f32
    accumulator; `F.conv2d` has no such argument and a bf16 conv would round
    its output to bf16 before the delta multiply. So the conv runs on f32
    copies of the codes and the weights: both are exact there (and in TF32:
    8-bit codes, bf16 weights), the sum is f32, and delta, the bias and the one
    cast follow as in the JAX package. No extra rounding."""
    q, d = _fold_codes(x, qp, cfg.a_bits)
    y = F.conv2d(q.float().permute(0, 3, 1, 2), p["w"].to(q.dtype).float(), stride=stride,
                 padding=padding).permute(0, 2, 3, 1) * d
    if p.get("b") is not None:
        y = y + p["b"]
    return y.to(x.dtype)


def _int8_qp(p, qstate, cfg: QConfig, name: str):
    """Per-tensor activation QParams for the int8 path, if eligible (group
    and per-channel scales stay on the fake-quant path)."""
    if not (cfg.use_int8_matmul and cfg.use_aq and qstate is not None):
        return None
    if "w_q8" not in p:
        return None
    qp = (qstate.get("a") or {}).get(name)
    if not isinstance(qp, QParams) or qp.delta.dim() != 0:
        return None
    return qp


def _int8_matmul(p, x2: torch.Tensor, qp: QParams, cfg: QConfig) -> torch.Tensor:
    """The K6 route. The zero point is rounded before the codes are built:
    the kernel casts rounded-and-clipped codes to int8, so a fractional zero
    point would bias every stored code by its fraction while the epilogue
    still corrected with the exact value."""
    off = 2 ** (cfg.a_bits - 1)
    zp = torch.round(qp.zero_point.float())
    return quantized_matmul(x2.contiguous(), p["w_q8"], p["w_d"], p["w_z"], qp.delta.float(),
                            zp - off, p.get("b"), p.get("w_ksum"), a_bits=cfg.a_bits)


# Shape gate of the library route, kept with the JAX package's constants so
# that both packages send the same layers the same way. They were chosen from
# measurements on another chip (a TPU) and say nothing about this card: they
# are here for routing parity only.
_INT8_XLA_MIN_M = 16384
_INT8_XLA_MAX_K = 512


def _int8_xla_eligible(m: int, k: int) -> bool:
    return m >= _INT8_XLA_MIN_M and k <= _INT8_XLA_MAX_K


def _int_mm_takes(x2: torch.Tensor, n: int) -> bool:
    """`torch._int_mm` on the card wants more than 16 rows and K, N multiples
    of 8; other shapes fall through to the next path, as shapes outside the
    gate do."""
    m, k = x2.shape
    return not x2.is_cuda or (m > 16 and k % 8 == 0 and n % 8 == 0)


def _int8_matmul_xla(p, x2: torch.Tensor, qp: QParams, cfg: QConfig) -> torch.Tensor:
    """The library route (`int8_impl="xla"`): quantize to recentered int8
    codes with torch ops, one library s8 x s8 -> s32 matmul (`torch._int_mm`
    on the card; an exact float64 product on the CPU), and the analytic
    removal of the affine cross terms in f32:

        fq(x).fq(w) = dx*dw[n] * (u@w8 - zx*wksum[n] - wz[n]*rowsum[m] + K*zx*wz[n])

    with u / w8 the recentered codes and zx / wz the recentered zero points."""
    off = 2 ** (cfg.a_bits - 1)
    dx = qp.delta.float()
    zp = torch.round(qp.zero_point.float())
    zx = zp - off
    u = (torch.clamp(torch.round(x2.float() / dx) + zp, 0, 2 ** cfg.a_bits - 1) - off).to(
        torch.int8)
    if x2.is_cuda:
        acc = torch._int_mm(u, p["w_q8"].t()).float()
        rowsum = u.sum(dim=1, keepdim=True, dtype=torch.int32).float()
    else:
        acc = (u.double() @ p["w_q8"].double().t()).float()
        rowsum = u.double().sum(dim=1, keepdim=True).float()
    k = x2.shape[-1]
    y = dx * p["w_d"] * (acc - zx * p["w_ksum"] - p["w_z"] * rowsum + float(k) * zx * p["w_z"])
    if p.get("b") is not None:
        y = y + p["b"]
    return y.to(x2.dtype)


def _int8_dispatch(p, x2: torch.Tensor, qp: QParams, cfg: QConfig):
    """The int8 matmul by cfg.int8_impl, or None where the library route's
    gate sends the layer on to the next path."""
    if cfg.int8_impl == "xla":
        if _int8_xla_eligible(x2.shape[0], x2.shape[1]) and _int_mm_takes(
                x2, p["w_q8"].shape[0]):
            return _int8_matmul_xla(p, x2, qp, cfg)
        return None
    return _int8_matmul(p, x2, qp, cfg)


def quant_linear(p, x: torch.Tensor, name: str, qstate: Optional[QState],
                 cfg: QConfig) -> torch.Tensor:
    """QuantLayer-linear forward: with packed int8 weights and a per-tensor
    activation scale, one int8 matmul that quantizes in the kernel; else the
    codes fold; else activation fake-quant, then the matmul in the
    activation's own dtype."""
    qp = _int8_qp(p, qstate, cfg, name)
    if qp is not None:
        y = _int8_dispatch(p, x.reshape(-1, x.shape[-1]), qp, cfg)
        if y is not None:
            return y.reshape(x.shape[:-1] + (y.shape[-1],))
    qpf = _fold_qp(qstate, cfg, name)
    if qpf is not None:
        return _codes_linear(p, x, qpf, cfg)
    return linear(p, aq_apply(qstate, cfg, name, x).to(x.dtype))


def group_norm(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC: one pass of per-channel f32 sum and sum of
    squares, group aggregation on the (B, C) partials, then x*A + B in the
    input dtype."""
    b, h, w, c = x.shape
    cg = c // groups
    xf = x.float()
    s1 = xf.sum(dim=(1, 2))
    s2 = (xf * xf).sum(dim=(1, 2))
    g1 = s1.reshape(b, groups, cg).sum(dim=2)
    g2 = s2.reshape(b, groups, cg).sum(dim=2)
    n = h * w * cg
    mean = g1 / n
    var = g2 / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    a = rstd_c * p["scale"].float()[None, :]
    bb = p["bias"].float()[None, :] - mean_c * a
    out = xf * a[:, None, None, :] + bb[:, None, None, :]
    return out.to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, one-pass f32 statistics."""
    xf = x.float()
    s1 = xf.sum(dim=-1, keepdim=True)
    s2 = (xf * xf).sum(dim=-1, keepdim=True)
    n = x.shape[-1]
    mean = s1 / n
    var = s2 / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    a = rstd * p["scale"].float()
    out = xf * a + (p["bias"].float() - mean * a)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def timestep_embedding(timesteps: torch.Tensor, num_channels: int = 320) -> torch.Tensor:
    """Sinusoidal timestep projection, cos then sin. Arguments reach ~1000
    rad, so they are reduced mod 2*pi first."""
    half = num_channels // 2
    exponent = (-math.log(10000.0)
                * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    two_pi = 2.0 * math.pi
    emb = emb - two_pi * torch.floor(emb / two_pi)
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def geglu_ff(p, prefix: str, x: torch.Tensor, qstate, cfg) -> torch.Tensor:
    """GEGLU feed-forward: proj -> chunk -> x1 * gelu(x2) (exact erf)."""
    h = quant_linear(p[f"{prefix}.net.0.proj"], x, f"{prefix}.net.0.proj", qstate, cfg)
    x1, x2 = h.chunk(2, dim=-1)
    h = x1 * F.gelu(x2)
    return quant_linear(p[f"{prefix}.net.2"], h, f"{prefix}.net.2", qstate, cfg)


def _sm_select(qstate, cfg: QConfig, prefix: str, device):
    """Softmax-quant mode + static delta for the fused attention."""
    if cfg.use_aq and cfg.t2i_log_quant:
        sm_mode = "log2_real_time" if cfg.t2i_real_time else "log2"
        sm_delta = (
            torch.ones((), device=device) if cfg.log_max_1
            else (qstate or {}).get("sm", {}).get(f"{prefix}.aqtizer_w")
        )
        if sm_mode == "log2" and sm_delta is None:
            sm_mode = "none"
        return sm_mode, sm_delta
    if cfg.use_aq and (qstate or {}).get("a", {}).get(f"{prefix}.aqtizer_w") is not None:
        # the kernel quantizes with zero point 0, exact for aqtizer_w, which
        # the reference builds always_zero
        return "uniform", qstate["a"][f"{prefix}.aqtizer_w"].delta
    return "none", None


def _unpack_heads(x: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """(B, T, H*dp) packed head-slot tensor -> (B, T, H*head_dim), the
    reference layout (the zero padding lanes dropped)."""
    b, t, cp = x.shape
    x4 = x.reshape(b, t, num_heads, cp // num_heads)[..., :head_dim]
    return x4.reshape(b, t, num_heads * head_dim)


def _repack_heads(x: torch.Tensor, num_heads: int, dp: int) -> torch.Tensor:
    """(B, T, H*head_dim) -> (B, T, H*dp) zero-padded head slots (for the
    packed to_out.0 weight when a non-packed attention path produced x)."""
    b, t, c = x.shape
    d = c // num_heads
    return F.pad(x.reshape(b, t, num_heads, d), (0, dp - d)).reshape(b, t, num_heads * dp)


def _attn_out(p, prefix, out, qstate, cfg, num_heads):
    """Final projection; re-pads head slots when to_out.0 carries packed
    columns but `out` is in the reference layout."""
    w_cols = p[f"{prefix}.to_out.0"]["w"].shape[1]
    if w_cols != out.shape[-1]:
        out = _repack_heads(out, num_heads, w_cols // num_heads)
    return quant_linear(p[f"{prefix}.to_out.0"], out, f"{prefix}.to_out.0", qstate, cfg)


def _attention_packed(p, prefix, q, k, v, num_heads, head_dim, scale, qstate, cfg, start_peak,
                      dtype):
    """Packed head-slot attention: q/k/v stay (B, T/S, H*dp) from the
    projections to to_out.0; the kernels address each head's slot by stride,
    so no transposed copy is made. Per-tensor quantizers act the same in this
    layout (0 -> 0 on the padding lanes)."""
    q = aq_apply(qstate, cfg, f"{prefix}.aqtizer_q", q)
    if start_peak:
        # key position 0 (sequence row 0) is spared, as in the reference
        k = torch.cat([k[:, 0:1, :],
                       aq_apply(qstate, cfg, f"{prefix}.aqtizer_k", k[:, 1:, :])], dim=1)
    else:
        k = aq_apply(qstate, cfg, f"{prefix}.aqtizer_k", k)
    v = aq_apply(qstate, cfg, f"{prefix}.aqtizer_v", v)
    sm_mode, sm_delta = _sm_select(qstate, cfg, prefix, q.device)
    out = fused_attention(
        q, k, v, scale, sm_mode=sm_mode, sm_bits=cfg.softmax_bits, sm_delta=sm_delta,
        start_peak=start_peak and cfg.use_aq, num_heads=num_heads, head_dim=head_dim,
    ).to(dtype)
    return quant_linear(p[f"{prefix}.to_out.0"], out, f"{prefix}.to_out.0", qstate, cfg)


def attention(p, prefix: str, x: torch.Tensor, ehs: Optional[torch.Tensor],
              num_heads: int, qstate: Optional[QState], cfg: QConfig,
              start_peak: bool = False) -> torch.Tensor:
    """Quantization-aware attention. Quant points: aqtizer_q on q, aqtizer_k
    on k (sparing key 0 under start_peak), aqtizer_w on the f32
    post-softmax weights (again sparing key 0), aqtizer_v on v."""
    b, t, c = x.shape
    head_dim = c // num_heads
    scale = head_dim ** -0.5

    q = quant_linear(p[f"{prefix}.to_q"], x, f"{prefix}.to_q", qstate, cfg)
    kv_in = ehs if ehs is not None else x
    k = quant_linear(p[f"{prefix}.to_k"], kv_in, f"{prefix}.to_k", qstate, cfg)
    v = quant_linear(p[f"{prefix}.to_v"], kv_in, f"{prefix}.to_v", qstate, cfg)
    s = kv_in.shape[1]

    if cfg.packed_attention:
        dp = q.shape[-1] // num_heads
        # dp % 128 == 0: one head per slot. dp == 64 with an even head count:
        # slot-64 packed weights, and models whose heads are 64 wide already
        # (SDXL) with no weight packing at all.
        if (cfg.use_pallas_attention and dp * num_heads == q.shape[-1]
                and (dp % 128 == 0 or (dp == 64 and num_heads % 2 == 0))):
            return _attention_packed(p, prefix, q, k, v, num_heads, head_dim, scale, qstate,
                                     cfg, start_peak, x.dtype)
        if q.shape[-1] != c:
            # packed weights but a path that needs the reference layout (the
            # materialized softmax): slice the padding lanes back out; the
            # output is re-padded for the packed to_out.0
            q = _unpack_heads(q, num_heads, head_dim)
            k = _unpack_heads(k, num_heads, head_dim)
            v = _unpack_heads(v, num_heads, head_dim)
    q = q.reshape(b, t, num_heads, head_dim).permute(0, 2, 1, 3)
    k = k.reshape(b, s, num_heads, head_dim).permute(0, 2, 1, 3)
    v = v.reshape(b, s, num_heads, head_dim).permute(0, 2, 1, 3)

    q = aq_apply(qstate, cfg, f"{prefix}.aqtizer_q", q)
    if start_peak:
        k = torch.cat([k[..., 0:1, :],
                       aq_apply(qstate, cfg, f"{prefix}.aqtizer_k", k[..., 1:, :])], dim=-2)
    else:
        k = aq_apply(qstate, cfg, f"{prefix}.aqtizer_k", k)
    v = aq_apply(qstate, cfg, f"{prefix}.aqtizer_v", v)

    if cfg.use_pallas_attention:
        sm_mode, sm_delta = _sm_select(qstate, cfg, prefix, q.device)
        out = fused_attention(
            q.reshape(b * num_heads, t, head_dim),
            k.reshape(b * num_heads, s, head_dim),
            v.reshape(b * num_heads, s, head_dim),
            scale, sm_mode=sm_mode, sm_bits=cfg.softmax_bits, sm_delta=sm_delta,
            start_peak=start_peak and cfg.use_aq,
        )
        out = out.reshape(b, num_heads, t, head_dim)
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        attn = torch.softmax(scores, dim=-1)
        if start_peak:
            attn = torch.cat([
                attn[..., 0:1],
                softmax_q_apply(qstate, cfg, f"{prefix}.aqtizer_w", attn[..., 1:])], dim=-1)
        else:
            attn = softmax_q_apply(qstate, cfg, f"{prefix}.aqtizer_w", attn)
        out = torch.matmul(attn.to(v.dtype), v)
    out = out.permute(0, 2, 1, 3).reshape(b, t, c).to(x.dtype)
    return _attn_out(p, prefix, out, qstate, cfg, num_heads)


def basic_transformer_block(p, prefix: str, x: torch.Tensor, ehs: Optional[torch.Tensor],
                            num_heads: int, qstate, cfg: QConfig) -> torch.Tensor:
    """Self-attn -> cross-attn -> GEGLU FF, each residual. start_peak
    applies only to the cross attention (attn2)."""
    h = layer_norm(p[f"{prefix}.norm1"], x)
    x = attention(p, f"{prefix}.attn1", h, None, num_heads, qstate, cfg) + x
    h = layer_norm(p[f"{prefix}.norm2"], x)
    x = attention(p, f"{prefix}.attn2", h, ehs, num_heads, qstate, cfg,
                  start_peak=cfg.t2i_start_peak) + x
    h = layer_norm(p[f"{prefix}.norm3"], x)
    return geglu_ff(p, f"{prefix}.ff", h, qstate, cfg) + x


def resnet_block(p, prefix: str, x: torch.Tensor, temb: torch.Tensor, qstate,
                 cfg: QConfig, has_shortcut: bool) -> torch.Tensor:
    """ResnetBlock2D, NHWC."""
    h = silu(group_norm(p[f"{prefix}.norm1"], x))
    h = quant_conv2d(p[f"{prefix}.conv1"], h, f"{prefix}.conv1", qstate, cfg, 1, 1)
    te = quant_linear(p[f"{prefix}.time_emb_proj"], silu(temb),
                      f"{prefix}.time_emb_proj", qstate, cfg)
    h = h + te[:, None, None, :]
    h = silu(group_norm(p[f"{prefix}.norm2"], h))
    h = quant_conv2d(p[f"{prefix}.conv2"], h, f"{prefix}.conv2", qstate, cfg, 1, 1)
    if has_shortcut:
        x = quant_conv2d(p[f"{prefix}.conv_shortcut"], x, f"{prefix}.conv_shortcut",
                         qstate, cfg, 1, 0)
    return x + h


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)
