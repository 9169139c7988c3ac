"""Scale initializers for affine quantizers (port of
`dgq_tpu/quant/scalers.py`): minmax, mse (80-point shrink grid, Lp p=2.4),
omse (80 ranges x every zero point), logminmax (a log2 grid over ten deltas),
kl (histogram KL over 50 clip ratios) and hist (0.9996 mass clip).

The JAX package runs mse / omse / logminmax as a `lax.scan` over the
candidates, `vmap`ped over the rows of a weight. Here the candidates are a
Python loop with a running best (the first strict minimum, `s < best_s`),
batched over rows and chunked over them: a channelwise search makes no
tensor larger than `ROW_CHUNK_ELEMENTS` (or one row) for a candidate, where
an 80-candidate product with a 1280 x 11520 weight would hold 4.7 GB in
float32. A per-tensor search is one row, the whole tensor, and holds a few
copies of it for each candidate (the CLIs give activations minmax scales).

kl / hist are histogram searches and run on the host in numpy float32, as in
the JAX package: the histogram's bin edges decide the clip ratio, and
float64 edges pick other ratios than the reference's float32 tensors.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from dgq_tpu_torch.quant.affine import QParams

# the largest rows x elements block one candidate evaluates at a time
ROW_CHUNK_ELEMENTS = 1 << 24


class Scaler(str, enum.Enum):
    MINMAX = "minmax"
    MSE = "mse"
    KL = "kl"
    HIST = "hist"
    OMSE = "omse"
    LOGMINMAX = "logminmax"


def lp_loss(pred: torch.Tensor, tgt: torch.Tensor, p: float = 2.0, *,
            all_mean: bool = True, dim=None) -> torch.Tensor:
    """Lp loss: mean(|pred - tgt|^p) (all_mean), or the sum over axis 1 then
    the mean (all_mean=False). `dim` takes the mean over that axis only (the
    per-row losses of a batched search)."""
    err = torch.abs(pred - tgt) ** p
    if dim is not None:
        return err.mean(dim=dim)
    if all_mean:
        return err.mean()
    return err.sum(dim=1).mean()


def _bounds(level: int, symmetric: bool, always_zero: bool) -> tuple[int, int]:
    if symmetric and not always_zero:
        return -level // 2, level // 2 - 1
    return 0, level - 1


# ---------------------------------------------------------------- minmax ----
def _minmax_from_range(x_min, x_max, level: int, symmetric: bool,
                       always_zero: bool) -> QParams:
    delta = (x_max - x_min) / (level - 1)
    if symmetric:
        hi = torch.maximum(torch.abs(x_min), x_max)
        x_min = -hi
        delta = (hi - x_min) / (level - 2)
    if always_zero:
        delta = x_max / (level - 1)
    delta = torch.clamp(delta, min=1e-8)
    if symmetric or always_zero:
        zp = torch.zeros_like(delta)
    else:
        zp = torch.round(-x_min / delta)
    return QParams(delta=delta, zero_point=zp)


def minmax_scale(x: torch.Tensor, level: int, symmetric: bool,
                 always_zero: bool) -> QParams:
    """Per-tensor minmax; x_min clamped <= 0, x_max clamped >= 0."""
    x_min = torch.clamp(x.min(), max=0.0)
    x_max = torch.clamp(x.max(), min=0.0)
    return _minmax_from_range(x_min, x_max, level, symmetric, always_zero)


def minmax_scale_rows(flat: torch.Tensor, level: int, symmetric: bool,
                      always_zero: bool) -> QParams:
    """Minmax per row of a (rows, n) tensor."""
    x_min = torch.clamp(flat.amin(dim=1), max=0.0)
    x_max = torch.clamp(flat.amax(dim=1), min=0.0)
    return _minmax_from_range(x_min, x_max, level, symmetric, always_zero)


# ------------------------------------------------------- batched searches ---
def _search_rows(flat: torch.Tensor, candidates, init_delta):
    """The running-best search of mse / omse / logminmax over the rows of
    `flat`, a block of rows at a time. `candidates(rows)` yields each
    candidate's (score (R,), delta (R,), zp (R,)) in the scan's order; a
    candidate replaces the best only with a strictly lower score, so the
    first minimum wins (initial best: score 1e10, `init_delta(rows)`, 0)."""
    deltas, zps = [], []
    step = max(1, ROW_CHUNK_ELEMENTS // max(1, flat.shape[1]))
    for r in range(0, flat.shape[0], step):
        rows = flat[r:r + step]
        best_s = torch.full((rows.shape[0],), 1e10, dtype=torch.float32, device=rows.device)
        best_d = init_delta(rows)
        best_z = torch.zeros_like(best_d)
        for s, d, z in candidates(rows):
            take = s < best_s
            best_s = torch.where(take, s, best_s)
            best_d = torch.where(take, d, best_d)
            best_z = torch.where(take, z, best_z)
        deltas.append(best_d)
        zps.append(best_z)
    return torch.cat(deltas), torch.cat(zps)


def _zeros(rows):
    return torch.zeros(rows.shape[0], dtype=rows.dtype, device=rows.device)


def _mse_rows(flat, level, symmetric, always_zero):
    nb, pb = _bounds(level, symmetric, always_zero)

    def candidates(rows):
        x_min = rows.amin(dim=1, keepdim=True)
        x_max = rows.amax(dim=1, keepdim=True)
        for i in range(80):
            # 1 - i * 0.01 in float32, as the scan computes it from a float32 i
            shrink = float(np.float32(1.0) - np.float32(i) * np.float32(0.01))
            new_min = x_min * shrink
            new_max = x_max * shrink
            if symmetric:
                hi = torch.maximum(torch.abs(new_min), new_max)
                new_min = -hi
                delta = (hi - new_min) / (level - 2)
            else:
                delta = (new_max - new_min) / (level - 1)
            if always_zero:
                delta = new_max / (level - 1)
            if symmetric or always_zero:
                zp = torch.zeros_like(delta)
            else:
                zp = torch.round(-new_min / delta)
            x_q = torch.clamp(torch.round(rows / delta) + zp, nb, pb)
            yield lp_loss(delta * (x_q - zp), rows, p=2.4, dim=1), delta[:, 0], zp[:, 0]
    return _search_rows(flat, candidates, _zeros)


def mse_scale(x: torch.Tensor, level: int, symmetric: bool, always_zero: bool) -> QParams:
    """80-point shrink-grid MSE search, Lp p=2.4: candidate i shrinks
    [x_min, x_max] by (1 - 0.01 i); the first strictly lowest loss wins."""
    d, z = _mse_rows(x.reshape(1, -1), level, symmetric, always_zero)
    return QParams(delta=d[0], zero_point=z[0])


# the compounded range shrink of omse: range0 * prod_{j<=i}(1 - 0.01 j), in
# float64 and then float32, as the JAX package builds its constant
_OMSE_SHRINK = np.cumprod(1.0 - 0.01 * np.arange(80)).astype(np.float32)


def _omse_rows(flat, level):
    def candidates(rows):
        range0 = rows.amax(dim=1, keepdim=True) - rows.amin(dim=1, keepdim=True)
        for i in range(80):
            delta = range0 * float(_OMSE_SHRINK[i]) / (level - 1)
            for zp in range(level):
                x_q = torch.clamp(torch.round(rows / delta) + zp, 0, level - 1)
                z = torch.full_like(delta[:, 0], float(zp))
                yield lp_loss(delta * (x_q - zp), rows, p=2.4, dim=1), delta[:, 0], z
    return _search_rows(flat, candidates, _zeros)


def omse_scale(x: torch.Tensor, level: int, symmetric: bool, always_zero: bool) -> QParams:
    """Compounding range shrink x zero-point sweep (the reference's omse
    always clamps to [0, level - 1], so symmetric / always_zero are unused)."""
    del symmetric, always_zero
    d, z = _omse_rows(x.reshape(1, -1), level)
    return QParams(delta=d[0], zero_point=z[0])


_LOGMINMAX_DELTAS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def _logminmax_rows(flat, level):
    """-> (delta float32, zp float32) per row; the search itself is float16."""
    def candidates(rows):
        x16 = rows.half()
        for dv in _LOGMINMAX_DELTAS:
            d = torch.tensor(dv, dtype=torch.float16, device=rows.device)
            x_q = torch.clamp(torch.round(-torch.log2(x16 / d)), 0, level - 1)
            x_dq = d * 2.0 ** x_q  # the reference's positive exponent, kept
            yield (lp_loss(x16.float(), x_dq.float(), p=2.0, dim=1),
                   d.expand(rows.shape[0]), torch.zeros(rows.shape[0], dtype=torch.float16,
                                                        device=rows.device))
    d, z = _search_rows(flat, candidates, lambda r: r.half().amax(dim=1))
    return d.float(), z.float()


def logminmax_scale(x: torch.Tensor, level: int, symmetric: bool,
                    always_zero: bool) -> QParams:
    """Searches delta in {0.1, ..., 1.0} (float16) for a log2 quantizer;
    the reference reconstructs with `delta * 2**x_q` (positive exponent)
    during the search, reproduced verbatim. Returns zp = 0."""
    del symmetric, always_zero
    d, _ = _logminmax_rows(x.reshape(1, -1), level)
    return QParams(delta=d[0].to(x.dtype),
                   zero_point=torch.zeros((), dtype=x.dtype, device=x.device))


# -------------------------------------------------------------- kl / hist ---
def kl_scale(x: np.ndarray, level: int, symmetric: bool, always_zero: bool) -> QParams:
    """Histogram-KL clip search over 50 clip ratios, on the host in float32
    (sub-float32 input would break np.histogram's edge math, float64 would
    move the edges): returns the minmax params of the clipped tensor."""
    np_x = np.asarray(x, dtype=np.float32)
    ref_hist, ref_bins = np.histogram(np_x, bins=level, density=True)
    sumd = np.sum(np.diff(ref_bins))
    smooth_ref = (ref_hist + 1e-5) / (1.0 + sumd * 1e-5)

    def to_hist_with_orig_bins(targ_hist, targ_bins, orig_hist, orig_bins):
        targ_v = 0.0
        targ_i = 0
        targ_bin = targ_bins[0]
        ret = np.zeros_like(orig_hist)
        for i, orig_bin in enumerate(orig_bins[:-1]):
            if targ_bin <= orig_bin:
                if targ_i < len(targ_bins) - 1:
                    targ_v = targ_hist[targ_i]
                    targ_i += 1
                    targ_bin = targ_bins[targ_i]
                else:
                    targ_v = 0.0
                    targ_bin = orig_bin.max() + 1.0
            ret[i] = targ_v
        return ret

    min_kl = 1e5
    res_ratio = 1.0
    for clip_ratio in np.linspace(0.5, 1.0, 50):
        lo, hi = np.min(np_x) * clip_ratio, np.max(np_x) * clip_ratio
        q_hist, q_bins = np.histogram(np.clip(np_x, lo, hi), bins=level, density=True)
        c_q = to_hist_with_orig_bins(q_hist, q_bins, ref_hist, ref_bins)
        c_q = (c_q + 1e-5) / (1.0 + sumd * 1e-5)
        kl_val = np.sum(smooth_ref * np.log(smooth_ref / c_q))
        if kl_val < min_kl:
            min_kl = kl_val
            res_ratio = clip_ratio
    lo, hi = np.min(np_x) * res_ratio, np.max(np_x) * res_ratio
    x_clip = np.clip(np_x, lo, hi).astype(np.float32)
    return minmax_scale(torch.from_numpy(x_clip), level, symmetric, always_zero)


def hist_scale(x: np.ndarray, level: int, symmetric: bool, always_zero: bool) -> QParams:
    """0.9996-mass histogram clip, on the host in float32 (see kl_scale)."""
    np_x = np.asarray(x, dtype=np.float32)
    data_max = max(-np.min(np_x), np.max(np_x))
    h, _ = np.histogram(np_x, bins=level, range=(0, data_max), density=True)
    h = h.astype(np.float32) / h.sum()
    accum = 0.0
    x_min, x_max = np.min(np_x), np.max(np_x)
    for i in range(len(h)):
        accum += h[i]
        if accum >= 0.9996:
            clip_value = (i + 0.5) * (data_max / level)
            x_min = max(-clip_value, np.min(np_x))
            x_max = min(clip_value, np.max(np_x))
            break
    x_clip = np.clip(np_x, x_min, x_max).astype(np.float32)
    return minmax_scale(torch.from_numpy(x_clip), level, symmetric, always_zero)


# ------------------------------------------------------------- dispatch -----
_DEVICE_SCALERS = {
    Scaler.MINMAX: minmax_scale,
    Scaler.MSE: mse_scale,
    Scaler.OMSE: omse_scale,
    Scaler.LOGMINMAX: logminmax_scale,
}
_HOST_SCALERS = {Scaler.KL: kl_scale, Scaler.HIST: hist_scale}


def _host_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def init_scale(x: torch.Tensor, bits: int, scaler: Scaler = Scaler.MINMAX,
               symmetric: bool = False, always_zero: bool = False) -> QParams:
    """Per-tensor scale initialization (float32), on x's device."""
    level = 2 ** bits
    scaler = Scaler(scaler)
    if scaler in _DEVICE_SCALERS:
        return _DEVICE_SCALERS[scaler](x.float(), level, symmetric, always_zero)
    qp = _HOST_SCALERS[scaler](_host_np(x), level, symmetric, always_zero)
    return QParams(qp.delta.to(x.device), qp.zero_point.to(x.device))


def init_scale_channelwise(x: torch.Tensor, bits: int, scaler: Scaler = Scaler.MINMAX,
                           symmetric: bool = False, always_zero: bool = False) -> QParams:
    """Per-out-channel (leading axis) initialization for weights: one
    independent search per output channel, results shaped to broadcast as
    (O,1,1,1) conv / (O,1) linear."""
    level = 2 ** bits
    scaler = Scaler(scaler)
    n = x.shape[0]
    flat = x.detach().float().reshape(n, -1)
    if scaler == Scaler.MINMAX:
        qp = minmax_scale_rows(flat, level, symmetric, always_zero)
    elif scaler == Scaler.MSE:
        qp = QParams(*_mse_rows(flat, level, symmetric, always_zero))
    elif scaler == Scaler.OMSE:
        qp = QParams(*_omse_rows(flat, level))
    elif scaler == Scaler.LOGMINMAX:
        qp = QParams(*_logminmax_rows(flat, level))
    else:
        host = _HOST_SCALERS[scaler]
        rows = [host(r, level, symmetric, always_zero) for r in _host_np(flat)]
        qp = QParams(torch.stack([r.delta for r in rows]).to(x.device),
                     torch.stack([r.zero_point for r in rows]).to(x.device))
    bshape = (n,) + (1,) * (x.dim() - 1)
    return QParams(qp.delta.reshape(bshape), qp.zero_point.reshape(bshape))
