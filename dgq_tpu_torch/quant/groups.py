"""Distribution-aware group quantization, the "G" of DGQ (port of
`dgq_tpu/quant/groups.py`).

  * per-axis min/max statistics are recorded over calibration batches for two
    candidate axes ("in-channel" = last axis, "out-channel" =
    second-to-last); convs take them on the im2col-unfolded input;
  * a spread heuristic picks the axis;
  * the channels are k-means clustered (k = group number) on their (min, max)
    pairs, and each cluster gets one affine scale, expanded back per channel.

The JAX package clusters with `sklearn.cluster.KMeans(n_clusters=g,
random_state=0)`, so that its group assignments match the reference's
checkpoints. The port does not depend on scikit-learn: `kmeans` below is a
numpy re-implementation of scikit-learn 1.9's dense k-means (one k-means++
seeding from `np.random.RandomState(0)`, then Lloyd iterations) that gives
the same partition. Its one subtle point is k-means++'s squared distances:
scikit-learn computes them for float32 data in float64 and casts the result
back to float32, and float32 distances pick other seeds for some inputs.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from dgq_tpu_torch.quant.affine import QParams


class GroupStats(NamedTuple):
    """Running per-axis min/max over calibration batches: in_min/in_max per
    last axis (C_last,), out_min/out_max per second-to-last axis (C_mid,)."""

    in_min: torch.Tensor
    in_max: torch.Tensor
    out_min: torch.Tensor
    out_max: torch.Tensor


def init_group_stats(x_shape, dtype=torch.float32, device="cuda") -> GroupStats:
    c_last, c_mid = x_shape[-1], x_shape[-2]

    def full(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)
    return GroupStats(full(c_last, float("inf")), full(c_last, float("-inf")),
                      full(c_mid, float("inf")), full(c_mid, float("-inf")))


def update_group_stats(stats: GroupStats, x: torch.Tensor) -> GroupStats:
    """Fold one batch into the running stats: reduce every axis except the
    candidate axis (any rank >= 3)."""
    nd = x.dim()
    in_axes = tuple(i for i in range(nd) if i != nd - 1)
    out_axes = tuple(i for i in range(nd) if i != nd - 2)
    return GroupStats(
        torch.minimum(stats.in_min, x.amin(dim=in_axes)),
        torch.maximum(stats.in_max, x.amax(dim=in_axes)),
        torch.minimum(stats.out_min, x.amin(dim=out_axes)),
        torch.maximum(stats.out_max, x.amax(dim=out_axes)),
    )


# ------------------------------------------------------------- k-means ------
def _sq_dist_upcast(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared euclidean distances (len(a), len(b)) of float32 points,
    computed in float64 and cast back to float32, clamped at 0, as
    scikit-learn's `_euclidean_distances` does for float32 data."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", b64, b64)[None, :]
    d = d.astype(np.float32)
    np.maximum(d, 0, out=d)
    return d


def _kmeans_plusplus(x: np.ndarray, k: int, rng: np.random.RandomState) -> np.ndarray:
    """Greedy k-means++ seeding with 2 + int(log k) local trials a center."""
    n = x.shape[0]
    w = np.ones(n, dtype=x.dtype)
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    trials = 2 + int(np.log(k))
    first = rng.choice(n, p=w / w.sum())
    centers[0] = x[first]
    closest = _sq_dist_upcast(x[first][None, :], x)
    pot = closest @ w
    for c in range(1, k):
        rand = rng.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(w * closest), rand)
        np.clip(ids, None, closest.size - 1, out=ids)
        dist = _sq_dist_upcast(x[ids], x)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = dist[best]
        centers[c] = x[ids[best]]
    return centers


def _labels(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest center by ||c||^2 - 2 x.c (float32), first minimum on ties."""
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2 * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(x, centers, labels_out):
    """One E-step and M-step: the labels, then each center the float32 mean
    of its points (summed in sample order, scaled by float32(1 / count)); an
    empty cluster is moved to the point farthest from its own center."""
    k = centers.shape[0]
    labels = _labels(x, centers)
    labels_out[:] = labels
    # float32, one point after another from zero: `add.at` is unbuffered and
    # adds in index order, so each center's sum is its points' in sample order
    # (one feature at a time: numpy's fast path takes 1-D operands)
    new_t = np.zeros((x.shape[1], k), dtype=x.dtype)
    for f in range(x.shape[1]):
        np.add.at(new_t[f], labels, x[:, f])
    new = np.ascontiguousarray(new_t.T)
    weight = np.bincount(labels, minlength=k).astype(x.dtype)
    empty = np.where(weight == 0)[0]
    if len(empty):
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if np.max(dist) != 0:
            for new_id, far_id in zip(empty, far):
                old_id = labels[far_id]
                new[old_id] -= x[far_id]
                new[new_id] = x[far_id]
                weight[new_id] = 1
                weight[old_id] -= 1
    biggest = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            new[j] *= np.float32(1.0 / float(weight[j]))
        else:
            new[j] = new[biggest]
    diff = new - centers
    return new, np.sqrt((diff * diff).sum(axis=1))


def kmeans(data: np.ndarray, k: int, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
    """-> (labels, centers) of `KMeans(n_clusters=k, random_state=seed)`
    on float32 data (the data are centered on their mean first, the
    tolerance is tol times the mean per-feature variance)."""
    x = np.array(data, dtype=np.float32, order="C")
    if x.shape[0] < k:
        raise ValueError(f"n_samples={x.shape[0]} should be >= n_clusters={k}.")
    tol = np.mean(np.var(x, axis=0)) * tol
    mean = x.mean(axis=0)
    x -= mean
    rng = np.random.RandomState(seed)
    centers = _kmeans_plusplus(x, k, rng)
    labels = np.full(x.shape[0], -1, dtype=np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(max_iter):
        centers, shift = _lloyd_step(x, centers, labels)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        labels = _labels(x, centers)
    return labels, centers + mean


def kmeans_group_qparams(stats: GroupStats, group_num: int, level: int, mode: str = "minmax",
                         in_channel_wise=None) -> tuple[QParams, np.ndarray, bool]:
    """Cluster the channels and derive per-channel-expanded group qparams.

    Returns (qparams, labels, in_channel_wise): delta / zero_point of shape
    (1, 1, C) when the last axis was grouped, (1, C, 1) for the middle axis,
    as float32 CPU tensors."""
    in_min, in_max, out_min, out_max = (
        np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v).ravel()
        for v in stats)

    if in_channel_wise is None:
        in_spread = in_max.max() - in_max.min() + in_min.max() - in_min.min()
        out_spread = out_max.max() - out_max.min() + out_min.max() - out_min.min()
        in_channel_wise = bool(in_spread > out_spread) or bool(
            os.environ.get("IN_CHANNEL_WISE", False))

    if in_channel_wise:
        channel_data = np.column_stack((in_min, in_max))
    else:
        channel_data = np.column_stack((out_min, out_max))

    labels, km_centers = kmeans(channel_data, group_num, seed=0)

    if mode == "mean":
        centers = km_centers
    elif mode == "minmax":
        centers = []
        for i in range(group_num):
            cluster = channel_data[labels == i]
            if cluster.size:
                # the min and max over both coordinates of the cluster
                centers.append([cluster.min(), cluster.max()])
            else:
                centers.append([0.0, 1.0])
        centers = np.asarray(centers)
    else:
        raise NotImplementedError(mode)

    n = channel_data.shape[0]
    delta = np.empty((n,), np.float32)
    zp = np.empty((n,), np.float32)
    for i in range(group_num):
        d = (centers[i, 1] - centers[i, 0]) / (level - 1)
        d = max(float(d), 1e-8)
        delta[labels == i] = d
        zp[labels == i] = np.round(-centers[i, 0] / d)

    shape = (1, 1, n) if in_channel_wise else (1, n, 1)
    qp = QParams(torch.from_numpy(delta.reshape(shape)), torch.from_numpy(zp.reshape(shape)))
    return qp, labels, in_channel_wise
