"""Quality metrics: FID, Inception Score, CLIP score (port of
`dgq_tpu/eval/scores.py`).

FID is the exact Frechet distance between Gaussian feature statistics
(scipy's `sqrtm`), with reference statistics from a `.npz` of `mu` / `sigma`
(the reference's real_im256.npz) or computed from features; the Inception
Score comes from class-probability arrays. Both are numpy on the host, the
JAX package's own lines. The CLIP score runs a transformers `CLIPModel`
from a local snapshot on the device given.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np


def gaussian_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an (N, D) feature matrix."""
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (Heusel et al.). A singular product (few
    images against a 2048-d covariance) is retried with `eps` on the
    diagonals, and the real part of the square root is kept."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_stats_file(features: np.ndarray, stats_npz: str) -> float:
    """FID of generated features against reference stats (real_im256.npz)."""
    z = np.load(stats_npz)
    mu, sigma = gaussian_stats(features)
    return frechet_distance(mu, sigma, z["mu"], z["sigma"])


def inception_score(probs: np.ndarray, splits: int = 10) -> tuple[float, float]:
    """IS (mean, std over splits) from an (N, num_classes) probability matrix."""
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def clip_score(images: Iterable[np.ndarray], prompts: list[str], model_dir: str,
               batch_size: int = 16, w: float = 2.5, device="cuda") -> float:
    """Mean CLIP score w * max(cos(img, text), 0) over pairs, from a local
    transformers CLIPModel + CLIPProcessor snapshot, in float32."""
    import torch
    from transformers import CLIPModel, CLIPProcessor

    from dgq_tpu_torch.eval.common import f32_precision

    model = CLIPModel.from_pretrained(model_dir).eval().to(device)
    proc = CLIPProcessor.from_pretrained(model_dir)
    images = list(images)
    sims = []
    with torch.no_grad(), f32_precision():
        for i in range(0, len(images), batch_size):
            inputs = proc(text=prompts[i : i + batch_size], images=images[i : i + batch_size],
                          return_tensors="pt", padding=True, truncation=True)
            out = model(**{k: v.to(device) for k, v in inputs.items()})
            ie = out.image_embeds / out.image_embeds.norm(dim=-1, keepdim=True)
            te = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
            sims.append((ie * te).sum(-1).clamp(min=0).cpu().numpy())
    return float(w * np.concatenate(sims).mean())


def resize_images_256(images: np.ndarray) -> np.ndarray:
    """512px -> 256px bicubic resize for FID (the reference's change_img_size),
    through Pillow."""
    from PIL import Image

    return np.stack([np.asarray(Image.fromarray(im).resize((256, 256), Image.BICUBIC))
                     for im in images])
