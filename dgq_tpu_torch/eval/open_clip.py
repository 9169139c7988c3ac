"""open_clip-format CLIP scorer, the reference's evaluation protocol (port of
`dgq_tpu/eval/open_clip.py`).

The reference pins open_clip ViT-g-14 / laion2b_s34b_b88k and reports the
mean raw text-image cosine over the first N images (its
src/eval_clip_score.py:26-70). This module loads an open_clip checkpoint
(the `state_dict` of open_clip.create_model, e.g.
open_clip_pytorch_model.bin) into a functional reimplementation of the
open_clip VisionTransformer and text tower, with no open_clip package.
Every width, depth, head count, patch size and embedding size is read from
the checkpoint's shapes, so any open_clip ViT (B/16, L/14, g-14, ...) loads.

Architecture (open_clip/transformer.py):
  * pre-LN residual blocks: x += attn(ln_1(x)); x += mlp(ln_2(x));
  * torch.nn.MultiheadAttention's layout: one fused in_proj (3W, W);
  * an exact-GELU MLP (laion-trained ViTs; OpenAI-trained ones take
    QuickGELU: quick_gelu=True);
  * vision pooling: class token -> ln_post -> @ proj;
  * text pooling: the position of the highest token id (EOT) -> ln_final ->
    @ text_projection, under a causal mask.

The towers run in float32 on the params' device (`eval.common.strict_f32`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from dgq_tpu_torch.eval.common import resize, strict_f32

OPENAI_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_open_clip(path: str, device="cuda") -> Dict:
    """An open_clip checkpoint file -> {'visual': ..., 'text': ...} of tensors
    on `device` under open_clip's names (the prefix split, no renaming)."""
    from dgq_tpu_torch.io.convert import tree_to_torch
    from dgq_tpu_torch.io.dgq_ckpt import load_pth

    sd = load_pth(path)
    if "state_dict" in sd:  # training checkpoints wrap it
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: np.asarray(v)
          for k, v in sd.items()}
    vis = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    txt = {k: v for k, v in sd.items() if not k.startswith("visual.")}
    return tree_to_torch({"visual": vis, "text": txt}, device)


def _ln(p, prefix, x, eps=1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], p[f"{prefix}.weight"], p[f"{prefix}.bias"],
                        eps)


def _mha(p, prefix, x, heads: int, causal: bool):
    """torch.nn.MultiheadAttention with its fused in_proj, on (B, T, W)."""
    b, t, w = x.shape
    qkv = F.linear(x, p[f"{prefix}.in_proj_weight"], p[f"{prefix}.in_proj_bias"])
    q, k, v = (z.reshape(b, t, heads, w // heads).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
    scores = (q @ k.transpose(-1, -2)) * ((w // heads) ** -0.5)
    if causal:
        scores = scores + torch.triu(torch.full((t, t), float("-inf"), device=x.device), 1)
    out = (torch.softmax(scores.float(), dim=-1).to(x.dtype) @ v).transpose(1, 2).reshape(b, t, w)
    return F.linear(out, p[f"{prefix}.out_proj.weight"], p[f"{prefix}.out_proj.bias"])


def _block(p, i, x, heads, causal, quick_gelu):
    pre = f"transformer.resblocks.{i}"
    x = x + _mha(p, f"{pre}.attn", _ln(p, f"{pre}.ln_1", x).to(x.dtype), heads, causal)
    h = F.linear(_ln(p, f"{pre}.ln_2", x).to(x.dtype), p[f"{pre}.mlp.c_fc.weight"],
                 p[f"{pre}.mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h) if quick_gelu else F.gelu(h)
    return x + F.linear(h, p[f"{pre}.mlp.c_proj.weight"], p[f"{pre}.mlp.c_proj.bias"])


def _depth(p) -> int:
    return 1 + max(int(k.split(".")[2]) for k in p if k.startswith("transformer.resblocks."))


# open_clip vision towers do not keep head_dim 64: ViT-H/g/bigG use 16 heads
# at widths 1280/1408/1664. Known vision widths -> heads; text towers always
# use width // 64.
_VISION_HEADS = {768: 12, 896: 14, 1024: 16, 1152: 16, 1280: 16, 1408: 16, 1664: 16}


def _n_heads(width: int, vision: bool = False) -> int:
    if vision and width in _VISION_HEADS:
        return _VISION_HEADS[width]
    return width // 64


@strict_f32
def preprocess_images(images, size: int = 224, device=None) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> normalized (N, size, size, 3) f32: shorter side
    to `size` by JAX's antialiased bicubic resize, clamped to [0, 1] (the
    torchvision transform resizes a uint8 PIL image), center crop, OpenAI
    normalization."""
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                        device=device).float() / 255.0
    n, h, w, _ = x.shape
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = torch.clamp(resize(x, nh, nw, "bicubic", antialias=True), 0.0, 1.0)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size, :]
    mean = torch.from_numpy(OPENAI_MEAN).to(x.device)
    std = torch.from_numpy(OPENAI_STD).to(x.device)
    return (x - mean) / std


@strict_f32
def encode_image(params: Dict, images: torch.Tensor, quick_gelu: bool = False) -> torch.Tensor:
    """Preprocessed (N, S, S, 3) -> L2-normalized (N, D) embeddings."""
    p = params["visual"]
    w_conv = p["conv1.weight"]  # (width, 3, P, P)
    width, _, ps, _ = w_conv.shape
    x = F.conv2d(images.permute(0, 3, 1, 2), w_conv, stride=ps)
    n = x.shape[0]
    x = x.flatten(2).transpose(1, 2)  # (N, grid^2, width), row-major over the grid
    cls = p["class_embedding"].reshape(1, 1, -1).expand(n, 1, width).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p["positional_embedding"]
    x = _ln(p, "ln_pre", x).to(x.dtype)
    heads = _n_heads(width, vision=True)
    for i in range(_depth(p)):
        x = _block(p, i, x, heads, causal=False, quick_gelu=quick_gelu)
    emb = _ln(p, "ln_post", x[:, 0]) @ p["proj"]
    return emb / emb.norm(dim=-1, keepdim=True)


@strict_f32
def encode_text(params: Dict, token_ids: torch.Tensor, quick_gelu: bool = False) -> torch.Tensor:
    """(N, 77) int token ids (zero-padded after EOT) -> L2-normalized (N, D)."""
    p = params["text"]
    token_ids = token_ids.to(p["token_embedding.weight"].device)
    x = p["token_embedding.weight"][token_ids] + p["positional_embedding"]
    heads = _n_heads(x.shape[-1])
    for i in range(_depth(p)):
        x = _block(p, i, x, heads, causal=True, quick_gelu=quick_gelu)
    x = _ln(p, "ln_final", x)
    eot = token_ids.argmax(dim=-1)  # EOT has the highest token id
    emb = x[torch.arange(x.shape[0], device=x.device), eot] @ p["text_projection"]
    return emb / emb.norm(dim=-1, keepdim=True)


def tokenize(prompts: list[str], tokenizer_dir: str, context: int = 77) -> np.ndarray:
    """open_clip.tokenize() semantics through a local transformers
    CLIPTokenizer (the same BPE vocabulary): [SOT] + bpe + [EOT], zero-padded
    to `context`; on overflow truncated, the last token forced to EOT."""
    from transformers import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(tokenizer_dir)
    out = np.zeros((len(prompts), context), np.int64)
    eot = tok.eos_token_id
    for i, t in enumerate(prompts):
        ids = tok(t)["input_ids"]  # already [SOT] ... [EOT]
        if len(ids) > context:
            ids = ids[:context]
            ids[-1] = eot
        out[i, : len(ids)] = ids
    return out


def clip_score_openclip(images, prompts: list[str], ckpt_path: str, tokenizer_dir: str,
                        batch_size: int = 8, quick_gelu: bool = False, device="cuda") -> float:
    """The reference's protocol (eval_clip_score.py:44-66): the mean raw
    text-image cosine, no weighting, no clamping. The input resolution comes
    from the checkpoint (grid x patch: 224 for ViT-g-14)."""
    params = load_open_clip(ckpt_path, device)
    patch = params["visual"]["conv1.weight"].shape[-1]
    grid = int(round((params["visual"]["positional_embedding"].shape[0] - 1) ** 0.5))
    images = list(images)
    toks = torch.from_numpy(tokenize(prompts, tokenizer_dir))
    sims = []
    for i in range(0, len(images), batch_size):
        imgs = preprocess_images(np.stack(images[i:i + batch_size]), grid * patch, device)
        ie = encode_image(params, imgs, quick_gelu)
        te = encode_text(params, toks[i:i + batch_size].to(device), quick_gelu)
        sims.append((ie * te).sum(-1).cpu().numpy())
    return float(np.concatenate(sims).mean())
