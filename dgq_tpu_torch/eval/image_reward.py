"""ImageReward-v1.0 scorer, functional (port of `dgq_tpu/eval/image_reward.py`).

The reference scores with the ImageReward package (its
src/eval_ImageReward_score.py:25-50). ImageReward-v1.0 is BLIP: a ViT-L/16
vision tower, a 12-layer BERT text encoder with cross-attention to the image
tokens in every layer, and a linear MLP head (768 -> 1024 -> 128 -> 64 -> 16
-> 1, dropout only between the layers) on the [CLS] text feature; the raw
reward is normalized by fixed constants. This module runs the whole scorer
from the published `ImageReward.pt` state dict (keys `blip.visual_encoder.*`
in BLIP/timm ViT naming, `blip.text_encoder.*` in BERT/med.py naming,
`mlp.layers.*`), with no ImageReward or timm package.

Architecture:
  * vision (BLIP vit.py, a timm ViT): patch conv -> [cls | patches] +
    pos_embed -> pre-LN blocks with a fused qkv -> final LayerNorm; eps 1e-6;
    no ln_pre and no projection: the cross-attention reads the full
    (N, 1 + grid^2, 1024) token sequence;
  * text (BLIP med.py: BERT + cross-attention): post-LN BERT layers, each
    self-attention -> cross-attention -> FFN, eps 1e-12; the cross-attention's
    keys and values project from the vision tokens; the self-attention is
    bidirectional with the pad mask added;
  * score(prompt, image): BertTokenizer(prompt, padding='max_length',
    truncation=True, max_length=35); reward = (mlp(text_cls) - MEAN) / STD.

The towers run in float32 on the params' device (`eval.common.strict_f32`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from dgq_tpu_torch.eval.common import strict_f32
from dgq_tpu_torch.eval.open_clip import preprocess_images

# ImageReward/models/ImageReward.py: the fixed reward normalization
IR_MEAN = 0.16717362830052426
IR_STD = 1.0333394966054072


def load_image_reward(path: str, device="cuda") -> Dict:
    """An ImageReward-v1.0 checkpoint -> {'visual', 'text', 'mlp'} dicts of
    tensors on `device` under their in-tower names (the prefix split only)."""
    from dgq_tpu_torch.io.convert import tree_to_torch
    from dgq_tpu_torch.io.dgq_ckpt import load_pth

    sd = load_pth(path)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: np.asarray(v)
          for k, v in sd.items()}
    out = {"visual": {}, "text": {}, "mlp": {}}
    for k, v in sd.items():
        for prefix, tower in (("blip.visual_encoder.", "visual"), ("blip.text_encoder.", "text"),
                              ("mlp.layers.", "mlp")):
            if k.startswith(prefix):
                out[tower][k[len(prefix):]] = v
    return tree_to_torch(out, device)


def _ln(p, prefix, x, eps):
    return F.layer_norm(x.float(), x.shape[-1:], p[f"{prefix}.weight"], p[f"{prefix}.bias"],
                        eps).to(x.dtype)


def _linear(p, prefix, x):
    return F.linear(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"])


def _heads_split(z, heads):
    b, t, w = z.shape
    return z.reshape(b, t, heads, w // heads).transpose(1, 2)


def _attn_core(q, k, v, mask=None):
    scores = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        scores = scores + mask
    out = torch.softmax(scores.float(), dim=-1).to(v.dtype) @ v
    b, h, t, d = out.shape
    return out.transpose(1, 2).reshape(b, t, h * d)


@strict_f32
def encode_vision(p: Dict, images: torch.Tensor, heads: int = 16) -> torch.Tensor:
    """Preprocessed (N, S, S, 3) -> (N, 1 + grid^2, width) BLIP image tokens
    (timm ViT-L/16 for the published checkpoint; sizes read from weights)."""
    w_conv = p["patch_embed.proj.weight"]  # (width, 3, P, P)
    width, _, ps, _ = w_conv.shape
    x = F.conv2d(images.permute(0, 3, 1, 2), w_conv, p["patch_embed.proj.bias"], stride=ps)
    n = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    cls = p["cls_token"].reshape(1, 1, -1).expand(n, 1, width).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"][0]
    depth = 1 + max(int(k.split(".")[1]) for k in p if k.startswith("blocks."))
    for i in range(depth):
        pre = f"blocks.{i}"
        qkv = _linear(p, f"{pre}.attn.qkv", _ln(p, f"{pre}.norm1", x, 1e-6))
        q, k, v = (_heads_split(z, heads) for z in qkv.chunk(3, dim=-1))
        x = x + _linear(p, f"{pre}.attn.proj", _attn_core(q, k, v))
        h = F.gelu(_linear(p, f"{pre}.mlp.fc1", _ln(p, f"{pre}.norm2", x, 1e-6)))
        x = x + _linear(p, f"{pre}.mlp.fc2", h)
    return _ln(p, "norm", x, 1e-6)


def _bert_attention(p, prefix, x, kv, heads, mask):
    """One med.py attention sub-block (self when kv is x, cross otherwise):
    q / k / v projections -> scaled dot product -> output.dense -> post-LN."""
    q = _linear(p, f"{prefix}.self.query", x)
    k = _linear(p, f"{prefix}.self.key", kv)
    v = _linear(p, f"{prefix}.self.value", kv)
    o = _attn_core(_heads_split(q, heads), _heads_split(k, heads), _heads_split(v, heads), mask)
    return _ln(p, f"{prefix}.output.LayerNorm", x + _linear(p, f"{prefix}.output.dense", o),
               1e-12)


@strict_f32
def encode_text_cross(p: Dict, token_ids: torch.Tensor, attn_mask: torch.Tensor,
                      enc_states: torch.Tensor, heads: int = 12) -> torch.Tensor:
    """(N, L) ids + (N, L) 0/1 pad mask + (N, S, Wv) image tokens ->
    (N, L, W) hidden states of BERT with cross-attention (med.py)."""
    dev = p["embeddings.word_embeddings.weight"].device
    token_ids, attn_mask = token_ids.to(dev), attn_mask.to(dev)
    x = p["embeddings.word_embeddings.weight"][token_ids]
    x = x + p["embeddings.position_embeddings.weight"][: x.shape[1]]
    x = _ln(p, "embeddings.LayerNorm", x, 1e-12)
    # additive pad mask over key positions (the transformers extended mask)
    mask = (1.0 - attn_mask.float())[:, None, None, :] * torch.finfo(torch.float32).min
    depth = 1 + max(int(k.split(".")[2]) for k in p if k.startswith("encoder.layer."))
    for i in range(depth):
        pre = f"encoder.layer.{i}"
        x = _bert_attention(p, f"{pre}.attention", x, x, heads, mask)
        x = _bert_attention(p, f"{pre}.crossattention", x, enc_states, heads, mask=None)
        h = F.gelu(_linear(p, f"{pre}.intermediate.dense", x))
        x = _ln(p, f"{pre}.output.LayerNorm", x + _linear(p, f"{pre}.output.dense", h), 1e-12)
    return x


@strict_f32
def reward_head(p: Dict, feats: torch.Tensor) -> torch.Tensor:
    """(N, W) [CLS] features -> (N,) normalized rewards. The published head
    interleaves Dropouts (inactive at eval), so its Linears sit at
    non-contiguous Sequential indices: they apply in index order."""
    x = feats.float()
    for i in sorted({int(k.split(".")[0]) for k in p}):
        x = _linear(p, str(i), x)
    return (x[:, 0] - IR_MEAN) / IR_STD


def tokenize_ir(prompts: list[str], tokenizer_dir: str,
                max_length: int = 35) -> tuple[np.ndarray, np.ndarray]:
    """ImageReward's tokenization (models/ImageReward.py score()):
    BertTokenizer, padding='max_length', truncation=True, max_length=35.
    Returns (input_ids, attention_mask)."""
    from transformers import BertTokenizer

    tok = BertTokenizer.from_pretrained(tokenizer_dir)
    enc = tok(prompts, padding="max_length", truncation=True, max_length=max_length,
              return_tensors="np")
    return enc["input_ids"], enc["attention_mask"]


def image_reward_scores(params: Dict, images: torch.Tensor, token_ids: torch.Tensor,
                        attn_mask: torch.Tensor, vision_heads: int = 16,
                        text_heads: int = 12) -> torch.Tensor:
    """Preprocessed images + tokens -> (N,) rewards. The default head counts
    are ViT-L/16 + BERT-base (the published v1.0)."""
    img_tokens = encode_vision(params["visual"], images, heads=vision_heads)
    txt = encode_text_cross(params["text"], token_ids, attn_mask, img_tokens, heads=text_heads)
    return reward_head(params["mlp"], txt[:, 0, :])


def image_reward_score_native(images, prompts: list[str], ckpt_path: str, tokenizer_dir: str,
                              batch_size: int = 8, vision_heads: int = 16, text_heads: int = 12,
                              image_size: int | None = None, device="cuda") -> float:
    """The reference protocol (eval_ImageReward_score.py:44-50): the mean
    normalized reward over (prompt, image) pairs. image_size defaults to the
    pos_embed grid x patch size of the checkpoint (224 for v1.0)."""
    params = load_image_reward(ckpt_path, device)
    if image_size is None:
        n_tok = params["visual"]["pos_embed"].shape[1]
        patch = params["visual"]["patch_embed.proj.weight"].shape[-1]
        image_size = int(round((n_tok - 1) ** 0.5)) * patch
    images = list(images)
    ids, mask = (torch.from_numpy(np.asarray(a)) for a in tokenize_ir(prompts, tokenizer_dir))
    out = []
    for i in range(0, len(images), batch_size):
        imgs = preprocess_images(np.stack(images[i:i + batch_size]), image_size, device)
        out.append(image_reward_scores(params, imgs, ids[i:i + batch_size],
                                       mask[i:i + batch_size], vision_heads,
                                       text_heads).cpu().numpy())
    return float(np.concatenate(out).mean())
