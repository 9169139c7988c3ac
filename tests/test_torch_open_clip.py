"""The port's open_clip scorer (`eval/open_clip.py`) against the JAX package
and against a torch replica of open_clip's architecture (nn.MultiheadAttention
with its fused in_proj, pre-LN blocks, class-token / EOT-argmax pooling),
saved under open_clip's state-dict names as tests/test_open_clip.py builds
it, so a real ViT-g-14 checkpoint loads the same way. No weights are
downloaded. The port runs on device="cpu".

Tolerances: the towers 2e-5 (tests/test_open_clip.py), the preprocessing
1e-5 (the resize, tests/test_torch_scores.py), the protocol's mean cosine
and the CLI's score 1e-4.
"""
from collections import OrderedDict
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.eval import open_clip as JO  # noqa: E402
from dgq_tpu_torch.eval import open_clip as TO  # noqa: E402

nn = torch.nn
# the head count follows the width (text width // 64, vision by open_clip's
# table), so the tiny towers keep it
W, HEADS, DEPTH, OUT = 128, 2, 2, 32
PATCH, IMG = 8, 32
VOCAB, CTX = 50, 12


class Block(nn.Module):
    def __init__(self, w, heads):
        super().__init__()
        self.ln_1 = nn.LayerNorm(w)
        self.attn = nn.MultiheadAttention(w, heads)
        self.ln_2 = nn.LayerNorm(w)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", nn.Linear(w, 4 * w)), ("gelu", nn.GELU()),
                                              ("c_proj", nn.Linear(4 * w, w))]))

    def forward(self, x, mask=None):  # (T, N, W), sequence first as open_clip
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, need_weights=False, attn_mask=mask)[0]
        return x + self.mlp(self.ln_2(x))


class Tower(nn.Module):
    def __init__(self, w, heads, depth):
        super().__init__()
        self.resblocks = nn.ModuleList([Block(w, heads) for _ in range(depth)])

    def forward(self, x, mask=None):
        for b in self.resblocks:
            x = b(x, mask)
        return x


class Visual(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, W, PATCH, PATCH, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(W) * 0.02)
        self.positional_embedding = nn.Parameter(torch.randn((IMG // PATCH) ** 2 + 1, W) * 0.02)
        self.ln_pre = nn.LayerNorm(W)
        self.transformer = Tower(W, HEADS, DEPTH)
        self.ln_post = nn.LayerNorm(W)
        self.proj = nn.Parameter(torch.randn(W, OUT) * 0.05)

    def forward(self, x):  # (N, 3, H, W)
        x = self.conv1(x).flatten(2).permute(0, 2, 1)
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding).permute(1, 0, 2)
        x = self.transformer(x).permute(1, 0, 2)
        e = self.ln_post(x[:, 0]) @ self.proj
        return e / e.norm(dim=-1, keepdim=True)


class RefCLIP(nn.Module):
    def __init__(self):
        super().__init__()
        self.visual = Visual()
        self.token_embedding = nn.Embedding(VOCAB, W)
        self.positional_embedding = nn.Parameter(torch.randn(CTX, W) * 0.02)
        self.transformer = Tower(W, HEADS, DEPTH)
        self.ln_final = nn.LayerNorm(W)
        self.text_projection = nn.Parameter(torch.randn(W, OUT) * 0.05)

    def encode_text(self, ids):
        x = self.token_embedding(ids) + self.positional_embedding
        mask = torch.triu(torch.full((CTX, CTX), float("-inf")), diagonal=1)
        x = self.ln_final(self.transformer(x.permute(1, 0, 2), mask).permute(1, 0, 2))
        e = x[torch.arange(x.shape[0]), ids.argmax(dim=-1)] @ self.text_projection
        return e / e.norm(dim=-1, keepdim=True)


@pytest.fixture(scope="module")
def model_and_ckpt(tmp_path_factory):
    torch.manual_seed(0)
    m = RefCLIP().eval()
    path = str(tmp_path_factory.mktemp("oc") / "open_clip_pytorch_model.bin")
    torch.save(m.state_dict(), path)
    return m, path


def _ids(n, seed):
    """EOT (the largest id) at varying positions, zero-padded after it."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((n, CTX), np.int64)
    for i in range(n):
        k = rng.randint(3, CTX)
        ids[i, :k] = rng.randint(1, VOCAB - 1, k)
        ids[i, k - 1] = VOCAB - 1
    return ids


def test_load_open_clip_matches_jax(model_and_ckpt):
    _, path = model_and_ckpt
    tp, jp = TO.load_open_clip(path, device="cpu"), JO.load_open_clip(path)
    for tower in ("visual", "text"):
        assert set(tp[tower]) == set(jp[tower])
        for k, v in jp[tower].items():
            assert np.array_equal(tp[tower][k].numpy(), v), k


def test_encode_image_matches_jax_and_torch(model_and_ckpt):
    m, path = model_and_ckpt
    imgs = (np.random.RandomState(0).randn(3, IMG, IMG, 3) * 0.5).astype(np.float32)
    ours = TO.encode_image(TO.load_open_clip(path, "cpu"), torch.from_numpy(imgs)).numpy()
    with torch.no_grad():
        ref = m.visual(torch.from_numpy(np.transpose(imgs, (0, 3, 1, 2)))).numpy()
    jax_out = np.asarray(JO.encode_image(JO.load_open_clip(path), jnp.asarray(imgs)))
    assert np.abs(ours - ref).max() <= 2e-5, np.abs(ours - ref).max()
    assert np.abs(ours - jax_out).max() <= 2e-5, np.abs(ours - jax_out).max()


def test_encode_text_matches_jax_and_torch(model_and_ckpt):
    m, path = model_and_ckpt
    ids = _ids(4, 1)
    ours = TO.encode_text(TO.load_open_clip(path, "cpu"), torch.from_numpy(ids)).numpy()
    with torch.no_grad():
        ref = m.encode_text(torch.from_numpy(ids)).numpy()
    jax_out = np.asarray(JO.encode_text(JO.load_open_clip(path), jnp.asarray(ids)))
    assert np.abs(ours - ref).max() <= 2e-5, np.abs(ours - ref).max()
    assert np.abs(ours - jax_out).max() <= 2e-5, np.abs(ours - jax_out).max()


@pytest.mark.parametrize("shape,size", [((1, 448, 672, 3), 224), ((2, 48, 40, 3), 32),
                                        ((1, 20, 30, 3), 32)])
def test_preprocess_matches_jax(shape, size):
    """Shorter side to `size` (down and up), the clamp, the center crop and
    OpenAI's normalization."""
    img = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    out = TO.preprocess_images(img, size).numpy()
    ref = np.asarray(JO.preprocess_images(img, size))
    assert out.shape == ref.shape == (shape[0], size, size, 3)
    assert np.abs(out - ref).max() <= 1e-5 / 0.26130258, np.abs(out - ref).max()


def test_score_protocol_matches_jax(model_and_ckpt):
    """clip_score_openclip: the mean raw cosine, the input size read from the
    checkpoint, batched; tokenization handed in (no vocabulary here)."""
    _, path = model_and_ckpt
    rng = np.random.RandomState(2)
    images = [rng.randint(0, 255, (IMG + 8, IMG, 3)).astype(np.uint8) for _ in range(3)]
    ids = _ids(3, 3)
    fake = lambda p, d, context=77: ids  # noqa: E731
    with mock.patch.object(TO, "tokenize", fake), mock.patch.object(JO, "tokenize", fake):
        ours = TO.clip_score_openclip(images, ["a", "b", "c"], path, "unused", batch_size=2,
                                      device="cpu")
        ref = JO.clip_score_openclip(images, ["a", "b", "c"], path, "unused", batch_size=2)
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-4, (ours, ref)


def test_tokenize_matches_jax(tmp_path):
    """open_clip.tokenize() semantics from a local BPE vocabulary: zero pad,
    truncation with the last token forced to EOT."""
    pytest.importorskip("transformers")
    import json

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "!": 2}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    prompts = ["a cat", "the quick brown fox jumps over the lazy dog " * 3]
    ours = TO.tokenize(prompts, str(tmp_path), context=16)
    assert np.array_equal(ours, JO.tokenize(prompts, str(tmp_path), context=16))
    assert ours[1, -1] == 1 and ours[0, -1] == 0
