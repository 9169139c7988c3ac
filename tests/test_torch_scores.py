"""The port's scores (`eval/scores.py`), its image resize (`eval/common.py`)
and its InceptionV3 extractor (`eval/inception.py`, the bridge in
`io/convert.py`) against the JAX package on the same numpy inputs and
weights. The port runs on device="cpu".

Tolerances:
  * FID, IS and the Gaussian stats: the same numpy lines on both sides, held
    at 1e-4 relative (tests/test_eval_and_utils.py's scale).
  * the resize: 1e-5 absolute on [0, 1] images (JAX's f32 product on the CPU
    is the less accurate side: 7e-6 from float64 at 64 -> 299).
  * BN folding and the bridge: bit for bit; the folded conv against torch's
    conv + BatchNorm 1e-5, the count_include_pad=False pool 1e-6, as
    tests/test_inception_fid.py.
  * the whole extractor (94 convs): 1e-5 of the largest feature.
  * the transformers CLIP score: 1e-4 (both packages run the same torch model).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from dgq_tpu.eval import inception as JI, scores as JS  # noqa: E402
from dgq_tpu_torch.eval import inception as TI, scores as TS  # noqa: E402
from dgq_tpu_torch.eval.common import resize  # noqa: E402
from dgq_tpu_torch.io.convert import (  # noqa: E402
    inception_params_from_numpy, inception_params_to_numpy)


def _close(a, b, rel=1e-4):
    assert np.isfinite(a) and abs(a - b) <= rel * max(abs(b), 1.0), (a, b)


@pytest.mark.parametrize("n,d,shift", [(500, 16, 0.0), (500, 8, 1.0), (500, 8, 3.0),
                                       (6, 32, 0.5)])
def test_fid_matches_jax(n, d, shift):
    """Gaussian stats bit for bit, the distance within 1e-4 (n=6 < d: the
    singular covariance of a handful of images)."""
    rng = np.random.RandomState(n + d)
    f1, f2 = rng.randn(n, d), rng.randn(n, d) + shift
    (tm, ts), (jm, js) = TS.gaussian_stats(f1), JS.gaussian_stats(f1)
    assert np.array_equal(tm, jm) and np.array_equal(ts, js)
    m2, s2 = TS.gaussian_stats(f2)
    _close(TS.frechet_distance(tm, ts, m2, s2), JS.frechet_distance(jm, js, m2, s2))
    assert abs(TS.frechet_distance(tm, ts, tm, ts)) < 1e-6 or n < d


def test_fid_from_stats_file(tmp_path):
    rng = np.random.RandomState(1)
    ref = rng.randn(300, 8)
    path = str(tmp_path / "real.npz")
    np.savez(path, mu=ref.mean(0), sigma=np.cov(ref, rowvar=False))
    feats = rng.randn(300, 8) + 0.5
    _close(TS.fid_from_stats_file(feats, path), JS.fid_from_stats_file(feats, path))


@pytest.mark.parametrize("kind", ["confident", "uniform", "peaked"])
def test_inception_score_matches_jax(kind):
    rng = np.random.RandomState(2)
    n, c = 1000, 10
    if kind == "confident":
        p = np.full((n, c), 1e-6)
        p[np.arange(n), rng.randint(0, c, n)] = 1.0
        p /= p.sum(1, keepdims=True)
    elif kind == "uniform":
        p = np.full((n, c), 1.0 / c)
    else:
        p = np.eye(c)[rng.randint(0, c, n)] * 0.9 + 0.01
    for splits in (10, 2):
        t, j = TS.inception_score(p, splits), JS.inception_score(p, splits)
        _close(t[0], j[0])
        _close(t[1], j[1])


def test_resize_images_256_matches_jax():
    pytest.importorskip("PIL")
    imgs = np.random.RandomState(3).randint(0, 256, (2, 512, 512, 3), np.uint8)
    out = TS.resize_images_256(imgs)
    assert out.shape == (2, 256, 256, 3)
    assert np.array_equal(out, JS.resize_images_256(imgs))


@pytest.mark.parametrize("shape,hw,method,aa", [
    ((2, 64, 48, 3), (299, 299), "bilinear", False),
    ((2, 512, 512, 3), (299, 299), "bilinear", False),
    ((2, 448, 672, 3), (224, 336), "bicubic", True),
    ((1, 37, 37, 3), (224, 224), "bicubic", True),
    ((1, 32, 40, 3), (24, 30), "bicubic", True),
    ((1, 40, 32, 3), (40, 24), "bicubic", True),
])
def test_resize_matches_jax(shape, hw, method, aa):
    """JAX's scale_and_translate weights and products: bilinear without
    antialias (Inception), Keys' bicubic with it (open_clip, ImageReward),
    up and down, one axis left alone."""
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0],) + hw + (3,), method,
                                      antialias=aa))
    out = resize(torch.from_numpy(x), *hw, method, aa).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5, np.abs(out - ref).max()


def test_spec_structure():
    spec = TI.inception_spec()
    assert spec == JI.inception_spec() and len(spec) == 94
    assert sum(ci * co * k[0] * k[1] for _, ci, co, k, _, _ in spec) == 21_751_136


def _pt_state(seed, fc=True):
    """A random state dict under pytorch-fid's names, BN non-trivial."""
    rs = np.random.RandomState(seed)
    state = {}
    for name, ci, co, k, _, _ in TI.inception_spec():
        state[f"{name}.conv.weight"] = (rs.randn(co, ci, *k) * np.sqrt(2.0 / (ci * k[0] * k[1]))
                                        ).astype(np.float32)
        state[f"{name}.bn.weight"] = rs.uniform(0.5, 1.5, co).astype(np.float32)
        state[f"{name}.bn.bias"] = (rs.randn(co) * 0.1).astype(np.float32)
        state[f"{name}.bn.running_mean"] = (rs.randn(co) * 0.1).astype(np.float32)
        state[f"{name}.bn.running_var"] = rs.uniform(0.5, 1.5, co).astype(np.float32)
    if fc:
        state["fc.weight"] = (rs.randn(1008, 2048) * 0.02).astype(np.float32)
        state["fc.bias"] = (rs.randn(1008) * 0.1).astype(np.float32)
    return state


@pytest.fixture(scope="module")
def pt_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("incep") / "pt_inception.pth"
    state = _pt_state(0)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    return str(path), state


def test_load_pt_inception_matches_jax(pt_ckpt):
    """The BN fold and the fc head bit for bit through the bridge, both ways."""
    path, _ = pt_ckpt
    tp = TI.load_pt_inception(path, device="cpu")
    jp = JI.load_pt_inception(path)
    assert set(tp) == set(jp) and "fc" in tp
    tnp = inception_params_to_numpy(tp)
    for name in jp:
        for leaf in ("w", "b"):
            assert np.array_equal(tnp[name][leaf], np.asarray(jp[name][leaf])), (name, leaf)
    back = inception_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for name in tp:
        assert torch.equal(back[name]["w"], tp[name]["w"])


def test_bn_folding_vs_torch(pt_ckpt):
    """Conv + BatchNorm (eval) in torch == the folded conv."""
    _, state = pt_ckpt
    params = TI.torch_inception_to_params(state, device="cpu")
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 3, 11, 11).astype(np.float32))
    n = "Conv2d_1a_3x3"
    g = {k: torch.from_numpy(state[f"{n}.bn.{k}"]) for k in ("weight", "bias", "running_mean",
                                                              "running_var")}
    ref = F.relu(F.batch_norm(F.conv2d(x, torch.from_numpy(state[f"{n}.conv.weight"]), stride=2),
                              g["running_mean"], g["running_var"], g["weight"], g["bias"],
                              training=False, eps=1e-3))
    ours = TI._conv_relu(params, n, x)
    assert torch.allclose(ours, ref, atol=1e-5), (ours - ref).abs().max()


def test_avg_pool_matches_jax():
    x = np.random.RandomState(1).randn(1, 7, 7, 4).astype(np.float32)
    ours = TI._avg_pool_3x3_nopad(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(JI._avg_pool_3x3_nopad(jnp.asarray(x)))
    assert np.abs(ours.numpy() - ref).max() <= 1e-6


@pytest.mark.parametrize("shape", [(3, 64, 64, 3), (2, 299, 299, 3)])
def test_preprocess_matches_jax(shape):
    u8 = np.random.RandomState(0).randint(0, 256, shape, np.uint8)
    out = TI.preprocess_images(u8).numpy()
    assert out.shape == (shape[0], 299, 299, 3)
    assert np.abs(out - np.asarray(JI.preprocess_images(u8))).max() <= 2e-5


def test_extractor_matches_jax(pt_ckpt):
    """fid_features and inception_probs end to end (preprocess, 94 convs,
    the FID pools, fc + softmax) on the same weights, and a forward of a
    port init bridged to JAX."""
    path, _ = pt_ckpt
    tp = TI.load_pt_inception(path, device="cpu")
    jp = JI.load_pt_inception(path)
    imgs = np.random.RandomState(6).randint(0, 256, (3, 40, 48, 3), np.uint8)
    ft, fj = TI.fid_features(tp, imgs, batch_size=2), JI.fid_features(jp, imgs, batch_size=2)
    assert ft.shape == (3, 2048) and np.isfinite(ft).all()
    assert np.abs(ft - fj).max() <= 1e-5 * np.abs(fj).max()
    pt, pj = TI.inception_probs(tp, imgs, 2), JI.inception_probs(jp, imgs, 2)
    assert pt.shape == (3, 1008)
    assert np.abs(pt - pj).max() <= 1e-5 * np.abs(pj).max()
    with pytest.raises(ValueError, match="fc head"):
        TI.inception_probs({k: v for k, v in tp.items() if k != "fc"}, imgs)

    init = TI.init_inception(torch.Generator().manual_seed(0), "cpu")
    x = np.random.RandomState(7).uniform(-1, 1, (2, 299, 299, 3)).astype(np.float32)
    ours = TI.inception_pool3(init, torch.from_numpy(x)).numpy()
    ref = np.asarray(JI.inception_pool3(jax.tree.map(jnp.asarray, inception_params_to_numpy(init)),
                                        jnp.asarray(x)))
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_clip_score_matches_jax(tmp_path):
    """The transformers CLIPModel route (2.5 x clamped cosine) on a tiny
    random CLIP saved with its processor: the port on the CPU against the
    JAX package's, which runs the same torch model."""
    transformers = pytest.importorskip("transformers")
    import json

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "!": 2}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    tok = transformers.CLIPTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    proc = transformers.CLIPProcessor(
        image_processor=transformers.CLIPImageProcessor(size={"shortest_edge": 32},
                                                        crop_size={"height": 32, "width": 32}),
        tokenizer=tok)
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77,
                         eos_token_id=1, bos_token_id=0, pad_token_id=1),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8),
        projection_dim=16)
    torch.manual_seed(0)
    model_dir = tmp_path / "clip"
    transformers.CLIPModel(cfg).save_pretrained(model_dir)
    proc.save_pretrained(model_dir)
    rs = np.random.RandomState(8)
    images = [rs.randint(0, 256, (40, 48, 3), np.uint8) for _ in range(3)]
    prompts = ["a cat", "a dog", "an owl"]
    ours = TS.clip_score(images, prompts, str(model_dir), batch_size=2, device="cpu")
    ref = JS.clip_score(images, prompts, str(model_dir), batch_size=2)
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-4, (ours, ref)
