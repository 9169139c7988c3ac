"""The port's ImageReward scorer (`eval/image_reward.py`) against the JAX
package and against transformers' BLIP oracle, built as
tests/test_image_reward.py builds it: tiny random BlipVisionModel /
BlipTextModel (direct ports of BLIP's vit.py / med.py) and the published
head's Linear / Dropout stack, saved under ImageReward.pt's names
(`blip.visual_encoder.*` timm naming, `blip.text_encoder.*` BERT naming,
`mlp.layers.*`). No weights are downloaded. The port runs on device="cpu".

Tolerances: the towers 2e-5, the head 1e-5, the protocol's mean reward and
the CLI's score 1e-4 (tests/test_image_reward.py).
"""
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from dgq_tpu.eval import image_reward as JR  # noqa: E402
from dgq_tpu_torch.eval import image_reward as TR  # noqa: E402

# vision: hidden 32, 4 heads, 2 layers, 32px / patch 8 -> 17 tokens;
# text: hidden 24, 3 heads, 2 layers, vocabulary 64
VW, VHEADS, IMG, PATCH = 32, 4, 32, 8
TW, THEADS, VOCAB, CTX = 24, 3, 64, 12


def _vision_rename(k: str) -> str:
    """transformers BlipVisionModel names -> BLIP vit.py (timm) names."""
    k = (k.replace("embeddings.class_embedding", "cls_token")
          .replace("embeddings.position_embedding", "pos_embed")
          .replace("embeddings.patch_embedding", "patch_embed.proj")
          .replace("post_layernorm", "norm").replace("encoder.layers.", "blocks."))
    return (k.replace("self_attn.qkv", "attn.qkv").replace("self_attn.projection", "attn.proj")
             .replace("layer_norm1", "norm1").replace("layer_norm2", "norm2"))


@pytest.fixture(scope="module")
def oracle_and_ckpt(tmp_path_factory):
    from transformers import BlipTextConfig, BlipTextModel, BlipVisionConfig, BlipVisionModel

    torch.manual_seed(0)
    vc = BlipVisionConfig(hidden_size=VW, intermediate_size=2 * VW, num_hidden_layers=2,
                          num_attention_heads=VHEADS, image_size=IMG, patch_size=PATCH,
                          layer_norm_eps=1e-6, hidden_act="gelu")
    # is_decoder=True makes the per-layer cross-attention (med.py's layout);
    # causality is a separate runtime flag, left off below
    tc = BlipTextConfig(hidden_size=TW, intermediate_size=2 * TW, num_hidden_layers=2,
                        num_attention_heads=THEADS, encoder_hidden_size=VW, vocab_size=VOCAB,
                        max_position_embeddings=40, is_decoder=True, layer_norm_eps=1e-12,
                        hidden_act="gelu")
    vis = BlipVisionModel(vc).eval()
    txt = BlipTextModel(tc, add_pooling_layer=False).eval()
    head = torch.nn.Sequential(torch.nn.Linear(TW, 16), torch.nn.Dropout(0.2),
                               torch.nn.Linear(16, 8), torch.nn.Dropout(0.2),
                               torch.nn.Linear(8, 1)).eval()
    sd = {f"blip.visual_encoder.{_vision_rename(k)}": v for k, v in vis.state_dict().items()}
    sd.update({f"blip.text_encoder.{k}": v for k, v in txt.state_dict().items()})
    sd.update({f"mlp.layers.{k}": v for k, v in head.state_dict().items()})
    path = str(tmp_path_factory.mktemp("ir") / "ImageReward.pt")
    torch.save(sd, path)
    return vis, txt, head, path


def _images(n, seed):
    return (np.random.RandomState(seed).randn(n, IMG, IMG, 3) * 0.5).astype(np.float32)


def _tokens(n, seed):
    rng = np.random.RandomState(seed)
    ids, mask = np.zeros((n, CTX), np.int64), np.zeros((n, CTX), np.int64)
    for i in range(n):
        k = rng.randint(3, CTX + 1)
        ids[i, :k] = rng.randint(1, VOCAB, k)
        mask[i, :k] = 1
    return ids, mask


def _oracle(vis, txt, imgs, ids, mask):
    with torch.no_grad():
        v = vis(torch.from_numpy(np.transpose(imgs, (0, 3, 1, 2)))).last_hidden_state
        t = txt(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                encoder_hidden_states=v,
                encoder_attention_mask=torch.ones(v.shape[:2], dtype=torch.long),
                is_decoder=False).last_hidden_state
    return v.numpy(), t.numpy()


def test_load_image_reward_matches_jax(oracle_and_ckpt):
    *_, path = oracle_and_ckpt
    tp, jp = TR.load_image_reward(path, "cpu"), JR.load_image_reward(path)
    for tower in ("visual", "text", "mlp"):
        assert set(tp[tower]) == set(jp[tower]) and tp[tower]
        for k, v in jp[tower].items():
            assert np.array_equal(tp[tower][k].numpy(), v), k


def test_towers_match_jax_and_oracle(oracle_and_ckpt):
    """The vision tower and the text tower with cross-attention."""
    vis, txt, _, path = oracle_and_ckpt
    tp, jp = TR.load_image_reward(path, "cpu"), JR.load_image_reward(path)
    imgs = _images(4, 1)
    ids, mask = _tokens(4, 2)
    v_ref, t_ref = _oracle(vis, txt, imgs, ids, mask)
    v = TR.encode_vision(tp["visual"], torch.from_numpy(imgs), heads=VHEADS)
    vj = JR.encode_vision(jp["visual"], jnp.asarray(imgs), heads=VHEADS)
    assert np.abs(v.numpy() - v_ref).max() <= 2e-5, np.abs(v.numpy() - v_ref).max()
    assert np.abs(v.numpy() - np.asarray(vj)).max() <= 2e-5
    t = TR.encode_text_cross(tp["text"], torch.from_numpy(ids), torch.from_numpy(mask), v,
                             heads=THEADS).numpy()
    tj = np.asarray(JR.encode_text_cross(jp["text"], jnp.asarray(ids), jnp.asarray(mask), vj,
                                         heads=THEADS))
    assert t.shape == t_ref.shape
    assert np.abs(t - t_ref).max() <= 2e-5, np.abs(t - t_ref).max()
    assert np.abs(t - tj).max() <= 2e-5, np.abs(t - tj).max()


def test_reward_head_matches_jax(oracle_and_ckpt):
    _, _, head, path = oracle_and_ckpt
    feats = np.random.RandomState(3).randn(5, TW).astype(np.float32)
    with torch.no_grad():
        want = (head(torch.from_numpy(feats)).numpy()[:, 0] - TR.IR_MEAN) / TR.IR_STD
    got = TR.reward_head(TR.load_image_reward(path, "cpu")["mlp"], torch.from_numpy(feats)).numpy()
    jgot = np.asarray(JR.reward_head(JR.load_image_reward(path)["mlp"], jnp.asarray(feats)))
    assert (TR.IR_MEAN, TR.IR_STD) == (JR.IR_MEAN, JR.IR_STD)
    assert np.abs(got - want).max() <= 1e-5 and np.abs(got - jgot).max() <= 1e-5


def test_score_native_matches_jax(oracle_and_ckpt):
    """The whole protocol on uint8 images of another size (resize, crop),
    batched, tokenization handed in."""
    *_, path = oracle_and_ckpt
    rng = np.random.RandomState(4)
    images = [rng.randint(0, 255, (48, 40, 3)).astype(np.uint8) for _ in range(3)]
    ids, mask = _tokens(3, 5)
    fake = lambda p, d, max_length=35: (ids, mask)  # noqa: E731
    kw = dict(batch_size=2, vision_heads=VHEADS, text_heads=THEADS, image_size=IMG)
    with mock.patch.object(TR, "tokenize_ir", fake), mock.patch.object(JR, "tokenize_ir", fake):
        ours = TR.image_reward_score_native(images, ["a", "b", "c"], path, "unused",
                                            device="cpu", **kw)
        ref = JR.image_reward_score_native(images, ["a", "b", "c"], path, "unused", **kw)
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-4, (ours, ref)


def test_tokenize_ir_matches_jax(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "on", "the", "mat"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    prompts = ["a cat", "a cat on the mat " * 20]
    ids, mask = TR.tokenize_ir(prompts, str(tmp_path), max_length=8)
    jids, jmask = JR.tokenize_ir(prompts, str(tmp_path), max_length=8)
    assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)
    assert list(ids[0, :4]) == [2, 5, 6, 3] and mask[1].sum() == 8


def test_eval_scores_cli_scorers_match_jax(oracle_and_ckpt, tmp_path):
    """eval_scores' --image_reward_ckpt and --open_clip_ckpt branches with
    their prompt alignment ('{prompt}_{rep}' stems, two reps), port against
    JAX: the same JSON keys, values within 1e-4; and the argument checks."""
    pil = pytest.importorskip("PIL.Image")
    from dgq_tpu.cli import eval_scores as JE
    from dgq_tpu.eval import open_clip as JO
    from dgq_tpu_torch.cli import eval_scores as TE
    from dgq_tpu_torch.eval import open_clip as TO

    *_, ir_ckpt = oracle_and_ckpt
    # an open_clip checkpoint whose text width gives the default 12-layer
    # head count: a ViT with width 64 (1 head) for both towers
    torch.manual_seed(1)
    oc = {"visual.conv1.weight": torch.randn(64, 3, 8, 8) * 0.05,
          "visual.class_embedding": torch.randn(64) * 0.02,
          "visual.positional_embedding": torch.randn(17, 64) * 0.02,
          "visual.proj": torch.randn(64, 16) * 0.05,
          "token_embedding.weight": torch.randn(VOCAB, 64) * 0.02,
          "positional_embedding": torch.randn(77, 64) * 0.02,
          "text_projection": torch.randn(64, 16) * 0.05}
    for pre in ("visual.transformer", "transformer"):
        blk = f"{pre}.resblocks.0"
        oc.update({f"{blk}.attn.in_proj_weight": torch.randn(192, 64) * 0.05,
                   f"{blk}.attn.in_proj_bias": torch.randn(192) * 0.02,
                   f"{blk}.attn.out_proj.weight": torch.randn(64, 64) * 0.05,
                   f"{blk}.attn.out_proj.bias": torch.randn(64) * 0.02,
                   f"{blk}.mlp.c_fc.weight": torch.randn(256, 64) * 0.05,
                   f"{blk}.mlp.c_fc.bias": torch.randn(256) * 0.02,
                   f"{blk}.mlp.c_proj.weight": torch.randn(64, 256) * 0.05,
                   f"{blk}.mlp.c_proj.bias": torch.randn(64) * 0.02})
        for ln in ("ln_1", "ln_2"):
            oc[f"{blk}.{ln}.weight"], oc[f"{blk}.{ln}.bias"] = torch.ones(64), torch.zeros(64)
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        oc[f"{ln}.weight"], oc[f"{ln}.bias"] = torch.ones(64), torch.randn(64) * 0.02
    oc_ckpt = str(tmp_path / "open_clip.bin")
    torch.save(oc, oc_ckpt)

    rs = np.random.RandomState(7)
    gen = tmp_path / "gen"
    gen.mkdir()
    for p in range(3):
        for r in range(2):
            pil.fromarray(rs.randint(0, 256, (IMG, IMG, 3), np.uint8)).save(gen / f"{p}_{r}.png")
    (tmp_path / "prompts.csv").write_text("caption\na cat\na dog\na mat\n")
    ids = np.zeros((6, 77), np.int64)
    ids[:, 0], ids[:, 1:4] = 1, rs.randint(2, VOCAB - 1, (6, 3))
    ids[:, 4] = VOCAB - 1
    ir_ids, ir_mask = _tokens(6, 8)
    argv = ["--gen_dir", str(gen), "--prompts", str(tmp_path / "prompts.csv"),
            "--image_reward_ckpt", ir_ckpt, "--ir_tokenizer", "unused",
            "--open_clip_ckpt", oc_ckpt, "--tokenizer", "unused", "--batch", "4"]
    seen = {}

    def oc_tok(prompts, d, context=77):
        seen.setdefault(d, prompts)
        return ids[:len(prompts)]
    ir_tok = lambda p, d, max_length=35: (ir_ids[:len(p)], ir_mask[:len(p)])  # noqa: E731
    # the tiny BLIP towers have 4 and 3 heads, the CLI the published 16 / 12
    real_t, real_j = TR.image_reward_scores, JR.image_reward_scores
    # both CLIs' random extractors (unused here: no reference) from one draw
    from dgq_tpu.eval import inception as JI
    from dgq_tpu_torch.eval import inception as TI
    from dgq_tpu_torch.io.convert import inception_params_to_numpy

    init = TI.init_inception(torch.Generator().manual_seed(0), "cpu")
    with mock.patch.object(JI, "init_inception", lambda key: jax.tree.map(
            jnp.asarray, inception_params_to_numpy(init))), \
            mock.patch.object(TO, "tokenize", oc_tok), mock.patch.object(JO, "tokenize", oc_tok), \
            mock.patch.object(TR, "tokenize_ir", ir_tok), \
            mock.patch.object(JR, "tokenize_ir", ir_tok), \
            mock.patch.object(TR, "image_reward_scores",
                              lambda p, i, t, m, vh, th: real_t(p, i, t, m, VHEADS, THEADS)), \
            mock.patch.object(JR, "image_reward_scores",
                              lambda p, i, t, m, vh, th: real_j(p, i, t, m, VHEADS, THEADS)):
        ours = TE.main(argv + ["--device", "cpu"])
        ref = JE.main(argv)
    assert seen["unused"] == ["a cat", "a cat", "a dog", "a dog", "a mat", "a mat"]
    assert set(ours) == set(ref) == {"image_reward", "clip_score_openclip"}
    for k in ref:
        assert np.isfinite(ours[k]) and abs(ours[k] - ref[k]) <= 1e-4, (k, ours[k], ref[k])

    for bad in (["--open_clip_ckpt", oc_ckpt], ["--image_reward_ckpt", ir_ckpt]):
        with pytest.raises(SystemExit):
            TE.parse_args(["--gen_dir", str(gen)] + bad)
