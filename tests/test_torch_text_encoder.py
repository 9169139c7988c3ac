"""The port's CLIP text encoders against the JAX package's
(`pipeline/text_encoder.py`), in float32 on the same weights and token ids.

The weights are an HF-style state dict drawn with numpy from a seed (width
64, 2 layers, random norm scales), converted by each package's
`hf_clip_text_to_params`, so the converters are held to each other too.
Tolerance: 1e-5 of the reference's largest magnitude (the same math in
another summation order). Token ids hold an EOS id (the last vocabulary
entry) in one row and none in the other, which takes the argmax fallback
of `_eos_positions`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.pipeline import text_encoder as JT  # noqa: E402
from dgq_tpu_torch.pipeline import text_encoder as TT  # noqa: E402

VOCAB, WIDTH, LAYERS, HEADS, PROJ = 99, 64, 2, 4, 48
EOS = VOCAB - 1
LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
           "mlp.fc1", "mlp.fc2")


def hf_state(seed, width=WIDTH, layers=LAYERS, proj=PROJ, prefix="text_model."):
    """An HF CLIPTextModel(WithProjection) state dict of numpy arrays."""
    rng = np.random.RandomState(seed)

    def n(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)

    st = {f"{prefix}embeddings.token_embedding.weight": n(VOCAB, width, s=0.5),
          f"{prefix}embeddings.position_embedding.weight": n(77, width, s=0.1),
          f"{prefix}final_layer_norm.weight": 1 + n(width, s=0.1),
          f"{prefix}final_layer_norm.bias": n(width, s=0.1)}
    dims = {"self_attn.q_proj": (width, width), "self_attn.k_proj": (width, width),
            "self_attn.v_proj": (width, width), "self_attn.out_proj": (width, width),
            "mlp.fc1": (width, 4 * width), "mlp.fc2": (4 * width, width)}
    for i in range(layers):
        pre = f"{prefix}encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            st[f"{pre}.{ln}.weight"] = 1 + n(width, s=0.1)
            st[f"{pre}.{ln}.bias"] = n(width, s=0.1)
        for name, (ci, co) in dims.items():
            st[f"{pre}.{name}.weight"] = n(co, ci, s=ci ** -0.5)
            st[f"{pre}.{name}.bias"] = n(co, s=0.02)
    if proj:
        st["text_projection.weight"] = n(proj, width, s=width ** -0.5)
    return st


@pytest.fixture(scope="module")
def weights():
    st = hf_state(0)
    return st, JT.hf_clip_text_to_params(st), TT.hf_clip_text_to_params(st, device="cpu")


def token_ids(seed=1, t=77):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, EOS, size=(2, t)).astype(np.int32)
    ids[0, 9] = EOS   # first EOS of row 0; row 1 has none: argmax fallback
    ids[0, 30] = EOS
    return ids


def close(out, ref):
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_hf_converter_layouts(weights):
    st, jp, tp = weights
    assert set(tp) == set(jp)
    pre = "encoder.layers.1"
    for lin in LINEARS:  # the port keeps (O, I); JAX transposes to (I, O)
        np.testing.assert_array_equal(tp[f"{pre}.{lin}"]["w"].numpy(),
                                      st[f"text_model.{pre}.{lin}.weight"])
        np.testing.assert_array_equal(tp[f"{pre}.{lin}"]["w"].numpy().T,
                                      np.asarray(jp[f"{pre}.{lin}"]["w"]))
    np.testing.assert_array_equal(tp["text_projection"].numpy(), st["text_projection.weight"])
    np.testing.assert_array_equal(tp["text_projection"].numpy().T,
                                  np.asarray(jp["text_projection"]))
    assert TT.clip_meta_from_params(tp) == JT.clip_meta_from_params(jp) == (LAYERS, 1)
    # without the 'text_model.' prefix, and without a projection
    bare = TT.hf_clip_text_to_params(hf_state(0, proj=0, prefix=""), device="cpu")
    assert set(bare) == set(tp) - {"text_projection"}
    for k, v in bare.items():
        for leaf, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            assert torch.equal(a, tp[k][leaf] if leaf else tp[k]), (k, leaf)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("skip_last,final_norm", [(0, True), (0, False), (1, True)])
def test_clip_text_encode(weights, act, skip_last, final_norm):
    _, jp, tp = weights
    ids = token_ids()
    ref = JT.clip_text_encode(jp, jnp.asarray(ids), LAYERS, HEADS, final_norm=final_norm,
                              act=act, skip_last=skip_last)
    out = TT.clip_text_encode(tp, torch.from_numpy(ids).long(), LAYERS, HEADS,
                              final_norm=final_norm, act=act, skip_last=skip_last)
    close(out, ref)


def test_eos_positions():
    ids = token_ids(seed=2)
    ids[1, 40] = VOCAB  # row 1: no EOS, its largest id at 40
    got = TT._eos_positions(torch.from_numpy(ids).long(), EOS).numpy()
    want = np.asarray(JT._eos_positions(jnp.asarray(ids), EOS))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 9 and got[1] == 40


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_pooled(weights, act):
    _, jp, tp = weights
    ids = token_ids(seed=3)
    ref = JT.clip_text_pooled(jp, jnp.asarray(ids), LAYERS, HEADS, act=act, eos_id=EOS)
    out = TT.clip_text_pooled(tp, torch.from_numpy(ids).long(), LAYERS, HEADS, act=act,
                              eos_id=EOS)
    assert tuple(out.shape) == (2, PROJ)
    close(out, ref)


def test_sdxl_encode_prompt():
    st_l, st_g = hf_state(4, width=64, proj=0), hf_state(5, width=96, layers=3, proj=80)
    jl, jg = JT.hf_clip_text_to_params(st_l), JT.hf_clip_text_to_params(st_g)
    tl, tg = (TT.hf_clip_text_to_params(s, device="cpu") for s in (st_l, st_g))
    ids_l, ids_g = token_ids(seed=6), token_ids(seed=7)
    kw = dict(layers_l=2, heads_l=4, layers_g=3, heads_g=3, eos_id=EOS)
    jh, jpool = JT.sdxl_encode_prompt(jl, jg, jnp.asarray(ids_l), jnp.asarray(ids_g), **kw)
    th, tpool = TT.sdxl_encode_prompt(tl, tg, torch.from_numpy(ids_l).long(),
                                      torch.from_numpy(ids_g).long(), **kw)
    assert tuple(th.shape) == (2, 77, 64 + 96) and tuple(tpool.shape) == (2, 80)
    close(th, jh)
    close(tpool, jpool)


def test_quick_gelu_and_attention(weights):
    _, jp, tp = weights
    x = np.random.RandomState(8).randn(2, 77, WIDTH).astype(np.float32)
    close(TT.quick_gelu(torch.from_numpy(x)), JT.quick_gelu(jnp.asarray(x)))
    mask = np.tril(np.ones((77, 77), bool))
    pre = "encoder.layers.0.self_attn"
    close(TT.clip_attention(tp, pre, torch.from_numpy(x), HEADS, torch.from_numpy(mask)),
          JT.clip_attention(jp, pre, jnp.asarray(x), HEADS, jnp.asarray(mask)[None, None]))


def test_init_clip_text_shapes():
    jp = JT.init_clip_text(jax.random.PRNGKey(0), vocab=VOCAB, width=WIDTH, layers=LAYERS,
                           proj_dim=PROJ)
    tp = TT.init_clip_text(torch.Generator().manual_seed(0), "cpu", vocab=VOCAB, width=WIDTH,
                           layers=LAYERS, proj_dim=PROJ)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        if isinstance(v, dict):
            for leaf, a in v.items():
                shape = tuple(np.shape(a))
                want = shape[::-1] if leaf == "w" else shape
                assert tuple(tp[k][leaf].shape) == want, (k, leaf)
        else:
            want = np.shape(v)[::-1] if k == "text_projection" else np.shape(v)
            assert tuple(tp[k].shape) == tuple(want), k
    ids = torch.from_numpy(token_ids()).long()
    out = TT.clip_text_pooled(tp, ids, LAYERS, 1, eos_id=EOS)
    assert tuple(out.shape) == (2, PROJ) and bool(torch.isfinite(out).all())
