"""The port's pipelines (`pipeline/sd_pipeline.py`, `prepare.py`, the VAE
converter and `latents_to_images`) against the JAX package's.

The JAX pipelines draw their initial latents from `jax.random.PRNGKey(seed)`,
the port's from a `torch.Generator` (a difference kept on purpose), so each
comparison hands the port the JAX latents through `_initial_latents`.

Tolerances:
  * fp: 1e-4 absolute on the final latents (2 PNDM steps, 3 UNet calls at
    CFG 7.5 for SD; 1 Euler step for SDXL-turbo).
  * quantized (W8A8, time-aware for SD, the fused attention's plain
    versions): the chaos bound of tests/test_packed_in_model.py,
    err <= max(5 * chaos, 1e-4), chaos measured on the JAX side under a 1e-6
    perturbation of the latents, the largest of eight draws.
  * latents_to_images: within one level of 255.
  * converters and `prepare_pipeline`'s weights: bit for bit.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.models.qconfig import QConfig as JQ  # noqa: E402
from dgq_tpu.models.unet_sd import sd_unet_spec  # noqa: E402
from dgq_tpu.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply  # noqa: E402
from dgq_tpu.pipeline import prepare as JP, sampler as JS, sd_pipeline as JSP  # noqa: E402
from dgq_tpu.pipeline import text_encoder as JT, vae as JV  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import quantize_model_weights  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy, params_to_torch_unet  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQ  # noqa: E402
from dgq_tpu_torch.models.unet_sdxl import unet_sdxl_apply as t_sdxl_apply  # noqa: E402
from dgq_tpu_torch.pipeline import prepare as TP, sd_pipeline as TSP  # noqa: E402
from dgq_tpu_torch.pipeline import text_encoder as TT, vae as TV  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402

BASE, CROSS, HW, SEED, STEPS = 32, 64, 64, 7, 2
QKW = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
           use_pallas_attention=True)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _jax_latents(b, seed=SEED, hw=HW):
    return jax.random.normal(jax.random.PRNGKey(seed), (b, hw // 8, hw // 8, 4))


def _hand_latents(monkeypatch, cls, lat):
    """The port's pipeline draws `lat` (the JAX pipeline's latents)."""
    def draw(self, b, height, width, seed):
        assert (b, height // 8, width // 8, 4) == tuple(lat.shape) and seed == SEED
        return torch.from_numpy(np.array(lat))
    monkeypatch.setattr(cls, "_initial_latents", draw)


@pytest.fixture(scope="module")
def sd():
    spec = sd_unet_spec(base=BASE, cross=CROSS)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    rng = np.random.RandomState(1)
    text, uncond = (rng.randn(2, 77, CROSS).astype(np.float32) for _ in range(2))
    return spec, tp, text, uncond


def test_sd_pipeline_fp_matches_jax(sd, monkeypatch):
    spec, tp, text, uncond = sd
    jpipe = JSP.SDPipeline(unet_params=_j(params_to_numpy(tp, spec)))
    ref = jpipe.generate_from_embeddings(jnp.asarray(text), jnp.asarray(uncond), steps=STEPS,
                                         height=HW, width=HW, seed=SEED)
    _hand_latents(monkeypatch, TSP.SDPipeline, _jax_latents(2))
    out = TSP.SDPipeline(unet_params=tp, device="cpu").generate_from_embeddings(
        torch.from_numpy(text), torch.from_numpy(uncond), steps=STEPS, height=HW, width=HW,
        seed=SEED)
    assert out.shape == (2, HW // 8, HW // 8, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-4)


def test_sd_pipeline_quantized_time_aware_within_chaos(sd, monkeypatch):
    spec, tp, text, uncond = sd
    tq, _ = quantize_model_weights(tp, spec, TQ(**QKW))
    jp = _j(params_to_numpy(tq, spec))
    # two distinct slots, so a wrong slot pick (PNDM calls the second
    # timestep twice) shows up
    scale = [1.0, 1.5]
    jqs = j_syn(spec, STEPS, True, jnp.float32)
    jqs["a"] = {n: qp._replace(delta=qp.delta * jnp.asarray(scale)) for n, qp in jqs["a"].items()}
    tqs = t_syn(spec, STEPS, True, torch.float32, device="cpu")
    tqs["a"] = {n: qp._replace(delta=qp.delta * torch.tensor(scale))
                for n, qp in tqs["a"].items()}

    @jax.jit
    def run(lat):
        return JS.sd_sample(jp, lat, jnp.asarray(text), jnp.asarray(uncond),
                            num_inference_steps=STEPS, scheduler="pndm", guidance_scale=7.5,
                            qstate=jqs, cfg=JQ(**QKW), time_aware=True)

    lat = _jax_latents(2)
    ref = np.asarray(run(lat))
    rng = np.random.RandomState(2)
    chaos = max(np.abs(np.asarray(run(lat + 1e-6 * rng.randn(*lat.shape))) - ref).max()
                for _ in range(8))
    _hand_latents(monkeypatch, TSP.SDPipeline, lat)
    out = TSP.SDPipeline(unet_params=tq, cfg=TQ(**QKW), qstate=tqs, time_aware=True,
                         device="cpu").generate_from_embeddings(
        torch.from_numpy(text), torch.from_numpy(uncond), steps=STEPS, height=HW, width=HW,
        seed=SEED)
    err = np.abs(out - ref).max()
    assert np.isfinite(out).all()
    assert err <= max(5 * chaos, 1e-4), (err, chaos)


@pytest.fixture(scope="module")
def sdxl():
    spec = sdxl_unet_spec(base=BASE, cross=CROSS, depths=(1, 1))
    tp = TU.init_unet_sd(torch.Generator().manual_seed(3), "cpu", spec=spec)
    rng = np.random.RandomState(4)
    ehs = rng.randn(1, 77, CROSS).astype(np.float32)
    pooled = rng.randn(1, 4 * BASE).astype(np.float32)
    return spec, tp, ehs, pooled


def test_sdxl_pipeline_fp_matches_jax(sdxl, monkeypatch):
    spec, tp, ehs, pooled = sdxl
    jpipe = JSP.SDXLTurboPipeline(unet_params=_j(params_to_numpy(tp, spec)))
    ref = jpipe.generate_from_embeddings(jnp.asarray(ehs), jnp.asarray(pooled), steps=1,
                                         height=HW, width=HW, seed=SEED)
    _hand_latents(monkeypatch, TSP.SDXLTurboPipeline, _jax_latents(1))
    out = TSP.SDXLTurboPipeline(unet_params=tp, device="cpu").generate_from_embeddings(
        torch.from_numpy(ehs), torch.from_numpy(pooled), steps=1, height=HW, width=HW,
        seed=SEED)
    assert out.shape == (1, HW // 8, HW // 8, 4)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-4)


def test_sdxl_pipeline_quantized_within_chaos(sdxl, monkeypatch):
    spec, tp, ehs, pooled = sdxl
    kw = dict(QKW, t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True)
    tq, _ = quantize_model_weights(tp, spec, TQ(**kw))
    jp = _j(params_to_numpy(tq, spec))
    jqs = j_syn(spec, 1, False, jnp.float32)
    time_ids = jnp.asarray([[HW, HW, 0.0, 0.0, HW, HW]], jnp.float32)

    @jax.jit
    def run(lat):
        return JS.sdxl_turbo_sample(jp, lat, jnp.asarray(ehs), jnp.asarray(pooled), time_ids,
                                    unet_apply=unet_sdxl_apply, num_inference_steps=1,
                                    qstate=jqs, cfg=JQ(**kw))

    lat = _jax_latents(1)
    ref = np.asarray(run(lat))
    rng = np.random.RandomState(5)
    chaos = max(np.abs(np.asarray(run(lat + 1e-6 * rng.randn(*lat.shape))) - ref).max()
                for _ in range(8))
    _hand_latents(monkeypatch, TSP.SDXLTurboPipeline, lat)
    out = TSP.SDXLTurboPipeline(
        unet_params=tq, cfg=TQ(**kw), qstate=t_syn(spec, 1, False, torch.float32, device="cpu"),
        unet_apply=t_sdxl_apply, device="cpu").generate_from_embeddings(
        torch.from_numpy(ehs), torch.from_numpy(pooled), steps=1, height=HW, width=HW,
        seed=SEED)
    err = np.abs(out - ref).max()
    assert err <= max(5 * chaos, 1e-4), (err, chaos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_latents_to_images(dtype):
    x = torch.from_numpy(np.random.RandomState(6).uniform(-1.3, 1.3, (2, 8, 8, 3))
                         .astype(np.float32)).to(dtype)
    got = TV.latents_to_images(x)
    want = JV.latents_to_images(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _vae_state(seed=8):
    spec = TV.vae_decoder_spec(base=BASE)
    tv = TV.init_vae_decoder(torch.Generator().manual_seed(seed), "cpu", base=BASE)
    rng = np.random.RandomState(seed)
    for p in tv.values():  # non-trivial norms and biases
        for k in ("scale", "bias", "b"):
            if p.get(k) is not None:
                p[k] = p[k] + torch.from_numpy(0.1 * rng.randn(*p[k].shape).astype(np.float32))
    state = {k: v.numpy() for k, v in params_to_torch_unet(tv, spec).items()}
    state["encoder.conv_in.weight"] = np.ones((8, 3, 3, 3), np.float32)  # not decoder: dropped
    state["quant_conv.bias"] = np.ones((8,), np.float32)
    return spec, tv, state


def test_hf_vae_to_params_matches_jax():
    spec, tv, state = _vae_state()
    tp = TV.hf_vae_to_params(state, device="cpu")
    jp = JV.hf_vae_to_params(state)
    assert set(tp) == set(jp) == {n for n, _, _ in spec}
    tnp = params_to_numpy(tp, spec)
    for name, _, _ in spec:
        for leaf, v in jp[name].items():
            np.testing.assert_array_equal(tnp[name][leaf], np.asarray(v), err_msg=name)
            assert torch.equal(tp[name][leaf], tv[name][leaf])


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A tiny CLIP BPE tokenizer's files (vocab.json, merges.txt), as
    tests/test_sdxl_prompt_path.py builds it."""
    d = tmp_path_factory.mktemp("tok")
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "!": 2}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return d


def _text_state(seed, vocab, width, proj):
    rng = np.random.RandomState(seed)
    p = TT.init_clip_text(torch.Generator().manual_seed(seed), "cpu", vocab=vocab, width=width,
                          layers=2, proj_dim=proj)
    st = {"text_model.embeddings.token_embedding.weight": p["token_embedding"],
          "text_model.embeddings.position_embedding.weight": p["position_embedding"]}
    for name, v in p.items():
        if name == "text_projection":
            st["text_projection.weight"] = v
        elif isinstance(v, dict):
            for leaf, hf in (("w", "weight"), ("b", "bias"), ("scale", "weight"),
                             ("bias", "bias")):
                if leaf in v:
                    st[f"text_model.{name}.{hf}"] = v[leaf] + (
                        0 if leaf == "w" else torch.from_numpy(
                            0.05 * rng.randn(*v[leaf].shape).astype(np.float32)))
    return {k: v.numpy() for k, v in st.items()}


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory, tokenizer_dir, sd):
    """A diffusers-style snapshot: unet/, vae/, text_encoder/ and tokenizer/."""
    spec, tp = sd[0], sd[1]
    root = tmp_path_factory.mktemp("snap")
    for sub in ("unet", "vae", "text_encoder", "tokenizer"):
        (root / sub).mkdir()
    torch.save(params_to_torch_unet(tp, spec), root / "unet" / "diffusion_pytorch_model.bin")
    torch.save({k: torch.from_numpy(v) for k, v in _vae_state()[2].items()},
               root / "vae" / "diffusion_pytorch_model.bin")
    torch.save({k: torch.from_numpy(v) for k, v in _text_state(9, 55, 32, 0).items()},
               root / "text_encoder" / "pytorch_model.bin")
    for f in ("vocab.json", "merges.txt"):
        (root / "tokenizer" / f).write_text((tokenizer_dir / f).read_text())
    return root


def test_prepare_pipeline_sd_matches_jax(snapshot):
    pytest.importorskip("transformers")
    tpipe = TP.prepare_pipeline("sd", str(snapshot), base=BASE, device="cpu")
    jpipe = JP.prepare_pipeline("sd", str(snapshot), base=BASE)
    spec = sd_unet_spec(base=BASE)
    tnp = params_to_numpy(tpipe.unet_params, spec)
    for name, _, _ in spec:
        for leaf, v in jpipe.unet_params[name].items():
            if v is not None:
                np.testing.assert_array_equal(tnp[name][leaf], np.asarray(v), err_msg=name)
    vspec = TV.vae_decoder_spec(base=BASE)
    vnp = params_to_numpy(tpipe.vae_params, vspec)
    for name, _, _ in vspec:
        for leaf, v in jpipe.vae_params[name].items():
            np.testing.assert_array_equal(vnp[name][leaf], np.asarray(v), err_msg=name)
    assert set(tpipe.text_params) == set(jpipe.text_params)
    assert tpipe.tokenizer is not None and jpipe.tokenizer is not None
    assert tpipe.device == "cpu" and isinstance(tpipe, TSP.SDPipeline)
    # the two packages' CLIP encoders on the snapshot's weights
    ids = np.asarray(tpipe.tokenizer(["a cat"], padding="max_length", max_length=77,
                                     return_tensors="np").input_ids)
    layers, heads = TT.clip_meta_from_params(tpipe.text_params)
    out = TT.clip_text_encode(tpipe.text_params, torch.from_numpy(ids).long(), layers, heads)
    ref = np.asarray(JT.clip_text_encode(jpipe.text_params, jnp.asarray(ids), layers, heads))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_prepare_pipeline_missing_parts(tmp_path, sdxl):
    with pytest.raises(FileNotFoundError):
        TP.prepare_pipeline("sd", str(tmp_path), base=BASE, device="cpu")
    (tmp_path / "unet").mkdir()
    spec, tp = sd_unet_spec(base=BASE), TU.init_unet_sd(torch.Generator().manual_seed(0),
                                                        "cpu", spec=sd_unet_spec(base=BASE))
    torch.save(params_to_torch_unet(tp, spec), tmp_path / "unet" / "unet.pth")
    pipe = TP.prepare_pipeline("sd", str(tmp_path), base=BASE, device="cpu")
    assert pipe.vae_params is None and pipe.text_params is None and pipe.tokenizer is None
    with pytest.raises(RuntimeError, match="tokenizer"):
        pipe.encode_prompts(["a cat"])
    xpipe = TP.prepare_pipeline("sdxl", str(tmp_path), unet_params=sdxl[1], device="cpu")
    assert isinstance(xpipe, TSP.SDXLTurboPipeline) and xpipe.text_params_g is None
    with pytest.raises(RuntimeError, match="tokenizers"):
        xpipe.encode_prompts(["a dog"])
    with pytest.raises(ValueError, match="unknown model type"):
        TP.prepare_pipeline("sd2", str(tmp_path), unet_params={}, device="cpu")


def test_sdxl_prompt_path_with_tokenizer(tokenizer_dir, sdxl):
    transformers = pytest.importorskip("transformers")
    tok = transformers.CLIPTokenizer(str(tokenizer_dir / "vocab.json"),
                                     str(tokenizer_dir / "merges.txt"))
    n = len(tok.get_vocab())
    w_l, w_g = 32, 32
    st_l, st_g = _text_state(10, n, w_l, 0), _text_state(11, n, w_g, 4 * BASE)
    kw = dict(tokenizer=tok, tokenizer_2=tok, layers_l=2, heads_l=4, layers_g=2, heads_g=4)
    spec, tp = sdxl[0], sdxl[1]
    tpipe = TSP.SDXLTurboPipeline(unet_params=tp, device="cpu",
                                  text_params_l=TT.hf_clip_text_to_params(st_l, device="cpu"),
                                  text_params_g=TT.hf_clip_text_to_params(st_g, device="cpu"),
                                  **kw)
    jpipe = JSP.SDXLTurboPipeline(unet_params=None, text_params_l=JT.hf_clip_text_to_params(st_l),
                                  text_params_g=JT.hf_clip_text_to_params(st_g), **kw)
    ehs, pooled = tpipe.encode_prompts(["a cat", "dog"])
    jehs, jpooled = jpipe.encode_prompts(["a cat", "dog"])
    assert tuple(ehs.shape) == (2, 77, w_l + w_g) and tuple(pooled.shape) == (2, 4 * BASE)
    for a, b in ((ehs, jehs), (pooled, jpooled)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    out = tpipe(["a cat"], steps=1, height=HW, width=HW)
    assert out.shape == (1, HW // 8, HW // 8, 4) and np.isfinite(out).all()
