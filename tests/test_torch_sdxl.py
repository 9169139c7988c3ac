"""The port's SDXL-turbo path (models.unet_sdxl, the Euler scheduler,
sdxl_turbo_sample, the SDXL VAE scale) against the JAX package on the same
numpy inputs and weights. The tiny model is the one of tests/test_unet_sdxl.py
(base 32, cross 64, add_ch 8) with the transformer stacks shrunk to depths
(1, 2), which `unet_sdxl_apply` reads off the params.

Tolerances:
  * Euler constants: exact (the same numpy math); the Euler updates: atol
    1e-6 (f32 elementwise in the same order).
  * fp forward and the 2-step fp sample: 1e-5 of the output's largest
    magnitude (summation order of convs, matmuls and norms differs between
    XLA:CPU and PyTorch; the model is unquantized, so it stays close).
  * quantized forward (the SDXL-turbo policy: W8A8, log2 real-time softmax
    with start_peak, int8 matmul path on): a chaos bound in the manner of
    tests/test_packed_in_model.py. Any value within float error of a
    quantizer bin boundary flips a bin, and under the real-time softmax one
    flipped maximum rescales a whole attention, so this net answers a
    perturbation either with no change at all or with one of about 0.4 (its
    outputs are of size 0.8): measured on the JAX net, 2 of 32 draws of size
    1e-6 and 16 of 16 draws of size 1e-5 change it by 0.38 to 0.50. The two
    packages' fp forwards differ by up to 1e-5 of the output (asserted
    below), so one package is a 1e-5 perturbation of the other: chaos is the
    JAX net's largest change (and largest mean change) over four draws of
    1e-5, and the port must be within 2 * chaos of JAX in both (measured:
    0.27 against 0.4 to 0.5). What holds the quantized layers tightly is
    tests/test_torch_int8.py and tests/test_torch_layers.py, layer by layer.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import dgq_tpu.ops.pallas.int8_matmul as JM  # noqa: E402
from dgq_tpu.models import unet_sdxl as JX  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQ  # noqa: E402
from dgq_tpu.pipeline import sampler as JS, schedulers as JSch, vae as JV  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_group_qstate as j_gsyn  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib.act_calib import attention_prefixes  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import quantize_model_weights as t_qmw  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy  # noqa: E402
from dgq_tpu_torch.models import layers as TL  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models import unet_sdxl as TX  # noqa: E402
from dgq_tpu_torch.models.qconfig import GroupQParams as TG, QConfig as TQ  # noqa: E402
from dgq_tpu_torch.pipeline import sampler as TS, schedulers as TSch, vae as TV  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate as t_gsyn  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402

BASE, CROSS, ADD_CH, DEPTHS = 32, 64, 8, (1, 2)


def test_full_width_spec_and_param_count():
    spec = TX.sdxl_unet_spec()
    assert spec == JX.sdxl_unet_spec()
    assert TX.sdxl_unet_spec(BASE, CROSS, ADD_CH, DEPTHS) == JX.sdxl_unet_spec(
        BASE, CROSS, ADD_CH, DEPTHS)
    params = TX.init_unet_sdxl(torch.Generator().manual_seed(0), "meta")
    n = sum(t.numel() for p in params.values() for t in p.values() if t is not None)
    assert n == 2_567_463_684, n
    assert 2.4e9 < n < 2.75e9  # the JAX package's own check
    assert len(TU.quantizable_layers(spec)) == 794
    assert len(attention_prefixes(spec)) == 140  # 70 transformer blocks
    assert tuple(params["add_embedding.linear_1"]["w"].shape) == (1280, 2816)
    assert tuple(params["down_blocks.2.attentions.0.proj_in"]["w"].shape) == (1280, 1280)
    assert tuple(params["mid_block.attentions.0.transformer_blocks.9.attn2.to_k"]["w"].shape) == (
        1280, 2048)
    assert TX.SDXL_CROSS == JX.SDXL_CROSS
    for inner, base in [(640, 320), (1280, 320), (64, 32), (128, 32)]:
        assert TX._heads(inner, base) == JX._heads(inner, base)
    assert TX._heads(640, 320) == 10 and TX._heads(1280, 320) == 20  # head dim 64


def test_synthetic_qstates_walk_the_sdxl_spec():
    spec = TX.sdxl_unet_spec(BASE, CROSS, ADD_CH, DEPTHS)
    jq, tq = j_syn(spec, 4, True, jnp.float32), t_syn(spec, 4, True, torch.float32, device="cpu")
    assert set(jq["a"]) == set(tq["a"]) and "add_embedding.linear_1" in tq["a"]
    for n, qp in jq["a"].items():
        np.testing.assert_array_equal(tq["a"][n].delta.numpy(), np.asarray(qp.delta))
        np.testing.assert_array_equal(tq["a"][n].zero_point.numpy(), np.asarray(qp.zero_point))
    (jg, jl), (tg, tl) = j_gsyn(spec, 0, False, jnp.float32), t_gsyn(spec, 0, False, torch.float32,
                                                                   device="cpu")
    assert tl == jl and set(tg["a"]) == set(jg["a"])
    assert all(isinstance(tg["a"][n], TG) for n in tl)
    assert "down_blocks.0.downsamplers.0.conv" in tl and "add_embedding.linear_1" not in tl
    for n in tl:
        assert tuple(tg["a"][n].delta_mid.shape) == tuple(jg["a"][n].delta_mid.shape)


@pytest.mark.parametrize("steps,spacing", [(1, "trailing"), (2, "trailing"), (4, "trailing"),
                                           (4, "leading")])
def test_euler_consts_exact_and_steps(steps, spacing):
    j = JSch.make_euler(steps, timestep_spacing=spacing)
    t = TSch.make_euler(steps, timestep_spacing=spacing)
    for a, b in zip(j, t):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert len(t.timesteps) == steps and len(t.sigmas) == steps + 1 and float(t.sigmas[-1]) == 0.0
    assert float(TSch.euler_init_sigma(steps, timestep_spacing=spacing)) == float(
        JSch.euler_init_sigma(steps, timestep_spacing=spacing))
    rng = np.random.RandomState(steps)
    x, e = (rng.randn(2, 8, 8, 4).astype(np.float32) * 3.0 for _ in range(2))
    for i in range(steps):
        np.testing.assert_allclose(
            TSch.euler_scale_model_input(torch.from_numpy(x), t.sigmas[i]).numpy(),
            np.asarray(JSch.euler_scale_model_input(jnp.asarray(x), j.sigmas[i])),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            TSch.euler_step(torch.from_numpy(x), torch.from_numpy(e), t.sigmas[i],
                            t.sigmas[i + 1]).numpy(),
            np.asarray(JSch.euler_step(jnp.asarray(x), jnp.asarray(e), j.sigmas[i],
                                       j.sigmas[i + 1])), rtol=0, atol=2e-6 * 3.0 * 15.0)
    xb = torch.from_numpy(x).bfloat16()
    assert TSch.euler_scale_model_input(xb, t.sigmas[0]).dtype == torch.bfloat16
    assert TSch.euler_step(xb, torch.from_numpy(e), t.sigmas[0], t.sigmas[1]).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def tiny():
    """Tiny SDXL weights drawn by the port and handed to JAX through the
    weight bridge, with the inputs of tests/test_unet_sdxl.py's shapes."""
    spec = TX.sdxl_unet_spec(BASE, CROSS, ADD_CH, DEPTHS)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    rng = np.random.RandomState(0)
    inp = dict(x=rng.randn(2, 16, 16, 4).astype(np.float32),
               ehs=rng.randn(2, 77, CROSS).astype(np.float32),
               te=rng.randn(2, BASE * 4).astype(np.float32),
               tid=np.tile(np.asarray([[128., 128., 0., 0., 128., 128.]], np.float32), (2, 1)),
               t=np.asarray([500, 500], np.int32))
    noise = [(1e-5 * rng.randn(*inp["x"].shape)).astype(np.float32) for _ in range(4)]
    return spec, tp, inp, noise


def _to_jax(params, spec):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                        params_to_numpy(params, spec), is_leaf=lambda a: a is None)


def _jax_fwd(params, spec, qstate, cfg, inp):
    fn = jax.jit(functools.partial(JX.unet_sdxl_apply, qstate=qstate, cfg=cfg))
    jp = _to_jax(params, spec)
    return lambda x: np.asarray(fn(jp, jnp.asarray(x), jnp.asarray(inp["t"]),
                                   jnp.asarray(inp["ehs"]), jnp.asarray(inp["te"]),
                                   jnp.asarray(inp["tid"])))


def _torch_fwd(params, inp, qstate, cfg, x=None):
    with torch.no_grad():
        return TX.unet_sdxl_apply(
            params, torch.from_numpy(inp["x"] if x is None else x), torch.from_numpy(inp["t"]),
            torch.from_numpy(inp["ehs"]), torch.from_numpy(inp["te"]),
            torch.from_numpy(inp["tid"]), qstate=qstate, cfg=cfg).numpy()


def test_tiny_sdxl_fp_forward(tiny):
    spec, tp, inp, _ = tiny
    assert TX._n_tr_layers(tp, "down_blocks.1.attentions.0") == 1
    assert TX._n_tr_layers(tp, "mid_block.attentions.0") == 2
    j = _jax_fwd(tp, spec, None, JQ(use_pallas_attention=True), inp)(inp["x"])
    out = _torch_fwd(tp, inp, None, TQ(use_pallas_attention=True))
    assert out.shape == (2, 16, 16, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, j, rtol=0, atol=1e-5 * max(1.0, np.abs(j).max()))
    # a scalar timestep broadcasts over the batch
    with torch.no_grad():
        one = TX.unet_sdxl_apply(tp, torch.from_numpy(inp["x"]), torch.tensor(500),
                                 torch.from_numpy(inp["ehs"]), torch.from_numpy(inp["te"]),
                                 torch.from_numpy(inp["tid"])).numpy()
    np.testing.assert_allclose(one, _torch_fwd(tp, inp, None, TQ()), rtol=0, atol=1e-5)


def test_tiny_sdxl_quantized_within_chaos(tiny, monkeypatch):
    """The SDXL-turbo policy with the int8 path on. The JAX side runs its
    attention kernels and, through the patched name, its int8 kernel in
    interpret mode."""
    spec, tp, inp, noise = tiny
    orig = JM.quantized_matmul
    monkeypatch.setattr(JM, "quantized_matmul",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True, t2i_log_quant=True,
              t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True,
              use_int8_matmul=True)
    tq, _ = t_qmw(tp, spec, TQ(**kw))
    n_packed = sum("w_q8" in p for p in tq.values())
    # every linear (proj_in / proj_out are linears here) and 1x1 shortcut
    assert n_packed == sum(1 for n, k, m in spec if k == "linear" or (k == "conv" and m[2] == 1))
    run = _jax_fwd(tq, spec, j_syn(spec, 0, False, jnp.float32), JQ(**kw), inp)
    j = run(inp["x"])
    changes = [np.abs(run(inp["x"] + n) - j) for n in noise]
    chaos, chaos_mean = max(c.max() for c in changes), max(c.mean() for c in changes)
    calls = []
    real = TL.quantized_matmul
    monkeypatch.setattr(TL, "quantized_matmul", lambda *a, **k: calls.append(1) or real(*a, **k))
    tqs = t_syn(spec, 0, False, torch.float32, device="cpu")
    out = _torch_fwd(tq, inp, tqs, TQ(**kw))
    assert len(calls) == n_packed
    fake = _torch_fwd(tq, inp, tqs, TQ(**{**kw, "use_int8_matmul": False}))
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01
    for other in (j, fake):
        err = np.abs(out - other)
        assert err.max() <= max(2 * chaos, 1e-4), (err.max(), chaos)
        assert err.mean() <= max(2 * chaos_mean, 1e-5), (err.mean(), chaos_mean)


def test_tiny_sdxl_turbo_sample_fp_and_bf16_carry(tiny):
    spec, tp, inp, _ = tiny
    jp = _to_jax(tp, spec)
    args = (inp["x"][:1], inp["ehs"][:1], inp["te"][:1], inp["tid"][:1])
    j = jax.jit(lambda lat: JS.sdxl_turbo_sample(
        jp, lat, *(jnp.asarray(a) for a in args[1:]), unet_apply=JX.unet_sdxl_apply,
        num_inference_steps=2, cfg=JQ(use_pallas_attention=True)))(jnp.asarray(args[0]))
    out = TS.sdxl_turbo_sample(tp, *(torch.from_numpy(a) for a in args),
                               unet_apply=TX.unet_sdxl_apply, num_inference_steps=2,
                               cfg=TQ(use_pallas_attention=True))
    assert tuple(out.shape) == (1, 16, 16, 4) and out.dtype == torch.float32
    scale = max(1.0, float(np.abs(np.asarray(j)).max()))
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=0, atol=1e-5 * scale)

    # bf16: the carry and every UNet input stay bf16 (sigmas are f32)
    seen = []

    def spy(params, x_in, t, ehs, **kw):
        seen.append((x_in.dtype, t.dtype, float(t[0])))
        return TX.unet_sdxl_apply(params, x_in, t, ehs, **kw)

    tb = {n: {k: None if v is None else v.bfloat16() for k, v in p.items()} for n, p in tp.items()}
    out_b = TS.sdxl_turbo_sample(tb, *(torch.from_numpy(a).bfloat16() for a in args),
                                 unet_apply=spy, num_inference_steps=2)
    assert out_b.dtype == torch.bfloat16 and bool(out_b.isfinite().all())
    assert seen == [(torch.bfloat16, torch.float32, 999.0), (torch.bfloat16, torch.float32, 499.0)]


def test_sdxl_turbo_sample_picks_time_aware_slots():
    """Timesteps are f32; the time-aware slot takes int(t): 999 -> slot 0,
    499 -> slot 1 at two steps. Step counts that do not divide 1000 are
    rejected."""
    seen = []

    def fake_unet(params, x_in, t, ehs, text_embeds, time_ids, qstate, cfg):
        seen.append(float(qstate["a"]["L"].delta))
        return torch.zeros_like(x_in)

    qs = {"a": {"L": TL.QParams(torch.tensor([1.0, 2.0]), torch.tensor([0.0, 0.0]))}, "sm": {}}
    x = torch.ones(1, 4, 4, 4)
    out = TS.sdxl_turbo_sample({}, x, None, None, None, fake_unet, num_inference_steps=2,
                               qstate=qs, time_aware=True)
    assert seen == [1.0, 2.0]
    # eps = 0 leaves the latents at their initial scaling by sigma_max
    np.testing.assert_allclose(out.numpy(), float(TSch.make_euler(2).sigmas[0]), rtol=1e-6)
    with pytest.raises(ValueError, match="dividing 1000"):
        TS.sdxl_turbo_sample({}, x, None, None, None, fake_unet, num_inference_steps=3,
                             qstate=qs, time_aware=True)


def test_sdxl_vae_scale_and_decode():
    assert TV.SDXL_VAE_SCALE == JV.SDXL_VAE_SCALE == 0.13025
    tv = TV.init_vae_decoder(torch.Generator().manual_seed(4), "cpu", base=32)
    jv = jax.tree.map(jnp.asarray, params_to_numpy(tv, JV.vae_decoder_spec(base=32)))
    lat = np.random.RandomState(2).randn(1, 8, 8, 4).astype(np.float32)
    out = TV.vae_decode(tv, torch.from_numpy(lat), scale=TV.SDXL_VAE_SCALE).numpy()
    j = np.asarray(JV.vae_decode(jv, jnp.asarray(lat), scale=JV.SDXL_VAE_SCALE))
    assert out.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(out, j, rtol=0, atol=1e-3)
    assert np.abs(out - TV.vae_decode(tv, torch.from_numpy(lat)).numpy()).max() > 1e-3


def test_sdxl_turbo_sample_capture_matches_jax(tiny):
    """capture=True returns the final latents and every step's UNet input,
    (x_in (steps, B, H, W, 4), timesteps (steps,) f32), as the JAX sampler's
    scan stacks them. Tolerance: the fp sample's, 1e-5 of the largest
    magnitude."""
    spec, tp, inp, _ = tiny
    jp = _to_jax(tp, spec)
    args = (inp["x"][:1], inp["ehs"][:1], inp["te"][:1], inp["tid"][:1])
    jx, (jin, jt) = jax.jit(lambda lat: JS.sdxl_turbo_sample(
        jp, lat, *(jnp.asarray(a) for a in args[1:]), unet_apply=JX.unet_sdxl_apply,
        num_inference_steps=2, cfg=JQ(use_pallas_attention=True), capture=True))(
            jnp.asarray(args[0]))
    x, (x_in, t) = TS.sdxl_turbo_sample(tp, *(torch.from_numpy(a) for a in args),
                                        unet_apply=TX.unet_sdxl_apply, num_inference_steps=2,
                                        cfg=TQ(use_pallas_attention=True), capture=True)
    assert tuple(x_in.shape) == np.asarray(jin).shape == (2, 1, 16, 16, 4)
    assert t.dtype == torch.float32 and np.asarray(jt).dtype == np.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    for mine, ref in ((x, jx), (x_in, jin)):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-5 * scale)
    plain = TS.sdxl_turbo_sample(tp, *(torch.from_numpy(a) for a in args),
                                 unet_apply=TX.unet_sdxl_apply, num_inference_steps=2,
                                 cfg=TQ(use_pallas_attention=True))
    assert torch.equal(plain, x)
