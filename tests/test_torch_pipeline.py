"""The ported slices as a whole, against the JAX package: DDIM and PNDM
constants and steps, the time-aware slot map, and a tiny sd_sample (2 DDIM
steps, CFG, time-aware qstate with 2 slots; g=1 and the g=8 flagship
configuration) followed by a tiny vae_decode.

Tolerances:
  * DDIM constants: exact (the same numpy math); ddim_step: atol 1e-6 (f32
    elementwise in the same order).
  * fp sample + decode: atol 1e-3 (the UNet's summation-order differences,
    carried through two steps and the decoder).
  * PNDM: constants exact; a 4-step fp PNDM sd_sample (5 UNet calls, no
    decoder): 1e-5 of the latents' largest magnitude (the fp UNet's
    summation-order differences, about 1e-6 relative a call, amplified by
    CFG 7.5 and carried through the linear multistep update).
  * quantized sample + decode: the chaos bound of
    tests/test_packed_in_model.py, err <= max(5 * chaos, 1e-4), with chaos
    measured on the JAX side under a 1e-6 perturbation of the latents (the
    largest of eight draws: a single draw is heavy-tailed, measured from
    5e-6 to 0.34 on the same tiny sampler).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.models.qconfig import QConfig as JQ  # noqa: E402
from dgq_tpu.models.unet_sd import sd_unet_spec  # noqa: E402
from dgq_tpu.pipeline import sampler as JS, schedulers as JSch, vae as JV  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_group_qstate as j_gsyn  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import quantize_model_weights as t_qmw  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy, qstate_from_numpy  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models.qconfig import GroupQParams as TG, QConfig as TQ  # noqa: E402
from dgq_tpu_torch.pipeline import sampler as TS, schedulers as TSch, vae as TV  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate as t_gsyn  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402

STEPS = 2


@pytest.mark.parametrize("steps", [1, 2, 10, 50])
def test_ddim_consts_and_step(steps):
    j, t = JSch.make_ddim(steps), TSch.make_ddim(steps)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rng = np.random.RandomState(steps)
    x, e = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    i = steps - 1
    np.testing.assert_allclose(
        TSch.ddim_step(torch.from_numpy(x), torch.from_numpy(e), t.alpha_t[i],
                       t.alpha_prev[i]).numpy(),
        np.asarray(JSch.ddim_step(jnp.asarray(x), jnp.asarray(e), j.alpha_t[i],
                                  j.alpha_prev[i])), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(TSch.sd_alphas_cumprod(), JSch.sd_alphas_cumprod())


def test_ddim_step_keeps_bf16_carry():
    x = torch.randn(1, 4, 4, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    c = TSch.make_ddim(10)
    assert TSch.ddim_step(x, x.float(), c.alpha_t[0], c.alpha_prev[0]).dtype == torch.bfloat16


def test_time_slots_and_rejection():
    for steps in (2, 10, 50):
        for t in np.asarray(JSch.make_ddim(steps).timesteps):
            assert TS.timestep_slot(int(t), steps) == int(JS.timestep_slot(jnp.asarray(t), steps))
    with pytest.raises(ValueError, match="dividing 1000"):
        TS.check_time_aware_steps(30, True, {"a": {}})
    TS.check_time_aware_steps(30, False, {"a": {}})
    with pytest.raises(ValueError, match="dividing 1000"):
        TS.sd_sample({}, torch.zeros(1, 8, 8, 4), torch.zeros(1, 77, 64),
                     torch.zeros(1, 77, 64), num_inference_steps=30, qstate={"a": {}},
                     time_aware=True)
    with pytest.raises(ValueError, match="unknown scheduler"):
        TS.sd_sample({}, torch.zeros(1, 8, 8, 4), torch.zeros(1, 77, 64),
                     torch.zeros(1, 77, 64), scheduler="plms")
    qs = t_syn(sd_unet_spec(base=32, cross=64), 3, True, torch.float32, device="cpu")
    name = next(iter(qs["a"]))
    qs["a"][name] = qs["a"][name]._replace(delta=torch.tensor([1.0, 2.0, 3.0]))
    assert float(TS.select_time_qstate(qs, 501, 2)["a"][name].delta) == 1.0
    assert float(TS.select_time_qstate(qs, 1, 2)["a"][name].delta) == 2.0


@pytest.fixture(scope="module")
def slice_setup():
    """Tiny UNet and VAE weights drawn by the port and handed to JAX through
    the weight bridge (the JAX package's per-layer init and folding cost a
    minute of dispatch on the CPU; folding is bit-identical, see
    test_torch_quant.py)."""
    spec = sd_unet_spec(base=32, cross=64)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    tv = TV.init_vae_decoder(torch.Generator().manual_seed(4), "cpu", base=32)
    jv = jax.tree.map(jnp.asarray, params_to_numpy(tv, JV.vae_decoder_spec(base=32)))
    rng = np.random.RandomState(1)
    lat = rng.randn(1, 8, 8, 4).astype(np.float32)
    ehs_t = rng.randn(1, 77, 64).astype(np.float32)
    ehs_u = rng.randn(1, 77, 64).astype(np.float32)
    noise = [(1e-6 * rng.randn(*lat.shape)).astype(np.float32) for _ in range(8)]
    return spec, tp, tv, jv, lat, ehs_t, ehs_u, noise


def _jax_run(tp, spec, jv, ehs_t, ehs_u, qstate, cfg, steps=STEPS, scheduler="ddim"):
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp, spec))

    @jax.jit
    def run(lat):
        x = JS.sd_sample(jp, lat, jnp.asarray(ehs_t), jnp.asarray(ehs_u),
                         num_inference_steps=steps, scheduler=scheduler, guidance_scale=7.5,
                         qstate=qstate, cfg=cfg, time_aware=qstate is not None)
        return JV.vae_decode(jv, x)
    return lambda lat: np.asarray(run(jnp.asarray(lat)))


def _torch_run(tp, tv, lat, ehs_t, ehs_u, qstate, cfg, steps=STEPS, scheduler="ddim"):
    x = TS.sd_sample(tp, torch.from_numpy(lat), torch.from_numpy(ehs_t),
                     torch.from_numpy(ehs_u), num_inference_steps=steps, scheduler=scheduler,
                     guidance_scale=7.5, qstate=qstate, cfg=cfg, time_aware=qstate is not None)
    return TV.vae_decode(tv, x).numpy()


def test_tiny_slice_fp(slice_setup):
    spec, tp, tv, jv, lat, ehs_t, ehs_u, _ = slice_setup
    j = _jax_run(tp, spec, jv, ehs_t, ehs_u, None, JQ(use_pallas_attention=True))(lat)
    out = _torch_run(tp, tv, lat, ehs_t, ehs_u, None, TQ(use_pallas_attention=True))
    assert out.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(out, j, rtol=0, atol=1e-3)


def test_tiny_slice_w8a8_time_aware_within_chaos(slice_setup):
    spec, tp, tv, jv, lat, ehs_t, ehs_u, noise = slice_setup
    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              use_pallas_attention=True)
    tq, _ = t_qmw(tp, spec, TQ(**kw))
    # two distinct slots, so a wrong slot pick shows up
    jqs = j_syn(spec, STEPS, True, jnp.float32)
    jqs["a"] = {n: qp._replace(delta=qp.delta * jnp.asarray([1.0, 1.5]))
                for n, qp in jqs["a"].items()}
    run = _jax_run(tq, spec, jv, ehs_t, ehs_u, jqs, JQ(**kw))
    j = run(lat)
    chaos = max(np.abs(run(lat + n) - j).max() for n in noise)
    tqs = t_syn(spec, STEPS, True, torch.float32, device="cpu")
    tqs["a"] = {n: qp._replace(delta=qp.delta * torch.tensor([1.0, 1.5]))
                for n, qp in tqs["a"].items()}
    out = _torch_run(tq, tv, lat, ehs_t, ehs_u, tqs, TQ(**kw))
    err = np.abs(out - j).max()
    assert np.isfinite(out).all()
    assert err <= max(5 * chaos, 1e-4), (err, chaos)


def test_select_time_qstate_indexes_group_params():
    spec = sd_unet_spec(base=32, cross=64)
    qs, group_layers = t_gsyn(spec, 2, True, torch.float32, device="cpu")
    name = group_layers[0]
    g = qs["a"][name]
    qs["a"][name] = TG(g.delta_mid * torch.tensor([[1.0], [3.0]]), g.zp_mid, g.delta_last,
                       g.zp_last * 0 + torch.tensor([[0.0], [7.0]]))
    first, second = (TS.select_time_qstate(qs, t, 2)["a"][name] for t in (501, 1))
    assert isinstance(first, TG) and tuple(first.delta_mid.shape) == tuple(g.delta_mid.shape[1:])
    assert float(first.delta_mid[0]) == pytest.approx(0.05)
    assert float(second.delta_mid[0]) == pytest.approx(0.15)
    assert float(first.zp_last) == 0.0 and float(second.zp_last) == 7.0
    assert tuple(second.delta_last.shape) == (1,)


def test_tiny_slice_g8_flagship_time_aware_within_chaos(slice_setup):
    """A 2-step sd_sample of the g=8 configuration (group convs by taps, log2
    real_time softmax with start_peak) and the decoder; the synthetic group
    qstate is made by the JAX package, given two distinct slots, and carried
    across by qstate_from_numpy."""
    spec, tp, tv, jv, lat, ehs_t, ehs_u, noise = slice_setup
    jqs, group_layers = j_gsyn(spec, STEPS, True, jnp.float32)
    scale = jnp.asarray([1.0, 1.5])

    def two_slots(leaf):
        if hasattr(leaf, "delta_mid"):
            return type(leaf)(leaf.delta_mid * scale[:, None], leaf.zp_mid, leaf.delta_last,
                              leaf.zp_last)
        return leaf._replace(delta=leaf.delta * scale)
    jqs["a"] = {n: two_slots(leaf) for n, leaf in jqs["a"].items()}
    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True, t2i_log_quant=True,
              t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True,
              group_conv_layers=group_layers, group_conv_impl="taps")
    tq, _ = t_qmw(tp, spec, TQ(w_bits=8, use_wq=True))
    run = _jax_run(tq, spec, jv, ehs_t, ehs_u, jqs, JQ(**kw))
    j = run(lat)
    chaos = max(np.abs(run(lat + n) - j).max() for n in noise)
    tqs = qstate_from_numpy(jax.tree.map(np.asarray, jqs), device="cpu")
    out = _torch_run(tq, tv, lat, ehs_t, ehs_u, tqs, TQ(**kw))
    err = np.abs(out - j).max()
    assert np.isfinite(out).all() and out.shape == (1, 64, 64, 3)
    assert err <= max(5 * chaos, 1e-4), (err, chaos)


@pytest.mark.parametrize("steps", [1, 2, 4, 25, 50])
def test_pndm_consts_exact(steps):
    j, t = JSch.make_pndm(steps), TSch.make_pndm(steps)
    assert len(t.timesteps) == (steps + 1 if steps > 1 else 1)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert str(b.dtype).endswith(str(np.asarray(a).dtype))


def test_pndm_plms_steps_match_jax():
    """Six chained PLMS updates on random eps: every branch of the history
    (first, repeated second, 2-, 3- and 4-term Adams-Bashforth). atol 1e-6:
    f32 elementwise in the same order."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    j, t = JSch.make_pndm(5), TSch.make_pndm(5)
    js, ts = JSch.pndm_init_state(jnp.asarray(x)), TSch.pndm_init_state(torch.from_numpy(x))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(6):
        e = rng.randn(*x.shape).astype(np.float32)
        js, jx = JSch.pndm_plms_step(js, jnp.asarray(i, jnp.int32), jx, jnp.asarray(e),
                                     j.alpha_t[i], j.alpha_prev[i])
        ts, tx = TSch.pndm_plms_step(ts, i, tx, torch.from_numpy(e), t.alpha_t[i],
                                     t.alpha_prev[i])
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
        assert ts.num_ets == int(js.num_ets)
    bf = TSch.pndm_plms_step(TSch.pndm_init_state(tx.bfloat16()), 0, tx.bfloat16(), tx,
                             t.alpha_t[0], t.alpha_prev[0])[1]
    assert bf.dtype == torch.bfloat16


def test_tiny_pndm_sample_fp(slice_setup):
    spec, tp, _, _, lat, ehs_t, ehs_u, _ = slice_setup
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp, spec))
    j = jax.jit(lambda x: JS.sd_sample(
        jp, x, jnp.asarray(ehs_t), jnp.asarray(ehs_u), num_inference_steps=4,
        scheduler="pndm", guidance_scale=7.5, cfg=JQ(use_pallas_attention=True)))(
            jnp.asarray(lat))
    out = TS.sd_sample(tp, torch.from_numpy(lat), torch.from_numpy(ehs_t),
                       torch.from_numpy(ehs_u), num_inference_steps=4, scheduler="pndm",
                       guidance_scale=7.5, cfg=TQ(use_pallas_attention=True))
    # random weights and CFG 7.5 grow the latents to size ~10 over 5 calls
    scale = max(1.0, float(np.abs(np.asarray(j)).max()))
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=0, atol=1e-5 * scale)
    ddim = TS.sd_sample(tp, torch.from_numpy(lat), torch.from_numpy(ehs_t),
                        torch.from_numpy(ehs_u), num_inference_steps=4, guidance_scale=7.5,
                        cfg=TQ(use_pallas_attention=True))
    assert float((out - ddim).abs().max()) > 1e-3  # another scheduler, another trajectory


@pytest.mark.parametrize("scheduler,steps,calls", [("ddim", 2, 2), ("pndm", 4, 5)])
def test_sd_sample_capture_and_unet_apply_match_jax(slice_setup, scheduler, steps, calls):
    """capture=True returns the final latents and every UNet call's inputs,
    (latent_model_input (calls, 2B, H, W, 4), timesteps (calls,) int32), as
    the JAX sampler's scan stacks them (PNDM makes one call more than it has
    steps); `unet_apply` is the function called for every UNet call.
    Tolerance: the fp PNDM sample's, 1e-5 of the largest magnitude."""
    spec, tp, _, _, lat, ehs_t, ehs_u, _ = slice_setup
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp, spec))
    jx, (jl, jt) = jax.jit(lambda x: JS.sd_sample(
        jp, x, jnp.asarray(ehs_t), jnp.asarray(ehs_u), num_inference_steps=steps,
        scheduler=scheduler, guidance_scale=7.5, cfg=JQ(use_pallas_attention=True),
        capture=True))(jnp.asarray(lat))
    seen = []

    def spy(params, lmi, t, ehs, **kw):
        seen.append(int(t[0]))
        return TU.unet_sd_apply(params, lmi, t, ehs, **kw)

    x, (lmi, t) = TS.sd_sample(tp, torch.from_numpy(lat), torch.from_numpy(ehs_t),
                               torch.from_numpy(ehs_u), num_inference_steps=steps,
                               scheduler=scheduler, guidance_scale=7.5,
                               cfg=TQ(use_pallas_attention=True), unet_apply=spy, capture=True)
    assert tuple(lmi.shape) == np.asarray(jl).shape == (calls, 2, 8, 8, 4)
    assert t.dtype == torch.int32 and np.asarray(jt).dtype == np.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert seen == [int(v) for v in np.asarray(jt)]
    for mine, ref in ((x, jx), (lmi, jl)):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-5 * scale)
    # the first call's input is the noise, doubled for CFG
    np.testing.assert_array_equal(lmi[0].numpy(), np.concatenate([lat, lat]))
    # without capture: the latents alone, the same numbers
    plain = TS.sd_sample(tp, torch.from_numpy(lat), torch.from_numpy(ehs_t),
                         torch.from_numpy(ehs_u), num_inference_steps=steps, scheduler=scheduler,
                         guidance_scale=7.5, cfg=TQ(use_pallas_attention=True))
    assert torch.equal(plain, x)


def test_sd_sample_calls_the_given_unet_apply():
    """A stand-in UNet that predicts zero noise replaces unet_sd_apply on
    every call: DDIM then only rescales the latents."""
    calls = []

    def zero_unet(params, lmi, t, ehs, qstate, cfg):
        calls.append(tuple(lmi.shape))
        return torch.zeros_like(lmi)

    x = torch.ones(1, 4, 4, 4)
    out, (lmi, t) = TS.sd_sample({}, x, torch.zeros(1, 77, 8), torch.zeros(1, 77, 8),
                                 num_inference_steps=2, unet_apply=zero_unet, capture=True)
    assert calls == [(2, 4, 4, 4)] * 2 and tuple(lmi.shape) == (2, 2, 4, 4, 4)
    consts = TSch.make_ddim(2)
    want = float(torch.sqrt(consts.alpha_prev[-1] / consts.alpha_t[0]))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)
