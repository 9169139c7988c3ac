"""SD3 medium through the port (`models.mmdit_sd3`, `pipeline.sampler.sd3_sample`,
`pipeline.vae` in its 16-channel form, `SD3Pipeline`, `prepare_pipeline("sd3")`,
`io.convert.hf_sd3_transformer_to_params`) against the plain reference
`tests/sd3_reference.py`, on a tiny MMDiT with seeded random weights: 3 blocks
(so the last block's text-free form is in it), width 64, heads of 32, 16
latent channels, 16 x 16 latents, 77 + 8 text tokens.

Tolerances and why:
  * unquantized forward, 1e-4 relative: the port forms the timestep's
    sinusoid in f32 from arguments up to 1000 rad reduced mod 2 pi, the
    reference in f64 (about 5e-6 here); every other difference is f32
    rounding;
  * W4A8 g=8 forward, 1e-4 relative: the same, where an A8 code that flips
    on a last-bit difference moves its element by one step; the reference
    in bfloat16 lies above 1e-3, so the bound tells the precision apart;
  * the sampler's sigmas and timesteps to 1e-6 relative (two f64 roundings of
    the spacing before the f32 cast), the slot map exactly;
  * the decode, 1e-5 relative (f32 rounding of the convs and one attention).
"""
import dataclasses

import numpy as np
import pytest
import torch

import sd3_reference as R
from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
from dgq_tpu_torch.io.convert import hf_sd3_transformer_to_params, params_to_torch_unet
from dgq_tpu_torch.models import mmdit_sd3 as M
from dgq_tpu_torch.models.qconfig import GroupQParams, QConfig, joint_act_sites
from dgq_tpu_torch.pipeline import prepare as TP, sampler as TS, schedulers as TSCH
from dgq_tpu_torch.pipeline import sd_pipeline as TSP, vae as TV
from dgq_tpu_torch.pipeline.sampler import select_slot_qstate
from dgq_tpu_torch.utils.synthetic import synthetic_mmdit_qstate

GEO = {"head_dim": 32, "sample_size": 16, "pos_embed_max_size": 24}
REF_GEO = {"head_dim": 32, "sample_size": 16, "pos_max": 24}
TEXT = 77 + 8
CFG = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, t2i_log_quant=True,
              t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True)
TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    spec = M.mmdit_sd3_spec(layers=3, heads=2, head_dim=32, joint_dim=96, pooled_dim=48,
                            freq_dim=32)
    params = M.init_mmdit_sd3(torch.Generator().manual_seed(0), "cpu", spec)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 16, generator=g)
    t = torch.tensor([987.4, 110.9])
    ehs = torch.randn(2, TEXT, 96, generator=g)
    ehs[:, :77, 48:] = 0.0  # the CLIP rows' padding, as the pipeline pads them
    pooled = torch.randn(2, 48, generator=g)
    folded, _ = quantize_model_weights(params, M.quantized_spec(spec), CFG)
    qs = synthetic_mmdit_qstate(spec, 28, device="cpu")
    return spec, params, folded, qs, (x, t, ehs, pooled)


def _ref_act(qstate):
    return {n: ((v.delta_last, v.zp_last) if isinstance(v, GroupQParams)
                else (v.delta, v.zero_point)) for n, v in qstate["a"].items()}


def _bf16(params):
    return {n: {k: v.to(torch.bfloat16) if torch.is_tensor(v) else v for k, v in p.items()}
            for n, p in params.items()}


def test_spec_is_sd3_medium_at_published_widths():
    spec = M.mmdit_sd3_spec()
    n = sum(m[0] * m[1] * m[2] * m[3] + m[1] if k == "conv" else m[0] * m[1] + m[1]
            for _, k, m in spec)
    assert n == 2_028_328_000
    names = {s[0] for s in spec}
    assert "transformer_blocks.23.attn.to_add_out" not in names
    assert "transformer_blocks.22.attn.to_add_out" in names
    assert "transformer_blocks.23.ff_context.net.2" not in names
    assert dict((s[0], s[2]) for s in spec)["transformer_blocks.23.norm1_context.linear"] == \
        (1536, 3072, True)
    sites = joint_act_sites(spec)
    assert "proj_out" not in sites and "pos_embed.proj" not in sites
    assert sum(s.endswith(".aqtizer_k") for s in sites) == 24
    # the reference's own lists, written from the published configs
    assert spec == R.mmdit_spec() and sites == R.act_sites(R.mmdit_spec())
    assert TV.vae_decoder_spec(latent_channels=16, post_quant_conv=False) == R.vae_spec()


def test_forward_unquantized_matches_reference(tiny):
    _, params, _, _, (x, t, ehs, pooled) = tiny
    out = M.mmdit_sd3_apply(params, x, t, ehs, pooled, **GEO)
    with R.strict_f32():
        ref = R.MMDiT(params, R.Policy(), **REF_GEO)(x, t, ehs, pooled)
    assert out.shape == x.shape and R.rel_gap(out, ref) < TOL


def test_forward_w4a8_g8_matches_reference_and_not_bfloat16(tiny):
    spec, params, folded, qs, (x, t, ehs, pooled) = tiny
    q = select_slot_qstate(qs, 5)
    out = M.mmdit_sd3_apply(folded, x, t, ehs, pooled, qstate=q, cfg=CFG, **GEO)
    pol = R.Policy(act=_ref_act(q), log2_real_time=True, start_peak=True)
    ref_params = R.fold(params)
    with R.strict_f32():
        ref = R.MMDiT(ref_params, pol, **REF_GEO)(x, t, ehs, pooled)
        ref16 = R.MMDiT(_bf16(ref_params), pol, dt=torch.bfloat16, **REF_GEO)(x, t, ehs, pooled)
    assert R.rel_gap(out, ref) < TOL
    assert R.rel_gap(ref16, ref) > 10 * TOL
    # the quantizers act: the float forward lies far away
    assert R.rel_gap(M.mmdit_sd3_apply(params, x, t, ehs, pooled, **GEO), ref) > 1e-2
    # the reference's own fold is the port's
    for name, _, _ in M.quantized_spec(spec):
        assert torch.equal(folded[name]["w"], ref_params[name]["w"]), name


def test_text_first_start_peak_is_the_references_key_after_the_image(tiny):
    """The port puts CLIP's start token at key 0 (text first); the reference
    keeps diffusers' [image; text] and spares key T. They agree, and a
    reference that spares no key, or the wrong one, does not."""
    _, params, folded, qs, (x, t, ehs, pooled) = tiny
    ehs = ehs.clone()
    ehs[:, 0] = 4.0  # a start-token row that draws the attention, as CLIP's does
    q = select_slot_qstate(qs, 0)
    out = M.mmdit_sd3_apply(folded, x, t, ehs, pooled, qstate=q, cfg=CFG, **GEO)
    with R.strict_f32():
        model = R.MMDiT(R.fold(params), R.Policy(act=_ref_act(q), log2_real_time=True,
                                                 start_peak=True), **REF_GEO)
        ref = model(x, t, ehs, pooled)
        model.pol = dataclasses.replace(model.pol, start_peak=False)
        no_peak = model(x, t, ehs, pooled)
    assert R.rel_gap(out, ref) < TOL
    assert R.rel_gap(no_peak, ref) > 10 * TOL
    b, n, d = 4, 64 + TEXT, 32
    g = torch.Generator().manual_seed(3)
    qq, kk, vv = (torch.randn(b, n, d, generator=g) for _ in range(3))
    kk[:, 64] *= 6.0
    core = R.attention_core(qq, kk, vv, d ** -0.5, True, 8, peak_col=64)
    wrong = R.attention_core(qq, kk, vv, d ** -0.5, True, 8, peak_col=0)
    assert R.rel_gap(wrong, core) > 10 * TOL


def test_flow_sigmas_and_timesteps():
    consts = TSCH.make_flow_match(28, 3.0)
    sig, ts = R.flow_sigmas(28, 3.0)
    assert consts.sigmas.shape == (29,) and consts.timesteps.shape == (28,)
    assert torch.allclose(consts.sigmas, sig, rtol=1e-6, atol=0)
    assert torch.allclose(consts.timesteps, ts, rtol=1e-6, atol=0)
    assert float(consts.sigmas[0]) == 1.0 and float(consts.sigmas[-1]) == 0.0
    s = 3.0 * 0.001 / (1 + 2.0 * 0.001)
    assert abs(float(consts.sigmas[-2]) - 3 * s / (1 + 2 * s)) < 1e-6
    assert bool((consts.sigmas[1:] < consts.sigmas[:-1]).all())


def test_one_cfg_step_matches_reference(tiny):
    _, params, folded, qs, (x, _, ehs, pooled) = tiny
    lat, e, p = x[:1], ehs[:1], pooled[:1]
    eu, pu = torch.randn(1, TEXT, 96), torch.randn(1, 48)

    def apply(*a, **kw):
        return M.mmdit_sd3_apply(*a, **kw, **GEO)

    out = TS.sd3_sample(folded, lat, e, p, eu, pu, apply, num_inference_steps=1,
                        guidance_scale=7.0, qstate=qs, cfg=CFG, time_aware=True)
    pol = R.Policy(act=_ref_act(select_slot_qstate(qs, 0)), log2_real_time=True,
                   start_peak=True)
    with R.strict_f32():
        model = R.MMDiT(R.fold(params), pol, **REF_GEO)
        ref = R.sample(lambda i: model, lat, e, p, eu, pu, steps=1)
    sig, ts = R.flow_sigmas(1)
    assert float(ts[0]) == 1000.0 and float(sig[1]) == 0.0
    assert R.rel_gap(out, ref) < TOL


def test_slots_go_by_step_index_at_28_steps(tiny):
    spec, _, folded, qs, (x, _, ehs, pooled) = tiny
    seen = []

    def spy(params, lmi, tt, e, p, qstate=None, cfg=None):
        seen.append(float(qstate["a"]["context_embedder"].delta_last[0]))
        return torch.zeros_like(lmi)

    TS.sd3_sample(folded, x[:1], ehs[:1], pooled[:1], ehs[:1], pooled[:1], spy,
                  num_inference_steps=28, qstate=qs, cfg=CFG, time_aware=True)
    want = qs["a"]["context_embedder"].delta_last[:, 0].tolist()
    assert seen == want and len(set(seen)) == 28
    with pytest.raises(ValueError, match="28 slots"):
        TS.sd3_sample(folded, x[:1], ehs[:1], pooled[:1], ehs[:1], pooled[:1], spy,
                      num_inference_steps=28, qstate=select_slot_qstate(qs, slice(0, 27)),
                      cfg=CFG, time_aware=True)
    # the UNet samplers keep the reference's slot map, which 28 steps do not divide
    with pytest.raises(ValueError, match="dividing 1000"):
        TS.check_time_aware_steps(28, True, qs)
    assert TS.timestep_slot(749, 4) == 1


def test_decode_16_channels_with_shift():
    spec = TV.vae_decoder_spec(base=32, latent_channels=16, post_quant_conv=False)
    assert all(n != "post_quant_conv" for n, _, _ in spec)
    params = TV.init_vae_decoder(torch.Generator().manual_seed(4), "cpu", base=32,
                                 latent_channels=16, post_quant_conv=False)
    lat = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(5))
    out = TV.vae_decode(params, lat, scale=TV.SD3_VAE_SCALE, shift=TV.SD3_VAE_SHIFT)
    with R.strict_f32():
        ref = R.vae_decode(params, lat)
    assert out.shape == (2, 64, 64, 3) and R.rel_gap(out, ref) < 1e-5
    assert R.rel_gap(TV.vae_decode(params, lat, scale=TV.SD3_VAE_SCALE), ref) > 1e-3


def test_sd3_key_mapping_on_a_synthetic_state_dict(tiny):
    spec, params, _, _, _ = tiny
    state = params_to_torch_unet(params, spec)
    state["pos_embed.pos_embed"] = torch.zeros(1, 24 * 24, 64)
    got = hf_sd3_transformer_to_params({k: v.numpy() for k, v in state.items()}, device="cpu")
    assert set(got) == {n for n, _, _ in spec}
    for name in got:
        assert torch.equal(got[name]["w"], params[name]["w"]), name
        assert torch.equal(got[name]["b"], params[name]["b"]), name
    state["transformer_blocks.0.attn.norm_q.weight"] = torch.ones(32)
    with pytest.raises(KeyError, match="norm_q"):
        hf_sd3_transformer_to_params(state, device="cpu")


def test_prepare_pipeline_sd3_generates_from_embeddings(tiny, tmp_path):
    spec, params, _, _, (_, _, ehs, pooled) = tiny
    (tmp_path / "transformer").mkdir()
    (tmp_path / "vae").mkdir()
    torch.save(params_to_torch_unet(params, spec),
               tmp_path / "transformer" / "diffusion_pytorch_model.bin")
    vspec = TV.vae_decoder_spec(base=32, latent_channels=16, post_quant_conv=False)
    vae = TV.init_vae_decoder(torch.Generator().manual_seed(6), "cpu", base=32,
                              latent_channels=16, post_quant_conv=False)
    torch.save(params_to_torch_unet(vae, vspec), tmp_path / "vae" / "diffusion_pytorch_model.bin")
    pipe = TP.prepare_pipeline("sd3", str(tmp_path), device="cpu")
    assert isinstance(pipe, TSP.SD3Pipeline) and "post_quant_conv" not in pipe.vae_params
    pipe.geometry = dict(GEO)
    with pytest.raises(RuntimeError, match="text encoders"):
        pipe.encode_prompts(["a cat"])
    images = pipe.generate_from_embeddings(ehs, pooled, ehs, pooled, steps=2, height=128,
                                           width=128, seed=3)
    assert images.shape == (2, 128, 128, 3) and images.dtype == np.uint8
    with pytest.raises(FileNotFoundError):
        TP.prepare_pipeline("sd3", str(tmp_path / "none"), device="cpu")
