"""The benchmark's plain reference against the port's plain path (on the
CPU the attention kernels' entry runs its plain version, and the group
convs the taps path), tiny. The reference imports nothing of the port;
these tests hand both the same inputs."""
from __future__ import annotations

import statistics

import torch

from dgqbench.harness import data
from dgqbench.reference import ops, sampling, specs
from dgqbench.reference import unet as ref

BASE, CROSS = 32, 32


def _sd(seed=7):
    spec = specs.sd_unet(BASE, CROSS)
    params = data.weights(spec, seed, "unet", "cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, 16, 4, generator=g)
    ehs = torch.randn(2, 77, CROSS, generator=g)
    return spec, params, x, torch.tensor([741, 741], dtype=torch.int32), ehs


def test_layer_lists_are_the_ports():
    from dgq_tpu_torch.models.unet_sd import sd_unet_spec
    from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec
    from dgq_tpu_torch.pipeline.vae import vae_decoder_spec

    assert specs.sd_unet() == sd_unet_spec()
    assert specs.sdxl_unet() == sdxl_unet_spec()
    assert specs.vae_decoder() == vae_decoder_spec()
    assert specs.sd_unet(BASE, CROSS) == sd_unet_spec(BASE, CROSS)


def test_float_sd_unet_matches_the_port():
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import unet_sd_apply

    _, params, x, t, ehs = _sd()
    with torch.no_grad():
        port = unet_sd_apply(params, x, t, ehs, qstate=None, cfg=QConfig())
        mine = ref.sd_unet(ref.Model(params, ref.Policy(), heads=lambda c: 8), x, t, ehs)
    assert ops.rel_gap(port, mine) < 1e-5


def test_quantized_sd_layers_match_the_ports_plain_path():
    """W4 minmax, group A8 and the log2 real-time softmax with start peak,
    each layer from the port's own input of the layer (the units run again
    alone, their layer functions watched), and the glue between them."""
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models import layers
    from dgq_tpu_torch.models.qconfig import GroupQParams, QConfig
    from dgq_tpu_torch.models.unet_sd import unet_sd_apply
    from dgq_tpu_torch.quant.affine import QParams

    from dgqbench.drivers.generate import watch_layers

    spec, params, x, t, ehs = _sd()
    groups = specs.group_conv_layers(spec)
    meta = {n: (k, m) for n, k, m in spec}
    act = data.act_quantizers(spec, 2, 7, "cpu")
    cfg = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True, group_conv_layers=tuple(groups),
                  group_conv_impl="taps", use_pallas_attention=True)
    qs = {"a": {n: (GroupQParams(d[1], z[1], torch.ones(1), torch.zeros(1)) if d.dim() == 2
                    else QParams(d[1], z[1])) for n, (d, z) in act.items()}, "sm": {}}

    def port_unit(key, ins):
        rec = []
        with watch_layers(rec):
            if ".transformer_blocks." in key:
                out = layers.basic_transformer_block(pq, key, ins[0], ins[1], 8, qs, cfg)
            elif ".resnets." in key:
                out = layers.resnet_block(pq, key, ins[0], ins[1], qs, cfg,
                                          f"{key}.conv_shortcut" in pq)
            elif meta[key][0] == "conv":
                out = layers.quant_conv2d(pq[key], ins[0], key, qs, cfg, *meta[key][1][3:])
            else:
                out = layers.quant_linear(pq[key], ins[0], key, qs, cfg)
        return rec, out

    with torch.no_grad():
        pq, _ = quantize_model_weights(params, spec, cfg)
        rec = {}
        eps = unet_sd_apply(pq, x, t, ehs, qstate=qs, cfg=cfg, record=rec)
        folded = {n: ({"w": ops.fold_weight(p["w"], 4), "b": p["b"]}
                      if "w" in p and n not in ("conv_in", "conv_out") else p)
                  for n, p in params.items()}
        pol = ref.Policy(act=data.slot(act, 1), log2_real_time=True, start_peak=True,
                         group_layers=frozenset(groups))
        m = ref.Model(folded, pol, heads=lambda c: 8)
        follow = ref.Follow(rec, m, port_unit)
        mine = ref.sd_unet(m, x, t, ehs, follow)
    kinds = {k for k, _ in follow.where}
    assert kinds == {"linear", "conv", "gn", "ln", "attn"}
    assert len(follow.layers) > 400 and follow.rerun == 0.0
    assert statistics.median(follow.layers) < 1e-6 and max(follow.layers) < 1e-2
    assert max(follow.glue) < 1e-5 and ops.rel_gap(eps, mine) < 1e-5


def test_float_sdxl_unet_matches_the_port():
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sdxl import unet_sdxl_apply

    spec = specs.sdxl_unet(BASE, CROSS, 8, (1, 1))
    params = data.weights(spec, 3, "unet", "cpu")
    g = torch.Generator().manual_seed(3)
    args = (torch.randn(2, 16, 16, 4, generator=g), torch.tensor([999.0, 249.0]),
            torch.randn(2, 77, CROSS, generator=g), torch.randn(2, 4 * BASE, generator=g),
            torch.tensor([[128.0, 128, 0, 0, 128, 128]] * 2))
    with torch.no_grad():
        port = unet_sdxl_apply(params, *args, qstate=None, cfg=QConfig())
        mine = ref.sdxl_unet(ref.Model(params, ref.Policy(), heads=lambda c: c // 32), *args)
    assert ops.rel_gap(port, mine) < 1e-5


def test_vae_decoder_matches_the_port():
    from dgq_tpu_torch.pipeline.vae import latents_to_images, vae_decode

    params = data.weights(specs.vae_decoder(32), 5, "vae", "cpu")
    z = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        port = vae_decode(params, z)
        mine = ref.vae_decode(params, z, 0.18215)
    assert ops.rel_gap(port, mine) < 1e-5
    assert (ref.to_uint8(port).numpy() == latents_to_images(port)).all()


def test_plms_matches_the_ports_sampler():
    from dgq_tpu_torch.pipeline.sampler import sd_sample

    def fake_unet(params, x, t, ehs, qstate=None, cfg=None):
        return torch.tanh(x) * 0.3 + t.float().reshape(-1, 1, 1, 1) / 1000.0 + ehs.mean()

    x0 = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    ehs = torch.randn(2, 77, 8, generator=torch.Generator().manual_seed(2))
    port = sd_sample(None, x0, ehs, ehs * 0, num_inference_steps=25, scheduler="pndm",
                     unet_apply=fake_unet)
    plms, x = sampling.PLMS(25), x0
    for t in sampling.pndm_calls(25):
        lmi = torch.cat([x, x])
        eps = fake_unet(None, lmi, torch.full((4,), t), torch.cat([ehs * 0, ehs]))
        x = plms.step(sampling.guided(eps, 7.5), t, x)
    assert ops.rel_gap(port, x) < 1e-6
    assert len(sampling.pndm_calls(25)) == 26


def test_adaround_pieces_match_the_port():
    from dgq_tpu_torch.quant import adaround as port
    from dgq_tpu_torch.calib.reconstruction import batch_indices
    from dgq_tpu_torch.quant.affine import QParams

    from dgqbench.reference import adaround

    w = torch.randn(6, 5, generator=torch.Generator().manual_seed(4))
    d, z = ops.minmax_weight_qparams(w, 4)
    a = adaround.init_alpha(w, d)
    assert torch.allclose(a, port.adaround_init_alpha(w, d))
    assert torch.equal(adaround.soft_weight(w, d, z, a, 4),
                       port.adaround_quant(w, QParams(d, z), a, 4))
    for s in (0, 19, 20, 57, 99):
        assert adaround.temperature(s, 100, 0.2) == float(
            port.linear_temp_decay(torch.tensor(float(s)), 100, 0.2))
    assert torch.equal(adaround.batch_rows((5, 2, 3), 100, 4, 64),
                       batch_indices((5, 2, 3), 100, 4, 64))
