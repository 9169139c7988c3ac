"""The benchmark's counts of operations and bytes against hand counts, and
its UNet counts against the port's own cost model at full width."""
from __future__ import annotations

import pytest

from dgqbench import costs
from dgqbench.reference import specs


def test_attention_counts_each_product_once_and_each_tensor_once():
    flops, nbytes = costs.attention(2, 3, 5, 7)
    assert flops == 2 * (2 * 3 * 5 * 7) * 2  # Q K^T and P V, 2 operations a multiply-add
    assert nbytes == 4 * (2 * 3 * 7 + 2 * 5 * 7 * 2 + 2 * 3 * 7)  # q, k, v read, o written


def test_group_conv_counts_input_weights_scales_bias_output():
    flops, nbytes = costs.group_conv(2, 4, 4, 3, 5, 3, 1)
    assert flops == 2 * 2 * 4 * 4 * 5 * 3 * 9
    assert nbytes == 4 * (2 * 16 * 3 + 9 * 3 * 5 + 2 * 9 * 3 + 5 + 2 * 16 * 5)


def test_bound_is_the_larger_of_compute_and_memory():
    assert costs.bound_s(495e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert costs.bound_s(495e12, 6.7e12) == pytest.approx(2.0)


def test_transformer_block_by_hand():
    c, t, s, b = 8, 6, 3, 2
    got = costs.block_forward_flops(specs.transformer_block("x", c, 5), t, s, b)
    macs = (4 * t * c * c + 2 * t * t * c          # self attention
            + t * c * c + 2 * s * 5 * c + t * c * c + 2 * t * s * c   # cross attention
            + t * c * 8 * c + t * 4 * c * c)        # GEGLU
    assert got == 2 * b * macs


def test_unet_counts_match_the_ports_cost_model():
    from dgq_tpu_torch.utils.flops import spec_cost

    sd = specs.sd_unet()
    assert costs.unet_forward_flops(sd, 64, 1, 77) == spec_cost(sd, latent_hw=64)["flops"]
    xl = specs.sdxl_unet()
    assert costs.unet_forward_flops(xl, 128, 1, 77) == spec_cost(xl, latent_hw=128)["flops"]
    assert costs.unet_forward_flops(sd, 64, 1, 77) == pytest.approx(0.803e12, rel=2e-3)


def test_vae_decode_by_level():
    spec = specs.vae_decoder(32)
    lat = 4
    macs = 0
    for n, k, m in spec:
        if k == "conv":
            side = {"post_quant_conv": lat, "decoder.conv_in": lat,
                    "decoder.conv_out": 8 * lat}.get(n)
            if side is None and "mid_block" in n:
                side = lat
            if side is None:
                i = int(n.split(".")[2])
                side = lat * 2 ** i * (2 if "upsamplers" in n else 1)
            macs += m[0] * m[1] * m[2] ** 2 * side * side
        elif k == "linear":
            macs += m[0] * m[1] * lat * lat
    macs += 2 * (lat * lat) ** 2 * 128
    assert costs.vae_decode_flops(spec, lat, 3) == 2 * 3 * macs


def test_parameter_counts_are_the_published_ones():
    assert specs.param_count(specs.sd_unet()) == 859520964
    assert specs.param_count(specs.sdxl_unet()) == 2567463684
