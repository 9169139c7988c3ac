"""AdaRound's deploy half in the port (`dgq_tpu_torch/quant/adaround.py` and
`calib.weight_calib.fold_weight_quant(alphas=, soft=)`) against the JAX
package on the same numpy inputs: f32 conv and linear weights of a tiny SD
UNet, per-out-channel minmax scales, offsets from `adaround_init_alpha`
perturbed by a seeded normal so that both signs of alpha occur.

Hard rounding (the deploy fold) equals the JAX package bit for bit. Soft
rounding goes through a sigmoid, 1 / (1 + exp(-alpha)) in both packages, and
the CPU exponentials of XLA and PyTorch differ in the last bits for about one
input in a thousand, which moves a soft target by at most 2^-22
(`test_soft_targets_differ_only_in_the_exponential`). So the soft fold is
held to that: floor(w/delta) + target + zp rounds once on each side at a unit
of at most 2^-19 (its magnitude stays under 32 at 4 bits), so the two folds
lie within delta (2^-22 + 2 * 2^-19) < delta 2^-17 of each other.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.calib import weight_calib as j_wc  # noqa: E402
from dgq_tpu.models import qconfig as j_qc  # noqa: E402
from dgq_tpu.models.unet_sd import init_unet_sd as j_init, sd_unet_spec as j_spec  # noqa: E402
from dgq_tpu.quant import adaround as j_ada  # noqa: E402
from dgq_tpu_torch.calib import weight_calib as t_wc  # noqa: E402
from dgq_tpu_torch.io.convert import conv_w_to_torch, params_from_numpy  # noqa: E402
from dgq_tpu_torch.models import qconfig as t_qc  # noqa: E402
from dgq_tpu_torch.quant import adaround as t_ada  # noqa: E402
from dgq_tpu_torch.quant.affine import QParams  # noqa: E402


def _spec():
    """Every kind of quantized layer (3x3, 1x1 and strided convs, linears with
    and without bias, the excluded conv_in / conv_out) of the tiny UNet."""
    spec = j_spec(base=32, cross=64)
    return spec[:5] + [e for e in spec if e[0].startswith((
        "down_blocks.0.resnets.0.", "down_blocks.0.attentions.0.", "down_blocks.0.downsamplers"))]


def _to_torch_layout(a, kind):
    a = np.asarray(a)
    return np.ascontiguousarray(conv_w_to_torch(a) if kind == "conv" else a.T)


@pytest.fixture(scope="module")
def model():
    """The tiny model on both sides, each side's minmax scales, and offsets
    in each side's layout: JAX's init from the remainder plus a seeded normal
    of spread 2, so that rounding goes up and down in every layer."""
    spec = _spec()
    jp = j_init(jax.random.PRNGKey(0), spec=spec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")
    jw = j_wc.init_weight_qparams(jp, spec, 4)
    tw = t_wc.init_weight_qparams(tp, spec, 4)
    rng = np.random.default_rng(7)
    j_alphas, t_alphas = {}, {}
    for name, kind, _ in spec:
        if kind not in ("conv", "linear"):
            continue
        a = np.asarray(j_ada.adaround_init_alpha(jp[name]["w"], jw[name].delta))
        a = (a + 2.0 * rng.standard_normal(a.shape)).astype(np.float32)
        j_alphas[name] = jnp.asarray(a)
        t_alphas[name] = torch.from_numpy(_to_torch_layout(a, kind))
    return spec, jp, tp, jw, tw, j_alphas, t_alphas


def _np(t):
    return t.detach().numpy()


def _fold_both(model, soft, drop=()):
    spec, jp, tp, jw, tw, ja, ta = model
    ja = {k: v for k, v in ja.items() if k not in drop}
    ta = {k: v for k, v in ta.items() if k not in drop}
    jq = j_wc.fold_weight_quant(jp, jw, spec, j_qc.QConfig(w_bits=4, use_wq=True), ja, soft=soft)
    tq = t_wc.fold_weight_quant(tp, tw, spec, t_qc.QConfig(w_bits=4, use_wq=True), ta, soft=soft)
    return params_from_numpy(jax.tree.map(np.asarray, jq), spec, device="cpu"), tq


def test_offsets_take_both_signs(model):
    ta = model[-1]
    assert len(ta) >= 8
    for a in ta.values():
        assert bool((a >= 0).any()) and bool((a < 0).any())


def test_init_alpha_matches_jax(model):
    """The port's init from the rounding remainder on the same weights and
    scales: the log of a quotient, equal to the JAX init within its ulps."""
    spec, jp, tp, jw, tw, _, _ = model
    for name, kind, _ in spec:
        if kind not in ("conv", "linear"):
            continue
        want = _to_torch_layout(j_ada.adaround_init_alpha(jp[name]["w"], jw[name].delta), kind)
        got = _np(t_ada.adaround_init_alpha(tp[name]["w"], tw[name].delta))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits,symmetric", [(4, False), (8, False), (4, True)])
def test_hard_adaround_quant_is_bit_identical(model, bits, symmetric):
    spec, jp, tp, jw, tw, ja, ta = model
    for name, kind, _ in spec:
        if name not in ta:
            continue
        j = j_ada.adaround_quant(jp[name]["w"], jw[name], ja[name], bits, symmetric, soft=False)
        t = t_ada.adaround_quant(tp[name]["w"], QParams(tw[name].delta, tw[name].zero_point),
                                 ta[name], bits, symmetric, soft=False)
        np.testing.assert_array_equal(_np(t), _to_torch_layout(j, kind), err_msg=name)


def test_soft_targets_differ_only_in_the_exponential(model):
    """The soft targets of the two packages differ by at most 2^-22 (two ulps
    of the sigmoid near 1, stretched by 1.2), in under 1% of the inputs, and
    only where the sigmoid's exponential does: the rest of the arithmetic
    (the affine stretch and the clip) is the same."""
    rng = np.random.default_rng(3)
    a = (4.0 * rng.standard_normal(200_000)).astype(np.float32)
    j = np.asarray(j_ada.adaround_soft_targets(jnp.asarray(a)))
    t = _np(t_ada.adaround_soft_targets(torch.from_numpy(a)))
    assert float(np.abs(j - t).max()) <= 2.0 ** -22
    assert (j != t).mean() < 0.01
    # fed JAX's sigmoid, the port's stretch and clip give JAX's targets bit for bit
    sig = torch.from_numpy(np.array(jax.nn.sigmoid(jnp.asarray(a))))
    mine = torch.clamp(sig * (t_ada.ZETA - t_ada.GAMMA) + t_ada.GAMMA, 0.0, 1.0)
    np.testing.assert_array_equal(_np(mine), j)


def test_soft_adaround_quant_matches_jax(model):
    spec, jp, tp, jw, tw, ja, ta = model
    for name, kind, _ in spec:
        if name not in ta:
            continue
        j = _to_torch_layout(j_ada.adaround_quant(jp[name]["w"], jw[name], ja[name], 4), kind)
        t = _np(t_ada.adaround_quant(tp[name]["w"], tw[name], ta[name], 4))
        delta = _np(tw[name].delta) * np.ones_like(t)
        assert bool((np.abs(t - j) <= 2.0 ** -17 * delta).all()), name


@pytest.mark.parametrize("soft", [False, True])
def test_fold_weight_quant_with_alphas_matches_jax(model, soft):
    """The deploy fold (hard) equals the JAX fold bit for bit on every leaf;
    the soft fold within the exponential's bits; conv_in / conv_out keep their
    float weights either way."""
    spec, _, tp, tw = model[0], model[1], model[2], model[4]
    expect, got = _fold_both(model, soft)
    for name, kind, _ in spec:
        for leaf, val in expect[name].items():
            if val is None:
                assert got[name][leaf] is None
            elif soft and leaf == "w" and name in model[-1]:
                delta = _np(tw[name].delta) * np.ones(val.shape, dtype=np.float32)
                assert bool((np.abs(_np(got[name][leaf]) - _np(val)) <= 2.0 ** -17 * delta).all())
            else:
                assert torch.equal(got[name][leaf], val), (name, leaf)
    assert torch.equal(got["conv_in"]["w"], tp["conv_in"]["w"])
    # learned rounding moved weights off the nearest-rounding fold
    nearest = t_wc.fold_weight_quant(tp, tw, spec, t_qc.QConfig(w_bits=4, use_wq=True))
    moved = [n for n in model[-1] if n not in t_wc.EXCLUDED_LAYERS
             and not torch.equal(nearest[n]["w"], got[n]["w"])]
    assert len(moved) >= len(model[-1]) - len(t_wc.EXCLUDED_LAYERS)


def test_a_layer_without_offsets_takes_nearest_rounding(model):
    """A layer absent from `alphas` folds with `fake_quant`, on both sides."""
    spec, _, tp, tw, _, _, ta = model[0], model[1], model[2], model[4], None, None, model[-1]
    dropped = [n for n in ta if n not in t_wc.EXCLUDED_LAYERS][:3]
    expect, got = _fold_both(model, False, drop=dropped)
    nearest = t_wc.fold_weight_quant(tp, tw, spec, t_qc.QConfig(w_bits=4, use_wq=True))
    for name in dropped:
        assert torch.equal(got[name]["w"], nearest[name]["w"])
        assert torch.equal(got[name]["w"], expect[name]["w"])
    kept = next(n for n in ta if n not in dropped and n not in t_wc.EXCLUDED_LAYERS)
    assert not torch.equal(got[kept]["w"], nearest[kept]["w"])
    assert torch.equal(got[kept]["w"], expect[kept]["w"])
