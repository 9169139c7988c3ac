"""dgq_tpu_torch quantizer core, config, weight folding and weight bridge
against the JAX package on the same numpy inputs.

Tolerance: bit-identical. The ops are the same elementwise f32 ops in the
same order, min/max reductions are order-free, and both round half to even.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.calib import act_calib as j_act  # noqa: E402
from dgq_tpu.calib import weight_calib as j_wc  # noqa: E402
from dgq_tpu.models import qconfig as j_qc  # noqa: E402
from dgq_tpu.models.unet_sd import init_unet_sd as j_init, sd_unet_spec as j_spec  # noqa: E402
from dgq_tpu.quant import affine as j_aff, log2 as j_log2, scalers as j_sc  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib import act_calib as t_act, weight_calib as t_wc  # noqa: E402
from dgq_tpu_torch.io.convert import params_from_numpy, qstate_from_numpy  # noqa: E402
from dgq_tpu_torch.models import qconfig as t_qc  # noqa: E402
from dgq_tpu_torch.models.unet_sd import init_unet_sd as TU_init  # noqa: E402
from dgq_tpu_torch.models.unet_sd import sd_unet_spec as t_spec  # noqa: E402
from dgq_tpu_torch.quant import affine as t_aff, log2 as t_log2, scalers as t_sc  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.detach().cpu().numpy())


@pytest.mark.parametrize("bits,symmetric,always_zero", [
    (8, False, False), (4, False, False), (8, True, False), (8, False, True), (6, False, False),
])
def test_fake_quant_and_bounds_bit_identical(bits, symmetric, always_zero):
    x = _rand(4, 33, seed=1, scale=3.0)
    # fractional zero point and a per-row delta exercise the shifted clip
    delta = np.abs(_rand(4, 1, seed=2)) * 0.1 + 0.01
    zp = np.round(_rand(4, 1, seed=3) * 20.0) + 0.37
    j = j_aff.fake_quant(jnp.asarray(x), j_aff.QParams(jnp.asarray(delta), jnp.asarray(zp)),
                         bits, symmetric, always_zero)
    t = t_aff.fake_quant(torch.from_numpy(x), t_aff.QParams(torch.from_numpy(delta),
                                                            torch.from_numpy(zp)),
                         bits, symmetric, always_zero)
    _same(j, t)
    assert t_aff.quant_bounds(bits, symmetric, always_zero) == j_aff.quant_bounds(
        bits, symmetric, always_zero)


def test_ste_round_value_and_gradient():
    x = torch.tensor([-2.5, -0.5, 0.5, 1.5, 2.49, 3.7], requires_grad=True)
    y = t_aff.ste_round(x)
    _same(j_aff.ste_round(jnp.asarray(x.detach().numpy())), y)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


@pytest.mark.parametrize("bits", [4, 8])
def test_log2_quantizers_bit_identical(bits):
    logits = _rand(2, 16, 40, seed=4, scale=3.0)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    delta = np.float32(0.37)
    _same(j_log2.log2_fake_quant(jnp.asarray(p), jnp.asarray(delta), bits),
          t_log2.log2_fake_quant(torch.from_numpy(p), torch.tensor(delta), bits))
    _same(j_log2.log2_real_time_quant(jnp.asarray(p), bits),
          t_log2.log2_real_time_quant(torch.from_numpy(p), bits))


@pytest.mark.parametrize("symmetric,always_zero", [(False, False), (True, False), (False, True)])
def test_minmax_scalers_bit_identical(symmetric, always_zero):
    x = _rand(8, 5, 3, 3, seed=5)
    j = j_sc.minmax_scale(jnp.asarray(x), 256, symmetric, always_zero)
    t = t_sc.minmax_scale(torch.from_numpy(x), 256, symmetric, always_zero)
    _same(j.delta, t.delta)
    _same(j.zero_point, t.zero_point)
    flat = x.reshape(8, -1)
    j = j_sc.minmax_scale_rows(jnp.asarray(flat), 16, symmetric, always_zero)
    t = t_sc.minmax_scale_rows(torch.from_numpy(flat), 16, symmetric, always_zero)
    _same(j.delta, t.delta)
    _same(j.zero_point, t.zero_point)
    j = j_sc.init_scale_channelwise(jnp.asarray(x), 4)
    t = t_sc.init_scale_channelwise(torch.from_numpy(x), 4)
    assert tuple(t.delta.shape) == (8, 1, 1, 1)
    _same(j.delta, t.delta)
    _same(j.zero_point, t.zero_point)


def test_unported_scalers_raise():
    """The scalers that once raised here are all ported
    (tests/test_torch_calib_quant.py holds each against JAX): the channelwise
    MSE search gives the JAX package's delta within 1e-6 relative and its
    zero points exactly, and a name that is no scaler is refused."""
    w = _rand(2, 3, seed=9)
    j = j_sc.init_scale_channelwise(jnp.asarray(w), 4, j_sc.Scaler.MSE)
    t = t_sc.init_scale_channelwise(torch.from_numpy(w), 4, t_sc.Scaler.MSE)
    np.testing.assert_allclose(t.delta.numpy(), np.asarray(j.delta), rtol=1e-6)
    _same(j.zero_point, t.zero_point)
    with pytest.raises(ValueError):
        t_sc.init_scale_channelwise(torch.zeros(2, 3), 4, "no-such-scaler")


def test_aq_apply_and_softmax_q_apply_bit_identical():
    x = _rand(2, 8, 6, 32, seed=6, scale=4.0)
    logits = _rand(2, 8, 6, 77, seed=7, scale=2.0)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    qs_np = {"a": {"x": j_aff.QParams(np.float32(0.05), np.float32(127.6)),
                   "ch": j_aff.QParams(np.abs(_rand(32, seed=8)) * 0.1 + 0.01,
                                       np.full(32, 128.0, np.float32)),
                   "w": j_aff.QParams(np.float32(1 / 255.0), np.float32(0.0))},
             "sm": {"w": np.float32(0.4)}}
    jq = jax.tree.map(jnp.asarray, qs_np)
    tq = qstate_from_numpy(qs_np, device="cpu")
    for kw in ({}, {"t2i_log_quant": True}, {"t2i_log_quant": True, "t2i_real_time": True},
               {"t2i_log_quant": True, "log_max_1": True}):
        jc = j_qc.QConfig(use_aq=True, **kw)
        tc = t_qc.QConfig(use_aq=True, **kw)
        for name in ("x", "ch"):
            _same(j_qc.aq_apply(jq, jc, name, jnp.asarray(x)),
                  t_qc.aq_apply(tq, tc, name, torch.from_numpy(x)))
        _same(j_qc.softmax_q_apply(jq, jc, "w", jnp.asarray(p)),
              t_qc.softmax_q_apply(tq, tc, "w", torch.from_numpy(p)))
    # quantization off: identity on both sides
    t = torch.from_numpy(x)
    assert t_qc.aq_apply(tq, t_qc.QConfig(), "x", t) is t


@pytest.mark.parametrize("field,value", [
    ("use_int8_matmul", True), ("use_int8_conv", True),
    ("packed_attention", True), ("fold_act_dequant", True),
])
def test_qconfig_unported_fields_raise(field, value):
    """Every field that once raised is ported now (the s8 conv last) and
    constructs, directly and through replace, from the JAX package's dict."""
    j_qc.QConfig(**{field: value})  # the JAX package takes the same dict
    assert getattr(t_qc.QConfig(**{field: value}), field) is value
    assert getattr(t_qc.QConfig().replace(**{field: value}), field) is value


@pytest.mark.parametrize("impl", ["taps", "fused", "im2col", "unfold"])
def test_qconfig_takes_group_layers_and_every_legal_impl(impl):
    cfg = t_qc.QConfig(group_conv_layers=("a",), group_conv_impl=impl)
    assert cfg.group_conv_layers == ("a",) and cfg.group_conv_impl == impl


def test_qconfig_rejects_unknown_group_conv_impl():
    """Stricter than the JAX package, which silently takes the unfold branch."""
    j_qc.QConfig(group_conv_impl="tap")
    with pytest.raises(ValueError, match="'taps', 'fused', 'im2col', 'unfold'"):
        t_qc.QConfig(group_conv_impl="tap")
    with pytest.raises(ValueError, match="group_conv_impl"):
        t_qc.QConfig().replace(group_conv_impl="")


def test_qconfig_fields_match_jax():
    import dataclasses

    assert ([f.name for f in dataclasses.fields(t_qc.QConfig)]
            == [f.name for f in dataclasses.fields(j_qc.QConfig)])


def test_weight_fold_and_bridge_bit_identical():
    spec = j_spec(base=32, cross=64)
    assert t_spec(base=32, cross=64) == spec
    # every kind of layer (3x3 / 1x1 / strided conv, linear with and without
    # bias, norms, the excluded conv_in/conv_out); the whole tiny model costs
    # the JAX side a minute of per-layer dispatch
    spec = spec[:5] + [e for e in spec if e[0].startswith((
        "down_blocks.0.resnets.0.", "down_blocks.0.attentions.0.", "down_blocks.0.downsamplers"))]
    jp = j_init(jax.random.PRNGKey(0), spec=spec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")
    cfg = dict(w_bits=4, use_wq=True)
    jq, jw = j_wc.quantize_model_weights(jp, spec, j_qc.QConfig(**cfg))
    tq, tw = t_wc.quantize_model_weights(tp, spec, t_qc.QConfig(**cfg))
    expect = params_from_numpy(jax.tree.map(np.asarray, jq), spec, device="cpu")
    for name, kind, _ in spec:
        for leaf, val in expect[name].items():
            if val is None:
                assert tq[name][leaf] is None
            else:
                assert torch.equal(tq[name][leaf], val), (name, leaf)
        if kind in ("conv", "linear"):
            _same(jw[name].delta.reshape(-1), tw[name].delta.reshape(-1))
    # conv_in/conv_out keep their float weights
    assert torch.equal(tq["conv_in"]["w"], tp["conv_in"]["w"])
    assert t_wc.EXCLUDED_LAYERS == j_wc.EXCLUDED_LAYERS


def test_qpoint_names_and_synthetic_qstate_match():
    spec = j_spec(base=32, cross=64)
    assert t_act.attention_prefixes(spec) == j_act.attention_prefixes(spec)
    assert t_act.act_qpoint_names(spec) == j_act.act_qpoint_names(spec)
    assert t_act.softmax_qpoint_names(spec) == j_act.softmax_qpoint_names(spec)
    jq = j_syn(spec, 5, True, jnp.float32)
    tq = t_syn(spec, 5, True, torch.float32, device="cpu")
    assert set(jq["a"]) == set(tq["a"])
    for name, qp in jq["a"].items():
        _same(qp.delta, tq["a"][name].delta)
        _same(qp.zero_point, tq["a"][name].zero_point)


def test_port_imports_no_jax():
    code = ("import sys, dgq_tpu_torch, dgq_tpu_torch.pipeline.sampler, "
            "dgq_tpu_torch.pipeline.vae, dgq_tpu_torch.io.convert, "
            "dgq_tpu_torch.calib.weight_calib, dgq_tpu_torch.utils.synthetic, "
            "dgq_tpu_torch.ops.build, dgq_tpu_torch.ops.group_conv, "
            "dgq_tpu_torch.ops.int8_matmul, dgq_tpu_torch.models.unet_sdxl, "
            "dgq_tpu_torch.io.dgq_ckpt, dgq_tpu_torch.calib.data, dgq_tpu_torch.pipeline.prepare, "
            "dgq_tpu_torch.cli.infer, dgq_tpu_torch.cli.ckpt_tools, "
            "dgq_tpu_torch.cli.quantize_weight, dgq_tpu_torch.cli.quantize_act, "
            "dgq_tpu_torch.calib.reconstruction, dgq_tpu_torch.cli.gen4eval, "
            "dgq_tpu_torch.cli.eval_scores, dgq_tpu_torch.eval.scores, "
            "dgq_tpu_torch.eval.inception, dgq_tpu_torch.eval.image_reward, "
            "dgq_tpu_torch.parallel.mesh, dgq_tpu_torch.cli.flops, dgq_tpu_torch.utils.profiler, "
            "chip_smoke, chip_profile\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'dgq_tpu', 'sklearn', 'transformers', 'safetensors', 'PIL')]\n"
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr


def test_every_port_module_is_covered_by_the_no_jax_import():
    """The import in test_port_imports_no_jax reaches every module of the
    package: none is left to import jax unseen."""
    root = Path(__file__).resolve().parents[1]
    modules = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                     for p in (root / "dgq_tpu_torch").rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, dgq_tpu_torch.pipeline.sampler, dgq_tpu_torch.pipeline.vae, "
            "dgq_tpu_torch.io.convert, dgq_tpu_torch.calib.weight_calib, "
            "dgq_tpu_torch.utils.synthetic, dgq_tpu_torch.ops.build, "
            "dgq_tpu_torch.ops.group_conv, dgq_tpu_torch.ops.int8_matmul, "
            "dgq_tpu_torch.models.unet_sdxl, dgq_tpu_torch.io.dgq_ckpt, "
            "dgq_tpu_torch.calib.data, dgq_tpu_torch.pipeline.prepare, "
            "dgq_tpu_torch.cli.infer, dgq_tpu_torch.cli.ckpt_tools, "
            "dgq_tpu_torch.cli.quantize_weight, dgq_tpu_torch.cli.quantize_act, "
            "dgq_tpu_torch.calib.reconstruction, dgq_tpu_torch.cli.gen4eval, "
            "dgq_tpu_torch.cli.eval_scores, dgq_tpu_torch.eval.scores, "
            "dgq_tpu_torch.eval.inception, dgq_tpu_torch.eval.image_reward, "
            "dgq_tpu_torch.parallel.mesh, dgq_tpu_torch.cli.flops, dgq_tpu_torch.utils.profiler\n"
            f"missing = [m for m in {modules!r} if m not in sys.modules]\n"
            "assert not missing, missing")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr


def test_no_public_function_defaults_to_the_cpu():
    """The port's entry points run on the card unless the caller asks for the
    CPU: no public function of the package has a parameter whose default is
    "cpu" (or a CPU torch.device)."""
    import importlib
    import inspect
    import pkgutil

    import dgq_tpu_torch

    checked, offenders = 0, []
    for info in pkgutil.walk_packages(dgq_tpu_torch.__path__, "dgq_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if name.startswith("_") or fn.__module__ != mod.__name__:
                continue
            for pname, prm in inspect.signature(fn).parameters.items():
                checked += pname == "device"
                d = prm.default
                if (isinstance(d, str) and d.startswith("cpu")) or (
                        isinstance(d, torch.device) and d.type == "cpu"):
                    offenders.append(f"{mod.__name__}.{name}({pname}={d!r})")
    assert not offenders, offenders
    assert checked >= 6  # two inits, two bridges, two synthetic qstates
    for fn in (TU_init, t_syn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
