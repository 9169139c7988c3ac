"""The port's SD v1.4 UNet: structure at full width, and the tiny model's
forward against the JAX package on the same weights and inputs.

Tolerances:
  * fp forward: atol 1e-4 (summation order of convs/matmuls/norms differs
    between XLA:CPU and PyTorch; the model is unquantized, so it stays
    close).
  * W8A8 + uniform A8 softmax forward: the chaos bound of
    tests/test_packed_in_model.py, err <= max(5 * chaos, 1e-4), with chaos
    the JAX net's own output change under a 1e-6 input perturbation (the
    largest of eight draws, since one draw is heavy-tailed). Any
    value within float error of a quantizer bin boundary flips a bin, and
    the quantized net amplifies it layer to layer; a different summation
    order is such an error.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.models import unet_sd as JU  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQ  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_group_qstate as j_gsyn  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import quantize_model_weights as t_qmw  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy, qstate_from_numpy  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models.qconfig import GroupQParams as TG, QConfig as TQ  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate as t_gsyn  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402


def test_full_width_spec_counts():
    spec = TU.sd_unet_spec()
    assert spec == JU.sd_unet_spec()
    assert len(TU.quantizable_layers(spec)) == 282
    params = TU.init_unet_sd(torch.Generator().manual_seed(0), "meta", torch.float32, spec)
    n = sum(t.numel() for p in params.values() for t in p.values() if t is not None)
    assert n == 859_520_964, n


def test_init_is_seeded_and_shaped():
    spec = TU.sd_unet_spec(base=32, cross=64)
    a = TU.init_unet_sd(torch.Generator().manual_seed(3), "cpu", spec=spec)
    b = TU.init_unet_sd(torch.Generator().manual_seed(3), "cpu", spec=spec)
    assert all(torch.equal(a[n]["w"], b[n]["w"]) for n, k, _ in spec if k != "groupnorm"
               and k != "layernorm")
    assert tuple(a["down_blocks.0.resnets.0.conv1"]["w"].shape) == (32, 32, 3, 3)
    assert tuple(a["time_embedding.linear_1"]["w"].shape) == (128, 32)
    w = a["down_blocks.1.resnets.0.conv1"]["w"]
    assert abs(float(w.std()) * (32 * 9) ** 0.5 - 1.0) < 0.05


@pytest.fixture(scope="module")
def tiny():
    """Tiny model weights drawn by the port and handed to JAX through the
    weight bridge (the JAX package's own per-layer init and weight folding
    cost a minute of dispatch on the CPU; folding is bit-identical, see
    test_torch_quant.py)."""
    spec = TU.sd_unet_spec(base=32, cross=64)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ehs = rng.randn(2, 77, 64).astype(np.float32)
    t = np.asarray([500, 500], np.int32)
    noise = [(1e-6 * rng.randn(*x.shape)).astype(np.float32) for _ in range(8)]
    return spec, tp, x, ehs, t, noise


def _jax(params, spec, qstate, cfg):
    """The JAX forward, compiled once per config (eager dispatch of the
    interpret-mode kernels takes minutes)."""
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params, spec))
    fn = jax.jit(functools.partial(JU.unet_sd_apply, qstate=qstate, cfg=cfg))
    return lambda x, t, ehs: np.asarray(fn(jp, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(ehs)))


def _torch(params, x, t, ehs, qstate, cfg):
    with torch.no_grad():
        return TU.unet_sd_apply(params, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(ehs), qstate=qstate, cfg=cfg).numpy()


def test_tiny_unet_fp_forward(tiny):
    spec, tp, x, ehs, t, _ = tiny
    j = _jax(tp, spec, None, JQ(use_pallas_attention=True))(x, t, ehs)
    out = _torch(tp, x, t, ehs, None, TQ(use_pallas_attention=True))
    np.testing.assert_allclose(out, j, rtol=0, atol=1e-4)


def test_tiny_unet_w8a8_uniform_softmax_within_chaos(tiny):
    spec, tp, x, ehs, t, noise = tiny
    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              use_pallas_attention=True)
    tq, _ = t_qmw(tp, spec, TQ(**kw))
    run = _jax(tq, spec, j_syn(spec, 0, False, jnp.float32), JQ(**kw))
    j = run(x, t, ehs)
    chaos = max(np.abs(run(x + n, t, ehs) - j).max() for n in noise)
    out = _torch(tq, x, t, ehs, t_syn(spec, 0, False, torch.float32, device="cpu"), TQ(**kw))
    err = np.abs(out - j).max()
    assert err <= max(5 * chaos, 1e-4), (err, chaos)
    assert np.abs(out).max() > 0.01


def _g8_kwargs(group_layers, impl, **extra):
    """The flagship policy (the JAX bench's --group 8 configuration), W8."""
    return dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True,
                use_pallas_attention=True, group_conv_layers=group_layers,
                group_conv_impl=impl, **extra)


def test_synthetic_group_qstate_matches_jax():
    spec = TU.sd_unet_spec(base=32, cross=64)
    jq, jl = j_gsyn(spec, 3, True, jnp.float32)
    tq, tl = t_gsyn(spec, 3, True, torch.float32, device="cpu")
    assert tl == jl and len(tl) > 0 and tq["sm"] == {} and set(tq["a"]) == set(jq["a"])
    for n, leaf in jq["a"].items():
        fields = (("delta_mid", "zp_mid", "delta_last", "zp_last") if n in jl
                  else ("delta", "zero_point"))
        assert isinstance(tq["a"][n], TG) == (n in jl)
        for f in fields:
            np.testing.assert_array_equal(getattr(tq["a"][n], f).numpy(),
                                          np.asarray(getattr(leaf, f)))
    # every k x k conv but conv_in / conv_out is a group layer
    assert set(tl) == {n for n, k, m in spec if k == "conv" and m[2] > 1
                       and n not in ("conv_in", "conv_out")}


@pytest.mark.parametrize("impl", ["taps", "fused"])
def test_tiny_unet_g8_flagship_within_chaos(tiny, impl):
    """The g=8 configuration: group-quantized k x k convs, log2 real_time
    softmax, start_peak on the cross attention. The JAX side runs its Pallas
    kernels (attention K3, and under 'fused' the group conv K5) in interpret
    mode; its synthetic group qstate crosses over by qstate_from_numpy."""
    spec, tp, x, ehs, t, noise = tiny
    jqs, group_layers = j_gsyn(spec, 0, False, jnp.float32)
    tq, _ = t_qmw(tp, spec, TQ(w_bits=8, use_wq=True))
    run = _jax(tq, spec, jqs, JQ(**_g8_kwargs(group_layers, impl)))
    j = run(x, t, ehs)
    chaos = max(np.abs(run(x + n, t, ehs) - j).max() for n in noise)
    tqs = qstate_from_numpy(jax.tree.map(np.asarray, jqs), device="cpu")
    assert all(isinstance(tqs["a"][n], TG) for n in group_layers)
    out = _torch(tq, x, t, ehs, tqs, TQ(**_g8_kwargs(group_layers, impl)))
    err = np.abs(out - j).max()
    assert np.isfinite(out).all()
    assert err <= max(5 * chaos, 1e-4), (err, chaos)
    # the group quantizer is live: the g=1-style per-tensor run differs
    assert np.abs(out).max() > 0.01


def test_tiny_unet_static_log2_within_chaos(tiny):
    """The short configuration that reaches K4: static log2 with delta
    pinned to 1 (log_max_1), start_peak on the cross attention."""
    spec, tp, x, ehs, t, noise = tiny
    jqs, group_layers = j_gsyn(spec, 0, False, jnp.float32)
    kw = _g8_kwargs(group_layers, "taps", log_max_1=True)
    kw["t2i_real_time"] = False
    tq, _ = t_qmw(tp, spec, TQ(w_bits=8, use_wq=True))
    run = _jax(tq, spec, jqs, JQ(**kw))
    j = run(x, t, ehs)
    chaos = max(np.abs(run(x + n, t, ehs) - j).max() for n in noise)
    out = _torch(tq, x, t, ehs, qstate_from_numpy(jax.tree.map(np.asarray, jqs), device="cpu"),
                 TQ(**kw))
    assert np.abs(out - j).max() <= max(5 * chaos, 1e-4), (np.abs(out - j).max(), chaos)
    # use_pallas_attention=False takes the materialized softmax_q_apply branch
    # and computes the same function
    mat = _torch(tq, x, t, ehs, qstate_from_numpy(jax.tree.map(np.asarray, jqs), device="cpu"),
                 TQ(**{**kw, "use_pallas_attention": False}))
    assert np.abs(mat - out).max() <= max(5 * chaos, 1e-4)
