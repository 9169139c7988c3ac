"""dgq_tpu_torch NHWC layers against the JAX package on the same numpy
inputs and weights (converted by the weight bridge).

Tolerances: atol 1e-5 to 2e-4 as in tests/test_unet_sd.py, because the
summation order of the convolutions, matmuls and norm statistics differs
between XLA:CPU and PyTorch's CPU kernels. Elementwise ops with identical
order (silu, upsampling) are exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.models import layers as JL  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQ  # noqa: E402
from dgq_tpu.models.unet_sd import (  # noqa: E402
    _resnet_spec, _transformer_spec, init_unet_sd as j_init)
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu_torch.io.convert import params_from_numpy, qstate_from_numpy  # noqa: E402
from dgq_tpu_torch.models import layers as TL  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQ  # noqa: E402


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _params(spec, seed=0):
    """Both packages' params for `spec`; random biases and norm affines so
    every term is exercised."""
    jp = j_init(jax.random.PRNGKey(seed), spec=spec)
    rng = np.random.RandomState(seed + 100)
    for name, p in jp.items():
        for leaf in ("b", "bias", "scale"):
            if p.get(leaf) is not None:
                p[leaf] = jnp.asarray(rng.randn(*p[leaf].shape).astype(np.float32) * 0.3
                                      + (1.0 if leaf == "scale" else 0.0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")


def _close(j, t, atol):
    j, t = np.asarray(j), t.detach().numpy()
    assert j.shape == t.shape, (j.shape, t.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=atol)


@pytest.mark.parametrize("c,groups,eps", [(64, 32, 1e-5), (96, 32, 1e-6)])
def test_group_norm(c, groups, eps):
    x = _rand(2, 8, 8, c, seed=1, scale=2.0) + 0.5
    p = {"scale": _rand(c, seed=2) + 1.0, "bias": _rand(c, seed=3)}
    _close(JL.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), groups, eps),
           TL.group_norm({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), groups, eps), 1e-5)


def test_layer_norm():
    x = _rand(2, 16, 64, seed=4, scale=3.0) + 1.0
    p = {"scale": _rand(64, seed=5) + 1.0, "bias": _rand(64, seed=6)}
    _close(JL.layer_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
           TL.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)), 1e-5)


def test_timestep_embedding():
    t = np.asarray([1, 250, 501, 999], np.int32)
    # f32 trig near 1000 rad after the mod-2pi reduction: ~1e-4 between libms
    _close(JL.timestep_embedding(jnp.asarray(t), 320),
           TL.timestep_embedding(torch.from_numpy(t), 320), 2e-4)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv2d_and_quant_conv2d(k, stride, pad):
    spec = [("c", "conv", (16, 24, k, stride, pad))]
    jp, tp = _params(spec)
    x = _rand(2, 9, 9, 16, seed=7)
    _close(JL.conv2d(jp["c"], jnp.asarray(x), stride, pad),
           TL.conv2d(tp["c"], torch.from_numpy(x), stride, pad), 1e-5)
    qs = {"a": {"c": JQP(np.float32(0.05), np.float32(128.0))}}
    _close(JL.quant_conv2d(jp["c"], jnp.asarray(x), "c", jax.tree.map(jnp.asarray, qs),
                           JQ(use_aq=True), stride, pad),
           TL.quant_conv2d(tp["c"], torch.from_numpy(x), "c", qstate_from_numpy(qs, device="cpu"),
                           TQ(use_aq=True), stride, pad), 1e-5)


def test_linear_geglu_silu_upsample():
    spec = [("l", "linear", (32, 48, True)), ("ff.net.0.proj", "linear", (32, 128, True)),
            ("ff.net.2", "linear", (64, 32, True))]
    jp, tp = _params(spec)
    x = _rand(2, 10, 32, seed=8)
    _close(JL.linear(jp["l"], jnp.asarray(x)), TL.linear(tp["l"], torch.from_numpy(x)), 1e-5)
    qs = {"a": {"ff.net.0.proj": JQP(np.float32(0.04), np.float32(100.0))}}
    _close(JL.geglu_ff(jp, "ff", jnp.asarray(x), jax.tree.map(jnp.asarray, qs), JQ(use_aq=True)),
           TL.geglu_ff(tp, "ff", torch.from_numpy(x), qstate_from_numpy(qs, device="cpu"), TQ(use_aq=True)),
           1e-5)
    y = _rand(2, 3, 4, 5, seed=9, scale=4.0)
    _close(JL.silu(jnp.asarray(y)), TL.silu(torch.from_numpy(y)), 1e-6)
    _close(JL.upsample_nearest2x(jnp.asarray(y)), TL.upsample_nearest2x(torch.from_numpy(y)), 0)


@pytest.mark.parametrize("shortcut", [False, True])
def test_resnet_block(shortcut):
    cin, cout = 64, (96 if shortcut else 64)
    spec = _resnet_spec("rb", cin, cout, shortcut, 128)
    jp, tp = _params(spec, seed=10)
    x = _rand(2, 8, 8, cin, seed=11)
    temb = _rand(2, 128, seed=12)
    _close(JL.resnet_block(jp, "rb", jnp.asarray(x), jnp.asarray(temb), None, JQ(), shortcut),
           TL.resnet_block(tp, "rb", torch.from_numpy(x), torch.from_numpy(temb), None, TQ(),
                           shortcut), 1e-4)


def _attn_qstate(prefix_list):
    a = {}
    for pre in prefix_list:
        for s in ("q", "k", "v"):
            a[f"{pre}.aqtizer_{s}"] = JQP(np.float32(0.05), np.float32(128.0))
        a[f"{pre}.aqtizer_w"] = JQP(np.float32(1.0 / 255.0), np.float32(0.0))
    return {"a": a, "sm": {}}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_basic_transformer_block(fused, quant):
    """fp and act-quantized (uniform A8 softmax) blocks, through the
    materialized softmax and through fused_attention (the Pallas kernel in
    interpret mode on the JAX side, the plain version on the port's)."""
    spec = _transformer_spec("tb", 64, 48)
    jp, tp = _params(spec, seed=13)
    x = _rand(2, 16, 64, seed=14)
    ehs = _rand(2, 77, 48, seed=15)
    kw = dict(use_aq=quant, use_pallas_attention=fused, a_bits=8, softmax_bits=8)
    qs = _attn_qstate(["tb.attn1", "tb.attn2"]) if quant else None
    j = JL.basic_transformer_block(jp, "tb", jnp.asarray(x), jnp.asarray(ehs), 8,
                                   None if qs is None else jax.tree.map(jnp.asarray, qs),
                                   JQ(**kw))
    t = TL.basic_transformer_block(tp, "tb", torch.from_numpy(x), torch.from_numpy(ehs), 8,
                                   None if qs is None else qstate_from_numpy(qs, device="cpu"), TQ(**kw))
    _close(j, t, 2e-4)


@pytest.mark.parametrize("mode", ["log2_real_time", "log2"])
def test_attention_log2_start_peak_plain_path(mode):
    """The materialized-softmax attention in the g=8 policy's log2 modes with
    start_peak (plain path only: the CUDA kernels K3/K4 wait for slice 2)."""
    spec = _transformer_spec("tb", 64, 48)[:8]
    jp, tp = _params(spec, seed=16)
    x = _rand(2, 16, 64, seed=17)
    ehs = _rand(2, 77, 48, seed=18)
    qs = _attn_qstate(["tb.attn2"])
    qs["sm"]["tb.attn2.aqtizer_w"] = np.float32(0.5)
    kw = dict(use_aq=True, t2i_log_quant=True, t2i_real_time=mode == "log2_real_time",
              t2i_start_peak=True)
    _close(JL.attention(jp, "tb.attn2", jnp.asarray(x), jnp.asarray(ehs), 8,
                        jax.tree.map(jnp.asarray, qs), JQ(**kw), start_peak=True),
           TL.attention(tp, "tb.attn2", torch.from_numpy(x), torch.from_numpy(ehs), 8,
                        qstate_from_numpy(qs, device="cpu"), TQ(**kw), start_peak=True), 2e-4)
