"""The real-int8 k x k conv of the port (`use_int8_conv`: the packed 'w_q8c'
codes, `models.layers._int8_conv` and its routing) against the JAX package on
the same numpy inputs. The port runs on device="cpu", where the s8 product
is an exact float64 one; JAX runs its XLA s8 conv.

Tolerances:
  * packed codes, the s32 accumulator and the window sums: bit-identical.
  * the output against JAX's `_int8_conv`: 1e-6 of the largest |output| (the
    same f32 ops in the same order; XLA:CPU may contract a multiply-add).
  * against the fake-quant conv: atol 2e-3, as tests/test_int8_path.py.
  * `use_int8_conv` alone leaves linears and 1x1 convs where they were: 1e-6.
  * the tiny UNet: the chaos bound of tests/test_packed_in_model.py.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.calib import weight_calib as j_wc  # noqa: E402
from dgq_tpu.models import layers as JL  # noqa: E402
from dgq_tpu.models import unet_sd as JU  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQ  # noqa: E402
from dgq_tpu.quant.affine import QParams as JP  # noqa: E402
from dgq_tpu.quant.scalers import Scaler as JS, init_scale as j_init_scale  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib import weight_calib as t_wc  # noqa: E402
from dgq_tpu_torch.io.convert import params_from_numpy, params_to_numpy  # noqa: E402
from dgq_tpu_torch.models import layers as TL  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQ  # noqa: E402
from dgq_tpu_torch.quant.affine import QParams as TP  # noqa: E402
from dgq_tpu_torch.quant.scalers import Scaler as TS  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402


def _both(cin, cout, k, stride, pad, a_bits, bias, seed, zp_shift=0.0):
    """One conv layer packed by each package from the same numpy weights, an
    input and its per-tensor qparams."""
    rng = np.random.RandomState(seed)
    spec = [("C", "conv", (cin, cout, k, stride, pad))]
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    kw = dict(w_bits=4, a_bits=a_bits, use_wq=True, use_aq=True, use_int8_conv=True,
              disable_out_quant=False)
    jparams = {"C": {"w": jnp.asarray(w), "b": None if b is None else jnp.asarray(b)}}
    jwqp = j_wc.init_weight_qparams(jparams, spec, 4, JS.MINMAX)
    jq = j_wc.attach_int8_packed(j_wc.fold_weight_quant(jparams, jwqp, spec, JQ(**kw)), jwqp,
                                 spec, JQ(**kw))
    tparams = params_from_numpy({"C": {"w": w, "b": b}}, spec, device="cpu")
    tq, _ = t_wc.quantize_model_weights(tparams, spec, TQ(**kw), TS.MINMAX)
    x = rng.randn(2, 9, 9, cin).astype(np.float32)
    xqp = j_init_scale(jnp.asarray(x), a_bits, JS.MINMAX)
    d, z = np.float32(xqp.delta), np.float32(xqp.zero_point) + np.float32(zp_shift)
    jstate = {"a": {"C": JP(jnp.asarray(d), jnp.asarray(z))}, "sm": {}}
    tstate = {"a": {"C": TP(torch.tensor(d), torch.tensor(z))}, "sm": {}}
    return spec, kw, jq, tq, x, jstate, tstate


def _jax_acc(jp, x, qp, a_bits, stride, pad):
    """JAX's s32 accumulator and window sums, by `_int8_conv`'s own lines."""
    off = 2 ** (a_bits - 1)
    zp_r = jnp.round(qp.zero_point.astype(jnp.float32))
    codes = (jnp.clip(jnp.round(x / qp.delta) + zp_r, 0, 2 ** a_bits - 1) - off).astype(jnp.int8)
    codes = jnp.pad(codes, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    constant_values=(zp_r - off).astype(jnp.int8))
    kh, kw = jp["w_q8c"].shape[:2]
    acc = jax.lax.conv_general_dilated(codes, jp["w_q8c"], (stride, stride), "VALID",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    csum = jnp.sum(codes.astype(jnp.int32), axis=-1, keepdims=True)
    xsum = jax.lax.reduce_window(csum, jnp.int32(0), jax.lax.add, (1, kh, kw, 1),
                                 (1, stride, stride, 1), "VALID")
    return np.asarray(acc), np.asarray(xsum)


@pytest.mark.parametrize("stride,pad,a_bits,bias,zp_shift", [
    (1, 1, 8, True, 0.0), (2, 1, 8, True, 0.0), (1, 1, 6, False, 0.0), (2, 1, 6, True, 0.0),
    (1, 0, 8, True, 0.37),
])
def test_int8_conv_matches_jax(stride, pad, a_bits, bias, zp_shift):
    """Codes, s32 accumulator and window sums bit for bit; the output within
    1e-6 of JAX's largest |output| and atol 2e-3 of the fake-quant conv."""
    spec, kw, jq, tq, x, jstate, tstate = _both(16, 24, 3, stride, pad, a_bits, bias,
                                                seed=3 + stride + a_bits, zp_shift=zp_shift)
    jnp_q = params_to_numpy(tq, spec)["C"]
    for leaf in ("w_q8c", "w_d", "w_z", "w_ksum"):
        assert np.array_equal(jnp_q[leaf], np.asarray(jq["C"][leaf])), leaf
    assert "w_q8" not in tq["C"]

    qp = tstate["a"]["C"]
    codes, zx = TL.int8_conv_codes(torch.from_numpy(x), qp, a_bits, pad)
    acc, xsum = TL.int8_conv_acc(codes, tq["C"]["w_q8c"], stride)
    jacc, jxsum = _jax_acc(jq["C"], jnp.asarray(x), jstate["a"]["C"], a_bits, stride, pad)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), jacc)
    assert np.array_equal(xsum.numpy(), jxsum)

    calls = []
    real = TL._int8_conv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "_int8_conv", lambda *a, **k: calls.append(1) or real(*a, **k))
        out = TL.quant_conv2d(tq["C"], torch.from_numpy(x), "C", tstate, TQ(**kw), stride,
                              pad).numpy()
    assert calls == [1]
    ref = np.asarray(JL.quant_conv2d(jq["C"], jnp.asarray(x), "C", jstate, JQ(**kw), stride, pad))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max(), np.abs(out - ref).max()
    fake = TL.quant_conv2d(tq["C"], torch.from_numpy(x), "C", tstate,
                           TQ(**{**kw, "use_int8_conv": False}), stride, pad).numpy()
    if zp_shift == 0.0:  # a fractional zero point is rounded by the s8 path only
        assert np.abs(out - fake).max() <= 2e-3, np.abs(out - fake).max()


def test_int8_conv_bf16_activations():
    """bf16 activations: the codes come from the f32 upcast, the output is
    cast once at the end, as in the JAX package (1 bf16 ulp of its output)."""
    spec, kw, jq, tq, x, jstate, tstate = _both(16, 24, 3, 1, 1, 8, True, seed=9)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = TL.quant_conv2d(tq["C"], xb, "C", tstate, TQ(**kw), 1, 1)
    assert out.dtype == torch.bfloat16
    ref = JL.quant_conv2d(jq["C"], jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), "C",
                          jstate, JQ(**kw), 1, 1)
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref)
    assert (err <= 2 ** -7 * np.abs(ref) + 1e-6).all(), err.max()


def test_conv_only_int8_flag_does_not_route_linears():
    """use_int8_conv alone leaves linears and 1x1 convs on the fake-quant
    path, and packs no 'w_q8' for them (the JAX test of the same name)."""
    rng = np.random.RandomState(5)
    spec = [("L", "linear", (64, 32, True)), ("P", "conv", (64, 32, 1, 1, 0))]
    params = {"L": {"w": torch.from_numpy((rng.randn(32, 64) * 0.1).astype(np.float32)),
                    "b": torch.from_numpy(rng.randn(32).astype(np.float32))},
              "P": {"w": torch.from_numpy((rng.randn(32, 64, 1, 1) * 0.1).astype(np.float32)),
                    "b": None}}
    both = TQ(w_bits=4, a_bits=8, use_wq=True, use_aq=True, use_int8_matmul=True,
              use_int8_conv=True, int8_impl="xla", disable_out_quant=False)
    conv_only = both.replace(use_int8_matmul=False)
    off = conv_only.replace(use_int8_conv=False)
    pq, _ = t_wc.quantize_model_weights(params, spec, both)
    assert "w_q8" in pq["L"] and "w_q8" in pq["P"]
    pc, _ = t_wc.quantize_model_weights(params, spec, conv_only)
    assert not any(k in pc[n] for n in ("L", "P") for k in ("w_q8", "w_q8c"))
    x = rng.randn(512, 64).astype(np.float32)
    d = np.float32((x.max() - x.min()) / 255)
    z = np.float32(np.round(-x.min() / d) + 0.37)  # int8 rounds it, fake-quant does not
    state = {"a": {n: TP(torch.tensor(d), torch.tensor(z)) for n in ("L", "P")}, "sm": {}}
    xt = torch.from_numpy(x)
    a = TL.quant_linear(pq["L"], xt, "L", state, conv_only)
    b = TL.quant_linear(pq["L"], xt, "L", state, off)
    assert np.abs(a.numpy() - b.numpy()).max() <= 1e-6
    x4 = xt.reshape(2, 16, 16, 64)
    a = TL.quant_conv2d(pq["P"], x4, "P", state, conv_only)
    b = TL.quant_conv2d(pq["P"], x4, "P", state, off)
    assert np.abs(a.numpy() - b.numpy()).max() <= 1e-6


def test_qconfig_int8_conv_constructs():
    """The last field that raised: it constructs, and the JAX package takes
    the same dict."""
    assert TQ(use_int8_conv=True).use_int8_conv is True
    assert TQ().replace(use_int8_conv=True).use_int8_conv is True
    assert JQ(use_int8_conv=True).use_int8_conv is True


def test_tiny_unet_int8_conv_within_chaos():
    """The tiny SD UNet with use_int8_conv: every k x k conv but conv_in /
    conv_out goes through `_int8_conv` (counted), and the output is within
    the chaos bound of the JAX package's int8-conv forward and of the port's
    own fake-quant forward."""
    spec = TU.sd_unet_spec(base=32, cross=64)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ehs = rng.randn(2, 77, 64).astype(np.float32)
    t = np.asarray([500, 500], np.int32)
    noise = [(1e-6 * rng.randn(*x.shape)).astype(np.float32) for _ in range(8)]
    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True, use_int8_conv=True)
    tq, _ = t_wc.quantize_model_weights(tp, spec, TQ(**kw))
    n_kxk = sum(1 for n, k, m in spec if k == "conv" and m[2] > 1
                and n not in ("conv_in", "conv_out"))
    assert sum("w_q8c" in p for p in tq.values()) == n_kxk
    assert not any("w_q8" in p for p in tq.values())
    jp = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), params_to_numpy(tq, spec),
                      is_leaf=lambda a: a is None)
    fn = jax.jit(functools.partial(JU.unet_sd_apply, qstate=j_syn(spec, 0, False, jnp.float32),
                                   cfg=JQ(**kw)))

    def run(xx):
        return np.asarray(fn(jp, jnp.asarray(xx), jnp.asarray(t), jnp.asarray(ehs)))
    j = run(x)
    chaos = max(np.abs(run(x + n) - j).max() for n in noise)
    calls = []
    real = TL._int8_conv
    tqs = t_syn(spec, 0, False, torch.float32, device="cpu")
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(TL, "_int8_conv", lambda *a, **k: calls.append(1) or real(*a, **k))
        out = TU.unet_sd_apply(tq, *args, qstate=tqs, cfg=TQ(**kw)).numpy()
        assert len(calls) == n_kxk
        fake = TU.unet_sd_apply(tq, *args, qstate=tqs,
                                cfg=TQ(**{**kw, "use_int8_conv": False})).numpy()
        assert len(calls) == n_kxk
    bound = max(5 * chaos, 1e-4)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01
    assert np.abs(out - j).max() <= bound, (np.abs(out - j).max(), chaos)
    assert np.abs(out - fake).max() <= bound, (np.abs(out - fake).max(), chaos)
