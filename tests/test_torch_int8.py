"""The int8 deploy path of the port (ops.int8_matmul's plain version, the
packing, the int8 / codes-fold dispatch of models.layers) against the JAX
package on the same numpy inputs. The port runs on device="cpu", where
`quantized_matmul` takes its plain version; the JAX kernel runs in interpret
mode (its name is patched in the tests that reach it through the model, as
tests/test_int8_path.py does).

Tolerances:
  * packing, integer codes, the bridge: bit-identical (the same elementwise
    f32 ops, both round half to even).
  * plain version vs the JAX kernel, f32: 1e-5 of the output's largest
    magnitude. The integer product is exact on both sides; the f32 epilogue
    subtracts cross terms of the accumulator's size, so its rounding (and
    XLA:CPU's freedom to contract a multiply-add) is relative to that size,
    not to each output.
  * the library route and the codes fold vs their JAX functions: the same
    1e-5 relative; against the port's own fake-quant path atol 2e-3 / 1e-5 as
    tests/test_int8_path.py.
  * the tiny UNet with int8 on: the chaos bound of
    tests/test_packed_in_model.py, err <= max(5 * chaos, 1e-4).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import dgq_tpu.ops.pallas.int8_matmul as JM  # noqa: E402
from dgq_tpu.calib import weight_calib as j_wc  # noqa: E402
from dgq_tpu.models import layers as JL  # noqa: E402
from dgq_tpu.models import unet_sd as JU  # noqa: E402
from dgq_tpu.models.qconfig import GroupQParams as JG, QConfig as JQ  # noqa: E402
from dgq_tpu.quant import affine as j_aff  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib import weight_calib as t_wc  # noqa: E402
from dgq_tpu_torch.io.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy, qstate_from_numpy)
from dgq_tpu_torch.models import layers as TL  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models.qconfig import GroupQParams as TG, QConfig as TQ  # noqa: E402
from dgq_tpu_torch.ops import int8_matmul as TM  # noqa: E402
from dgq_tpu_torch.quant import affine as t_aff  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402


@pytest.fixture
def interpret_kernel(monkeypatch):
    """The JAX model reaches its kernel without `interpret`; on the CPU the
    test patches the name, nothing in the package changes."""
    orig = JM.quantized_matmul
    monkeypatch.setattr(JM, "quantized_matmul",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _minmax_qp(a, bits):
    lo, hi = min(a.min(), 0.0), max(a.max(), 0.0)
    delta = np.float32((hi - lo) / (2 ** bits - 1))
    return delta, np.float32(np.round(-lo / delta))


def _case(m, k, n, w_bits, a_bits, seed):
    """x, an (N, K) weight with its per-out-channel minmax qparams, and the
    activation's per-tensor qparams."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(n, k) * 0.1).astype(np.float32)
    wd = ((w.max(1) - np.minimum(w.min(1), 0)) / (2 ** w_bits - 1)).astype(np.float32)
    wz = np.round(-np.minimum(w.min(1), 0) / wd).astype(np.float32)
    dx, zx = _minmax_qp(x, a_bits)
    bias = rng.randn(n).astype(np.float32)
    return x, w, wd, wz, dx, zx, bias


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_weight_int8_bit_identical(bits):
    _, w, wd, wz, _, _, _ = _case(4, 96, 130, bits, 8, seed=bits)
    jq, jd, jz = JM.pack_weight_int8(jnp.asarray(w.T), jnp.asarray(wd[None, :]),
                                     jnp.asarray(wz[None, :]), bits)
    tq, td, tz = TM.pack_weight_int8(torch.from_numpy(w), torch.from_numpy(wd[:, None]),
                                     torch.from_numpy(wz[:, None]), bits)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (130, 96) and tq.is_contiguous()
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))  # (N, K) here, (K, N) there
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert int(tq.min()) >= -(2 ** (bits - 1)) and int(tq.max()) <= 2 ** (bits - 1) - 1


@pytest.mark.parametrize("bits", [8, 6])
def test_quantize_int_bit_identical(bits):
    x = np.random.RandomState(bits).randn(16, 64).astype(np.float32) * 2.0
    d, z = _minmax_qp(x, bits)
    jc = j_aff.quantize_int(jnp.asarray(x), j_aff.QParams(jnp.asarray(d), jnp.asarray(z)), bits)
    tqp = t_aff.QParams(torch.tensor(d), torch.tensor(z))
    tc = t_aff.quantize_int(torch.from_numpy(x), tqp, bits)
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert t_aff.int_code_offset(bits) == j_aff.int_code_offset(bits) == 2 ** (bits - 1)
    assert t_aff.int_code_offset(8, symmetric=True) == j_aff.int_code_offset(8, symmetric=True)
    np.testing.assert_array_equal(
        t_aff.dequantize_int(tc, tqp, bits).numpy(),
        np.asarray(j_aff.dequantize_int(jc, j_aff.QParams(jnp.asarray(d), jnp.asarray(z)), bits)))
    np.testing.assert_allclose(t_aff.dequantize_int(tc, tqp, bits).numpy(),
                               t_aff.fake_quant(torch.from_numpy(x), tqp, bits).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(48, 96, 130), (5, 36, 33), (154, 64, 40)])
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("a_bits", [8, 6])
def test_plain_version_matches_jax_kernel(m, k, n, w_bits, a_bits):
    """Ragged M and N (the JAX wrapper pads them; the port masks), A8 and A6
    bounds, W4 and W8 codes."""
    x, w, wd, wz, dx, zx, bias = _case(m, k, n, w_bits, a_bits, seed=m + w_bits + a_bits)
    off = 2 ** (a_bits - 1)
    jq, jd, jz = JM.pack_weight_int8(jnp.asarray(w.T), jnp.asarray(wd[None, :]),
                                     jnp.asarray(wz[None, :]), w_bits)
    ref = JM.quantized_matmul(jnp.asarray(x), jq, jd, jz, jnp.asarray(dx), jnp.asarray(zx - off),
                              jnp.asarray(bias), block_m=16, block_n=128, out_dtype=jnp.float32,
                              a_bits=a_bits, interpret=True)
    tq, td, tz = TM.pack_weight_int8(torch.from_numpy(w), torch.from_numpy(wd), torch.from_numpy(wz),
                                     w_bits)
    args = (torch.from_numpy(x), tq, td, tz, torch.tensor(dx), torch.tensor(zx - off),
            torch.from_numpy(bias))
    out = TM.quantized_matmul_reference(*args, a_bits=a_bits)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    assert _rel(out.numpy(), ref) <= 1e-5
    # the wrapper on a CPU tensor is the plain version; w_ksum from pack time changes nothing
    ksum = tq.sum(dim=1, dtype=torch.int32).float()
    assert torch.equal(TM.quantized_matmul(*args, w_ksum=ksum, a_bits=a_bits), out)
    # and it equals dequantize-then-matmul: the fake-quant result
    xq = t_aff.fake_quant(args[0], t_aff.QParams(args[4], torch.tensor(zx)), a_bits)
    wq = (tq.float() - tz[:, None]) * td[:, None]
    assert _rel(out.numpy(), (xq.double() @ wq.double().t() + args[6].double()).numpy()) <= 1e-5


def test_plain_version_a6_differs_from_a8_bounds():
    """The JAX package's float oracle pins the clip to [-128, 127]; the kernel
    (and so the plain version) takes the bounds from a_bits."""
    x, w, wd, wz, dx, zx, bias = _case(16, 64, 24, 4, 6, seed=3)
    x = x * 3.0  # values that clip under A6
    tq, td, tz = TM.pack_weight_int8(torch.from_numpy(w), torch.from_numpy(wd), torch.from_numpy(wz), 4)
    args = (torch.from_numpy(x), tq, td, tz, torch.tensor(dx), torch.tensor(zx - 32.0),
            torch.from_numpy(bias))
    a6 = TM.quantized_matmul_reference(*args, a_bits=6)
    a8 = TM.quantized_matmul_reference(*args, a_bits=8)
    assert float((a6 - a8).abs().max()) > 1e-2
    _, codes, xsum = TM.quantized_matmul(*args, a_bits=6, return_codes=True)
    assert int(codes.min()) == -32 and int(codes.max()) == 31
    assert torch.equal(xsum, codes.float().sum(dim=1))


def test_plain_version_accumulates_exactly_at_wide_k():
    """W8 x A8 at K = 5120: the sums pass 2^24, where an f32 accumulator
    would round; the plain version holds them exactly."""
    rng = np.random.RandomState(0)
    m, k, n = 8, 5120, 16
    x = torch.from_numpy((rng.rand(m, k) * 127.0).astype(np.float32))  # delta 1: codes to +127
    wq = torch.from_numpy(rng.randint(100, 128, (n, k)).astype(np.int8))
    one, zero = torch.ones(n), torch.zeros(n)
    out = TM.quantized_matmul_reference(x, wq, one, zero, torch.tensor(1.0), torch.tensor(0.0))
    xq = torch.clamp(torch.round(x), -128, 127).long()
    exact = xq @ wq.long().t()
    assert int(exact.max()) > 2 ** 24
    assert torch.equal(out, exact.float())


def test_quantized_matmul_codes_equal_quantize_int():
    """The codes the wrapper reports are quantize_int's, bit for bit (on the
    card the kernel writes them; here the plain version builds them)."""
    x, w, wd, wz, dx, zx, _ = _case(33, 40, 8, 4, 8, seed=9)
    tq, td, tz = TM.pack_weight_int8(torch.from_numpy(w), torch.from_numpy(wd), torch.from_numpy(wz), 4)
    _, codes, _ = TM.quantized_matmul(torch.from_numpy(x), tq, td, tz, torch.tensor(dx),
                                      torch.tensor(zx - 128.0), return_codes=True)
    want = t_aff.quantize_int(torch.from_numpy(x), t_aff.QParams(torch.tensor(dx), torch.tensor(zx)), 8)
    assert torch.equal(codes, want)


def test_quantized_matmul_rejects_bad_inputs():
    x, wq = torch.zeros(4, 8), torch.zeros(3, 8, dtype=torch.int8)
    v = torch.zeros(3)
    with pytest.raises(ValueError, match="int8 codes"):
        TM.quantized_matmul(x, wq.float(), v, v, torch.tensor(1.0), torch.tensor(0.0))
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        TM.quantized_matmul(x, torch.zeros(3, 7, dtype=torch.int8), v, v, torch.tensor(1.0),
                            torch.tensor(0.0))
    with pytest.raises(ValueError, match="a_bits"):
        TM.quantized_matmul(x, wq, v, v, torch.tensor(1.0), torch.tensor(0.0), a_bits=9)
    with pytest.raises(ValueError, match="w_delta"):
        TM.quantized_matmul(x, wq, torch.zeros(4), v, torch.tensor(1.0), torch.tensor(0.0))


def _small_spec():
    return [
        ("conv_in", "conv", (4, 16, 3, 1, 1)),        # excluded: keeps float weights
        ("lin", "linear", (64, 32, True)),
        ("lin_nobias", "linear", (32, 24, False)),
        ("p1", "conv", (16, 24, 1, 1, 0)),            # 1x1: packed
        ("c3", "conv", (16, 16, 3, 1, 1)),            # k x k: no matmul codes
        ("g3", "conv", (16, 16, 3, 1, 1)),            # group layer: skipped
        ("norm", "groupnorm", (16,)),
    ]


def _small_params(spec, seed=0):
    rng = np.random.RandomState(seed)
    jp = {}
    for name, kind, meta in spec:
        if kind == "conv":
            cin, cout, k, _, _ = meta
            jp[name] = {"w": jnp.asarray((rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)),
                        "b": jnp.asarray(rng.randn(cout).astype(np.float32))}
        elif kind == "linear":
            cin, cout, bias = meta
            jp[name] = {"w": jnp.asarray((rng.randn(cin, cout) * 0.1).astype(np.float32)),
                        "b": jnp.asarray(rng.randn(cout).astype(np.float32)) if bias else None}
        else:
            jp[name] = {"scale": jnp.ones(meta[0]), "bias": jnp.zeros(meta[0])}
    return jp


@pytest.mark.parametrize("w_bits", [4, 8])
def test_attach_int8_packed_bit_identical(w_bits):
    spec = _small_spec()
    jp = _small_params(spec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")
    kw = dict(w_bits=w_bits, use_wq=True, use_int8_matmul=True, group_conv_layers=("g3",))
    jq, _ = j_wc.quantize_model_weights(jp, spec, JQ(**kw))
    tq, _ = t_wc.quantize_model_weights(tp, spec, TQ(**kw))
    expect = params_from_numpy(jax.tree.map(np.asarray, jq), spec, device="cpu")
    for name in ("lin", "lin_nobias", "p1"):
        assert set(tq[name]) == set(expect[name]) == {"w", "b", "w_q8", "w_d", "w_z", "w_ksum"}
        for leaf in ("w", "w_q8", "w_d", "w_z", "w_ksum"):
            assert tq[name][leaf].dtype == expect[name][leaf].dtype
            assert torch.equal(tq[name][leaf], expect[name][leaf]), (name, leaf)
        assert tq[name]["w_q8"].dtype == torch.int8 and tq[name]["w_q8"].is_contiguous()
        assert tuple(tq[name]["w_q8"].shape) == (tq[name]["w"].shape[0],
                                                 tq[name]["w"][0].numel())
    for name in ("conv_in", "c3", "g3"):  # excluded, k x k, group layer
        assert "w_q8" not in tq[name] and "w_q8" not in jq[name]
    # without the flag nothing is packed
    plain, _ = t_wc.quantize_model_weights(tp, spec, TQ(w_bits=w_bits, use_wq=True))
    assert all("w_q8" not in p for p in plain.values())


def test_bridge_round_trip_of_packed_entries():
    """Pack in the port, cross to the JAX layout and back: unchanged; and the
    JAX-layout codes are the transpose the JAX kernel expects."""
    spec = _small_spec()
    tp = params_from_numpy(jax.tree.map(np.asarray, _small_params(spec, seed=2)), spec, device="cpu")
    tq, _ = t_wc.quantize_model_weights(tp, spec, TQ(w_bits=4, use_wq=True, use_int8_matmul=True))
    as_np = params_to_numpy(tq, spec)
    assert as_np["lin"]["w_q8"].dtype == np.int8 and as_np["lin"]["w_q8"].shape == (64, 32)
    assert as_np["p1"]["w_q8"].shape == (16, 24) and as_np["lin"]["w_d"].dtype == np.float32
    back = params_from_numpy(as_np, spec, device="cpu")
    for name in ("lin", "lin_nobias", "p1"):
        for leaf in ("w", "w_q8", "w_d", "w_z", "w_ksum"):
            assert back[name][leaf].dtype == tq[name][leaf].dtype
            assert torch.equal(back[name][leaf], tq[name][leaf]), (name, leaf)
    # k x k conv codes (the JAX package's s8 conv) cross as HWIO <-> OIHW
    codes = np.arange(3 * 3 * 2 * 5, dtype=np.int8).reshape(3, 3, 2, 5)
    one = [("c", "conv", (2, 5, 3, 1, 1))]
    t = params_from_numpy({"c": {"w": codes.astype(np.float32), "b": None, "w_q8c": codes}}, one,
                          device="cpu")
    assert t["c"]["w_q8c"].dtype == torch.int8 and tuple(t["c"]["w_q8c"].shape) == (5, 2, 3, 3)
    np.testing.assert_array_equal(params_to_numpy(t, one)["c"]["w_q8c"], codes)


def _linear_setup(a_bits=8, w_bits=4, m=(4, 7), seed=1, frac_zp=0.0, **cfg_kw):
    """One linear with packed weights in both packages and a per-tensor
    activation quantizer."""
    name = "L"
    spec = [(name, "linear", (64, 32, True))]
    rng = np.random.RandomState(seed)
    jp = {name: {"w": jnp.asarray((rng.randn(64, 32) * 0.1).astype(np.float32)),
                 "b": jnp.asarray(rng.randn(32).astype(np.float32))}}
    kw = dict(w_bits=w_bits, a_bits=a_bits, use_wq=True, use_aq=True, use_int8_matmul=True, **cfg_kw)
    jq, _ = j_wc.quantize_model_weights(jp, spec, JQ(**kw))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), spec, device="cpu")
    x = rng.randn(*m, 64).astype(np.float32)
    d, z = _minmax_qp(x, a_bits)
    z = np.float32(z + frac_zp)
    jqs = {"a": {name: j_aff.QParams(jnp.asarray(d), jnp.asarray(z))}, "sm": {}}
    tqs = {"a": {name: t_aff.QParams(torch.tensor(d), torch.tensor(z))}, "sm": {}}
    return name, jq[name], tq[name], x, jqs, tqs, kw


@pytest.mark.parametrize("a_bits,w_bits", [(8, 4), (6, 4), (8, 8)])
@pytest.mark.parametrize("frac_zp", [0.0, 0.37])
def test_quant_linear_int8_matches_jax_and_fake_quant(interpret_kernel, a_bits, w_bits, frac_zp):
    """The K6 route of quant_linear: against the JAX package (kernel in
    interpret mode) and, with an integer zero point, against the port's own
    fake-quant path. A fractional zero point is rounded before the codes are
    built, in both packages."""
    name, jp, tp, x, jqs, tqs, kw = _linear_setup(a_bits, w_bits, frac_zp=frac_zp)
    j = JL.quant_linear(jp, jnp.asarray(x), name, jqs, JQ(**kw))
    out = TL.quant_linear(tp, torch.from_numpy(x), name, tqs, TQ(**kw))
    assert tuple(out.shape) == (4, 7, 32) and out.dtype == torch.float32
    assert _rel(out.numpy(), j) <= 1e-5
    fake = TL.quant_linear(tp, torch.from_numpy(x), name, tqs, TQ(**{**kw, "use_int8_matmul": False}))
    if frac_zp == 0.0:
        np.testing.assert_allclose(out.numpy(), fake.numpy(), rtol=0, atol=2e-3)
    else:
        assert float((out - fake).abs().max()) > 1e-4  # the rounded zero point shows


def test_int8_1x1_conv_and_group_layers_stay_off_k6(interpret_kernel, monkeypatch):
    """A stride-1 1x1 conv with packed weights runs as an int8 matmul; a group
    layer is neither packed nor routed there, with int8 on."""
    rng = np.random.RandomState(5)
    spec = [("g3", "conv", (8, 16, 3, 1, 1)), ("p1", "conv", (8, 16, 1, 1, 0))]
    jp = {"g3": {"w": jnp.asarray((rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32)),
                 "b": jnp.asarray(rng.randn(16).astype(np.float32))},
          "p1": {"w": jnp.asarray((rng.randn(1, 1, 8, 16) * 0.1).astype(np.float32)),
                 "b": jnp.asarray(rng.randn(16).astype(np.float32))}}
    kw = dict(w_bits=4, a_bits=8, use_wq=True, use_aq=True, use_int8_matmul=True,
              group_conv_layers=("g3",), group_conv_impl="taps")
    jq, _ = j_wc.quantize_model_weights(jp, spec, JQ(**kw))
    tq, _ = t_wc.quantize_model_weights(
        params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu"), spec, TQ(**kw))
    assert "w_q8" not in tq["g3"] and "w_q8" in tq["p1"]
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    d, z = _minmax_qp(x, 8)
    g = dict(delta_mid=np.full(72, 0.05, np.float32), zp_mid=np.full(72, 128.0, np.float32),
             delta_last=np.ones(1, np.float32), zp_last=np.zeros(1, np.float32))
    jqs = {"a": {"g3": JG(**{k: jnp.asarray(v) for k, v in g.items()}),
                 "p1": j_aff.QParams(jnp.asarray(d), jnp.asarray(z))}, "sm": {}}
    tqs = {"a": {"g3": TG(**{k: torch.from_numpy(v) for k, v in g.items()}),
                 "p1": t_aff.QParams(torch.tensor(d), torch.tensor(z))}, "sm": {}}
    calls = []
    real = TL.quantized_matmul
    monkeypatch.setattr(TL, "quantized_matmul", lambda *a, **k: calls.append(1) or real(*a, **k))
    xt = torch.from_numpy(x)
    y_g = TL.quant_conv2d(tq["g3"], xt, "g3", tqs, TQ(**kw), 1, 1)
    assert not calls
    np.testing.assert_allclose(
        y_g.numpy(), np.asarray(JL.quant_conv2d(jq["g3"], jnp.asarray(x), "g3", jqs, JQ(**kw), 1, 1)),
        rtol=0, atol=2e-4)
    y_p = TL.quant_conv2d(tq["p1"], xt, "p1", tqs, TQ(**kw), 1, 0)
    assert len(calls) == 1 and tuple(y_p.shape) == (2, 6, 6, 16)
    assert _rel(y_p.numpy(), JL.quant_conv2d(jq["p1"], jnp.asarray(x), "p1", jqs, JQ(**kw), 1, 0)) <= 1e-5
    fake = TL.quant_conv2d(tq["p1"], xt, "p1", tqs, TQ(**{**kw, "use_int8_matmul": False}), 1, 0)
    np.testing.assert_allclose(y_p.numpy(), fake.numpy(), rtol=0, atol=2e-3)
    # a group-scaled or per-channel activation stays on the fake-quant path
    assert TL._int8_qp(tq["p1"], {"a": {"p1": tqs["a"]["g3"]}}, TQ(**kw), "p1") is None
    vec = t_aff.QParams(torch.full((8,), 0.05), torch.full((8,), 128.0))
    assert TL._int8_qp(tq["p1"], {"a": {"p1": vec}}, TQ(**kw), "p1") is None
    assert TL._int8_qp(tq["p1"], tqs, TQ(**kw), "p1") is not None
    assert TL._int8_qp(tq["g3"], tqs, TQ(**kw), "p1") is None  # no packed weights


def test_int8_xla_route_matches_jax_and_gate():
    """int8_impl='xla': the library route against the JAX function on the
    same inputs, the same routing gate, and below the gate the identical
    fake-quant result."""
    assert (TL._INT8_XLA_MIN_M, TL._INT8_XLA_MAX_K) == (JL._INT8_XLA_MIN_M, JL._INT8_XLA_MAX_K)
    for m, k in [(16384, 512), (16383, 512), (16384, 513), (32768, 320), (4, 320)]:
        assert TL._int8_xla_eligible(m, k) == JL._int8_xla_eligible(m, k)
    name, jp, tp, x, jqs, tqs, kw = _linear_setup(m=(TL._INT8_XLA_MIN_M,), seed=2, frac_zp=0.37,
                                                  int8_impl="xla")
    j = JL.quant_linear(jp, jnp.asarray(x), name, jqs, JQ(**kw))
    out = TL.quant_linear(tp, torch.from_numpy(x), name, tqs, TQ(**kw))
    assert _rel(out.numpy(), j) <= 1e-5
    direct = TL._int8_matmul_xla(tp, torch.from_numpy(x), tqs["a"][name], TQ(**kw))
    assert torch.equal(direct, out)
    # the same function as the K6 route's plain version
    k6 = TL.quant_linear(tp, torch.from_numpy(x), name, tqs, TQ(**{**kw, "int8_impl": "pallas"}))
    assert _rel(out.numpy(), k6.numpy()) <= 1e-6
    small = torch.from_numpy(x[:32])
    assert torch.equal(TL.quant_linear(tp, small, name, tqs, TQ(**kw)),
                       TL.quant_linear(tp, small, name, tqs, TQ(**{**kw, "use_int8_matmul": False})))


def test_fold_act_dequant_matches_jax_and_fake_quant():
    """The codes fold (linear and conv, stride and padding variants, bf16)
    against the JAX functions and the port's fake-quant path; per-channel
    scales do not take it."""
    rng = np.random.RandomState(7)
    on, off = dict(use_aq=True, a_bits=8, fold_act_dequant=True), dict(use_aq=True, a_bits=8)
    x = rng.randn(6, 10, 32).astype(np.float32)
    w, b = (rng.randn(32, 48) * 0.1).astype(np.float32), rng.randn(48).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tp = {"w": torch.from_numpy(w.T.copy()), "b": torch.from_numpy(b)}
    jqs = {"a": {"L": j_aff.QParams(jnp.asarray(0.031), jnp.asarray(117.0))}, "sm": {}}
    tqs = {"a": {"L": t_aff.QParams(torch.tensor(0.031), torch.tensor(117.0))}, "sm": {}}
    out = TL.quant_linear(tp, torch.from_numpy(x), "L", tqs, TQ(**on))
    assert _rel(out.numpy(), JL.quant_linear(jp, jnp.asarray(x), "L", jqs, JQ(**on))) <= 1e-5
    np.testing.assert_allclose(
        out.numpy(), TL.quant_linear(tp, torch.from_numpy(x), "L", tqs, TQ(**off)).numpy(),
        rtol=0, atol=1e-5)
    q, d = TL._fold_codes(torch.from_numpy(x * 2.0), tqs["a"]["L"], 8)  # x * 2 clips both sides
    assert torch.equal(q, torch.round(q)) and float(q.min()) == -117.0 and float(q.max()) == 138.0
    np.testing.assert_allclose((q * d).numpy(),
                               t_aff.fake_quant(torch.from_numpy(x * 2.0), tqs["a"]["L"], 8).numpy(),
                               rtol=0, atol=1e-6)

    xc = rng.randn(2, 9, 9, 16).astype(np.float32)
    wc, bc = (rng.randn(3, 3, 16, 24) * 0.1).astype(np.float32), rng.randn(24).astype(np.float32)
    jpc = {"w": jnp.asarray(wc), "b": jnp.asarray(bc)}
    tpc = {"w": torch.from_numpy(np.transpose(wc, (3, 2, 0, 1)).copy()), "b": torch.from_numpy(bc)}
    jqc = {"a": {"C": j_aff.QParams(jnp.asarray(0.044), jnp.asarray(131.0))}, "sm": {}}
    tqc = {"a": {"C": t_aff.QParams(torch.tensor(0.044), torch.tensor(131.0))}, "sm": {}}
    for stride, padding in [(1, 1), (2, 1), (1, 0)]:
        out = TL.quant_conv2d(tpc, torch.from_numpy(xc), "C", tqc, TQ(**on), stride, padding)
        j = JL.quant_conv2d(jpc, jnp.asarray(xc), "C", jqc, JQ(**on), stride, padding)
        assert _rel(out.numpy(), j) <= 1e-5, (stride, padding)
        fake = TL.quant_conv2d(tpc, torch.from_numpy(xc), "C", tqc, TQ(**off), stride, padding)
        np.testing.assert_allclose(out.numpy(), fake.numpy(), rtol=0, atol=1e-5)

    # bf16: the f32 epilogue is kept (the conv runs on exact f32 copies of the
    # codes and weights), so the only rounding is the one cast of the result:
    # within one bf16 ulp (2^-7 relative) of the f32 fold on the same values
    tb = {"w": tpc["w"].bfloat16(), "b": tpc["b"].bfloat16()}
    xb = torch.from_numpy(xc).bfloat16()
    out_b = TL.quant_conv2d(tb, xb, "C", tqc, TQ(**on), 1, 1)
    assert out_b.dtype == torch.bfloat16
    ref = TL.quant_conv2d({"w": tb["w"].float(), "b": tb["b"].float()}, xb.float(), "C", tqc,
                          TQ(**on), 1, 1)
    assert bool(((out_b.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6).all())
    jb = JL.quant_conv2d({"w": jnp.asarray(wc, jnp.bfloat16), "b": jnp.asarray(bc, jnp.bfloat16)},
                         jnp.asarray(xc, jnp.bfloat16), "C", jqc, JQ(**on), 1, 1)
    assert bool(((out_b.float().numpy() - np.asarray(jb, np.float32)) <=
                 2.0 ** -6 * np.abs(ref.numpy()) + 1e-6).all())
    lin_b = TL.quant_linear({"w": tp["w"].bfloat16(), "b": tp["b"].bfloat16()},
                            torch.from_numpy(x).bfloat16(), "L", tqs, TQ(**on))
    assert lin_b.dtype == torch.bfloat16

    vec = {"a": {"C": t_aff.QParams(torch.full((16,), 0.05), torch.full((16,), 128.0))}, "sm": {}}
    assert TL._fold_qp(vec, TQ(**on), "C") is None and TL._fold_qp(tqc, TQ(**off), "C") is None
    assert torch.equal(TL.quant_conv2d(tpc, torch.from_numpy(xc), "C", vec, TQ(**on), 1, 1),
                       TL.quant_conv2d(tpc, torch.from_numpy(xc), "C", vec, TQ(**off), 1, 1))


def test_qconfig_int8_fields():
    assert TQ(use_int8_matmul=True, int8_impl="xla").int8_impl == "xla"
    JQ(int8_impl="cublas")  # the JAX package takes any string and routes it to the kernel
    with pytest.raises(ValueError, match="'pallas', 'xla'"):
        TQ(int8_impl="cublas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TQ(use_int8_conv=True)


@pytest.fixture(scope="module")
def tiny_int8():
    spec = TU.sd_unet_spec(base=32, cross=64)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ehs = rng.randn(2, 77, 64).astype(np.float32)
    t = np.asarray([500, 500], np.int32)
    noise = [(1e-6 * rng.randn(*x.shape)).astype(np.float32) for _ in range(8)]
    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              use_pallas_attention=True, use_int8_matmul=True)
    tq, _ = t_wc.quantize_model_weights(tp, spec, TQ(**kw))
    return spec, tq, x, ehs, t, noise, kw


def test_tiny_unet_int8_within_chaos(interpret_kernel, tiny_int8, monkeypatch):
    """The tiny SD UNet with the int8 path on: every linear and 1x1 conv with
    a per-tensor scale goes through the K6 wrapper (counted), and the output
    is within the chaos bound of the JAX package's (kernel in interpret mode)
    and of the port's own fake-quant forward."""
    spec, tq, x, ehs, t, noise, kw = tiny_int8
    n_packed = sum("w_q8" in p for p in tq.values())
    assert n_packed == sum(1 for n, k, m in spec if n not in ("conv_in", "conv_out")
                           and (k == "linear" or (k == "conv" and m[2] == 1)))
    jp = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), params_to_numpy(tq, spec),
                      is_leaf=lambda a: a is None)
    fn = jax.jit(functools.partial(JU.unet_sd_apply, qstate=j_syn(spec, 0, False, jnp.float32),
                                   cfg=JQ(**kw)))

    def run(xx):
        return np.asarray(fn(jp, jnp.asarray(xx), jnp.asarray(t), jnp.asarray(ehs)))
    j = run(x)
    chaos = max(np.abs(run(x + n) - j).max() for n in noise)
    calls = []
    real = TL.quantized_matmul
    monkeypatch.setattr(TL, "quantized_matmul", lambda *a, **k: calls.append(1) or real(*a, **k))
    tqs = t_syn(spec, 0, False, torch.float32, device="cpu")
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs))
    with torch.no_grad():
        out = TU.unet_sd_apply(tq, *args, qstate=tqs, cfg=TQ(**kw)).numpy()
        assert len(calls) == n_packed
        fake = TU.unet_sd_apply(tq, *args, qstate=tqs,
                                cfg=TQ(**{**kw, "use_int8_matmul": False})).numpy()
        assert len(calls) == n_packed
    bound = max(5 * chaos, 1e-4)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01
    assert np.abs(out - j).max() <= bound, (np.abs(out - j).max(), chaos)
    assert np.abs(out - fake).max() <= bound, (np.abs(out - fake).max(), chaos)
