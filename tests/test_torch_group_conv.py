"""The port's group-quantized conv path (dgq_tpu_torch.models.layers group
branch and dgq_tpu_torch.ops.group_conv, the module holding kernel K5) on the
CPU, against the JAX package on the same numpy inputs: the Pallas kernel runs
in interpret mode, as tests/test_group_conv_kernel.py runs it; the port's
`group_quant_conv` takes its plain version, because the tensors are on the
CPU.

Tolerances: atol 2e-3 against JAX and between impls, the bound of
tests/test_group_conv_kernel.py:42 (f32 reassociation of sums of up to
9*C products of codes below 2^8 and weights of about 0.1, and the
fake-quant form delta*q against the folded form q @ (delta*w)); unfold_nhwc
is a pure data movement and is exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from dgq_tpu.models import layers as JL  # noqa: E402
from dgq_tpu.models.qconfig import GroupQParams as JG, QConfig as JQ  # noqa: E402
from dgq_tpu.ops.pallas import group_conv as JGC  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu_torch.io.convert import conv_w_to_torch, qstate_from_numpy  # noqa: E402
from dgq_tpu_torch.models import layers as TL  # noqa: E402
from dgq_tpu_torch.models.qconfig import GroupQParams as TG, QConfig as TQ  # noqa: E402
from dgq_tpu_torch.ops import group_conv as TGC  # noqa: E402

ATOL = 2e-3
IMPLS = ("taps", "fused", "im2col", "unfold")


def _mk(seed, c, o, k=3, zp=(100, 156), dl=1.0, zl=0.0):
    """numpy HWIO weight, bias, and group params with a c-major mid axis."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, k, c, o) * 0.1).astype(np.float32)
    b = (rng.randn(o) * 0.1).astype(np.float32)
    dm = rng.uniform(0.02, 0.08, (c * k * k,)).astype(np.float32)
    zm = rng.uniform(zp[0], zp[1], (c * k * k,)).astype(np.float32)
    return rng, w, b, (dm, zm, np.full((1,), dl, np.float32), np.full((1,), zl, np.float32))


def _jp(w, b):
    return {"w": jnp.asarray(w), "b": None if b is None else jnp.asarray(b)}


def _tp(w, b):
    return {"w": torch.from_numpy(conv_w_to_torch(w).copy()),
            "b": None if b is None else torch.from_numpy(b)}


def _jax_fused(x, w, b, g, k, pad, a_bits):
    c = x.shape[-1]
    dm, zm, dl, zl = (jnp.asarray(a) for a in g)
    return np.asarray(JGC.group_quant_conv(
        jnp.asarray(x), jnp.asarray(w), dm.reshape(c, k * k).T, zm.reshape(c, k * k).T,
        dl[0], zl[0], None if b is None else jnp.asarray(b), kh=k, kw=k, padding=pad,
        a_bits=a_bits, interpret=True))


def _torch_fused(x, w, b, g, k, pad, a_bits):
    c = x.shape[-1]
    dm, zm, dl, zl = (torch.from_numpy(a) for a in g)
    TGC.reset_launch_counts()
    out = TGC.group_quant_conv(
        torch.from_numpy(x), torch.from_numpy(w), dm.reshape(c, k * k).t(),
        zm.reshape(c, k * k).t(), dl, zl, None if b is None else torch.from_numpy(b),
        kh=k, kw=k, padding=pad, a_bits=a_bits)
    assert TGC.LAUNCHES == {"group_quant_conv": 0}  # the CPU never counts a launch
    return out.numpy()


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (3, 1, 0)])
def test_unfold_nhwc_exact(k, stride, pad):
    x = np.random.RandomState(k + stride).randn(2, 9, 7, 5).astype(np.float32)
    t = TL.unfold_nhwc(torch.from_numpy(x), k, k, stride, pad)
    ref = F.unfold(torch.from_numpy(x).permute(0, 3, 1, 2), (k, k), padding=pad, stride=stride)
    assert torch.equal(t, ref)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(JL.unfold_nhwc(jnp.asarray(x), k, k, stride, pad)))


def test_conv2d_unfolded_is_the_conv():
    rng, w, b, _ = _mk(0, 6, 10)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    tp = _tp(w, b)
    unf = TL.unfold_nhwc(torch.from_numpy(x), 3, 3, 1, 1)
    np.testing.assert_allclose(TL.conv2d_unfolded(tp, unf, (8, 8)).numpy(),
                               TL.conv2d(tp, torch.from_numpy(x), 1, 1).numpy(), atol=1e-5)
    j = JL.conv2d_unfolded(_jp(w, b), JL.unfold_nhwc(jnp.asarray(x), 3, 3, 1, 1), (8, 8))
    np.testing.assert_allclose(TL.conv2d_unfolded(tp, unf, (8, 8)).numpy(), np.asarray(j),
                               atol=1e-5)


@pytest.mark.parametrize("c,o,h,a_bits,zp,dl", [
    (32, 48, 8, 8, (100, 156), 1.0),   # tests/test_group_conv_kernel.py's shapes
    (16, 16, 12, 8, (100, 156), 1.0),
    (16, 16, 8, 6, (20, 40), 1.0),     # A6
    (8, 24, 6, 8, (100, 156), 1.0),    # odd O and H
    (16, 24, 8, 8, (-40, 300), 1.0),   # zero points outside [0, 255]: the halo is not code 0
    (16, 24, 8, 8, (100, 156), 1.37),  # delta_last != 1 is folded into the weights
])
def test_fused_and_taps_match_jax(c, o, h, a_bits, zp, dl):
    rng, w, b, g = _mk(c + o + h, c, o, zp=zp, dl=dl, zl=0.25 if dl != 1.0 else 0.0)
    x = rng.randn(2, h, h, c).astype(np.float32) * 2.0
    j_fused = _jax_fused(x, w, b, g, 3, 1, a_bits)
    j_taps = np.asarray(JL.group_quant_conv2d_taps(
        _jp(w, b), jnp.asarray(x), JG(*(jnp.asarray(a) for a in g)),
        JQ(a_bits=a_bits, use_aq=True), 1, 1))
    t_fused = _torch_fused(x, w, b, g, 3, 1, a_bits)
    t_taps = TL.group_quant_conv2d_taps(
        _tp(w, b), torch.from_numpy(x), TG(*(torch.from_numpy(a) for a in g)),
        TQ(a_bits=a_bits, use_aq=True), 1, 1).numpy()
    assert t_fused.shape == j_fused.shape == (2, h, h, o)
    for name, t, j in [("fused", t_fused, j_fused), ("taps", t_taps, j_taps),
                       ("fused vs taps", t_fused, t_taps)]:
        assert np.abs(t - j).max() <= ATOL, (name, np.abs(t - j).max())
    assert np.abs(t_fused).max() > 0.1


def test_halo_is_quantized_zero_not_zero():
    """With every zero point above 255 the code of a padded position is
    clip(0, -z, 255 - z) = 255 - z < 0; a kernel that skipped the halo
    would differ at the border and agree inside."""
    rng, w, b, g = _mk(5, 8, 8, zp=(300, 320))
    x = rng.randn(1, 6, 6, 8).astype(np.float32)
    out = _torch_fused(x, w, b, g, 3, 1, 8)
    np.testing.assert_allclose(out, _jax_fused(x, w, b, g, 3, 1, 8), atol=ATOL)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    dm, zm = g[0].reshape(8, 9).T, g[1].reshape(8, 9).T
    skip = np.zeros_like(out)
    for t in range(9):
        i, jj = divmod(t, 3)
        q = np.clip(np.round(xp[:, i:i + 6, jj:jj + 6, :] / dm[t]), -zm[t], 255 - zm[t])
        inside = np.zeros((1, 8, 8, 1), np.float32)
        inside[:, 1:-1, 1:-1] = 1.0
        q = q * inside[:, i:i + 6, jj:jj + 6]  # the wrong form: halo codes forced to 0
        skip += (q * dm[t]) @ w[i, jj]
    skip += b
    assert np.abs(out - skip)[:, 1:-1, 1:-1].max() <= ATOL
    assert np.abs(out - skip)[:, 0].max() > 0.1


@pytest.mark.parametrize("stride", [1, 2])
def test_impls_agree_and_match_jax(stride):
    """All four group_conv_impl values through quant_conv2d, f32: each against
    the JAX package's same impl, and against each other. Stride 2 is not
    fused-eligible, so 'fused' takes the taps path and equals it exactly."""
    rng, w, b, g = _mk(2 + stride, 16, 24)
    x = rng.randn(1, 8, 8, 16).astype(np.float32) * 2.0
    jqs = {"a": {"L": JG(*(jnp.asarray(a) for a in g))}, "sm": {}}
    tqs = qstate_from_numpy({"a": {"L": JG(*g)}, "sm": {}}, device="cpu")
    assert isinstance(tqs["a"]["L"], TG)
    outs = {}
    for impl in IMPLS:
        kw = dict(a_bits=8, use_aq=True, group_conv_layers=("L",), group_conv_impl=impl)
        t = TL.quant_conv2d(_tp(w, b), torch.from_numpy(x), "L", tqs, TQ(**kw), stride, 1)
        outs[impl] = t.numpy()
        j = JL.quant_conv2d(_jp(w, b), jnp.asarray(x), "L", jqs, JQ(**kw), stride, 1)
        assert np.abs(outs[impl] - np.asarray(j)).max() <= ATOL, impl
    for impl in IMPLS[1:]:
        assert np.abs(outs[impl] - outs["taps"]).max() <= ATOL, impl
    gqp = tqs["a"]["L"]
    assert TGC.fused_eligible(x.shape, 24, 3, 3, 1, 1, gqp)
    assert not TGC.fused_eligible(x.shape, 24, 3, 3, 2, 1, gqp)
    if stride == 2:
        np.testing.assert_array_equal(outs["fused"], outs["taps"])
        assert outs["taps"].shape == (1, 4, 4, 24)


def test_spatial_groups_take_the_taps_path():
    rng, w, b, g = _mk(9, 16, 24)
    x = rng.randn(1, 8, 8, 16).astype(np.float32)
    g = (g[0], g[1], np.full((64,), 1.1, np.float32), np.zeros((64,), np.float32))
    tqs = {"a": {"L": TG(*(torch.from_numpy(a) for a in g))}, "sm": {}}
    assert not TGC.fused_eligible(x.shape, 24, 3, 3, 1, 1, tqs["a"]["L"])
    kw = dict(a_bits=8, use_aq=True, group_conv_layers=("L",))
    outs = {impl: TL.quant_conv2d(_tp(w, b), torch.from_numpy(x), "L", tqs,
                                  TQ(group_conv_impl=impl, **kw), 1, 1).numpy()
            for impl in IMPLS}
    np.testing.assert_array_equal(outs["fused"], outs["taps"])
    j = JL.quant_conv2d(_jp(w, b), jnp.asarray(x), "L",
                        {"a": {"L": JG(*(jnp.asarray(a) for a in g))}, "sm": {}},
                        JQ(group_conv_impl="taps", **kw), 1, 1)
    for impl in IMPLS:
        assert np.abs(outs[impl] - np.asarray(j)).max() <= ATOL, impl


@pytest.mark.parametrize("scalar_zp", [False, True])
def test_per_channel_plain_qparams_on_group_layer(scalar_zp):
    """A plain QParams with a per-channel (C,) delta on a group-listed layer
    applies delta[c] to every tap of channel c under every impl."""
    rng = np.random.RandomState(4)
    c, o = 12, 16
    w = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)
    b = (rng.randn(o) * 0.1).astype(np.float32)
    x = rng.randn(2, 12, 12, c).astype(np.float32)
    delta = rng.uniform(0.02, 0.08, (c,)).astype(np.float32)
    zp = np.float32(128.0) if scalar_zp else rng.uniform(100, 156, (c,)).astype(np.float32)
    jqs = {"a": {"L": JQP(jnp.asarray(delta), jnp.asarray(zp))}, "sm": {}}
    tqs = qstate_from_numpy({"a": {"L": JQP(delta, zp)}, "sm": {}}, device="cpu")
    kw = dict(a_bits=8, use_aq=True, group_conv_layers=("L",))
    for impl in IMPLS:
        t = TL.quant_conv2d(_tp(w, b), torch.from_numpy(x), "L", tqs,
                            TQ(group_conv_impl=impl, **kw), 1, 1).numpy()
        j = JL.quant_conv2d(_jp(w, b), jnp.asarray(x), "L", jqs,
                            JQ(group_conv_impl="taps" if impl == "fused" else impl, **kw), 1, 1)
        assert np.abs(t - np.asarray(j)).max() <= ATOL, impl


def test_group_layer_without_state_or_with_aq_off_is_the_plain_conv():
    rng, w, b, _ = _mk(6, 8, 8)
    x = torch.from_numpy(rng.randn(1, 6, 6, 8).astype(np.float32))
    tp = _tp(w, b)
    ref = TL.conv2d(tp, x, 1, 1)
    for impl in IMPLS:
        cfg = TQ(use_aq=True, group_conv_layers=("L",), group_conv_impl=impl)
        out = TL.quant_conv2d(tp, x, "L", {"a": {}, "sm": {}}, cfg, 1, 1)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    off = TL.quant_conv2d(tp, x, "L", None, TQ(group_conv_layers=("L",)), 1, 1)
    assert torch.equal(off, ref)


def test_taps_bf16_fold_unbiased():
    """The shifted-clip codes keep the fractional zero point out of the bf16
    matmul feed: the per-channel signed mean error of a bf16 run against the
    f32 run centres on zero (bound 1e-2, as tests/test_group_conv_kernel.py)."""
    rng, w, _, g = _mk(5, 64, 64)
    x = torch.from_numpy(rng.randn(2, 8, 8, 64).astype(np.float32))
    gqp = TG(*(torch.from_numpy(a) for a in g))
    cfg = TQ(a_bits=8, use_aq=True)
    ref = TL.group_quant_conv2d_taps(_tp(w, None), x, gqp, cfg, 1, 1)
    tp16 = {"w": _tp(w, None)["w"].bfloat16(), "b": None}
    out = TL.group_quant_conv2d_taps(tp16, x.bfloat16(), gqp, cfg, 1, 1)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref).mean(dim=(0, 1, 2)).abs().max()) < 1e-2


def test_wrapper_rejects_bad_arguments():
    rng, w, b, g = _mk(7, 8, 8)
    x = torch.from_numpy(rng.randn(1, 6, 6, 8).astype(np.float32))
    dm = torch.from_numpy(g[0]).reshape(8, 9).t()
    one, zero = torch.ones(1), torch.zeros(1)
    with pytest.raises(ValueError, match=r"\(kh\*kw, C\)"):
        TGC.group_quant_conv(x, torch.from_numpy(w), dm.t(), dm.t(), one, zero, None)
    with pytest.raises(ValueError, match="scalars"):
        TGC.group_quant_conv(x, torch.from_numpy(w), dm, dm, torch.ones(36), zero, None)
    with pytest.raises(ValueError, match="not .kh, kw, C, O."):
        TGC.group_quant_conv(x, torch.from_numpy(conv_w_to_torch(w).copy()), dm, dm, one, zero,
                             None)
    # a non-CPU tensor never reaches the plain version
    xm = torch.empty(1, 6, 6, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        TGC.group_quant_conv(xm, torch.from_numpy(w), dm, dm, one, zero, None)
