"""The packed head-slot attention path of the port (pack_attention_heads,
`fused_attention(num_heads=)`, the gate in `attention`, the tiny UNets with
`QConfig(packed_attention=True)`) on the CPU, against the JAX package on the
same numpy inputs. The JAX side runs its packed Pallas kernels (K1p to K4p)
in interpret mode; the port's side runs the packed entries' plain version,
which `fused_attention` takes for CPU tensors.

Tolerances:
  * pack_attention_heads and the head (un)packers move numbers and add
    zeros: bit-identical, through the weight bridge in both directions.
  * `fused_attention(num_heads=)` against the packed Pallas kernels: atol
    2e-3 as tests/test_torch_attention.py (blockwise online softmax against a
    materialized one), against the JAX materialized oracle 1e-5 (the same
    math in another summation order). The quantizing modes differ: at the
    grid's uniform delta of 0.004 a probability within float error of a bin
    boundary takes the neighbouring code, one bin of 0.004 |v| on that row's
    outputs (measured: one or two rows of 512), so the uniform mode gets two
    bins more elementwise, 2 * delta * max|v|, and a mean error under 1e-4
    (1e-5 against the oracle); a log2 code flips at a half-integer exponent
    and changes its probability by a factor of 2, so the log2 modes are held
    by the share of outputs off by more than 2e-3, under 5e-4.
  * a transformer block with packed weights: 2e-4, as the unpacked block in
    tests/test_torch_layers.py.
  * tiny UNets: fp 1e-4 (SD) and 1e-5 of the output's size (SDXL), as the
    unpacked tests; quantized SD within the chaos bound of
    tests/test_packed_in_model.py, err <= max(5 * chaos, 1e-4), chaos the JAX
    packed net's largest output change over eight 1e-6 input perturbations.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.calib import weight_calib as JW  # noqa: E402
from dgq_tpu.models import layers as JL  # noqa: E402
from dgq_tpu.models import unet_sd as JU  # noqa: E402
from dgq_tpu.models import unet_sdxl as JX  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQ  # noqa: E402
from dgq_tpu.models.unet_sd import _transformer_spec  # noqa: E402
from dgq_tpu.ops.pallas import attention as JA  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_group_qstate as j_gsyn  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_pertensor_qstate as j_syn  # noqa: E402
from dgq_tpu_torch.calib import weight_calib as TW  # noqa: E402
from dgq_tpu_torch.io.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy, qstate_from_numpy)
from dgq_tpu_torch.models import layers as TL  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models import unet_sdxl as TX  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQ  # noqa: E402
from dgq_tpu_torch.ops import attention as TA  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _jnp_tree(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


# ---------------------------------------------------------------- weights

ATTN_SPEC = [
    ("blk.attn1.to_q", "linear", (80, 80, False)),
    ("blk.attn1.to_k", "linear", (48, 80, True)),   # a bias, to see it padded
    ("blk.attn1.to_v", "linear", (48, 80, False)),
    ("blk.attn1.to_out.0", "linear", (80, 80, True)),
    ("blk.ff", "linear", (80, 80, True)),
    ("blk.norm", "layernorm", (80,)),
]


def _attn_params_np(seed=0):
    rng = np.random.RandomState(seed)
    params = {}
    for name, kind, meta in ATTN_SPEC:
        if kind == "linear":
            i_d, o_d, bias = meta
            params[name] = {"w": rng.randn(i_d, o_d).astype(np.float32),
                            "b": rng.randn(o_d).astype(np.float32) if bias else None}
        else:
            params[name] = {"scale": rng.randn(*meta).astype(np.float32),
                            "bias": rng.randn(*meta).astype(np.float32)}
    return params


@pytest.mark.parametrize("heads", ["int", "callable"])
@pytest.mark.parametrize("slot,dp", [(64, 64), (128, 128)])
def test_pack_attention_heads_bit_identical_through_bridge(slot, dp, heads):
    """Packed by the JAX package then carried over == carried over then packed
    by the port, leaf for leaf, and back again."""
    num_heads = 2 if heads == "int" else (lambda o: o // 40)
    params_np = _attn_params_np()
    j_packed = _np_tree(JW.pack_attention_heads(_jnp_tree(params_np), ATTN_SPEC, num_heads, slot))
    tp = params_from_numpy(params_np, ATTN_SPEC, device="cpu")
    t_packed = TW.pack_attention_heads(tp, ATTN_SPEC, num_heads, slot)

    # leaves it does not touch are shared, not copied
    assert t_packed["blk.ff"] is tp["blk.ff"] and t_packed["blk.norm"] is tp["blk.norm"]
    assert t_packed is not tp and tp["blk.attn1.to_q"]["w"].shape == (80, 80)
    assert tuple(t_packed["blk.attn1.to_q"]["w"].shape) == (2 * dp, 80)      # zero rows
    assert tuple(t_packed["blk.attn1.to_k"]["w"].shape) == (2 * dp, 48)
    assert tuple(t_packed["blk.attn1.to_k"]["b"].shape) == (2 * dp,)
    assert tuple(t_packed["blk.attn1.to_out.0"]["w"].shape) == (80, 2 * dp)  # zero columns
    assert tuple(t_packed["blk.attn1.to_out.0"]["b"].shape) == (80,)

    via_jax = params_from_numpy(j_packed, ATTN_SPEC, device="cpu")
    back = params_to_numpy(t_packed, ATTN_SPEC)
    for name, _, _ in ATTN_SPEC:
        for leaf, want in j_packed[name].items():
            if want is None:
                assert t_packed[name][leaf] is None and back[name][leaf] is None
                continue
            assert torch.equal(t_packed[name][leaf], via_jax[name][leaf]), (name, leaf)
            np.testing.assert_array_equal(back[name][leaf], want)

    # what the layout is for: the projection's real lanes are the unpacked
    # ones, the padding lanes exact zeros (bias included), to_out.0 reads them
    x = torch.from_numpy(_rand(3, 48, seed=1))
    y = TL.linear(t_packed["blk.attn1.to_k"], x).reshape(3, 2, dp)
    assert torch.equal(y[..., :40].reshape(3, 80), TL.linear(tp["blk.attn1.to_k"], x))
    assert bool((y[..., 40:] == 0).all())
    o = torch.from_numpy(_rand(1, 3, 80, seed=2))
    np.testing.assert_allclose(
        TL.linear(t_packed["blk.attn1.to_out.0"], TL._repack_heads(o, 2, dp)).numpy(),
        TL.linear(tp["blk.attn1.to_out.0"], o).numpy(), rtol=0, atol=1e-5)


def test_pack_attention_heads_leaves_64_wide_heads_alone():
    """SDXL's heads are 64 wide: nothing to pad, every entry is shared."""
    spec = [("a.to_q", "linear", (128, 128, False)), ("a.to_out.0", "linear", (128, 128, True))]
    tp = {n: {"w": torch.randn(128, 128), "b": None} for n, _, _ in spec}
    packed = TW.pack_attention_heads(tp, spec, num_heads=lambda o: o // 64)
    assert all(packed[n] is tp[n] for n in tp)
    assert TW._head_slot_width(64, 2, 64) == JW._head_slot_width(64, 2, 64) == 64
    # an odd head count cannot pair: the slot is 128 even at slot=64
    for d, h, slot in [(40, 8, 64), (40, 3, 64), (80, 8, 64), (160, 8, 64), (40, 8, 128),
                       (64, 10, 128)]:
        assert TW._head_slot_width(d, h, slot) == JW._head_slot_width(d, h, slot)


@pytest.mark.parametrize("dp", [64, 128])
def test_unpack_and_repack_heads(dp):
    h, d = 2, 40
    x = _rand(2, 5, h * d, seed=3)
    packed = TL._repack_heads(torch.from_numpy(x), h, dp)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JL._repack_heads(jnp.asarray(x), h, dp)))
    assert tuple(packed.shape) == (2, 5, h * dp)
    assert bool((packed.reshape(2, 5, h, dp)[..., d:] == 0).all())
    back = TL._unpack_heads(packed, h, d)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JL._unpack_heads(jnp.asarray(packed.numpy()), h, d)))
    # the ops module's own pair moves between (B, T, H*dp) and (B*H, T, d)
    classic = TA.unpack_heads(packed, h, d)
    assert tuple(classic.shape) == (2 * h, 5, d)
    assert torch.equal(TA.repack_heads(classic, h, dp), packed)


# ---------------------------------------------------------------- fused_attention


def _pack_np(x, h, dp):
    """(B*H, T, d) -> (B, T, H*dp) zero-padded head slots."""
    bh, t, d = x.shape
    x4 = np.pad(x.reshape(bh // h, h, t, d), ((0, 0), (0, 0), (0, 0), (0, dp - d)))
    return np.ascontiguousarray(x4.transpose(0, 2, 1, 3)).reshape(bh // h, t, h * dp)


def _share(a, b):
    return float((np.abs(a - b) > 2e-3).mean())


@pytest.mark.parametrize("sm_mode,start_peak", [
    ("none", False), ("uniform", False), ("log2", False), ("log2_real_time", False),
    ("log2_real_time", True)])
@pytest.mark.parametrize("t,s", [(128, 128), (128, 77)])
@pytest.mark.parametrize("dp", [128, 64])
def test_packed_plain_matches_packed_pallas_kernels(sm_mode, start_peak, t, s, dp):
    """The grid of tests/test_packed_attention.py: K2p, K1p, K4p and K3p in
    interpret mode against the port's `fused_attention(num_heads=)`."""
    h, d, b = 2, 40, 2
    q, k, v = (_rand(b * h, n, d, seed=i + t + s) for i, n in enumerate((t, s, s)))
    scale = d ** -0.5
    delta = np.float32(0.004) if sm_mode in ("uniform", "log2") else None
    qp, kp, vp = (_pack_np(a, h, dp) for a in (q, k, v))
    j = np.asarray(JA.fused_attention(
        jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp), scale, sm_mode=sm_mode, sm_bits=8,
        sm_delta=None if delta is None else jnp.asarray(delta), start_peak=start_peak,
        interpret=True, num_heads=h))
    kw = dict(sm_mode=sm_mode, sm_bits=8, sm_delta=None if delta is None else torch.tensor(delta),
              start_peak=start_peak, num_heads=h)
    out = TA.fused_attention(*(torch.from_numpy(a) for a in (qp, kp, vp)), scale, **kw)
    assert tuple(out.shape) == (b, t, h * dp) and out.dtype == torch.float32
    assert bool((out.reshape(b, t, h, dp)[..., d:] == 0).all())  # padding lanes: zeros
    # the true head width changes nothing: the lanes left out are zeros
    narrow = TA.fused_attention(*(torch.from_numpy(a) for a in (qp, kp, vp)), scale,
                                head_dim=d, **kw)
    assert torch.equal(narrow, out)
    # and it is the classic path's numbers in another place
    classic = TA.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                                 **{**kw, "num_heads": None})
    assert torch.equal(TA.unpack_heads(out, h, d), classic)

    oracle = _pack_np(np.asarray(JA.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, sm_mode=sm_mode, sm_bits=8,
        sm_delta=None if delta is None else jnp.asarray(delta), start_peak=start_peak)), h, dp)
    if sm_mode == "none":
        np.testing.assert_allclose(out.numpy(), j, rtol=0, atol=2e-3)
        np.testing.assert_allclose(out.numpy(), oracle, rtol=0, atol=1e-5)
    elif sm_mode == "uniform":
        flip = 2.0 * float(delta) * np.abs(v).max()
        np.testing.assert_allclose(out.numpy(), j, rtol=0, atol=2e-3 + flip)
        np.testing.assert_allclose(out.numpy(), oracle, rtol=0, atol=1e-5 + flip)
        assert np.abs(out.numpy() - j).mean() <= 1e-4
        assert np.abs(out.numpy() - oracle).mean() <= 1e-5
    else:
        assert _share(out.numpy(), j) < 5e-4, np.abs(out.numpy() - j).max()
        assert _share(out.numpy(), oracle) < 5e-4


def test_packed_real_time_delta_spans_batches_and_heads():
    """K3p's delta is one for the whole call: a peaky head in batch 1 changes
    the output of batch 0."""
    h, d, dp = 2, 8, 64
    q, k, v = (_rand(2 * h, 16, d, seed=5 + i) for i in range(3))
    q2 = q.copy()
    q2[3] *= 8.0
    run = lambda qq: TA.fused_attention(  # noqa: E731
        *(torch.from_numpy(_pack_np(a, h, dp)) for a in (qq, k, v)), 0.35,
        sm_mode="log2_real_time", sm_bits=4, num_heads=h, head_dim=d)
    assert float((run(q)[0] - run(q2)[0]).abs().max()) > 1e-3


def test_packed_slot_checks_raise():
    """The JAX package's slot rules (attention.py:822-828), on every device."""
    def run(width, heads, **kw):
        x = torch.zeros(1, 8, width)
        return TA.fused_attention(x, x, x, 0.1, num_heads=heads, **kw)

    with pytest.raises(ValueError, match="even head count"):
        run(3 * 64, 3)
    with pytest.raises(ValueError, match="64 or a multiple of 128"):
        run(2 * 96, 2)
    with pytest.raises(ValueError, match="no multiple of num_heads"):
        run(130, 4)
    with pytest.raises(ValueError, match="does not fit the slot"):
        run(2 * 64, 2, head_dim=80)
    with pytest.raises(ValueError, match="packed layout"):
        TA.fused_attention(torch.zeros(2, 8, 40), torch.zeros(2, 8, 40), torch.zeros(2, 8, 40),
                           0.1, head_dim=40)
    # the same inputs on the JAX side
    with pytest.raises(ValueError, match="even head count"):
        z = jnp.zeros((1, 8, 3 * 64))
        JA.fused_attention(z, z, z, 0.1, num_heads=3, interpret=True)
    assert run(2 * 64, 2).shape == (1, 8, 128) and run(256, 1).shape == (1, 8, 256)


def test_packed_non_cpu_tensor_goes_to_kernel_wrapper():
    """A tensor that is not on the CPU never reaches the plain version, in any
    mode; nothing is counted without a launch."""
    TA.reset_launch_counts()
    q = torch.empty(2, 16, 128, device="meta")
    for mode, sp in [("none", False), ("uniform", False), ("uniform", True), ("log2", False),
                     ("log2_real_time", True)]:
        with pytest.raises(ValueError, match="CUDA tensors"):
            TA.fused_attention(q, q, q, 0.1, sm_mode=mode, sm_delta=torch.tensor(0.1),
                               start_peak=sp, num_heads=2, head_dim=40)
    x = torch.zeros(1, 8, 128)
    TA.fused_attention(x, x, x, 0.1, num_heads=2)
    assert all(n == 0 for n in TA.LAUNCHES.values())
    assert {n for n in TA.LAUNCHES if n.endswith("_packed")} == {
        "flash_attention_packed", "static_uniform_attention_packed", "rt_stats_packed",
        "quant_accum_packed", "static_quant_attention_packed"}


def test_packed_out_buffer_is_overwritten():
    """`out=`: the buffer is filled, padding lanes included, whatever it held."""
    h, d, dp = 2, 40, 64
    q, k, v = (torch.from_numpy(_pack_np(_rand(2 * h, 16, d, seed=9 + i), h, dp))
               for i in range(3))
    buf = torch.full((2, 16, h * dp), float("nan"))
    got = TA.fused_attention(q, k, v, 0.2, num_heads=h, head_dim=d, out=buf)
    assert got is buf and bool(buf.isfinite().all())
    assert torch.equal(buf, TA.fused_attention(q, k, v, 0.2, num_heads=h, head_dim=d))


# ---------------------------------------------------------------- attention()


def _block(slot, seed=13):
    """A transformer block (8 heads of 8 at width 64, cross width 48) with
    random biases, its packed form on both sides, inputs and a qstate."""
    spec = _transformer_spec("tb", 64, 48)
    jp = JU.init_unet_sd(jax.random.PRNGKey(seed), spec=spec)
    rng = np.random.RandomState(seed + 100)
    for p in jp.values():
        for leaf in ("b", "bias", "scale"):
            if p.get(leaf) is not None:
                p[leaf] = jnp.asarray(rng.randn(*p[leaf].shape).astype(np.float32) * 0.3
                                      + (1.0 if leaf == "scale" else 0.0))
    tp = params_from_numpy(_np_tree(jp), spec, device="cpu")
    a = {}
    for pre in ("tb.attn1", "tb.attn2"):
        for s in ("q", "k", "v"):
            a[f"{pre}.aqtizer_{s}"] = JQP(np.float32(0.05), np.float32(128.0))
        a[f"{pre}.aqtizer_w"] = JQP(np.float32(1.0 / 255.0), np.float32(0.0))
    return (spec, JW.pack_attention_heads(jp, spec, 8, slot),
            TW.pack_attention_heads(tp, spec, 8, slot), tp, {"a": a, "sm": {}})


@pytest.mark.parametrize("policy", ["fp", "uniform", "log2_real_time_start_peak"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("slot", [64, 128])
def test_transformer_block_with_packed_weights(slot, fused, policy):
    """`attention()` with packed weights inside a block (attn1 self, attn2
    cross with start_peak when the policy has it): the packed kernels' route
    (`fused`) and, with use_pallas_attention off, the route that slices the
    packed projections back, runs the classic path and re-pads for to_out.0."""
    spec, jpk, tpk, tp, qs = _block(slot)
    x, ehs = _rand(2, 16, 64, seed=14), _rand(2, 77, 48, seed=15)
    kw = dict(use_aq=policy != "fp", use_pallas_attention=fused, a_bits=8, softmax_bits=8,
              packed_attention=True)
    if policy.startswith("log2"):
        kw.update(t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True)
    jq = None if policy == "fp" else jax.tree.map(jnp.asarray, qs)
    tq = None if policy == "fp" else qstate_from_numpy(qs, device="cpu")
    j = np.asarray(JL.basic_transformer_block(jpk, "tb", jnp.asarray(x), jnp.asarray(ehs), 8, jq,
                                              JQ(**kw)))
    seen = []
    real = TL.fused_attention
    try:
        TL.fused_attention = lambda *a, **k: seen.append(k.get("num_heads")) or real(*a, **k)
        out = TL.basic_transformer_block(tpk, "tb", torch.from_numpy(x), torch.from_numpy(ehs), 8,
                                         tq, TQ(**kw))
    finally:
        TL.fused_attention = real
    assert seen == ([8, 8] if fused else [])  # the packed entry, or the materialized softmax
    np.testing.assert_allclose(out.numpy(), j, rtol=0, atol=2e-4)
    # and the unpacked weights under the unpacked configuration give the same block
    plain = TL.basic_transformer_block(tp, "tb", torch.from_numpy(x), torch.from_numpy(ehs), 8,
                                       tq, TQ(**{**kw, "packed_attention": False}))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=0, atol=2e-4)


def test_attention_gate_routes_like_the_jax_package():
    """Packed configuration, three cases of the gate: slot-aligned packed
    weights take the packed entry; unpacked weights with heads that fill no
    slot (8 of 8) take the classic entry unchanged; an odd head count at slot
    64 packs to 128 and takes the packed entry."""
    spec, _, tpk, tp, _ = _block(64)
    x, ehs = torch.from_numpy(_rand(2, 16, 64, seed=14)), torch.from_numpy(_rand(2, 77, 48, seed=15))
    cfg = TQ(use_pallas_attention=True, packed_attention=True)
    calls = []
    real = TL.fused_attention
    try:
        TL.fused_attention = lambda *a, **k: calls.append(
            (tuple(a[0].shape), k.get("num_heads"), k.get("head_dim"))) or real(*a, **k)
        a = TL.attention(tpk, "tb.attn1", x, None, 8, None, cfg)
        b = TL.attention(tp, "tb.attn1", x, None, 8, None, cfg)
        odd = TW.pack_attention_heads(tp, spec, 1, 64)  # one head of 64: h odd
        c = TL.attention(odd, "tb.attn2", x, ehs, 1, None, cfg)
    finally:
        TL.fused_attention = real
    assert calls == [((2, 16, 512), 8, 8), ((16, 16, 8), None, None), ((2, 16, 128), 1, 64)]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    ref = TL.attention(tp, "tb.attn2", x, ehs, 1, None, TQ(use_pallas_attention=True))
    np.testing.assert_allclose(c.numpy(), ref.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- tiny UNets


@pytest.fixture(scope="module")
def tiny_sd():
    spec = TU.sd_unet_spec(base=32, cross=64)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ehs = rng.randn(2, 77, 64).astype(np.float32)
    t = np.asarray([500, 500], np.int32)
    noise = [(1e-6 * rng.randn(*x.shape)).astype(np.float32) for _ in range(8)]
    return spec, tp, x, ehs, t, noise


def _jax_sd(params, spec, qstate, cfg):
    jp = _jnp_tree(params_to_numpy(params, spec))
    fn = jax.jit(functools.partial(JU.unet_sd_apply, qstate=qstate, cfg=cfg))
    return lambda x, t, ehs: np.asarray(fn(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs)))


def _torch_sd(params, x, t, ehs, qstate, cfg):
    with torch.no_grad():
        return TU.unet_sd_apply(params, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(ehs), qstate=qstate, cfg=cfg).numpy()


@pytest.mark.parametrize("slot", [64, 128])
def test_tiny_unet_packed_fp_forward(tiny_sd, slot):
    """Packed by the port, carried to JAX through the bridge, run packed on
    both sides; the port's packed and unpacked forwards agree too."""
    spec, tp, x, ehs, t, _ = tiny_sd
    packed = TW.pack_attention_heads(tp, spec, num_heads=8, slot=slot)
    assert tuple(packed["mid_block.attentions.0.transformer_blocks.0.attn1.to_q"]["w"].shape) == (
        8 * slot, 128)
    cfg = dict(use_pallas_attention=True, packed_attention=True)
    j = _jax_sd(packed, spec, None, JQ(**cfg))(x, t, ehs)
    out = _torch_sd(packed, x, t, ehs, None, TQ(**cfg))
    np.testing.assert_allclose(out, j, rtol=0, atol=1e-4)
    unpacked = _torch_sd(tp, x, t, ehs, None, TQ(use_pallas_attention=True))
    np.testing.assert_allclose(out, unpacked, rtol=0, atol=1e-4)


@pytest.mark.parametrize("policy", ["g1", "g8"])
def test_tiny_unet_packed_quantized_within_chaos(tiny_sd, policy):
    """W8A8 with packed attention: the g=1 policy (uniform A8 softmax, K1p)
    and the g=8 policy (group convs on taps, log2 real-time softmax with
    start_peak, K3p)."""
    spec, tp, x, ehs, t, noise = tiny_sd
    tq, _ = TW.quantize_model_weights(tp, spec, TQ(w_bits=8, use_wq=True))
    packed = TW.pack_attention_heads(tq, spec, num_heads=8)
    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              use_pallas_attention=True, packed_attention=True)
    if policy == "g1":
        jqs = j_syn(spec, 0, False, jnp.float32)
        tqs = t_syn(spec, 0, False, torch.float32, device="cpu")
    else:
        jqs, group_layers = j_gsyn(spec, 0, False, jnp.float32)
        tqs = qstate_from_numpy(jax.tree.map(np.asarray, jqs), device="cpu")
        kw.update(t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True,
                  group_conv_layers=group_layers, group_conv_impl="taps")
    run = _jax_sd(packed, spec, jqs, JQ(**kw))
    j = run(x, t, ehs)
    chaos = max(np.abs(run(x + n, t, ehs) - j).max() for n in noise)
    out = _torch_sd(packed, x, t, ehs, tqs, TQ(**kw))
    err = np.abs(out - j).max()
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01
    assert err <= max(5 * chaos, 1e-4), (err, chaos)
    # the port's own unpacked forward is within the same bound
    unpacked = _torch_sd(tq, x, t, ehs, tqs, TQ(**{**kw, "packed_attention": False}))
    assert np.abs(out - unpacked).max() <= max(5 * chaos, 1e-4)


def test_tiny_sdxl_packed_native_64_wide_heads():
    """A tiny SDXL UNet at base 64: heads are 64 wide (2 and 4 of them), so
    `pack_attention_heads` changes nothing and `packed_attention` alone sends
    every attention to the packed entries."""
    base, cross, add_ch, depths = 64, 64, 8, (1, 1)
    spec = TX.sdxl_unet_spec(base, cross, add_ch, depths)
    assert spec == JX.sdxl_unet_spec(base, cross, add_ch, depths)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    packed = TW.pack_attention_heads(tp, spec, num_heads=lambda o: o // 64)
    assert all(packed[n] is tp[n] for n in tp)
    rng = np.random.RandomState(0)
    inp = [rng.randn(2, 16, 16, 4).astype(np.float32), np.asarray([500, 500], np.int32),
           rng.randn(2, 77, cross).astype(np.float32), rng.randn(2, base * 4).astype(np.float32),
           np.tile(np.asarray([[128., 128., 0., 0., 128., 128.]], np.float32), (2, 1))]
    cfg = dict(use_pallas_attention=True, packed_attention=True)
    jp = _jnp_tree(params_to_numpy(packed, spec))
    j = np.asarray(jax.jit(functools.partial(JX.unet_sdxl_apply, qstate=None, cfg=JQ(**cfg)))(
        jp, *(jnp.asarray(a) for a in inp)))
    seen = []
    real = TL.fused_attention
    try:
        TL.fused_attention = lambda *a, **k: seen.append(
            (k.get("num_heads"), k.get("head_dim"))) or real(*a, **k)
        with torch.no_grad():
            out = TX.unet_sdxl_apply(packed, *(torch.from_numpy(a) for a in inp), qstate=None,
                                     cfg=TQ(**cfg)).numpy()
            unpacked = TX.unet_sdxl_apply(tp, *(torch.from_numpy(a) for a in inp), qstate=None,
                                          cfg=TQ(use_pallas_attention=True)).numpy()
    finally:
        TL.fused_attention = real
    n_packed = [c for c in seen if c[0] is not None]
    assert len(n_packed) == len(seen) // 2 and set(n_packed) == {(2, 64), (4, 64)}
    tol = 1e-5 * max(1.0, np.abs(j).max())
    np.testing.assert_allclose(out, j, rtol=0, atol=tol)
    np.testing.assert_allclose(out, unpacked, rtol=0, atol=tol)
