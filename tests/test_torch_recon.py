"""The port's reconstruction building blocks against the JAX package's, on
the same numpy inputs (tiny SD net: base 32, cross 64, 16x16 latents; tiny
SDXL-turbo net: add_ch 8, depths (1, 2)):

  * `fake_quant` at the clip bounds: values bit for bit, and the gradients
    with respect to x and to delta equal `jax.grad`'s (JAX's clip splits the
    gradient at a tie between x and the bound; `torch.clamp` did not);
  * AdaRound's `rounding_reg_loss` (within 1e-6 relative, the soft targets'
    sigmoid differing in its last bits) with its gradient, and
    `linear_temp_decay` bit for bit, over a grid;
  * `recon_units` of SD and SDXL: the same units (name, kind, layers, meta,
    sum_axis, heads) in the same order;
  * `capture_unit_io` for every unit kind, with and without `want_inputs`:
    the inputs and the output within 1e-5 of the largest element of the
    JAX record's (one jitted JAX forward records every unit; the time
    embedding's sinusoidal input within 2e-4, as tests/test_torch_layers.py
    holds it); the capture
    stops at its unit; `inject_at` adds to the unit's output;
  * the kernel entries refuse an input that requires grad.

`capture_unit_grad` is in tests/test_torch_recon_grad.py.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from recon_parity import tiny_sd, tiny_sdxl, tnp, to_j, to_t  # noqa: E402

from dgq_tpu.calib import reconstruction as JR  # noqa: E402
from dgq_tpu.models import unet_sd as JU, unet_sdxl as JX  # noqa: E402
from dgq_tpu.quant import adaround as JAda, affine as JAff  # noqa: E402
from dgq_tpu_torch.calib import reconstruction as TR  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU, unet_sdxl as TX  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQC  # noqa: E402
from dgq_tpu_torch.ops import attention as TA, group_conv as TG, int8_matmul as TI  # noqa: E402
from dgq_tpu_torch.quant import adaround as TAda, affine as TAff  # noqa: E402

# one unit of each kind (and of each lone-layer kind) of the tiny SD net
SD_UNITS = [
    "time_embedding.linear_1",                          # lone linear on (B, C)
    "down_blocks.0.resnets.0",                          # resnet
    "down_blocks.0.attentions.0.proj_in",               # lone 1x1 conv
    "down_blocks.1.attentions.1.transformer_blocks.0",  # transformer
    "down_blocks.2.downsamplers.0.conv",                # lone strided conv
    "mid_block.resnets.1",                              # resnet, mid
    "up_blocks.2.resnets.2",                            # resnet with a shortcut
    "up_blocks.3.attentions.2.proj_out",                # the last unit
]
SDXL_UNITS = [
    "add_embedding.linear_1",
    "down_blocks.0.resnets.1",
    "down_blocks.1.attentions.0.proj_in",               # lone linear on (B, T, C)
    "down_blocks.2.attentions.1.transformer_blocks.1",
    "up_blocks.0.upsamplers.0.conv",
]


@pytest.fixture(scope="module")
def sd():
    return tiny_sd()


@pytest.fixture(scope="module")
def sdxl():
    return tiny_sdxl()


def _record_all(apply, params, batch):
    """Every unit's (inputs, output) of one jitted JAX forward."""
    def fn(p, *b):
        rec = {}
        apply(p, *b, record=rec)
        return rec
    return jax.jit(fn)(params, *batch)


@pytest.fixture(scope="module")
def sd_record(sd):
    spec, jp, _, cali = sd
    return _record_all(JU.unet_sd_apply, jp, to_j(c[:2] for c in cali))


@pytest.fixture(scope="module")
def sdxl_record(sdxl):
    spec, jp, _, cali = sdxl
    return _record_all(JX.unet_sdxl_apply, jp, to_j(cali))


# ------------------------------------------------------- the repair first ----
@pytest.mark.parametrize("bits,symmetric,per_channel", [
    (4, False, False), (4, False, True), (8, False, False), (4, True, False)])
def test_fake_quant_gradient_at_the_clip_bounds_is_jax(bits, symmetric, per_channel):
    """Codes on both bounds (and inside): the values and d/dx of
    sum(fake_quant * r) bit for bit, d/ddelta within 2e-5 relative (a sum
    over a row, in another order). torch.clamp gave d/dx 1 at a tie, JAX
    0.5."""
    rng = np.random.RandomState(bits + 2 * symmetric + 4 * per_channel)
    nb, pb = JAff.quant_bounds(bits, symmetric, False)
    rows = 3
    delta = (0.05 + 0.1 * rng.rand(rows, 1) if per_channel else np.full((1, 1), 0.07)
             ).astype(np.float32)
    zp = (np.round(rng.rand(*delta.shape) * 3) if not symmetric
          else np.zeros_like(delta)).astype(np.float32)
    codes = rng.randint(nb - 3, pb + 4, size=(rows, 64)).astype(np.float32)
    codes[:, :4] = np.array([nb, pb, nb, pb], np.float32) - zp  # exactly on the bounds
    x = (codes * delta).astype(np.float32)
    r = rng.randn(rows, 64).astype(np.float32)

    def j_loss(x, d):
        return jnp.sum(JAff.fake_quant(x, JAff.QParams(d, jnp.asarray(zp)), bits, symmetric) * r)
    jv = JAff.fake_quant(jnp.asarray(x), JAff.QParams(jnp.asarray(delta), jnp.asarray(zp)),
                         bits, symmetric)
    jgx, jgd = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(delta))

    tx = torch.from_numpy(x).requires_grad_(True)
    td = torch.from_numpy(delta).requires_grad_(True)
    tv = TAff.fake_quant(tx, TAff.QParams(td, torch.from_numpy(zp)), bits, symmetric)
    (tv * torch.from_numpy(r)).sum().backward()
    ties = np.isin(np.round(x / delta) + zp, [nb, pb])
    assert ties.sum() >= 4 * rows
    np.testing.assert_array_equal(tnp(tv), np.asarray(jv))
    np.testing.assert_array_equal(tnp(tx.grad), np.asarray(jgx))
    np.testing.assert_allclose(tnp(td.grad), np.asarray(jgd), rtol=2e-5, atol=1e-6)


def test_clip_values_equal_clamp_and_gradients_split_at_ties():
    x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0], requires_grad=True)
    lo = torch.tensor(0.0, requires_grad=True)
    y = TAff.clip(x, lo, 1.0)
    assert torch.equal(y, torch.clamp(x.detach(), 0.0, 1.0))
    y.sum().backward()
    jgx, jglo = jax.grad(lambda a, b: jnp.sum(jnp.clip(a, b, 1.0)), argnums=(0, 1))(
        jnp.asarray(tnp(x)), jnp.asarray(0.0))
    np.testing.assert_array_equal(tnp(x.grad), np.asarray(jgx))
    assert float(lo.grad) == float(jglo)
    bf = TAff.clip(torch.ones(3, dtype=torch.bfloat16), 0.0, 0.5)  # number bounds keep the dtype
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, torch.full((3,), 0.5, dtype=torch.bfloat16))
    # the gradient form (min of max) gives the one-pass clamp's values and dtype
    bg = TAff.clip(torch.ones(3, dtype=torch.bfloat16, requires_grad=True), 0.0, 0.5)
    assert bg.dtype == torch.bfloat16 and torch.equal(bg.detach(), bf)


@pytest.mark.parametrize("beta", [20.0, 11.0, 2.0])
def test_rounding_reg_loss_and_its_gradient(beta):
    """Values within 1e-6 relative, gradients within 1e-5 of the largest."""
    alpha = np.concatenate([np.linspace(-3, 3, 241), [0.0, -2.3978953, 2.3978953]]
                           ).astype(np.float32).reshape(4, -1)
    jv, jg = jax.value_and_grad(JAda.rounding_reg_loss)(jnp.asarray(alpha), jnp.float32(beta))
    ta = torch.from_numpy(alpha).requires_grad_(True)
    tv = TAda.rounding_reg_loss(ta, torch.tensor(beta))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tnp(ta.grad), np.asarray(jg), atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("t_max,warmup", [(20, 0.2), (20000, 0.2), (10, 0.0), (7, 0.5)])
def test_linear_temp_decay_bit_for_bit(t_max, warmup):
    t = np.arange(t_max + 1, dtype=np.float32)
    j = np.asarray(JAda.linear_temp_decay(jnp.asarray(t), t_max, warmup))
    tt = tnp(TAda.linear_temp_decay(torch.from_numpy(t), t_max, warmup))
    np.testing.assert_array_equal(tt, j)
    assert tt[0] == 20.0 and abs(tt[-1] - 2.0) < 1e-5


# ------------------------------------------------------------------ units ----
@pytest.mark.parametrize("model", ["sd", "sdxl", "sd_full", "sdxl_full"])
def test_recon_units_equal_jax(model, request):
    if model == "sd":
        spec = request.getfixturevalue("sd")[0]
    elif model == "sdxl":
        spec = request.getfixturevalue("sdxl")[0]
    elif model == "sd_full":
        spec = JU.sd_unet_spec()
    else:
        spec = JX.sdxl_unet_spec()
    j = JR.recon_units(spec)
    t = TR.recon_units(spec)
    assert [dataclass_tuple(u) for u in t] == [dataclass_tuple(u) for u in j]
    if model == "sd_full":  # the counts the walk covers at full width
        assert (len(t), [sum(u.kind == k for u in t) for k in ("layer", "resnet", "transformer")]
                ) == (78, [40, 22, 16])
    if model == "sdxl_full":
        assert len(t) == 117 and {u.heads for u in t if u.kind == "transformer"} == {10, 20}
    assert TR.tib_unit(spec) == TR.ReconUnit(*dataclass_tuple(JR.tib_unit(spec)))


def dataclass_tuple(u):
    return (u.kind, u.name, tuple(u.layers), u.meta, u.sum_axis, u.heads)


# --------------------------------------------------------------- captures ----
def _check_capture(rec, unit, t_ins, t_out, want_inputs):
    j_ins, j_out = rec[unit]
    _close(t_out, j_out)
    if not want_inputs:
        assert t_ins == ()
        return
    assert len(t_ins) == len(j_ins)
    for a, b in zip(t_ins, j_ins):
        # the time embedding's own input is the sinusoidal projection, whose
        # f32 trig near 1000 rad differs by ~1e-4 between the libms
        # (tests/test_torch_layers.py:test_timestep_embedding)
        _close(a, b, 2e-4 if unit == "time_embedding.linear_1" else 1e-5)


def _close(t, j, tol=1e-5):
    """Within tol of the largest element (the packages sum in other orders,
    and the error grows with depth)."""
    j = np.asarray(j)
    np.testing.assert_allclose(tnp(t), j, rtol=0, atol=tol * np.abs(j).max())


@pytest.mark.parametrize("want_inputs", [True, False])
@pytest.mark.parametrize("unit", SD_UNITS)
def test_capture_unit_io_sd(sd, sd_record, unit, want_inputs):
    spec, _, tp, cali = sd
    ins, out = TR.capture_unit_io(tp, to_t(c[:2] for c in cali), unit, TQC(),
                                  want_inputs=want_inputs)
    _check_capture(sd_record, unit, ins, out, want_inputs)


@pytest.mark.parametrize("want_inputs", [True, False])
@pytest.mark.parametrize("unit", SDXL_UNITS)
def test_capture_unit_io_sdxl(sdxl, sdxl_record, unit, want_inputs):
    spec, _, tp, cali = sdxl
    ins, out = TR.capture_unit_io(tp, to_t(cali), unit, TQC(), TX.unet_sdxl_apply,
                                  want_inputs=want_inputs)
    _check_capture(sdxl_record, unit, ins, out, want_inputs)


def test_capture_stops_at_its_unit(sd, monkeypatch):
    """No layer past the unit runs: conv_out (after every unit) is never
    reached by a capture, and the whole forward does reach it."""
    spec, _, tp, cali = sd
    seen = []
    real = TU.conv2d
    monkeypatch.setattr(TU, "conv2d", lambda p, x, *a: seen.append(x.shape[-1]) or real(p, x, *a))
    TR.capture_unit_io(tp, to_t(c[:1] for c in cali), "up_blocks.3.attentions.2.proj_out", TQC())
    assert seen == [4]  # conv_in only
    with pytest.raises(KeyError):
        TR.capture_unit_io(tp, to_t(c[:1] for c in cali), "conv_out", TQC())
    assert seen[-1] == 32  # that forward ran to conv_out


def test_inject_at_adds_to_the_unit_output(sd):
    spec, _, tp, cali = sd
    batch = to_t(c[:1] for c in cali)
    name = "mid_block.resnets.0"
    _, out = TR.capture_unit_io(tp, batch, name, TQC())
    bump = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    rec = TU.CaptureUntil(name)
    with TU.inject_at({name: bump}), pytest.raises(TU.StopForward):
        TU.unet_sd_apply(tp, *batch, record=rec)
    torch.testing.assert_close(rec[name][1], out + bump, rtol=0, atol=0)


# ----------------------------------------------------- the kernel guard ----
def _needs_grad(*shape):
    return torch.zeros(*shape, requires_grad=True)


GUARDED = [
    ("flash_attention", lambda q, k, v: TA.flash_attention(q, k, v, 0.5)),
    ("static_uniform_attention", lambda q, k, v: TA.static_uniform_attention(q, k, v, 0.5, 0.01)),
    ("rt_stats", lambda q, k, v: TA.rt_stats(q, k, 0.5)),
    ("quant_accum", lambda q, k, v: TA.quant_accum(q, k, v, torch.zeros(2, 8),
                                                  torch.ones(1), 0.5)),
    ("log2_real_time_attention", lambda q, k, v: TA.log2_real_time_attention(q, k, v, 0.5)),
    ("static_quant_attention", lambda q, k, v: TA.static_quant_attention(q, k, v, 0.5, "log2",
                                                                         0.5)),
    ("flash_attention_packed", lambda q, k, v: TA.flash_attention_packed(
        q.reshape(1, 8, 16), k.reshape(1, 8, 16), v.reshape(1, 8, 16), 0.5, 2)),
    ("static_uniform_attention_packed", lambda q, k, v: TA.static_uniform_attention_packed(
        q.reshape(1, 8, 16), k.reshape(1, 8, 16), v.reshape(1, 8, 16), 0.5, 0.01, 2)),
    ("rt_stats_packed", lambda q, k, v: TA.rt_stats_packed(
        q.reshape(1, 8, 16), k.reshape(1, 8, 16), 0.5, 2)),
    ("quant_accum_packed", lambda q, k, v: TA.quant_accum_packed(
        q.reshape(1, 8, 16), k.reshape(1, 8, 16), v.reshape(1, 8, 16), torch.zeros(2, 8),
        torch.ones(1), 0.5, 2)),
    ("log2_real_time_attention_packed", lambda q, k, v: TA.log2_real_time_attention_packed(
        q.reshape(1, 8, 16), k.reshape(1, 8, 16), v.reshape(1, 8, 16), 0.5, 2)),
    ("static_quant_attention_packed", lambda q, k, v: TA.static_quant_attention_packed(
        q.reshape(1, 8, 16), k.reshape(1, 8, 16), v.reshape(1, 8, 16), 0.5, "log2", 0.5, 2)),
    ("fused_attention", lambda q, k, v: TA.fused_attention(q, k, v, 0.5)),
    ("group_quant_conv", lambda q, k, v: TG.group_quant_conv(
        q.reshape(2, 4, 4, 4), torch.zeros(3, 3, 4, 4), torch.ones(9, 4), torch.zeros(9, 4),
        torch.ones(()), torch.zeros(()), None)),
    ("fold_weights", lambda q, k, v: TG.fold_weights(
        torch.float32, q.reshape(1, 1, 8, 16), torch.ones(1, 8), torch.zeros(1, 8),
        torch.ones(()), torch.zeros(()), 1, 1)),
    ("quantized_matmul", lambda q, k, v: TI.quantized_matmul(
        q.reshape(16, 8), torch.zeros(4, 8, dtype=torch.int8), torch.ones(4), torch.zeros(4),
        torch.tensor(0.1), torch.tensor(0.0))),
]


@pytest.mark.parametrize("entry,call", GUARDED, ids=[g[0] for g in GUARDED])
def test_kernel_entries_refuse_inputs_that_require_grad(entry, call):
    """Each entry raises, naming itself, before it needs the card or a
    build (these are CPU tensors); under no_grad the same call passes the
    guard (the CPU falls back or refuses the device, as before)."""
    q, k, v = _needs_grad(2, 8, 8), torch.zeros(2, 8, 8), torch.zeros(2, 8, 8)
    with pytest.raises(RuntimeError, match=f"^{entry}: an input requires grad"):
        call(q, k, v)
    with torch.no_grad():
        try:
            call(q, k, v)
        except Exception as e:  # a CPU tensor where the entry needs the card
            assert "requires grad" not in str(e)
