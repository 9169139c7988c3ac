"""The port's `calib.reconstruction.capture_unit_grad` (the Fisher
weighting |dKL/d(unit output)| + 1) against the JAX package's, on the same
numpy inputs, each within 1e-5 of the largest element:

  * the JAX package's own `capture_unit_grad` on a unit of each kind (lone
    1x1 conv, resnet, transformer) of a small net made of the
    tiny SD net's first blocks (time embedding, conv_in, one resnet, one
    Transformer2DModel, conv_out), passed in as `unet_apply` in both
    packages, so each JAX compile is small;
  * the whole tiny SD UNet at every unit kind, against JAX's autodiff of the
    same KL through `unet_sd.inject_at`: one jitted gradient with a zero
    injected at every unit of the list, which is the gradient at each unit's
    output (a single compile stands in for one a unit).

The quantized net's weights are W4-folded with nearest rounding (the
port's fold, handed to JAX as numpy).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from recon_parity import tiny_sd, tnp, to_j, to_t  # noqa: E402

from dgq_tpu.calib import reconstruction as JR  # noqa: E402
from dgq_tpu.models import layers as JL, unet_sd as JU  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQC  # noqa: E402
from dgq_tpu_torch.calib import reconstruction as TR  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import fold_weight_quant as t_fold  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams as t_init_wqp  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy  # noqa: E402
from dgq_tpu_torch.models import layers as TL, unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQC  # noqa: E402

W4 = dict(w_bits=4, use_wq=True)
SD_UNITS = [
    "time_embedding.linear_1",                          # lone linear on (B, C)
    "down_blocks.0.resnets.0",                          # resnet
    "down_blocks.0.attentions.0.proj_in",               # lone 1x1 conv
    "down_blocks.1.attentions.1.transformer_blocks.0",  # transformer
    "down_blocks.2.downsamplers.0.conv",                # lone strided conv
    "mid_block.resnets.1",
    "up_blocks.2.resnets.2",                            # resnet with a shortcut
    "up_blocks.3.attentions.2.proj_out",                # the last unit
]
MINI_UNITS = [
    "down_blocks.0.attentions.0.proj_in",
    "down_blocks.0.resnets.0",
    "down_blocks.0.attentions.0.transformer_blocks.0",
    "down_blocks.0.attentions.0.proj_out",
]


def _mini(m, L):
    """The small net over the tiny SD params, from package m's blocks."""
    def apply(p, sample, t, ehs, qstate=None, cfg=None, record=None):
        cfg = cfg if cfg is not None else (JQC() if m is JU else TQC())
        base = p["conv_in"]["w"].shape[-1 if m is JU else 0]
        t_emb = L.timestep_embedding(t, base)
        emb = L.quant_linear(p["time_embedding.linear_1"], t_emb, "time_embedding.linear_1",
                             qstate, cfg)
        emb = m._rec(record, "time_embedding.linear_1", (t_emb,), emb)
        emb_in = L.silu(emb)
        emb = L.quant_linear(p["time_embedding.linear_2"], emb_in, "time_embedding.linear_2",
                             qstate, cfg)
        emb = m._rec(record, "time_embedding.linear_2", (emb_in,), emb)
        x = L.conv2d(p["conv_in"], sample, 1, 1)
        x = m._resnet(p, "down_blocks.0.resnets.0", x, emb, qstate, cfg, False, record)
        x = m.transformer_2d(p, "down_blocks.0.attentions.0", x, ehs, 1, qstate, cfg, record)
        return L.conv2d(p["conv_out"], L.silu(L.group_norm(p["conv_norm_out"], x)), 1, 1)
    return apply


J_MINI, T_MINI = _mini(JU, JL), _mini(TU, TL)


@pytest.fixture(scope="module")
def sd():
    """The tiny SD net, and its W4 fold (the port's, which equals the JAX
    package's bit for bit, tests/test_torch_quant.py) in both packages."""
    spec, jp, tp, cali = tiny_sd()
    tq = t_fold(tp, t_init_wqp(tp, spec, 4), spec, TQC(**W4))
    jq = jax.tree.map(jnp.asarray, params_to_numpy(tq, spec))
    return spec, jp, tp, jq, tq, cali


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert (got > 1.0).any()  # a gradient reached the unit


@pytest.mark.parametrize("unit", MINI_UNITS)
def test_capture_unit_grad_equals_the_jax_function(sd, unit):
    spec, jp, tp, jq, tq, cali = sd
    want = np.asarray(JR.capture_unit_grad(jp, jq, to_j(c[:2] for c in cali), unit,
                                           JQC(**W4), unet_apply=J_MINI))
    got = tnp(TR.capture_unit_grad(tp, tq, to_t(c[:2] for c in cali), unit, TQC(**W4),
                                   unet_apply=T_MINI))
    _close(got, want)


@pytest.fixture(scope="module")
def sd_grads(sd):
    """JAX's dKL/d(unit output) at every unit of SD_UNITS: the loss of the
    JAX package's `capture_unit_grad`, differentiated at zeros injected at
    all of them at once."""
    spec, jp, tp, jq, tq, cali = sd

    def grads(pf, pq, *b):
        out_fp = JU.unet_sd_apply(pf, *b)
        rec = {}
        JU.unet_sd_apply(pq, *b, record=rec)

        def loss(ds):
            with JU.inject_at(ds):
                out_q = JU.unet_sd_apply(pq, *b)
            p_fp = jax.nn.softmax(out_fp.astype(jnp.float32), axis=-1)
            logq = jax.nn.log_softmax(out_q.astype(jnp.float32), axis=-1)
            return jnp.sum(p_fp * (jnp.log(p_fp + 1e-12) - logq)) / b[0].shape[0]
        return jax.grad(loss)({u: jnp.zeros(rec[u][1].shape, jnp.float32) for u in SD_UNITS})

    g = jax.jit(grads)(jp, jq, *to_j(c[:2] for c in cali))
    return {u: np.abs(np.asarray(v)) + 1.0 for u, v in g.items()}


@pytest.mark.parametrize("unit", SD_UNITS)
def test_capture_unit_grad_sd_unet(sd, sd_grads, unit):
    spec, jp, tp, jq, tq, cali = sd
    got = tnp(TR.capture_unit_grad(tp, tq, to_t(c[:2] for c in cali), unit, TQC(**W4)))
    _close(got, sd_grads[unit])


def test_capture_unit_grad_divides_by_the_batch_not_its_parts(sd):
    """batchmean by the chunk's leading size: the gradient of one sample is
    the same whether it rides with another or alone, scaled by the sizes."""
    spec, jp, tp, jq, tq, cali = sd
    unit = "down_blocks.0.resnets.0"
    pair = TR.capture_unit_grad(tp, tq, to_t(c[:2] for c in cali), unit, TQC(**W4)) - 1.0
    one = TR.capture_unit_grad(tp, tq, to_t(c[:1] for c in cali), unit, TQC(**W4)) - 1.0
    torch.testing.assert_close(pair[:1] * 2, one, rtol=0, atol=1e-5 * float(one.abs().max()))
