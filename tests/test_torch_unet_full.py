"""The port's SD v1.4 UNet at full width (base 320, cross 768, 64x64
latents, 859.52M parameters) against the JAX package's, on the CPU, from the
same weights: drawn by the port from a seeded generator and handed to JAX
through the weight bridge (`io.convert.params_to_numpy`), as
tests/test_torch_unet.py does for the tiny net. Every test is marked slow
(tier-1 does not run it): `python -m pytest -m slow tests/test_torch_unet_full.py`.
It needs about 24 GB of host memory (the weights in numpy, JAX and torch,
and their W4 folds) and runs for minutes: XLA compiles each configuration's
full forward once.

Both sides take the materialized softmax (`use_pallas_attention=False`) and
the taps group conv, so no interpret-mode kernel runs at 4096 tokens.
Tolerances, those of tests/test_torch_unet.py and tests/test_unet_sd.py:
  * fp: within 5e-3 of the JAX output (tests/test_unet_sd.py's bound
    against the reference UNet at this width);
  * W4A8 g=1 (per-tensor A8, uniform A8 softmax) and g=8 (group-quantized
    k x k convs, log2 real-time softmax, start_peak): the chaos bound of
    tests/test_packed_in_model.py, err <= max(5 * chaos, 1e-4), chaos the
    JAX net's largest output change under CHAOS_DRAWS input perturbations
    of 1e-6.
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
from dgq_tpu_torch.models.qconfig import QConfig as TQ  # noqa: E402
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate as t_syn  # noqa: E402

pytestmark = pytest.mark.slow

BASE, CROSS, HW = 320, 768, 64
CHAOS_DRAWS = 8  # one draw is heavy-tailed: most move nothing, a few a bin


@pytest.fixture(scope="module")
def full():
    spec = TU.sd_unet_spec(base=BASE, cross=CROSS)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    rng = np.random.RandomState(0)
    x = rng.randn(1, HW, HW, 4).astype(np.float32)
    ehs = rng.randn(1, 77, CROSS).astype(np.float32)
    t = np.asarray([500], np.int32)
    noise = [(1e-6 * rng.randn(*x.shape)).astype(np.float32) for _ in range(CHAOS_DRAWS)]
    return spec, tp, x, ehs, t, noise


def _jax(params, spec, qstate, cfg):
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params, spec))
    fn = jax.jit(functools.partial(JU.unet_sd_apply, qstate=qstate, cfg=cfg))
    return lambda x, t, ehs: np.asarray(fn(jp, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(ehs)))


def _torch(params, x, t, ehs, qstate, cfg):
    with torch.no_grad():
        return TU.unet_sd_apply(params, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(ehs), qstate=qstate, cfg=cfg).numpy()


def _within_chaos(run, out, x, t, ehs, noise):
    j = run(x, t, ehs)
    chaos = max(np.abs(run(x + n, t, ehs) - j).max() for n in noise)
    err = np.abs(out - j).max()
    assert np.isfinite(out).all()
    assert err <= max(5 * chaos, 1e-4), (err, chaos)
    assert np.abs(out).max() > 0.01


def test_full_unet_fp_forward(full):
    spec, tp, x, ehs, t, _ = full
    j = _jax(tp, spec, None, JQ())(x, t, ehs)
    out = _torch(tp, x, t, ehs, None, TQ())
    assert np.abs(out - j).max() <= 5e-3, np.abs(out - j).max()


def test_full_unet_w4a8_g1_within_chaos(full):
    spec, tp, x, ehs, t, noise = full
    kw = dict(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True)
    tq, _ = t_qmw(tp, spec, TQ(**kw))
    run = _jax(tq, spec, j_syn(spec, 0, False, jnp.float32), JQ(**kw))
    out = _torch(tq, x, t, ehs, t_syn(spec, 0, False, torch.float32, device="cpu"), TQ(**kw))
    _within_chaos(run, out, x, t, ehs, noise)


def test_full_unet_w4a8_g8_within_chaos(full):
    spec, tp, x, ehs, t, noise = full
    jqs, group_layers = j_gsyn(spec, 0, False, jnp.float32)
    kw = dict(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True,
              group_conv_layers=group_layers, group_conv_impl="taps")
    tq, _ = t_qmw(tp, spec, TQ(w_bits=4, use_wq=True))
    run = _jax(tq, spec, jqs, JQ(**kw))
    out = _torch(tq, x, t, ehs, qstate_from_numpy(jax.tree.map(np.asarray, jqs), device="cpu"),
                 TQ(**kw))
    _within_chaos(run, out, x, t, ehs, noise)
