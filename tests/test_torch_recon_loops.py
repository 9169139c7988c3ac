"""The port's reconstruction loops (`calib.reconstruction.reconstruct_unit`,
`reconstruct_tib`, `reconstruct_unit_act_deltas`) against the JAX
package's, on the tiny SD net (base 32, cross 64, 16x16 latents) with the
same numpy weights, W4 minmax scales and cached unit data (the JAX
package's record of 4 calibration samples), 20 Adam steps at batch 2, the
port handed the JAX package's index stream (`recon_parity.jax_batch_indices`):

  * the loss of every step within 5e-5 relative of JAX's (the unit's
    forward sums in another order on each side);
  * every learned offset within 2 lr K of JAX's (K steps; Adam takes a full
    lr step on a near-zero gradient whose sign the two summation orders may
    disagree on; `recon_parity.compare_alphas`), and the hard rounding
    (alpha >= 0) equal wherever |alpha_jax| exceeds that bound;
  * reconstruct_unit in 'mse', 'fisher_diag' and 'fisher_full' on a resnet,
    a transformer and a lone layer; the fisher weights are the same seeded
    |g| + 1 in both packages. 'fisher_full' differentiates |pred - out|,
    whose gradient at an exact 0 is 1 in JAX (torch.abs gives 0); the port
    keeps JAX's (`_abs`). This data meets it: the lone layer's first soft
    forward equals its target exactly at one element;
  * the activation deltas (cosine-decayed Adam through `fake_quant`, whose
    clip ties now split their gradient as JAX's) within 2 lr K as well.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from recon_parity import (  # noqa: E402
    compare_alphas,
    hand_jax_indices,
    jax_key,
    tiny_sd,
    tnp,
    to_j,
)

from dgq_tpu.calib import reconstruction as JR  # noqa: E402
from dgq_tpu.models import unet_sd as JU  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQC  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu_torch.calib import reconstruction as TR  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import fold_weight_quant as t_fold  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams as t_init_wqp  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQC  # noqa: E402
from dgq_tpu_torch.quant.affine import QParams as TQP  # noqa: E402

W4 = dict(w_bits=4, use_wq=True)
ITERS, BATCH, LR = 20, 2, 1e-3
UNITS = ["down_blocks.0.resnets.0", "down_blocks.0.attentions.0.transformer_blocks.0",
         "down_blocks.0.attentions.0.proj_in"]


@pytest.fixture(scope="module")
def sd():
    """The tiny net, its W4 scales in both packages (the port's minmax
    scales as numpy: equal bit for bit, tests/test_torch_calib_quant.py) and
    the JAX record of every unit on the 4 samples."""
    spec, jp, tp, cali = tiny_sd()
    twqp = t_init_wqp(tp, spec, 4)
    jwqp = {n: JQP(jnp.asarray(_jax_layout(tnp(q.delta))), jnp.asarray(_jax_layout(tnp(q.zero_point))))
            for n, q in twqp.items()}

    def record(p, *b):
        rec = {}
        JU.unet_sd_apply(p, *b, record=rec)
        return rec
    rec = jax.jit(record)(jp, *to_j(cali))
    units = {u.name: u for u in TR.recon_units(spec)}
    return spec, jp, tp, jwqp, twqp, rec, units, cali


def _jax_layout(a):
    """A per-out-channel (O, 1, 1, 1) / (O, 1) scale in the JAX package's
    broadcast layout ((1, 1, 1, O) / (1, O))."""
    return a.reshape((1,) * (a.ndim - 1) + (-1,)) if a.ndim > 1 else a


def _t(x):
    return torch.from_numpy(np.array(x))


def _losses_close(t_losses, j_losses):
    j = np.asarray(j_losses)
    assert t_losses.shape == j.shape == (ITERS,)
    np.testing.assert_allclose(tnp(t_losses), j, rtol=5e-5)


@pytest.mark.parametrize("mode", ["mse", "fisher_diag", "fisher_full"])
@pytest.mark.parametrize("unit", UNITS)
def test_reconstruct_unit_follows_jax(sd, unit, mode, monkeypatch):
    spec, jp, tp, jwqp, twqp, rec, units, _ = sd
    hand_jax_indices(monkeypatch)
    ins, out = rec[unit]
    grads = None
    if mode != "mse":
        grads = 1.0 + np.abs(np.random.RandomState(3).randn(*out.shape)).astype(np.float32)
    j_alphas, j_losses = JR.reconstruct_unit(
        jax_key((5,)), JR.recon_units(spec)[[u.name for u in JR.recon_units(spec)].index(unit)],
        jp, jwqp, ins, out, JQC(**W4), iters=ITERS, batch_size=BATCH, lr=LR, opt_mode=mode,
        cached_grads=None if grads is None else jnp.asarray(grads))
    t_alphas, t_losses = TR.reconstruct_unit(
        (5,), units[unit], tp, twqp, tuple(_t(x) for x in ins), _t(out), TQC(**W4),
        iters=ITERS, batch_size=BATCH, lr=LR, opt_mode=mode,
        cached_grads=None if grads is None else _t(grads))
    _losses_close(t_losses, j_losses)
    worst, share = compare_alphas(t_alphas, j_alphas, LR, ITERS)
    assert share > 0.9, (worst, share)


def test_reconstruct_tib_follows_jax(sd, monkeypatch):
    spec, jp, tp, jwqp, twqp, rec, units, cali = sd
    hand_jax_indices(monkeypatch)
    t = np.asarray([1, 250, 501, 999], np.int32)
    j_alphas, j_losses = JR.reconstruct_tib(jax_key((7, TR.TIB_STREAM)), jp, spec, jwqp,
                                            jnp.asarray(t), JQC(**W4), iters=ITERS,
                                            batch_size=BATCH, lr=LR)
    t_alphas, t_losses = TR.reconstruct_tib((7, TR.TIB_STREAM), tp, spec, twqp, _t(t),
                                            TQC(**W4), iters=ITERS, batch_size=BATCH, lr=LR)
    assert set(t_alphas) == set(TR.tib_unit(spec).layers)
    # the time embedding's sinusoidal input differs by ~1e-4 between the
    # libms near 1000 rad (tests/test_torch_layers.py), so the losses are
    # held to 1e-4 here
    np.testing.assert_allclose(tnp(t_losses), np.asarray(j_losses), rtol=1e-4)
    compare_alphas(t_alphas, j_alphas, LR, ITERS)


@pytest.mark.parametrize("unit", ["down_blocks.0.resnets.0", "down_blocks.0.attentions.0.proj_in"])
def test_reconstruct_unit_act_deltas_follows_jax(sd, unit, monkeypatch):
    """Per-tensor A8 quantizers at each of the unit's inputs (zero point 128,
    deltas that clip a few elements, so codes sit on both bounds); lr 4e-5."""
    spec, jp, tp, jwqp, twqp, rec, units, _ = sd
    hand_jax_indices(monkeypatch)
    ins, out = rec[unit]
    tq = t_fold(tp, twqp, spec, TQC(**W4))
    jq = jax.tree.map(jnp.asarray, params_to_numpy(tq, spec))
    names = [n for n in units[unit].layers]
    deltas = {n: np.float32(0.004 + 0.002 * i) for i, n in enumerate(names)}
    jqs = {"a": {n: JQP(jnp.float32(d), jnp.float32(128.0)) for n, d in deltas.items()}, "sm": {}}
    tqs = {"a": {n: TQP(torch.tensor(d), torch.tensor(128.0)) for n, d in deltas.items()},
           "sm": {}}
    ju = JR.recon_units(spec)[[u.name for u in JR.recon_units(spec)].index(unit)]
    j_state, j_losses = JR.reconstruct_unit_act_deltas(
        jax_key((9,)), ju, jq, jqs, ins, out, JQC(**W4), iters=ITERS, batch_size=BATCH)
    t_state, t_losses = TR.reconstruct_unit_act_deltas(
        (9,), units[unit], tq, tqs, tuple(_t(x) for x in ins), _t(out), TQC(**W4),
        iters=ITERS, batch_size=BATCH)
    _losses_close(t_losses, j_losses)
    bound = 2 * 4e-5 * ITERS
    for n in names:
        got, want = float(t_state["a"][n].delta), float(j_state["a"][n].delta)
        assert abs(got - want) <= bound, (n, got, want)
        assert abs(got - deltas[n]) > 1e-6  # the loop moved it
        assert float(t_state["a"][n].zero_point) == 128.0


def test_abs_gradient_is_jax_at_zero():
    x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    TR._abs(x).sum().backward()
    want = jax.vmap(jax.grad(jnp.abs))(jnp.asarray([-2.0, 0.0, 3.0]))
    np.testing.assert_array_equal(tnp(x.grad), np.asarray(want))
    assert torch.equal(TR._abs(x.detach()), torch.abs(x.detach()))


def test_batch_indices_are_seeded_by_the_key():
    a = TR.batch_indices((42, 3), 20, 8, 24)
    assert a.shape == (20, 8) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 24
    assert torch.equal(a, TR.batch_indices((42, 3), 20, 8, 24))
    assert not torch.equal(a, TR.batch_indices((42, 4), 20, 8, 24))
    assert not torch.equal(a, TR.batch_indices((43, 3), 20, 8, 24))


def test_cosine_decay_equals_optax():
    import optax

    for lr, iters in ((4e-5, 20), (4e-5, 20000), (1e-3, 7)):
        sched = optax.cosine_decay_schedule(lr, iters)
        ours = TR.cosine_decay(lr, iters)
        for step in sorted({0, 1, iters // 2, iters - 1, iters, iters + 3}):
            assert np.float32(ours(step)) == np.float32(sched(step)), (lr, iters, step)
