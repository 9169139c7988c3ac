"""The port's whole reconstruction walk (`calib.reconstruction.
calibrate_weights`) and its per-unit saves against the JAX package's, on the
tiny SD net (base 32, cross 64, 16x16 latents, 4 calibration samples) with
the same numpy weights and W4 minmax scales, 20 Adam steps at batch 2 a unit,
captures in one chunk of 4, the port handed the JAX package's index stream:

  * asym (the units after the first take their inputs from the
    hard-rounded prefix), max_units=6: the same offset keys, every offset
    within 2 lr K of JAX's and the hard rounding equal wherever |alpha_jax|
    exceeds that (`recon_parity.compare_alphas`; the asym captures feed one
    unit's result to the next, and the bound still holds);
  * tib_recon (the temporal block first, its layers out of the per-unit
    walks and hard-rounded inside them), max_units=6: the same;
  * partial_dir both ways: the JAX run's saves resume in the port with
    every offset bit for bit and no unit reconstructed; the port's saves
    (JAX's keys and layout) resume in the JAX package bit for bit, and pass
    the port's `ckpt_tools check` against the weight-only file the port
    writes with those offsets;
  * the walk's record of each unit (`recon_parity.record_units`): finite
    losses, and the unit error with the learned hard rounding
    (`unit_error`) no worse than 1.5x nearest rounding's.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from recon_parity import (  # noqa: E402
    compare_alphas,
    hand_jax_indices,
    record_units,
    tiny_sd,
    tnp,
    to_j,
    to_t,
)

from dgq_tpu.calib import reconstruction as JR  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQC  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu_torch.calib import reconstruction as TR  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams as t_init_wqp  # noqa: E402
from dgq_tpu_torch.cli import ckpt_tools as TCT  # noqa: E402
from dgq_tpu_torch.io import dgq_ckpt as TK  # noqa: E402
from dgq_tpu_torch.io.convert import reference_layout  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQC  # noqa: E402

W4 = dict(w_bits=4, use_wq=True)
ITERS, BATCH, LR = 20, 2, 1e-3
WALK = dict(iters=ITERS, batch_size=BATCH, capture_batch=4, seed=0, max_units=6)


@pytest.fixture(scope="module")
def net():
    spec, jp, tp, cali = tiny_sd()
    twqp = t_init_wqp(tp, spec, 4)

    def jax_layout(a):
        a = tnp(a)
        return jnp.asarray(a.reshape((1,) * (a.ndim - 1) + (-1,)) if a.ndim > 1 else a)
    jwqp = {n: JQP(jax_layout(q.delta), jax_layout(q.zero_point)) for n, q in twqp.items()}
    return spec, jp, tp, jwqp, twqp, cali


@pytest.fixture(scope="module")
def walks(net, tmp_path_factory):
    """Both packages' asym walks, each keeping its partial saves."""
    spec, jp, tp, jwqp, twqp, cali = net
    root = tmp_path_factory.mktemp("walks")
    j_parts, t_parts = str(root / "jax_parts"), str(root / "port_parts")
    j = JR.calibrate_weights(jp, spec, JQC(**W4), jwqp, to_j(cali), asym=True,
                             partial_dir=j_parts, **WALK)
    mp = pytest.MonkeyPatch()
    hand_jax_indices(mp)
    calls = record_units(mp)
    try:
        t = TR.calibrate_weights(tp, spec, TQC(**W4), twqp, to_t(cali), asym=True,
                                 partial_dir=t_parts, **WALK)
    finally:
        mp.undo()
    return j, t, calls, j_parts, t_parts, root


def _covered(spec, n, drop=()):
    return {l for u in JR.recon_units(spec)[:n] for l in u.layers if l not in drop}


@pytest.mark.parametrize("captures", ["device", "host"])
def test_asym_walk_follows_jax(net, walks, captures, monkeypatch):
    """The walk against JAX's, with its captures on the device and (the
    port's own placement, `captures="host"`) in host memory, where the
    offsets are also the device walk's bit for bit."""
    spec, jp, tp, jwqp, twqp, cali = net
    j, t, _, _, _, _ = walks
    if captures == "host":
        hand_jax_indices(monkeypatch)
        host = TR.calibrate_weights(tp, spec, TQC(**W4), twqp, to_t(cali), asym=True,
                                    captures="host", **WALK)
        assert set(host) == set(t) and all(torch.equal(host[n], t[n]) for n in t)
        t = host
    assert set(t) == set(j) == _covered(spec, 6)
    compare_alphas(t, j, LR, ITERS)


def test_tib_walk_follows_jax(net, monkeypatch):
    spec, jp, tp, jwqp, twqp, cali = net
    hand_jax_indices(monkeypatch)
    j = JR.calibrate_weights(jp, spec, JQC(**W4), jwqp, to_j(cali), tib_recon=True, **WALK)
    t = TR.calibrate_weights(tp, spec, TQC(**W4), twqp, to_t(cali), tib_recon=True, **WALK)
    tib = set(TR.tib_unit(spec).layers)
    assert set(t) == set(j) == tib | _covered(spec, 6)
    compare_alphas(t, j, LR, ITERS)


def test_walk_stats(net, walks):
    spec = net[0]
    calls = walks[2]
    units = TR.recon_units(spec)[:6]
    assert [c["unit"] for c in calls] == units
    for c in calls:
        assert c["losses"].shape == (ITERS,) and bool(torch.isfinite(c["losses"]).all())
        # the learned hard rounding is no worse than 1.5x nearest rounding
        # on the unit's cached data (tests/test_calibration.py's bound)
        learned, nearest = TR.unit_error(c["unit"], c["params"], c["wqp"], c["alphas"],
                                         c["inputs"], c["outputs"], c["cfg"], 4)
        assert 0 < learned <= 1.5 * nearest, (c["unit"].name, learned, nearest)


def test_port_resumes_a_jax_partial_dir_bit_for_bit(net, walks):
    spec, jp, tp, jwqp, twqp, cali = net
    j, _, _, j_parts, _, _ = walks
    msgs = []
    t = TR.calibrate_weights(tp, spec, TQC(**W4), twqp, to_t(cali), asym=True,
                             partial_dir=j_parts, progress=msgs.append, **WALK)
    assert ["resumed from partial save" in m for m in msgs] == [True] * 6
    assert set(t) == set(j)
    for name in j:
        np.testing.assert_array_equal(tnp(reference_layout("w", t[name])), np.asarray(j[name]))


def test_jax_resumes_the_port_partial_dir_bit_for_bit(net, walks):
    spec, jp, tp, jwqp, twqp, cali = net
    _, t, _, _, t_parts, root = walks
    assert sorted(os.listdir(t_parts)) == sorted(f"{u.name}.pth"
                                                 for u in TR.recon_units(spec)[:6])
    msgs = []
    j = JR.calibrate_weights(jp, spec, JQC(**W4), jwqp, to_j(cali), asym=True,
                             partial_dir=t_parts, progress=msgs.append, **WALK)
    assert sum("resumed from partial save" in m for m in msgs) == 6
    assert set(j) == set(t)
    for name in t:
        np.testing.assert_array_equal(np.asarray(j[name]), tnp(reference_layout("w", t[name])))
    # the port's saves pass the port's check against its weight-only file
    agg = str(root / "w.pth")
    TK.save_weight_only(agg, tp, twqp, spec, alphas=t)
    assert TCT.main(["check", agg, t_parts]) == 0
    _, _, back = TK.load_weight_only(agg, spec, device="cpu")
    assert set(back) == set(t) and all(torch.equal(back[n], t[n]) for n in t)
    # and a changed save fails it
    from dgq_tpu_torch.io.dgq_ckpt import load_pth, save_pth

    first = os.path.join(t_parts, sorted(os.listdir(t_parts))[0])
    bad = str(root / "bad_parts")
    os.makedirs(bad)
    save_pth({k: v + 1.0 for k, v in load_pth(first).items()},
             os.path.join(bad, os.path.basename(first)))
    assert TCT.main(["check", agg, bad]) == 1
