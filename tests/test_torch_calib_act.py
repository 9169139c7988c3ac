"""The port's activation calibration (`calib/act_calib.py`, the taps of
`models/qconfig.py` and `models/layers.py`) and calibration data
(`calib/data.py`, `cli/common.py`'s calibration half) against the JAX
package's, on the tiny SD net of tests/test_calibration.py (base 32, cross
64) and a tiny SDXL-turbo net (base 32, cross 64, add_ch 8, depths (1, 2)),
with the same weights and inputs in both packages.

  * `tap_execution_order`: equal, list for list (SD: plain attention, and
    the fused attention with start_peak, whose post-softmax tap is made for
    the collector; SDXL).
  * `init_act_qstate` in one chunk: every delta and zero point within 1e-5
    relative (the taps differ by the summation order of XLA:CPU and
    PyTorch). One chunk runs no quantizer, except a real-time log2 softmax,
    which needs no state; that configuration is chaotic and is held by the
    calibration test below instead.
  * `calibrate_activations`, vanilla (EMA running stats) and g=2 (k-means
    groups, the t2i flags): the same names, slots and group layers; every
    delta and zero point of the port (a group quantizer as its effective
    per-element grid) within max(5 * chaos, 1e-6) of JAX's, where chaos is
    the largest change of the port's own calibration under eight 1e-6
    perturbations of its input latents (the bound of
    tests/test_packed_in_model.py, on the calibrated state). The group axis
    of every layer whose choice none of those perturbations moved equals
    JAX's: the quantized forward of this random-weight net is chaotic, and a
    1e-6 perturbation flips a few layers' axis in either package.
  * calibration data: the layout (timestep chunks, CFG doubling, ehs rows)
    on the JAX latents handed in through `calib.data.cali_latents`, against
    the JAX data within 1e-4; each package reads the other's `.npz` cache;
    the same weights give the same fingerprint and cache file name.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.calib import act_calib as JA, data as JD  # noqa: E402
from dgq_tpu.calib.weight_calib import quantize_model_weights as j_qmw  # noqa: E402
from dgq_tpu.cli import common as JC  # noqa: E402
from dgq_tpu.models import qconfig as JQ, unet_sd as JU, unet_sdxl as JX  # noqa: E402
from dgq_tpu_torch.calib import act_calib as TA, data as TD  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import quantize_model_weights as t_qmw  # noqa: E402
from dgq_tpu_torch.cli import common as TC  # noqa: E402
from dgq_tpu_torch.io.convert import params_from_numpy  # noqa: E402
from dgq_tpu_torch.models import qconfig as TQ, unet_sd as TU, unet_sdxl as TX  # noqa: E402

BASE, CROSS = 32, 64
W8A8 = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True)
T2I = dict(t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True)


@pytest.fixture(scope="module")
def sd():
    spec = JU.sd_unet_spec(base=BASE, cross=CROSS)
    assert spec == TU.sd_unet_spec(base=BASE, cross=CROSS)
    jp = JU.init_unet_sd(jax.random.PRNGKey(0), spec=spec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")
    rng = np.random.RandomState(0)
    n = 4
    cali = (rng.randn(n, 16, 16, 4).astype(np.float32),
            rng.randint(0, 1000, (n,)).astype(np.int32),
            rng.randn(n, 77, CROSS).astype(np.float32))
    return spec, jp, tp, cali


@pytest.fixture(scope="module")
def sdxl():
    spec = JX.sdxl_unet_spec(BASE, CROSS, 8, (1, 2))
    jp = JU.init_unet_sd(jax.random.PRNGKey(1), spec=spec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")
    rng = np.random.RandomState(1)
    n = 2
    cali = (rng.randn(n, 16, 16, 4).astype(np.float32),
            np.full((n,), 500, np.int32),
            rng.randn(n, 77, CROSS).astype(np.float32),
            rng.randn(n, 4 * BASE).astype(np.float32),
            np.tile(np.asarray([[128, 128, 0, 0, 128, 128]], np.float32), (n, 1)))
    return spec, jp, tp, cali


def _j(batch):
    return tuple(jnp.asarray(x) for x in batch)


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


@pytest.mark.parametrize("kw", [{}, dict(use_pallas_attention=True, t2i_start_peak=True)])
def test_tap_execution_order_sd(sd, kw):
    spec, jp, tp, cali = sd
    batch = tuple(c[:1] for c in cali)
    jo = JA.tap_execution_order(jp, _j(batch), JQ.QConfig(**kw))
    to = TA.tap_execution_order(tp, _t(batch), TQ.QConfig(**kw))
    assert to == jo
    assert set(TA.act_qpoint_names(spec)) | set(TA.softmax_qpoint_names(spec)) == set(to)


def test_tap_execution_order_sdxl(sdxl):
    spec, jp, tp, cali = sdxl
    jo = JA.tap_execution_order(jp, _j(cali), JQ.QConfig(), unet_apply=JX.unet_sdxl_apply)
    to = TA.tap_execution_order(tp, _t(cali), TQ.QConfig(), unet_apply=TX.unet_sdxl_apply)
    assert to == jo and len(to) == len(set(to))


def _assert_rel(a, b, rtol):
    la, lb = TA.state_leaves({"s": a}), TA.state_leaves({"s": b})
    assert la.keys() == lb.keys()
    for k in la:
        for x, y in zip(la[k], lb[k]):
            np.testing.assert_allclose(y, x, rtol=rtol, atol=0, err_msg=str(k))


@pytest.mark.parametrize("model,kw", [
    ("sd", {}),
    ("sd", dict(t2i_log_quant=True, t2i_start_peak=True)),  # static log2: the quantile search
    ("sdxl", {}),
])
def test_init_act_qstate_one_chunk(sd, sdxl, model, kw):
    spec, jp, tp, cali = sd if model == "sd" else sdxl
    japply = JU.unet_sd_apply if model == "sd" else JX.unet_sdxl_apply
    tapply = TU.unet_sd_apply if model == "sd" else TX.unet_sdxl_apply
    batch = tuple(c[:2] for c in cali)
    jq, jr = JA.init_act_qstate(jp, _j(batch), spec, JQ.QConfig(**W8A8, **kw), chunk=500,
                                unet_apply=japply)
    tq, tr = TA.init_act_qstate(tp, _t(batch), spec, TQ.QConfig(**W8A8, **kw), chunk=500,
                                unet_apply=tapply)
    assert list(tq["a"]) == list(jq["a"]) and list(tq["sm"]) == list(jq["sm"])
    assert bool(tq["sm"]) == (kw.get("t2i_log_quant", False)
                              and not kw.get("t2i_real_time", False))
    _assert_rel(jq, tq, 1e-5)
    assert tr.keys() == jr.keys()
    for n in jr:  # within 1e-5 of the range's size (a softmax minimum is ~1e-8)
        np.testing.assert_allclose(tr[n], jr[n], rtol=0, atol=1e-5 * np.abs(jr[n]).max())


def test_init_act_qstate_chunked_runs_earlier_quantizers(sd):
    """Chunks of 32 taps (the CLI's default): the names and slots of the
    one-chunk state, and later quantizers see earlier ones live, so the
    result differs from the one-chunk run but stays close."""
    spec, _, tp, cali = sd
    batch = _t(tuple(c[:2] for c in cali))
    cfg = TQ.QConfig(**W8A8)
    one, _ = TA.init_act_qstate(tp, batch, spec, cfg, chunk=500)
    many, _ = TA.init_act_qstate(tp, batch, spec, cfg, chunk=32)
    assert list(one["a"]) == list(many["a"])
    first = TA.tap_execution_order(tp, batch, cfg)[:32]
    for n in first:  # the first chunk has nothing live before it
        assert torch.equal(one["a"][n].delta, many["a"][n].delta)


@pytest.mark.parametrize("group_num", [2, 8])
def test_group_stage_matches_jax(sd, group_num):
    """DGQ's group stage alone, from an empty state: no quantizer is live, so
    its forward is not chaotic, and the port gives the JAX package's group
    layers, the same axis at every point, every zero point equal and every
    delta within 1e-5 relative (a group quantizer as its per-element grid)."""
    spec, jp, tp, cali = sd
    batch = tuple(c[:2] for c in cali)
    kw = dict(a_bits=8, softmax_bits=8, use_aq=True)
    jq, jgl = JA.group_calibrate_qstate(jp, {"a": {}, "sm": {}}, [_j(batch)], JQ.QConfig(**kw),
                                        spec, group_num)
    tq, tgl = TA.group_calibrate_qstate(tp, {"a": {}, "sm": {}}, [_t(batch)], TQ.QConfig(**kw),
                                        spec, group_num)
    assert tgl == jgl and len(tgl) > 90
    ta, ja = TA.group_axes({"s": tq}), TA.group_axes({"s": jq})
    assert ta == ja and len(set(ta.values())) == 2  # both axes are chosen somewhere
    assert not TA.moved_leaves({"s": jq}, {"s": tq}, 1e-5), sorted(
        TA.moved_leaves({"s": jq}, {"s": tq}, 1e-5))


def _perturbed_runs(run, cali, n=8, amp=1e-6):
    rng = np.random.RandomState(123)
    out = []
    for _ in range(n):
        x = cali[0] + amp * rng.randn(*cali[0].shape).astype(np.float32)
        out.append(run((x.astype(np.float32),) + tuple(cali[1:])))
    return out


@pytest.fixture(scope="module")
def calibrated(sd):
    """Vanilla and g=2 calibrations of the tiny SD net in both packages (one
    time slot of two samples; the JAX package compiles each collector once,
    about a minute in all), and the port's runs on perturbed latents."""
    spec, jp, tp, cali = sd
    cali = tuple(c[:2] for c in cali)
    out = {}
    for label, kw, g in (("vanilla", {}, 0), ("g2", T2I, 2)):
        jcfg, tcfg = JQ.QConfig(**W8A8, **kw), TQ.QConfig(**W8A8, **kw)
        jpq, _ = j_qmw(jp, spec, jcfg)
        tpq, _ = t_qmw(tp, spec, tcfg)

        def trun(c, tpq=tpq, tcfg=tcfg, g=g):
            return TA.calibrate_activations(tpq, spec, tcfg, _t(c), interval=2, group_num=g,
                                            batch_size=2, init_chunk=500)
        jper, jgl = JA.calibrate_activations(jpq, spec, jcfg, _j(cali), interval=2,
                                             group_num=g, batch_size=2, init_chunk=500)
        out[label] = (jper, jgl, trun(cali), _perturbed_runs(trun, cali))
    return out


@pytest.mark.parametrize("label", ["vanilla", "g2"])
def test_calibrate_activations_within_chaos(calibrated, label):
    jper, jgl, (tper, tgl), perturbed = calibrated[label]
    assert list(tper) == list(jper) == ["act_0"]
    assert tgl == jgl
    assert bool(tgl) == (label == "g2")
    for key in ("a", "sm"):
        assert list(tper["act_0"][key]) == list(jper["act_0"][key])
    err_d, err_z = TA.state_gap(jper, tper)
    chaos_d = max(TA.state_gap(tper, p[0])[0] for p in perturbed)
    chaos_z = max(TA.state_gap(tper, p[0])[1] for p in perturbed)
    assert err_d <= max(5 * chaos_d, 1e-6), (err_d, chaos_d)
    assert err_z <= max(5 * chaos_z, 1e-6), (err_z, chaos_z)
    # Every leaf that none of the perturbations moved (zero points equal,
    # deltas within 1e-5 relative) is the JAX package's at that tolerance.
    moved = set().union(*(TA.moved_leaves(tper, p[0]) for p in perturbed))
    stable = set(TA.state_leaves(tper)) - moved
    assert len(stable) >= 0.2 * len(TA.state_leaves(tper)), len(stable)
    assert not TA.moved_leaves(tper, jper) & stable, sorted(TA.moved_leaves(tper, jper) & stable)
    if label == "g2":
        # The axis choice compares two spreads of quantized activations, and
        # this random-weight net's quantized forward is chaotic: a 1e-6
        # perturbation of the latents flips a few layers' choice in either
        # package. Every layer whose choice no perturbation moved has the
        # JAX package's axis.
        ta, ja = TA.group_axes(tper), TA.group_axes(jper)
        assert ta.keys() == ja.keys() and len(ta) > 300
        flipped = {k for p in perturbed for k, v in TA.group_axes(p[0]).items() if v != ta[k]}
        differ = {k for k in ta if ta[k] != ja[k]}
        assert not differ - flipped, sorted(differ - flipped)
        assert len(flipped) < 0.1 * len(ta)


def test_calibrated_state_runs_the_sampler(sd, calibrated):
    """The g=2 state drives every group-conv form and, stacked time-aware,
    the port's sampler (the forms' parity is tests/test_torch_group_conv.py's;
    under the real-time softmax this net's outputs are chaotic)."""
    from dgq_tpu_torch.pipeline.sampler import sd_sample

    spec, _, tp, cali = sd
    _, _, (tper, tgl), _ = calibrated["g2"]
    cfg = TQ.QConfig(**W8A8, **T2I, group_conv_layers=tgl)
    pq, _ = t_qmw(tp, spec, cfg)
    x, t, ehs = _t(tuple(c[:1] for c in cali))
    outs = [TU.unet_sd_apply(pq, x, t, ehs, qstate=tper["act_0"],
                             cfg=cfg.replace(group_conv_impl=impl))
            for impl in ("unfold", "taps", "im2col")]
    assert all(bool(o.isfinite().all()) and o.shape == x.shape for o in outs)
    final = sd_sample(pq, x, ehs, ehs, num_inference_steps=1, scheduler="ddim",
                      qstate=TA.stack_time_qstates(tper), cfg=cfg, time_aware=True)
    assert bool(final.isfinite().all())


# ------------------------------------------------------------ cali data -----
def _jax_latents(seed, start, shape):
    return np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), start),
                                        shape))


@pytest.fixture
def jax_latents(monkeypatch):
    monkeypatch.setattr(TD, "cali_latents", lambda seed, start, shape, device: torch.from_numpy(
        _jax_latents(seed, start, shape)).to(device))


def test_sd_cali_data_layout_and_parity(sd, jax_latents, tmp_path):
    spec, jp, tp, _ = sd
    rng = np.random.RandomState(5)
    text = rng.randn(3, 77, CROSS).astype(np.float32)
    uncond = np.repeat(rng.randn(1, 77, CROSS).astype(np.float32), 3, axis=0)
    kw = dict(steps=2, scheduler="pndm", latent_hw=16, seed=0, batch_size=2)
    (jl, jt, je), ji = JD.generate_sd_cali_data(jp, jnp.asarray(text), jnp.asarray(uncond), **kw)
    cache = str(tmp_path / "t.npz")
    (tl, tt, te), ti = TD.generate_sd_cali_data(tp, torch.from_numpy(text),
                                                torch.from_numpy(uncond), cache_path=cache, **kw)
    assert ti == ji == 6 and tl.shape == (3 * 6, 16, 16, 4) == jl.shape
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    # ehs rows: per prompt batch [uncond | text] (batch_size 2: u0 u1 t0 t1 u2 t2)
    np.testing.assert_array_equal(te[:6].numpy(), np.concatenate(
        [uncond[:2], text[:2], uncond[2:], text[2:]]))
    # each package reads the other's cache
    (jl2, jt2, je2), ji2 = JD.generate_sd_cali_data(jp, jnp.asarray(text), jnp.asarray(uncond),
                                                    cache_path=cache, **kw)
    assert ji2 == ti
    np.testing.assert_array_equal(np.asarray(jl2), tl.numpy())
    np.testing.assert_array_equal(np.asarray(je2), te.numpy())
    jcache = str(tmp_path / "j.npz")
    JD.generate_sd_cali_data(jp, jnp.asarray(text), jnp.asarray(uncond), cache_path=jcache,
                             **kw)
    (tl2, tt2, _), ti2 = TD.generate_sd_cali_data(tp, torch.from_numpy(text),
                                                  torch.from_numpy(uncond), cache_path=jcache,
                                                  **kw)
    assert ti2 == ji
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt))


def test_sdxl_cali_data_parity(sdxl, jax_latents, tmp_path):
    spec, jp, tp, _ = sdxl
    rng = np.random.RandomState(6)
    text = rng.randn(2, 77, CROSS).astype(np.float32)
    pooled = rng.randn(2, 4 * BASE).astype(np.float32)
    kw = dict(steps=2, latent_hw=16, seed=3, batch_size=1)
    jd, ji = JD.generate_sdxl_cali_data(jp, jnp.asarray(text), jnp.asarray(pooled), **kw)
    cache = str(tmp_path / "x.npz")
    td, ti = TD.generate_sdxl_cali_data(tp, torch.from_numpy(text), torch.from_numpy(pooled),
                                        cache_path=cache, **kw)
    assert ti == ji == 2 and len(td) == 5
    for a, b in zip(jd[1:], td[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    scale = float(np.abs(np.asarray(jd[0])).max())
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd[0]), atol=1e-5 * scale, rtol=0)
    jd2, _ = JD.generate_sdxl_cali_data(jp, jnp.asarray(text), jnp.asarray(pooled),
                                        cache_path=cache, **kw)
    for a, b in zip(jd2, td):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_fingerprint_and_cache_name_match_jax(sd, tmp_path):
    spec, jp, tp, _ = sd
    assert TC._params_fingerprint(tp) == JC._params_fingerprint(jp)
    other = params_from_numpy(jax.tree.map(np.asarray, JU.init_unet_sd(
        jax.random.PRNGKey(7), spec=spec)), spec, device="cpu")
    assert TC._params_fingerprint(other) != TC._params_fingerprint(tp)
    e = np.random.RandomState(2).randn(2, 77, CROSS).astype(np.float32)
    assert (TC._params_fingerprint({"t": torch.from_numpy(e), "u": torch.from_numpy(-e)})
            == JC._params_fingerprint({"t": jnp.asarray(e), "u": jnp.asarray(-e)}))
    # the CLI's cache file names agree: the port reads the file the JAX CLI wrote
    prefix = str(tmp_path / "cali")
    text, uncond = JD.synthetic_prompt_embeddings(2, dim=CROSS, seed=0)
    JC.build_cali_data("sd", jp, JU.unet_sd_apply, CROSS, 2, 1, 16, 0, cache_prefix=prefix,
                       embeds=(text, uncond))
    (lmi, _, ehs), interval = TC.build_cali_data(
        "sd", tp, TU.unet_sd_apply, CROSS, 2, 1, 16, 0, cache_prefix=prefix,
        embeds=(torch.zeros(2, 77, CROSS), torch.zeros(2, 77, CROSS)))
    assert interval == 4
    np.testing.assert_array_equal(ehs[:2].numpy(), np.asarray(uncond))  # read, not made
