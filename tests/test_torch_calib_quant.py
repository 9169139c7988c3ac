"""The port's calibration primitives against the JAX package's, on the same
numpy inputs:

  * every scaler (minmax, mse, omse, logminmax, kl, hist), per tensor and
    per out channel: delta and zero point within 1e-6 relative; where the
    two searches chose different grid points, the two candidates' losses
    must agree within 1e-6 relative (a tie the reduction order can break
    either way). kl / hist also on bfloat16 input.
  * the log2 quantile search (`log2_init_delta`, and `tail_quantiles`
    against `jnp.quantile` past torch.quantile's 2^24-element limit), the
    EMA helpers bit for bit;
  * `update_group_stats` bit for bit;
  * `kmeans_group_qparams` against the JAX package's scikit-learn k-means
    over 5 channel counts x 3 group counts x 10 seeds: the same partition
    and axis, bit-identical delta / zero point in `minmax` mode, `mean`
    within 1e-6 relative;
  * importing the port and running its k-means leaves scikit-learn out of
    `sys.modules` (in a subprocess).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.quant import affine as j_aff, groups as j_grp, log2 as j_log2  # noqa: E402
from dgq_tpu.quant import scalers as j_sc  # noqa: E402
from dgq_tpu_torch.quant import affine as t_aff, groups as t_grp, log2 as t_log2  # noqa: E402
from dgq_tpu_torch.quant import scalers as t_sc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALERS = ["minmax", "mse", "omse", "logminmax", "kl", "hist"]


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _loss(x, delta, zp, scaler, bits, symmetric, always_zero):
    """The search's loss of one (delta, zp) candidate on x, in float64."""
    x = np.asarray(x, np.float64)
    level = 2 ** bits
    if scaler == "logminmax":
        x16 = x.astype(np.float16)
        d = np.float16(delta)
        q = np.clip(np.round(-np.log2(x16 / d)), 0, level - 1)
        return np.mean((x16.astype(np.float64) - (d * np.float16(2.0) ** q)) ** 2)
    nb, pb = (0, level - 1) if scaler == "omse" else j_sc._bounds(level, symmetric,
                                                                   always_zero)
    q = np.clip(np.round(x / delta) + zp, nb, pb)
    return np.mean(np.abs(delta * (q - zp) - x) ** 2.4)


def _assert_close_or_tie(x_rows, jd, jz, td, tz, scaler, bits, symmetric, always_zero):
    jd, jz, td, tz = (np.asarray(v, np.float64).reshape(-1) for v in (jd, jz, td, tz))
    for r in range(jd.size):
        if (abs(jd[r] - td[r]) <= 1e-6 * abs(jd[r])
                and abs(jz[r] - tz[r]) <= 1e-6 * max(abs(jz[r]), 1.0)):
            continue
        lj = _loss(x_rows[r], jd[r], jz[r], scaler, bits, symmetric, always_zero)
        lt = _loss(x_rows[r], td[r], tz[r], scaler, bits, symmetric, always_zero)
        assert abs(lj - lt) <= 1e-6 * abs(lj), (r, jd[r], td[r], jz[r], tz[r], lj, lt)


@pytest.mark.parametrize("scaler", SCALERS)
@pytest.mark.parametrize("bits,symmetric,always_zero", [
    (4, False, False), (8, False, False), (8, True, False), (8, False, True)])
def test_scalers_per_tensor_and_channelwise(scaler, bits, symmetric, always_zero):
    if scaler == "omse" and bits == 8:
        bits = 6  # 80 x 2^bits candidates: keep the eager loop short
    x = _rand(6, 4, 3, 3, seed=bits + 3 * symmetric + 5 * always_zero, scale=2.0)
    if scaler == "logminmax":
        x = np.abs(x) / np.abs(x).max()  # a softmax-like positive tensor
    j = j_sc.init_scale(jnp.asarray(x), bits, scaler, symmetric, always_zero)
    t = t_sc.init_scale(torch.from_numpy(x), bits, scaler, symmetric, always_zero)
    assert t.delta.dim() == 0 and t.zero_point.dim() == 0
    _assert_close_or_tie(x.reshape(1, -1), j.delta, j.zero_point, _np(t.delta),
                         _np(t.zero_point), scaler, bits, symmetric, always_zero)
    j = j_sc.init_scale_channelwise(jnp.asarray(x), bits, scaler, symmetric, always_zero)
    t = t_sc.init_scale_channelwise(torch.from_numpy(x), bits, scaler, symmetric, always_zero)
    assert tuple(t.delta.shape) == (6, 1, 1, 1) == tuple(t.zero_point.shape)
    _assert_close_or_tie(x.reshape(6, -1), j.delta, j.zero_point, _np(t.delta),
                         _np(t.zero_point), scaler, bits, symmetric, always_zero)


def test_logminmax_with_negative_input():
    """log2 of a negative value is NaN: every candidate scores NaN and the
    search keeps max(x) in both packages."""
    x = _rand(3, 40, seed=11)
    j = j_sc.init_scale(jnp.asarray(x), 8, "logminmax")
    t = t_sc.init_scale(torch.from_numpy(x), 8, "logminmax")
    np.testing.assert_array_equal(np.asarray(j.delta), _np(t.delta))


def test_mse_row_chunks_match_one_block(monkeypatch):
    """Chunking the rows (ROW_CHUNK_ELEMENTS) changes nothing."""
    w = _rand(12, 3, 3, 3, seed=12)
    whole = t_sc.init_scale_channelwise(torch.from_numpy(w), 4, "mse")
    monkeypatch.setattr(t_sc, "ROW_CHUNK_ELEMENTS", 60)
    chunked = t_sc.init_scale_channelwise(torch.from_numpy(w), 4, "mse")
    assert torch.equal(whole.delta, chunked.delta)
    assert torch.equal(whole.zero_point, chunked.zero_point)


@pytest.mark.parametrize("scaler", ["hist", "kl"])
def test_hist_kl_accept_bf16(scaler):
    x32 = np.abs(_rand(512, seed=3)) * 2.0
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    j = j_sc.init_scale(xb, 8, scaler)
    t = t_sc.init_scale(torch.from_numpy(x32).to(torch.bfloat16), 8, scaler)
    t32 = t_sc.init_scale(torch.from_numpy(x32).to(torch.bfloat16).float(), 8, scaler)
    for a, b in ((j.delta, t.delta), (j.zero_point, t.zero_point), (t32.delta, t.delta)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6)


def test_log2_init_delta_and_ema():
    logits = _rand(2, 4, 64, 77, seed=4, scale=3.0)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for bits in (8, 4):
        j = j_log2.log2_init_delta(jnp.asarray(p), bits)
        t = t_log2.log2_init_delta(torch.from_numpy(p), bits)
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6)
    d = np.float32(0.31)
    np.testing.assert_array_equal(
        np.asarray(j_log2.log2_ema_update(jnp.asarray(d), jnp.asarray(p), 0.95)),
        _np(t_log2.log2_ema_update(torch.tensor(d), torch.from_numpy(p), 0.95)))


@pytest.mark.parametrize("n", [1, 2, 1000, 77 * 77 + 3, (1 << 24) + 5])
def test_tail_quantiles_match_jnp_quantile(n):
    """`jnp.quantile`'s linear interpolation from the tail alone, also past
    the 2^24 elements that torch.quantile refuses."""
    x = np.random.RandomState(n % 1000).rand(n).astype(np.float32)
    qs = (0.999, 0.9999, 0.99999)
    got = t_log2.tail_quantiles(torch.from_numpy(x), qs)
    want = jnp.quantile(jnp.asarray(x), jnp.asarray(qs, jnp.float32))
    np.testing.assert_array_equal(np.asarray([_np(g) for g in got]), np.asarray(want))


def test_ema_helpers_bit_identical():
    x = _rand(5, 7, seed=5, scale=3.0)
    j = j_aff.ema_minmax_update(jnp.asarray(x), jnp.float32(-1.5), jnp.float32(2.5))
    t = t_aff.ema_minmax_update(torch.from_numpy(x), torch.tensor(-1.5), torch.tensor(2.5))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    for lo, hi in ((-1.0, 3.0), (-0.2137, 0.99871), (0.4, 2.0), (-3.0, -1.0)):
        for bits, sym, az in ((8, False, False), (4, False, False), (8, True, False),
                              (8, False, True)):
            j = j_aff.minmax_qparams_from_range(jnp.asarray(lo), jnp.asarray(hi), bits, sym, az)
            t = t_aff.minmax_qparams_from_range(lo, hi, bits, sym, az)
            np.testing.assert_array_equal(np.asarray(j.delta), _np(t.delta))
            np.testing.assert_array_equal(np.asarray(j.zero_point), _np(t.zero_point))


@pytest.mark.parametrize("shape", [(2, 9, 5), (2, 3, 6, 4)])
def test_update_group_stats_bit_identical(shape):
    xs = [_rand(*shape, seed=s, scale=2.0) for s in range(3)]
    j = j_grp.init_group_stats(shape)
    t = t_grp.init_group_stats(shape, device="cpu")
    for x in xs:
        j = j_grp.update_group_stats(j, jnp.asarray(x))
        t = t_grp.update_group_stats(t, torch.from_numpy(x))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


def _channel_stats(n, seed):
    """(in_min, in_max, out_min, out_max) of n channels each, shaped like
    recorded activation ranges: a spread of centres, heavy-tailed widths,
    a few outlier channels; the spread heuristic picks either axis."""
    rng = np.random.RandomState(seed)
    out = []
    for axis in range(2):
        scale = rng.choice([0.05, 0.5, 2.0, 8.0])
        lo = rng.randn(n) * scale - np.abs(rng.standard_cauchy(n)) * 0.1 * scale
        hi = lo + np.abs(rng.randn(n)) * scale * 2 + np.abs(rng.standard_cauchy(n)) * 0.2
        hot = rng.rand(n) < 0.02
        hi[hot] *= rng.uniform(3, 20)
        out += [lo.astype(np.float32), hi.astype(np.float32)]
    return out[0], out[1], out[2], out[3]


@pytest.mark.parametrize("g", [2, 8, 16])
@pytest.mark.parametrize("n", [320, 640, 1280, 2880, 4096])
def test_kmeans_group_qparams_matches_sklearn(n, g):
    for seed in range(10):
        in_min, in_max, out_min, out_max = _channel_stats(n, seed * 7919 + n + g)
        js = j_grp.GroupStats(*(jnp.asarray(v) for v in (in_min, in_max, out_min, out_max)))
        ts = t_grp.GroupStats(*(torch.from_numpy(v) for v in (in_min, in_max, out_min,
                                                                out_max)))
        for mode in ("minmax", "mean"):
            jq, jl, jw = j_grp.kmeans_group_qparams(js, g, 256, mode)
            tq, tl, tw = t_grp.kmeans_group_qparams(ts, g, 256, mode)
            assert tw == jw, (seed, mode)
            np.testing.assert_array_equal(tl, jl, err_msg=f"seed {seed} {mode}")
            assert tuple(tq.delta.shape) == tuple(jq.delta.shape)
            if mode == "minmax":
                np.testing.assert_array_equal(_np(tq.delta), np.asarray(jq.delta))
                np.testing.assert_array_equal(_np(tq.zero_point), np.asarray(jq.zero_point))
            else:
                np.testing.assert_allclose(_np(tq.delta), np.asarray(jq.delta), rtol=1e-6)
                np.testing.assert_allclose(_np(tq.zero_point), np.asarray(jq.zero_point),
                                           rtol=1e-6)


def test_kmeans_leaves_sklearn_unimported():
    code = (
        "import sys, numpy as np, torch\n"
        "import dgq_tpu_torch\n"
        "from dgq_tpu_torch.calib import act_calib\n"
        "from dgq_tpu_torch.cli import quantize_act, quantize_weight\n"
        "from dgq_tpu_torch.quant.groups import GroupStats, kmeans_group_qparams\n"
        "r = np.random.RandomState(0)\n"
        "s = GroupStats(*(torch.from_numpy(r.randn(300).astype(np.float32)) "
        "for _ in range(4)))\n"
        "qp, labels, _ = kmeans_group_qparams(s, 8, 256)\n"
        "assert len(set(labels.tolist())) == 8\n"
        "assert 'sklearn' not in sys.modules, 'sklearn was imported'\n"
        "assert 'jax' not in sys.modules and 'dgq_tpu' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_kmeans_refuses_fewer_points_than_groups():
    with pytest.raises(ValueError, match="n_clusters"):
        t_grp.kmeans(np.zeros((3, 2), np.float32), 4)
