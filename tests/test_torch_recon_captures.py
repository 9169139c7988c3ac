"""Captures held in host memory (`calib.reconstruction`, `captures=`): the
same walk and the same Adam loops as with captures on the device, bit for
bit, on the tiny SD net (base 32, cross 64, 16x16 latents, weights and 4
calibration samples from seed 11, W4 minmax scales). The port alone: no JAX
(the JAX parity of the host form is `tests/test_torch_recon_walk.py::
test_asym_walk_follows_jax[host]`).

  * `calibrate_weights(captures="host")` against `captures="device"`: every
    step's loss of every unit and every offset equal, for the mse loss with
    and without asym and for fisher_diag; the placement logged;
  * the prefetch ring of `_RowFeed` at its edges: no step, fewer steps than
    its depth, a batch larger than the sample count, and a dp rank's rows
    (steps where the rank holds none of the batch);
  * `hold_on_host` and `_Captures.place`, the rule as a function of bytes
    and free memory; `check_host_room`, host captures against the host's
    MemAvailable, and `host_memory`, its reader;
  * `unit_error` on host captures.

On the CPU the host form runs the same ring, its copies synchronous and
nothing pinned; the `cuda` case runs it on the card (pinned memory, a
side stream, events) and skips here."""
import pytest
import torch

from dgq_tpu_torch.calib import reconstruction as TR
from dgq_tpu_torch.calib.weight_calib import fold_weight_quant, init_weight_qparams
from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec

CFG = QConfig(w_bits=4, use_wq=True)
WALK = dict(iters=6, batch_size=2, capture_batch=3, seed=0, max_units=4)
GIB = 2 ** 30


def _tiny(device="cpu"):
    g = torch.Generator().manual_seed(11)
    spec = sd_unet_spec(base=32, cross=64)
    cali = (torch.randn(4, 16, 16, 4, generator=g),
            torch.tensor([1, 250, 501, 999], dtype=torch.int32),
            torch.randn(4, 77, 64, generator=g))
    params = init_unet_sd(torch.Generator(device=device).manual_seed(12), device, spec=spec)
    return spec, params, init_weight_qparams(params, spec, 4), cali


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


def _walk(monkeypatch, net, captures, **kw):
    """The walk -> (offsets, [(unit, losses, captures form, the call's
    inputs, outputs and params, the unit's offsets)], its progress lines)."""
    spec, params, wqp, cali = net
    calls, lines = [], []
    real = TR.reconstruct_unit

    def unit(key, u, p, q, inputs, outputs, cfg, **k):
        alphas, losses = real(key, u, p, q, inputs, outputs, cfg, **k)
        calls.append((u, losses, k["captures"], inputs, outputs, p, alphas))
        return alphas, losses
    monkeypatch.setattr(TR, "reconstruct_unit", unit)
    alphas = TR.calibrate_weights(params, spec, CFG, wqp, cali, captures=captures,
                                  progress=lines.append, **{**WALK, **kw})
    monkeypatch.setattr(TR, "reconstruct_unit", real)
    return alphas, calls, lines


@pytest.mark.parametrize("kw", [dict(asym=True), dict(asym=False),
                                dict(asym=True, opt_mode="fisher_diag")],
                         ids=["mse-asym", "mse-sym", "fisher_diag-asym"])
def test_host_walk_is_the_device_walk_bit_for_bit(tiny, monkeypatch, kw):
    a_dev, dev, dev_lines = _walk(monkeypatch, tiny, "device", **kw)
    a_host, host, host_lines = _walk(monkeypatch, tiny, "host", **kw)
    assert [c[2] for c in dev] == ["device"] * 4 and [c[2] for c in host] == ["host"] * 4
    assert [c[0] for c in host] == [c[0] for c in dev]
    for d, h in zip(dev, host):
        assert torch.equal(d[1], h[1]), d[0].name  # every step's loss
    assert set(a_host) == set(a_dev) and all(torch.equal(a_host[n], a_dev[n]) for n in a_dev)
    # one placement line a unit, after the unit's line
    placed = [l for l in host_lines if l.startswith("captures: ")]
    assert len(placed) == 4 and all(l.endswith('in host memory (captures="host")')
                                    for l in placed)
    assert all(l.endswith('on the CPU (captures="device")')
               for l in dev_lines if l.startswith("captures: "))


def test_auto_holds_the_captures_on_the_cpu_device(tiny, monkeypatch):
    alphas, calls, lines = _walk(monkeypatch, tiny, "auto", max_units=2)
    assert [c[2] for c in calls] == ["device", "device"]
    assert [l.split(" (")[1] for l in lines if l.startswith("captures: ")] == [
        "the CPU computes)"] * 2
    with pytest.raises(ValueError, match="captures must be one of"):
        TR.calibrate_weights(tiny[1], tiny[0], CFG, tiny[2], tiny[3], captures="pinned",
                             **WALK)


@pytest.fixture(scope="module")
def unit_data(tiny):
    """One resnet's captures (fp inputs and outputs over the 4 samples) and
    a Fisher weight of their shape."""
    spec, params, wqp, cali = tiny
    unit = next(u for u in TR.recon_units(spec) if u.kind == "resnet")
    inputs, out = TR.capture_unit_io(params, cali, unit.name, CFG)
    grads = 1.0 + torch.rand(out.shape, generator=torch.Generator().manual_seed(3))
    return unit, params, wqp, inputs, out, grads


@pytest.mark.parametrize("iters,batch", [(0, 2), (1, 2), (2, 2), (5, 7)],
                         ids=["no-step", "one-step", "below-ring-depth", "batch-above-n"])
@pytest.mark.parametrize("opt_mode", ["mse", "fisher_diag"])
def test_ring_edges(unit_data, iters, batch, opt_mode):
    assert TR.FEED_DEPTH > 2  # "below-ring-depth" runs 2 steps
    unit, params, wqp, inputs, out, grads = unit_data
    got = {}
    for form in ("device", "host"):
        got[form] = TR.reconstruct_unit((0, 3), unit, params, wqp, inputs, out, CFG,
                                        iters=iters, batch_size=batch, opt_mode=opt_mode,
                                        cached_grads=grads, captures=form)
    (a_dev, l_dev), (a_host, l_host) = got["device"], got["host"]
    assert l_host.shape == (iters,) and torch.equal(l_host, l_dev)
    assert all(torch.equal(a_host[n], a_dev[n]) for n in a_dev)


def test_dp_rank_rows(unit_data, monkeypatch):
    """A rank's re-based rows of its slice [1, 3) of 4 samples: some steps
    hold none of the batch (weight 0, no rows fed), some one or two."""
    unit, params, wqp, inputs, out, _ = unit_data
    monkeypatch.setattr(TR, "all_reduce_sum_", lambda mesh, tensors: None)
    shard = TR.Shard(None, 1, 3, 4)
    idx = TR.batch_indices((0, 5), 8, 2, 4)
    counts = [int(((r >= 1) & (r < 3)).sum()) for r in idx]
    assert 0 in counts and max(counts) > 0
    got = {form: TR.reconstruct_unit((0, 5), unit, params, wqp, tuple(x[1:3] for x in inputs),
                                     out[1:3], CFG, iters=8, batch_size=2, shard=shard,
                                     captures=form)
           for form in ("device", "host")}
    assert torch.equal(got["host"][1], got["device"][1])
    assert all(torch.equal(got["host"][0][n], got["device"][0][n]) for n in got["device"][0])
    with pytest.raises(ValueError, match='captures must be "device" or "host"'):
        TR.reconstruct_unit((0, 5), unit, params, wqp, inputs, out, CFG, iters=1,
                            captures="auto")


def test_act_delta_loop_in_host_form(tiny, unit_data):
    """The activation-delta loop (per-tensor A8 at each of the unit's
    inputs, as tests/test_torch_recon_loops.py sets them) in both forms."""
    unit, params, wqp, inputs, out, _ = unit_data
    params_q = fold_weight_quant(params, wqp, tiny[0], CFG)
    deltas = {n: 0.004 + 0.002 * i for i, n in enumerate(unit.layers)}
    qs = {"a": {n: TR.QParams(torch.tensor(d), torch.tensor(128.0)) for n, d in deltas.items()},
          "sm": {}}
    got = {form: TR.reconstruct_unit_act_deltas((0, 1), unit, params_q, qs, inputs, out, CFG,
                                                iters=5, batch_size=3, captures=form)
           for form in ("device", "host")}
    assert torch.equal(got["host"][1], got["device"][1])
    for n, d in deltas.items():
        moved = got["host"][0]["a"][n].delta
        assert torch.equal(moved, got["device"][0]["a"][n].delta) and abs(float(moved) - d) > 1e-7


@pytest.mark.parametrize("projected,free,host", [
    (0, 0, False),
    (10 * GIB, 20 * GIB, False),       # exactly half: stays on the card
    (10 * GIB + 1, 20 * GIB, True),
    (int(65.02 * GIB), int(70.1 * GIB), True),   # SD v1.4's up_blocks.3.resnets.0, 3328 samples
    (int(0.39 * GIB), int(70.1 * GIB), False),   # the same unit at 20 samples
    (20 * GIB, 50 * GIB, False),       # SDXL-turbo's up_blocks.2.resnets.0, 256 samples
])
def test_placement_rule(projected, free, host):
    assert TR.hold_on_host(projected, free) is host


@pytest.mark.parametrize("fisher", [False, True])
def test_place_decides_from_the_first_chunk(monkeypatch, fisher):
    """`_Captures.place` on a card (its free bytes stood in): bytes a
    sample from the first chunk times the rank's samples, the Fisher
    weights counted under a Fisher loss, and one logged line."""
    monkeypatch.setattr(TR, "_free_bytes", lambda device: 8 * 2 ** 20)
    lines = []
    store = TR._Captures(torch.device("cuda"), "auto", 10, fisher, lines.append)
    ins = (torch.zeros(2, 64, 1024), torch.zeros(2, 1280))  # 256 KiB + 5 KiB a sample
    out = torch.zeros(2, 32, 1024)                          # 128 KiB a sample
    store.place(ins, out)
    sample = 4 * (64 * 1024 + 1280 + 32 * 1024 + (32 * 1024 if fisher else 0))
    assert store.projected == 10 * sample
    assert store.host is (10 * sample > 4 * 2 ** 20) and store.form == (
        "host" if store.host else "device")
    where = "in pinned host memory" if store.host else "on the card"
    assert lines == [f"captures: {10 * sample / GIB:.2f} GiB {where} (free 0.01 GiB on the card)"]


@pytest.mark.parametrize("projected,mem,raises", [
    (int(65.02 * GIB), {"MemTotal": 101 * GIB, "MemAvailable": 90 * GIB}, False),
    (90 * GIB, {"MemTotal": 101 * GIB, "MemAvailable": 90 * GIB}, False),
    (90 * GIB + 1, {"MemTotal": 101 * GIB, "MemAvailable": 90 * GIB}, True),
    (int(65.02 * GIB), {"MemTotal": 64 * GIB, "MemAvailable": 60 * GIB}, True),
    (int(65.02 * GIB), {}, False),     # /proc/meminfo not read: nothing checked
])
def test_check_host_room(projected, mem, raises):
    if not raises:
        TR.check_host_room(projected, mem)
        return
    with pytest.raises(RuntimeError) as err:
        TR.check_host_room(projected, mem)
    assert (f"{projected} bytes" in str(err.value)
            and f"MemAvailable of {mem['MemAvailable']} bytes" in str(err.value)
            and f"MemTotal {mem['MemTotal']} bytes" in str(err.value))


def test_host_memory_reads_meminfo():
    mem = TR.host_memory()
    if not mem:
        pytest.skip("no /proc/meminfo on this host")
    assert 0 < mem["MemAvailable"] <= mem["MemTotal"] and mem["MemTotal"] % 1024 == 0


def test_place_refuses_host_captures_beyond_memavailable(monkeypatch):
    """On a card, host captures larger than MemAvailable raise once the
    decision is logged, before any tensor is allocated."""
    monkeypatch.setattr(TR, "_free_bytes", lambda device: 2 ** 20)
    monkeypatch.setattr(TR, "host_memory", lambda: {"MemTotal": 2 ** 21, "MemAvailable": 2 ** 20})
    lines = []
    store = TR._Captures(torch.device("cuda"), "auto", 10, False, lines.append)
    with pytest.raises(RuntimeError, match="MemAvailable of 1048576 bytes"):
        store.place((torch.zeros(2, 64, 1024),), torch.zeros(2, 32, 1024))
    assert store.host and lines[0].startswith("captures: ") and not store._pinned


def test_unit_error_on_host_captures(tiny, monkeypatch):
    """unit_error on the host walk's captures: its device walk's values, and
    the learned rounding no worse than 1.5x nearest."""
    errs = {}
    for form in ("device", "host"):
        _, calls, _ = _walk(monkeypatch, tiny, form, max_units=3)
        errs[form] = [TR.unit_error(u, p, tiny[2], alphas, inputs, outputs, CFG, chunk=3)
                      for u, _, _, inputs, outputs, p, alphas in calls]
    assert errs["host"] == errs["device"]
    assert all(0 < learned <= 1.5 * nearest for learned, nearest in errs["host"])


@pytest.mark.cuda
def test_host_walk_on_the_card_is_the_device_walk():
    """On the card: pinned captures, the rows copied on a side stream; the
    walk's losses and offsets those of the on-card form, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is false")
    net = _tiny("cuda")
    mp = pytest.MonkeyPatch()
    try:
        a_dev, dev, _ = _walk(mp, net, "device", asym=True, opt_mode="fisher_diag")
        a_host, host, lines = _walk(mp, net, "host", asym=True, opt_mode="fisher_diag")
    finally:
        mp.undo()
    assert all(l.endswith('in pinned host memory (captures="host")')
               for l in lines if l.startswith("captures: "))
    assert all(h[3][0].device.type == "cpu" for h in host)
    for d, h in zip(dev, host):
        assert torch.equal(d[1], h[1]), d[0].name
    assert all(torch.equal(a_host[n], a_dev[n]) for n in a_dev)
