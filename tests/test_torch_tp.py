"""The port's channel parallelism (`parallel/mesh.py:shard_params_tp`,
`gather_params_tp`, the dp x tp groups; `parallel/tp.py`; `--tp` in
`cli.quantize_weight`) against the JAX package's tp axis, on the CPU:

  * `shard_params_tp`'s rule with a hand-made mesh (no process group), tp 2
    and 3, on the tiny SD params plus a layer of 5 out channels (replicated
    at both) and one of 6 (cut at both): the leaves the JAX package cuts
    (`P(..., "tp")` on its HWIO / (I, O) out axis) are the port's cut
    weights, and rank t keeps the rows JAX's shard t holds. The port also
    cuts a cut layer's bias, which JAX replicates as a 1-D leaf; `like=`
    cuts a tree of scales the same way. A cut layer refuses the int8, codes
    fold and group-conv routes;
  * one JAX forward of the tiny UNet with its params sharded over a (1, 2)
    mesh equals its unsharded forward (the reference at tp 2 is its tp 1);
  * two gloo ranks (a file rendezvous under tmp_path, one thread each), one
    launch: a cut linear pair with a residual that skips the first, and a
    cut 3x3 conv, forward and backward, equal the unsharded layers within
    1e-6 of the largest value, each rank's weight gradients the matching
    rows (a gather that summed its gradient would double them); the
    gathered params equal the whole bit for bit and their calibration-cache
    fingerprint is the whole's; the tiny walk of tests/test_torch_dp_recon.py
    ('mse': 4 units, two lone layers and two resnets; 'tib fisher_diag')
    at tp 2 on JAX's index stream against the JAX walk, at the loops'
    limits (every step's loss within 5e-5 relative, more than 0.9 of the
    gathered offsets within 1e-4; the temporal block's losses against the
    port's own run of it, as in that file), the gathered weight scales equal
    the whole's bit for bit; `cli.quantize_weight --tp 2 --fast --no_recon
    --use_aq` at base 32: the weight-only file equals `--tp 1`'s bit for
    bit, the activation states within 1e-5 relative;
  * four gloo ranks: the dp and tp groups of a (2, 2) mesh hold the ranks
    rank = d * tp + t says, a sum over each group, the broadcast from dp
    rank 0 of each dp group, and each rank's batch rows by its dp index;
    `cli.quantize_weight --dp 2 --tp 2 --partial_dir` (3 units, 4 Adam
    steps) learns `--tp 1`'s offsets (within 2 lr K, more than 0.9 within
    1e-4), the same command resumes every unit from the saves, and it and
    `--resume_w` write the first run's file bit for bit.

The JAX walks and forwards run in this process while both launches run.
About 65 s on one worker.
"""
import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from recon_parity import (  # noqa: E402
    compare_alphas,
    jax_batch_indices,
    launch_ranks,
    tiny_sd,
    tnp,
    to_j,
    to_t,
)

from dgq_tpu.calib import reconstruction as JR  # noqa: E402
from dgq_tpu.models import unet_sd as JU  # noqa: E402
from dgq_tpu.models.qconfig import QConfig as JQC  # noqa: E402
from dgq_tpu.parallel import mesh as JM  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu_torch.calib import reconstruction as TR  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import attach_int8_packed  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams as t_init_wqp  # noqa: E402
from dgq_tpu_torch.cli import quantize_weight as TQW  # noqa: E402
from dgq_tpu_torch.io.convert import reference_layout  # noqa: E402
from dgq_tpu_torch.models import layers as TL  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQC  # noqa: E402
from dgq_tpu_torch.parallel import mesh as TM  # noqa: E402
from dgq_tpu_torch.quant.affine import QParams  # noqa: E402

W4 = dict(w_bits=4, use_wq=True)
ITERS, BATCH, LR = 20, 2, 1e-3
RUNS = {  # label -> (samples, calibrate_weights keywords), as tests/test_torch_dp_recon.py
    "mse": (4, dict(max_units=4, asym=False)),
    "tib fisher_diag": (4, dict(max_units=3, asym=False, tib_recon=True,
                                opt_mode="fisher_diag")),
}
CLI = ["--device", "cpu", "--model", "sd", "--base", "32", "--wq", "4", "--fast", "--no_recon",
       "--use_aq", "--cali_prompt_data_n", "2", "--step_size", "2", "--latent_hw", "16"]
# the four ranks' reconstruction: 12 samples (6 a dp rank), 3 units, 4 Adam steps
WALK = ["--device", "cpu", "--model", "sd", "--base", "32", "--wq", "4", "--fast", "--iters", "4",
        "--max_units", "3", "--cali_prompt_data_n", "2", "--step_size", "2", "--latent_hw", "16"]

WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from dgq_tpu_torch.calib import reconstruction as TR
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams
from dgq_tpu_torch.cli import quantize_weight
from dgq_tpu_torch.cli.common import _params_fingerprint
from dgq_tpu_torch.models.layers import conv2d, linear, silu
from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.parallel.mesh import (gather_params_tp, init_multihost, make_mesh,
                                          shard_params_tp)

rank, world, init, data, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
assert init_multihost(init, world, rank, device="cpu")
mesh = make_mesh(tp=2, device="cpu")
d = torch.load(data, weights_only=False)
res = {"mesh": [mesh.dp, mesh.tp, mesh.rank, mesh.tp_rank]}

# the cut layers, forward and backward, against the whole layers
g = torch.Generator().manual_seed(0)
whole = {"lin1": {"w": torch.randn(16, 16, generator=g) / 4, "b": torch.randn(16, generator=g)},
         "lin2": {"w": torch.randn(8, 16, generator=g) / 4, "b": torch.randn(8, generator=g)},
         "conv": {"w": torch.randn(6, 5, 3, 3, generator=g) / 6, "b": torch.randn(6, generator=g)}}
x, xc = torch.randn(3, 7, 16, generator=g), torch.randn(2, 5, 5, 5, generator=g)
gy, gc = torch.randn(3, 7, 8, generator=g), torch.randn(2, 5, 5, 6, generator=g)

def run(params):
    for p in params.values():
        p["w"].requires_grad_(True)
        p["b"].requires_grad_(True)
    xx, xxc = x.clone().requires_grad_(True), xc.clone().requires_grad_(True)
    h = linear(params["lin1"], xx) + xx  # the residual skips the cut layer
    y = linear(params["lin2"], silu(h))
    yc = conv2d(params["conv"], xxc, 1, 1)
    ((y * gy).sum() + (yc * gc).sum()).backward()
    return {"y": y.detach(), "yc": yc.detach(), "gx": xx.grad, "gxc": xxc.grad,
            "gw": {n: p["w"].grad for n, p in params.items()},
            "gb": {n: p["b"].grad for n, p in params.items()}}

res["whole"] = run({n: {k: v.clone() for k, v in p.items()} for n, p in whole.items()})
cut = shard_params_tp(mesh, whole)
res["cut"] = run(cut)
res["rows"] = {n: [p["tp"].rows.start, p["tp"].rows.stop] for n, p in cut.items()}

# the tiny UNet's params: gathered back bit for bit, the cache key of the whole
params = shard_params_tp(mesh, d["params"])
back = gather_params_tp(mesh, params)
res["gathered_equal"] = all(torch.equal(back[n][k], v) for n, p in d["params"].items()
                            for k, v in p.items() if v is not None)
res["fingerprint"] = [_params_fingerprint(params), _params_fingerprint(d["params"])]

# the walks on JAX's index stream
TR.batch_indices = lambda key, iters, bs, n: d["indices"][(tuple(key), n)]
unit_real, tib_real = TR.reconstruct_unit, TR.reconstruct_tib
record = []

def unit(key, u, *args, **kw):
    alphas, losses = unit_real(key, u, *args, **kw)
    record.append((u.name, losses.clone()))
    return alphas, losses

def tib(*args, **kw):
    alphas, losses = tib_real(*args, **kw)
    record.append(("time_embedding", losses.clone()))
    return alphas, losses

TR.reconstruct_unit, TR.reconstruct_tib = unit, tib
res["walks"] = {}
for label, (n, kw) in d["runs"].items():
    record = []
    wqp = init_weight_qparams(params, d["spec"], 4)
    alphas = TR.calibrate_weights(params, d["spec"], QConfig(w_bits=4, use_wq=True), wqp,
                                  d["cali"][n], iters=20, batch_size=2, capture_batch=4, seed=0,
                                  mesh=mesh, **kw)
    res["walks"][label] = {"alphas": gather_params_tp(mesh, alphas, like=params),
                           "wqp": gather_params_tp(mesh, wqp, like=params), "units": record}
TR.reconstruct_unit, TR.reconstruct_tib = unit_real, tib_real

# the CLI
r = quantize_weight.main(d["cli"] + ["--tp", "2", "--outdir", f"{out}/cli",
                                     "--cali_data_path", f"{out}/cali"])
res["cli"] = [r["weight_only"], r["merged"]]
torch.save(res, f"{out}/rank{rank}.pt")
print("RANK", rank, "OK", flush=True)
"""

GROUPS = r"""
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from dgq_tpu_torch.parallel import mesh as M

rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert M.init_multihost(init, world, rank, device="cpu")
mesh = M.make_mesh(dp=2, tp=2, device="cpu")
s, u, b = (torch.tensor([float(rank + 1)]) for _ in range(3))
M.all_reduce_sum_(mesh, [s])
M.all_reduce_tp_(mesh, [u])
M.broadcast_(mesh, [b])
print("RESULT " + json.dumps({
    "dp": dist.get_process_group_ranks(mesh.group), "tp": dist.get_process_group_ranks(
        mesh.tp_group), "idx": [mesh.dp_rank, mesh.tp_rank], "dp_sum": s.item(),
    "tp_sum": u.item(), "bcast": b.item(), "rows": str(M.batch_rows(mesh, 8))}), flush=True)

# the CLI at dp 2 x tp 2: a walk with partial saves, the same command resumed
# from them, and --resume_w on the first file
from dgq_tpu_torch.cli import quantize_weight
root, qw = sys.argv[4], json.loads(sys.argv[5]) + ["--dp", "2", "--tp", "2"]
parts = ["--partial_dir", f"{root}/parts"]
first = quantize_weight.main(qw + parts + ["--outdir", f"{root}/q4"])["weight_only"]
again = quantize_weight.main(qw + parts + ["--outdir", f"{root}/q4b"])["weight_only"]
path = [first]
dist.broadcast_object_list(path, src=0)
resumed = quantize_weight.main(qw + ["--resume_w", path[0], "--outdir", f"{root}/q4c"])
print("CLI " + json.dumps([first, again, resumed["weight_only"]]), flush=True)
"""


def _hand_mesh(tp, t):
    return TM.Mesh(1, tp, t, tp, None, "cpu", None)


def _extra_layers():
    """(port, JAX) layers of 5 and 6 out channels, the same numbers."""
    rng = np.random.RandomState(3)
    w5, w6 = rng.randn(5, 3).astype(np.float32), rng.randn(6, 2, 3, 3).astype(np.float32)
    port = {"odd": {"w": torch.from_numpy(w5), "b": torch.zeros(5)},
            "six": {"w": torch.from_numpy(w6), "b": torch.zeros(6)}}
    jx = {"odd": {"w": jnp.asarray(w5.T), "b": jnp.zeros(5)},
          "six": {"w": jnp.asarray(w6.transpose(2, 3, 1, 0)), "b": jnp.zeros(6)}}
    return port, jx


@pytest.fixture(scope="module")
def tiny():
    return tiny_sd()


@pytest.mark.parametrize("tp", [2, 3])
def test_shard_params_tp_follows_the_jax_rule(tiny, tp):
    spec, jp, tparams, _ = tiny
    port_x, jax_x = _extra_layers()
    tparams, jp = {**tparams, **port_x}, {**jp, **jax_x}
    jmesh = JM.make_mesh(dp=1, tp=tp)
    jcut = JM.shard_params_tp(jmesh, jp)
    cut_names = set()
    for t in range(tp):
        cut = TM.shard_params_tp(_hand_mesh(tp, t), tparams)
        dev = jmesh.devices[0, t]
        for name, p in tparams.items():
            for key, v in p.items():
                if v is None:
                    continue
                jleaf = jcut[name][key]
                jax_cuts = "tp" in tuple(jleaf.sharding.spec)
                mine = cut[name][key]
                if key == "w":
                    assert jax_cuts == ("tp" in cut[name]), (name, tp)
                    shard = next(s for s in jleaf.addressable_shards if s.device == dev)
                    np.testing.assert_array_equal(tnp(reference_layout("w", mine)),
                                                  np.asarray(shard.data), err_msg=name)
                if "tp" in cut[name]:
                    cut_names.add(name)
                    mark = cut[name]["tp"]
                    assert (mark.tp, mark.index, mark.out) == (tp, t, v.shape[0])
                    assert torch.equal(mine, v[mark.rows])
                else:
                    assert torch.equal(mine, v), (name, key)
    assert "six" in cut_names and "odd" not in cut_names
    if tp == 2:  # every SD layer's out count is even
        assert cut_names == {n for n, p in tparams.items() if "w" in p} - {"odd"}


def test_shard_params_tp_like_cuts_scales_and_offsets(tiny):
    spec, _, tparams, _ = tiny
    wqp = t_init_wqp(tparams, spec, 4)
    mesh = _hand_mesh(2, 1)
    cut = TM.shard_params_tp(mesh, tparams)
    wqp_cut = TM.shard_params_tp(mesh, wqp, like=cut)
    mine = t_init_wqp(cut, spec, 4)  # per out channel: the rows of the whole's
    for name, qp in wqp.items():
        rows = cut[name]["tp"].rows
        for a, b, c in zip(qp, wqp_cut[name], mine[name]):
            assert torch.equal(a[rows], b) and torch.equal(b, c), name
    assert TM.shard_params_tp(None, wqp) is wqp
    assert TM.gather_params_tp(_hand_mesh(1, 0), tparams) is tparams


@pytest.mark.parametrize("route", ["codes_linear", "codes_conv2d", "int8_dispatch",
                                   "int8_conv", "group_conv", "attach_int8_packed"])
def test_a_cut_layer_refuses_the_routes_without_a_tp_form(route):
    mark_of = TM.shard_params_tp(_hand_mesh(2, 0), {
        "lin": {"w": torch.randn(4, 6), "b": torch.zeros(4)},
        "conv": {"w": torch.randn(4, 3, 3, 3), "b": torch.zeros(4)}})
    qp = QParams(torch.tensor(0.1), torch.tensor(128.0))
    cfg = TQC(w_bits=4, a_bits=8, use_aq=True)
    calls = {
        "codes_linear": lambda: TL._codes_linear(mark_of["lin"], torch.randn(2, 6), qp, cfg),
        "codes_conv2d": lambda: TL._codes_conv2d(mark_of["conv"], torch.randn(1, 5, 5, 3), qp,
                                                 cfg, 1, 1),
        "int8_dispatch": lambda: TL._int8_dispatch(mark_of["lin"], torch.randn(2, 6), qp, cfg),
        "int8_conv": lambda: TL._int8_conv(mark_of["conv"], torch.randn(1, 5, 5, 3), qp, cfg,
                                           1, 1),
        "group_conv": lambda: TL._group_quant_conv2d(mark_of["conv"], torch.randn(1, 5, 5, 3),
                                                     "conv", None, cfg, 1, 1),
        "attach_int8_packed": lambda: attach_int8_packed(
            mark_of, {"lin": QParams(torch.ones(2, 1), torch.zeros(2, 1))},
            [("lin", "linear", (6, 4, True))], cfg.replace(use_int8_matmul=True)),
    }
    with pytest.raises(NotImplementedError, match="channel-parallel layer"):
        calls[route]()


def _jax_forwards(jp, cali):
    """The tiny UNet's jitted forward on one sample: (whole params, params
    sharded over a (1, 2) mesh)."""
    fn = jax.jit(JU.unet_sd_apply)
    batch = to_j(tuple(x[:1] for x in cali[:3]))
    cut = JM.shard_params_tp(JM.make_mesh(dp=1, tp=2), jp)
    return np.asarray(fn(jp, *batch)), np.asarray(fn(cut, *batch))


def test_jax_forward_at_tp2_equals_its_tp1(ranks):
    whole, cut = ranks[5]
    np.testing.assert_allclose(cut, whole, rtol=0, atol=1e-5 * np.abs(whole).max())


def _jax_layout(a):
    a = tnp(a)
    return jnp.asarray(a.reshape((1,) * (a.ndim - 1) + (-1,)) if a.ndim > 1 else a)


def _jax_walks(jp, spec, jwqp, cali, out):
    unit_real, tib_real = JR.reconstruct_unit, JR.reconstruct_tib
    for label, (n, kw) in RUNS.items():
        record = []

        def unit(key, u, *args, **k):
            alphas, losses = unit_real(key, u, *args, **k)
            record.append((u.name, np.asarray(losses)))
            return alphas, losses

        def tib(*args, **k):
            alphas, losses = tib_real(*args, **k)
            record.append(("time_embedding", np.asarray(losses)))
            return alphas, losses
        mp = pytest.MonkeyPatch()
        mp.setattr(JR, "reconstruct_unit", unit)
        mp.setattr(JR, "reconstruct_tib", tib)
        try:
            out[label] = (JR.calibrate_weights(jp, spec, JQC(**W4), jwqp, to_j(cali[:n]),
                                               iters=ITERS, batch_size=BATCH, capture_batch=4,
                                               seed=0, **kw), record)
        finally:
            mp.undo()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tiny):
    """Both ranks' results and, computed here while they and the four-rank
    launch run, the JAX walks, the port's own temporal block, the --tp 1 CLI
    runs, the whole weight scales and the JAX forwards: (ranks, jax {label:
    (offsets, [(unit, losses)])}, tib losses, cli result, scales, (whole,
    cut) forwards, the four ranks' outputs, WALK's offsets at --tp 1)."""
    root = tmp_path_factory.mktemp("tp")
    spec, jp, tparams, cali = tiny
    twqp = t_init_wqp(tparams, spec, 4)
    jwqp = {n: JQP(_jax_layout(q.delta), _jax_layout(q.zero_point)) for n, q in twqp.items()}
    indices = {}
    for n, kw in RUNS.values():
        for u in range(kw["max_units"]):
            indices[((0, u), n)] = jax_batch_indices((0, u), ITERS, BATCH, n)
        indices[((0, TR.TIB_STREAM), n)] = jax_batch_indices((0, TR.TIB_STREAM), ITERS, BATCH, n)
    torch.save({"params": tparams, "spec": spec, "indices": indices, "runs": RUNS,
                "cali": {n: to_t(tuple(x[:n] for x in cali)) for n, _ in RUNS.values()},
                "cli": CLI}, root / "data.pt")
    launched, fwd = {}, {}
    walk = WALK + ["--cali_data_path", str(root / "cali4")]
    threads = [threading.Thread(target=lambda: launched.update(outs=launch_ranks(
                   WORKER, root / "store", root / "data.pt", root, timeout=300))),
               threading.Thread(target=lambda: launched.update(four=launch_ranks(
                   GROUPS, root / "store4", root, json.dumps(walk), world=4, timeout=300))),
               threading.Thread(target=lambda: fwd.update(out=_jax_forwards(jp, cali)))]
    for thread in threads:
        thread.start()
    try:
        jax_out = {}
        _jax_walks(jp, spec, jwqp, tuple(cali), jax_out)
        mp = pytest.MonkeyPatch()
        mp.setattr(TR, "batch_indices", jax_batch_indices)
        try:
            tib = TR.reconstruct_tib((0, TR.TIB_STREAM), tparams, spec, twqp, to_t(cali)[1],
                                     TQC(**W4), iters=ITERS, batch_size=BATCH)[1]
        finally:
            mp.undo()
        cli1 = TQW.main(CLI + ["--outdir", str(root / "cli1"), "--cali_data_path",
                               str(root / "cali1")])
        walk1 = TQW.main(WALK + ["--outdir", str(root / "walk1"), "--cali_data_path",
                                 str(root / "cali1")])["alphas"]
    finally:
        for thread in threads:
            thread.join()
    assert {"outs", "four"} <= set(launched) and "out" in fwd, "a launch or the JAX forwards failed"
    results = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return results, jax_out, tib, cli1, twqp, fwd["out"], launched["four"], walk1


def test_two_ranks_form_one_tp_group(ranks):
    assert [r["mesh"] for r in ranks[0]] == [[1, 2, 0, 0], [1, 2, 1, 1]]


def _close(a, b, rel=1e-6):
    a, b = tnp(a), tnp(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= rel * float(np.abs(b).max())


@pytest.mark.parametrize("what", ["y", "yc", "gx", "gxc"])
def test_cut_layers_forward_and_backward_equal_the_whole(ranks, what):
    for r in ranks[0]:
        _close(r["cut"][what], r["whole"][what])


def test_each_rank_gets_its_rows_of_the_weight_gradients(ranks):
    for r in ranks[0]:
        for name, (lo, hi) in r["rows"].items():
            _close(r["cut"]["gw"][name], r["whole"]["gw"][name][lo:hi])
            _close(r["cut"]["gb"][name], r["whole"]["gb"][name][lo:hi])
    assert [r["rows"]["conv"] for r in ranks[0]] == [[0, 3], [3, 6]]


def test_gathered_params_and_their_fingerprint_are_the_wholes(ranks):
    for r in ranks[0]:
        assert r["gathered_equal"]
        assert r["fingerprint"][0] == r["fingerprint"][1]


@pytest.mark.parametrize("label", list(RUNS))
def test_tp2_walk_follows_jax(ranks, label):
    results, jax_out, tib, _, twqp, *_ = ranks
    j_alphas, j_units = jax_out[label]
    for r in results:
        walk = r["walks"][label]
        assert [u for u, _ in walk["units"]] == [u for u, _ in j_units]
        for (name, t_losses), (_, j_losses) in zip(walk["units"], j_units):
            if name == "time_embedding":
                j_losses = tnp(tib)  # the port's own run of the block
            np.testing.assert_allclose(tnp(t_losses), j_losses, rtol=5e-5, err_msg=name)
        worst, share = compare_alphas(walk["alphas"], j_alphas, LR, ITERS)
        assert share > 0.9, (worst, share)
        for name, qp in twqp.items():
            assert all(torch.equal(a, b) for a, b in zip(qp, walk["wqp"][name])), name
    a0, a1 = (r["walks"][label]["alphas"] for r in results)
    assert all(torch.equal(a0[n], a1[n]) for n in a0)


def test_quantize_weight_tp2_writes_tp1s_file(ranks, tmp_path):
    results, _, _, cli1, *_ = ranks
    (w2, m2), (none_w, none_m) = results[0]["cli"], results[1]["cli"]
    assert none_w is None and none_m is None  # rank 1 writes nothing
    for mine, theirs in ((w2, cli1["weight_only"]), (m2, cli1["merged"])):
        a = torch.load(mine, weights_only=False)
        b = torch.load(theirs, weights_only=False)
        assert set(a["weight"]) == set(b["weight"])
        for k, v in b["weight"].items():
            assert torch.equal(a["weight"][k], v), k
        for slot in (k for k in b if k != "weight"):
            for k, v in b[slot].items():
                _close(a[slot][k], v, rel=1e-5)


def _lines(outs, tag):
    return [json.loads(next(ln for ln in o.splitlines() if ln.startswith(tag))[len(tag):])
            for o in outs]


def test_four_ranks_make_the_dp_and_tp_groups(ranks):
    res = _lines(ranks[6], "RESULT ")
    for rank, r in enumerate(res):
        d, t = divmod(rank, 2)
        assert r["idx"] == [d, t]
        assert r["dp"] == [t, t + 2] and r["tp"] == [2 * d, 2 * d + 1]
        assert r["dp_sum"] == (t + 1) + (t + 3) and r["tp_sum"] == (2 * d + 1) + (2 * d + 2)
        assert r["bcast"] == t + 1  # dp rank 0 of the group: global rank t
        assert r["rows"] == str(slice(4 * d, 4 * d + 4))


def test_quantize_weight_dp2_tp2_follows_tp1_and_resumes(ranks):
    """dp 2 x tp 2 on four ranks: the offsets within 2 lr K of --tp 1's and
    more than 0.9 of them within 1e-4; the same command on its partial saves
    resumes every unit and writes the same file bit for bit, and so does
    --resume_w on it."""
    from dgq_tpu_torch.io import dgq_ckpt as TK
    from dgq_tpu_torch.models.unet_sd import sd_unet_spec
    from recon_parity import alpha_bound

    outs, walk1 = ranks[6], ranks[7]
    (first, again, resumed), *others = _lines(outs, "CLI ")
    assert all(o == [None, None, None] for o in others)  # rank 0 alone writes
    assert sum(o.count("resumed from partial save") for o in outs) == 4 * 3
    spec = sd_unet_spec(base=32)
    _, _, alphas = TK.load_weight_only(first, spec, "cpu")
    assert set(alphas) == set(walk1)
    close = total = 0
    for n, a in walk1.items():
        d = (alphas[n] - a).abs()
        assert float(d.max()) <= alpha_bound(1e-3, 4), n
        close += int((d <= 1e-4).sum())
        total += d.numel()
    assert close / total > 0.9
    a = torch.load(first, weights_only=False)["weight"]
    for other in (again, resumed):
        b = torch.load(other, weights_only=False)["weight"]
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), other
