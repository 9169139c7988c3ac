"""The port's data-parallel reconstruction walk (`calibrate_weights(mesh=)`,
two gloo ranks on the CPU, one thread each, a file rendezvous under
tmp_path) against the JAX package's walk, whose dp runs equal its dp = 1
runs, on the tiny SD net of tests/test_torch_recon_walk.py (base 32, cross
64, 16x16 latents, W4 minmax scales, 20 Adam steps at batch 2 a unit,
captures in chunks of 4), both ranks handed the JAX package's index stream
(`recon_parity.jax_batch_indices`, computed here and passed to the ranks):

  * 'mse': 4 samples, 4 units (two lone layers, two resnets; the card's
    `dp_path` walks a transformer too), each unit on the fp inputs as in
    tests/test_torch_recon_loops.py; a rank holds 2 of the 4 samples, and
    some step draws no index of rank 1's;
  * 'tib fisher_diag': the temporal block on every rank (its offsets then
    broadcast from rank 0), then the walk with Fisher weights, whose
    batchmean divides by the whole capture chunk on each rank;
  * 'replicated': 3 samples, which do not shard over 2 ranks, so each rank
    holds all 3 and runs the whole loop, as the JAX package replicates;

with the loops' limits: every step's loss of every unit within 5e-5
relative of JAX's, more than 0.9 of the offsets within 1e-4 and all within
2 lr K (`recon_parity.compare_alphas`); both ranks' offsets equal bit for
bit. The temporal block runs whole on every rank, so its losses are held to
the port's own run of it (5e-5): against JAX they part by up to 1.3e-4 on
these timesteps, the two libms' sinusoids near 1000 rad
(tests/test_torch_recon_loops.py holds them to 1e-4 on its own timesteps).
"""
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
from dgq_tpu.models.qconfig import QConfig as JQC  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu_torch.calib import reconstruction as TR  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams as t_init_wqp  # noqa: E402
from dgq_tpu_torch.models.qconfig import QConfig as TQC  # noqa: E402

W4 = dict(w_bits=4, use_wq=True)
ITERS, BATCH, LR = 20, 2, 1e-3
RUNS = {  # label -> (samples, calibrate_weights keywords)
    "mse": (4, dict(max_units=4, asym=False)),
    "tib fisher_diag": (4, dict(max_units=3, asym=False, tib_recon=True,
                                opt_mode="fisher_diag")),
    "replicated": (3, dict(max_units=2, asym=False)),
}

WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from dgq_tpu_torch.calib import reconstruction as TR
from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.parallel.mesh import init_multihost, make_mesh

rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
data, out = sys.argv[4], sys.argv[5]
assert init_multihost(init, world, rank, device="cpu")
mesh = make_mesh(dp=world, device="cpu")
d = torch.load(data, weights_only=False)
TR.batch_indices = lambda key, iters, bs, n: d["indices"][(tuple(key), n)]
unit_real, tib_real = TR.reconstruct_unit, TR.reconstruct_tib
record = []

def unit(key, u, params, wqp, inputs, outputs, cfg, **kw):
    alphas, losses = unit_real(key, u, params, wqp, inputs, outputs, cfg, **kw)
    record.append((u.name, losses.clone(), outputs.shape[0]))
    return alphas, losses

def tib(key, params, spec, *args, **kw):
    alphas, losses = tib_real(key, params, spec, *args, **kw)
    record.append(("time_embedding", losses.clone(), None))
    return alphas, losses

TR.reconstruct_unit, TR.reconstruct_tib = unit, tib
results = {}
for label, (n, kw) in d["runs"].items():
    record = []
    alphas = TR.calibrate_weights(d["params"], d["spec"], QConfig(w_bits=4, use_wq=True),
                                  d["wqp"], d["cali"][n], iters=20, batch_size=2,
                                  capture_batch=4, seed=0, mesh=mesh, **kw)
    results[label] = {"alphas": alphas, "units": record}
torch.save(results, f"{out}/rank{rank}.pt")
print("RANK", rank, "OK")
"""


def _jax_layout(a):
    a = tnp(a)
    return jnp.asarray(a.reshape((1,) * (a.ndim - 1) + (-1,)) if a.ndim > 1 else a)


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    """The JAX walks (their per-unit losses recorded) and both ranks' port
    walks: {label: (jax offsets, jax [(unit, losses)], [rank results])}."""
    root = tmp_path_factory.mktemp("dp_recon")
    spec, jp, tp, cali4 = tiny_sd()
    twqp = t_init_wqp(tp, spec, 4)
    jwqp = {n: JQP(_jax_layout(q.delta), _jax_layout(q.zero_point)) for n, q in twqp.items()}
    cali = {4: cali4, 3: tuple(x[:3] for x in cali4)}

    indices = {}
    for n, kw in RUNS.values():
        for u in range(kw["max_units"]):
            indices[((0, u), n)] = jax_batch_indices((0, u), ITERS, BATCH, n)
        indices[((0, TR.TIB_STREAM), n)] = jax_batch_indices((0, TR.TIB_STREAM), ITERS, BATCH, n)
    torch.save({"params": tp, "spec": spec, "wqp": twqp, "indices": indices, "runs": RUNS,
                "cali": {n: to_t(c) for n, c in cali.items()}}, root / "data.pt")
    launch_ranks(WORKER, root / "store", root / "data.pt", root)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]

    out = {}
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
            j = JR.calibrate_weights(jp, spec, JQC(**W4), jwqp, to_j(cali[n]), iters=ITERS,
                                     batch_size=BATCH, capture_batch=4, seed=0, **kw)
        finally:
            mp.undo()
        out[label] = (j, record, [r[label] for r in ranks])
    mp = pytest.MonkeyPatch()
    mp.setattr(TR, "batch_indices", jax_batch_indices)
    try:
        tib = TR.reconstruct_tib((0, TR.TIB_STREAM), tp, spec, twqp, to_t(cali4)[1],
                                 TQC(**W4), iters=ITERS, batch_size=BATCH)
    finally:
        mp.undo()
    return out, indices, tib


@pytest.mark.parametrize("label", list(RUNS))
def test_dp_walk_follows_jax(walks, label):
    j_alphas, j_units, ranks = walks[0][label]
    t_units = ranks[0]["units"]
    assert [u for u, _, _ in t_units] == [u for u, _ in j_units]
    for (name, t_losses, _), (_, j_losses) in zip(t_units, j_units):
        if name == "time_embedding":
            j_losses = tnp(walks[2][1])  # the port's own run of the block
        np.testing.assert_allclose(tnp(t_losses), j_losses, rtol=5e-5, err_msg=name)
    worst, share = compare_alphas(ranks[0]["alphas"], j_alphas, LR, ITERS)
    assert share > 0.9, (worst, share)


@pytest.mark.parametrize("label", list(RUNS))
def test_dp_ranks_end_with_the_same_offsets_and_losses(walks, label):
    _, _, (r0, r1) = walks[0][label]
    assert set(r0["alphas"]) == set(r1["alphas"])
    for name in r0["alphas"]:
        assert torch.equal(r0["alphas"][name], r1["alphas"][name]), name
    for (u0, l0, _), (u1, l1, _) in zip(r0["units"], r1["units"]):
        assert u0 == u1 and torch.equal(l0, l1), u0


@pytest.mark.parametrize("label,held", [("mse", 2), ("tib fisher_diag", 2), ("replicated", 3)])
def test_dp_rank_holds_its_slice_of_the_captures(walks, label, held):
    """A unit's cached tensors on each rank hold n / dp samples when n
    shards (every sample when it does not)."""
    for rank in walks[0][label][2]:
        assert [h for u, _, h in rank["units"] if u != "time_embedding"]
        assert all(h == held for u, _, h in rank["units"] if u != "time_embedding")


def test_dp_walk_meets_a_step_without_rank_1s_samples(walks):
    """The 'mse' walk's index stream has steps where rank 1 (samples 2, 3)
    holds none of the batch, and steps where rank 0 holds none; the walk
    above ran through them."""
    indices = walks[1]
    rows = torch.stack([indices[((0, u), 4)] for u in range(RUNS["mse"][1]["max_units"])])
    assert bool((rows < 2).all(-1).any()) and bool((rows >= 2).all(-1).any())
