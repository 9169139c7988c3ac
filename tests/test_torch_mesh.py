"""The port's process group and data-parallel helpers
(`dgq_tpu_torch/parallel/mesh.py`) against the JAX package's
`dgq_tpu/parallel/mesh.py`:

  * `init_multihost` returns False with no rendezvous in the environment,
    and refuses SLURM's rank variables without MASTER_ADDR;
  * the backend rule: gloo on the CPU and when ranks share a card, NCCL when
    each rank of the node has a card of its own; the ranks a node runs from
    torchrun's LOCAL_WORLD_SIZE or SLURM's SLURM_TASKS_PER_NODE;
  * two gloo ranks on the CPU (a file rendezvous under tmp_path): each rank's
    first line names its backend and device; `sync_mean` gives the values of
    tests/test_multihost.py (1.5 and 5.0, a Python scalar too);
    `shard_batch` gives each rank the rows JAX's NamedSharding(P("dp"))
    puts on its device; `all_reduce_sum_` and `broadcast_` in place;
    `batch_reduce_` folds a min or max over both ranks inside `batch_split`
    and leaves it alone outside;
  * `make_mesh` raises, naming torchrun, when the world is not dp * tp, tp
    > 1 included (the dp x tp groups are held in tests/test_torch_tp.py);
  * `leave_multihost` (two gloo ranks at tp 2, a mesh and a cut layer still
    held): the groups are destroyed and every gloo thread of the rank is
    joined before it returns, so no rank reaches the interpreter's exit with
    them running (it could abort there, exit -6, after its last line).
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from recon_parity import launch_ranks  # noqa: E402

from dgq_tpu.parallel import mesh as JM  # noqa: E402
from dgq_tpu_torch.parallel import mesh as TM  # noqa: E402

RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
              "SLURM_NTASKS_PER_NODE", "SLURM_TASKS_PER_NODE", "SLURM_JOB_ID",
              "OMPI_COMM_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS")

WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from dgq_tpu_torch.parallel import mesh as M

rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert M.init_multihost(init, world, rank, device="cpu")
print(M.describe_rank("cpu"), flush=True)
mesh = M.make_mesh(dp=2, device="cpu")
local = {"delta": torch.full((3,), float(rank + 1)), "zp": 10.0 * rank,
         "n": torch.tensor(rank, dtype=torch.int32)}
synced = M.sync_mean(mesh, local)
batch = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
mine = M.shard_batch(mesh, {"x": batch, "pair": (batch[:, 0], batch[:, 1:])})
t = torch.full((2, 2), float(rank + 1))
u = torch.full((3,), float(rank + 5))
M.all_reduce_sum_(mesh, [t, u])
b = torch.full((4,), float(rank + 1))
M.broadcast_(mesh, [b])
M.barrier(mesh)
lo, hi, alone = (torch.tensor([float(rank + 1)]) for _ in range(3))
with M.batch_split(mesh):
    M.batch_reduce_(lo, "min")
    M.batch_reduce_(hi, "max")
M.batch_reduce_(alone, "max")
try:
    M.make_mesh(dp=4, device="cpu")
    wrong = None
except RuntimeError as e:
    wrong = str(e)
print("RESULT " + json.dumps({
    "mesh": [mesh.dp, mesh.tp, mesh.rank, mesh.world, mesh.device],
    "delta": synced["delta"].tolist(), "zp": synced["zp"], "zp_type": type(synced["zp"]).__name__,
    "n": float(synced["n"]), "rows": mine["x"].tolist(), "pair0": mine["pair"][0].tolist(),
    "t": t.tolist(), "u": u.tolist(), "b": b.tolist(), "wrong": wrong,
    "split": [lo.item(), hi.item(), alone.item()]}), flush=True)
"""


LEAVE = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from dgq_tpu_torch.parallel import mesh as M

rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]


def gloo_threads():
    tasks = os.listdir("/proc/self/task")
    names = (open(f"/proc/self/task/{t}/comm").read().strip() for t in tasks)
    return sorted(n for n in names if "gloo" in n)


assert M.init_multihost(init, world, rank, device="cpu")
mesh = M.make_mesh(dp=1, tp=2, device="cpu")  # the world, and a tp group of its own
params = M.shard_params_tp(mesh, {"l": {"w": torch.ones(4, 3), "b": torch.zeros(4)}})
M.all_reduce_tp_(mesh, [torch.ones(2)])
M.all_reduce_sum_(mesh, [torch.ones(2)])
up = gloo_threads()
M.leave_multihost()
print("LEFT " + json.dumps({"up": up, "left": gloo_threads(), "initialized":
                            torch.distributed.is_initialized(), "groups": [
                                mesh.group is None, mesh.tp_group is None,
                                params["l"]["tp"].group is None]}), flush=True)
"""


@pytest.fixture
def no_rendezvous(monkeypatch):
    for name in RENDEZVOUS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outs = launch_ranks(WORKER, tmp_path_factory.mktemp("mesh") / "store", timeout=120)
    results = []
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        results.append((out, json.loads(line[len("RESULT "):])))
    return results


def test_init_multihost_without_a_rendezvous_is_false(no_rendezvous):
    assert TM.init_multihost(device="cpu") is False
    assert JM.init_multihost() is False  # the JAX package's answer
    assert not torch.distributed.is_initialized()


def test_init_multihost_refuses_slurm_ranks_without_an_address(no_rendezvous):
    no_rendezvous.setenv("SLURM_PROCID", "0")
    no_rendezvous.setenv("SLURM_NTASKS", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        TM.init_multihost(device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,cards,local_world,want", [
    ("cpu", 8, 2, "gloo"), ("cuda", 0, 1, "gloo"), ("cuda", 1, 2, "gloo"),
    ("cuda", 2, 2, "nccl"), ("cuda", 8, 4, "nccl"), ("cuda", 4, 8, "gloo")])
def test_backend_rule(device, cards, local_world, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert TM.pick_backend(device, local_world) == want


@pytest.mark.parametrize("env,want", [
    ({}, 8), ({"LOCAL_WORLD_SIZE": "2"}, 2), ({"SLURM_TASKS_PER_NODE": "4(x2)"}, 4),
    ({"SLURM_TASKS_PER_NODE": "2(x3),1"}, 2), ({"SLURM_TASKS_PER_NODE": "1,3"}, 3),
    ({"LOCAL_WORLD_SIZE": "1", "SLURM_TASKS_PER_NODE": "4(x2)"}, 1)])
def test_node_tasks(env, want, no_rendezvous):
    for name, value in env.items():
        no_rendezvous.setenv(name, value)
    assert TM.node_tasks(8) == want


def test_slurm_two_nodes_of_four_take_nccl(no_rendezvous):
    """A 2-node x 4-task SLURM job without --ntasks-per-node: SLURM sets
    SLURM_TASKS_PER_NODE alone, and four cards a node take NCCL."""
    for name, value in (("SLURM_PROCID", "5"), ("SLURM_NTASKS", "8"), ("SLURM_LOCALID", "1"),
                        ("SLURM_TASKS_PER_NODE", "4(x2)")):
        no_rendezvous.setenv(name, value)
    no_rendezvous.setattr(torch.cuda, "device_count", lambda: 4)
    assert TM.pick_backend("cuda", TM.node_tasks(8)) == "nccl"
    assert TM.rank_device("cuda") == "cuda:1"
    no_rendezvous.setattr(torch.cuda, "device_count", lambda: 2)
    assert TM.pick_backend("cuda", TM.node_tasks(8)) == "gloo"


@pytest.mark.parametrize("local,cards,want", [("0", 1, "cuda:0"), ("1", 1, "cuda:0"),
                                               ("3", 4, "cuda:3"), ("5", 4, "cuda:1")])
def test_rank_device(local, cards, want, no_rendezvous):
    no_rendezvous.setenv("LOCAL_RANK", local)
    no_rendezvous.setattr(torch.cuda, "device_count", lambda: cards)
    assert TM.rank_device("cuda") == want
    assert TM.rank_device("cpu") == "cpu"


def test_two_ranks_name_their_backend_and_device(ranks):
    for r, (out, res) in enumerate(ranks):
        assert f"rank {r} of 2: backend gloo, device cpu" in out
        assert res["mesh"] == [2, 1, r, 2, "cpu"]


def test_sync_mean_is_the_jax_packages(ranks):
    """tests/test_multihost.py's values: rank-local deltas 1 and 2 -> 1.5,
    scalars 0 and 10 -> 5.0 (a float, as a Python scalar went in)."""
    for _, res in ranks:
        np.testing.assert_array_equal(res["delta"], [1.5, 1.5, 1.5])
        assert res["zp"] == 5.0 and res["zp_type"] == "float"
        assert res["n"] == 0.5


def test_shard_batch_follows_the_dp_named_sharding(ranks):
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    devs = np.asarray(jax.devices()[:2]).reshape(2, 1)
    sharded = jax.device_put(batch, NamedSharding(Mesh(devs, ("dp", "tp")), P("dp")))
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for r, (_, res) in enumerate(ranks):
        np.testing.assert_array_equal(res["rows"], by_device[devs[r, 0]])
        np.testing.assert_array_equal(res["pair0"], by_device[devs[r, 0]][:, 0])


def test_all_reduce_sum_and_broadcast_in_place(ranks):
    for _, res in ranks:
        assert res["t"] == [[3.0, 3.0], [3.0, 3.0]] and res["u"] == [11.0] * 3
        assert res["b"] == [1.0] * 4  # rank 0's


def test_batch_reduce_over_both_ranks_inside_batch_split(ranks):
    for _, res in ranks:
        assert res["split"][:2] == [1.0, 2.0]
    assert [res["split"][2] for _, res in ranks] == [1.0, 2.0]


def test_batch_reduce_without_a_split_is_the_identity():
    t = torch.tensor([3.0])
    with TM.batch_split(None), TM.batch_split(TM.Mesh(1, 1, 0, 1, None, "cpu")):
        assert TM.batch_reduce_(t, "min") is t and t.item() == 3.0


def test_make_mesh_refuses_a_wrong_world_and_tp(ranks, no_rendezvous):
    for _, res in ranks:
        assert "torchrun --nproc_per_node 4" in res["wrong"]
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m x.y"):
        TM.make_mesh(dp=2, device="cpu", program="x.y")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        TM.make_mesh(dp=1, tp=2, device="cpu")
    mesh = TM.make_mesh(dp=1, device="cpu")  # a world of one needs no group
    assert (mesh.dp, mesh.rank, mesh.world, mesh.group) == (1, 0, 1, None)
    assert not torch.distributed.is_initialized()


def test_leave_multihost_joins_the_gloo_threads_of_every_group(tmp_path):
    """The rank still holds its mesh and a cut layer's mark when it leaves;
    the groups are held weakly, so destroying them stops their threads."""
    outs = launch_ranks(LEAVE, tmp_path / "store", timeout=120)
    for out in outs:
        res = json.loads(next(ln for ln in out.splitlines() if ln.startswith("LEFT "))[5:])
        assert res["up"] and all("gloo" in n for n in res["up"])
        assert res["left"] == [] and not res["initialized"]
        assert res["groups"] == [True, True, True]


def test_batch_rows_without_a_mesh_and_uneven():
    assert TM.batch_rows(None, 5) == slice(0, 5)
    mesh = TM.Mesh(2, 1, 1, 2, None, "cpu")
    assert TM.batch_rows(mesh, 6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not shard"):
        TM.batch_rows(mesh, 5)


def test_shard_prompts_is_the_jax_packages():
    prompts = list(range(7))
    for world in (1, 2, 3):
        for rank in range(world):
            assert TM.shard_prompts(prompts, rank, world) == JM.shard_prompts(prompts, rank,
                                                                               world)
