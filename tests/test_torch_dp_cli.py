"""The port's CLIs with --dp 2 on the CPU: two gloo ranks (a file rendezvous
under tmp_path, one thread each) join the process group and call each CLI's
`main(argv)`, as torchrun's ranks do after the rendezvous:

  * `cli.gen4eval --dp 2 --fp`, 3 prompts at batch 2 (a full batch and a
    padded tail, as the JAX package's tests/test_cli_smoke.py:325 runs it)
    against `--dp 1` in this process: the same three files, each within 1e-4
    (the latents of a batch of 1 and of 2 sum in other orders);
  * `cli.gen4eval --dp 2` W8A8 on the weights of the run below with a
    synthetic per-tensor A8 state (`synthetic_pertensor_qstate`), with
    the real-time log2 softmax quantizer, whose delta is a reduction over
    the whole batch: through the fused attention's plain version
    (--pallas_attn --t2i_start_peak) and through the layers' own quantizer,
    one PNDM step; the same files as `--dp 1`, each within 1e-4 (a rank
    that took the delta of its own rows alone misses by about 5e-2);
  * `cli.quantize_weight --dp 2 --max_units 2` (base 32, --debug): rank 0
    writes the one checkpoint and run.log, which logs `mesh: dp=2 tp=1` (the
    string the JAX package's test asserts), rank 1 writes nothing, and the
    learned offsets are those of `--dp 1` in this process (every one within
    2 lr K, more than 0.9 of them within 1e-4);
  * `cli.infer --multihost` on that checkpoint: both ranks run both images,
    only rank 0 writes them.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from recon_parity import alpha_bound, launch_ranks  # noqa: E402

from dgq_tpu_torch.cli import gen4eval as TG, quantize_weight as TQW  # noqa: E402
from dgq_tpu_torch.io import dgq_ckpt as TK  # noqa: E402
from dgq_tpu_torch.models.unet_sd import sd_unet_spec  # noqa: E402

REAL_TIME = {"fused": ["--pallas_attn", "--t2i_start_peak"], "layers": []}
# one PNDM step: over more, a flipped log2 code (the CPU's sums of 2 and of 4
# rows differ in the last bit) grows into a different trajectory
GEN_RT = ["--device", "cpu", "--model", "sd", "--base", "32", "--wq", "8", "--aq", "8",
          "--use_aq", "--t2i_log_quant", "--t2i_real_time", "--batch", "2", "--steps", "1",
          "--height", "64", "--width", "64"]
WORKER = r"""
import glob, os, sys
import torch
torch.set_num_threads(1)
from dgq_tpu_torch.cli import gen4eval, infer, quantize_weight
from dgq_tpu_torch.io.dgq_ckpt import load_weight_only, save_merged
from dgq_tpu_torch.models.unet_sd import sd_unet_spec
from dgq_tpu_torch.parallel.mesh import init_multihost
from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate

rank, world, init, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
REAL_TIME, GEN_RT = @CONSTS@
assert init_multihost(init, world, rank, device="cpu")
os.makedirs(f"{root}/inf", exist_ok=True)
res = gen4eval.main(["--device", "cpu", "--model", "sd", "--base", "32", "--prompts",
                     f"{root}/prompts.tsv", "--fp", "--batch", "2", "--steps", "2", "--height",
                     "64", "--width", "64", "--dp", "2", "--outdir", f"{root}/dp2"])
print("GEN", rank, sorted(res["files"]), flush=True)
res = quantize_weight.main(sys.argv[5:] + ["--dp", "2", "--outdir", f"{root}/qw2"])
print("QW", rank, res["weight_only"], flush=True)
torch.distributed.barrier()
ckpt = glob.glob(f"{root}/qw2/*/cali_ckpt.pth_weight_only")[0]
merged = f"{root}/merged.pth"
if rank == 0:  # the weights with a synthetic per-tensor A8 state
    spec = sd_unet_spec(base=32)
    params, wqp, alphas = load_weight_only(ckpt, spec, "cpu")
    save_merged(merged, params, wqp, spec,
                {"act_0": synthetic_pertensor_qstate(spec, 1, False, torch.float32, "cpu")},
                alphas=alphas)
torch.distributed.barrier()
for mode, flags in REAL_TIME.items():
    res = gen4eval.main(GEN_RT + ["--prompts", f"{root}/prompts.tsv", "--cali_ckpt", merged,
                                  "--dp", "2", "--outdir", f"{root}/{mode}2"] + flags)
    print("RT", mode, rank, sorted(res["files"]), flush=True)
res = infer.main(["--device", "cpu", "--model", "sd", "--base", "32", "--multihost", "--cali_ckpt",
                  ckpt, "--num_inference_steps", "2", "--height", "64", "--width", "64",
                  "--outdir", f"{root}/inf", "--prompt", "x"])
print("INF", rank, len(res["outputs"]), sorted(res["run_s"]), flush=True)
""".replace("@CONSTS@", repr((REAL_TIME, GEN_RT)))
QW = ["--device", "cpu", "--model", "sd", "--base", "32", "--latent_hw", "16", "--wq", "8",
      "--debug", "--step_size", "2", "--max_units", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    (root / "prompts.tsv").write_text("Prompt\nfirst cat\nsecond dog\nthird bird\n")
    qw = QW + ["--cali_data_path", str(root / "cali")]
    outs = launch_ranks(WORKER, root / "store", root, *qw)
    return root, outs, qw


def test_gen4eval_dp2_equals_dp1(runs):
    root, outs, _ = runs
    for r, out in enumerate(outs):  # rank 0 rows 0 and 2, rank 1 row 1 (row 3 padding)
        want = ["0_0.npy", "2_0.npy"] if r == 0 else ["1_0.npy"]
        assert f"GEN {r} {[str(root / 'dp2' / f) for f in want]}" in out, out[-2000:]
    res = TG.main(["--device", "cpu", "--model", "sd", "--base", "32", "--prompts",
                   str(root / "prompts.tsv"), "--fp", "--batch", "2", "--steps", "2",
                   "--height", "64", "--width", "64", "--outdir", str(root / "dp1")])
    files = sorted(os.listdir(root / "dp2"))
    assert files == sorted(os.listdir(root / "dp1")) == ["0_0.npy", "1_0.npy", "2_0.npy"]
    assert res["images"] == 3
    for f in files:
        a, b = np.load(root / "dp2" / f), np.load(root / "dp1" / f)
        assert a.shape == (8, 8, 4) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f)


@pytest.mark.parametrize("mode", sorted(REAL_TIME))
def test_gen4eval_dp2_real_time_softmax_equals_dp1(runs, mode):
    """The delta of the real-time quantizer is reduced over both ranks'
    rows: each image is --dp 1's (the tail batch's padded row is a copy,
    which moves no max)."""
    root, outs, _ = runs
    for r, out in enumerate(outs):
        want = ["0_0.npy", "2_0.npy"] if r == 0 else ["1_0.npy"]
        assert f"RT {mode} {r} {[str(root / f'{mode}2' / f) for f in want]}" in out, out[-2000:]
    merged = root / "merged.pth"
    TG.main(GEN_RT + REAL_TIME[mode] + ["--prompts", str(root / "prompts.tsv"), "--cali_ckpt",
                                        str(merged), "--outdir", str(root / f"{mode}1")])
    files = sorted(os.listdir(root / f"{mode}2"))
    assert files == sorted(os.listdir(root / f"{mode}1")) == ["0_0.npy", "1_0.npy", "2_0.npy"]
    for f in files:
        a, b = np.load(root / f"{mode}2" / f), np.load(root / f"{mode}1" / f)
        assert a.shape == (8, 8, 4) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f)


def test_quantize_weight_dp2_writes_once_and_learns_dp1s_offsets(runs, tmp_path):
    root, outs, qw = runs
    run_dirs = os.listdir(root / "qw2")
    assert len(run_dirs) == 1
    ckpt = root / "qw2" / run_dirs[0] / "cali_ckpt.pth_weight_only"
    assert f"QW 0 {ckpt}" in outs[0] and "QW 1 None" in outs[1]
    log = (root / "qw2" / run_dirs[0] / "run.log").read_text()
    assert "mesh: dp=2 tp=1" in log and "rank 0 of 2: backend gloo, device cpu" in log
    assert "rank 1 - INFO" in outs[1] and "rank 1 of 2: backend gloo, device cpu" in outs[1]
    spec = sd_unet_spec(base=32)
    _, _, dp2 = TK.load_weight_only(str(ckpt), spec, "cpu")
    dp1 = TQW.main(qw + ["--outdir", str(tmp_path / "qw1")])["alphas"]
    assert dp2 and set(dp2) == set(dp1)
    close = total = 0
    for n, a in dp1.items():
        d = (dp2[n] - a).abs()
        assert float(d.max()) <= alpha_bound(1e-3, 10), n
        close += int((d <= 1e-4).sum())
        total += d.numel()
    assert close / total > 0.9
    assert torch.isfinite(torch.cat([a.reshape(-1) for a in dp2.values()])).all()


def test_infer_multihost_runs_on_every_rank_and_rank_0_writes(runs):
    root, outs, _ = runs
    assert "INF 0 4 ['fp', 'w4a32g1']" in outs[0] and "INF 1 0 ['fp', 'w4a32g1']" in outs[1]
    assert len(list((root / "inf").glob("*.npy"))) == 4
