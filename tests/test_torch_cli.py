"""The port's inference CLI (`cli/infer.py`, `cli/common.py`) and checkpoint
tools (`cli/ckpt_tools.py`) against the JAX package's.

  * parse_args and qconfig_from_args: the same argv gives the same values
    and the same QConfig fields in both packages.
  * `infer.main([..., "--device", "cpu"])` on a merged checkpoint written by
    `dgq_tpu.io.dgq_ckpt` (tiny UNet, 2 time-aware slots of g=8 group
    qstates): with the README's flags, and again with --pallas_attn
    --group_impl fused --fp16, on the plain versions; each writes finite
    arrays under the JAX CLI's file names and tags. Once more as a command
    (`python -m dgq_tpu_torch.cli.infer`), with a VAE snapshot, so the
    outputs are uint8 images.
  * --device cuda without a card, and --multihost, are refused.
"""
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.cli import common as JCC, infer as JI  # noqa: E402
from dgq_tpu.io import dgq_ckpt as JK  # noqa: E402
from dgq_tpu.models.unet_sd import sd_unet_spec  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu.utils.synthetic import synthetic_group_qstate as j_gsyn  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams  # noqa: E402
from dgq_tpu_torch.cli import ckpt_tools as TCT, common as TCC, infer as TI  # noqa: E402
from dgq_tpu_torch.io import dgq_ckpt as TK  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy, params_to_torch_unet  # noqa: E402
from dgq_tpu_torch.models import families as TF  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.pipeline import vae as TV  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = 32
README = ["--use_aq", "--use_group", "--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak",
          "--time_aware_aqtizer"]
TINY = ["--model", "sd", "--base", str(BASE), "--num_inference_steps", "2", "--height", "64",
        "--width", "64", "--prompt", "a smoke test", "--device", "cpu"]


@pytest.mark.parametrize("argv", [
    [],
    ["--model", "sdxl", "--wq", "8", "--aq", "6", "--softmax_a_bit", "6", "--t2i_log_quant",
     "--group_impl", "fused", "--pallas_attn", "--sdxl_depths", "1,2", "--fp16", "--seed", "3"],
    ["--cali_ckpt", "m.pth", "--use_group", "--t2i_real_time", "--t2i_start_peak",
     "--group_impl", "im2col", "--num_inference_steps", "10", "--base", "64", "--height", "256",
     "--width", "128", "--outdir", "o", "--vae_weights", "v", "--text_weights", "t",
     "--tokenizer", "k", "--text_weights_2", "t2", "--tokenizer_2", "k2", "--unet_weights", "u"]
    + README,
])
def test_parse_args_and_qconfig_match_jax(argv, monkeypatch):
    monkeypatch.delenv("DIFFUSERS_REWRITE", raising=False)
    monkeypatch.setattr(sys, "argv", ["infer"] + argv)
    j = vars(JI.parse_args())
    t = vars(TI.parse_args(argv))
    assert t.pop("device") == "cuda"
    assert t == j
    for use_aq in (False, True):
        jq = JCC.qconfig_from_args(JI.parse_args(), use_aq=use_aq)
        tq = TCC.qconfig_from_args(TI.parse_args(argv), use_aq=use_aq)
        for f in ("w_bits", "a_bits", "softmax_bits", "use_wq", "use_aq", "t2i_log_quant",
                  "t2i_real_time", "t2i_start_peak", "group_conv_impl", "use_pallas_attention",
                  "log_max_1", "disable_out_quant", "group_conv_layers", "use_int8_matmul",
                  "fold_act_dequant", "packed_attention"):
            assert getattr(tq, f) == getattr(jq, f), f


def test_model_type_from_env_and_helpers(monkeypatch, tmp_path):
    monkeypatch.setenv("DIFFUSERS_REWRITE", "sdxl")
    assert TCC.model_type_from_env() == JCC.model_type_from_env() == "sdxl"
    assert TI.parse_args([]).model == "sdxl"
    assert TCC.parse_depths("1,3") == JCC.parse_depths("1,3") == (1, 3)
    assert TF.pooled_dim_for() == JCC.pooled_dim_for("sdxl") == 1280
    assert TF.pooled_dim_for(32) == JCC.pooled_dim_for("sdxl", 32) == 128
    lines = tmp_path / "p.txt"
    lines.write_text("\n".join(f"prompt {i}" for i in range(9)) + "\n\n")
    assert TCC.load_prompts(str(lines), 4, seed=1) == JCC.load_prompts(str(lines), 4, seed=1)
    assert TCC.load_prompts(str(lines), 20) == JCC.load_prompts(str(lines), 20)
    coco = tmp_path / "c.json"
    coco.write_text('{"annotations": [' + ", ".join(
        f'{{"caption": "c{i}"}}' for i in range(12)) + "]}")
    assert TCC.load_prompts(str(coco), 5, seed=2) == JCC.load_prompts(str(coco), 5, seed=2)
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        outpath, log = TCC.setup_logging(str(tmp_path / "logs"))
    finally:
        for h in [h for h in root.handlers if h not in before]:
            root.removeHandler(h)
            h.close()
    assert os.path.isdir(outpath) and log.name == "dgq_tpu_torch"


@pytest.mark.parametrize("model", ["sd", "sdxl"])
def test_build_model(model):
    spec, params, apply_fn, hw, cross = TF.build_model(model, base=BASE, sdxl_depths=(1, 1),
                                                       device="cpu")
    jspec, _, _, jhw, jcross = JCC.build_model(model, base=BASE, sdxl_depths=(1, 1),
                                               init_params=False)
    assert spec == jspec and (hw, cross) == (jhw, jcross)
    assert set(params) == {n for n, _, _ in spec}
    assert TF.build_model(model, base=BASE, sdxl_depths=(1, 1), init_params=False,
                          device="cpu")[1] is None
    # the same seed draws the same weights
    again = TF.build_model(model, base=BASE, sdxl_depths=(1, 1), device="cpu")[1]
    assert torch.equal(again["conv_in"]["w"], params["conv_in"]["w"])


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """A merged g=8 checkpoint written by the JAX package: tiny SD weights
    (drawn by the port, handed over through the bridge), W4 minmax qparams
    and two time slots of group qstates."""
    d = tmp_path_factory.mktemp("ckpt")
    spec = sd_unet_spec(base=BASE)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    twqp = init_weight_qparams(tp, spec, 4)
    kinds = {n: k for n, k, _ in spec}
    jwqp = {n: JQP(*(jnp.asarray(v.numpy().reshape((1, 1, 1, -1) if kinds[n] == "conv"
                                                   else (1, -1))) for v in qp))
            for n, qp in twqp.items()}
    qs, _ = j_gsyn(spec, 1, False, jnp.float32)
    per_t = {"act_0": qs,
             "act_1": jax.tree.map(lambda x: x * 1.25, qs)}
    path = str(d / "sd_w4a8g8.pth")
    JK.save_merged(path, jax.tree.map(jnp.asarray, params_to_numpy(tp, spec)), jwqp, spec, per_t)
    return path


def _npys(outdir):
    return sorted(f for f in os.listdir(outdir) if f.endswith(".npy"))


@pytest.mark.parametrize("extra", [[], ["--pallas_attn", "--group_impl", "fused", "--fp16"]])
def test_infer_main_on_a_jax_written_checkpoint(merged, tmp_path, extra):
    res = TI.main(TINY + ["--cali_ckpt", merged, "--outdir", str(tmp_path)] + README + extra)
    names = [f"tmp_sd_a_smoke_test_{i}_{tag}.npy" for tag in ("fp", "w4a8g8") for i in (0, 1)]
    assert _npys(tmp_path) == sorted(names)
    assert sorted(os.path.basename(p) for p in res["outputs"]) == sorted(names)
    assert set(res["run_s"]) == {"fp", "w4a8g8"} and res["load_fold_s"] > 0
    for n in names:
        arr = np.load(tmp_path / n)
        assert arr.shape == (8, 8, 4) and arr.dtype == np.float32 and np.isfinite(arr).all()
    # the quantized latents differ from the fp ones
    assert not np.array_equal(np.load(tmp_path / names[0]), np.load(tmp_path / names[2]))


def test_infer_command_with_vae(merged, tmp_path):
    vae = tmp_path / "vae"
    vae.mkdir()
    tv = TV.init_vae_decoder(torch.Generator().manual_seed(5), "cpu", base=BASE)
    torch.save(params_to_torch_unet(tv, TV.vae_decoder_spec(base=BASE)),
               vae / "diffusion_pytorch_model.bin")
    r = subprocess.run([sys.executable, "-m", "dgq_tpu_torch.cli.infer", *TINY,
                        "--cali_ckpt", merged, "--outdir", str(tmp_path), "--vae_weights",
                        str(vae), *README], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    names = _npys(tmp_path)
    assert names == sorted(f"tmp_sd_a_smoke_test_{i}_{t}.npy" for t in ("fp", "w4a8g8")
                           for i in (0, 1))
    for n in names:
        img = np.load(tmp_path / n)
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
        assert os.path.exists(tmp_path / n.replace(".npy", ".png"))


def test_device_cuda_without_a_card_and_multihost_are_refused(merged, tmp_path, monkeypatch):
    """--multihost without a rendezvous in the environment raises, as the
    JAX package's does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda is legal here")
    for name in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    argv = [a if a != "cpu" else "cuda" for a in TINY] + ["--cali_ckpt", merged,
                                                         "--outdir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TI.main(argv)
    with pytest.raises(RuntimeError, match="--multihost set but no rendezvous found"):
        TI.main(TINY + ["--multihost", "--outdir", str(tmp_path)])
    assert _npys(tmp_path) == []


def test_ckpt_tools_merge_check_clean(tmp_path, merged):
    spec = sd_unet_spec(base=BASE)
    w = tmp_path / "w.pth_weight_only"
    a = tmp_path / "a.pth"
    full = torch.load(merged, weights_only=False)
    torch.save({"weight": {k: v.bfloat16() for k, v in full["weight"].items()}}, w)
    torch.save({k: v for k, v in full.items() if k != "weight"}, a)
    out = tmp_path / "m.pth"
    assert TCT.main(["merge", str(w), str(a), str(out)]) == 0
    m = torch.load(out, weights_only=False)
    assert set(m) == set(full)
    assert all(v.dtype == torch.bfloat16 for v in m["weight"].values())
    # the merged file loads in both packages to the same qstates
    _, _, _, tper, tgl = TK.load_merged(str(out), spec, device="cpu")
    _, _, _, jper, jgl = JK.load_merged(str(out), spec)
    assert tgl == jgl and set(tper) == set(jper) == {"act_0", "act_1"}

    # check: per-block partial saves against the aggregate
    parts = tmp_path / "parts"
    parts.mkdir()
    blk = "down_blocks.0.resnets.0.conv1"
    torch.save({"w": full["weight"][f"model.{blk}.w"]}, parts / f"{blk}.pth")
    assert TCT.main(["check", merged, str(parts)]) == 0
    torch.save({"w": full["weight"][f"model.{blk}.w"] + 1, "nope": torch.zeros(1)},
               parts / f"{blk}.pth")
    assert TCT.main(["check", merged, str(parts)]) == 1

    # clean: run directories without a checkpoint go
    runs = tmp_path / "runs"
    for d, f in (("keep", "cali_ckpt.pth_weight_only"), ("keep2", "x_merged"),
                 ("drop", "run.log")):
        (runs / d).mkdir(parents=True)
        (runs / d / f).write_text("")
    assert TCT.main(["clean", str(runs)]) == 0
    assert sorted(os.listdir(runs)) == ["keep", "keep2"]


def test_ckpt_tools_merge_command(tmp_path, merged):
    full = torch.load(merged, weights_only=False)
    w, a, out = tmp_path / "w.pth", tmp_path / "a.pth", tmp_path / "m.pth"
    torch.save({"weight": full["weight"]}, w)
    torch.save({k: v for k, v in full.items() if k != "weight"}, a)
    r = subprocess.run([sys.executable, "-m", "dgq_tpu_torch.cli.ckpt_tools", "merge", str(w),
                        str(a), str(out)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    m = torch.load(out, weights_only=False)
    for k, v in full["weight"].items():
        assert torch.equal(m["weight"][k], v), k
