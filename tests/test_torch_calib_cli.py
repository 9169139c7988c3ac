"""The port's calibration entry points (`cli/quantize_weight.py`,
`cli/quantize_act.py`) against the JAX package's:

  * parse_args: the same argv gives the same values in both packages (the
    port adds --device);
  * reconstruction with the fused attention kernels (--pallas_attn) raises
    NotImplementedError naming the ROADMAP entry, and --dp or --tp outside
    a process group of their size raise RuntimeError naming the torchrun
    line, before any work (reconstruction itself is held in
    tests/test_torch_recon_cli.py, --tp in tests/test_torch_tp.py);
  * the README's verify flow on the port, on the CPU at base 32:
    `quantize_weight --fast --no_recon --use_aq`, then `quantize_act
    --group_num 2` with the t2i flags and --pallas_attn on its weight-only
    checkpoint; every checkpoint loaded by `dgq_tpu.io.dgq_ckpt` equals,
    bit for bit, what the port computed and wrote; then `cli.ckpt_tools
    merge` and `cli.infer` on the result (finite latents under the JAX
    CLI's file names);
  * `cli.common.encode_cali_prompts` of each family (SD's CFG pair,
    SDXL-turbo's dual encoders) on tiny CLIP weights equals the JAX
    package's.

The calibrated states themselves are held against the JAX package's in
tests/test_torch_calib_act.py (the CLIs draw their stand-in prompt
embeddings and latents from torch generators, so the two packages' CLIs do
not see the same data).
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dgq_tpu.cli import common as JC, quantize_act as JQA, quantize_weight as JQW  # noqa: E402
from dgq_tpu.io import dgq_ckpt as JK  # noqa: E402
from dgq_tpu.models.unet_sd import sd_unet_spec  # noqa: E402
from dgq_tpu_torch.cli import ckpt_tools as TCT, common as TC, infer as TI  # noqa: E402
from dgq_tpu_torch.cli import quantize_act as TQA, quantize_weight as TQW  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy  # noqa: E402
from dgq_tpu_torch.models.families import build_model  # noqa: E402
from dgq_tpu_torch.pipeline.text_encoder import init_clip_text  # noqa: E402

BASE = 32
T2I = ["--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak", "--time_aware_aqtizer"]


@pytest.mark.parametrize("module,argv", [
    ("weight", []),
    ("weight", ["--model", "sdxl", "--wq", "8", "--cali", "--no_recon", "--use_aq", "--debug",
                "--sdxl_depths", "1,2", "--no_running_stat", "--seed", "3", "--base", "64"]),
    ("weight", ["--resume_w", "w.pth", "--dp", "2", "--tp", "2", "--partial_dir", "p",
                "--tib_recon", "--recon_loss", "fisher_diag", "--iters", "5", "--max_units", "3",
                "--step_size", "7", "--latent_hw", "16", "--cali_data_path", "c"] + T2I),
    ("act", ["--cali_ckpt", "w.pth"]),
    ("act", ["--cali_ckpt", "w.pth", "--model", "sdxl", "--group_num", "2", "--group_mode",
             "mean", "--pallas_attn", "--group_impl", "fused", "--cali_prompt_data_n", "3"]
     + T2I),
])
def test_parse_args_match_jax(module, argv, monkeypatch):
    monkeypatch.delenv("DIFFUSERS_REWRITE", raising=False)
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    j = vars((JQW if module == "weight" else JQA).parse_args())
    t = vars((TQW if module == "weight" else TQA).parse_args(argv))
    assert t.pop("device") == "cuda"
    assert t == j


TORCHRUN = "torchrun --nproc_per_node 2 -m dgq_tpu_torch.cli.quantize_weight"


@pytest.mark.parametrize("extra,exc,match,item", [
    (["--pallas_attn"], NotImplementedError, "--pallas_attn", "ROADMAP queue 3"),
    # --dp outside a process group of its size names the torchrun line
    (["--no_recon", "--dp", "2"], RuntimeError, TORCHRUN, "a process group of 2 ranks"),
    (["--no_recon", "--tp", "2"], RuntimeError, TORCHRUN, "a process group of 2 ranks"),
    (["--dp", "2", "--partial_dir", "p"], RuntimeError, TORCHRUN, "a process group of 2 ranks"),
    (["--tib_recon", "--pallas_attn", "--use_aq"], NotImplementedError, "--pallas_attn",
     "ROADMAP queue 3"),
    (["--recon_loss", "fisher_full", "--tp", "2"], RuntimeError, TORCHRUN,
     "a process group of 2 ranks"),
])
def test_reconstruction_is_refused(extra, exc, match, item, tmp_path, monkeypatch):
    for name in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(exc, match=match) as e:
        TQW.main(["--device", "cpu", "--base", str(BASE), "--outdir", str(tmp_path)] + extra)
    assert item in str(e.value)
    assert not os.listdir(tmp_path)  # refused before any work


def _same(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))


def _same_states(jper, tper):
    assert list(jper) == list(tper)
    for slot in tper:
        for key in ("a", "sm"):
            assert set(jper[slot].get(key, {})) == set(tper[slot].get(key, {})), (slot, key)
            for name, tv in tper[slot].get(key, {}).items():
                jv = jper[slot][key][name]
                fields = (("delta_mid", "zp_mid", "delta_last", "zp_last")
                          if hasattr(tv, "delta_mid") else ("delta", "zero_point")
                          if hasattr(tv, "delta") else (None,))
                for f in fields:
                    _same(jv if f is None else getattr(jv, f), tv if f is None else
                          getattr(tv, f))


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib")
    common = ["--device", "cpu", "--model", "sd", "--base", str(BASE), "--wq", "4",
              "--cali_prompt_data_n", "2", "--step_size", "2", "--latent_hw", "16",
              "--cali_data_path", str(d / "cali"), "--outdir", str(d / "results")]
    w = TQW.main(common + ["--fast", "--no_recon", "--use_aq"])
    a = TQA.main(common + ["--cali_ckpt", w["weight_only"], "--aq", "8", "--group_num", "2",
                           "--pallas_attn"] + T2I)
    return d, common, w, a


def test_quantize_weight_checkpoints_load_in_jax_bit_for_bit(flow):
    _, _, w, _ = flow
    spec = sd_unet_spec(base=BASE)
    _, tparams, _, _, _ = build_model("sd", base=BASE, seed=42, device="cpu")
    jparams, jwqp, jalphas = JK.load_weight_only(w["weight_only"], spec)
    assert not jalphas
    tnp = params_to_numpy(tparams, spec)
    for name in tnp:
        for k, v in tnp[name].items():
            if v is not None:
                _same(jparams[name][k], v)
    from dgq_tpu_torch.calib.weight_calib import init_weight_qparams

    for name, qp in init_weight_qparams(tparams, spec, 4).items():
        _same(jwqp[name].delta, qp.delta)
        _same(jwqp[name].zero_point, qp.zero_point)
    mparams, mwqp, _, jper, jgl = JK.load_merged(w["merged"], spec)
    assert jgl == () and len(jper) == 3  # PNDM: 2 steps, 3 UNet calls
    _same_states(jper, w["per_t"])
    assert len(w["per_t"]["act_0"]["a"]) > 300
    assert set(w["seconds"]) == {"build", "shard", "weight_init", "cali_data", "act_slots"}
    assert len(w["seconds"]["act_slots"]) == 3


def test_quantize_act_checkpoint_loads_in_jax_bit_for_bit(flow):
    _, _, _, a = flow
    spec = sd_unet_spec(base=BASE)
    assert os.path.basename(a["act_ckpt"]) == "cali_ckpt_activation_w4a8g2.pth"
    params, _, _, jper, jgl = JK.load_merged(a["act_ckpt"], spec)
    assert params is None
    assert jgl == a["group_layers"] and len(jgl) > 40
    _same_states(jper, a["per_t"])
    axes = {v.delta_last.numel() > 1 for v in a["per_t"]["act_0"]["a"].values()
            if hasattr(v, "delta_mid")}
    assert axes == {True, False}  # both axes occur


def test_merge_and_infer_on_the_port_checkpoints(flow):
    d, _, w, a = flow
    merged = str(d / "sd_w4a8g2_merged.pth")  # cli.infer reads g2 off the name
    assert TCT.main(["merge", w["weight_only"], a["act_ckpt"], merged]) == 0
    out = d / "infer"
    out.mkdir()
    res = TI.main(["--device", "cpu", "--model", "sd", "--base", str(BASE), "--cali_ckpt",
                   merged, "--use_aq", "--use_group", "--num_inference_steps", "2", "--height",
                   "128", "--width", "128", "--outdir", str(out), "--prompt", "x",
                   "--pallas_attn", "--group_impl", "fused"] + T2I)
    names = sorted(os.path.basename(p) for p in res["outputs"])
    assert names == sorted(f"tmp_sd_x_{i}_{t}.npy" for t in ("fp", "w4a8g2") for i in (0, 1))
    for p in res["outputs"]:
        arr = np.load(p)
        assert arr.shape == (16, 16, 4) and np.isfinite(arr).all()


def test_resume_w_resaves_the_weight_only_checkpoint(flow):
    """--resume_w without --use_aq reads a weight-only file and writes it
    again under the new run directory: the same weights and scales."""
    d, common, w, _ = flow
    spec = sd_unet_spec(base=BASE)
    r = TQW.main(common + ["--resume_w", w["weight_only"]])
    assert r["weight_only"] != w["weight_only"] and r["merged"] is None
    a, b = JK.load_weight_only(w["weight_only"], spec), JK.load_weight_only(r["weight_only"], spec)
    for name in a[0]:
        for k, v in a[0][name].items():
            if v is not None:
                _same(v, b[0][name][k])
    for name, qp in a[1].items():
        _same(qp.delta, b[1][name].delta)
        _same(qp.zero_point, b[1][name].zero_point)


def _clip_file(path, vocab, width, proj, seed):
    """A tiny CLIP text encoder (2 layers) saved under HF's names."""
    p = init_clip_text(torch.Generator().manual_seed(seed), "cpu", vocab=vocab, width=width,
                       layers=2, proj_dim=proj)
    state = {"embeddings.token_embedding.weight": p.pop("token_embedding"),
             "embeddings.position_embedding.weight": p.pop("position_embedding")}
    if proj:
        state["text_projection.weight"] = p.pop("text_projection")
    for name, leaves in p.items():
        for leaf, v in leaves.items():
            state[f"{name}.{'bias' if leaf in ('b', 'bias') else 'weight'}"] = v
    torch.save(state, path)
    return str(path)


@pytest.mark.parametrize("model", ["sd", "sdxl"])
def test_encode_cali_prompts_matches_jax(model, tmp_path):
    pytest.importorskip("transformers")
    import json

    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    vocab.update({"<|startoftext|>": len(vocab), "<|endoftext|>": len(vocab) + 1})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    w1 = _clip_file(tmp_path / "te1.bin", len(vocab), 64, 0, seed=0)
    w2 = _clip_file(tmp_path / "te2.bin", len(vocab), 128, 96, seed=1)
    kw = dict(text_weights_2=w2, tokenizer_2_path=str(tmp_path)) if model == "sdxl" else {}
    prompts = ["a cat", "two dogs playing", "a red car"]
    got = TC.encode_cali_prompts(model, prompts, w1, str(tmp_path), batch_size=2, device="cpu",
                                 **kw)
    want = JC.encode_cali_prompts(model, prompts, w1, str(tmp_path), batch_size=2, **kw)
    shapes = ((3, 77, 64), (3, 77, 64)) if model == "sd" else ((3, 77, 192), (3, 96))
    for a, b, shape in zip(got, want, shapes):
        assert tuple(a.shape) == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
