"""The port's evaluation CLIs (`cli/eval_scores.py`, `cli/gen4eval.py`) and
their helpers (`parallel/mesh.shard_prompts`, `read_prompts`, `load_images`)
against the JAX package's, on the same files. The port runs on
--device cpu.

Tolerances: the helpers exactly; eval_scores' JSON values within 1e-4 of
JAX's, relative to max(|value|, 1) (the extractor agrees within 1e-5 of
its largest feature, tests/test_torch_scores.py); gen4eval's images, given
JAX's latents and stand-in embeddings, within one level of 255 (fp, 2 PNDM
steps at CFG 7.5, the VAE decode).
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pil = pytest.importorskip("PIL.Image")
import torch  # noqa: E402

from dgq_tpu.calib import data as JD  # noqa: E402
from dgq_tpu.cli import eval_scores as JE, gen4eval as JG  # noqa: E402
from dgq_tpu.parallel.mesh import shard_prompts as j_shard  # noqa: E402
from dgq_tpu_torch.cli import eval_scores as TE, gen4eval as TG  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_torch_unet  # noqa: E402
from dgq_tpu_torch.models import unet_sd as TU  # noqa: E402
from dgq_tpu_torch.parallel.mesh import shard_prompts  # noqa: E402
from dgq_tpu_torch.pipeline import sd_pipeline as TSP, vae as TV  # noqa: E402


@pytest.mark.parametrize("n,world", [(10, 3), (7, 2), (3, 4), (0, 2)])
def test_shard_prompts_matches_jax(n, world):
    prompts = [str(i) for i in range(n)]
    got = [shard_prompts(prompts, r, world) for r in range(world)]
    assert got == [j_shard(prompts, r, world) for r in range(world)]
    assert sum(got, []) == prompts


@pytest.mark.parametrize("name,text", [
    ("metadata.csv", "image_id,caption\n1,a cat\n2,a dog, running\n"),
    ("p.csv", "prompt\nfirst\nsecond\n"),
    ("other.csv", "text,x\nfirst column,1\nsecond,2\n"),
    ("PartiPrompts.tsv", "Prompt\tCategory\nA bird\tAnimals\nA car\tVehicles\n"),
    ("bare.tsv", "no header\tx\n\nsecond\ty\n"),
])
def test_read_prompts_matches_jax(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    assert TG.read_prompts(str(path)) == JG.read_prompts(str(path))
    assert len(TG.read_prompts(str(path))) == 2


def test_load_images_matches_jax(tmp_path):
    """Numeric (prompt, rep) order, --limit a numeric prefix, the prompt ids,
    mixed sizes resized to 299, and float latents refused."""
    d = tmp_path / "stems"
    d.mkdir()
    for p in range(3):
        for r in range(12):  # n_per_prompt > 10
            np.save(d / f"{p}_{r}.npy", np.full((8, 8, 3), p * 16 + r, np.uint8))
    for limit in (0, 5):
        (ti, tids), (ji, jids) = (m.load_images(str(d), limit, with_prompt_ids=True)
                                  for m in (TE, JE))
        assert np.array_equal(ti, ji) and tids == jids
    assert [int(v) for v in ti[:, 0, 0, 0]] == [0, 1, 2, 3, 4]
    assert sorted(os.listdir(d), key=TE._stem_key) == sorted(os.listdir(d), key=JE._stem_key)
    m = tmp_path / "mixed"
    m.mkdir()
    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate([(64, 48), (48, 64), (32, 32)]):
        pil.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(m / f"img{i}.png")
    ti, tids = TE.load_images(str(m), with_prompt_ids=True)
    assert ti.shape == (3, 299, 299, 3) and tids is None
    assert np.array_equal(ti, JE.load_images(str(m)))
    np.save(d / "9_99.npy", np.zeros((8, 8, 4), np.float32))
    with pytest.raises(ValueError, match="latents"):
        TE.load_images(str(d))


def _pt_inception_file(path, seed=0):
    from dgq_tpu_torch.eval.inception import inception_spec

    rs = np.random.RandomState(seed)
    state = {}
    for name, ci, co, k, _, _ in inception_spec():
        state[f"{name}.conv.weight"] = torch.from_numpy(
            (rs.randn(co, ci, *k) * np.sqrt(2.0 / (ci * k[0] * k[1]))).astype(np.float32))
        state[f"{name}.bn.weight"] = torch.from_numpy(rs.uniform(0.5, 1.5, co).astype(np.float32))
        state[f"{name}.bn.bias"] = torch.zeros(co)
        state[f"{name}.bn.running_mean"] = torch.from_numpy((rs.randn(co) * 0.1).astype(
            np.float32))
        state[f"{name}.bn.running_var"] = torch.ones(co)
    state["fc.weight"] = torch.from_numpy((rs.randn(1008, 2048) * 0.05).astype(np.float32))
    state["fc.bias"] = torch.zeros(1008)
    torch.save(state, path)
    return str(path)


def test_eval_scores_matches_jax(tmp_path, capsys):
    """FID against --ref_dir and IS (--isc) through a pytorch-fid-named
    checkpoint: the same JSON keys as JAX's, in the printed line and the
    --out file, values within 1e-4. (Each FID at 2048 features costs a
    13 s `sqrtm` on the CPU, so the --ref_stats branch, `np.load` of the
    same (mu, sigma) into the same `frechet_distance`, is left to the card's
    run.) Without --inception_ckpt the CLI warns, as JAX's does."""
    rs = np.random.RandomState(1)
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    gen.mkdir(), ref.mkdir()
    for i in range(10):  # one image in each of IS's ten splits
        pil.fromarray(rs.randint(0, 256, (32, 32, 3), np.uint8)).save(gen / f"{i}_0.png")
        pil.fromarray(rs.randint(0, 256, (32, 32, 3), np.uint8)).save(ref / f"{i}.png")
    ckpt = _pt_inception_file(tmp_path / "pt_inception.pth")
    argv = ["--gen_dir", str(gen), "--inception_ckpt", ckpt, "--batch", "4", "--ref_dir",
            str(ref), "--isc", "--limit", "10"]
    ours = TE.main(argv + ["--device", "cpu", "--out", str(tmp_path / "t.json")])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    ref_out = JE.main(argv)
    assert set(ours) == set(ref_out) == {"fid", "inception_score", "inception_score_std"}
    for k in ref_out:
        assert abs(ours[k] - ref_out[k]) <= 1e-4 * max(abs(ref_out[k]), 1.0), (k, ours, ref_out)
    import json

    assert json.load(open(tmp_path / "t.json")) == json.loads(printed) == ours
    capsys.readouterr()
    assert TE.main(["--gen_dir", str(gen), "--device", "cpu", "--batch", "8"]) == {}
    assert "WARNING: no --inception_ckpt" in capsys.readouterr().err


@pytest.fixture(scope="module")
def tiny_sd_files(tmp_path_factory):
    """A tiny SD UNet (base 32) and VAE (base 32) under reference names."""
    root = tmp_path_factory.mktemp("sdfiles")
    spec = TU.sd_unet_spec(base=32)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    (root / "unet").mkdir(), (root / "vae").mkdir()
    torch.save(params_to_torch_unet(tp, spec), root / "unet" / "diffusion_pytorch_model.bin")
    vspec = TV.vae_decoder_spec(base=32)
    tv = TV.init_vae_decoder(torch.Generator().manual_seed(1), "cpu", base=32)
    rng = np.random.RandomState(1)
    for p in tv.values():
        for k in ("bias", "b"):
            if p.get(k) is not None:
                p[k] = p[k] + torch.from_numpy(0.1 * rng.randn(*p[k].shape).astype(np.float32))
    torch.save(params_to_torch_unet(tv, vspec), root / "vae" / "diffusion_pytorch_model.bin")
    return root


def test_gen4eval_fp_matches_jax(tiny_sd_files, tmp_path, monkeypatch):
    """gen4eval --fp with a VAE, 2 prompts x 2 reps: JAX's file names and
    layout (.png plus the --im256 copies), and its images within one level
    when the port is handed JAX's latents and stand-in embeddings."""
    prompts = tmp_path / "prompts.csv"
    prompts.write_text("caption\na cat\na dog\n")
    common = ["--model", "sd", "--base", "32", "--prompts", str(prompts), "--fp", "--batch", "2",
              "--steps", "2", "--height", "64", "--width", "64", "--n_per_prompt", "2",
              "--unet_weights", str(tiny_sd_files / "unet"),
              "--vae_weights", str(tiny_sd_files / "vae"), "--im256"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["gen4eval"] + common + ["--outdir", jdir])
    JG.main()

    def latents(self, b, height, width, seed):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), (b, height // 8, width // 8, 4))))

    def embeddings(n, seq=77, dim=768, seed=0, device="cpu"):
        return tuple(torch.from_numpy(np.array(a)) for a in JD.synthetic_prompt_embeddings(
            n, seq=seq, dim=dim, seed=seed))
    monkeypatch.setattr(TSP.SDPipeline, "_initial_latents", latents)
    from dgq_tpu_torch.calib import data as TD

    monkeypatch.setattr(TD, "synthetic_prompt_embeddings", embeddings)
    res = TG.main(common + ["--outdir", tdir, "--device", "cpu"])
    names = ["0_0.png", "0_1.png", "1_0.png", "1_1.png"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == names
    assert sorted(os.listdir(tdir + "_im256")) == sorted(os.listdir(jdir + "_im256")) == names
    assert res["images"] == 4 and len(res["files"]) == 8
    for f in names:
        a = np.asarray(pil.open(os.path.join(tdir, f)))
        b = np.asarray(pil.open(os.path.join(jdir, f)))
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, f
        assert np.asarray(pil.open(os.path.join(tdir + "_im256", f))).shape == (256, 256, 3)


def test_gen4eval_sdxl_quantized_shards_and_refusals(tmp_path, monkeypatch):
    """SDXL-turbo, minmax W4 without a checkpoint, no VAE: raw latents as
    .npy under global '{prompt}_{rep}' names for rank 1 of 2; outside a
    process group --dp 2 raises naming the torchrun line, and --multihost
    raises as the JAX package's does (no rendezvous)."""
    for name in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    prompts = tmp_path / "p.tsv"
    prompts.write_text("Prompt\n" + "".join(f"prompt {i}\n" for i in range(5)))
    out = str(tmp_path / "out")
    argv = ["--model", "sdxl", "--base", "32", "--sdxl_depths", "1,1", "--prompts", str(prompts),
            "--outdir", out, "--steps", "1", "--height", "64", "--width", "64", "--batch", "2",
            "--wq", "4", "--use_aq", "--device", "cpu"]
    res = TG.main(argv + ["--gpu_rank", "1", "--world_size", "2"])
    assert sorted(os.listdir(out)) == ["3_0.npy", "4_0.npy"]  # prompts 3, 4 of 0..4
    assert res["images"] == len(shard_prompts(list(range(5)), 1, 2)) == 2
    lat = np.load(os.path.join(out, "3_0.npy"))
    assert lat.shape == (8, 8, 4) and lat.dtype == np.float32 and np.isfinite(lat).all()
    for bad, match in ((["--dp", "2"], "torchrun --nproc_per_node 2 -m dgq_tpu_torch.cli.gen4eval"),
                       (["--multihost"], "--multihost set but no rendezvous found")):
        with pytest.raises(RuntimeError, match=match):
            TG.main(argv + bad)
