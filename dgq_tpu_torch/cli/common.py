"""Shared CLI plumbing (port of `dgq_tpu/cli/common.py`): the device,
model construction and weight loading, logging, the quantization flags, the
calibration inputs (prompt embeddings, calibration data and the cache key of
their `.npz` file), and the process group of a multi-process run.

In a run of several ranks (torchrun, or --multihost) only rank 0 writes
files (checkpoints, run.log, partial saves, caches); the other ranks log to
stderr under their rank. The JAX package's processes each write the same
files; ROADMAP queue 3 keeps the difference.

The model is chosen by --model {sd,sdxl}; the DIFFUSERS_REWRITE environment
variable gives the default, as in the reference.
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import logging
import os
import random
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def model_type_from_env(default: str = "sd") -> str:
    return os.environ.get("DIFFUSERS_REWRITE", default)


def resolve_device(name: str) -> str:
    """The device a CLI runs on. 'cuda' without a usable card is an error:
    the entry points never fall back to the CPU on their own. A rank of a
    process group takes its own card (`parallel.mesh.rank_device`) as the
    current device, so 'cuda' means that card."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r}: cuda or cpu")
    if name == "cuda" and dist.is_initialized():
        from dgq_tpu_torch.parallel.mesh import rank_device

        torch.cuda.set_device(rank_device(name))
    return name


def process_rank() -> int:
    """This process's rank in the process group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def writes_files() -> bool:
    """Whether this process writes the run's files: rank 0 of a process
    group, or a process on its own."""
    return process_rank() == 0


def built_once(fn, mesh=None):
    """fn()'s result on every rank of a process group, computed once: rank 0
    computes it (reading or writing any cache itself) and broadcasts it (CPU
    tensors and Python values) to the others. fn() alone without a process
    group.

    With weights cut over channels (a mesh of tp > 1) a forward needs every
    rank of a tp group, so dp rank 0's tp group (ranks 0 to tp - 1) computes
    fn() together, each rank on its shards, and rank 0 broadcasts. The data
    are then those of the whole weights up to summation order, as the JAX
    package builds them on its sharded weights; no rank ever holds the whole
    weights on its card."""
    if not dist.is_initialized():
        return fn()
    tp = mesh.tp if mesh is not None else 1
    out = [fn() if process_rank() < tp else None]
    dist.broadcast_object_list(out, src=0)
    return out[0]


def announce_rank(device: str) -> None:
    """In a process group, print the rank's backend and device to stderr
    (the first line of a CLI that does not log through `setup_logging`)."""
    if dist.is_initialized():
        import sys

        from dgq_tpu_torch.parallel.mesh import describe_rank

        print(describe_rank(device), file=sys.stderr, flush=True)


def setup_logging(outdir: str, device: str = "cuda") -> tuple[Optional[str], logging.Logger]:
    """-> (the run's directory, the logger). Rank 0 (or a process on its
    own) makes `outdir/<timestamp>/` and logs to its run.log and to stderr;
    another rank makes nothing, logs to stderr under its rank and gets None
    for the directory. In a process group the first line names the rank's
    backend and device."""
    rank = process_rank()
    fmt = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
    outpath = None
    if rank == 0:
        os.makedirs(outdir, exist_ok=True)
        outpath = os.path.join(outdir, datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S"))
        os.makedirs(outpath, exist_ok=True)
        handlers = [logging.FileHandler(os.path.join(outpath, "run.log")),
                    logging.StreamHandler()]
    else:
        fmt = f"%(asctime)s - rank {rank} - %(levelname)s - %(name)s -   %(message)s"
        handlers = [logging.StreamHandler()]
    logging.basicConfig(format=fmt, datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO,
                        handlers=handlers)
    log = logging.getLogger("dgq_tpu_torch")
    if dist.is_initialized():
        from dgq_tpu_torch.parallel.mesh import describe_rank

        log.info(describe_rank(device))
    return outpath, log


def build_model(model_type: str, base: Optional[int] = None, seed: int = 0,
                hf_unet_path: Optional[str] = None, sdxl_depths: tuple = (2, 10),
                init_params: bool = True, device="cuda", host: bool = False):
    """-> (spec, params, unet_apply, latent_hw, cross).

    hf_unet_path: a torch state dict (file or snapshot directory) of the
    reference UNet, converted on load. Without it, random weights drawn on
    `device` from a generator seeded with `seed` (smoke and benchmark runs
    only); init_params=False gives params=None, for callers that take the
    weights from a checkpoint. host=True keeps the whole weights on the
    host, for a run that moves only its shards to the card
    (`parallel.mesh.shard_params_tp`): random weights are still drawn on
    `device`, the same values, one leaf at a time."""
    if model_type == "sd":
        from dgq_tpu_torch.models.unet_sd import sd_unet_spec, unet_sd_apply

        spec = sd_unet_spec(base=base or 320)
        apply_fn, latent_hw, cross = unet_sd_apply, 64, 768
    elif model_type == "sdxl":
        from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply

        spec = sdxl_unet_spec(base=base or 320, depths=tuple(sdxl_depths))
        apply_fn, latent_hw, cross = unet_sdxl_apply, 128, 2048
    else:
        raise ValueError(f"unknown model type {model_type}")

    if hf_unet_path:
        from dgq_tpu_torch.io.convert import torch_unet_to_params
        from dgq_tpu_torch.io.hf_loader import load_state_dict_any

        params = torch_unet_to_params(load_state_dict_any(hf_unet_path), spec,
                                      "cpu" if host else device)
    elif init_params:
        from dgq_tpu_torch.models.unet_sd import init_unet_sd

        params = init_unet_sd(torch.Generator(device=device).manual_seed(seed), device,
                              spec=spec, store="cpu" if host else None)
    else:
        params = None
    return spec, params, apply_fn, latent_hw, cross


def pooled_dim_for(model_type: str, base: Optional[int] = None) -> int:
    """SDXL's pooled text-embedding width: add_embedding.linear_1 takes
    [pooled, 6 * add_ch] with pooled = the time-embedding width, 4 * base
    (1280 for the real model)."""
    del model_type
    return 4 * (base or 320)


def load_prompts(path: str, num: int, seed: Optional[int] = None) -> list:
    """Prompts from a COCO annotations json (`num` sampled captions) or a
    plain-text file (one prompt per line; `num` sampled when it has more)."""
    if path.endswith(".json"):
        from dgq_tpu_torch.calib.data import get_coco_prompts

        return get_coco_prompts(path, num, seed=seed)
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) <= num:
        return lines
    return random.Random(seed).sample(lines, num)


def timed(device: str, fn):
    """(fn(), seconds it took), the card synchronised at both ends."""
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slot_clock(device: str, log):
    """A `progress` callback for `calibrate_activations` that logs each
    message and notes its time (the card synchronised), and a function that
    gives the seconds between the notes: one a time slot."""
    marks = []

    def progress(msg):
        if device == "cuda":
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        log.info(msg)
    return progress, lambda: [b - a for a, b in zip(marks, marks[1:])]


class _DictKey:
    """Prints as `jax.tree_util.DictKey` does, for the JAX package's path
    strings in `_params_fingerprint`."""

    def __init__(self, key):
        self.key = key

    def __repr__(self):
        return f"DictKey(key={self.key!r})"


def _tree_leaves(tree: dict, path=()):
    """(path, leaf, the channel-parallel mark of the leaf's layer or None)."""
    mark = tree.get("tp")
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, path + (k,))
        elif v is not None and k != "tp":
            yield path + (k,), v, mark


def _samples(leaf: torch.Tensor, mark) -> tuple:
    """(shape, the 17 strided values) of a leaf in the JAX package's layout
    (out axis last): of the whole leaf where `mark` says this is one rank's
    rows of it, each value taken on the rank that holds it and gathered over
    the tp group (a max against -inf, which moves no bit)."""
    if mark is None or leaf.shape[-1] * mark.tp != mark.out:
        stride = max(1, leaf.numel() // 16)
        return tuple(leaf.shape), leaf.reshape(-1)[::stride][:17].detach().double()
    shape = tuple(leaf.shape[:-1]) + (mark.out,)
    numel = leaf.numel() * mark.tp
    j = torch.arange(0, numel, max(1, numel // 16), device=leaf.device)[:17]
    o = j % mark.out - mark.rows.start
    own = (o >= 0) & (o < leaf.shape[-1])
    vals = torch.full(j.shape, float("-inf"), dtype=torch.float64, device=leaf.device)
    vals[own] = leaf.reshape(-1, leaf.shape[-1])[j[own] // mark.out, o[own]].detach().double()
    dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=mark.group)
    return shape, vals


def _params_fingerprint(params: dict) -> str:
    """Content hash of a weight tree for calibration-cache keys: each leaf's
    path and shape plus 17 strided values, a few KB hashed. The leaves are
    taken in the JAX package's layouts (`io.convert.reference_layout`, the layout
    `params_to_numpy` gives) under its path strings, so the same weights give
    the same key in both packages. Only the sampled values leave the device.
    Weights cut over channels give the whole weights' key on every rank of
    the tp group, which calls it together (`_samples`)."""
    from dgq_tpu_torch.io.convert import reference_layout

    h = hashlib.md5()
    leaves = [(str(tuple(_DictKey(k) for k in path)), path[-1], v, mark)
              for path, v, mark in _tree_leaves(params)]
    for path_s, key, leaf, mark in sorted(leaves, key=lambda kv: kv[0]):
        shape, sample = _samples(reference_layout(key, torch.as_tensor(leaf)), mark)
        h.update(path_s.encode())
        h.update(str(shape).encode())
        h.update(np.ascontiguousarray(sample.cpu().numpy()).tobytes())
    return h.hexdigest()[:12]


def encode_cali_prompts(model_type: str, prompts: list, text_weights: str, tokenizer_path: str,
                        text_weights_2: Optional[str] = None,
                        tokenizer_2_path: Optional[str] = None, batch_size: int = 16,
                        device="cuda"):
    """Real captions through the CLIP text encoder(s), for calibration data.
    SD: (text, uncond), the conditional and empty-prompt embeddings of the
    CFG pair. SDXL-turbo (guidance 0): (ehs, pooled) of the dual encoders.
    `transformers` is imported only for the tokenizers."""
    from transformers import CLIPTokenizer

    from dgq_tpu_torch.io.hf_loader import load_state_dict_any
    from dgq_tpu_torch.pipeline.text_encoder import (
        clip_meta_from_params,
        clip_text_encode,
        hf_clip_text_to_params,
        sdxl_encode_prompt,
    )

    tok = CLIPTokenizer.from_pretrained(tokenizer_path)

    def ids_of(tk, texts):
        return torch.as_tensor(tk(texts, padding="max_length", max_length=77, truncation=True,
                                  return_tensors="np").input_ids, device=device)

    params = hf_clip_text_to_params(load_state_dict_any(text_weights), device)
    layers, heads = clip_meta_from_params(params)
    chunks = [list(prompts[i:i + batch_size]) for i in range(0, len(prompts), batch_size)]
    if model_type == "sd":
        texts = [clip_text_encode(params, ids_of(tok, c), layers, heads) for c in chunks]
        unconds = [clip_text_encode(params, ids_of(tok, [""] * len(c)), layers, heads)
                   for c in chunks]
        return torch.cat(texts), torch.cat(unconds)
    tok2 = CLIPTokenizer.from_pretrained(tokenizer_2_path) if tokenizer_2_path else tok
    params2 = (hf_clip_text_to_params(load_state_dict_any(text_weights_2), device)
               if text_weights_2 else params)
    layers2, heads2 = clip_meta_from_params(params2)
    ehss, pooleds = [], []
    for c in chunks:
        ehs, pooled = sdxl_encode_prompt(params, params2, ids_of(tok, c), ids_of(tok2, c),
                                         layers_l=layers, heads_l=heads, layers_g=layers2,
                                         heads_g=heads2, eos_id=tok2.eos_token_id)
        ehss.append(ehs)
        pooleds.append(pooled)
    return torch.cat(ehss), torch.cat(pooleds)


def cali_embeddings_from_args(args, model_type: str, cross: int, n_prompts: int, seed: int,
                              pooled_dim: Optional[int] = None, device="cuda"):
    """The calibration prompt embeddings of a CLI run: real captions through
    real text-encoder weights when --prompt_path / --text_weights /
    --tokenizer are given, synthetic embeddings otherwise. -> (pair, tag),
    the tag for the cache key ('' for the synthetic path, a content hash of
    the real embeddings otherwise)."""
    from dgq_tpu_torch.calib.data import synthetic_prompt_embeddings, synthetic_sdxl_embeddings

    prompt_path = getattr(args, "prompt_path", None)
    if prompt_path:
        missing = [f for f in ("text_weights", "tokenizer") if not getattr(args, f, None)]
        if missing:
            raise SystemExit(f"--prompt_path requires --{' --'.join(missing)} "
                             "(caption-conditioned calibration needs the text encoder)")
        prompts = load_prompts(prompt_path, n_prompts, seed=seed)
        pair = encode_cali_prompts(model_type, prompts, args.text_weights, args.tokenizer,
                                   text_weights_2=getattr(args, "text_weights_2", None),
                                   tokenizer_2_path=getattr(args, "tokenizer_2", None),
                                   device=device)
        return pair, "_c" + _params_fingerprint({"t": pair[0], "u": pair[1]})
    if model_type == "sd":
        return synthetic_prompt_embeddings(n_prompts, dim=cross, seed=seed, device=device), ""
    return synthetic_sdxl_embeddings(n_prompts, dim=cross,
                                     pooled_dim=pooled_dim or pooled_dim_for(model_type),
                                     seed=seed, device=device), ""


def build_cali_data(model_type: str, params: dict, apply_fn, cross: int, n_prompts: int,
                    steps: int, latent_hw: int, seed: int, cache_path: Optional[str] = None,
                    pooled_dim: Optional[int] = None, cache_prefix: Optional[str] = None,
                    embeds: Optional[tuple] = None, embeds_tag: str = ""):
    """Generate (or load from the cache) calibration data for either model
    family -> (cali_data, interval): SD (lmi, t, ehs) with CFG doubling,
    SDXL-turbo (lmi, t, ehs, text_embeds, time_ids) at guidance 0.

    embeds: the prompt embeddings pair (SD (text, uncond), SDXL (ehs,
    pooled)); None draws synthetic ones on the weights' device. cache_prefix
    derives the cache file name here, from everything that changes the data
    (prompts, steps, resolution, seed, a fingerprint of the weights), in the
    JAX package's form; cache_path overrides it verbatim."""
    from dgq_tpu_torch.calib.data import (
        generate_sd_cali_data,
        generate_sdxl_cali_data,
        synthetic_prompt_embeddings,
        synthetic_sdxl_embeddings,
    )

    if cache_path is None and cache_prefix is not None:
        cache_path = (f"{cache_prefix}_{model_type}_{steps}steps_n{n_prompts}"
                      f"_hw{latent_hw}_s{seed}_p{_params_fingerprint(params)}{embeds_tag}.npz")
    device = params["conv_in"]["w"].device
    if model_type == "sd":
        text, uncond = embeds or synthetic_prompt_embeddings(n_prompts, dim=cross, seed=seed,
                                                             device=device)
        return generate_sd_cali_data(params, text, uncond, steps=steps, scheduler="pndm",
                                     latent_hw=latent_hw, seed=seed, cache_path=cache_path,
                                     unet_apply=apply_fn)
    text, pooled = embeds or synthetic_sdxl_embeddings(
        n_prompts, dim=cross, pooled_dim=pooled_dim or pooled_dim_for(model_type), seed=seed,
        device=device)
    return generate_sdxl_cali_data(params, text, pooled, steps=steps, latent_hw=latent_hw,
                                   seed=seed, cache_path=cache_path, unet_apply=apply_fn)


def parse_depths(s: str) -> tuple:
    return tuple(int(x) for x in s.split(","))


def add_quant_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--sdxl_depths", type=parse_depths, default=(2, 10),
                    help="SDXL transformer depths 'lo,hi' (tiny smoke runs)")
    ap.add_argument("--wq", type=int, default=4, help="weight bits")
    ap.add_argument("--aq", type=int, default=8, help="activation bits")
    ap.add_argument("--softmax_a_bit", type=int, default=8)
    ap.add_argument("--t2i_log_quant", action="store_true")
    ap.add_argument("--t2i_real_time", action="store_true")
    ap.add_argument("--t2i_start_peak", action="store_true")
    ap.add_argument("--time_aware_aqtizer", action="store_true")
    ap.add_argument("--group_impl", default="taps",
                    choices=["taps", "fused", "unfold", "im2col"],
                    help="group-conv execution path (taps = per-tap codes and "
                         "accumulated matmuls; fused = the hand-written group "
                         "conv kernel where eligible; unfold = the reference's "
                         "materialized im2col)")
    ap.add_argument("--pallas_attn", action="store_true",
                    help="fused attention kernels with the softmax quantizer "
                         "inside (the hand-written CUDA kernels on the card)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group before any device use (torchrun's "
                         "MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE, or SLURM's "
                         "SLURM_PROCID / SLURM_NTASKS with MASTER_ADDR / MASTER_PORT); "
                         "every rank runs the command, rank 0 writes")
    ap.add_argument("--prompt_path", default=None,
                    help="captions: COCO annotations json or a plain-text "
                         "file, one prompt per line")
    ap.add_argument("--text_weights", default=None,
                    help="CLIP text encoder state dict (file or HF snapshot dir)")
    ap.add_argument("--tokenizer", default=None,
                    help="HF CLIPTokenizer directory (vocab.json/merges.txt)")
    ap.add_argument("--text_weights_2", default=None,
                    help="[sdxl] second text encoder (OpenCLIP-bigG "
                         "WithProjection state dict)")
    ap.add_argument("--tokenizer_2", default=None,
                    help="[sdxl] tokenizer for the second encoder")


def maybe_init_multihost(args) -> None:
    """With --multihost, join the process group (`parallel.mesh.
    init_multihost`) before any device use; no rendezvous in the
    environment is an error, as in the JAX package."""
    if getattr(args, "multihost", False):
        from dgq_tpu_torch.parallel.mesh import init_multihost

        if not init_multihost(device=getattr(args, "device", "cuda")):
            raise RuntimeError(
                "--multihost set but no rendezvous found: launch with torchrun (MASTER_ADDR / "
                "MASTER_PORT / RANK / WORLD_SIZE) or under SLURM (SLURM_PROCID / SLURM_NTASKS "
                "with MASTER_ADDR / MASTER_PORT exported)")


def dp_mesh(args, module: str):
    """The (dp, tp) mesh of a run with --dp N and --tp M (a CLI without --tp
    has M = 1), None when N * M = 1: the process group is joined from the
    environment, and a process outside a group of N * M ranks gets the
    torchrun line that starts `module`."""
    tp = getattr(args, "tp", 1)
    if args.dp * tp == 1:
        return None
    from dgq_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=args.dp, tp=tp, device=args.device, program=module)


def qconfig_from_args(args, use_wq=True, use_aq=False):
    from dgq_tpu_torch.models.qconfig import QConfig

    return QConfig(
        w_bits=args.wq, a_bits=args.aq, softmax_bits=args.softmax_a_bit,
        use_wq=use_wq, use_aq=use_aq,
        t2i_log_quant=args.t2i_log_quant, t2i_real_time=args.t2i_real_time,
        t2i_start_peak=args.t2i_start_peak,
        group_conv_impl=getattr(args, "group_impl", "taps"),
        use_pallas_attention=getattr(args, "pallas_attn", False),
    )
