"""Score generated images: FID, Inception Score, CLIP score, ImageReward
(port of `dgq_tpu/cli/eval_scores.py`).

The reference shells out to pytorch-fid / torch-fidelity / open_clip
(its scripts/eval_scores.sh:17-32); here every metric runs in-process on the
port's scorers (`dgq_tpu_torch/eval/`), in float32 on the card.

    python -m dgq_tpu_torch.cli.eval_scores --gen_dir out/im256 \\
        --inception_ckpt pt_inception-2015-12-05-6726825d.pth \\
        --ref_stats data/real_im256.npz --isc
    # CLIP score as well: --clip_model <local CLIP snapshot> --prompts f.csv

--ref_stats takes the reference's real_im256.npz (mu / sigma) format; pass
--ref_dir instead to compute the stats from a directory of reference images.
Without --inception_ckpt a random extractor is used (relative comparisons
only: the absolute FID means nothing without real weights). It runs on the
card (--device cuda, the default) and refuses to start without one; --device
cpu runs on the CPU. `main(argv)` returns the results dict, which it also
prints as one JSON line (and writes to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _stem_key(f: str):
    """Sort / alignment key of an image file: gen4eval writes
    '{prompt_idx}_{rep}' stems (older runs bare unpadded ints), and a
    lexicographic sort would misalign images with the prompt file from 10
    prompts on. Returns (bucket, prompt_idx, rep, name); prompt_idx is -1
    when the stem does not parse."""
    stem = os.path.splitext(f)[0]
    head, _, tail = stem.partition("_")
    try:
        return (0, int(head), int(tail) if tail else 0, f)
    except ValueError:
        return (1, -1, 0, f)


def load_images(path: str, limit: int = 0, with_prompt_ids: bool = False):
    """Directory of .png / .jpg / .npy images -> (N, H, W, 3) uint8, in
    numeric (prompt, rep) order.

    Sets of mixed sizes (reference-image directories) are resized image by
    image to 299x299 bilinear, the Inception input size, as pytorch-fid does.
    with_prompt_ids=True also returns each image's prompt index from its
    '{prompt_idx}_{rep}' stem (None when the names are not in that scheme),
    so CLIP scoring pairs correctly with repeats."""
    keys = sorted(_stem_key(f) for f in os.listdir(path)
                  if f.lower().endswith((".png", ".jpg", ".jpeg", ".npy")))
    if limit:
        keys = keys[:limit]
    if not keys:
        raise FileNotFoundError(f"no images in {path}")
    out = []
    for _, _, _, f in keys:
        fp = os.path.join(path, f)
        if f.endswith(".npy"):
            arr = np.load(fp)
            if arr.dtype != np.uint8:
                # a float .npy is a no-VAE run's raw latents, not an image: a
                # blind uint8 cast would wrap negatives and score garbage
                raise ValueError(
                    f"{fp} holds non-uint8 data (shape {arr.shape}, dtype {arr.dtype}) — raw "
                    f"latents from a no-VAE run cannot be scored; re-generate with "
                    f"--vae_weights")
        else:
            from PIL import Image

            arr = np.asarray(Image.open(fp).convert("RGB"))
        out.append(arr)
    if len({a.shape for a in out}) > 1:
        from PIL import Image

        out = [np.asarray(Image.fromarray(a).resize((299, 299), Image.BILINEAR)) for a in out]
    images = np.stack(out)
    if not with_prompt_ids:
        return images
    ids = [k[1] for k in keys]
    return images, (ids if all(i >= 0 for i in ids) else None)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gen_dir", required=True, help="generated images dir")
    ap.add_argument("--ref_stats", default=None,
                    help="real_im256.npz-format (mu, sigma) reference stats")
    ap.add_argument("--ref_dir", default=None, help="reference images dir (stats computed here)")
    ap.add_argument("--inception_ckpt", default=None,
                    help="local pt_inception-2015-12-05-*.pth")
    ap.add_argument("--isc", action="store_true",
                    help="also compute IS (needs the checkpoint's fc head)")
    ap.add_argument("--clip_model", default=None,
                    help="local transformers CLIP snapshot dir (torchmetrics-style 2.5x clamped "
                         "score)")
    ap.add_argument("--open_clip_ckpt", default=None,
                    help="open_clip checkpoint file (e.g. ViT-g-14 laion2b_s34b_b88k "
                         "open_clip_pytorch_model.bin): the reference's exact CLIP protocol; "
                         "needs --tokenizer")
    ap.add_argument("--tokenizer", default=None,
                    help="local CLIP tokenizer dir (BPE vocab) for --open_clip_ckpt")
    ap.add_argument("--image_reward_ckpt", default=None,
                    help="ImageReward-v1.0 checkpoint (ImageReward.pt), scored natively; needs "
                         "--ir_tokenizer and --prompts")
    ap.add_argument("--ir_tokenizer", default=None,
                    help="local BertTokenizer dir (vocab.txt) for --image_reward_ckpt")
    ap.add_argument("--prompts", default=None,
                    help="prompt csv/tsv aligned with sorted image names")
    ap.add_argument("--limit", type=int, default=0,
                    help="score only the first N images (all metrics)")
    ap.add_argument("--clip_limit", type=int, default=0,
                    help="cap ONLY the CLIP score at N images (the reference caps CLIP at "
                         "3000 while FID/IS use the full set)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=None, help="write results json here too")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    if args.open_clip_ckpt and not args.tokenizer:
        ap.error("--open_clip_ckpt requires --tokenizer (local CLIP BPE tokenizer dir)")
    if args.image_reward_ckpt and not (args.ir_tokenizer and args.prompts):
        ap.error("--image_reward_ckpt requires --ir_tokenizer and --prompts")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from dgq_tpu_torch.cli.common import resolve_device
    from dgq_tpu_torch.eval.inception import (
        fid_features,
        inception_probs,
        init_inception,
        load_pt_inception,
    )
    from dgq_tpu_torch.eval.scores import frechet_distance, gaussian_stats, inception_score

    device = resolve_device(args.device)
    gen, prompt_ids = load_images(args.gen_dir, args.limit, with_prompt_ids=True)
    print(f"scoring {len(gen)} images from {args.gen_dir}", file=sys.stderr)

    if args.inception_ckpt:
        params = load_pt_inception(args.inception_ckpt, device)
    else:
        print("WARNING: no --inception_ckpt; random-init extractor (relative FID only)",
              file=sys.stderr)
        params = init_inception(torch.Generator(device).manual_seed(0), device)

    results = {}
    mu, sigma = gaussian_stats(fid_features(params, gen, batch_size=args.batch))
    if args.ref_stats:
        z = np.load(args.ref_stats)
        results["fid"] = frechet_distance(mu, sigma, z["mu"], z["sigma"])
    elif args.ref_dir:
        ref = load_images(args.ref_dir, args.limit)
        mu_r, sg_r = gaussian_stats(fid_features(params, ref, args.batch))
        results["fid"] = frechet_distance(mu, sigma, mu_r, sg_r)

    if args.isc:
        if "fc" not in params:
            print("WARNING: --isc skipped (no fc head; pass --inception_ckpt with a full "
                  "pt_inception checkpoint)", file=sys.stderr)
        else:
            is_mean, is_std = inception_score(inception_probs(params, gen, batch_size=args.batch))
            results["inception_score"] = is_mean
            results["inception_score_std"] = is_std

    if args.prompts and (args.clip_model or args.open_clip_ckpt or args.image_reward_ckpt):
        from dgq_tpu_torch.cli.gen4eval import read_prompts

        n = min(len(gen), args.clip_limit) if args.clip_limit else len(gen)
        all_prompts = read_prompts(args.prompts)
        if prompt_ids is not None:
            # each image with ITS prompt by the '{prompt}_{rep}' stem (a 1:1
            # positional pairing misaligns when n_per_prompt > 1)
            prompts = [all_prompts[pid] for pid in prompt_ids[:n]]
        else:
            prompts = all_prompts[:n]
        if args.image_reward_ckpt:
            from dgq_tpu_torch.eval.image_reward import image_reward_score_native

            results["image_reward"] = image_reward_score_native(
                list(gen[:n]), prompts, args.image_reward_ckpt, args.ir_tokenizer,
                batch_size=args.batch, device=device)
        if args.open_clip_ckpt:
            from dgq_tpu_torch.eval.open_clip import clip_score_openclip

            results["clip_score_openclip"] = clip_score_openclip(
                list(gen[:n]), prompts, args.open_clip_ckpt, args.tokenizer, device=device)
        if args.clip_model:
            from dgq_tpu_torch.eval.scores import clip_score

            results["clip_score"] = clip_score(list(gen[:n]), prompts, args.clip_model,
                                               device=device)

    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
