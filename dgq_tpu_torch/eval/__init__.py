"""Evaluation: FID / IS / CLIP-score / ImageReward scoring and the image
resizes they need (port of `dgq_tpu/eval/`)."""
