"""Command-line entry points (`python -m dgq_tpu_torch.cli.<name>`)."""
