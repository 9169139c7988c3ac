"""Synthetic quantizer state for benchmarks and smoke runs."""
