"""Quantizer math: affine fake-quant, log2 softmax quantizer, minmax scalers."""
