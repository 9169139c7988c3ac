"""Deploy half of calibration: weight scale init and folding, quant-point names."""
