"""SD v1.4 UNet and its NHWC layers, with quantization hook points."""
