"""The whole step's share of the chip's peak: the model operations of the
window's batches (UNet calls and decodes, costs.unet_forward_flops and
vae_decode_flops) over the window's time, over 495 TFLOP/s, in percent."""


def read(rc):
    w = rc.window
    return 100.0 * w["batches"] * rc.info["flops_per_batch"] / w["seconds"] / rc.costs.PEAK_FLOPS
