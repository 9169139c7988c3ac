"""The whole step's share of the chip's peak in SDXL-turbo generation: the
model operations of the window's batches (4 UNet calls, costs.unet_forward_flops,
and the 1024 px decode, costs.vae_decode_flops) over the window's time,
over 495 TFLOP/s, in percent."""


def read(rc):
    w, flops = rc.window, rc.info.get("flops_per_batch")
    if flops is None:
        return None
    return 100.0 * w["batches"] * flops / w["seconds"] / rc.costs.PEAK_FLOPS
