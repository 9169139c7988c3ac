"""The whole step's share of the chip's peak in SD3 generation: the model
operations of the window's batches (28 transformer calls at the CFG batch,
costs/sd3.py's mmdit_forward_flops, and the decode, costs.vae_decode_flops)
over the window's time, over 495 TFLOP/s, in percent."""


def read(rc):
    w, flops = rc.window, rc.info.get("flops_per_batch")
    if flops is None:
        return None
    return 100.0 * w["batches"] * flops / w["seconds"] / rc.costs.PEAK_FLOPS
