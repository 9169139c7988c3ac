"""The whole step's share of the chip's peak: the unit's forward and
backward operations (3 x the forward's, costs.block_forward_flops) of the
window's steps over the window's time, over 495 TFLOP/s, in percent."""


def read(rc):
    w = rc.window
    return 100.0 * w["attempted"] * rc.info["flops_per_step"] / w["seconds"] / rc.costs.PEAK_FLOPS
