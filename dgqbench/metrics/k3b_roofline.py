"""K3b (`rt_stats` + `quant_accum`, the log2 real-time softmax attention):
the least time of the UNet calls' attention calls (costs.attention) over
the device time of the kernel's launches, in percent."""

FAMILIES = {"quant_tf32_kernel", "quant_tc_kernel"}


def read(rc):
    s = next((s for s in rc.sessions if s.label == "unet"), None)
    if s is None:
        return None
    spent = s.time_s(FAMILIES)
    if spent <= 0:
        return None
    bound = sum(rc.costs.bound_s(*rc.costs.attention(*a)) for a in rc.info["k3b_calls"])
    return 100.0 * bound * s.units / spent
