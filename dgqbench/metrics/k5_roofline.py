"""K5 (`group_quant_conv`: the fold, the conv and the split-K finish): the
least time of the UNet calls' stride-1 group convs (costs.group_conv) over
the device time of the kernel's launches, in percent."""

FAMILIES = {"group_conv_tf32_kernel", "group_conv_tc_kernel", "group_conv_kernel",
            "fold_kernel", "fold_oihw_kernel", "finish_kernel"}


def read(rc):
    s = next((s for s in rc.sessions if s.label == "unet"), None)
    if s is None:
        return None
    spent = s.time_s(FAMILIES)
    if spent <= 0:
        return None
    bound = sum(rc.costs.bound_s(*rc.costs.group_conv(*c)) for c in rc.info["k5_calls"])
    return 100.0 * bound * s.units / spent
