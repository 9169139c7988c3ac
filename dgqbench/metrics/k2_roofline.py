"""K2 (`flash_attention`, the VAE's single-head mid attention, head dim 512):
its least time (costs.attention) over its device time, in percent."""

FAMILIES = {"flash_tf32_kernel", "flash_tc_kernel"}


def read(rc):
    s = next((s for s in rc.sessions if s.label == "vae"), None)
    if s is None:
        return None
    spent = s.time_s(FAMILIES)
    if spent <= 0:
        return None
    return 100.0 * sum(rc.costs.bound_s(*rc.costs.attention(*a))
                       for a in rc.info["k2_calls"]) / spent
