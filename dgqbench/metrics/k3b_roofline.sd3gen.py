"""K3b (`rt_stats` + `quant_accum`) in SD3's joint attention (T = S = 4429,
head dim 64, 96 heads a call, one a block): the least time of the
transformer calls' attentions (costs.attention) over the device time of
the kernel's launches, in percent."""

FAMILIES = {"quant_tf32_kernel", "quant_tc_kernel"}


def read(rc):
    s = next((s for s in rc.sessions if s.label == "mmdit"), None)
    if s is None or "k3b_calls" not in rc.info:
        return None
    spent = s.time_s(FAMILIES)
    if spent <= 0:
        return None
    bound = sum(rc.costs.bound_s(*rc.costs.attention(*a)) for a in rc.info["k3b_calls"])
    return 100.0 * bound * s.units / spent
