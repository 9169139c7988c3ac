"""Idle ms of the device a UNet call while the host runs the low-resolution
stages (latent side 16 and 8 at 512 px): the idle gaps whose midpoint lies
inside one of the program's spans of those stages, summed, over the calls.
Only the calls inside a `dgq.unet.untimed` span count (every second traced
call), whose quantizer spans record no CUDA events: in the others each
quantizer's event pair costs the host tens of us and widens the gaps. Host
spans and device operations share the profiler's clock."""
from dgqbench.harness.spans import intervals

STAGES = ("dgq.unet.down_blocks.2", "dgq.unet.down_blocks.3", "dgq.unet.mid_block",
          "dgq.unet.up_blocks.0", "dgq.unet.up_blocks.1")


def read(rc):
    s = next((s for s in rc.sessions if s.label == "unet"), None)
    if s is None or not s.device_ops:
        return None
    calls = intervals(s, "dgq.unet.untimed")
    spans = [(a, b) for n, a, b in s.host_ops
             if n in STAGES and any(x <= a and b <= y for x, y in calls)]
    if not spans:
        return None
    idle = sum(b - a for a, b in s.gaps() if any(x <= (a + b) // 2 <= y for x, y in spans))
    return idle / 1e6 / len(calls)
