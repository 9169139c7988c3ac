"""Device ms of one UNet call in operations outside the port's kernels and the
library's convs, matmuls and reductions: the fake quantizers, norms,
activations and copies."""
from dgqbench.harness.trace import ELEMENTWISE


def read(rc):
    s = next((s for s in rc.sessions if s.label == "unet"), None)
    if s is None or not s.device_ops:
        return None
    return 1e3 * s.time_s({ELEMENTWISE}) / s.units
