"""Device ms of the activation quantizers in one UNet call, measured where
the work happens: the program's `dgq.fake_quant` spans in its timed UNet
calls (every second call leaves them untimed), their stream extents less
the device's idle inside them (`harness/spans.py`), summed, over those
calls."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.fake_quant", per="dgq.unet")
