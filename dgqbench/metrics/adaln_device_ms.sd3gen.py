"""Device ms of the adaLN modulation in one SD3 transformer call: the
program's `dgq.adaln` spans (each block's two modulation linears with the
norm-modulate of both streams before the attention, and the norm-modulates
before the two MLPs) in its timed MMDiT calls, their stream extents less
the device's idle inside them (`harness/spans.py`), summed, over those
calls."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.adaln", per="dgq.mmdit")
