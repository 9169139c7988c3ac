"""Device ms of one Adam step's soft rounding of the unit's weights: the
program's `dgq.recon.soft_weights` spans, their stream extents less the
device's idle inside them (`harness/spans.py`), over their count."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.recon.soft_weights")
