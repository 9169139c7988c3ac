"""Device ms of one Adam step's forward of the unit and its loss: the
program's `dgq.recon.unit_forward` spans, their stream extents less the
device's idle inside them (`harness/spans.py`), over their count."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.recon.unit_forward")
