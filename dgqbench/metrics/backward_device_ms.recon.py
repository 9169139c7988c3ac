"""Device ms of one Adam step's backward (`zero_grad` and `backward`): the
program's `dgq.recon.backward` spans, their stream extents less the
device's idle inside them (`harness/spans.py`), over their count."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.recon.backward")
