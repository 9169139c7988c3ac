"""Device ms of one Adam step's rounding regulariser: the program's
`dgq.recon.reg` spans (one a step; before the warm-up's end the step
computes no regulariser and its span holds nothing), their stream extents
less the device's idle inside them (`harness/spans.py`), over their
count."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.recon.reg")
