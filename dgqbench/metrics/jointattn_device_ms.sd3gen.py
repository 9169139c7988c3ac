"""Device ms of the joint attentions in one SD3 transformer call: the
program's `dgq.joint_attention` spans (the q, k and v quantizers, the
text-first concatenation, the K3b pair and the split back, one a block) in
its timed MMDiT calls (every second call leaves them untimed), their stream
extents less the device's idle inside them (`harness/spans.py`), summed,
over those calls."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.joint_attention", per="dgq.mmdit")
