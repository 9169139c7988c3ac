"""Operations of SD3 medium's MMDiT forward (`reference.sd3.mmdit_spec`),
by the rules of `dgqbench.costs`: a multiply-add is 2 operations, the joint
attention counts Q K^T and P V, elementwise work, norms and softmax count
nothing.

Each linear acts on the rows of its stream: the image stream's (to_q/k/v,
to_out.0, ff, proj_out) on the image tokens, the text stream's (add_q/k/v_proj,
to_add_out, ff_context, context_embedder) on the text tokens, the adaLN and
embedding linears once a sample; the patch embedding once an image token.
"""
from __future__ import annotations


def _rows(name: str, tokens: int, text: int) -> int:
    if name.startswith("time_text_embed.") or ".norm1" in name or name == "norm_out.linear":
        return 1
    if (name == "context_embedder" or ".add_" in name or ".to_add_out" in name
            or ".ff_context." in name):
        return text
    return tokens


def mmdit_forward_flops(spec, tokens: int, text: int, batch: int) -> float:
    """Operations of one forward at `tokens` image tokens (4096 at 1024 px),
    `text` text tokens (333) and `batch` rows (the CFG batch)."""
    macs = 0
    for name, kind, meta in spec:
        cin, cout = meta[0], meta[1]
        if kind == "conv":
            macs += cin * cout * meta[2] * meta[2] * tokens
            continue
        macs += cin * cout * _rows(name, tokens, text)
        if name.endswith(".attn.to_q"):
            n = tokens + text
            macs += 2 * n * n * cout
    return 2.0 * macs * batch

