"""What the algorithm needs for given shapes, whatever implements it: the
floating-point operations and bytes of each hand-written kernel's call and
of a model's forward, and the least time the chip could take for them.

Counting rules: a multiply-add is 2 operations; each input byte is read
once and each output byte written once (float32 operands: 4 bytes); work
that one implementation repeats (the K3b pair computes Q K^T twice) is
counted once; attention counts Q K^T and P V; elementwise work, norms and
softmax are not counted as operations.

Peak (NVIDIA H100 SXM data sheet, dense): the cells' operands are float32,
and TF32 on the tensor cores is the fastest path that takes them: 495
TFLOP/s. HBM: 3.35 TB/s. A 3xTF32 body therefore reads at most about a
third of its roofline.
"""
from __future__ import annotations

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of operations over the peak and bytes over HBM's rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attention(bh: int, t: int, s: int, d: int) -> tuple:
    """(flops, bytes) of one attention call: Q K^T and P V once each; q, k,
    v read, o written."""
    return 4.0 * bh * t * s * d, F32 * (2.0 * bh * t * d + 2.0 * bh * s * d)


def group_conv(b: int, h: int, w: int, c: int, o: int, k: int, pad: int) -> tuple:
    """(flops, bytes) of one stride-1 group-quantized conv call: the input,
    the weights, the per-(tap, channel) scales and zero points and the bias
    read once, the output written once."""
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    flops = 2.0 * b * ho * wo * o * c * k * k
    nbytes = F32 * (b * h * w * c + k * k * c * o + 2 * k * k * c + o + b * ho * wo * o)
    return flops, nbytes


def feature_side(name: str, latent: int, top: int) -> int:
    """The feature-map side a layer of a UNet works at (upsampler convs after
    the 2x interpolation)."""
    part = name.split(".")
    if name.startswith("down_blocks."):
        return latent >> int(part[1])
    if name.startswith("mid_block"):
        return latent >> top
    if name.startswith("up_blocks."):
        h = latent >> (top - int(part[1]))
        return h * 2 if ".upsamplers." in name else h
    return latent


def _linear_macs(name: str, cin: int, cout: int, tokens: int, seq: int) -> int:
    """A linear's multiply-adds at `tokens` tokens (the time and add
    embeddings act once a sample, cross-attention keys and values on the
    `seq` text tokens), with its attention's Q K^T and P V at its to_q."""
    if name.startswith(("time_embedding", "add_embedding")) or "time_emb_proj" in name:
        return cin * cout
    t = seq if (".attn2.to_k" in name or ".attn2.to_v" in name) else tokens
    macs = cin * cout * t
    if name.endswith(".to_q"):
        macs += 2 * tokens * (seq if ".attn2." in name else tokens) * cout
    return macs


def unet_forward_flops(spec, latent: int, batch: int, seq: int) -> float:
    """Operations of one UNet forward: every conv and linear, each at its
    level's feature-map size, and each attention's Q K^T and P V."""
    top = max(int(n.split(".")[1]) for n, _, _ in spec if n.startswith("down_blocks."))
    macs = 0
    for name, kind, meta in spec:
        h = feature_side(name, latent, top)
        if kind == "conv":
            cin, cout, k, stride, _ = meta
            macs += cin * cout * k * k * (h // stride) ** 2
        elif kind == "linear":
            macs += _linear_macs(name, meta[0], meta[1], h * h, seq)
    return 2.0 * macs * batch


def block_forward_flops(spec, tokens: int, seq: int, batch: int) -> float:
    """Operations of one forward of the linears (and their attentions) of
    `spec`, a transformer block's layers, at `tokens` tokens."""
    return 2.0 * batch * sum(_linear_macs(n, m[0], m[1], tokens, seq)
                             for n, k, m in spec if k == "linear")


def vae_decode_flops(spec, latent: int, batch: int) -> float:
    """Operations of one KL-VAE decode from (latent x latent) latents."""
    macs = 0
    for name, kind, meta in spec:
        if name.startswith("decoder.up_blocks."):
            i = int(name.split(".")[2])
            h = latent << i
            if ".upsamplers." in name:
                h *= 2
        else:
            h = latent << 3 if name in ("decoder.conv_out", "decoder.conv_norm_out") else latent
        if kind == "conv":
            cin, cout, k, _, _ = meta
            macs += cin * cout * k * k * h * h
        elif kind == "linear":
            cin, cout, _ = meta
            macs += cin * cout * h * h
            if name.endswith(".to_q"):
                macs += 2 * (h * h) ** 2 * cout
    return 2.0 * macs * batch
