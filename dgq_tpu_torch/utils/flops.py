"""Model cost accounting: Params / MACs / FLOPs / BOPs, and a speed-of-light
estimate of one UNet forward (port of `dgq_tpu/utils/flops.py`).

`spec_cost` walks the layer spec with symbolic spatial sizes (exact for conv
and linear; attention added from the transformer topology). BOPs follow the
reference convention: MACs * w_bits * a_bits (32 x 32 for fp32).
`spec_roofline` defaults to one NVIDIA H100 SXM's published peaks. The JAX
package's `xla_cost` reads XLA's compiled cost analysis and has no
counterpart here.
"""
from __future__ import annotations

from typing import Optional

# the NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM rate
H100_BF16_TFS = 989.0
H100_HBM_GBS = 3350.0


def _make_level_hw(spec, latent_hw: int):
    """Per-layer spatial size from the UNet topology encoded in spec names.

    The level count is read off the down-block indices (SD has 4 levels —
    mid at /8, up_blocks.i at /2^(3-i); SDXL has 3 — mid at /4, up at
    /2^(2-i)), so one helper serves both models. Upsampler convs run AFTER
    the nearest-2x interpolation (unet_sd.py upsample-then-conv), so their
    input is at twice the block scale."""
    top = max((int(n.split(".")[1]) for n, _, _ in spec
               if n.startswith("down_blocks.")), default=3)

    def level_hw(name: str) -> int:
        if name.startswith("down_blocks."):
            # a block's convs (incl. its stride-2 downsampler input) run at
            # the scale before the downsample
            h = latent_hw // (2 ** int(name.split(".")[1]))
        elif name.startswith("mid_block"):
            h = latent_hw // (2 ** top)
        elif name.startswith("up_blocks."):
            i = int(name.split(".")[1])
            h = latent_hw // (2 ** max(top - i, 0))
            if ".upsamplers." in name:
                h *= 2  # conv after the 2x interpolation
        else:
            h = latent_hw
        return max(h, 1)

    return level_hw


def _is_token_linear(name: str) -> bool:
    """Linears applied per spatial/sequence token (vs once per sample).
    time_emb_proj contains 'proj' but is a per-sample vector op."""
    if "time_emb_proj" in name:
        return False
    return ".attn" in name or ".ff." in name or "proj" in name


def spec_cost(spec, latent_hw: int = 64, seq: int = 77, heads: int = 8,
              head_dim_divisor: int = 64) -> dict:
    """Analytic Params/MACs for a UNet spec at a given latent size.

    Spatial sizes are tracked per level from the spec topology; attention
    token counts follow the conv feature map at each transformer's level.
    """
    params = 0
    macs = 0
    level_hw = _make_level_hw(spec, latent_hw)

    for name, kind, meta in spec:
        if kind == "conv":
            cin, cout, k, stride, pad = meta
            params += cin * cout * k * k + cout
            h = level_hw(name)
            ho = h // stride
            macs += cin * cout * k * k * ho * ho
        elif kind == "linear":
            cin, cout, bias = meta
            params += cin * cout + (cout if bias else 0)
            if _is_token_linear(name):
                t = level_hw(name) ** 2
                if ".to_k" in name or ".to_v" in name:
                    # cross attention keys/values read the text sequence
                    t = seq if ".attn2." in name else t
                macs += cin * cout * t
                if name.endswith(".to_q"):
                    # score + value matmuls for this attention
                    tq = level_hw(name) ** 2
                    ts = seq if ".attn2." in name else tq
                    d_total = cout
                    macs += 2 * tq * ts * d_total
            else:
                macs += cin * cout  # per-sample vector ops (time embedding)
        else:
            (c,) = meta
            params += 2 * c
    return {"params": params, "macs": macs, "flops": 2 * macs}


def bops(macs: int, w_bits: int, a_bits: int) -> int:
    """Bit operations (reference sd.py:645 convention)."""
    return macs * w_bits * a_bits


def spec_roofline(spec, latent_hw: int = 64, batch: int = 8, seq: int = 77,
                  peak_tfs: float = H100_BF16_TFS, hbm_gbs: float = H100_HBM_GBS,
                  heads: int = 8, attn_head_dim: Optional[int] = None,
                  mxu_lane: int = 128) -> dict:
    """Speed-of-light estimate of one UNet forward on one card.

    Per layer: time = max(compute, memory) with compute = 2*MACs / peak and
    memory = (weights + input + output bytes in bf16) / memory bandwidth —
    the ideal where every elementwise producer is fused, so each activation
    is read and written once per layer. Attention is modeled as flash (score
    and value matmul FLOPs counted; the TxT score matrix never reaches
    memory; q/k/v/o traffic is counted at their projection layers), with the
    head padding made explicit: the attention kernels run a head in a slot
    of 64, 128 or 256 lanes (the packed layout of `pack_attention_heads`;
    SD's 40 / 80 / 160-wide heads take slots of 64 / 128 / 256, SDXL's 64-wide
    heads fill theirs), so the score and value matmuls run at head_dim / slot
    efficiency. mxu_lane = 128 gives those slots (a head of at most 64 takes
    64, a wider one the next multiple of 128: the JAX package's 128-lane rule
    gives the same slots). Norm layers are one read+write of their tensor.
    Defaults are one H100 SXM: 989 bf16 TF/s, 3350 GB/s; SD heads=8
    (head_dim = width/8), pass attn_head_dim=64 for SDXL's fixed 64-wide
    heads.

    Returns totals plus a per-scale-level breakdown; `sol_s` is the
    irreducible sum of per-layer maxima, `compute_s`/`memory_s` the pure
    single-resource bounds. Model-width floor only — it excludes quantizer
    arithmetic, schedulers, and the VAE."""
    BY = 2  # bf16
    level_hw = _make_level_hw(spec, latent_hw)

    per_scale: dict = {}
    tot_c = tot_m = sol = 0.0
    for name, kind, meta in spec:
        h = level_hw(name)
        macs = 0
        byt = 0
        if kind == "conv":
            cin, cout, k, stride, pad = meta
            ho = h // stride
            macs = batch * cin * cout * k * k * ho * ho
            byt = (cin * cout * k * k
                   + batch * h * h * cin + batch * ho * ho * cout) * BY
        elif kind == "linear":
            cin, cout, bias = meta
            if _is_token_linear(name):
                t = h * h
                if (".to_k" in name or ".to_v" in name) and ".attn2." in name:
                    t = seq
                macs = batch * cin * cout * t
                byt = (cin * cout + batch * t * (cin + cout)) * BY
                if name.endswith(".to_q"):
                    tq = h * h
                    ts = seq if ".attn2." in name else tq
                    hd = attn_head_dim or max(cout // heads, 1)
                    # head padding: a head runs in the smallest slot the
                    # kernels address — 64 lanes for a head of at most 64
                    # (SD's 40-wide heads at 64/40, SDXL's 64-wide at 1.0),
                    # otherwise the next mxu_lane multiple. A cost of the
                    # model's head shape, not a software gap.
                    g = 64 if (mxu_lane == 128 and hd <= 64) else mxu_lane
                    slot = -(-hd // g) * g
                    pad = max(slot / hd, 1.0)
                    macs += int(batch * 2 * tq * ts * cout * pad)  # flash
            else:  # per-sample vectors (time embedding)
                macs = batch * cin * cout
                byt = (cin * cout + batch * (cin + cout)) * BY
        else:  # norm: one fused read+write of the activation
            (c,) = meta
            byt = 2 * batch * h * h * c * BY
        c_s = 2 * macs / (peak_tfs * 1e12)
        m_s = byt / (hbm_gbs * 1e9)
        tot_c += c_s
        tot_m += m_s
        sol += max(c_s, m_s)
        lv = per_scale.setdefault(h, {"compute_s": 0.0, "memory_s": 0.0,
                                      "sol_s": 0.0, "macs": 0, "bytes": 0})
        lv["compute_s"] += c_s
        lv["memory_s"] += m_s
        lv["sol_s"] += max(c_s, m_s)
        lv["macs"] += macs
        lv["bytes"] += byt
    return {"sol_s": sol, "compute_s": tot_c, "memory_s": tot_m,
            "per_scale": dict(sorted(per_scale.items(), reverse=True))}
