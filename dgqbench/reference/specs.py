"""Layer lists of the models the benchmark runs, from their published
configurations: SD v1.4's UNet (`CompVis/stable-diffusion-v1-4`,
unet/config.json), SDXL-turbo's UNet (`stabilityai/sdxl-turbo`,
unet/config.json) and the KL-VAE decoder (vae/config.json).

Each list holds (name, kind, meta) in forward order, under the diffusers
state-dict names: conv meta (cin, cout, k, stride, pad), linear meta (cin,
cout, bias), norm meta (channels,). Weights are OIHW for convs and (out, in)
for linears. The widths are parameters so that the CPU tests can build the
same topology small.
"""
from __future__ import annotations


def transformer_block(prefix: str, inner: int, cross: int) -> list:
    """BasicTransformerBlock: self attention, cross attention, GEGLU."""
    out = []
    for attn, kv in ((f"{prefix}.attn1", inner), (f"{prefix}.attn2", cross)):
        out += [(f"{attn}.to_q", "linear", (inner, inner, False)),
                (f"{attn}.to_k", "linear", (kv, inner, False)),
                (f"{attn}.to_v", "linear", (kv, inner, False)),
                (f"{attn}.to_out.0", "linear", (inner, inner, True))]
    out += [(f"{prefix}.norm1", "layernorm", (inner,)),
            (f"{prefix}.norm2", "layernorm", (inner,)),
            (f"{prefix}.norm3", "layernorm", (inner,)),
            (f"{prefix}.ff.net.0.proj", "linear", (inner, inner * 8, True)),
            (f"{prefix}.ff.net.2", "linear", (inner * 4, inner, True))]
    return out


def resnet(prefix: str, cin: int, cout: int, shortcut: bool, temb: int) -> list:
    out = [(f"{prefix}.norm1", "groupnorm", (cin,)),
           (f"{prefix}.conv1", "conv", (cin, cout, 3, 1, 1)),
           (f"{prefix}.time_emb_proj", "linear", (temb, cout, True)),
           (f"{prefix}.norm2", "groupnorm", (cout,)),
           (f"{prefix}.conv2", "conv", (cout, cout, 3, 1, 1))]
    if shortcut:
        out.append((f"{prefix}.conv_shortcut", "conv", (cin, cout, 1, 1, 0)))
    return out


def transformer_2d(prefix: str, c: int, depth: int, cross: int, linear_proj: bool) -> list:
    proj = ("linear", (c, c, True)) if linear_proj else ("conv", (c, c, 1, 1, 0))
    out = [(f"{prefix}.norm", "groupnorm", (c,)),
           (f"{prefix}.proj_in",) + proj,
           (f"{prefix}.proj_out",) + proj]
    for i in range(depth):
        out += transformer_block(f"{prefix}.transformer_blocks.{i}", c, cross)
    return out


def sd_unet(base: int = 320, cross: int = 768) -> list:
    """SD v1.4: block_out_channels (320, 640, 1280, 1280), 2 layers a block,
    one-layer transformers with conv projections, 8 heads."""
    c1, c2, c3 = base, base * 2, base * 4
    temb = base * 4
    spec = [("conv_in", "conv", (4, c1, 3, 1, 1)),
            ("time_embedding.linear_1", "linear", (c1, temb, True)),
            ("time_embedding.linear_2", "linear", (temb, temb, True)),
            ("conv_norm_out", "groupnorm", (c1,)),
            ("conv_out", "conv", (c1, 4, 3, 1, 1))]
    for bi, (cin, cout) in enumerate([(c1, c1), (c1, c2), (c2, c3)]):
        pre = f"down_blocks.{bi}"
        spec += resnet(f"{pre}.resnets.0", cin, cout, bi != 0, temb)
        spec += resnet(f"{pre}.resnets.1", cout, cout, False, temb)
        spec += transformer_2d(f"{pre}.attentions.0", cout, 1, cross, False)
        spec += transformer_2d(f"{pre}.attentions.1", cout, 1, cross, False)
        spec += [(f"{pre}.downsamplers.0.conv", "conv", (cout, cout, 3, 2, 1))]
    for pre in ("down_blocks.3.resnets.0", "down_blocks.3.resnets.1",
                "mid_block.resnets.0", "mid_block.resnets.1"):
        spec += resnet(pre, c3, c3, False, temb)
    spec += transformer_2d("mid_block.attentions.0", c3, 1, cross, False)
    for i in range(3):
        spec += resnet(f"up_blocks.0.resnets.{i}", 2 * c3, c3, True, temb)
    spec += [("up_blocks.0.upsamplers.0.conv", "conv", (c3, c3, 3, 1, 1))]
    for pre, cout, prev, cin, has_up in [("up_blocks.1", c3, c3, c2, True),
                                         ("up_blocks.2", c2, c3, c1, True),
                                         ("up_blocks.3", c1, c2, c1, False)]:
        for i, extra in enumerate((prev, cout, cin)):
            spec += resnet(f"{pre}.resnets.{i}", cout + extra, cout, True, temb)
            spec += transformer_2d(f"{pre}.attentions.{i}", cout, 1, cross, False)
        if has_up:
            spec += [(f"{pre}.upsamplers.0.conv", "conv", (cout, cout, 3, 1, 1))]
    return spec


def sdxl_unet(base: int = 320, cross: int = 2048, add_ch: int = 256,
              depths: tuple = (2, 10)) -> list:
    """SDXL-turbo: block_out_channels (320, 640, 1280), transformer depths
    (-, 2, 10), linear projections, heads of 64, the text-time add
    embedding (projection_class_embeddings_input_dim 2816)."""
    d_lo, d_hi = depths
    c1, c2, c3 = base, base * 2, base * 4
    temb = base * 4
    spec = [("conv_in", "conv", (4, c1, 3, 1, 1)),
            ("time_embedding.linear_1", "linear", (c1, temb, True)),
            ("time_embedding.linear_2", "linear", (temb, temb, True)),
            ("add_embedding.linear_1", "linear", (temb + add_ch * 6, temb, True)),
            ("add_embedding.linear_2", "linear", (temb, temb, True)),
            ("conv_norm_out", "groupnorm", (c1,)),
            ("conv_out", "conv", (c1, 4, 3, 1, 1))]
    spec += resnet("down_blocks.0.resnets.0", c1, c1, False, temb)
    spec += resnet("down_blocks.0.resnets.1", c1, c1, False, temb)
    spec += [("down_blocks.0.downsamplers.0.conv", "conv", (c1, c1, 3, 2, 1))]
    for pre, cin, cout, depth, has_down in [("down_blocks.1", c1, c2, d_lo, True),
                                            ("down_blocks.2", c2, c3, d_hi, False)]:
        spec += resnet(f"{pre}.resnets.0", cin, cout, True, temb)
        spec += resnet(f"{pre}.resnets.1", cout, cout, False, temb)
        spec += transformer_2d(f"{pre}.attentions.0", cout, depth, cross, True)
        spec += transformer_2d(f"{pre}.attentions.1", cout, depth, cross, True)
        if has_down:
            spec += [(f"{pre}.downsamplers.0.conv", "conv", (cout, cout, 3, 2, 1))]
    spec += resnet("mid_block.resnets.0", c3, c3, False, temb)
    spec += resnet("mid_block.resnets.1", c3, c3, False, temb)
    spec += transformer_2d("mid_block.attentions.0", c3, d_hi, cross, True)
    for pre, cout, prev, cin, depth in [("up_blocks.0", c3, c3, c2, d_hi),
                                        ("up_blocks.1", c2, c3, c1, d_lo)]:
        for i, extra in enumerate((prev, cout, cin)):
            spec += resnet(f"{pre}.resnets.{i}", cout + extra, cout, True, temb)
            spec += transformer_2d(f"{pre}.attentions.{i}", cout, depth, cross, True)
        spec += [(f"{pre}.upsamplers.0.conv", "conv", (cout, cout, 3, 1, 1))]
    for i, extra in enumerate((c2, c1, c1)):
        spec += resnet(f"up_blocks.2.resnets.{i}", c1 + extra, c1, True, temb)
    return spec


def vae_decoder(base: int = 128) -> list:
    """KL-VAE decoder: block_out_channels (128, 256, 512, 512), 2 + 1
    resnets an up block, one single-head mid attention."""
    c4, c2, c1 = base * 4, base * 2, base
    spec = [("post_quant_conv", "conv", (4, 4, 1, 1, 0)),
            ("decoder.conv_in", "conv", (4, c4, 3, 1, 1)),
            ("decoder.conv_norm_out", "groupnorm", (c1,)),
            ("decoder.conv_out", "conv", (c1, 3, 3, 1, 1))]
    for pre in ("decoder.mid_block.resnets.0", "decoder.mid_block.resnets.1"):
        spec += [(f"{pre}.norm1", "groupnorm", (c4,)), (f"{pre}.conv1", "conv", (c4, c4, 3, 1, 1)),
                 (f"{pre}.norm2", "groupnorm", (c4,)), (f"{pre}.conv2", "conv", (c4, c4, 3, 1, 1))]
    att = "decoder.mid_block.attentions.0"
    spec += [(f"{att}.group_norm", "groupnorm", (c4,))]
    spec += [(f"{att}.{n}", "linear", (c4, c4, True)) for n in ("to_q", "to_k", "to_v", "to_out.0")]
    cin = c4
    for i, cout in enumerate([c4, c4, c2, c1]):
        for j in range(3):
            pre = f"decoder.up_blocks.{i}.resnets.{j}"
            spec += [(f"{pre}.norm1", "groupnorm", (cin,)),
                     (f"{pre}.conv1", "conv", (cin, cout, 3, 1, 1)),
                     (f"{pre}.norm2", "groupnorm", (cout,)),
                     (f"{pre}.conv2", "conv", (cout, cout, 3, 1, 1))]
            if cin != cout:
                spec += [(f"{pre}.conv_shortcut", "conv", (cin, cout, 1, 1, 0))]
            cin = cout
        if i < 3:
            spec += [(f"decoder.up_blocks.{i}.upsamplers.0.conv", "conv", (cout, cout, 3, 1, 1))]
    return spec


def attention_prefixes(spec) -> list:
    return [n[: -len(".to_q")] for n, k, _ in spec if k == "linear" and n.endswith(".to_q")]


def group_conv_layers(spec) -> list:
    """The convs DGQ quantizes by group (every k x k conv but conv_in and
    conv_out, which stay unquantized), in spec order."""
    return [n for n, k, m in spec
            if k == "conv" and m[2] > 1 and n not in ("conv_in", "conv_out")]


def act_points(spec) -> list:
    """Every activation quantizer: each conv / linear input (conv_in and
    conv_out excepted) and each attention's q, k and v."""
    names = [n for n, k, _ in spec if k in ("conv", "linear") and n not in ("conv_in", "conv_out")]
    for p in attention_prefixes(spec):
        names += [f"{p}.aqtizer_q", f"{p}.aqtizer_k", f"{p}.aqtizer_v"]
    return names


def param_count(spec) -> int:
    n = 0
    for _, kind, meta in spec:
        if kind == "conv":
            cin, cout, k, _, _ = meta
            n += cin * cout * k * k + cout
        elif kind == "linear":
            cin, cout, bias = meta
            n += cin * cout + (cout if bias else 0)
        else:
            n += 2 * meta[0]
    return n
