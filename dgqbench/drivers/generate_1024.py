"""Driver `generate_1024`: closed-loop text-to-image batches at 1024 px
through the port's pipelines, a VAE decode and uint8 images a batch (no
PNG writes), for two models (the traffic's "model"):

  * "sdxl-turbo": `SDXLTurboPipeline.generate_from_embeddings`, 4 trailing
    Euler steps, guidance 0 (the UNet at the batch itself), 4 time slots by
    the reference's map (1000 - t) // 250;
  * "sd3": `SD3Pipeline.generate_from_embeddings`, 28 flow-matching Euler
    steps (shift 3.0) with classifier-free guidance 7.0 (the MMDiT at twice
    the batch), 28 time slots, one a step.

Set-up makes the weights, the activation quantizers and the VAE from the
seed on the device (`harness.data`), folds the W4 weights through the
port's minmax fold and warms up with one batch of one step (a model call
and a decode at the window's shapes). The window runs whole batches back to
back; each batch's embeddings and initial-noise seed come from the run's
seed. The traced slice runs batches of `trace_steps` steps (the same calls
at other timesteps).

The harness wraps two names to see the timed path: the pipeline's model
field (`unet_apply`, `transformer_apply`) and the module attribute
`dgq_tpu_torch.pipeline.sd_pipeline.vae_decode`. One batch, drawn from the
seed among the first `check_batch_pool`, keeps every model call's inputs
and output and the decode's input and output for the check.

The check judges each stage from the program's own state, as `generate`'s
does (the quantized trajectory is chaotic):
  * inputs_gap (exact): the initial noise against the draw for the batch's
    seed (SDXL-turbo's scaled by sigma_0 and the Euler input scaling, as
    the sampler forms them), SD3's CFG halves, each call's timesteps;
  * euler_gap / flow_gap: each sampler update from the program's sample and
    model output (SDXL-turbo's epsilon Euler, SD3's guided flow step);
  * rerun_gap (exact): two calls drawn from the seed run again with
    `record=`, and each reconstruction unit again alone from its recorded
    inputs with the port's layer functions watched;
  * layer_gap: each layer of those units from the program's own input of
    the layer against the reference with its own W4 fold and the slot's
    quantizers: every quantized conv and linear, every norm, SD3's
    norm-modulates and the attention core (SD3's K3b joint attention in
    diffusers' key order, the start peak at key 4096: the watch hands the
    reference the program's text-first q, k, v and output rotated to it);
  * glue_gap: what lies between layers and units, formed by the reference
    from the program's outputs;
  * vae_gap: the decode from the program's final latents; image_gap
    (exact): the uint8 images from the decode's output.

The SD3 parts of the port are imported inside the SD3 cell only, so that
the SDXL-turbo cell runs on a port that has no SD3.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import numpy as np
import torch

from dgqbench import costs
from dgqbench.costs import sd3 as sd3_costs
from dgqbench.drivers import generate as gen
from dgqbench.harness import data
from dgqbench.reference import ops, sampling, specs
from dgqbench.reference import sd3 as ref3
from dgqbench.reference import unet as ref

_sync = gen._sync


class Spy(gen.Spy):
    """`generate.Spy` for a model call of any signature: `model(params, x,
    t, *args, **kw)`; a kept batch holds (x, t, args, kw, out) a call."""

    label = "unet"

    def model(self, params, x, t, *args, **kw):
        i = self.call
        self.call += 1
        c0, c1 = self.calls
        if i == c0 and c1 > c0:
            self._open(self.label, c1 - c0)
        out = self.unet_apply(params, x, t, *args, **kw)
        if i == c1 - 1:
            self._close(self.label)
        if self.mode == "keep":
            self.batch.calls.append((x, t, args, kw, out))
        return out


@contextlib.contextmanager
def _watch(rec: list, watched: dict, adapt: Optional[dict] = None):
    """Record (kind, name, inputs, output) of every call of the port's layer
    functions `watched` ({function name: kind}), as the layer functions call
    each other through the `layers` module; `adapt[kind]` turns a call's
    (inputs, output) into what the reference takes."""
    from dgq_tpu_torch.models import layers

    saved = {n: getattr(layers, n) for n in watched}

    def hooked(fn, kind):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if kind in ("linear", "conv"):
                rec.append((kind, a[2], (a[1],), out))
            elif kind == "adaln":
                rec.append((kind, None, tuple(a[:3]), out))
            elif kind == "attn":
                ins = tuple(a[:3])
                if adapt and "attn" in adapt:
                    ins, out_r = adapt["attn"](ins, out)
                else:
                    out_r = out
                rec.append((kind, None, ins, out_r))
            else:
                rec.append((kind, None, (a[1],), out))
            return out
        return call

    for n, kind in watched.items():
        setattr(layers, n, hooked(saved[n], kind))
    try:
        yield rec
    finally:
        for n, f in saved.items():
            setattr(layers, n, f)


def _group_params(act: dict, device):
    """The port's qstate {"a": ...} from {name: (delta, zp)}, stacked over
    slots: per-tensor (slots,), or (slots, n) group factors over the mid axis
    of an unfolded conv input (`mid`) or over a linear input's last axis."""
    from dgq_tpu_torch.models.qconfig import GroupQParams
    from dgq_tpu_torch.quant.affine import QParams

    out = {}
    for name, (d, z, axis) in act.items():
        if axis is None:
            out[name] = QParams(d, z)
            continue
        one = torch.ones(d.shape[0], 1, device=device)
        out[name] = (GroupQParams(d, z, one, torch.zeros_like(one)) if axis == "mid"
                     else GroupQParams(one, torch.zeros_like(one), d, z))
    return {"a": out, "sm": {}}


class Cell:
    """One run's state: the port's pipeline, what the harness made, the
    model's own parts in the subclasses."""

    label = "unet"

    def __init__(self, ctx):
        self.conf, self.tr, self.seed, self.device = ctx.config, ctx.traffic, ctx.seed, ctx.device
        self.q = self.conf["quant"]
        self.flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        self.kept: Optional[gen.Batch] = None
        self.detail: dict = {}
        g = data.generator(ctx.seed, "check", device="cpu")
        self.check_batch = int(torch.randint(0, self.tr["check_batch_pool"], (1,), generator=g))
        self.check_calls = sorted(torch.randperm(self.tr["steps"], generator=g)
                                  [:self.tr["check_calls"]].tolist())

    def _spy(self, apply):
        from dgq_tpu_torch.pipeline import sd_pipeline

        self.module = sd_pipeline
        self.spy = Spy(apply, sd_pipeline.vae_decode, self.device)
        self.spy.label = self.label
        sd_pipeline.vae_decode = self.spy.vae

    def release(self):
        """Give the pipeline back its decode and drop the port's weights."""
        self.module.vae_decode = self.spy.vae_decode
        self.pipe = self.params_q = self.qstate = None


# ------------------------------------------------------------ SDXL-turbo ---
def euler_schedule(steps: int):
    """(timesteps, sigmas) of EulerDiscreteScheduler, trailing spacing, f32
    (SDXL-turbo's scheduler/scheduler_config.json), sigmas ending in 0."""
    ac = sampling.alphas_cumprod()
    ts = (np.arange(1000, 0, -1000 / steps) - 1).round().astype(np.float32)
    sig = np.interp(ts, np.arange(1000), np.sqrt((1 - ac) / ac))
    return torch.tensor(ts), torch.tensor(np.concatenate([sig, [0.0]]).astype(np.float32))


class XLCell(Cell):
    label = "unet"

    def __init__(self, ctx):
        super().__init__(ctx)
        from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
        from dgq_tpu_torch.models.qconfig import QConfig
        from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply
        from dgq_tpu_torch.pipeline.sd_pipeline import SDXLTurboPipeline

        u, q, dev, tr = self.conf["unet"], self.q, self.device, self.tr
        base, self.cross = u["block_out_channels"][0], u["cross_attention_dim"]
        add_ch = u["addition_time_embed_dim"]
        depths = tuple(u["transformer_layers_per_block"][1:])
        self.spec = specs.sdxl_unet(base, self.cross, add_ch, depths)
        self.pooled = dict((n, m) for n, _, m in self.spec)["add_embedding.linear_1"][0] - 6 * add_ch
        if self.spec != sdxl_unet_spec(base, self.cross, add_ch, depths):
            raise RuntimeError("the port's SDXL-turbo UNet layer list differs from the benchmark's")
        self.spec_meta = {n: (k, m) for n, k, m in self.spec}
        self.head_width = min(64, base)  # heads of 64 (the port's `unet_sdxl._heads`)
        self.vae_spec = specs.vae_decoder(tr["vae"]["block_out_channels"][0])
        self.scale = tr["vae"]["scaling_factor"]
        self.groups = specs.group_conv_layers(self.spec)
        self.raw = data.weights(self.spec, self.seed, "unet", dev)
        self.vae = data.weights(self.vae_spec, self.seed, "vae", dev)
        self.act = data.act_quantizers(self.spec, q["slots"], self.seed, dev)
        self.cfg = QConfig(w_bits=q["w_bits"], a_bits=q["a_bits"], softmax_bits=q["softmax_bits"],
                           use_wq=True, use_aq=True, t2i_log_quant=q["t2i_log_quant"],
                           t2i_real_time=q["t2i_real_time"], t2i_start_peak=q["t2i_start_peak"],
                           group_conv_layers=tuple(sorted(self.groups)),
                           group_conv_impl=q["group_conv_impl"],
                           use_pallas_attention=q["use_pallas_attention"])
        self.qstate = _group_params({n: (d, z, "mid" if d.dim() == 2 else None)
                                     for n, (d, z) in self.act.items()}, dev)
        with torch.no_grad():
            self.params_q, _ = quantize_model_weights(self.raw, self.spec, self.cfg)
        self.apply = unet_sdxl_apply
        self._spy(unet_sdxl_apply)
        self.pipe = SDXLTurboPipeline(unet_params=self.params_q, vae_params=self.vae,
                                      cfg=self.cfg, qstate=self.qstate, time_aware=True,
                                      unet_apply=self.spy.model, device=dev)
        lat, b = tr["height"] // 8, tr["batch"]
        c4 = 4 * tr["vae"]["block_out_channels"][0]
        self.info = {"k2_calls": [(b, lat * lat, lat * lat, c4)],
                     "flops_per_batch": tr["steps"] * costs.unet_forward_flops(self.spec, lat, b, 77)
                     + costs.vae_decode_flops(self.vae_spec, lat, b)}

    def embeddings(self, *tag):
        b = self.tr["batch"]
        g = data.generator(self.seed, "prompts", *tag, device=self.device)
        return (torch.randn(b, 77, self.cross, generator=g, device=self.device),
                torch.randn(b, self.pooled, generator=g, device=self.device))

    def run_batch(self, *tag, steps=None):
        tr = self.tr
        ehs, pooled = self.embeddings(*tag)
        return self.pipe.generate_from_embeddings(
            ehs, pooled, steps=steps or tr["steps"], height=tr["height"], width=tr["width"],
            seed=data.sub_seed(self.seed, "noise", *tag))

    def policy(self, t) -> ref.Policy:
        q = self.q
        return ref.Policy(act=data.slot(self.act, sampling.time_slot(int(t), self.tr["steps"])),
                          a_bits=q["a_bits"], sm_bits=q["softmax_bits"],
                          log2_real_time=q["t2i_log_quant"] and q["t2i_real_time"],
                          start_peak=q["t2i_start_peak"], group_layers=frozenset(self.groups))

    def heads_of(self, channels: int) -> int:
        return channels // self.head_width

    def port_unit(self, qs, key, inputs):
        """A unit of the port alone from its recorded inputs, its layers watched."""
        from dgq_tpu_torch.models import layers

        rec: list = []
        with gen._program_precision(self), _watch(rec, gen.WATCHED):
            if ".transformer_blocks." in key:
                out = layers.basic_transformer_block(self.params_q, key, inputs[0], inputs[1],
                                                     inputs[0].shape[-1] // self.head_width,
                                                     qs, self.cfg)
            elif ".resnets." in key:
                out = layers.resnet_block(self.params_q, key, inputs[0], inputs[1], qs,
                                          self.cfg, f"{key}.conv_shortcut" in self.params_q)
            elif self.spec_meta[key][0] == "conv":
                meta = self.spec_meta[key][1]
                out = layers.quant_conv2d(self.params_q[key], inputs[0], key, qs, self.cfg,
                                          meta[3], meta[4])
            else:
                out = layers.quant_linear(self.params_q[key], inputs[0], key, qs, self.cfg)
        return rec, out

    def check(self, control: bool) -> dict:
        batch, tr = self.kept, self.tr
        ts, sig = euler_schedule(tr["steps"])
        if batch is None or len(batch.calls) != tr["steps"]:
            raise RuntimeError("the checked batch kept no whole trajectory")
        folded = gen._folded(self)
        layer_gap = glue_gap = rerun = 0.0
        with torch.no_grad():
            for c in self.check_calls:
                x_in, tt, (ehs,), kw, eps = batch.calls[c]
                qs, te, tids = kw["qstate"], kw["text_embeds"], kw["time_ids"]
                pol = self.policy(tt[0])
                if control:
                    m16 = ref.Model(folded, pol, torch.bfloat16, heads=self.heads_of)
                    r = ref.Record()
                    eps = ref.sdxl_unet(m16, x_in, tt, ehs, te, tids, r)
                    rec = r.rec
                    layers_of = lambda key, x, m16=m16: gen._control_unit(self, m16, key, x)  # noqa: E731,E501
                else:
                    rec = {}
                    out = self.apply(self.params_q, x_in, tt, ehs, text_embeds=te, time_ids=tids,
                                     qstate=qs, cfg=self.cfg, record=rec)
                    rerun = max(rerun, float((out - eps).abs().max()))
                    layers_of = lambda key, x, qs=qs: self.port_unit(qs, key, x)  # noqa: E731
                with ops.strict_f32():
                    m32 = ref.Model(folded, pol, torch.float32, heads=self.heads_of)
                    follow = ref.Follow(rec, m32, layers_of)
                    eps_ref = ref.sdxl_unet(m32, x_in, tt, ehs, te, tids, follow)
                layer_gap = max(layer_gap, max(follow.layers))
                worst = sorted(zip(follow.layers, follow.where), key=lambda g: -g[0])[:5]
                self.detail[c] = [(g, *w) for g, w in worst]
                glue_gap = max(glue_gap, max(follow.glue), ops.rel_gap(eps, eps_ref))
                rerun = max(rerun, follow.rerun)
                del rec, follow
        nums = {"layer_gap": layer_gap, "glue_gap": glue_gap}
        if not control:
            nums["rerun_gap"] = rerun
        self.release()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        b = tr["batch"]
        with torch.no_grad(), ops.strict_f32():
            g = torch.Generator(device=self.device).manual_seed(batch.seed)
            noise = torch.randn(b, tr["height"] // 8, tr["width"] // 8, 4, generator=g,
                                device=self.device)
            x0 = noise.float() * sig[0]
            x_in0 = x0.float() / torch.sqrt(sig[0].float() ** 2 + 1.0)
            gap = float((batch.calls[0][0] - x_in0).abs().max())
            for i, (_, tt, _, _, _) in enumerate(batch.calls):
                gap = max(gap, float((tt - ts[i]).abs().max()))
            if not control:
                nums["inputs_gap"] = gap
            dt = torch.bfloat16 if control else torch.float64
            xs = [x.double() * math.sqrt(float(sig[i]) ** 2 + 1.0)
                  for i, (x, _, _, _, _) in enumerate(batch.calls)] + [batch.vae_in.double()]
            ref_next = [xs[i] + batch.calls[i][4].double() * (float(sig[i + 1]) - float(sig[i]))
                        for i in range(tr["steps"])]
            prog_next = ([(xs[i].to(dt) + batch.calls[i][4].to(dt) * (float(sig[i + 1])
                                                                      - float(sig[i])))
                          for i in range(tr["steps"])] if control else xs[1:])
            nums["euler_gap"] = max(ops.rel_gap(p, r) for p, r in zip(prog_next, ref_next))
            vae_ref = ref.vae_decode(self.vae, batch.vae_in, self.scale)
            vae_prog = (ref.vae_decode(self.vae, batch.vae_in, self.scale, torch.bfloat16)
                        if control else batch.vae_out)
            nums["vae_gap"] = ops.rel_gap(vae_prog, vae_ref)
            if not control:
                nums["image_gap"] = float((ref.to_uint8(batch.vae_out).cpu().numpy()
                                           != batch.images).sum())
        return nums


# -------------------------------------------------------------------- SD3 ---
def sd3_act_quantizers(spec, sites, slots: int, seed: int, device, groups: int = 8) -> dict:
    """{name: (delta, zp)} for `slots` slots: a linear's input takes group
    factors over its in-channels ((slots, C): channel j in one of `groups`
    groups drawn from the seed, each group's delta 0.05 e^u, u uniform in
    [-0.3, 0.3], a slot and group), the joint q, k, v per tensor ((slots,),
    delta drawn so too); zero points 128."""
    cin = {n: m[0] for n, k, m in spec if k == "linear"}
    g = data.generator(seed, "act", device=device)
    out = {}
    for name in sites:
        if name in cin:
            labels = torch.randint(0, groups, (cin[name],), generator=g, device=device)
            u = torch.rand(slots, groups, generator=g, device=device)
            d = (0.05 * torch.exp(0.6 * (u - 0.5)))[:, labels]
        else:
            d = 0.05 * torch.exp(0.6 * (torch.rand(slots, generator=g, device=device) - 0.5))
        out[name] = (d, torch.full_like(d, 128.0))
    return out


class SD3Cell(Cell):
    label = "mmdit"

    def __init__(self, ctx):
        super().__init__(ctx)
        from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
        from dgq_tpu_torch.models import mmdit_sd3
        from dgq_tpu_torch.models.qconfig import QConfig
        from dgq_tpu_torch.pipeline.sd_pipeline import SD3Pipeline
        from dgq_tpu_torch.pipeline.vae import vae_decoder_spec

        t, v, q, dev, tr = (self.conf["transformer"], self.conf["vae"], self.q, self.device,
                            self.tr)
        dims = dict(layers=t["num_layers"], heads=t["num_attention_heads"],
                    head_dim=t["attention_head_dim"], in_channels=t["in_channels"],
                    patch=t["patch_size"], joint_dim=t["joint_attention_dim"],
                    pooled_dim=t["pooled_projection_dim"])
        self.spec = ref3.mmdit_spec(**dims)
        if self.spec != mmdit_sd3.mmdit_sd3_spec(**dims):
            raise RuntimeError("the port's MMDiT layer list differs from the benchmark's")
        self.vae_spec = ref3.vae_spec(v["block_out_channels"][0], v["latent_channels"])
        if self.vae_spec != vae_decoder_spec(v["block_out_channels"][0], v["latent_channels"],
                                             post_quant_conv=False):
            raise RuntimeError("the port's 16-channel VAE layer list differs from the benchmark's")
        self.layers, self.heads, self.head_dim = dims["layers"], dims["heads"], dims["head_dim"]
        self.width, self.pooled, self.joint = (self.heads * self.head_dim, dims["pooled_dim"],
                                               dims["joint_dim"])
        self.scale, self.shift = v["scaling_factor"], v["shift_factor"]
        self.sites = ref3.act_sites(self.spec)
        self.raw = data.weights(self.spec, self.seed, "mmdit", dev)
        self.vae = data.weights(self.vae_spec, self.seed, "vae", dev)
        self.act = sd3_act_quantizers(self.spec, self.sites, q["slots"], self.seed, dev,
                                      q["group_num"])
        self.cfg = QConfig(w_bits=q["w_bits"], a_bits=q["a_bits"], softmax_bits=q["softmax_bits"],
                           use_wq=True, use_aq=True, t2i_log_quant=q["t2i_log_quant"],
                           t2i_real_time=q["t2i_real_time"], t2i_start_peak=q["t2i_start_peak"],
                           use_pallas_attention=q["use_pallas_attention"])
        self.qstate = _group_params({n: (d, z, "last" if d.dim() == 2 else None)
                                     for n, (d, z) in self.act.items()}, dev)
        with torch.no_grad():
            self.params_q, _ = quantize_model_weights(self.raw, mmdit_sd3.quantized_spec(self.spec),
                                                      self.cfg)
        self.apply, self.joint_block = mmdit_sd3.mmdit_sd3_apply, mmdit_sd3.joint_block
        self.geometry = {"head_dim": self.head_dim, "sample_size": t["sample_size"],
                         "pos_embed_max_size": t["pos_embed_max_size"]}
        self._spy(mmdit_sd3.mmdit_sd3_apply)
        self.pipe = SD3Pipeline(transformer_params=self.params_q, vae_params=self.vae,
                                cfg=self.cfg, qstate=self.qstate, time_aware=True,
                                transformer_apply=self.spy.model, geometry=self.geometry,
                                device=dev)
        lat, b, text = tr["height"] // 8, tr["batch"], tr["text_tokens"]
        tokens = (lat // dims["patch"]) ** 2
        self.text = text
        c4 = 4 * v["block_out_channels"][0]
        self.info = {
            "k3b_calls": [(2 * b * self.heads, tokens + text, tokens + text, self.head_dim)]
            * self.layers,
            "k2_calls": [(b, lat * lat, lat * lat, c4)],
            "flops_per_batch": tr["steps"] * sd3_costs.mmdit_forward_flops(self.spec, tokens, text,
                                                                           2 * b)
            + costs.vae_decode_flops(self.vae_spec, lat, b)}

    def _prompt(self, g, b):
        tr = self.tr
        e = torch.randn(b, tr["text_tokens"], self.joint, generator=g, device=self.device)
        e[:, :tr["clip_tokens"], tr["clip_width"]:] = 0.0
        return e, torch.randn(b, self.pooled, generator=g, device=self.device)

    def embeddings(self, *tag):
        """(text, pooled, uncond, pooled uncond): the negative prompt one draw repeated."""
        b = self.tr["batch"]
        g = data.generator(self.seed, "prompts", *tag, device=self.device)
        text, pooled = self._prompt(g, b)
        eu, pu = self._prompt(g, 1)
        return text, pooled, eu.expand(b, -1, -1), pu.expand(b, -1)

    def run_batch(self, *tag, steps=None):
        tr = self.tr
        return self.pipe.generate_from_embeddings(
            *self.embeddings(*tag), steps=steps or tr["steps"],
            guidance_scale=tr["guidance_scale"], height=tr["height"], width=tr["width"],
            seed=data.sub_seed(self.seed, "noise", *tag))

    def policy(self, step: int) -> ref3.Policy:
        q = self.q
        return ref3.Policy(act=ref3.slot(self.act, step), a_bits=q["a_bits"],
                           sm_bits=q["softmax_bits"],
                           log2_real_time=q["t2i_log_quant"] and q["t2i_real_time"],
                           start_peak=q["t2i_start_peak"])

    def model(self, params, pol, dt):
        return ref3.MMDiT(params, pol, dt, head_dim=self.head_dim,
                          sample_size=self.geometry["sample_size"],
                          pos_max=self.geometry["pos_embed_max_size"])

    def _rotate(self, ins, out):
        """The program's text-first q, k, v and output in diffusers' order."""
        s = self.text

        def rot(x):
            return torch.cat([x[:, s:], x[:, :s]], dim=1)
        return tuple(rot(x) for x in ins), rot(out)

    def port_unit(self, qs, key, inputs):
        from dgq_tpu_torch.models import layers

        rec: list = []
        watched = {"quant_linear": "linear", "ln_modulate": "adaln", "fused_attention": "attn"}
        with gen._program_precision(self), _watch(rec, watched, {"attn": self._rotate}):
            if key.startswith("transformer_blocks."):
                last = int(key.split(".")[1]) == self.layers - 1
                x, c = self.joint_block(self.params_q, key, inputs[0], inputs[1], inputs[2],
                                        self.heads, qs, self.cfg, last)
                out = x if last else torch.cat([x, c], dim=1)
            else:
                out = layers.quant_linear(self.params_q[key], inputs[0], key, qs, self.cfg)
        return rec, out

    def control_unit(self, m16, key, inputs):
        rl = ref.RecordLayers()
        m16.layer = rl
        try:
            x = tuple(a.to(torch.bfloat16) for a in inputs)
            if key.startswith("transformer_blocks."):
                out = m16.block(key, *x, int(key.split(".")[1]) == self.layers - 1)
            else:
                out = m16.qlinear(key, x[0])
        finally:
            m16.layer = ref3.run_free_layer
        return rl.rec, out

    def check(self, control: bool) -> dict:
        batch, tr = self.kept, self.tr
        sig, ts = ref3.flow_sigmas(tr["steps"], tr["shift"])
        if batch is None or len(batch.calls) != tr["steps"]:
            raise RuntimeError("the checked batch kept no whole trajectory")
        folded = ref3.fold(self.raw, self.q["w_bits"])
        layer_gap = glue_gap = rerun = 0.0
        with torch.no_grad():
            for c in self.check_calls:
                lmi, tt, (ehs, pooled), kw, v = batch.calls[c]
                qs = kw["qstate"]
                pol = self.policy(c)
                if control:
                    m16 = self.model({n: {k: x.to(torch.bfloat16) if torch.is_tensor(x) else x
                                          for k, x in p.items()} for n, p in folded.items()},
                                     pol, torch.bfloat16)
                    r = ref.Record()
                    v = m16(lmi, tt, ehs, pooled, r)
                    rec = r.rec
                    layers_of = lambda key, x, m16=m16: self.control_unit(m16, key, x)  # noqa: E731
                else:
                    rec = {}
                    out = self.apply(self.params_q, lmi, tt, ehs, pooled, qstate=qs, cfg=self.cfg,
                                     record=rec, **self.geometry)
                    rerun = max(rerun, float((out - v).abs().max()))
                    layers_of = lambda key, x, qs=qs: self.port_unit(qs, key, x)  # noqa: E731
                with ops.strict_f32():
                    m32 = self.model(folded, pol, torch.float32)
                    follow = ref.Follow(rec, m32, layers_of)
                    v_ref = m32(lmi, tt, ehs, pooled, follow)
                layer_gap = max(layer_gap, max(follow.layers))
                worst = sorted(zip(follow.layers, follow.where), key=lambda g: -g[0])[:5]
                self.detail[c] = [(g, *w) for g, w in worst]
                glue_gap = max(glue_gap, max(follow.glue), ops.rel_gap(v, v_ref))
                rerun = max(rerun, follow.rerun)
                del rec, follow
        nums = {"layer_gap": layer_gap, "glue_gap": glue_gap}
        if not control:
            nums["rerun_gap"] = rerun
        self.release()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        b, gs = tr["batch"], tr["guidance_scale"]
        with torch.no_grad(), ops.strict_f32():
            g = torch.Generator(device=self.device).manual_seed(batch.seed)
            noise = torch.randn(b, tr["height"] // 8, tr["width"] // 8,
                                self.conf["transformer"]["in_channels"], generator=g,
                                device=self.device)
            gap = float((batch.calls[0][0][:b] - noise).abs().max())
            for i, (lmi, tt, _, _, _) in enumerate(batch.calls):
                gap = max(gap, float((lmi[:b] - lmi[b:]).abs().max()),
                          float((tt - ts[i]).abs().max()))
            if not control:
                nums["inputs_gap"] = gap
            xs = [lmi[:b] for lmi, _, _, _, _ in batch.calls] + [batch.vae_in]

            def step(i, dt):
                v_u, v_c = batch.calls[i][4].to(dt).chunk(2, dim=0)
                return xs[i].to(dt) + (float(sig[i + 1]) - float(sig[i])) * (v_u + gs * (v_c - v_u))

            ref_next = [step(i, torch.float64) for i in range(tr["steps"])]
            prog_next = ([step(i, torch.bfloat16) for i in range(tr["steps"])] if control
                         else xs[1:])
            nums["flow_gap"] = max(ops.rel_gap(p, r) for p, r in zip(prog_next, ref_next))
            vae_ref = ref3.vae_decode(self.vae, batch.vae_in, self.scale, self.shift)
            vae_prog = (ref3.vae_decode(self.vae, batch.vae_in, self.scale, self.shift,
                                        torch.bfloat16) if control else batch.vae_out)
            nums["vae_gap"] = ops.rel_gap(vae_prog, vae_ref)
            if not control:
                nums["image_gap"] = float((ref3.to_uint8(batch.vae_out).cpu().numpy()
                                           != batch.images).sum())
        return nums


# ---------------------------------------------------------------- driver ---
CELLS = {"sdxl-turbo": XLCell, "sd3": SD3Cell}
COUNTERS = {"sdxl-turbo": ("rt_stats", "quant_accum", "group_quant_conv", "flash_attention"),
            "sd3": ("rt_stats", "quant_accum", "flash_attention", "fake_quant")}


def setup(ctx) -> Cell:
    cell = CELLS[ctx.traffic["model"]](ctx)
    cell.run_batch("warmup", steps=1)
    _sync(cell.device)
    return cell


def window(cell: Cell, seconds: float) -> dict:
    from dgq_tpu_torch.ops import attention, group_conv

    counted = [attention, group_conv]
    if cell.tr["model"] == "sd3":
        from dgq_tpu_torch.ops import fake_quant

        counted.append(fake_quant)
    for m in counted:
        m.reset_launch_counts()
    cell.spy.finite.clear()
    t0 = time.perf_counter()
    n, ends = 0, []
    while time.perf_counter() - t0 < seconds:
        if cell.kept is None or n <= cell.check_batch:
            cell.kept = gen.Batch(seed=data.sub_seed(cell.seed, "noise", "window", n))
            cell.spy.begin("keep", cell.kept)
        else:
            cell.spy.begin("off")
        images = cell.run_batch("window", n)
        if cell.spy.mode == "keep":
            cell.kept.images = images
        n += 1
        ends.append(time.perf_counter() - t0)
    _sync(cell.device)
    t = time.perf_counter() - t0
    cell.spy.begin("off")
    counts = {k: v for m in counted for k, v in m.LAUNCHES.items()}
    per_batch = {k: counts[k] / n for k in COUNTERS[cell.tr["model"]]}
    failed = sum(int(not bool(f)) for f in cell.spy.finite) * cell.tr["batch"]
    return {"attempted": n * cell.tr["batch"], "failed": failed, "seconds": t, "batches": n,
            "e2e": {"images_per_s": n * cell.tr["batch"] / t},
            "counters": {"launches per batch": per_batch,
                         "batch seconds": [b - a for a, b in zip([0.0] + ends, ends)]}}


def trace(cell: Cell) -> list:
    """Model calls [c0, c1) and the decode of a batch of `trace_steps`
    steps, first timed alone, then profiled, each on a batch of its own."""
    c, steps = cell.tr["trace_calls"], cell.tr["trace_steps"]
    cell.spy.begin("time", calls=c)
    cell.run_batch("trace", 0, steps=steps)
    cell.spy.begin("trace", calls=c)
    cell.run_batch("trace", 1, steps=steps)
    cell.spy.begin("off")
    out = [cell.spy.sessions[cell.label], cell.spy.sessions["vae"]]
    for s in out:
        s.wall_untraced_s = cell.spy.walls[s.label]
    return out


def check(cell: Cell, control: bool = False) -> dict:
    """The numbers compared, from the kept batch. control=True puts the
    reference in bfloat16 in the program's place (and leaves out the
    numbers that only the program has: inputs_gap, rerun_gap, image_gap)."""
    return cell.check(control)
