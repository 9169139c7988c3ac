"""Driver `generate`: closed-loop text-to-image batches through the port's
`SDPipeline.generate_from_embeddings`, as `cli.gen4eval` runs them for the
paper's tables (PNDM with classifier-free guidance, a VAE decode a batch,
uint8 images; no PNG writes).

Set-up makes the weights, the activation quantizers and the VAE from the
seed on the device, folds the W4 weights through the port's minmax fold and
warms up with one short batch (2 PNDM steps: 3 UNet calls and a decode at
the window's shapes). The window runs whole batches back to back; each
batch's prompt embeddings and initial-noise seed come from the run's seed.

The harness wraps two names to see the timed path: the pipeline's
`unet_apply` (a field of `SDPipeline`) and the module attribute
`dgq_tpu_torch.pipeline.sd_pipeline.vae_decode`. One batch, drawn from the
seed among the first three, keeps every UNet call's inputs and output and
the decode's input and output for the check.

The check follows the program's own state, because the quantized
trajectory is chaotic (a 1e-6 change of the latents moves the first eps by
a tenth): it cannot hold a whole trajectory against a reference, so it
judges each stage from the program's inputs at that stage:
  * inputs_gap (exact): the batch's initial noise against the draw for its
    seed, each call's CFG halves and timesteps;
  * pndm_gap: every PLMS update, from the program's sample and eps history;
  * rerun_gap (exact): two calls drawn from the seed run again through the
    port's UNet with `record=`, and each of their reconstruction units
    (resnets, transformer blocks, lone convs and linears) again alone from
    its recorded inputs with the port's layer functions watched; each must
    give the window's output bit for bit, so that what is compared next is
    what the window computed;
  * layer_gap: each layer of those units (every quantized conv and linear,
    K5 inside the k x k convs, every norm, the K3b attention core) from the
    program's own input of the layer, against the reference with its own W4
    fold and the time slot's quantizers. Not the units' outputs: a
    transformer block is chaotic by itself (a 1e-7 change of its input
    moves its output by 0.7% to 2.5%, in the port and in the reference
    alike), a layer is not;
  * glue_gap: what lies between layers and units (the activation
    quantizers of q, k and v, residuals, GEGLU's gate, conv_in, the time
    embedding, the transformer's norm, skips, upsampling, conv_out and the
    eps), formed by the reference from the program's outputs;
  * vae_gap: the decode (K2 in its mid attention) from the program's final
    latents; image_gap (exact): the uint8 images from the decode's output.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from dgqbench import costs
from dgqbench.harness import data
from dgqbench.harness.trace import Session
from dgqbench.reference import ops, sampling, specs
from dgqbench.reference import unet as ref

PORT_COUNTERS = ("rt_stats", "quant_accum", "group_quant_conv", "flash_attention")


@dataclasses.dataclass
class Batch:
    """What one batch keeps for the check."""
    seed: int
    calls: list = dataclasses.field(default_factory=list)  # (lmi, tt, qstate, eps)
    ehs: Optional[torch.Tensor] = None
    vae_in: Optional[torch.Tensor] = None
    vae_out: Optional[torch.Tensor] = None
    images: Optional[object] = None


class Spy:
    """The harness's wrappers of the UNet call and the decode. mode "off"
    passes through; "keep" fills `batch`; "time" and "trace" time or profile
    UNet calls [c0, c1) and the decode of one batch."""

    def __init__(self, unet_apply, vae_decode, device):
        self.unet_apply, self.vae_decode, self.device = unet_apply, vae_decode, device
        self.mode, self.calls, self.call = "off", (0, 0), 0
        self.batch: Optional[Batch] = None
        self.finite: list = []
        self.walls: dict = {}
        self.sessions: dict = {}

    def begin(self, mode: str, batch: Optional[Batch] = None, calls=(0, 0)):
        self.mode, self.batch, self.calls, self.call = mode, batch, tuple(calls), 0

    def _open(self, label, units):
        if self.mode == "trace":
            self.sessions[label] = Session(label, units, self.device)
            self.sessions[label].start()
        elif self.mode == "time":
            _sync(self.device)
            self.walls[label] = time.perf_counter()

    def _close(self, label):
        if self.mode == "trace":
            self.sessions[label].stop()
        elif self.mode == "time":
            _sync(self.device)
            self.walls[label] = time.perf_counter() - self.walls[label]

    def unet(self, params, lmi, tt, ehs, qstate=None, cfg=None):
        i = self.call
        self.call += 1
        c0, c1 = self.calls
        if i == c0 and c1 > c0:
            self._open("unet", c1 - c0)
        eps = self.unet_apply(params, lmi, tt, ehs, qstate=qstate, cfg=cfg)
        if i == c1 - 1:
            self._close("unet")
        if self.mode == "keep":
            self.batch.ehs = ehs
            self.batch.calls.append((lmi, tt, qstate, eps))
        return eps

    def vae(self, params, latents, *args, **kw):
        self._open("vae", 1)
        out = self.vae_decode(params, latents, *args, **kw)
        self._close("vae")
        self.finite.append(torch.isfinite(out).all())
        if self.mode == "keep":
            self.batch.vae_in, self.batch.vae_out = latents, out
        return out


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


# the port's layer functions the check watches, by the reference's kind
WATCHED = {"quant_linear": "linear", "quant_conv2d": "conv", "group_norm": "gn",
           "layer_norm": "ln", "fused_attention": "attn"}


@contextlib.contextmanager
def watch_layers(rec: list):
    """Record (kind, name, inputs, output) of every call of the port's layer
    functions, as `models.layers`' own functions call them, in call order."""
    from dgq_tpu_torch.models import layers

    saved = {n: getattr(layers, n) for n in WATCHED}

    def hooked(fn, kind):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if kind in ("linear", "conv"):
                rec.append((kind, a[2], (a[1],), out))
            elif kind == "attn":
                rec.append((kind, None, tuple(a[:3]), out))
            else:
                rec.append((kind, None, (a[1],), out))
            return out
        return call

    for n, kind in WATCHED.items():
        setattr(layers, n, hooked(saved[n], kind))
    try:
        yield rec
    finally:
        for n, f in saved.items():
            setattr(layers, n, f)


class Cell:
    """One run's state: the port's pipeline and what the harness made."""

    def __init__(self, ctx):
        from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
        from dgq_tpu_torch.models.qconfig import GroupQParams, QConfig
        from dgq_tpu_torch.models.unet_sd import sd_unet_spec, unet_sd_apply
        from dgq_tpu_torch.pipeline import sd_pipeline
        from dgq_tpu_torch.pipeline.sd_pipeline import SDPipeline
        from dgq_tpu_torch.quant.affine import QParams

        conf, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.conf, self.tr, self.seed, self.device = conf, tr, ctx.seed, dev
        u, q = conf["unet"], conf["quant"]
        self.base, self.cross = u["block_out_channels"][0], u["cross_attention_dim"]
        self.spec = specs.sd_unet(self.base, self.cross)
        self.spec_meta = {n: (k, m) for n, k, m in self.spec}
        if self.spec != sd_unet_spec(base=self.base, cross=self.cross):
            raise RuntimeError("the port's SD UNet layer list differs from the benchmark's")
        self.vae_spec = specs.vae_decoder(conf["vae"]["block_out_channels"][0])
        self.groups = specs.group_conv_layers(self.spec)
        self.q = q
        self.raw = data.weights(self.spec, ctx.seed, "unet", dev)
        self.vae = data.weights(self.vae_spec, ctx.seed, "vae", dev)
        self.act = data.act_quantizers(self.spec, q["slots"], ctx.seed, dev)
        self.cfg = QConfig(w_bits=q["w_bits"], a_bits=q["a_bits"], softmax_bits=q["softmax_bits"],
                           use_wq=True, use_aq=True, t2i_log_quant=q["t2i_log_quant"],
                           t2i_real_time=q["t2i_real_time"], t2i_start_peak=q["t2i_start_peak"],
                           group_conv_layers=tuple(sorted(self.groups)),
                           group_conv_impl=q["group_conv_impl"],
                           use_pallas_attention=q["use_pallas_attention"])
        a = {}
        for name, (d, z) in self.act.items():
            if d.dim() == 2:
                one = torch.ones(d.shape[0], 1, device=dev)
                a[name] = GroupQParams(d, z, one, torch.zeros_like(one))
            else:
                a[name] = QParams(d, z)
        self.qstate = {"a": a, "sm": {}}
        with torch.no_grad():
            self.params_q, _ = quantize_model_weights(self.raw, self.spec, self.cfg)
        self.unet_sd_apply = unet_sd_apply
        self.flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        self.module = sd_pipeline
        self.spy = Spy(unet_sd_apply, sd_pipeline.vae_decode, dev)
        sd_pipeline.vae_decode = self.spy.vae
        self.pipe = SDPipeline(unet_params=self.params_q, vae_params=self.vae, cfg=self.cfg,
                               qstate=self.qstate, time_aware=True, unet_apply=self.spy.unet,
                               device=dev)
        g = data.generator(ctx.seed, "check", device="cpu")
        pool = tr["check_batch_pool"]
        self.check_batch = int(torch.randint(0, pool, (1,), generator=g))
        calls = len(sampling.pndm_calls(tr["steps"]))
        self.check_calls = sorted(torch.randperm(calls, generator=g)[:tr["check_calls"]].tolist())
        self.kept: Optional[Batch] = None
        self.detail: dict = {}  # the check's largest layer gaps a call, for readings
        self.info = self._info()

    def _info(self) -> dict:
        tr, b = self.tr, 2 * self.tr["batch"]
        lat = self.tr["height"] // 8
        heads = self.conf["unet"]["attention_head_dim"]
        attn, convs = [], []
        conv_meta = {n: m for n, k, m in self.spec if k == "conv"}
        for pre in specs.attention_prefixes(self.spec):
            h = costs.feature_side(pre, lat, 3)
            c = next(m[1] for n, k, m in self.spec if n == f"{pre}.to_q")
            t = h * h
            attn.append((b * heads, t, t if pre.endswith("attn1") else 77, c // heads))
        for n in self.groups:
            cin, cout, k, stride, pad = conv_meta[n]
            if stride == 1:
                h = costs.feature_side(n, lat, 3)
                convs.append((b, h, h, cin, cout, k, pad))
        calls = len(sampling.pndm_calls(tr["steps"]))
        c4 = 4 * self.conf["vae"]["block_out_channels"][0]
        return {
            "k3b_calls": attn, "k5_calls": convs,
            "k2_calls": [(tr["batch"], lat * lat, lat * lat, c4)],  # one head of width 4 x base
            "flops_per_batch": calls * costs.unet_forward_flops(self.spec, lat, b, 77)
            + costs.vae_decode_flops(self.vae_spec, lat, tr["batch"])}

    def embeddings(self, *tag):
        """One batch's (text, uncond) embeddings, (B, 77, cross): uncond one
        draw repeated, as a pipeline's empty prompt."""
        b = self.tr["batch"]
        g = data.generator(self.seed, "prompts", *tag, device=self.device)
        text = torch.randn(b, 77, self.cross, generator=g, device=self.device)
        uncond = torch.randn(1, 77, self.cross, generator=g, device=self.device).expand(b, 77, -1)
        return text, uncond

    def run_batch(self, *tag, steps=None):
        tr = self.tr
        text, uncond = self.embeddings(*tag)
        return self.pipe.generate_from_embeddings(
            text, uncond, steps=steps or tr["steps"], scheduler=tr["scheduler"],
            guidance_scale=tr["guidance_scale"], height=tr["height"], width=tr["width"],
            seed=data.sub_seed(self.seed, "noise", *tag))

    def release(self):
        """Give the pipeline back its decode and drop the port's weights."""
        self.module.vae_decode = self.spy.vae_decode
        self.pipe = self.params_q = self.qstate = None


def setup(ctx) -> Cell:
    cell = Cell(ctx)
    cell.run_batch("warmup", steps=2)
    _sync(cell.device)
    return cell


def window(cell: Cell, seconds: float) -> dict:
    from dgq_tpu_torch.ops import attention, group_conv

    attention.reset_launch_counts()
    group_conv.reset_launch_counts()
    cell.spy.finite.clear()
    t0 = time.perf_counter()
    n, ends = 0, []
    while time.perf_counter() - t0 < seconds:
        if cell.kept is None or n <= cell.check_batch:
            cell.kept = Batch(seed=data.sub_seed(cell.seed, "noise", "window", n))
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
    counts = {**attention.LAUNCHES, **group_conv.LAUNCHES}
    per_batch = {k: counts[k] / n for k in PORT_COUNTERS}
    failed = sum(int(not bool(f)) for f in cell.spy.finite) * cell.tr["batch"]
    return {"attempted": n * cell.tr["batch"], "failed": failed, "seconds": t, "batches": n,
            "e2e": {"images_per_s": n * cell.tr["batch"] / t},
            "counters": {"launches per batch": per_batch,
                         "batch seconds": [b - a for a, b in zip([0.0] + ends, ends)]}}


def trace(cell: Cell) -> list:
    """UNet calls [c0, c1) and the decode of one batch, first timed alone,
    then profiled, each on a batch of its own."""
    c = cell.tr["trace_calls"]
    cell.spy.begin("time", calls=c)
    cell.run_batch("trace", 0)
    cell.spy.begin("trace", calls=c)
    cell.run_batch("trace", 1)
    cell.spy.begin("off")
    out = [cell.spy.sessions["unet"], cell.spy.sessions["vae"]]
    for s in out:
        s.wall_untraced_s = cell.spy.walls[s.label]
    return out


# ------------------------------------------------------------------ check ---
def _policy(cell: Cell, t: int) -> ref.Policy:
    q = cell.q
    return ref.Policy(act=data.slot(cell.act, sampling.time_slot(t, cell.tr["steps"])),
                      a_bits=q["a_bits"], sm_bits=q["softmax_bits"],
                      log2_real_time=q["t2i_log_quant"] and q["t2i_real_time"],
                      start_peak=q["t2i_start_peak"], group_layers=frozenset(cell.groups))


def _folded(cell: Cell) -> dict:
    out = {}
    for name, kind, _ in cell.spec:
        p = cell.raw[name]
        if kind in ("conv", "linear") and name not in ("conv_in", "conv_out"):
            p = {"w": ops.fold_weight(p["w"], cell.q["w_bits"]), "b": p["b"]}
        out[name] = p
    return out


def _pndm(cell: Cell, batch: Batch, dt):
    """The samples the PLMS updates give from the program's samples and eps:
    the (i + 1)-th sample from the i-th."""
    tr = cell.tr
    plms, b, out = sampling.PLMS(tr["steps"]), tr["batch"], []
    for t, (lmi, _, _, eps) in zip(sampling.pndm_calls(tr["steps"]), batch.calls):
        e = sampling.guided(eps.to(dt), tr["guidance_scale"])
        out.append(plms.step(e, t, lmi[:b].to(dt)))
    return out


@contextlib.contextmanager
def _program_precision(cell: Cell):
    """The TF32 settings the window ran under, inside the reference's."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cell.flags
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _port_unit(cell: Cell, qs, key, inputs):
    """A unit of the port alone from its recorded inputs, its layers watched."""
    from dgq_tpu_torch.models import layers

    rec: list = []
    with _program_precision(cell), watch_layers(rec):
        if ".transformer_blocks." in key:
            out = layers.basic_transformer_block(cell.params_q, key, inputs[0], inputs[1],
                                                 cell.conf["unet"]["attention_head_dim"], qs,
                                                 cell.cfg)
        elif ".resnets." in key:
            out = layers.resnet_block(cell.params_q, key, inputs[0], inputs[1], qs, cell.cfg,
                                      f"{key}.conv_shortcut" in cell.params_q)
        elif cell.spec_meta[key][0] == "conv":
            meta = cell.spec_meta[key][1]
            out = layers.quant_conv2d(cell.params_q[key], inputs[0], key, qs, cell.cfg,
                                      meta[3], meta[4])
        else:
            out = layers.quant_linear(cell.params_q[key], inputs[0], key, qs, cell.cfg)
    return rec, out


def _control_unit(cell: Cell, m16, key, inputs):
    """The same for the control: the reference in bfloat16, its layers recorded."""
    rl = ref.RecordLayers()
    m16.layer = rl
    try:
        out = m16.run_unit(key, tuple(x.to(torch.bfloat16) for x in inputs), cell.spec_meta)
    finally:
        m16.layer = ref.run_free_layer
    return rl.rec, out


def check(cell: Cell, control: bool = False) -> dict:
    """The numbers compared, from the kept batch. control=True puts the
    reference in bfloat16 in the program's place (and leaves out the
    numbers that only the program has: inputs_gap, rerun_gap, image_gap)."""
    batch, tr = cell.kept, cell.tr
    calls = sampling.pndm_calls(tr["steps"])
    if batch is None or len(batch.calls) != len(calls):
        raise RuntimeError("the checked batch kept no whole trajectory")
    b, nums = tr["batch"], {}
    heads = cell.conf["unet"]["attention_head_dim"]
    folded = _folded(cell)
    layer_gap = glue_gap = rerun = 0.0
    with torch.no_grad():
        for c in cell.check_calls:
            lmi, tt, qs, eps = batch.calls[c]
            pol = _policy(cell, calls[c])
            if control:
                m16 = ref.Model(folded, pol, torch.bfloat16, heads=lambda _c: heads)
                r = ref.Record()
                eps = ref.sd_unet(m16, lmi, tt, batch.ehs, r)
                rec = r.rec
                layers_of = lambda key, x, m16=m16: _control_unit(cell, m16, key, x)  # noqa: E731
            else:
                rec = {}
                out = cell.unet_sd_apply(cell.params_q, lmi, tt, batch.ehs, qstate=qs,
                                         cfg=cell.cfg, record=rec)
                rerun = max(rerun, float((out - eps).abs().max()))
                layers_of = lambda key, x, qs=qs: _port_unit(cell, qs, key, x)  # noqa: E731
            with ops.strict_f32():
                m32 = ref.Model(folded, pol, torch.float32, heads=lambda _c: heads)
                follow = ref.Follow(rec, m32, layers_of)
                eps_ref = ref.sd_unet(m32, lmi, tt, batch.ehs, follow)
            layer_gap = max(layer_gap, max(follow.layers))
            worst = sorted(zip(follow.layers, follow.where), key=lambda g: -g[0])[:5]
            cell.detail[c] = [(g, *w) for g, w in worst]
            glue_gap = max(glue_gap, max(follow.glue), ops.rel_gap(eps, eps_ref))
            rerun = max(rerun, follow.rerun)
            del rec, follow
    nums["layer_gap"], nums["glue_gap"] = layer_gap, glue_gap
    if not control:
        nums["rerun_gap"] = rerun
    cell.release()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad(), ops.strict_f32():
        noise = sampling.initial_latents(b, tr["height"], tr["width"], batch.seed, cell.device)
        gap = float((batch.calls[0][0][:b] - noise).abs().max())
        for t, (lmi, tt, _, _) in zip(calls, batch.calls):
            gap = max(gap, float((lmi[:b] - lmi[b:]).abs().max()), float((tt - t).abs().max()))
        if not control:
            nums["inputs_gap"] = gap
        nexts = [lmi[:b] for lmi, _, _, _ in batch.calls[1:]] + [batch.vae_in]
        ref_next = _pndm(cell, batch, torch.float32)
        prog_next = _pndm(cell, batch, torch.bfloat16) if control else nexts
        nums["pndm_gap"] = max(ops.rel_gap(p, r) for p, r in zip(prog_next, ref_next))
        scale = cell.conf["vae"]["scaling_factor"]
        vae_ref = ref.vae_decode(cell.vae, batch.vae_in, scale)
        vae_prog = (ref.vae_decode(cell.vae, batch.vae_in, scale, torch.bfloat16) if control
                    else batch.vae_out)
        nums["vae_gap"] = ops.rel_gap(vae_prog, vae_ref)
        if not control:
            images = ref.to_uint8(batch.vae_out).cpu().numpy()
            nums["image_gap"] = float((images != batch.images).sum())
    return nums
