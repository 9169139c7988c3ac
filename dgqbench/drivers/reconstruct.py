"""Driver `reconstruct`: AdaRound reconstruction of one unit through the
port's `calib.reconstruction.reconstruct_unit`, whole calls of a fixed
number of Adam steps, back to back, as `cli.quantize_weight` walks its
units (mse loss, the CLI's batch, w, warmup and learning rate).

Set-up makes the weights and the calibration samples from the seed on the
device (the sampler's input shapes and timesteps, no sampling run), takes
the unit's captures through the port's capture path (`capture_unit_io`, a
prefix forward that stops at the unit, in chunks of the CLI's capture
batch), the W4 minmax scales of the unit's layers through the port's
`init_weight_qparams`, and runs the first call, whose steps the check
follows: its key is drawn from the seed so that the rows of the steps it
compares all differ. The window then runs further calls.

Optimizer step hooks (`torch.optim.optimizer`'s global hooks) read the
port's Adam state in that first call: the offsets before step 0, the first
moment after step 1 (the first gradient is m / (1 - beta1)), the offsets
after step 3, the whole state after step `w_start` (where the regulariser
enters) and the offsets three steps later. The check:
  * capture_gap: the captures against the reference's own prefix forward of
    the same samples (float, no quantizer);
  * loss_gap: the losses of steps 0 to 2, from the reference's own scales
    and offsets, and of the three steps from the port's state at `w_start`,
    both on the port's captures;
  * grad_gap: the first gradient, update_gap: the offsets' change over each
    three steps, each by the worst leaf: |norm(program) - norm(reference)|
    over the larger of the reference leaf's norm and the median leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out (none is, for this unit's weights).
"""
from __future__ import annotations

import statistics
import time

import torch

from dgqbench import costs
from dgqbench.harness import data
from dgqbench.harness.trace import Session
from dgqbench.reference import adaround, ops, specs
from dgqbench.reference import unet as ref


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


class StepHooks:
    """Calls fn(count, optimizer) after every optimizer step while open
    (count: the steps taken so far in this optimizer's life), and
    pre(optimizer) before the first."""

    def __init__(self, fn, pre=None):
        self.fn, self.pre, self.counts = fn, pre, {}

    def __enter__(self):
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        def post(opt, args, kwargs):
            c = self.counts.get(id(opt), 0) + 1
            self.counts[id(opt)] = c
            self.fn(c, opt)

        def pre(opt, args, kwargs):
            if self.pre is not None and id(opt) not in self.counts:
                self.pre(opt)

        self.handles = [register_optimizer_step_post_hook(post),
                        register_optimizer_step_pre_hook(pre)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def _params(opt):
    return [p for g in opt.param_groups for p in g["params"]]


class Cell:
    def __init__(self, ctx):
        from dgq_tpu_torch.calib.reconstruction import capture_unit_io, recon_units
        from dgq_tpu_torch.calib.weight_calib import init_weight_qparams
        from dgq_tpu_torch.models.qconfig import QConfig
        from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply

        conf, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
        self.conf, self.tr, self.seed, self.device = conf, tr, seed, dev
        u = conf["unet"]
        self.base, self.cross = u["block_out_channels"][0], u["cross_attention_dim"]
        add_ch = u["addition_time_embed_dim"]
        depths = tuple(u["transformer_layers_per_block"][1:])
        self.spec = specs.sdxl_unet(self.base, self.cross, add_ch, depths)
        if self.spec != sdxl_unet_spec(self.base, self.cross, add_ch, depths):
            raise RuntimeError("the port's SDXL UNet layer list differs from the benchmark's")
        self.params = data.weights(self.spec, seed, "unet", dev)
        self.inputs = self._samples()
        units = recon_units(self.spec)
        self.u_idx = next(i for i, x in enumerate(units) if x.name == tr["unit"])
        self.unit = units[self.u_idx]
        self.cfg = QConfig(w_bits=conf["quant"]["w_bits"])
        layers = [e for e in self.spec if e[0] in self.unit.layers]
        self.wqp = init_weight_qparams(self.params, layers, self.cfg.w_bits)
        n, cb = tr["samples"], tr["capture_batch"]
        xs = ehs = out = None
        for s in range(0, n, cb):
            (xi, ei), oi = capture_unit_io(self.params, tuple(x[s:s + cb] for x in self.inputs),
                                           tr["unit"], self.cfg, unet_sdxl_apply)
            if xs is None:
                xs, ehs, out = (torch.empty((n,) + t.shape[1:], dtype=t.dtype, device=dev)
                                for t in (xi, ei, oi))
            xs[s:s + cb], ehs[s:s + cb], out[s:s + cb] = xi, ei, oi
        self.captures = (xs, ehs, out)
        self.key_base = data.sub_seed(seed, "recon") % 2 ** 31
        self.check_key = self._check_key()
        tokens = xs.shape[1]
        # a step: the forward, and a backward of twice its operations
        self.info = {"flops_per_step": 3 * costs.block_forward_flops(
            layers, tokens, ehs.shape[1], tr["batch"])}
        self.first = {}
        self.walls: dict = {}
        self.sessions: dict = {}

    def _samples(self):
        """prompts x Euler steps samples: N(0, 1) latents at the sampler's
        input size, the trailing Euler timesteps, each prompt's embeddings
        and pooled embedding on all of its steps, the 1024px time ids."""
        tr, dev = self.tr, self.device
        p, k = tr["prompts"], tr["euler_steps"]
        lat = tr["height"] // 8
        g = data.generator(self.seed, "samples", device=dev)
        x = torch.randn(p * k, lat, lat, 4, generator=g, device=dev)
        ehs = torch.randn(p, 77, self.cross, generator=g, device=dev).repeat_interleave(k, 0)
        pooled = torch.randn(p, 4 * self.base, generator=g, device=dev).repeat_interleave(k, 0)
        ts = torch.arange(1000, 0, -1000 / k, dtype=torch.float64).sub(1).round().float()
        t = ts.to(dev).repeat(p)
        h, w = tr["height"], tr["width"]
        ids = torch.tensor([[h, w, 0.0, 0.0, h, w]], device=dev).repeat(p * k, 1)
        return x, t, ehs, pooled, ids

    def _check_key(self) -> tuple:
        """The first key from the seed whose compared steps draw rows that
        all differ."""
        tr = self.tr
        w0 = self.w_start
        for j in range(1000):
            key = (self.key_base, self.u_idx, j)
            rows = adaround.batch_rows(key, tr["iters"], tr["batch"], tr["samples"])
            picked = [rows[:3].reshape(-1), rows[w0:w0 + 3].reshape(-1)]
            if all(len(set(r.tolist())) == r.numel() for r in picked):
                return key
        raise RuntimeError("no key draws distinct rows")

    @property
    def w_start(self) -> int:
        tr = self.tr
        return next(s for s in range(tr["iters"])
                    if adaround.regularised(s, tr["iters"], tr["warmup"]))

    def call(self, key):
        from dgq_tpu_torch.calib.reconstruction import reconstruct_unit

        tr = self.tr
        xs, ehs, out = self.captures
        _, losses = reconstruct_unit(key, self.unit, self.params, self.wqp, (xs, ehs), out,
                                     self.cfg, iters=tr["iters"], batch_size=tr["batch"],
                                     w=tr["w"], warmup=tr["warmup"], lr=tr["lr"])
        return losses

    def first_call(self):
        """The call whose steps the check follows; reads the Adam state."""
        w0, names = self.w_start, self.unit.layers
        first = self.first

        def snap(opt, what):
            return {n: opt.state[p][what].detach().clone() if what != "p" else p.detach().clone()
                    for n, p in zip(names, _params(opt))}

        def post(c, opt):
            if c == 1:
                first["m1"] = snap(opt, "exp_avg")
            if c == 3:
                first["p3"] = snap(opt, "p")
            if c == w0:
                first["pw"], first["mw"], first["vw"] = (snap(opt, "p"), snap(opt, "exp_avg"),
                                                         snap(opt, "exp_avg_sq"))
            if c == w0 + 3:
                first["pw3"] = snap(opt, "p")

        def pre(opt):
            first["p0"] = {n: p.detach().clone() for n, p in zip(names, _params(opt))}

        with StepHooks(post, pre):
            first["losses"] = self.call(self.check_key).cpu()


def setup(ctx) -> Cell:
    cell = Cell(ctx)
    cell.first_call()
    _sync(cell.device)
    return cell


def window(cell: Cell, seconds: float) -> dict:
    t0 = time.perf_counter()
    n, losses, ends = 0, [], []
    while time.perf_counter() - t0 < seconds:
        losses.append(cell.call((cell.key_base, cell.u_idx, 1000 + n)).cpu())
        n += 1
        ends.append(time.perf_counter() - t0)
    _sync(cell.device)
    t = time.perf_counter() - t0
    steps = n * cell.tr["iters"]
    failed = sum(int((~torch.isfinite(x)).sum()) for x in losses)
    return {"attempted": steps, "failed": failed, "seconds": t, "calls": n,
            "e2e": {"recon_steps_per_s": steps / t},
            "counters": {"call seconds": [b - a for a, b in zip([0.0] + ends, ends)]}}


def trace(cell: Cell) -> list:
    """Steps [s0, s1) of one call, first timed alone, then profiled, each in
    a call of its own."""
    s0, s1 = cell.tr["trace_steps"]
    for mode in ("time", "trace"):
        def post(c, opt, mode=mode):
            if c == s0:
                if mode == "trace":
                    cell.sessions["steps"] = Session("steps", s1 - s0, cell.device)
                    cell.sessions["steps"].start()
                else:
                    _sync(cell.device)
                    cell.walls["steps"] = time.perf_counter()
            elif c == s1:
                if mode == "trace":
                    cell.sessions["steps"].stop()
                else:
                    _sync(cell.device)
                    cell.walls["steps"] = time.perf_counter() - cell.walls["steps"]
        with StepHooks(post):
            cell.call((cell.key_base, cell.u_idx, 2000 if mode == "time" else 2001))
    s = cell.sessions["steps"]
    s.wall_untraced_s = cell.walls["steps"]
    return [s]


# ------------------------------------------------------------------ check ---
def _worst_leaf(prog: dict, ref_: dict, keep) -> float:
    norms = {n: float(torch.linalg.vector_norm(ref_[n].float(), dtype=torch.float64)) for n in ref_}
    med = statistics.median(norms.values())
    gaps = [abs(float(torch.linalg.vector_norm(prog[n].float(), dtype=torch.float64)) - norms[n])
            / max(norms[n], med) for n in ref_ if n in keep]
    return max(gaps)


def check(cell: Cell, control: bool = False) -> dict:
    """The numbers compared. control=True puts the reference in bfloat16 in
    the program's place."""
    tr, first = cell.tr, cell.first
    names = list(cell.unit.layers)
    xs, ehs, out = cell.captures
    bits = cell.cfg.w_bits
    heads = cell.unit.heads
    nums = {}
    with torch.no_grad(), ops.strict_f32():
        cap = 0.0
        per_head = min(64, cell.base)  # SDXL's heads are 64 wide
        m32 = ref.Model(cell.params, ref.Policy(), torch.float32, heads=lambda c: c // per_head)
        m16 = ref.Model(cell.params, ref.Policy(), torch.bfloat16, heads=lambda c: c // per_head)
        cb = tr["capture_batch"]
        for s in range(0, tr["samples"], cb):
            chunk = tuple(x[s:s + cb] for x in cell.inputs)
            rec32 = _capture(m32, chunk, tr["unit"])
            if control:
                prog = _capture(m16, chunk, tr["unit"])
            else:
                prog = ((xs[s:s + cb], ehs[s:s + cb]), out[s:s + cb])
            cap = max(cap, ops.rel_gap(prog[0][0], rec32[0][0]), ops.rel_gap(prog[1], rec32[1]))
        nums["capture_gap"] = cap
    qp = {n: ops.minmax_weight_qparams(cell.params[n]["w"], bits) for n in names}
    weights = {n: cell.params[n]["w"] for n in names}
    rows = adaround.batch_rows(cell.check_key, tr["iters"], tr["batch"], tr["samples"])
    w0 = cell.w_start

    def unit_apply(dt):
        m = ref.Model(cell.params, ref.Policy(), dt, heads=lambda c: heads)

        def apply(soft, x, e):
            m.p = {**cell.params, **{n: {"w": soft[n], "b": cell.params[n]["b"]} for n in soft}}
            return m.block(tr["unit"], x, e, heads)
        return apply

    def run(dt, start, m=None, v=None, t=0, first_step=0):
        def cast(d):
            return None if d is None else {n: a.to(dt) for n, a in d.items()}
        adam = adaround.Adam(cast(start), tr["lr"], cast(m), cast(v), t)
        losses, g = adaround.steps(unit_apply(dt), weights, qp, adam, first_step, 3, rows,
                                   (xs, ehs, out), 1, tr["iters"], tr["w"], tr["warmup"], bits, dt)
        delta = {n: adam.p[n].float() - start[n].float() for n in start}
        return losses, g, delta

    with ops.strict_f32():
        a0 = {n: adaround.init_alpha(weights[n], qp[n][0]) for n in names}
        l_ref, g_ref, d_ref = run(torch.float32, a0)
        lw_ref, _, dw_ref = run(torch.float32, first["pw"], first["mw"], first["vw"], w0, w0)
        if control:
            l_p, g_p, d_p = run(torch.bfloat16, a0)
            lw_p, _, dw_p = run(torch.bfloat16, first["pw"], first["mw"], first["vw"], w0, w0)
        else:
            losses = first["losses"]
            l_p, lw_p = losses[:3].tolist(), losses[w0:w0 + 3].tolist()
            g_p = {n: first["m1"][n] / (1 - adaround.BETAS[0]) for n in names}
            d_p = {n: first["p3"][n] - first["p0"][n] for n in names}
            dw_p = {n: first["pw3"][n] - first["pw"][n] for n in names}
    norms = {n: float(torch.linalg.vector_norm(g_ref[n], dtype=torch.float64)) for n in names}
    med = statistics.median(norms.values())
    keep = {n for n in names if norms[n] >= 1e-3 * med}
    nums["loss_gap"] = max(abs(p - r) / abs(r) for p, r in zip(l_p + lw_p, l_ref + lw_ref))
    nums["grad_gap"] = _worst_leaf(g_p, g_ref, keep)
    nums["update_gap"] = max(_worst_leaf(d_p, d_ref, keep), _worst_leaf(dw_p, dw_ref, keep))
    return nums


def _capture(m, chunk, unit):
    r = ref.Record(stop_at=unit)
    try:
        ref.sdxl_unet(m, *chunk, unit=r)
    except ref.Stop:
        pass
    return r.rec[unit]

