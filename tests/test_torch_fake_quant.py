"""The one-launch activation fake quantizer (`ops/fake_quant.py`,
`csrc/fake_quant.cu`) and `models.qconfig.aq_apply`'s dispatch to it.

On the CPU (no card; these count in the suite): the dispatch rule
`kernel_rule` case by case, plain and group parameters; `aq_apply` run as on a card (the rule told the
device is "cuda") sends CPU-bound work of every kind the kernel does not take
to `quant.affine.fake_quant`'s chain, bit for bit the former `aq_apply`,
and the kinds it takes to the launch (there the plain version stands in);
start rows against the former `torch.cat`; `fused_fake_quant` refuses, before
any launch, what the kernel does not take; the module imports without `nvcc`.

Marked `cuda` (they skip without a card; a CUDA kernel has no CPU mode): the
kernel bit for bit against the plain chain on the card (`torch.equal` on the
bits), f32 and bf16, one value or a vector over the last axis (fresh, a time
slot's view, a strided view) or a group quantizer's factors over the rows
and the columns, contiguous, permuted (b, h, t, d), the
`[..., 1:, :]` slice and misaligned inputs, ragged sizes and an empty tensor,
crafted ties, clip bounds, +-0, +-inf and NaN; start rows against
`torch.cat`; a contiguous output; one launch a call; and a tiny SD UNet
under the g=8 benchmark policy, and under a group state on every linear and
attention quantizer (as `quantize_act --group_num` calibrates it), whose
every quantizer takes the kernel, with the chain's bits. Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_fake_quant.py -q
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dgq_tpu_torch.models import layers
from dgq_tpu_torch.models import qconfig as Q
from dgq_tpu_torch.models.qconfig import GroupQParams, QConfig, TapCollector, collect_act_taps
from dgq_tpu_torch.ops import fake_quant as FQ
from dgq_tpu_torch.quant.affine import QParams, fake_quant

F32, BF16 = torch.float32, torch.bfloat16
ONE = ((F32, ()), (F32, ()))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case, args, takes", [
    ("f32 per tensor", ("cuda", F32, False, (8, 4096, 320), ONE), True),
    ("bf16 per tensor", ("cuda", BF16, False, (8, 4096, 320), ONE), True),
    ("permuted q", ("cuda", F32, False, (8, 8, 4096, 40), ONE), True),
    ("rank 1", ("cuda", F32, False, (77,), ONE), True),
    ("last-axis vector", ("cuda", F32, False, (2, 7, 40), ((F32, (40,)), (F32, (40,)))), True),
    ("(1, C) vector", ("cuda", F32, False, (2, 7, 40), ((F32, (1, 40)), (F32, (1, 40)))), True),
    ("(1,) one value", ("cuda", F32, False, (2, 7, 40), ((F32, (1,)), (F32, ()))), True),
    ("CPU tensor", ("cpu", F32, False, (8, 4096, 320), ONE), False),
    ("gradient wanted", ("cuda", F32, True, (8, 4096, 320), ONE), False),
    ("f16 input", ("cuda", torch.float16, False, (8, 4096, 320), ONE), False),
    ("f64 input", ("cuda", torch.float64, False, (8, 4096, 320), ONE), False),
    ("rank 0", ("cuda", F32, False, (), ONE), False),
    ("rank 5", ("cuda", F32, False, (2, 2, 2, 2, 2), ONE), False),
    ("2^31 elements", ("cuda", F32, False, (2 ** 16, 2 ** 15), ONE), False),
    ("bf16 delta", ("cuda", F32, False, (2, 7, 40), ((BF16, ()), (F32, ()))), False),
    ("f64 zero point", ("cuda", F32, False, (2, 7, 40), ((F32, ()), (torch.float64, ()))), False),
    ("(C, 1) broadcast", ("cuda", F32, False, (2, 7, 40), ((F32, (7, 1)), (F32, (7, 1)))), False),
    ("other last size", ("cuda", F32, False, (2, 7, 40), ((F32, (8,)), (F32, (8,)))), False),
    ("params of higher rank", ("cuda", F32, False, (40,), ((F32, (1, 40)), (F32, (1, 40)))),
     False),
])
def test_kernel_rule(case, args, takes):
    assert FQ.kernel_rule(*args) is takes, case


ROWS, COLS, ONE_1 = ((F32, (7,)),) * 2, ((F32, (40,)),) * 2, ((F32, (1,)),) * 2


@pytest.mark.parametrize("case, shape, last, mid, start_rows, takes", [
    ("rows", (2, 7, 40), ONE_1, ROWS, 0, True),
    ("columns", (2, 7, 40), COLS, ONE_1, 0, True),
    ("rows and columns", (2, 7, 40), COLS, ROWS, 0, True),
    ("0-d factors", (2, 7, 40), ONE, ONE, 0, True),
    ("rows after the start row", (2, 8, 40), ONE_1, ROWS, 1, True),
    ("rows counting the start row", (2, 7, 40), ONE_1, ROWS, 1, False),
    ("other rows", (2, 9, 40), ONE_1, ROWS, 0, False),
    ("2-d rows", (2, 7, 40), ONE_1, ((F32, (7, 1)),) * 2, 0, False),
    ("2-d columns", (2, 7, 40), ((F32, (1, 40)),) * 2, ONE_1, 0, False),
    ("bf16 rows", (2, 7, 40), ONE_1, ((BF16, (7,)), (F32, (7,))), 0, False),
    ("rank 1", (40,), COLS, ONE_1, 0, False),
])
def test_kernel_rule_group(case, shape, last, mid, start_rows, takes):
    assert FQ.kernel_rule("cuda", F32, False, shape, last, mid, start_rows) is takes, case


def _old_aq_apply(qstate, cfg, name, x):
    """`aq_apply` before the kernel: the chain for every quantizer."""
    qp = qstate["a"][name]
    if isinstance(qp, GroupQParams):
        mid = (1,) * (x.dim() - 2) + (-1, 1)
        last = (1,) * (x.dim() - 1) + (-1,)
        delta = qp.delta_mid.reshape(mid) * qp.delta_last.reshape(last)
        zp = qp.zp_mid.reshape(mid) + qp.zp_last.reshape(last)
        return fake_quant(x, QParams(delta, zp), cfg.a_bits)
    delta, zp = qp.delta, qp.zero_point
    if 0 < delta.dim() < x.dim():
        shape = (1,) * (x.dim() - delta.dim()) + tuple(delta.shape)
        delta = delta.reshape(shape)
        zp = zp.reshape(shape)
    return fake_quant(x, QParams(delta, zp), cfg.a_bits)


@pytest.fixture
def as_on_a_card(monkeypatch):
    """aq_apply's rule told the device is "cuda" (the other terms as they
    are), and its launches recorded and run by the plain version, the
    kernel's stand-in on the CPU."""
    rule, calls = FQ.kernel_rule, []
    monkeypatch.setattr(FQ, "kernel_rule", lambda _dev, *a: rule("cuda", *a))

    def recorded(x, delta, zp, bits, start_rows=0, mid=None, checked=False):
        assert checked  # aq_apply has seen kernel_takes hold
        calls.append(x.shape)
        return FQ.fused_fake_quant_reference(x, delta, zp, bits, start_rows, mid)

    monkeypatch.setattr(FQ, "fused_fake_quant", recorded)
    return calls


def _case(kind):
    g = torch.Generator().manual_seed(5)
    x = 0.3 * torch.randn(2, 6, 16, generator=g)
    d = 0.02 + 0.01 * torch.rand(16, generator=g)
    z = torch.round(100.0 + 50.0 * torch.rand(16, generator=g))
    qp = QParams(torch.tensor(0.021), torch.tensor(128.0))
    if kind == "group":
        qp = GroupQParams(d[:6], z[:6], torch.ones(1), torch.zeros(1))
    elif kind == "group columns":
        qp = GroupQParams(torch.ones(1), torch.zeros(1), d, z)
    elif kind == "group bf16":
        qp = GroupQParams(d[:6].bfloat16(), z[:6], torch.ones(1), torch.zeros(1))
    elif kind == "broadcast":
        qp = QParams(d[:6].reshape(6, 1), z[:6].reshape(6, 1))
    elif kind == "f16 input":
        x = x.half()
    elif kind == "grad":
        x.requires_grad_(True)
    elif kind == "bf16 per tensor":
        x = x.bfloat16()
    elif kind == "vector":
        qp = QParams(d, z)
    return x, qp


@pytest.mark.parametrize("kind, kernel", [
    ("group bf16", False), ("broadcast", False), ("f16 input", False), ("grad", False),
    ("per tensor", True), ("bf16 per tensor", True), ("vector", True), ("group", True),
    ("group columns", True),
])
def test_aq_apply_dispatch_keeps_the_chains_bits(as_on_a_card, kind, kernel):
    x, qp = _case(kind)
    cfg = QConfig(use_aq=True)
    qstate = {"a": {"p": qp}}
    before = dict(FQ.LAUNCHES)
    out = Q.aq_apply(qstate, cfg, "p", x)
    assert len(as_on_a_card) == int(kernel)
    ref = _old_aq_apply(qstate, cfg, "p", x)
    assert _same_bits(out.detach().float(), ref.detach().float()) and out.dtype == ref.dtype
    if kind == "grad":
        out.sum().backward()
        g = x.grad.clone()
        x.grad = None
        ref.sum().backward()
        assert torch.equal(g, x.grad)
    # CPU tensors count toward neither: the counters are the card's
    assert FQ.LAUNCHES == before


def test_aq_apply_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    monkeypatch.setattr(FQ, "fused_fake_quant", None)  # a call would raise
    x, qp = _case("per tensor")
    out = Q.aq_apply({"a": {"p": qp}}, QConfig(use_aq=True), "p", x)
    assert _same_bits(out, _old_aq_apply({"a": {"p": qp}}, QConfig(use_aq=True), "p", x))


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("kind", ["per tensor", "vector", "bf16 per tensor", "group"])
def test_start_rows_equal_the_former_cat(monkeypatch, as_on_a_card, kind, kernel):
    if not kernel:
        monkeypatch.setattr(FQ, "kernel_rule", lambda *a: False)
    x, qp = _case(kind)
    x = x.reshape(2, 6, 2, 8).permute(0, 2, 1, 3)  # (b, h, t, d) as the attention's k
    if kind == "vector":
        qp = QParams(qp.delta[:8], qp.zero_point[:8])
    if kind == "group":  # a factor for each of the 5 quantized rows
        qp = GroupQParams(qp.delta_mid[:5], qp.zp_mid[:5], qp.delta_last, qp.zp_last)
    cfg = QConfig(use_aq=True)
    qstate = {"a": {"k": qp}}
    taps = TapCollector()
    with collect_act_taps(taps):
        out = Q.aq_apply(qstate, cfg, "k", x, start_rows=1)
    ref = torch.cat([x[..., 0:1, :], _old_aq_apply(qstate, cfg, "k", x[..., 1:, :])], dim=-2)
    assert _same_bits(out, ref)
    assert len(as_on_a_card) == int(kernel)
    assert torch.equal(taps.store["k"], x[..., 1:, :])
    # unquantized, the tensor comes back as it is
    assert Q.aq_apply(qstate, QConfig(), "k", x, start_rows=1) is x


def _refused(case):
    """(x, delta, zp, start_rows) that fused_fake_quant refuses, on the CPU."""
    x = torch.randn(2, 7, 40)
    d, z = torch.tensor(0.05), torch.tensor(128.0)
    rows, mid = 0, None
    if case == "f16 input":
        x = x.half()
    elif case == "f64 input":
        x = x.double()
    elif case == "rank 0":
        x = x[0, 0, 0]
    elif case == "rank 5":
        x = x.reshape(1, 2, 7, 4, 10)
    elif case == "bf16 delta":
        d = d.bfloat16()
    elif case == "f64 zero point":
        z = z.double()
    elif case == "(C, 1) broadcast":
        d, z = torch.full((7, 1), 0.05), torch.full((7, 1), 128.0)
    elif case == "other last size":
        d, z = torch.full((8,), 0.05), torch.full((8,), 128.0)
    elif case == "a float delta":
        d = 0.05
    elif case == "start rows on rank 1":
        x, rows = x[0, 0], 1
    elif case == "negative start rows":
        rows = -1
    elif case == "gradient wanted":
        x.requires_grad_(True)
    elif case == "delta requires grad":
        d.requires_grad_(True)
    elif case == "group rows of another length":
        mid = torch.full((6,), 1.5), torch.zeros(6)
    elif case == "group bf16 factor":
        mid = torch.full((7,), 1.5, dtype=BF16), torch.zeros(7)
    elif case == "group factor requires grad":
        mid = torch.full((7,), 1.5, requires_grad=True), torch.zeros(7)
    return x, d, z, rows, mid


@pytest.mark.parametrize("case, error, match", [
    ("CPU tensor", ValueError, "CUDA tensor"),
    ("f16 input", ValueError, "f32 or bf16"),
    ("f64 input", ValueError, "f32 or bf16"),
    ("rank 0", ValueError, "rank 1 to 4"),
    ("rank 5", ValueError, "rank 1 to 4"),
    ("bf16 delta", ValueError, "f32"),
    ("f64 zero point", ValueError, "f32"),
    ("(C, 1) broadcast", ValueError, "vector over the last"),
    ("other last size", ValueError, "vector over the last"),
    ("a float delta", ValueError, "delta"),
    ("start rows on rank 1", ValueError, "start_rows 1"),
    ("negative start rows", ValueError, "start_rows -1"),
    ("gradient wanted", RuntimeError, "requires grad"),
    ("delta requires grad", RuntimeError, "requires grad"),
    ("group rows of another length", ValueError, "group factors"),
    ("group bf16 factor", ValueError, "group factors"),
    ("group factor requires grad", RuntimeError, "requires grad"),
])
def test_fused_fake_quant_refuses_what_the_kernel_does_not_take(monkeypatch, case, error, match):
    def no_launch():
        raise AssertionError("a refused call reached the kernel")

    monkeypatch.setattr(FQ, "load_kernels", no_launch)
    if case != "CPU tensor":  # the other terms of the rule, as on a card
        rule = FQ.kernel_rule
        monkeypatch.setattr(FQ, "kernel_rule", lambda _dev, *a: rule("cuda", *a))
    x, d, z, rows, mid = _refused(case)
    before = dict(FQ.LAUNCHES)
    with pytest.raises(error, match=match):
        FQ.fused_fake_quant(x, d, z, 8, rows, mid)
    assert FQ.LAUNCHES == before


def test_module_imports_without_nvcc():
    code = ("import dgq_tpu_torch.models.layers, dgq_tpu_torch.ops.fake_quant as f; "
            "from dgq_tpu_torch.ops import build; "
            "assert build._kernels is None and f.LAUNCHES == "
            "{'fake_quant': 0, 'fake_quant_plain': 0}")
    subprocess.run([sys.executable, "-c", code], check=True, env={"PATH": "/usr/bin:/bin"},
                   cwd=Path(__file__).resolve().parents[1])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is false")
    FQ.reset_launch_counts()


def _params(kind, c, g, rows=1):
    """(delta, zp) on the card: one value or a vector over c, fresh or a view;
    or, for "group ...", (delta_last, zp_last, (delta_mid, zp_mid)), the
    factors over the columns and over `rows` rows, as `GroupQParams` holds
    them (the other factor one value: 1 and 0)."""
    dev = "cuda"
    if kind.startswith("group"):
        d = 1.0 + 0.3 * torch.rand(3, 2 * max(rows, c), generator=g, device=dev)
        z = torch.round(40.0 * torch.rand(3, 2 * max(rows, c), generator=g, device=dev))
        one, zero = torch.ones(1, device=dev), torch.zeros(1, device=dev)
        last = (0.04 * d[0, :c], 80.0 + z[0, :c])
        mid = (0.04 * d[1, :rows], 80.0 + z[1, :rows])
        if kind == "group rows":
            return one, zero, mid
        if kind == "group columns":
            return (*last, (one, zero))
        return (*last, (d[2, 1:2 * rows:2], z[2, 1:2 * rows:2]))  # "group both": strided rows
    if kind == "one":
        return (torch.tensor(0.0493, device=dev), torch.tensor(128.0, device=dev))
    if kind == "slot":  # a time slot's 0-d view, storage offset 7
        d = 0.05 * torch.exp(0.6 * (torch.rand(25, generator=g, device=dev) - 0.5))
        return d[7], torch.full((25,), 128.0, device=dev)[7]
    d = 0.05 * torch.exp(0.6 * (torch.rand(3, 2 * c, generator=g, device=dev) - 0.5))
    z = torch.round(90.0 + 80.0 * torch.rand(3, 2 * c, generator=g, device=dev))
    if kind == "vector":
        return d[0, :c].contiguous(), z[0, :c].contiguous()
    if kind == "vector slot":
        return d[2, :c], z[2, :c]
    return d[1, ::2], z[1, ::2]  # "vector step 2"


def _layout(kind, dtype, c, g):
    dev = "cuda"
    if kind == "contiguous":
        return (0.4 * torch.randn(2, 13, c, generator=g, device=dev)).to(dtype)
    if kind == "rank 1":
        return (0.4 * torch.randn(3 * c + 1, generator=g, device=dev)).to(dtype)[:c]
    base = (0.4 * torch.randn(2, 33, 3, c, generator=g, device=dev)).to(dtype)
    if kind == "permuted":
        return base.permute(0, 2, 1, 3)
    if kind == "slice":
        return base.permute(0, 2, 1, 3)[..., 1:, :]
    flat = torch.empty(base.numel() + 1, device=dev, dtype=dtype)  # "misaligned"
    return flat[1:].view_as(base).copy_(base)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 13])
@pytest.mark.parametrize("layout", ["contiguous", "permuted", "slice", "misaligned", "rank 1"])
@pytest.mark.parametrize("params", ["one", "slot", "vector", "vector slot", "vector step 2",
                                    "group rows", "group columns", "group both"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_kernel_matches_the_chain_bit_for_bit(card, dtype, params, layout, c):
    g = torch.Generator(device="cuda").manual_seed(c)
    x = _layout(layout, dtype, c, g)
    delta, zp, *mid = _params(params, c, g, x.shape[-2] if x.dim() > 1 else 1)
    mid = mid[0] if mid else None
    if mid is not None and x.dim() < 2:  # group factors need a row axis
        with pytest.raises(ValueError, match="group factors"):
            FQ.fused_fake_quant(x, delta, zp, 8, mid=mid)
        assert FQ.LAUNCHES["fake_quant"] == 0
        return
    out = FQ.fused_fake_quant(x, delta, zp, 8, mid=mid)
    ref = FQ.fused_fake_quant_reference(x, delta, zp, 8, mid=mid)
    torch.cuda.synchronize()
    assert FQ.LAUNCHES == {"fake_quant": 1, "fake_quant_plain": 0}
    assert out.is_contiguous() and out.dtype == F32 and out.shape == x.shape
    assert _same_bits(out, ref)


def _crafted(delta: float, zp: float):
    """Ties (n + 0.5) delta, values past both clip bounds, +-0, +-inf, NaN,
    subnormals and the largest finite values, on the card."""
    n = torch.arange(-300, 300, dtype=torch.float64)
    ties = ((n + 0.5) * delta).float()
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-45, -1e-45,
                            3.4e38, -3.4e38, 1e30, -1e30, delta * (255 - zp), delta * -zp,
                            delta * (255.5 - zp), delta * (-0.5 - zp)])
    x = torch.cat([ties, torch.nextafter(ties, torch.tensor(float("inf"))), special])
    return x.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("zp", [128.0, 0.0, 255.0, 127.5, -3.0])
@pytest.mark.parametrize("delta", [0.05, 0.0371, 1e-8, 3.0])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_kernel_matches_the_chain_on_crafted_values(card, dtype, delta, zp):
    x = _crafted(delta, zp).to(dtype)
    for shape in ((x.numel(),), (1, 1, x.numel())):
        xs = x.reshape(shape)
        d = torch.tensor(delta, device="cuda")
        z = torch.tensor(zp, device="cuda")
        assert _same_bits(FQ.fused_fake_quant(xs, d, z, 8),
                          FQ.fused_fake_quant_reference(xs, d, z, 8))
    # the same values under a last-axis vector (every column its own scale)
    c = 8
    xs = x[: x.numel() // c * c].reshape(-1, c)
    d = torch.full((c,), delta, device="cuda") * torch.linspace(0.5, 2.0, c, device="cuda")
    z = torch.full((c,), zp, device="cuda")
    assert _same_bits(FQ.fused_fake_quant(xs, d, z, 8),
                      FQ.fused_fake_quant_reference(xs, d, z, 8))
    # and under group factors: the rows' deltas times the columns', zero points summed
    r = xs.shape[0]
    mid = (torch.linspace(0.75, 1.5, r, device="cuda"), torch.zeros(r, device="cuda"))
    z = torch.full((c,), zp, device="cuda") - 2.0 * (torch.arange(c, device="cuda") % 2)
    assert _same_bits(FQ.fused_fake_quant(xs, d, z, 8, mid=mid),
                      FQ.fused_fake_quant_reference(xs, d, z, 8, mid=mid))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 2, 40])
@pytest.mark.parametrize("layout", ["contiguous", "permuted"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_start_rows_match_torch_cat(card, dtype, layout, rows):
    g = torch.Generator(device="cuda").manual_seed(rows)
    x = _layout(layout, dtype, 40, g)
    x[..., :1, :3] = torch.tensor([float("nan"), -0.0, float("inf")], device="cuda").to(dtype)
    delta, zp = _params("one", 40, g)
    out = FQ.fused_fake_quant(x, delta, zp, 8, start_rows=rows)
    ref = (torch.cat([x[..., :rows, :], fake_quant(x[..., rows:, :], QParams(delta, zp), 8)],
                     dim=-2) if rows else fake_quant(x, QParams(delta, zp), 8))
    assert _same_bits(out, ref) and out.is_contiguous()
    assert FQ.LAUNCHES["fake_quant"] == 1
    if rows < x.shape[-2]:  # a group factor for each quantized row
        delta, zp, mid = _params("group both", 40, g, x.shape[-2] - rows)
        out = FQ.fused_fake_quant(x, delta, zp, 8, start_rows=rows, mid=mid)
        assert _same_bits(out, FQ.fused_fake_quant_reference(x, delta, zp, 8, rows, mid))
        assert FQ.LAUNCHES["fake_quant"] == 2


@pytest.mark.cuda
def test_empty_and_refused_inputs(card):
    x = torch.empty(2, 0, 40, device="cuda")
    one = torch.tensor(0.05, device="cuda"), torch.tensor(128.0, device="cuda")
    out = FQ.fused_fake_quant(x, *one, 8)
    assert out.shape == x.shape and out.dtype == F32 and FQ.LAUNCHES["fake_quant"] == 0
    with pytest.raises(ValueError, match="f32 or bf16"):
        FQ.fused_fake_quant(torch.ones(4, 8, device="cuda", dtype=torch.float16), *one, 8)
    with pytest.raises(RuntimeError, match="requires grad"):
        FQ.fused_fake_quant(torch.ones(4, 8, device="cuda", requires_grad=True), *one, 8)
    for n in range(1, 11):  # below, at and past one 16-byte vector
        x = torch.randn(n, device="cuda")
        assert _same_bits(FQ.fused_fake_quant(x, *one, 8), fake_quant(x, QParams(*one), 8))
    assert FQ.LAUNCHES["fake_quant"] == 10


@pytest.mark.cuda
def test_tiny_unet_under_the_g8_policy_takes_the_kernel(card, monkeypatch):
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec, unet_sd_apply
    from dgq_tpu_torch.pipeline.sampler import select_time_qstate
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate

    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec, store="cuda")
    qstate, groups = synthetic_group_qstate(spec, 2, True, F32, device="cuda")
    cfg = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, group_conv_layers=groups,
                  group_conv_impl="fused", use_pallas_attention=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True)
    with torch.no_grad():
        folded, _ = quantize_model_weights(params, spec, cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn(2, 16, 16, 4, generator=g, device="cuda")
    ehs = torch.randn(2, 77, 64, generator=g, device="cuda")
    qs = select_time_qstate(qstate, 501, 2)
    counted, real = [], layers.aq_apply

    def counting(qstate, cfg, name, x, *a, **kw):
        if cfg.use_aq and qstate is not None and qstate.get("a", {}).get(name) is not None:
            counted.append(name)
        return real(qstate, cfg, name, x, *a, **kw)

    monkeypatch.setattr(layers, "aq_apply", counting)
    with torch.no_grad():
        out = unet_sd_apply(folded, lat, torch.tensor([501, 501], device="cuda"), ehs,
                            qstate=qs, cfg=cfg)
        torch.cuda.synchronize()
        launches = dict(FQ.LAUNCHES)
        monkeypatch.setattr(FQ, "kernel_rule", lambda *a: False)
        plain = unet_sd_apply(folded, lat, torch.tensor([501, 501], device="cuda"), ehs,
                              qstate=qs, cfg=cfg)
    assert len(counted) > 100
    assert launches == {"fake_quant": len(counted) // 2, "fake_quant_plain": 0}
    assert FQ.LAUNCHES["fake_quant_plain"] == len(counted) // 2
    assert _same_bits(out, plain)


@pytest.mark.cuda
def test_tiny_unet_under_a_group_state_takes_the_kernel(card, monkeypatch):
    """`quantize_act --group_num` gives every linear and attention quantizer
    `GroupQParams`: a factor over the rows (tokens) or over the columns
    (channels). Here each quantizer the forward reaches gets such factors in
    turn, sized from a first forward's taps."""
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec, unet_sd_apply
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate

    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec, store="cuda")
    qstate, groups = synthetic_group_qstate(spec, 0, False, F32, device="cuda")
    cfg = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, group_conv_layers=groups,
                  group_conv_impl="fused", use_pallas_attention=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True)
    g = torch.Generator(device="cuda").manual_seed(2)
    lat = torch.randn(2, 16, 16, 4, generator=g, device="cuda")
    ehs = torch.randn(2, 77, 64, generator=g, device="cuda")
    t = torch.tensor([501, 501], device="cuda")
    shapes = TapCollector(shapes_only=True)
    with torch.no_grad():
        folded, _ = quantize_model_weights(params, spec, cfg)
        with collect_act_taps(shapes):
            unet_sd_apply(folded, lat, t, ehs, qstate=qstate, cfg=cfg)
    grouped = {}
    for i, (name, qp) in enumerate(qstate["a"].items()):
        if isinstance(qp, GroupQParams) or name not in shapes.store:
            continue
        rows, cols = shapes.store[name][-2:]
        n = rows if i % 2 else cols
        d = qp.delta * (1.0 + 0.5 * torch.rand(n, generator=g, device="cuda"))
        z = qp.zero_point + torch.round(8.0 * torch.rand(n, generator=g, device="cuda") - 4.0)
        one, zero = torch.ones(1, device="cuda"), torch.zeros(1, device="cuda")
        grouped[name] = GroupQParams(d, z, one, zero) if i % 2 else GroupQParams(one, zero, d, z)
    qs = {**qstate, "a": {**qstate["a"], **grouped}}
    FQ.reset_launch_counts()
    with torch.no_grad():
        out = unet_sd_apply(folded, lat, t, ehs, qstate=qs, cfg=cfg)
        torch.cuda.synchronize()
        launches = dict(FQ.LAUNCHES)
        monkeypatch.setattr(FQ, "kernel_rule", lambda *a, **kw: False)
        plain = unet_sd_apply(folded, lat, t, ehs, qstate=qs, cfg=cfg)
    assert len(grouped) > 100
    assert launches["fake_quant_plain"] == 0 and launches["fake_quant"] >= len(grouped)
    assert FQ.LAUNCHES["fake_quant_plain"] == launches["fake_quant"]
    assert _same_bits(out, plain)
