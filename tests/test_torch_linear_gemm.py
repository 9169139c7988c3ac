"""The 3xTF32 GEMM of the port's f32 linears (`ops/linear_gemm.py`,
`csrc/linear_gemm.cu`) and `models.layers.linear`'s dispatch to it.

On the CPU (no card; these count in the suite): the plain version (three
TF32 products in f32, `ops.tf32.tf32_split`) against an f64 product at the
cells' K and N with few rows, within twice `F.linear`'s error, where one TF32
product is not; the routing rule case by case (the CPU, bf16, a gradient
wanted, rows below MIN_ROWS, too few tiles, K or N not a multiple of 4,
misaligned rows each keep the library); the tile plan; `layers.linear` on the
CPU bit for bit `F.linear` then the bias; its dispatch as on a card (the
rule told the device is "cuda"): what the kernel takes goes to the launch
(the plain version stands in), the rest to `F.linear`, bit for bit;
`linear_gemm` refuses, before any launch, what the kernel does not take.

Marked `cuda` (they skip without a card; a CUDA kernel has no CPU mode): the
kernel against the plain version; a NaN in x kept, as the library keeps it;
its max abs error against an f64 product at most twice `F.linear`'s (TF32
off) at every f32 linear shape of the benchmark's `sd3m_gen_b2`,
`sdxlt_gen_b4` and `sd14_gen_b4` cells that the kernel takes, ragged M
included, with and without bias, on N(0, 1) inputs and W4-folded weights; a
tiny SD3 transformer call whose every linear the rule takes launches the
kernel, no other does, and its unquantized call holds against the CPU's. Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_linear_gemm.py -q
"""
import pytest
import torch
import torch.nn.functional as F

from dgq_tpu_torch.models import layers
from dgq_tpu_torch.ops import linear_gemm as LG
from dgq_tpu_torch.ops.tf32 import tf32_split

F32, BF16 = torch.float32, torch.bfloat16

# (K, N) of the cells' f32 linears (SD3 medium, SDXL-turbo, SD v1.4, the VAEs)
CELL_KN = [(1536, 1536), (1536, 6144), (6144, 1536), (1536, 64), (4096, 1536), (640, 640),
           (640, 5120), (2560, 640), (1280, 1280), (1280, 10240), (5120, 1280), (2048, 640),
           (320, 320), (320, 2560), (1280, 320), (768, 320), (512, 512)]


def _w4_folded(n, k, g, device="cpu"):
    """An (n, k) weight as the cells hold one: N(0, 1/k), W4 minmax per output
    channel, folded."""
    w = torch.randn(n, k, generator=g, device=device) / k ** 0.5
    lo, hi = w.amin(1, keepdim=True), w.amax(1, keepdim=True)
    delta = (hi - lo) / 15
    zp = torch.round(-lo / delta)
    return (torch.clamp(torch.round(w / delta) + zp, 0, 15) - zp) * delta


def _max_err(y, exact):
    return float((y.double() - exact).abs().max())


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k, n", CELL_KN)
def test_plain_version_against_f64(k, n):
    g = torch.Generator().manual_seed(k * 7 + n)
    x = torch.randn(6, k, generator=g)
    w = _w4_folded(n, k, g)
    b = torch.randn(n, generator=g)
    exact = x.double() @ w.double().T + b.double()
    plain = LG.linear_gemm_reference(x, w, b)
    assert plain.dtype == F32 and plain.shape == (6, n)
    lib = _max_err(F.linear(x, w) + b, exact)
    assert _max_err(plain, exact) <= 2 * lib
    # the bound has teeth: one TF32 product (big times big) misses it by far
    xb, wb = (tf32_split(t)[0] for t in (x, w))
    assert _max_err(F.linear(xb, wb) + b, exact) > 8 * lib


@pytest.mark.parametrize("case, args, takes", [
    ("SD3 image FF in", ("cuda", F32, F32, False, 16384, 6144, 1536), True),
    ("SD3 text q", ("cuda", F32, F32, False, 1332, 1536, 1536), True),
    ("SD3 proj_out", ("cuda", F32, F32, False, 16384, 64, 1536), True),
    ("SD 8px FF out", ("cuda", F32, F32, False, 512, 1280, 5120), True),
    ("VAE 512px attention", ("cuda", F32, F32, False, 16384, 512, 512), True),
    ("CPU", ("cpu", F32, F32, False, 16384, 1536, 1536), False),
    ("bf16 x", ("cuda", BF16, F32, False, 16384, 1536, 1536), False),
    ("bf16 w", ("cuda", F32, BF16, False, 16384, 1536, 1536), False),
    ("f16 x", ("cuda", torch.float16, F32, False, 16384, 1536, 1536), False),
    ("gradient wanted (AdaRound)", ("cuda", F32, F32, True, 4096, 1280, 1280), False),
    ("adaLN modulation, M 4", ("cuda", F32, F32, False, 4, 9216, 1536), False),
    ("rows below one tile", ("cuda", F32, F32, False, 127, 10240, 1536), False),
    ("SD cross k at 320: 25 tiles", ("cuda", F32, F32, False, 616, 320, 768), False),
    ("SDXL cross k at 640: 30 tiles", ("cuda", F32, F32, False, 308, 640, 2048), False),
    ("K not a multiple of 4", ("cuda", F32, F32, False, 16384, 1536, 1538), False),
    ("N not a multiple of 4", ("cuda", F32, F32, False, 16384, 1538, 1536), False),
    ("2^31 rows", ("cuda", F32, F32, False, 2 ** 31, 64, 4), False),
    ("misaligned rows", ("cuda", F32, F32, False, 16384, 1536, 1536, False), False),
])
def test_kernel_rule(case, args, takes):
    assert LG.kernel_rule(*args) is takes, case


@pytest.mark.parametrize("m, n, plan", [
    (16384, 1536, (128, 1536, 132)),
    (16384, 6144, (128, 6144, 132)),
    (1332, 1536, (128, 132, 132)),   # 11 x 12 tiles fill the card at 128 columns
    (16384, 64, (64, 128, 128)),     # N at most 64
    (512, 1280, (64, 80, 80)),       # 4 x 10 tiles at 128 would leave SMs idle
    (616, 320, (64, 25, 25)),
])
def test_gemm_plan(m, n, plan):
    assert tuple(LG.gemm_plan(m, n)) == plan


@pytest.mark.parametrize("shape, n, bias, dtype", [
    ((2, 300, 64), 32, True, F32), ((300, 64), 64, False, F32), ((4, 64), 96, True, F32),
    ((2, 300, 64), 32, True, BF16), ((7,), 12, True, F32),
])
def test_linear_on_the_cpu_is_f_linear_then_the_bias(shape, n, bias, dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(*shape, generator=g).to(dtype)
    w = torch.randn(n, shape[-1], generator=g)
    b = torch.randn(n, generator=g).to(dtype) if bias else None
    before = dict(LG.LAUNCHES)
    out = layers.linear({"w": w, "b": b}, x)
    ref = F.linear(x, w.to(dtype))
    if b is not None:
        ref = ref + b
    assert out.dtype == ref.dtype and torch.equal(out, ref)
    assert LG.LAUNCHES == before  # CPU tensors count toward neither


@pytest.fixture
def as_on_a_card(monkeypatch):
    """The rule told the device is "cuda" (the other terms as they are:
    alignment is read off the CPU tensors), and the launches recorded and run
    by the plain version, the kernel's stand-in on the CPU."""
    rule, calls = LG.kernel_rule, []
    monkeypatch.setattr(LG, "kernel_rule", lambda _dev, *a: rule("cuda", *a))

    def recorded(x, w, b=None, checked=False):
        assert checked  # layers.linear has seen kernel_takes hold
        calls.append((tuple(x.shape), tuple(w.shape)))
        return LG.linear_gemm_reference(x, w, b)

    monkeypatch.setattr(LG, "linear_gemm", recorded)
    return calls


@pytest.mark.parametrize("case, x_shape, n, kernel", [
    ("1024 rows, 64 tiles", (2, 512, 256), 512, True),
    ("SD3 image rows", (4, 4096, 64), 64, True),
    ("M 4, adaLN", (4, 256), 512, False),
    ("few tiles", (300, 256), 128, False),
    ("K not a multiple of 4", (1024, 258), 512, False),
    ("bf16", (1024, 256), 512, False),
    ("gradient wanted", (1024, 256), 512, False),
])
def test_linear_dispatch(as_on_a_card, case, x_shape, n, kernel):
    g = torch.Generator().manual_seed(8)
    x = torch.randn(*x_shape, generator=g)
    w = torch.randn(n, x_shape[-1], generator=g) / x_shape[-1] ** 0.5
    b = torch.randn(n, generator=g)
    if case == "bf16":
        x = x.bfloat16()
    if case == "gradient wanted":
        w.requires_grad_(True)
    out = layers.linear({"w": w, "b": b}, x)
    assert len(as_on_a_card) == int(kernel), case
    if kernel:
        assert torch.equal(out, LG.linear_gemm_reference(x, w, b))
    else:
        ref = F.linear(x, w.to(x.dtype)) + b
        assert out.dtype == ref.dtype and torch.equal(out, ref)
    if case == "gradient wanted":  # the library's product, and its gradient
        out.sum().backward()
        w_ref = w.detach().clone().requires_grad_(True)
        (F.linear(x, w_ref) + b).sum().backward()
        assert torch.equal(w.grad, w_ref.grad)


@pytest.mark.parametrize("case", ["cpu", "grad", "K not a multiple of 4", "bf16 w"])
def test_linear_gemm_refuses_what_the_kernel_does_not_take(case):
    x, w = torch.randn(1024, 64), torch.randn(512, 64)
    if case == "grad":
        x.requires_grad_(True)
        with pytest.raises(RuntimeError, match="requires grad"):
            LG.linear_gemm(x, w)
        return
    if case == "K not a multiple of 4":
        x, w = x[:, :62], w[:, :62]
    if case == "bf16 w":
        w = w.bfloat16()
    with pytest.raises(ValueError, match="linear_gemm takes"):
        LG.linear_gemm(x, w)


@pytest.mark.parametrize("m, n", [(100, 512), (616, 320)])
def test_the_floor_is_the_routings_alone(m, n):
    """Below the row or tile floor `layers.linear` keeps the library, but the
    kernel itself takes the product (timed so in `chip_smoke.py`)."""
    assert not LG.kernel_rule("cuda", F32, F32, False, m, n, 256)
    assert LG.kernel_rule("cuda", F32, F32, False, m, n, 256, floor=False)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is false")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the library's products in f32
    torch.backends.cudnn.allow_tf32 = False  # and the convs (SD3's patch embedding)
    LG.reset_launch_counts()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# every f32 linear of the generation cells the kernel takes: M, K, N, bias
CELL_SHAPES = [
    (16384, 1536, 1536, True), (16384, 1536, 6144, True), (16384, 6144, 1536, True),
    (16384, 1536, 64, True), (1332, 1536, 1536, True), (1332, 1536, 6144, True),
    (1332, 6144, 1536, True), (1332, 4096, 1536, True),
    (16384, 640, 640, False), (16384, 640, 5120, True), (16384, 2560, 640, True),
    (4096, 1280, 1280, False), (4096, 1280, 10240, True), (4096, 5120, 1280, True),
    (32768, 320, 320, False), (32768, 320, 2560, True),
    (32768, 1280, 320, True), (8192, 640, 5120, True), (2048, 1280, 10240, True),
    (512, 1280, 1280, False), (512, 5120, 1280, True), (616, 768, 1280, False),
    (16384, 512, 512, True), (65536, 512, 512, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n, bias", CELL_SHAPES)
def test_kernel_error_within_twice_the_librarys(card, m, k, n, bias):
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device="cuda")
    w = _w4_folded(n, k, g, "cuda")
    b = torch.randn(n, generator=g, device="cuda") if bias else None
    assert LG.kernel_takes(x, w, b)
    out = LG.linear_gemm(x, w, b)
    torch.cuda.synchronize()
    assert LG.LAUNCHES["linear_gemm"] == 1 and out.is_contiguous() and out.dtype == F32
    exact = x.double() @ w.double().T + (0 if b is None else b.double())
    lib = F.linear(x, w) if b is None else F.linear(x, w) + b
    assert _max_err(out, exact) <= 2 * _max_err(lib, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, n, bias", [
    ((2, 1332, 1536), 1536, True), ((3, 700, 520), 300, False), ((129, 36), 100, True),
    ((16384, 1536), 64, False),
])
def test_kernel_against_the_plain_version(card, shape, n, bias):
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(*shape, generator=g, device="cuda")
    w = torch.randn(n, shape[-1], generator=g, device="cuda") / shape[-1] ** 0.5
    b = torch.randn(n, generator=g, device="cuda") if bias else None
    out = LG.linear_gemm(x, w, b)
    plain = LG.linear_gemm_reference(x, w, b)
    exact = x.double() @ w.double().T + (0 if b is None else b.double())
    assert out.shape == shape[:-1] + (n,)
    # both are f32 results of the same three products, summed in other orders
    room = max(_max_err(plain, exact), 16 * 2.0 ** -23 * float(exact.abs().max()))
    assert float((out - plain).abs().max()) <= 2 * room


@pytest.mark.cuda
def test_kernel_keeps_a_nan_as_the_library_does(card):
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(256, 512, generator=g, device="cuda")
    w = torch.randn(512, 512, generator=g, device="cuda") / 512 ** 0.5
    x[3, 5] = float("nan")
    x[70, 0] = -float("nan")
    out = LG.linear_gemm(x, w)
    assert torch.equal(out.isnan(), F.linear(x, w).isnan())
    assert int(out.isnan().sum()) == 2 * 512


@pytest.mark.cuda
def test_tiny_sd3_call_launches_the_kernel_for_every_linear_it_takes(card, monkeypatch):
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models import mmdit_sd3 as M
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.pipeline.sampler import select_slot_qstate
    from dgq_tpu_torch.utils.synthetic import synthetic_mmdit_qstate

    # the tiny model's linears have 128 and 170 rows: one or two tiles each,
    # so the tile floor is lowered for it; the rest of the rule is as it is
    monkeypatch.setattr(LG, "MIN_TILES", 1)
    cfg = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True)
    spec = M.mmdit_sd3_spec(layers=3, heads=2, head_dim=32, joint_dim=96, pooled_dim=48,
                            freq_dim=32)
    params = M.init_mmdit_sd3(torch.Generator().manual_seed(0), "cpu", spec)
    folded, _ = quantize_model_weights(params, M.quantized_spec(spec), cfg)
    qs = select_slot_qstate(synthetic_mmdit_qstate(spec, 28, device="cpu"), 5)
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 16, 16, 16, generator=g), torch.tensor([987.4, 110.9]),
            torch.randn(2, 85, 96, generator=g), torch.randn(2, 48, generator=g))
    geo = {"head_dim": 32, "sample_size": 16, "pos_embed_max_size": 24}

    def cuda(tree):
        if isinstance(tree, dict):
            return {k: cuda(v) for k, v in tree.items()}
        if hasattr(tree, "_replace"):  # QParams, GroupQParams
            return type(tree)(*(cuda(v) for v in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(cuda(v) for v in tree)
        return tree.cuda() if torch.is_tensor(tree) else tree

    taken, real = [], LG.kernel_takes
    monkeypatch.setattr(LG, "kernel_takes",
                        lambda x, w, b=None: taken.append(real(x, w, b)) or taken[-1])
    M.mmdit_sd3_apply(cuda(folded), *cuda(args), qstate=cuda(qs), cfg=cfg, **geo)
    torch.cuda.synchronize()
    assert sum(taken) > 0
    assert LG.LAUNCHES == {"linear_gemm": sum(taken), "linear_library": len(taken) - sum(taken)}
    # the unquantized call (no code that flips on a last bit, the plain
    # attention) holds against the CPU's at test_torch_sd3.py's 1e-4
    LG.reset_launch_counts()
    first = sum(taken)
    out = M.mmdit_sd3_apply(cuda(params), *cuda(args), **geo)
    assert LG.LAUNCHES["linear_gemm"] == sum(taken) - first > 0
    ref = M.mmdit_sd3_apply(params, *args, **geo)
    assert float((out.cpu() - ref).abs().max() / ref.abs().max()) < 1e-4
