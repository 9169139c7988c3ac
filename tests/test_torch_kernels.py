"""The hand-written CUDA kernels (dgq_tpu_torch/csrc/attention.cu: K1 to K4
and their packed head-slot entries K1p to K4p, in bf16 on the tensor cores
and in both load forms, K2/K2p in f32 as three TF32 products a product in
both load forms; group_conv.cu: K5, bf16 and 3xTF32 f32, split and unsplit;
int8_matmul.cu: K6, split and unsplit, in both load forms) against their
plain PyTorch versions on the card. Marked `cuda`: they skip
when torch.cuda.is_available() is false (a CUDA kernel has no CPU mode).
Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(`--noconftest`: the suite's conftest imports JAX, which a GPU machine need
not have). The cases mirror tests/test_pallas_kernels.py: ragged S = 77,
head dims of the main path (40/80/160 SD UNet, 64 SDXL UNet, 512 VAE), two
deltas, bf16 and f32. The f32 entries of K1 to K4 run on the tensor cores
(three TF32 products for Q K^T, two for P V) at head dims up to 160.

Tolerances, with reasons:
  * K2 (flash): f32 atol 1e-4 (f32 reassociation of online vs materialized
    softmax, measured ~1e-5; each product is formed from three TF32
    products, which leave out under 2^-21 of it, where one would be off by
    some 1e-3 at the VAE's scores). bf16 runs on the tensor cores: Q K^T of bf16
    inputs is exact per product, but P is rounded to bf16 before P V, so
    each product carries a relative error of at most 2^-9 and the sum an
    absolute error that does not shrink where the output cancels:
    |err| <= 2^-7 |ref| + 2^-8 (P |V|) against the f32 plain result (P the
    plain softmax; the first term is the output's rounding to bf16).
  * K1 (uniform softmax quant): f32 as K2's; bf16 |err| <= 2^-7 |ref| +
    1e-5 max|V| (each side rounds its f32 result to bf16 once: half an ulp,
    <= 2^-8 relative); both plus at most a few one-bin flips,
    |err| <= 2 delta max|V| elementwise with a bounded mean. exp and the
    summation order differ, so a probability within float error of a bin
    boundary may round to the neighbouring code.
  * K3/K3b (log2 real_time) and K4 (static log2, uniform with start_peak): a
    log2 code flips at a half-integer exponent and changes that probability
    by a factor of 2, and under real_time delta comes from a sum in another
    order, so the size of an error is not bounded but the share of outputs
    with one is: under 5e-4 of the outputs may be off by more than 2e-3 (f32)
    or 2e-3 + 2^-7 |ref| (bf16), the form of tests/test_pallas_kernels.py.
  * K1p to K4p (the packed head-slot entries): the same kernel body on the
    same numbers in the same order, so the output with its padding lanes
    sliced off equals the unpacked kernel's bit for bit, f32 and bf16, K3p
    included (its delta is folded by an atomic min/max on the bit pattern,
    which no order changes); the padding lanes are exact zeros even over an
    output buffer full of NaN. Against the plain version: the tolerance of
    the unpacked kernel of the same mode.
  * K5 (group conv): the codes and the folded weights are the same numbers on
    both sides (bf16 products are exact in the tensor cores' f32
    accumulator), so only the f32 summation order differs: atol 2e-3 as
    tests/test_group_conv_kernel.py, plus 2^-7 |ref| in bf16 for the one
    rounding of each side's result. f32 takes the same 2e-3: a code is
    exact in TF32 and the weights' three TF32 products leave out under 2^-21
    of each product. Split K adds its partial tiles in split
    order, so two runs give the same bits; the fold kernel's w_t, rd and z
    equal `_fold`'s bit for bit.
  * K6 (int8 matmul): the integer product is exact and the f32 epilogue is
    written in the plain version's order without fused multiply-adds, so f32
    outputs agree within 1e-5 of the output's largest magnitude (expected: to
    the bit) and bf16 outputs within one bf16 ulp, 2^-7 |ref|; the codes the
    kernel builds equal `quantize_int` bit for bit.
"""
import pytest
import torch

from dgq_tpu_torch.ops import attention as TA
from dgq_tpu_torch.ops import group_conv as TG
from dgq_tpu_torch.ops import int8_matmul as TM
from dgq_tpu_torch.quant.affine import QParams, quantize_int

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _cuda_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is false")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _qkv(bh, t, s, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (2.0 * torch.randn(bh, t, d, generator=g, device="cuda")).to(dtype)
    k = (2.0 * torch.randn(bh, s, d, generator=g, device="cuda")).to(dtype)
    v = torch.randn(bh, s, d, generator=g, device="cuda").to(dtype)
    return q, k, v


def _check(out, ref, v, dtype, delta=None):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    err = (out - ref).abs()
    vmax = float(v.float().abs().max())
    bound = (torch.full_like(ref, 1e-4) if dtype == torch.float32
             else 2.0 ** -7 * ref.abs() + 1e-5 * vmax)
    if delta is not None:
        bound = bound + 2.0 * delta * vmax
        assert float(err.mean()) <= 2.0 ** -8 * float(ref.abs().mean()) + 0.01 * delta * vmax
    assert bool((err <= bound).all()), float((err - bound).max())


def _check_flash(out, q, k, v, scale):
    """The restated bf16 flash bound, against the f32 plain result."""
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    ref32, pav = torch.matmul(p, v.float()), torch.matmul(p, v.float().abs())
    assert out.shape == ref32.shape
    err = (out.float() - ref32).abs()
    bound = 2.0 ** -7 * ref32.abs() + 2.0 ** -8 * pav
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
@pytest.mark.parametrize("s", [77, 256])
def test_flash_kernel_matches_plain(s, d, dtype):
    q, k, v = _qkv(4, 200, s, d, dtype, seed=d + s)
    before = TA.LAUNCHES["flash_attention"]
    out = TA.fused_attention(q, k, v, d ** -0.5, sm_mode="none")
    torch.cuda.synchronize()
    assert TA.LAUNCHES["flash_attention"] == before + 1
    if dtype == torch.bfloat16:
        _check_flash(out, q, k, v, d ** -0.5)
    else:
        _check(out, TA.attention_reference(q, k, v, d ** -0.5), v, dtype)


@pytest.mark.parametrize("t,s,d", [
    (200, 77, 40), (129, 300, 64), (64, 65, 80), (70, 77, 160), (130, 96, 512),  # each tier
    (50, 33, 36), (50, 130, 12), (31, 77, 100), (40, 64, 200), (65, 40, 500),    # odd widths
])
def test_flash_tensor_core_forms_agree(t, s, d):
    """The bf16 flash kernel at every head-dim tier, ragged T and S: the form
    the wrapper picks for an aligned tensor (16-byte copies where head_dim is
    a multiple of 8, element loads where not) and the element-load form it
    picks for the same data one element off a 16-byte boundary give the same
    bits, inside the bound."""
    q, k, v = _qkv(3, t, s, d, torch.bfloat16, seed=t + s + d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (t * d, d, s * d, d, s * d, d)
    want_form = "wgmma_async" if d % 8 == 0 else "wgmma_plain"
    assert TA.flash_form(q.dtype, d, ptrs, strides) == want_form
    out = TA.flash_attention(q, k, v, d ** -0.5)
    _check_flash(out, q, k, v, d ** -0.5)
    for which in range(3):
        x = (q, k, v)[which]
        odd = torch.empty(x.numel() + 1, device="cuda", dtype=x.dtype)[1:].view_as(x).copy_(x)
        assert odd.is_contiguous() and odd.data_ptr() % 4 != 0
        args = [q, k, v]
        args[which] = odd
        assert TA.flash_form(q.dtype, d, tuple(a.data_ptr() for a in args),
                             strides) == "wgmma_plain"
        before = TA.LAUNCHES["flash_attention"]
        assert torch.equal(TA.flash_attention(*args, d ** -0.5), out)
        assert TA.LAUNCHES["flash_attention"] == before + 1


def test_flash_kernel_refuses_a_form_its_addresses_cannot_take():
    """The C entry checks the form it is handed: 16-byte copies on a view one
    element off, the tensor-core body on f32, the CUDA-core body on bf16 and
    head dims past 512 return an error instead of launching."""
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    q, k, v = _qkv(2, 64, 64, 40, torch.bfloat16, seed=1)
    odd = torch.empty(q.numel() + 1, device="cuda", dtype=q.dtype)[1:].view_as(q).copy_(q)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(qq, bf16, form, d=40):
        return lib.dgq_flash_attention(qq.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                       2, 64, 64, d, 0.1, bf16, form, stream)

    assert call(q, 1, 1) == 0 and call(q, 1, 2) == 0 and call(odd, 1, 2) == 0
    assert call(odd, 1, 1) != 0      # 16-byte copies from a misaligned base
    assert call(q, 1, 0) != 0        # bf16 has no CUDA-core flash body
    assert call(q, 0, 1) != 0        # f32 has no tensor-core body
    assert call(q, 1, 1, d=36) != 0  # 72-byte rows
    assert call(q, 1, 3) != 0
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="512"):
        x = torch.zeros(1, 8, 520, device="cuda", dtype=torch.bfloat16)
        TA.flash_attention(x, x, x, 0.1)


@pytest.mark.parametrize("t,s,d", [
    (200, 77, 40), (129, 300, 64), (64, 65, 80), (70, 77, 160), (130, 96, 512),  # each tier
    (50, 33, 36), (50, 130, 12), (31, 77, 100), (40, 64, 200), (65, 40, 500),    # odd widths
    (33, 70, 42), (64, 64, 3),
])
def test_flash_tf32_forms_agree(t, s, d):
    """The f32 flash kernel (three TF32 products a product) at every head-dim
    tier, ragged T and S: the form the wrapper picks for an aligned tensor
    (16-byte loads where head_dim is a multiple of 4, element loads where
    not) and the element-load form it picks for the same data one element
    off a 16-byte boundary give the same bits, within 1e-4 of the plain
    version."""
    q, k, v = _qkv(3, t, s, d, torch.float32, seed=t + s + d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (t * d, d, s * d, d, s * d, d)
    want_form = "tf32x3_vector" if d % 4 == 0 else "tf32x3_plain"
    assert TA.flash_form(q.dtype, d, ptrs, strides) == want_form
    out = TA.flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    _check(out, TA.attention_reference(q, k, v, d ** -0.5), v, torch.float32)
    for name, x in (("q", q), ("k", k), ("v", v)):
        odd = torch.empty(x.numel() + 1, device="cuda", dtype=x.dtype)[1:].view_as(x).copy_(x)
        args = {"q": q, "k": k, "v": v, name: odd}
        assert TA.flash_form(q.dtype, d, (args["q"].data_ptr(), args["k"].data_ptr(),
                                          args["v"].data_ptr()), strides) == "tf32x3_plain"
        assert torch.equal(TA.flash_attention(args["q"], args["k"], args["v"], d ** -0.5), out)


def test_flash_tf32_refuses_what_it_cannot_take():
    """The C entry checks the f32 forms it is handed: 16-byte loads from a view
    one element off or with head_dim no multiple of 4, either form on bf16, a
    scale <= 0, head dims past 512, and form 0 (no flash body runs on the CUDA
    cores), in the classic and the packed entry; the wrapper raises on a
    scale <= 0 before it launches anything."""
    import ctypes

    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    q, k, v = _qkv(2, 64, 64, 40, torch.float32, seed=2)
    qb = q.bfloat16()
    odd = torch.empty(q.numel() + 1, device="cuda", dtype=q.dtype)[1:].view_as(q).copy_(q)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(qq, bf16, form, d=40, scale=0.1):
        return lib.dgq_flash_attention(qq.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                       2, 64, 64, d, scale, bf16, form, stream)

    assert call(q, 0, 3) == 0 and call(q, 0, 4) == 0 and call(odd, 0, 4) == 0
    assert call(odd, 0, 3) != 0             # 16-byte loads from a misaligned base
    assert call(q, 0, 3, d=38) != 0         # 152-byte rows
    assert call(qb, 1, 3) != 0 and call(qb, 1, 4) != 0  # bf16 on the f32 body
    assert call(q, 0, 1) != 0 and call(q, 0, 2) != 0    # f32 on the bf16 body
    assert call(q, 0, 3, scale=0.0) != 0 and call(q, 0, 4, scale=-0.1) != 0
    assert call(q, 0, 5) != 0
    assert call(q, 0, 0) != 0 and call(q, 0, 0, scale=-0.1) != 0  # no CUDA-core flash body
    strides = (ctypes.c_longlong * 8)(*(64 * 40, 40) * 4)  # (2, 64, 1 * 40) packed views

    def packed(form):
        return lib.dgq_flash_attention_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              out.data_ptr(), 2, 1, 64, 64, 40, 40, strides, 0.1,
                                              0, form, stream)

    assert packed(3) == 0 and packed(0) != 0
    torch.cuda.synchronize()
    before = dict(TA.LAUNCHES)
    for scale in (0.0, -0.1):
        with pytest.raises(ValueError, match="positive scale"):
            TA.fused_attention(q, k, v, scale)
        with pytest.raises(ValueError, match="positive scale"):
            TA.fused_attention(*(TA.repack_heads(x, 2, 64) for x in (q, k, v)), scale,
                               num_heads=2, head_dim=40)
    assert TA.LAUNCHES == before
    with pytest.raises(ValueError, match="512"):
        x = torch.zeros(1, 8, 520, device="cuda")
        TA.flash_attention(x, x, x, 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta", [1.0 / 255.0, 1.0 / 64.0])
@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
@pytest.mark.parametrize("s", [77, 256])
def test_static_uniform_kernel_matches_plain(s, d, delta, dtype):
    q, k, v = _qkv(4, 200, s, d, dtype, seed=3 * d + s)
    # the time-aware slot delta lives on the device, in the qstate's dtype
    sm_delta = torch.tensor(delta, device="cuda", dtype=dtype)
    before = TA.LAUNCHES["static_uniform_attention"]
    out = TA.fused_attention(q, k, v, d ** -0.5, sm_mode="uniform", sm_bits=8,
                             sm_delta=sm_delta)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["static_uniform_attention"] == before + 1
    ref = TA.attention_reference(q, k, v, d ** -0.5, "uniform", 8, sm_delta)
    _check(out, ref, v, dtype, float(sm_delta))
    # quantization is live: the output differs from the unquantized one
    assert float((out.float() - TA.attention_reference(q, k, v, d ** -0.5).float())
                 .abs().max()) > 1e-2


def _mismatch_share(out, ref, dtype):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    bound = 2e-3 + (2.0 ** -7 * ref.abs() if dtype == torch.bfloat16 else 0.0)
    return float(((out - ref).abs() > bound).float().mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("t,s,d", [(200, 77, 40), (200, 256, 40), (256, 256, 80),
                                   (70, 77, 160), (1024, 1024, 80), (200, 77, 64),
                                   (1024, 1024, 64)])
def test_log2_real_time_kernels_match_plain(t, s, d, sp, dtype):
    q, k, v = _qkv(4, t, s, d, dtype, seed=d + s + sp)
    before = dict(TA.LAUNCHES)
    out = TA.fused_attention(q, k, v, d ** -0.5, sm_mode="log2_real_time", start_peak=sp)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["rt_stats"] == before["rt_stats"] + 1
    assert TA.LAUNCHES["quant_accum"] == before["quant_accum"] + 1
    ref = TA.attention_reference(q, k, v, d ** -0.5, "log2_real_time", 8, start_peak=sp)
    assert _mismatch_share(out, ref, dtype) < 5e-4
    assert float((out.float() - TA.attention_reference(q, k, v, d ** -0.5).float())
                 .abs().max()) > 1e-3


def test_real_time_dominant_column0_and_padded_rows():
    """Key 0 dominates: delta is the largest non-peak probability, small
    enough that the exponent cap ub bites; T = 40 leaves 24 padded query rows
    in the block, whose 1/77 must stay out of the reduction."""
    g = torch.Generator(device="cuda").manual_seed(12)
    q = 0.5 + 0.1 * torch.randn(2, 40, 40, generator=g, device="cuda").abs()
    k = 0.05 * torch.randn(2, 77, 40, generator=g, device="cuda")
    k[0, 0, :] = 5.2 / (40 ** -0.5 * 0.55 * 40)
    k[1, 0, :] = 30.0
    v = torch.randn(2, 77, 40, generator=g, device="cuda")
    out = TA.fused_attention(q, k, v, 40 ** -0.5, sm_mode="log2_real_time", start_peak=True)
    ref = TA.attention_reference(q, k, v, 40 ** -0.5, "log2_real_time", 8, start_peak=True)
    assert _mismatch_share(out, ref, torch.float32) < 5e-4
    assert float((out - ref).abs().max()) <= 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta", [1.0, 0.3])
@pytest.mark.parametrize("mode,sp", [("log2", False), ("log2", True), ("uniform", True)])
@pytest.mark.parametrize("t,s,d", [(200, 77, 40), (256, 256, 80), (70, 77, 160), (200, 77, 64),
                                   (256, 256, 64)])
def test_static_quant_kernel_matches_plain(t, s, d, mode, sp, delta, dtype):
    q, k, v = _qkv(4, t, s, d, dtype, seed=2 * d + s + sp)
    sm_delta = torch.tensor(delta, device="cuda", dtype=dtype)
    before = TA.LAUNCHES["static_quant_attention"]
    out = TA.fused_attention(q, k, v, d ** -0.5, sm_mode=mode, sm_bits=8, sm_delta=sm_delta,
                             start_peak=sp)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["static_quant_attention"] == before + 1
    ref = TA.attention_reference(q, k, v, d ** -0.5, mode, 8, sm_delta, start_peak=sp)
    assert _mismatch_share(out, ref, dtype) < 5e-4


def test_flash_kernel_at_the_1024px_vae_shape():
    """K2 at T = S = 16384, D = 512, one head: the SDXL decode's mid-block
    attention (256 blocks of 64 query rows whose two warpgroups halve O's
    columns, 193 KB of shared memory)."""
    q, k, v = _qkv(1, 16384, 16384, 512, torch.bfloat16, seed=5)
    q, k = q * 0.25, k * 0.25  # keep the softmax from collapsing onto one key
    out = TA.fused_attention(q, k, v, 512 ** -0.5, sm_mode="none")
    torch.cuda.synchronize()
    _check_flash(out, q, k, v, 512 ** -0.5)


def test_flash_tf32_kernel_at_the_1024px_vae_shape():
    """The f32 flash kernel at T = S = 16384, D = 512, one head (the SDXL-turbo
    decode's mid-block attention in f32): 256 row tiles, each of two column
    halves, 512 key tiles of 32; within 1e-4 of the plain version."""
    q, k, v = _qkv(1, 16384, 16384, 512, torch.float32, seed=5)
    q, k = q * 0.25, k * 0.25  # keep the softmax from collapsing onto one key
    out = TA.fused_attention(q, k, v, 512 ** -0.5, sm_mode="none")
    torch.cuda.synchronize()
    _check(out, TA.attention_reference(q, k, v, 512 ** -0.5), v, torch.float32)


PACKED_MODES = [("none", False), ("uniform", False), ("log2", False), ("log2", True),
                ("uniform", True), ("log2_real_time", False), ("log2_real_time", True)]
PACKED_COUNTERS = {"none": ("flash_attention_packed",),
                   "uniform": ("static_uniform_attention_packed",),
                   "log2": ("static_quant_attention_packed",),
                   "uniform+sp": ("static_quant_attention_packed",),
                   "log2_real_time": ("rt_stats_packed", "quant_accum_packed")}


def _packed_case(b, h, t, s, d, dp, dtype, seed):
    """Classic (B*H, T, d) q, k, v and their packed (B, T, H*dp) forms."""
    q, k, v = _qkv(b * h, t, s, d, dtype, seed)
    return (q, k, v), tuple(TA.repack_heads(x, h, dp) for x in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,sp", PACKED_MODES)
@pytest.mark.parametrize("t,s", [(200, 77), (256, 256)])
@pytest.mark.parametrize("h,d,dp", [(8, 40, 64), (8, 80, 128), (8, 160, 256), (10, 64, 64),
                                    (3, 40, 128)])
def test_packed_kernel_equals_unpacked_kernel_and_plain(h, d, dp, t, s, mode, sp, dtype):
    b = 2
    classic, packed = _packed_case(b, h, t, s, d, dp, dtype, seed=d + s + h)
    sm_delta = {"uniform": torch.tensor(1.0 / 64.0, device="cuda", dtype=dtype),
                "log2": torch.tensor(0.7, device="cuda", dtype=dtype)}.get(mode)
    kw = dict(sm_mode=mode, sm_bits=8, sm_delta=sm_delta, start_peak=sp)
    want = TA.fused_attention(*classic, d ** -0.5, **kw)
    before = dict(TA.LAUNCHES)
    # the output's memory holds NaN before the launch
    buf = torch.full((b, t, h * dp), float("nan"), device="cuda", dtype=dtype)
    out = TA.fused_attention(*packed, d ** -0.5, num_heads=h, head_dim=d, out=buf, **kw)
    torch.cuda.synchronize()
    counters = PACKED_COUNTERS["uniform+sp" if (mode == "uniform" and sp) else mode]
    for name in TA.LAUNCHES:
        assert TA.LAUNCHES[name] == before[name] + (name in counters), name
    assert out is buf and out.shape == (b, t, h * dp)
    assert bool((out.reshape(b, t, h, dp)[..., d:] == 0).all())   # zeros, not NaN * 0
    assert torch.equal(TA.unpack_heads(out, h, d), want)          # bit for bit
    ref = TA.packed_attention_reference(*packed, d ** -0.5, h, d, mode, 8, sm_delta, sp)
    if mode == "none" and dtype == torch.bfloat16:
        _check_flash(TA.unpack_heads(out, h, d), *classic, d ** -0.5)
    elif mode == "none":
        _check(out, ref, packed[2], dtype)
    elif mode == "uniform" and not sp:
        _check(out, ref, packed[2], dtype, float(sm_delta))
    else:
        assert _mismatch_share(out, ref, dtype) < 5e-4


@pytest.mark.parametrize("mode,sp", PACKED_MODES)
def test_packed_kernel_contracts_the_whole_slot_without_head_dim(mode, sp):
    """head_dim left out: the kernel contracts over all dp lanes of the slot,
    zeros included, and gives the same bits."""
    (_, _, _), packed = _packed_case(2, 4, 130, 77, 40, 64, torch.bfloat16, seed=7)
    sm_delta = torch.tensor(0.5, device="cuda") if mode in ("uniform", "log2") else None
    kw = dict(sm_mode=mode, sm_delta=sm_delta, start_peak=sp, num_heads=4)
    assert torch.equal(TA.fused_attention(*packed, 40 ** -0.5, **kw),
                       TA.fused_attention(*packed, 40 ** -0.5, head_dim=40, **kw))


@pytest.mark.parametrize("mode,sp", [("none", False), ("uniform", False),
                                     ("log2_real_time", True), ("log2", True)])
def test_packed_kernel_reads_offset_views(mode, sp):
    """q, k and v as views: column blocks of one fused (B, T, 3*H*dp)
    projection output (rows three times as far apart, a storage offset), a
    batch slice, and a buffer that starts one element off any 16-byte
    boundary; the output as a view too."""
    b, h, t, d, dp = 3, 8, 96, 40, 64
    c = h * dp
    _, (q, k, v) = _packed_case(b, h, t, t, d, dp, torch.bfloat16, seed=11)
    sm_delta = torch.tensor(0.5, device="cuda") if mode in ("uniform", "log2") else None
    kw = dict(sm_mode=mode, sm_delta=sm_delta, start_peak=sp, num_heads=h, head_dim=d)
    want = TA.fused_attention(q, k, v, d ** -0.5, **kw)
    fused = torch.cat([q, k, v], dim=-1)
    qv, kv, vv = fused[..., :c], fused[..., c:2 * c], fused[..., 2 * c:]
    assert not qv.is_contiguous() and kv.storage_offset() == c
    assert torch.equal(TA.fused_attention(qv, kv, vv, d ** -0.5, **kw), want)
    assert torch.equal(TA.fused_attention(qv[1:], kv[1:], vv[1:], d ** -0.5, **kw)[0],
                       TA.fused_attention(q[1:], k[1:], v[1:], d ** -0.5, **kw)[0])
    flat = torch.empty(q.numel() + 1, device="cuda", dtype=q.dtype)
    odd = flat[1:].view_as(q).copy_(q)
    assert odd.data_ptr() % 16 != 0
    assert torch.equal(TA.fused_attention(odd, k, v, d ** -0.5, **kw), want)
    wide = torch.full((b, t, 2 * c), float("nan"), device="cuda", dtype=q.dtype)
    got = TA.fused_attention(q, k, v, d ** -0.5, out=wide[..., c:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool(wide[..., :c].isnan().all())


def test_packed_real_time_delta_spans_batches_and_heads_on_the_card():
    """K3p's one delta: rt_stats_packed's scalar equals the classic call's
    over all B*H heads, and z lies in (B*H, T) order."""
    classic, packed = _packed_case(2, 8, 200, 77, 40, 64, torch.float32, seed=3)
    for sp in (False, True):
        z, red = TA.rt_stats(classic[0], classic[1], 40 ** -0.5, sp)
        zp, redp = TA.rt_stats_packed(packed[0], packed[1], 40 ** -0.5, 8, 40, sp)
        torch.cuda.synchronize()
        assert torch.equal(z, zp) and torch.equal(red, redp)


def test_packed_wrapper_rejects_bad_inputs():
    _, (q, k, v) = _packed_case(2, 8, 64, 77, 160, 256, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="contiguous last axis"):
        TA.flash_attention_packed(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 0.1, 8)
    with pytest.raises(ValueError, match="pass the true head_dim"):
        TA.log2_real_time_attention_packed(q, k, v, 0.1, 8)  # a 256-wide slot, quantized
    with pytest.raises(ValueError, match="out must be"):
        TA.flash_attention_packed(q, k, v, 0.1, 8, 160, out=torch.empty_like(k))
    with pytest.raises(ValueError, match="even head count"):
        x = torch.zeros(1, 8, 3 * 64, device="cuda")
        TA.flash_attention_packed(x, x, x, 0.1, 3)
    with pytest.raises(ValueError, match="dtype"):
        TA.flash_attention_packed(q.half(), k.half(), v.half(), 0.1, 8, 160)
    with pytest.raises(ValueError, match="65535"):
        x = torch.zeros(8192, 1, 8 * 64, device="cuda")
        TA.flash_attention_packed(x, x, x, 0.1, 8)
    # the 256-wide slot is fine unquantized, and quantized with its true width
    assert TA.flash_attention_packed(q, k, v, 0.1, 8).shape == q.shape
    assert TA.log2_real_time_attention_packed(q, k, v, 0.1, 8, 160).shape == q.shape


def _quant_run(kind, q, k, v, sp, heads=None, d=None, zr=None):
    """One launch of a tensor-core quantizing kernel (K1, rt_stats,
    quant_accum or K4 in its log2 or uniform form), classic or, with `heads`,
    packed; returns what it wrote. quant_accum reads the given (z, red)."""
    scale = (d or q.shape[-1]) ** -0.5
    if kind.startswith("static_"):
        mode = kind[len("static_"):]
        delta = torch.tensor(0.5 if mode == "log2" else 1.0 / 255.0, device="cuda")
        if heads is None:
            return (TA.static_quant_attention(q, k, v, scale, mode, delta, 8, sp),)
        return (TA.static_quant_attention_packed(q, k, v, scale, mode, delta, heads, d, 8, sp),)
    if kind == "uniform":
        delta = torch.tensor(1.0 / 255.0, device="cuda")
        if heads is None:
            return (TA.static_uniform_attention(q, k, v, scale, delta),)
        return (TA.static_uniform_attention_packed(q, k, v, scale, delta, heads, d),)
    if kind == "rt_stats":
        if heads is None:
            return TA.rt_stats(q, k, scale, sp)
        return TA.rt_stats_packed(q, k, scale, heads, d, sp)
    if heads is None:
        return (TA.quant_accum(q, k, v, *zr, scale, 8, sp),)
    return (TA.quant_accum_packed(q, k, v, *zr, scale, heads, d, 8, sp),)


QUANT_LAUNCHES = {"uniform": "static_uniform_attention", "rt_stats": "rt_stats",
                  "quant_accum": "quant_accum", "static_log2": "static_quant_attention",
                  "static_uniform": "static_quant_attention"}
QUANT_CASES = [(kind, t, s, d, sp)
               for kind in ("uniform", "rt_stats", "quant_accum", "static_log2", "static_uniform")
               for t, s, d in [(200, 77, 40), (129, 300, 64), (64, 65, 80), (70, 77, 160),
                               (50, 33, 36), (31, 77, 100), (40, 64, 192)]
               for sp in ((False,) if kind == "uniform" else
                          (True,) if kind == "static_uniform" else (False, True))
               if d <= 160 or kind == "uniform"]


@pytest.mark.parametrize("kind,t,s,d,sp", QUANT_CASES)
def test_quant_tensor_core_forms_agree(kind, t, s, d, sp):
    """The bf16 quantizing kernels on the tensor cores at every head-dim tier,
    ragged T and S: the form the wrapper picks for aligned tensors (16-byte
    copies where head_dim is a multiple of 8, element loads where not), the
    element-load form it picks for each input one element off a 16-byte
    boundary, and the packed entry on the same heads (aligned, then
    misaligned) write the same bits."""
    bf = torch.bfloat16
    q, k, v = _qkv(4, t, s, d, bf, seed=t + s + d + sp)
    scale = d ** -0.5
    strides = (t * d, d, s * d, d, s * d, d)
    want = "wgmma_async" if d % 8 == 0 else "wgmma_plain"
    assert TA.quant_form(bf, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()), strides) == want
    zr = TA.rt_stats(q, k, scale, sp) if kind == "quant_accum" else None
    name = QUANT_LAUNCHES[kind]
    before = TA.LAUNCHES[name]
    out = _quant_run(kind, q, k, v, sp, zr=zr)
    torch.cuda.synchronize()
    assert TA.LAUNCHES[name] == before + 1
    if kind == "uniform":  # inside the tolerance of test_static_uniform_kernel_matches_plain
        _check(out[0], TA.attention_reference(q, k, v, scale, "uniform", 8,
                                              torch.tensor(1.0 / 255.0)), v, bf, 1.0 / 255.0)
    if kind.startswith("static_"):  # inside test_static_quant_kernel_matches_plain's share
        mode = kind[len("static_"):]
        delta = torch.tensor(0.5 if mode == "log2" else 1.0 / 255.0)
        ref = TA.attention_reference(q, k, v, scale, mode, 8, delta, sp)
        assert _mismatch_share(out[0], ref, bf) < 5e-4
    for which in range(2 if kind == "rt_stats" else 3):
        args = [q, k, v]
        x = args[which]
        args[which] = torch.empty(x.numel() + 1, device="cuda", dtype=bf)[1:].view_as(x).copy_(x)
        assert TA.quant_form(bf, d, tuple(a.data_ptr() for a in args), strides) == "wgmma_plain"
        got = _quant_run(kind, *args, sp, zr=zr)
        assert all(torch.equal(a, b) for a, b in zip(got, out)), which
    h, dp = 2, 64 if d <= 64 else (128 if d <= 128 else 256)
    b = q.shape[0] // h
    qp, kp, vp = (TA.repack_heads(x, h, dp) for x in (q, k, v))
    packed = _quant_run(kind, qp, kp, vp, sp, heads=h, d=d, zr=zr)
    flat = torch.empty(qp.numel() + 1, device="cuda", dtype=bf)
    odd = flat[1:].view_as(qp).copy_(qp)
    assert TA.quant_form(bf, d, (odd.data_ptr(),), (t * h * dp, h * dp), dp) == "wgmma_plain"
    packed_odd = _quant_run(kind, odd, kp, vp, sp, heads=h, d=d, zr=zr)
    torch.cuda.synchronize()
    if kind == "rt_stats":
        assert all(torch.equal(a, c) and torch.equal(a, e)
                   for a, c, e in zip(out, packed, packed_odd))
    else:
        assert tuple(packed[0].shape) == (b, t, h * dp)
        assert torch.equal(TA.unpack_heads(packed[0], h, d), out[0])
        assert torch.equal(packed_odd[0], packed[0])


def test_quant_kernels_refuse_a_form_their_inputs_cannot_take():
    """The C entries of K1, rt_stats and quant_accum check the form they are
    handed: 16-byte copies from a misaligned view, the tensor-core body on
    f32, with scale <= 0, past head_dim 192 or, for K1, with codes past 256,
    and rt_stats or quant_accum on the CUDA-core body in bf16 return an error
    instead of launching. K1's CUDA-core body takes bf16 (head dims past
    192)."""
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    bf = torch.bfloat16
    q, k, v = _qkv(2, 64, 64, 40, bf, seed=1)
    odd = torch.empty(q.numel() + 1, device="cuda", dtype=bf)[1:].view_as(q).copy_(q)
    wide = torch.zeros(2, 64, 200, device="cuda", dtype=bf)
    out = torch.empty(2, 64, 200, device="cuda", dtype=bf)
    z = torch.zeros(2, 64, device="cuda")
    red = torch.ones(1, device="cuda")
    delta = torch.tensor([1.0 / 255.0], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def uni(qq, bf16, form, d=40, bits=8, scale=0.1, kk=k, vv=v):
        return lib.dgq_uniform_attention(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                         out.data_ptr(), 2, 64, 64, d, scale, delta.data_ptr(),
                                         bits, bf16, form, stream)

    def stats(qq, bf16, form, d=40, scale=0.1):
        return lib.dgq_rt_stats(qq.data_ptr(), k.data_ptr(), z.data_ptr(), red.data_ptr(), 2,
                                64, 64, d, scale, 0, bf16, form, stream)

    def accum(qq, bf16, form, d=40, scale=0.1):
        return lib.dgq_quant_accum(qq.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   z.data_ptr(), red.data_ptr(), 2, 64, 64, d, scale, 8, 0, bf16,
                                   form, stream)

    for fn in (uni, stats, accum):
        assert fn(q, 1, 1) == 0 and fn(q, 1, 2) == 0 and fn(odd, 1, 2) == 0
        assert fn(odd, 1, 1) != 0          # 16-byte copies from a misaligned base
        assert fn(q, 1, 1, d=36) != 0      # 72-byte rows
        assert fn(q, 1, 2, scale=0.0) != 0 and fn(q, 1, 1, scale=-0.1) != 0
        assert fn(q, 1, 3) != 0
    assert uni(q, 1, 0) == 0               # K1's CUDA-core body takes bf16
    assert stats(q, 1, 0) != 0 and accum(q, 1, 0) != 0
    assert uni(q, 1, 1, bits=9) != 0 and uni(q, 1, 0, bits=9) == 0
    assert uni(wide, 1, 2, d=200, kk=wide, vv=wide) != 0
    assert uni(wide, 1, 0, d=200, kk=wide, vv=wide) == 0
    torch.cuda.synchronize()
    q32 = q.float()
    for fn in (uni, stats, accum):
        assert fn(q32, 0, 1) != 0          # f32 has no tensor-core body


def test_static_quant_kernel_refuses_a_form_its_inputs_cannot_take():
    """K4's C entries check the form they are handed: 16-byte copies from a
    misaligned view, the tensor-core body on f32, with scale <= 0, past
    head_dim 192 or with uniform codes past 256 return an error; its
    CUDA-core body takes f32 only (no bf16 instance of it is built)."""
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    bf = torch.bfloat16
    q, k, v = _qkv(2, 64, 64, 40, bf, seed=2)
    odd = torch.empty(q.numel() + 1, device="cuda", dtype=bf)[1:].view_as(q).copy_(q)
    out = torch.empty(2, 64, 200, device="cuda", dtype=bf)
    delta = torch.tensor([0.5], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def static(qq, bf16, form, d=40, bits=8, uniform=0, scale=0.1):
        return lib.dgq_static_quant_attention(qq.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              out.data_ptr(), 2, 64, 64, d, scale,
                                              delta.data_ptr(), bits, uniform, 1, bf16, form,
                                              stream)

    for uniform in (0, 1):
        assert static(q, 1, 1, uniform=uniform) == 0 and static(odd, 1, 2, uniform=uniform) == 0
        assert static(odd, 1, 1, uniform=uniform) != 0
        assert static(q, 1, 1, d=36, uniform=uniform) != 0
        assert static(q, 1, 2, scale=0.0, uniform=uniform) != 0
        assert static(q, 1, 0, uniform=uniform) != 0      # no bf16 CUDA-core body
        assert static(q, 1, 2, d=200, uniform=uniform) != 0
        assert static(q.float(), 0, 1, uniform=uniform) != 0
    assert static(q, 1, 1, bits=9, uniform=1) != 0        # 511 is not exact in bf16
    assert static(q, 1, 1, bits=9, uniform=0) == 0        # log2 codes are exponents
    torch.cuda.synchronize()


TF32_QUANT_CASES = [(kind, t, s, d, sp)
                    for kind in ("uniform", "rt_stats", "quant_accum", "static_log2",
                                 "static_uniform")
                    for t, s, d in [(200, 77, 40), (129, 300, 64), (64, 65, 80), (70, 77, 160),
                                    (50, 33, 36), (31, 77, 100), (40, 64, 42)]
                    for sp in ((False,) if kind == "uniform" else
                               (True,) if kind == "static_uniform" else (False, True))]


@pytest.mark.parametrize("kind,t,s,d,sp", TF32_QUANT_CASES)
def test_quant_tf32_forms_agree(kind, t, s, d, sp):
    """The f32 quantizing kernels on the tensor cores (body (e): three TF32
    products for Q K^T, two for P V) at every head-dim tier, ragged T and S:
    the form the wrapper picks for aligned tensors (16-byte loads where
    head_dim is a multiple of 4, element loads where not); the element-load
    form it picks for each input one element off a 16-byte boundary, and the
    packed entry on the same heads (aligned, then misaligned), write the same
    bits. The uniform codes (K1, K4 uniform) are held to the plain version
    within `_check` with delta, rt_stats' z within 1e-4 and its scalar within
    1e-5 relative. The log2 codes are held to it where there are rows enough
    for the share bound (test_log2_real_time_kernels_match_plain,
    test_static_quant_kernel_matches_plain): at a few hundred rows one flip of
    a row's dominant probability at a half-integer exponent moves the whole
    row, more than the bound's 5e-4 of the outputs."""
    f32 = torch.float32
    q, k, v = _qkv(4, t, s, d, f32, seed=t + s + d + sp)
    scale = d ** -0.5
    strides = (t * d, d, s * d, d, s * d, d)
    want = "tf32x3_vector" if d % 4 == 0 else "tf32x3_plain"
    assert TA.quant_form(f32, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()), strides) == want
    zr = TA.rt_stats(q, k, scale, sp) if kind == "quant_accum" else None
    name = QUANT_LAUNCHES[kind]
    before = TA.LAUNCHES[name]
    out = _quant_run(kind, q, k, v, sp, zr=zr)
    torch.cuda.synchronize()
    assert TA.LAUNCHES[name] == before + 1
    if kind == "uniform":
        delta = torch.tensor(1.0 / 255.0)
        _check(out[0], TA.attention_reference(q, k, v, scale, "uniform", 8, delta), v, f32,
               1.0 / 255.0)
    elif kind == "static_uniform":
        delta = torch.tensor(1.0 / 255.0)
        _check(out[0], TA.attention_reference(q, k, v, scale, "uniform", 8, delta, True), v, f32,
               1.0 / 255.0)
    elif kind == "rt_stats":
        z_ref, red_ref = TA.rt_stats_reference(q, k, scale, sp)
        assert float((out[0] - z_ref).abs().max()) <= 1e-4
        assert float(((out[1] - red_ref) / red_ref).abs()) <= 1e-5
    for which in range(2 if kind == "rt_stats" else 3):
        args = [q, k, v]
        x = args[which]
        args[which] = torch.empty(x.numel() + 1, device="cuda", dtype=f32)[1:].view_as(x).copy_(x)
        assert TA.quant_form(f32, d, tuple(a.data_ptr() for a in args), strides) == "tf32x3_plain"
        got = _quant_run(kind, *args, sp, zr=zr)
        assert all(torch.equal(a, b) for a, b in zip(got, out)), which
    h, dp = 2, 64 if d <= 64 else (128 if d <= 128 else 256)
    b = q.shape[0] // h
    qp, kp, vp = (TA.repack_heads(x, h, dp) for x in (q, k, v))
    packed = _quant_run(kind, qp, kp, vp, sp, heads=h, d=d, zr=zr)
    odd = torch.empty(qp.numel() + 1, device="cuda", dtype=f32)[1:].view_as(qp).copy_(qp)
    assert TA.quant_form(f32, d, (odd.data_ptr(),), (t * h * dp, h * dp), dp) == "tf32x3_plain"
    packed_odd = _quant_run(kind, odd, kp, vp, sp, heads=h, d=d, zr=zr)
    torch.cuda.synchronize()
    if kind == "rt_stats":
        assert all(torch.equal(a, c) and torch.equal(a, e)
                   for a, c, e in zip(out, packed, packed_odd))
    else:
        assert tuple(packed[0].shape) == (b, t, h * dp)
        assert torch.equal(TA.unpack_heads(packed[0], h, d), out[0])
        assert bool((packed[0].reshape(b, t, h, dp)[..., d:] == 0).all())
        assert torch.equal(packed_odd[0], packed[0])


def test_quant_tf32_refuses_what_it_cannot_take():
    """The C entries of K1, rt_stats, quant_accum and K4 check the f32
    tensor-core forms they are handed: 16-byte loads from a misaligned view
    or with head_dim no multiple of 4, either form on bf16, a scale <= 0, head
    dims past 160, uniform codes past 2048. The CUDA-core body (form 0) takes
    K1 and K4 in f32 past all of these but the dtype; rt_stats and
    quant_accum, classic and packed, refuse it. Body (f) (form 5) is
    rt_stats' and quant_accum's in the classic layout alone, at head dims up
    to 64 with form 3's alignment."""
    import ctypes

    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    q, k, v = _qkv(2, 64, 64, 40, torch.float32, seed=5)
    qb = q.bfloat16()
    odd = torch.empty(q.numel() + 1, device="cuda")[1:].view_as(q).copy_(q)
    wide = torch.zeros(2, 64, 200, device="cuda")
    out = torch.empty(2, 64, 200, device="cuda")
    z = torch.zeros(2, 64, device="cuda")
    red = torch.ones(1, device="cuda")
    delta = torch.tensor([1.0 / 255.0], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def uni(qq, bf16, form, d=40, bits=8, scale=0.1, kk=k, vv=v):
        return lib.dgq_uniform_attention(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                         out.data_ptr(), 2, 64, 64, d, scale, delta.data_ptr(),
                                         bits, bf16, form, stream)

    def stats(qq, bf16, form, d=40, scale=0.1, kk=k, vv=None):
        return lib.dgq_rt_stats(qq.data_ptr(), kk.data_ptr(), z.data_ptr(), red.data_ptr(), 2,
                                64, 64, d, scale, 0, bf16, form, stream)

    def accum(qq, bf16, form, d=40, scale=0.1, kk=k, vv=v):
        return lib.dgq_quant_accum(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), out.data_ptr(),
                                   z.data_ptr(), red.data_ptr(), 2, 64, 64, d, scale, 8, 0, bf16,
                                   form, stream)

    def static(qq, bf16, form, d=40, bits=8, scale=0.1, kk=k, vv=v, uniform=1):
        return lib.dgq_static_quant_attention(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                              out.data_ptr(), 2, 64, 64, d, scale,
                                              delta.data_ptr(), bits, uniform, 1, bf16, form,
                                              stream)

    for fn in (uni, stats, accum, static):
        assert fn(q, 0, 3) == 0 and fn(q, 0, 4) == 0 and fn(odd, 0, 4) == 0
        assert fn(odd, 0, 3) != 0          # 16-byte loads from a misaligned base
        assert fn(q, 0, 3, d=38) != 0      # 152-byte rows
        assert fn(q, 0, 4, scale=0.0) != 0 and fn(q, 0, 3, scale=-0.1) != 0
        assert fn(qb, 1, 3) != 0 and fn(qb, 1, 4) != 0  # bf16 on the f32 body
        assert fn(q, 0, 1) != 0 and fn(q, 0, 2) != 0    # f32 on the bf16 body
        assert fn(wide, 0, 4, d=200, kk=wide, vv=wide) != 0  # past head_dim 160
        assert fn(q, 0, 6) != 0
    for fn in (uni, static):
        assert fn(q, 0, 0, scale=-0.1) == 0  # the CUDA-core body takes any scale
        assert fn(q, 0, 5) != 0              # body (f) is K3b's alone
    for fn in (stats, accum):
        assert fn(q, 0, 0) != 0 and fn(q, 0, 0, scale=-0.1) != 0  # no CUDA-core body
        assert fn(q, 0, 5) == 0 and fn(odd, 0, 5) != 0 and fn(q, 0, 5, d=38) != 0
        assert fn(q, 0, 5, scale=0.0) != 0 and fn(qb, 1, 5) != 0
        assert fn(wide, 0, 5, d=80, kk=wide, vv=wide) != 0  # past head_dim 64
    strides = (ctypes.c_longlong * 8)(*(64 * 40, 40) * 4)  # (2, 64, 1 * 40) packed views

    def stats_packed(form):
        return lib.dgq_rt_stats_packed(q.data_ptr(), k.data_ptr(), z.data_ptr(), red.data_ptr(),
                                       2, 1, 64, 64, 40, 40, strides, 0.1, 0, 0, form, stream)

    def accum_packed(form):
        return lib.dgq_quant_accum_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), z.data_ptr(), red.data_ptr(), 2, 1, 64,
                                          64, 40, 40, strides, 0.1, 8, 0, 0, form, stream)

    for fn in (stats_packed, accum_packed):
        assert fn(3) == 0 and fn(0) != 0 and fn(5) != 0
    assert uni(q, 0, 3, bits=11) == 0 and uni(q, 0, 3, bits=12) != 0  # 2047 and 4095
    assert static(q, 0, 4, bits=12) != 0 and static(q, 0, 4, bits=12, uniform=0) == 0
    assert uni(q, 0, 0, bits=12) == 0 and uni(wide, 0, 0, d=200, kk=wide, vv=wide) == 0
    torch.cuda.synchronize()


# Body (f) (form 5) against body (e) (form 3): head dims 40 (SD's tier, lanes
# past d zeros; 36 in it) and 64; T and S ragged against the 64-key tiles and
# the 128-row blocks, SD3's joint length 4429 on a few heads, a T whose last
# block leaves the second consumer without rows, S from 128 (the least that
# `k3b_form` routes).
K3B_TMA_CASES = [(launch, bh, t, s, d, sp)
                 for launch in ("rt_stats", "quant_accum")
                 for bh, t, s, d in [(3, 333, 333, 64), (2, 4429, 4429, 64), (2, 4429, 4429, 40),
                                     (4, 200, 128, 40), (4, 50, 333, 64), (3, 129, 300, 36)]
                 for sp in (False, True)]


@pytest.mark.parametrize("launch,bh,t,s,d,sp", K3B_TMA_CASES)
def test_k3b_tma_body_writes_body_e_bits(launch, bh, t, s, d, sp):
    """K3b's f32 body (f) (a producer warpgroup's TMA loads and split, two
    consumer warpgroups at the tensor cores) writes body (e)'s bits through
    the same C entry: rt_stats' z and the call's scalar, and quant_accum's
    output from body (e)'s (z, scalar). The wrappers route these calls to it
    (`k3b_form`), count the launch under "k3b_tma" and return the same bits."""
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    q, k, v = _qkv(bh, t, s, d, torch.float32, seed=t + s + d + sp)
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    ptrs, strides = (q.data_ptr(), k.data_ptr(), v.data_ptr()), (t * d, d, s * d, d, s * d, d)
    assert TA.k3b_form(torch.float32, d, s, ptrs, strides) == "tf32x3_tma"

    def stats(form):
        z = torch.full((bh, t), float("nan"), device="cuda")
        red = torch.full((1,), 0.0 if sp else float("inf"), device="cuda")
        assert lib.dgq_rt_stats(q.data_ptr(), k.data_ptr(), z.data_ptr(), red.data_ptr(), bh, t,
                                s, d, scale, int(sp), 0, form, stream) == 0
        return z, red

    def accum(form, z, red):
        out = torch.full_like(q, float("nan"))
        assert lib.dgq_quant_accum(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   z.data_ptr(), red.data_ptr(), bh, t, s, d, scale, 8, int(sp),
                                   0, form, stream) == 0
        return out

    def bits(*xs):
        return [x.view(torch.int32) for x in xs]

    zr = stats(3)
    before = TA.LAUNCHES["k3b_tma"]
    if launch == "rt_stats":
        want, got, wrapped = zr, stats(5), TA.rt_stats(q, k, scale, sp)
    else:
        want, got = (accum(3, *zr),), (accum(5, *zr),)
        wrapped = (TA.quant_accum(q, k, v, *zr, scale, 8, sp),)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["k3b_tma"] == before + 1
    assert bool(torch.isfinite(got[0]).all())
    for a, b, c in zip(bits(*want), bits(*got), bits(*wrapped)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_f32_log2_codes_past_126_keep_the_cuda_core_bound():
    """At delta 4 the log2 codes reach exponent_field(delta) - 1 = 128: the f32
    tensor-core body keeps the codes past 126 that the bf16 body caps, so its
    output agrees with the CUDA-core body (form 0) and the plain version
    within the log2 share bound."""
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    g = torch.Generator(device="cuda").manual_seed(6)
    q = 8.0 * torch.randn(2, 64, 64, generator=g, device="cuda")  # scores spread past 90 nats
    k = 8.0 * torch.randn(2, 256, 64, generator=g, device="cuda")
    v = torch.randn(2, 256, 64, generator=g, device="cuda")
    delta = torch.tensor([4.0], device="cuda")
    scale = 64 ** -0.5
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    assert bool((torch.round(-torch.log2(p / 4.0)) > 126).any())  # the inputs reach past 126
    out = TA.static_quant_attention(q, k, v, scale, "log2", delta)
    old = torch.empty_like(out)
    rc = lib.dgq_static_quant_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), old.data_ptr(),
                                        2, 64, 256, 64, scale, delta.data_ptr(), 8, 0, 0, 0, 0,
                                        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    ref = TA.attention_reference(q, k, v, scale, "log2", 8, delta)
    torch.cuda.synchronize()
    assert _mismatch_share(out, ref, torch.float32) < 5e-4
    assert _mismatch_share(out, old, torch.float32) < 5e-4


@pytest.mark.parametrize("packed", [False, True])
def test_bf16_static_uniform_codes_past_256_take_the_f32_kernel(packed):
    """bf16 K4 / K4p with 9-bit uniform codes: `quant_form` sends them to the
    CUDA-core body, which runs on f32 copies; the result, rounded to bf16
    once, is inside the bf16 tolerance of the plain version and equals the
    f32 kernel's result rounded to bf16."""
    classic, pk = _packed_case(2, 2, 130, 77, 40, 64, torch.bfloat16, seed=8)
    args, kw = (pk, dict(num_heads=2, head_dim=40)) if packed else (classic, {})
    delta = torch.tensor(1.0 / 511.0, device="cuda")
    before = TA.LAUNCHES["static_quant_attention_packed" if packed else "static_quant_attention"]
    out = TA.fused_attention(*args, 40 ** -0.5, sm_mode="uniform", sm_bits=9, sm_delta=delta,
                             start_peak=True, **kw)
    torch.cuda.synchronize()
    name = "static_quant_attention_packed" if packed else "static_quant_attention"
    assert TA.LAUNCHES[name] == before + 1 and out.dtype == torch.bfloat16
    f32 = TA.fused_attention(*(x.float() for x in args), 40 ** -0.5, sm_mode="uniform", sm_bits=9,
                             sm_delta=delta, start_peak=True, **kw)
    assert torch.equal(out, f32.bfloat16())
    ref = (TA.packed_attention_reference(*args, 40 ** -0.5, 2, 40, "uniform", 9, delta, True)
           if packed else TA.attention_reference(*args, 40 ** -0.5, "uniform", 9, delta, True))
    assert _mismatch_share(out, ref, torch.bfloat16) < 5e-4


@pytest.mark.parametrize("mode,sp", [("uniform", False), ("log2_real_time", False),
                                     ("log2_real_time", True)])
@pytest.mark.parametrize("packed", [False, True])
def test_bf16_quantizing_call_with_a_non_positive_scale_raises(mode, sp, packed):
    """The tensor-core bodies take the row max on raw scores: a bf16 or f32 K1
    or K3 call with scale <= 0 raises before it launches anything; the
    CUDA-core body, which takes any scale, runs f32 past head_dim 160 (K1)."""
    classic, pk = _packed_case(2, 2, 64, 77, 40, 64, torch.bfloat16, seed=4)
    args, kw = (pk, dict(num_heads=2, head_dim=40)) if packed else (classic, {})
    delta = torch.tensor(1.0 / 255.0, device="cuda") if mode == "uniform" else None
    before = dict(TA.LAUNCHES)
    for scale in (0.0, -0.1):
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="positive scale"):
                TA.fused_attention(*(x.to(dtype) for x in args), scale, sm_mode=mode,
                                   sm_delta=delta, start_peak=sp, **kw)
    assert TA.LAUNCHES == before
    if mode == "uniform" and not packed:
        q, k, v = _qkv(2, 64, 77, 200, torch.float32, seed=4)
        out = TA.fused_attention(q, k, v, -0.1, sm_mode=mode, sm_delta=delta)
        ref = TA.attention_reference(q, k, v, -0.1, mode, 8, delta)
        torch.cuda.synchronize()
        _check(out, ref, v, torch.float32, 1.0 / 255.0)


def _conv_case(b, h, c, o, dtype, seed, zp=(100.0, 156.0), dl=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2.0 * torch.randn(b, h, h, c, generator=g, device="cuda")).to(dtype)
    w = (torch.randn(3, 3, c, o, generator=g, device="cuda") / (9 * c) ** 0.5).to(dtype)
    dm = 0.02 + 0.06 * torch.rand(9, c, generator=g, device="cuda")
    zm = zp[0] + (zp[1] - zp[0]) * torch.rand(9, c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(o, generator=g, device="cuda")
    return x, w, dm, zm, torch.tensor([dl], device="cuda"), torch.zeros(1, device="cuda"), bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,c,o,zp,dl,a_bits", [
    (2, 16, 32, 64, (100.0, 156.0), 1.0, 8),
    (1, 9, 40, 24, (100.0, 156.0), 1.0, 8),      # ragged pixels, channels and outputs
    (2, 8, 96, 130, (-40.0, 300.0), 1.0, 8),     # zero points outside [0, 255]
    (2, 8, 64, 64, (100.0, 156.0), 1.37, 8),     # delta_last folded into the weights
    (2, 8, 64, 64, (20.0, 40.0), 1.0, 6),        # A6
    (4, 8, 2560, 1280, (100.0, 156.0), 1.0, 8),  # the widest conv of the main path
])
def test_group_conv_kernel_matches_plain(b, h, c, o, zp, dl, a_bits, dtype):
    args = _conv_case(b, h, c, o, dtype, seed=c + o, zp=zp, dl=dl)
    before = TG.LAUNCHES["group_quant_conv"]
    out = TG.group_quant_conv(*args, kh=3, kw=3, padding=1, a_bits=a_bits)
    torch.cuda.synchronize()
    assert TG.LAUNCHES["group_quant_conv"] == before + 1
    ref = TG.group_quant_conv_reference(*args, kh=3, kw=3, padding=1, a_bits=a_bits)
    assert out.shape == ref.shape == (b, h, h, o) and out.dtype == dtype
    err = (out.float() - ref.float()).abs()
    bound = 2e-3 + (2.0 ** -7 * ref.float().abs() if dtype == torch.bfloat16 else 0.0)
    assert bool((err <= bound).all()), float((err - bound).max())
    assert float(ref.float().abs().max()) > 0.5


@pytest.mark.parametrize("b,h,c,o,form,split", [
    (2, 16, 64, 128, "tensor_core", False),    # whole tiles
    (1, 9, 40, 24, "tensor_core", False),      # ragged pixels, C < 64, O < 64
    (2, 8, 96, 136, "tensor_core", True),      # C and O past a tile edge, split K
    (4, 8, 1280, 1280, "tensor_core", True),   # the 8 x 8 shape class: few tiles, deep K
    (4, 16, 640, 1280, "tensor_core", True),
    (2, 32, 320, 320, "tensor_core", True),    # one tile of outputs, 16 of pixels
    (4, 32, 64, 704, "tensor_core", False),    # O = 2.2 tiles
    (2, 16, 4, 320, "cuda_core", False),       # conv_in
    (2, 16, 320, 4, "cuda_core", False),       # conv_out
    (1, 9, 40, 22, "cuda_core", False),        # O no multiple of 8
])
def test_group_conv_forms_and_the_weight_fold(b, h, c, o, form, split):
    """bf16 at every shape class: the body and the split the plan names, the
    fold kernel's outputs equal to `_fold`'s bit for bit from the HWIO view of
    an OIHW weight (as the model passes it) with f32 and with bf16 scales, the
    result over NaN-free fresh memory within the bound and the same bits on
    a second run."""
    x, w, dm, zm, dl, zl, bias = _conv_case(b, h, c, o, torch.bfloat16, seed=c + o + h)
    w = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)  # OIHW storage, HWIO view
    assert not w.is_contiguous()
    assert TG.conv_form(x.dtype, c, o, x.data_ptr()) == form
    if form == "tensor_core":  # the CUDA-core body follows no plan and never splits
        assert (TG.conv_plan(b * h * h, c, o, 9).splits > 1) == split
    for cast in (torch.float32, torch.bfloat16):
        scales = tuple(t.to(cast) for t in (dm, zm, dl, zl))
        got = TG.fold_weights(x.dtype, w, *scales, 3, 3)
        want = TG._fold(x, w, *scales, 3, 3)
        torch.cuda.synchronize()
        for a, e in zip(got, want):
            assert a.dtype == e.dtype and a.is_contiguous() and torch.equal(a, e)
    args = (x, w, dm, zm, dl, zl, bias)
    out = TG.group_quant_conv(*args)
    ref = TG.group_quant_conv_reference(*args)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2e-3 + 2.0 ** -7 * ref.float().abs()).all())
    assert torch.equal(out, TG.group_quant_conv(*args))
    # the f32 call of the same conv: the 3xTF32 body where bf16 takes the tensor
    # cores (its fold's panels bit for bit), the CUDA-core body elsewhere; the
    # f32 tolerance
    f32 = tuple(t.float() if t is not None else t for t in args)
    want32 = "tf32x3" if form == "tensor_core" else "cuda_core"
    assert TG.conv_form(torch.float32, c, o, 0) == want32
    if want32 == "tf32x3":
        panels, rd, z = TG.fold_weights(torch.float32, f32[1], *f32[2:6], 3, 3, panels=True)
        w_t, rd_ref, z_ref = TG._fold(f32[0], f32[1], *f32[2:6], 3, 3)
        assert torch.equal(panels, TG.fold_panels(w_t))
        assert torch.equal(rd, rd_ref) and torch.equal(z, z_ref)
    err32 = (TG.group_quant_conv(*f32) - TG.group_quant_conv_reference(*f32)).abs()
    assert float(err32.max()) <= 2e-3


@pytest.mark.parametrize("b,h,c,o,split", [
    (4, 64, 320, 320, False),    # 64px: 256 output tiles, no split
    (4, 32, 640, 640, False),    # 32px: 128 output tiles, no split
    (4, 16, 1280, 1280, True),   # 16px
    (4, 8, 2560, 1280, True),    # 8px: 16 tiles, deep K
    (2, 8, 96, 136, True),       # C and O past a tile edge
    (1, 9, 40, 24, True),        # ragged pixels, one 32-channel step and a part: 18 steps in 2
])
def test_group_conv_tf32_shape_classes_with_split_k(b, h, c, o, split):
    """f32 on the tensor cores (three TF32 products a product) at every shape
    class of the main path: the form and split the plan names, within 2e-3 of
    the plain version, the same bits on a second run (split K adds its
    partial tiles in split order)."""
    x, w, dm, zm, dl, zl, bias = _conv_case(b, h, c, o, torch.float32, seed=c + o + h)
    w = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)  # OIHW storage, HWIO view
    assert TG.conv_form(x.dtype, c, o, x.data_ptr()) == "tf32x3"
    assert (TG.conv_plan(b * h * h, c, o, 9, torch.float32).splits > 1) == split
    args = (x, w, dm, zm, dl, zl, bias)
    before = TG.LAUNCHES["group_quant_conv"]
    out = TG.group_quant_conv(*args)
    torch.cuda.synchronize()
    assert TG.LAUNCHES["group_quant_conv"] == before + 1
    ref = TG.group_quant_conv_reference(*args)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 2e-3
    assert torch.equal(out, TG.group_quant_conv(*args))


def test_group_conv_tensor_core_body_takes_a_1x1_conv_and_other_paddings():
    g = torch.Generator(device="cuda").manual_seed(9)
    x = (2.0 * torch.randn(2, 12, 12, 64, generator=g, device="cuda")).bfloat16()
    bias = 0.1 * torch.randn(72, generator=g, device="cuda")
    one = torch.ones(1, device="cuda")
    for kh, pad in ((1, 0), (3, 0), (3, 2)):
        w = (torch.randn(kh, kh, 64, 72, generator=g, device="cuda") / 24.0).bfloat16()
        dm = 0.02 + 0.06 * torch.rand(kh * kh, 64, generator=g, device="cuda")
        zm = 100.0 + 56.0 * torch.rand(kh * kh, 64, generator=g, device="cuda")
        args = (x, w, dm, zm, one, 0 * one, bias)
        out = TG.group_quant_conv(*args, kh=kh, kw=kh, padding=pad)
        ref = TG.group_quant_conv_reference(*args, kh=kh, kw=kh, padding=pad)
        assert out.shape == ref.shape == (2, 12 + 2 * pad - kh + 1, 12 + 2 * pad - kh + 1, 72)
        assert bool(((out.float() - ref.float()).abs()
                     <= 2e-3 + 2.0 ** -7 * ref.float().abs()).all())


def test_group_conv_kernel_refuses_a_plan_that_does_not_cover_k():
    """The C entry checks the split it is handed: too few or too many steps a
    split, a split without its scratch, the tensor-core body on f32."""
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    x, w, dm, zm, dl, zl, bias = _conv_case(1, 8, 64, 64, torch.bfloat16, seed=2)
    w_t, rd, z = TG.fold_weights(x.dtype, w, dm, zm, dl, zl, 3, 3)
    out = torch.empty(1, 8, 8, 64, device="cuda", dtype=x.dtype)
    part = torch.empty(3, 64, 64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(partial, bf16, form, splits, per):
        return lib.dgq_group_quant_conv(
            x.data_ptr(), w_t.data_ptr(), rd.data_ptr(), z.data_ptr(), bias.data_ptr(),
            out.data_ptr(), partial, 1, 8, 8, 64, 64, 3, 3, 1, 8, bf16, form, splits, per, stream)

    assert call(None, 1, 1, 1, 9) == 0 and call(part.data_ptr(), 1, 1, 3, 3) == 0
    assert call(part.data_ptr(), 1, 1, 3, 2) != 0   # 6 of 9 steps
    assert call(part.data_ptr(), 1, 1, 3, 5) != 0   # the third split would be empty
    assert call(None, 1, 1, 3, 3) != 0              # no scratch for the partial tiles
    assert call(None, 0, 1, 1, 9) != 0              # f32 on the tensor-core body
    assert call(None, 1, 0, 2, 5) != 0              # the CUDA-core body does not split
    assert call(None, 1, 2, 1, 9) != 0              # bf16 on the 3xTF32 body
    torch.cuda.synchronize()
    # the 3xTF32 body: 9 taps x 2 steps of 32 channels, on f32 panels
    x32 = x.float()
    panels, rd32, z32 = TG.fold_weights(torch.float32, w.float(), dm, zm, dl, zl, 3, 3, panels=True)
    out32 = torch.empty(1, 8, 8, 64, device="cuda")
    part32 = torch.empty(3, 64, 64, device="cuda")

    def call32(partial, splits, per):
        return lib.dgq_group_quant_conv(
            x32.data_ptr(), panels.data_ptr(), rd32.data_ptr(), z32.data_ptr(), bias.data_ptr(),
            out32.data_ptr(), partial, 1, 8, 8, 64, 64, 3, 3, 1, 8, 0, 2, splits, per, stream)

    assert call32(None, 1, 18) == 0 and call32(part32.data_ptr(), 3, 6) == 0
    assert call32(None, 1, 9) != 0                  # the bf16 plan: half of K
    assert call32(part32.data_ptr(), 3, 9) != 0     # the third split would be empty
    assert call32(None, 3, 6) != 0                  # no scratch
    torch.cuda.synchronize()


def test_group_conv_no_padding_and_no_bias():
    x, w, dm, zm, dl, zl, _ = _conv_case(2, 10, 32, 32, torch.float32, seed=3)
    out = TG.group_quant_conv(x, w, dm, zm, dl, zl, None, kh=3, kw=3, padding=0)
    ref = TG.group_quant_conv_reference(x, w, dm, zm, dl, zl, None, kh=3, kw=3, padding=0)
    assert out.shape == (2, 8, 8, 32)
    assert float((out - ref).abs().max()) <= 2e-3


def _int8_case(m, k, n, dtype, w_bits, a_bits, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (1.5 * torch.randn(m, k, generator=g, device="cuda")).to(dtype)
    lo = 2 ** (w_bits - 1)
    wq = torch.randint(-lo, lo, (n, k), generator=g, device="cuda", dtype=torch.int32).to(torch.int8)
    dw = 0.005 + 0.01 * torch.rand(n, generator=g, device="cuda")
    zw = torch.round(2.0 * torch.randn(n, generator=g, device="cuda"))
    bias = torch.randn(n, generator=g, device="cuda").to(dtype)
    # an activation range that clips on both sides; the zero point off centre
    dx = torch.tensor(6.0 / 2 ** a_bits, device="cuda")
    zp = torch.tensor(float(2 ** (a_bits - 1) + 5), device="cuda")
    return x, wq, dw, zw, dx, zp, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_bits,a_bits", [(4, 8), (8, 8), (4, 6)])
@pytest.mark.parametrize("m,k,n", [
    (256, 320, 384),     # whole tiles
    (308, 768, 320),     # cross to_k: ragged M
    (4, 320, 1280),      # time embedding: one partial row tile
    (2, 2816, 1280),     # SDXL add_embedding.linear_1: K = 44 tiles
    (77, 36, 50),        # K a multiple of 4 only: the scalar loads
    (130, 100, 130),     # ragged M, N and K
    (256, 5120, 1280),   # SD 8px FF-out: the widest K
])
def test_int8_matmul_kernel_matches_plain(m, k, n, w_bits, a_bits, dtype):
    x, wq, dw, zw, dx, zp, bias = _int8_case(m, k, n, dtype, w_bits, a_bits, seed=m + k + a_bits)
    zx = zp - 2 ** (a_bits - 1)
    ksum = wq.sum(dim=1, dtype=torch.int32).float()
    before = TM.LAUNCHES["int8_matmul"]
    out, codes, xsum = TM.quantized_matmul(x, wq, dw, zw, dx, zx, bias, ksum, a_bits=a_bits,
                                           return_codes=True)
    torch.cuda.synchronize()
    assert TM.LAUNCHES["int8_matmul"] == before + 1
    ref = TM.quantized_matmul_reference(x, wq, dw, zw, dx, zx, bias, ksum, a_bits=a_bits)
    assert out.shape == ref.shape == (m, n) and out.dtype == dtype
    # the in-kernel quantizer is quantize_int, bit for bit
    want = quantize_int(x.float(), QParams(dx, zp), a_bits)
    assert torch.equal(codes, want)
    assert torch.equal(xsum, want.float().sum(dim=1))
    assert int(codes.min()) == -(2 ** (a_bits - 1)) and int(codes.max()) == 2 ** (a_bits - 1) - 1
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert bool((err <= 2.0 ** -7 * ref.float().abs()).all()), float(err.max())
    assert float(ref.float().abs().max()) > 0.5
    # without the pack-time sums and without a bias
    out2 = TM.quantized_matmul(x, wq, dw, zw, dx, zx, None, None, a_bits=a_bits)
    ref2 = TM.quantized_matmul_reference(x, wq, dw, zw, dx, zx, None, None, a_bits=a_bits)
    assert float((out2.float() - ref2.float()).abs().max()) <= 2.0 ** -7 * float(ref2.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (4, 320, 1280),      # time embedding: 3 splits of one step
    (2, 2816, 1280),     # SDXL add_embedding.linear_1: 11 splits
    (256, 5120, 1280),   # SD 8px FF-out: 10 splits of 4 steps
    (308, 768, 320),     # cross to_k: ragged M and N, 6 splits
    (333, 1000, 640),    # ragged M and K (K % 16 = 8: element loads), 3 splits
    (77, 1001, 200),     # every edge ragged, odd K
])
def test_int8_matmul_split_and_unsplit_plans_agree(m, k, n, dtype):
    """The plan `int8_plan` gives (K split over blocks where the tiles are
    few) and one unsplit run of the whole K write the same bits, and the same
    codes and row sums (`return_codes`); both equal the plain version within
    its bound; a second split call gives the same bits, so every tile's
    counter was left at 0."""
    x, wq, dw, zw, dx, zp, bias = _int8_case(m, k, n, dtype, 8, 8, seed=m + n)
    zx = zp - 128
    ksum = wq.sum(dim=1, dtype=torch.int32).float()
    plan = TM.int8_plan(m, n, k)
    assert plan.splits > 1
    whole = TM.Int8Plan(plan.m_tiles, plan.n_tiles, plan.steps, 1, plan.steps)
    split = TM.quantized_matmul(x, wq, dw, zw, dx, zx, bias, ksum, return_codes=True)
    one = TM.quantized_matmul(x, wq, dw, zw, dx, zx, bias, ksum, return_codes=True, plan=whole)
    again = TM.quantized_matmul(x, wq, dw, zw, dx, zx, bias, ksum)
    torch.cuda.synchronize()
    for a, b in zip(split, one):
        assert torch.equal(a, b)
    assert torch.equal(again, split[0])
    assert not bool(TM._COUNTERS[x.device].any())
    want = quantize_int(x.float(), QParams(dx, zp), 8)
    assert torch.equal(split[1], want) and torch.equal(split[2], want.float().sum(dim=1))
    ref = TM.quantized_matmul_reference(x, wq, dw, zw, dx, zx, bias, ksum)
    err = (split[0].float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert bool((err <= 2.0 ** -7 * ref.float().abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_element_loads_equal_the_async_copies(dtype):
    """x one element off a 16-byte boundary takes the element-load form, the
    same tiles filled another way: the same bits. A bf16 bias, read as it is,
    gives the bits of its f32 widening."""
    x, wq, dw, zw, dx, zp, bias = _int8_case(300, 640, 384, dtype, 4, 8, seed=5)
    odd = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)[1:].view_as(x).copy_(x)
    assert TM.int8_form(640, x.data_ptr(), wq.data_ptr()) == "cp_async"
    assert TM.int8_form(640, odd.data_ptr(), wq.data_ptr()) == "element"
    args = (wq, dw, zw, dx, zp - 128)
    want = TM.quantized_matmul(x, *args, bias)
    assert torch.equal(TM.quantized_matmul(odd, *args, bias), want)
    b16 = bias.bfloat16()
    assert torch.equal(TM.quantized_matmul(x, *args, b16), TM.quantized_matmul(x, *args, b16.float()))


def test_int8_matmul_reads_scale_and_zero_point_from_the_device():
    """A time-aware slot is a view into a stacked tensor: the kernel reads the
    scalar through a pointer, whatever its dtype."""
    x, wq, dw, zw, _, _, bias = _int8_case(64, 128, 64, torch.bfloat16, 4, 8, seed=4)
    deltas = torch.tensor([0.02, 0.05], device="cuda", dtype=torch.bfloat16)
    zps = torch.tensor([3.0, -4.0], device="cuda", dtype=torch.bfloat16)
    for slot in (0, 1):
        out = TM.quantized_matmul(x, wq, dw, zw, deltas[slot], zps[slot], bias)
        ref = TM.quantized_matmul_reference(x, wq, dw, zw, deltas[slot], zps[slot], bias)
        assert bool(((out.float() - ref.float()).abs() <= 2.0 ** -7 * ref.float().abs()).all())


@pytest.mark.parametrize("dxv", [0.05, 0.1, 1.0 / 3.0, 0.0234375, 1e-3, 0.7])
@pytest.mark.parametrize("zxv", [0.0, -7.0, 5.0, 0.37])
def test_int8_matmul_quantizer_at_rounding_ties(dxv, zxv):
    """The kernel quantizes by the reciprocal of dx and takes the true division
    next to a rounding tie (and for a fractional zero point): on values at the
    half-integer multiples of dx and up to 2 ulps either side of them, the
    codes are those of clip(round(x / dx) + zx, nb, pb) bit for bit."""
    dx = torch.tensor(dxv, device="cuda")
    zx = torch.tensor(zxv, device="cuda")
    j = torch.arange(-160, 160, device="cuda", dtype=torch.float32)
    ties = (j + 0.5) * dx
    up1 = torch.nextafter(ties, ties + 1.0)
    dn1 = torch.nextafter(ties, ties - 1.0)
    x = torch.stack([ties, up1, dn1, torch.nextafter(up1, ties + 1.0),
                     torch.nextafter(dn1, ties - 1.0), j * dx]).contiguous()
    wq = torch.ones(8, x.shape[1], dtype=torch.int8, device="cuda")
    ones = torch.ones(8, device="cuda")
    _, codes, xsum = TM.quantized_matmul(x, wq, ones, 0 * ones, dx, zx, return_codes=True)
    torch.cuda.synchronize()
    want = torch.clamp(torch.round(x / dx) + zx, -128.0, 127.0).to(torch.int8)
    assert torch.equal(codes, want)
    assert torch.equal(xsum, want.float().sum(dim=1))


def test_wrapper_rejects_bad_inputs():
    q, k, v = _qkv(2, 64, 77, 40, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        TA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        TA.flash_attention(q.half(), k.half(), v.half(), 0.1)
    with pytest.raises(ValueError, match="512"):
        big = torch.zeros(1, 8, 520, device="cuda")
        TA.flash_attention(big, big, big, 0.1)
    with pytest.raises(ValueError, match="head_dim <= 160"):
        wide = torch.zeros(1, 8, 512, device="cuda")
        TA.log2_real_time_attention(wide, wide, wide, 0.1)
    x, w, dm, zm, dl, zl, bias = _conv_case(1, 8, 32, 32, torch.float32, seed=2)
    with pytest.raises(ValueError, match="contiguous"):
        TG.group_quant_conv(x.transpose(1, 2), w, dm, zm, dl, zl, bias)
    # a mixed dtype pair raises on the card: the fold kernel never gives way to `_fold`
    before = TG.LAUNCHES["group_quant_conv"]
    with pytest.raises(ValueError, match="w in x's dtype"):
        TG.group_quant_conv(x.bfloat16(), w, dm, zm, dl, zl, bias)
    with pytest.raises(ValueError, match="w in x's dtype"):
        TG.fold_weights(torch.bfloat16, w, dm, zm, dl, zl, 3, 3)
    assert TG.LAUNCHES["group_quant_conv"] == before
    x, wq, dw, zw, dx, zp, bias = _int8_case(32, 64, 32, torch.float32, 4, 8, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        TM.quantized_matmul(x.t().contiguous().t(), wq, dw, zw, dx, zp - 128)
    with pytest.raises(ValueError, match="f32 or bf16"):
        TM.quantized_matmul(x.half(), wq, dw, zw, dx, zp - 128)
    with pytest.raises(ValueError, match="one device"):
        TM.quantized_matmul(x, wq.cpu(), dw, zw, dx, zp - 128)
