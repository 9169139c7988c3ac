"""What surrounds the tensor-core kernels of the port (the bf16 flash attention
K2/K2p, the quantizing attention K1/K1p, K3b/K3p and K4/K4p, the
group-quantized conv K5 and the int8 matmul K6) and can be held on the CPU:
the conv's and the int8 matmul's tile and split-K plans, the wrappers'
choice of kernel body as pure functions, the restated bf16 flash tolerance
on a plain emulation that rounds P to bf16 as the kernel does, the
quantizing kernels' arithmetic (exact bf16 codes and 2^-q into P V, delta
after, key 0 by a rank-1 update) emulated in torch against the plain version
and against the JAX package's kernel, K6's split-K sums in s32 against the
plain version and the JAX kernel, and the weight fold bit for bit against
the same fold written with jax.numpy as dgq_tpu/ops/pallas/group_conv.py
writes it inline. The f32 bodies of K2/K2p and K5 (three TF32 products a
product): the TF32 rounding bit for bit on a table of edge values, the flash
and conv arithmetic emulated in torch against the plain versions and the JAX
kernel, why one TF32 product is not enough, the fold's split K-major panels,
and the f32 conv plan. The f32 bodies of K1, K3b and K4 (three TF32 products
for Q K^T, two for P V): each mode's arithmetic as new cases (`body="f32"`)
of the quantizing kernels' tests, against the plain version and the JAX
kernels, and the log2 codes past 126 that body (e) keeps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops.pallas import attention as JA
from dgq_tpu.ops.pallas import int8_matmul as JM
from dgq_tpu_torch.models.unet_sd import sd_unet_spec
from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec
from dgq_tpu_torch.ops import attention as TA
from dgq_tpu_torch.ops import group_conv as TG
from dgq_tpu_torch.ops import int8_matmul as TM
from dgq_tpu_torch.ops.tf32 import tf32_rna, tf32_split

BATCH = 4  # the CFG batch of two images


def _unet_conv_shapes():
    """(pixels, C, O, taps) of every stride-1 k x k conv of the full-width SD
    v1.4 UNet at each resolution a 64 x 64 latent passes through."""
    shapes = set()
    for _, kind, meta in sd_unet_spec():
        if kind == "conv" and meta[2] > 1 and meta[3] == 1:
            for side in (64, 32, 16, 8):
                shapes.add((BATCH * side * side, meta[0], meta[1], meta[2] ** 2))
    return sorted(shapes)


# the six shapes chip_smoke.py times: H = W, C, O (3 x 3, batch 4)
SMOKE_SHAPES = [(BATCH * h * h, c, o, 9) for h, c, o in
                [(64, 320, 320), (32, 640, 640), (16, 1280, 1280), (8, 2560, 1280),
                 (64, 4, 320), (16, 2560, 1280)]]


@pytest.mark.parametrize("m,c,o,taps", sorted(set(_unet_conv_shapes() + SMOKE_SHAPES)))
def test_conv_plan_covers_k_exactly_once(m, c, o, taps):
    plan = TG.conv_plan(m, c, o, taps)
    assert plan == TG.conv_plan(m, c, o, taps)  # a pure function of the shape
    assert plan.m_tiles * TG.TILE_M >= m > (plan.m_tiles - 1) * TG.TILE_M
    assert plan.n_tiles * TG.TILE_N >= o > (plan.n_tiles - 1) * TG.TILE_N
    assert plan.steps == taps * plan.c_chunks and 1 <= plan.splits <= TG.MAX_SPLITS
    # what the kernel's launcher demands of the plan: no empty split, none missing
    assert plan.splits * plan.steps_per_split >= plan.steps
    assert (plan.splits - 1) * plan.steps_per_split < plan.steps
    ranges = TG.plan_k_ranges(plan, c)
    assert len(ranges) == plan.splits and all(ranges)
    seen = np.zeros((taps, c), dtype=np.int64)
    for pieces in ranges:
        for tap, lo, hi in pieces:
            assert 0 <= lo < hi <= c
            seen[tap, lo:hi] += 1
    assert (seen == 1).all()  # every (tap, channel) of K in exactly one split
    # splits walk K in order, so adding the partial sums in split order is one fixed order
    flat = [piece for pieces in ranges for piece in pieces]
    assert flat == sorted(flat)


def test_conv_plan_splits_where_the_tiles_are_few():
    """One tile per block fills the card at 64 x 64 (128 tiles for 132 SMs) and
    leaves it idle at 8 x 8 (8 tiles), where the weights are the traffic."""
    assert TG.conv_plan(BATCH * 64 * 64, 320, 320, 9).splits == 1
    for m, c, o in ((BATCH * 8 * 8, 2560, 1280), (BATCH * 16 * 16, 1280, 1280),
                    (BATCH * 32 * 32, 640, 640)):
        deep = TG.conv_plan(m, c, o, 9)
        assert deep.splits > 1
        # one wave of blocks, more than half of it used
        assert TG.SM_COUNT // 2 < deep.m_tiles * deep.n_tiles * deep.splits <= TG.SM_COUNT
        assert deep.steps_per_split >= 8
    # a 1 x 1 conv with few channels has too few steps to split
    assert TG.conv_plan(64, 64, 64, 1).splits == 1


@pytest.mark.parametrize("dtype,c,o,ptr,want", [
    (torch.bfloat16, 320, 320, 0, "tensor_core"),
    (torch.bfloat16, 2560, 1280, 4096, "tensor_core"),
    (torch.bfloat16, 8, 8, 16, "tensor_core"),
    (torch.bfloat16, 4, 320, 0, "cuda_core"),      # conv_in: 4 channels
    (torch.bfloat16, 320, 4, 0, "cuda_core"),      # conv_out: 4 outputs
    (torch.bfloat16, 40, 22, 0, "cuda_core"),      # ragged outputs
    (torch.bfloat16, 320, 320, 8, "cuda_core"),    # x off a 16-byte boundary
    (torch.float32, 320, 320, 0, "tf32x3"),        # f32: three TF32 products a product
    (torch.float32, 2560, 1280, 4096, "tf32x3"),
    (torch.float32, 4, 320, 0, "cuda_core"),       # conv_in keeps the first body in f32 too
    (torch.float32, 320, 4, 0, "cuda_core"),       # conv_out
    (torch.float32, 320, 320, 8, "cuda_core"),     # x off a 16-byte boundary
])
def test_conv_form_is_a_rule_on_dtype_shape_and_address(dtype, c, o, ptr, want):
    assert TG.conv_form(dtype, c, o, ptr) == want


ALIGNED = (4096, 8192, 12288)


@pytest.mark.parametrize("dtype,d,ptrs,strides,slot,want", [
    (torch.float32, 40, ALIGNED, (163840, 40) * 3, 0, "tf32x3_vector"),
    (torch.float32, 512, ALIGNED, (512 * 4096, 512) * 3, 0, "tf32x3_vector"),
    (torch.float32, 64, ALIGNED, (4096 * 640, 640) * 3, 64, "tf32x3_vector"),  # SDXL packed
    (torch.float32, 36, ALIGNED, (36 * 64, 36) * 3, 0, "tf32x3_vector"),   # 144-byte rows
    (torch.float32, 40, (4100, 8192, 12288), (163840, 40) * 3, 0, "tf32x3_plain"),  # odd base
    (torch.float32, 42, ALIGNED, (42 * 64, 42) * 3, 0, "tf32x3_plain"),    # 168-byte rows
    (torch.float32, 40, ALIGNED, (163842, 40) * 3, 0, "tf32x3_plain"),     # a batch stride off
    (torch.float32, 40, ALIGNED, (4096 * 40, 40) * 3, 42, "tf32x3_plain"),  # a slot off
    (torch.bfloat16, 40, ALIGNED, (163840, 40) * 3, 0, "wgmma_async"),     # SD's 80-byte rows
    (torch.bfloat16, 64, ALIGNED, (4096 * 640, 640) * 3, 64, "wgmma_async"),  # SDXL packed
    (torch.bfloat16, 160, ALIGNED, (256 * 2048, 2048) * 3, 256, "wgmma_async"),
    (torch.bfloat16, 512, ALIGNED, (4096 * 512, 512) * 3, 0, "wgmma_async"),
    (torch.bfloat16, 40, (4098, 8192, 12288), (163840, 40) * 3, 0, "wgmma_plain"),  # odd base
    (torch.bfloat16, 40, (4096, 8192, 12296), (163840, 40) * 3, 0, "wgmma_plain"),  # v 8 bytes off
    (torch.bfloat16, 36, ALIGNED, (36 * 64, 36) * 3, 0, "wgmma_plain"),    # 72-byte rows
    (torch.bfloat16, 12, ALIGNED, (4096 * 512, 512) * 3, 64, "wgmma_plain"),  # tiny heads
    (torch.bfloat16, 40, ALIGNED, (163844, 40) * 3, 0, "wgmma_plain"),     # a batch stride off
    (torch.bfloat16, 40, ALIGNED, (4096 * 516, 516) * 3, 0, "wgmma_plain"),   # a row stride off
])
def test_flash_form_is_a_rule_on_dtype_head_dim_strides_and_addresses(dtype, d, ptrs, strides,
                                                                      slot, want):
    assert TA.flash_form(dtype, d, ptrs, strides, slot) == want
    assert TA.FLASH_FORMS[want] in (1, 2, 3, 4)  # no call picks body (b), form 0


def test_flash_form_of_real_views():
    """The rule applied to tensors: a contiguous (BH, T, 40) bf16 tensor takes
    16-byte copies, the same data one element further on does not."""
    q = torch.zeros(2 * 8 * 40 + 8, dtype=torch.bfloat16)
    base = q.data_ptr()
    assert base % 16 == 0
    aligned, odd = q[:640].view(2, 8, 40), q[1:641].view(2, 8, 40)
    strides = (320, 40) * 3
    assert TA.flash_form(q.dtype, 40, (aligned.data_ptr(),) * 3, strides) == "wgmma_async"
    assert TA.flash_form(q.dtype, 40, (odd.data_ptr(),) * 3, strides) == "wgmma_plain"
    assert TA.flash_form(torch.float32, 40, (odd.data_ptr(),) * 3, strides) == "tf32x3_plain"


def _flash_case(t, s, d, seed, amp=2.0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(amp * rng.standard_normal((2, t, d), dtype=np.float32)).bfloat16()
    k = torch.from_numpy(amp * rng.standard_normal((2, s, d), dtype=np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((2, s, d), dtype=np.float32)).bfloat16()
    return q, k, v


def _flash_with_bf16_p(q, k, v, scale):
    """The kernel's arithmetic in plain torch: exact products of the bf16
    inputs, an f32 softmax, P rounded to bf16 before P V (the row sum taken of
    the unrounded P), the f32 result rounded to bf16 once."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    acc = torch.matmul(e.bfloat16().float(), v.float())
    return (acc / e.sum(dim=-1, keepdim=True)).bfloat16()


def _flash_f32(q, k, v, scale):
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p, v.float()), torch.matmul(p, v.float().abs())


@pytest.mark.parametrize("s", [77, 1024])
@pytest.mark.parametrize("d", [40, 64, 160, 512])
def test_flash_with_bf16_p_stays_inside_the_restated_bound(d, s):
    """|err| <= 2^-7 |ref| + 2^-8 (P |V|): the relative part is the output's
    one rounding to bf16 on each side of the comparison, the absolute part
    P's rounding (2^-9 relative on each product p v, and as much again of
    slack), which does not shrink where the output cancels."""
    q, k, v = _flash_case(96, s, d, seed=d + s)
    scale = d ** -0.5
    out = _flash_with_bf16_p(q, k, v, scale).float()
    ref32, pav = _flash_f32(q, k, v, scale)
    err = (out - ref32).abs()
    assert bool((err <= 2.0 ** -7 * ref32.abs() + 2.0 ** -8 * pav).all())
    # and the plain version of the port, rounded to bf16, is inside it too
    plain = TA.attention_reference(q, k, v, scale).float()
    assert bool(((plain - ref32).abs() <= 2.0 ** -7 * ref32.abs() + 2.0 ** -8 * pav).all())
    # far inside on average: the mean error is a small part of the mean bound
    assert float(err.mean()) <= 0.25 * float((2.0 ** -7 * ref32.abs() + 2.0 ** -8 * pav).mean())


def test_the_bound_without_the_absolute_part_is_too_tight_for_bf16_p():
    """The reason for restating the bound: with P rounded to bf16 the earlier
    bound, 2^-7 |ref| + 1e-5 max|V| against the bf16 plain version, fails where
    the output nearly cancels (many keys of similar weight, values of both
    signs), while the restated one holds."""
    broke = 0
    for seed in range(4):
        q, k, v = _flash_case(128, 2048, 64, seed=100 + seed, amp=0.5)
        scale = 64 ** -0.5
        out = _flash_with_bf16_p(q, k, v, scale).float()
        plain = TA.attention_reference(q, k, v, scale).float()
        old = 2.0 ** -7 * plain.abs() + 1e-5 * float(v.float().abs().max())
        broke += int(((out - plain).abs() > old).sum())
        ref32, pav = _flash_f32(q, k, v, scale)
        assert bool(((out - ref32).abs() <= 2.0 ** -7 * ref32.abs() + 2.0 ** -8 * pav).all())
    assert broke > 0


@pytest.mark.parametrize("dtype,d,ptrs,strides,slot,max_code,want", [
    (torch.float32, 40, ALIGNED, (163840, 40) * 3, 0, 255, "tf32x3_vector"),  # the CLIs' f32
    (torch.float32, 64, ALIGNED, (4096 * 640, 640) * 3, 64, 255, "tf32x3_vector"),
    (torch.float32, 160, ALIGNED, (256 * 160, 160) * 3, 0, 255, "tf32x3_vector"),  # top of (e)
    (torch.float32, 192, ALIGNED, (256 * 192, 192) * 3, 0, 255, "cuda_core"),
    (torch.float32, 512, ALIGNED, (4096 * 512, 512) * 3, 0, 255, "cuda_core"),   # K1, VAE width
    (torch.float32, 40, ALIGNED, (163840, 40) * 3, 0, 2048, "tf32x3_vector"),  # 11-bit codes
    (torch.float32, 40, ALIGNED, (163840, 40) * 3, 0, 4095, "cuda_core"),      # past TF32's
    (torch.float32, 40, (4100, 8192, 12288), (163840, 40) * 3, 0, 255, "tf32x3_plain"),
    (torch.float32, 42, ALIGNED, (42 * 64, 42) * 3, 0, 255, "tf32x3_plain"),  # 168-byte rows
    (torch.float32, 64, (4096, 8196), (4096 * 640, 640) * 2, 64, 255, "tf32x3_plain"),  # rt_stats
    (torch.bfloat16, 40, ALIGNED, (163840, 40) * 3, 0, 255, "wgmma_async"),  # SD 64px
    (torch.bfloat16, 64, ALIGNED, (4096 * 640, 640) * 3, 64, 255, "wgmma_async"),  # SDXL packed
    (torch.bfloat16, 80, ALIGNED, (1024 * 1024, 1024) * 3, 128, 255, "wgmma_async"),  # SD packed
    (torch.bfloat16, 160, ALIGNED, (256 * 160, 160) * 3, 0, 255, "wgmma_async"),
    (torch.bfloat16, 192, ALIGNED, (256 * 192, 192) * 3, 0, 255, "wgmma_async"),  # top of (c)
    (torch.bfloat16, 512, ALIGNED, (4096 * 512, 512) * 3, 0, 255, "cuda_core"),   # K1, VAE width
    (torch.bfloat16, 200, ALIGNED, (64 * 200, 200) * 3, 0, 255, "cuda_core"),
    (torch.bfloat16, 40, ALIGNED, (163840, 40) * 3, 0, 511, "cuda_core"),    # 9-bit codes
    (torch.bfloat16, 40, ALIGNED, (163840, 40) * 3, 0, 256, "wgmma_async"),
    (torch.bfloat16, 40, (4098, 8192, 12288), (163840, 40) * 3, 0, 255, "wgmma_plain"),
    (torch.bfloat16, 64, (4096, 8192), (4096 * 640, 640) * 2, 64, 255, "wgmma_async"),  # rt_stats
    (torch.bfloat16, 64, (4096, 8200), (4096 * 640, 640) * 2, 64, 255, "wgmma_plain"),  # k 8 B off
    (torch.bfloat16, 36, ALIGNED, (36 * 64, 36) * 3, 0, 255, "wgmma_plain"),   # 72-byte rows
    (torch.bfloat16, 80, ALIGNED, (1024 * 1024, 1024) * 3, 132, 255, "wgmma_plain"),  # odd slot
    (torch.bfloat16, 40, ALIGNED, (163840, 44) * 3, 0, 255, "wgmma_plain"),  # a row stride off
])
def test_quant_form_is_a_rule_on_dtype_head_dim_codes_strides_and_addresses(
        dtype, d, ptrs, strides, slot, max_code, want):
    assert TA.quant_form(dtype, d, ptrs, strides, slot, max_code) == want
    # bf16 takes body (b) or (c), f32 body (b) or (e)
    assert TA.FLASH_FORMS[want] in ((0, 1, 2) if dtype == torch.bfloat16 else (0, 3, 4))


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_quant_form_checked_refuses_a_non_positive_scale_on_the_tensor_cores(scale):
    """The tensor-core bodies take the row max on raw scores: a bf16 or f32
    call with scale <= 0 raises before any launch; the CUDA-core body takes it."""
    args = (ALIGNED, (163840, 40) * 3)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="positive scale"):
            TA._quant_form_checked(scale, dtype, 40, *args)
        assert TA._quant_form_checked(scale, dtype, 512, ALIGNED, (4096 * 512, 512) * 3) == 0
    assert TA._quant_form_checked(scale, torch.float32, 40, *args, max_code=4095) == 0
    assert TA._quant_form_checked(0.125, torch.bfloat16, 40, *args) == 1
    assert TA._quant_form_checked(0.125, torch.float32, 40, *args) == 3


LOG2E = 1.4426950408889634


def _quant_case(bh, t, s, d, seed, amp=2.0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(amp * rng.standard_normal((bh, t, d), dtype=np.float32)).bfloat16()
    k = torch.from_numpy(amp * rng.standard_normal((bh, s, d), dtype=np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((bh, s, d), dtype=np.float32)).bfloat16()
    return q, k, v


def _scores_emulated(q, k, body="bf16"):
    """Raw S = Q K^T as the tensor-core bodies form it: bf16 products are exact,
    the sums f32; f32 (body (e)) takes three TF32 products a 32-lane chunk of
    the head dim, each chunk into its own accumulator, the chunks added in f32."""
    if body == "bf16":
        return torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = None
    for c in range(0, q.shape[-1], 32):
        part = _tf32_products(q[..., c:c + 32], k[..., c:c + 32])
        s = part if s is None else s + part
    return s


def _stats_emulated(q, k, scale, body="bf16"):
    """Pass 1 of the tensor-core bodies: raw scores (`_scores_emulated`), m the
    raw row max, l = sum 2^(scale log2 e (s - m))."""
    s = _scores_emulated(q, k, body)
    c = scale * LOG2E
    m = s.max(dim=-1, keepdim=True).values
    l = torch.exp2(s * c - m * c).sum(dim=-1, keepdim=True)
    return s, m, l


def _exponent_field(x):
    return int(np.asarray(float(x), dtype=np.float32).view(np.int32)) >> 23


def _significand(x):
    """x with its exponent field set to 127: x = 2^(exponent_field(x) - 127) times it."""
    bits = np.asarray(float(x), dtype=np.float32).view(np.int32)
    return float(((bits & np.int32(-0x7F800001)) | np.int32(0x3F800000)).view(np.float32))


def _log2_terms(code, delta, body):
    """The A elements of P V for log2 codes and the factor the accumulator
    takes after: bf16, 2^-q (exact) and delta; f32 (body (e)), 2^(e - q) with
    e delta's unbiased exponent (a normal TF32 number for every q <=
    exponent_field(delta) - 1) and delta's significand."""
    if body == "bf16":
        p = torch.exp2(-code).bfloat16()
        assert torch.equal(p.float(), torch.exp2(-code))  # 2^-q is exact in bf16
        return p.float(), delta
    a = torch.exp2(float(_exponent_field(delta) - 127) - code)
    assert torch.equal(tf32_rna(a), a)  # one TF32 part
    return a, _significand(delta)


def _pv_emulated(p, v, f, body):
    """P V times f: bf16, one f32 product of the exact P with bf16 V; f32 (body
    (e)), P (one exact TF32 part) against V's big and small parts, a fresh
    accumulator a key tile of 64, the tiles added in f32."""
    if body == "bf16":
        return torch.matmul(p, v.float()) * f
    vb, vs = tf32_split(v)
    acc = None
    for key0 in range(0, v.shape[1], 64):
        pt = p[..., key0:key0 + 64]
        part = (torch.matmul(pt, vs[:, key0:key0 + 64]) + torch.matmul(pt, vb[:, key0:key0 + 64]))
        acc = part if acc is None else acc + part
    return acc * f


def _out(x, body):
    return x.bfloat16() if body == "bf16" else x


def _rt_emulated(q, k, v, scale, start_peak, sm_bits=8, body="bf16"):
    """`rt_stats` then `quant_accum` as the kernels compute them: z = scale m
    + ln l; the call's delta; q = round(clamp(log2 delta + z / ln 2 - s scale
    log2 e, 0, ub)), ub = min(exponent_field(delta) - 1, 2^b - 1), and 126 in
    bf16; P from `_log2_terms`, P V by `_pv_emulated`; under start_peak key 0
    zero in P and exp(s0 - z) V[0] added in f32 (the rank-1 update)."""
    s, m, l = _stats_emulated(q, k, scale, body)
    z = m * scale + torch.log(l)
    if start_peak:
        m2 = s[..., 1:].max(dim=-1, keepdim=True).values
        delta = float((torch.exp((m2 - m) * scale) / l).max())
    else:
        delta = 1.0 / float(l.min())
    ub = min(_exponent_field(delta) - 1, 2 ** sm_bits - 1, 126 if body == "bf16" else 10 ** 9)
    y = torch.clamp(np.log2(delta) + z * LOG2E - s * (scale * LOG2E), 0, ub)
    p, f = _log2_terms(torch.round(y), delta, body)
    if start_peak:
        p[..., 0] = 0
    out = _pv_emulated(p, v, f, body)
    if start_peak:
        out = out + torch.exp(s[..., 0:1] * scale - z) * v[:, 0:1, :].float()
    return _out(out, body)


def _uniform_emulated(q, k, v, scale, delta, sm_bits=8, body="bf16"):
    """K1 as the kernel computes it: pass 1's m, l; code = min(rint(2^(s c -
    (m c + log2(l delta)))), 2^b - 1), c = scale log2 e, an integer exact in
    bf16 (b <= 8) and in TF32 (b <= 11), as P; `_pv_emulated` with delta."""
    s, m, l = _stats_emulated(q, k, scale, body)
    c = scale * LOG2E
    e = torch.exp2(s * c - (m * c + torch.log2(l * delta)))
    code = torch.clamp(torch.round(e), max=2 ** sm_bits - 1)
    rounded = code.bfloat16().float() if body == "bf16" else tf32_rna(code)
    assert torch.equal(rounded, code)
    return _out(_pv_emulated(code, v, delta, body), body)


def _check_share(out, ref, bf16=True):
    """chip_smoke.py's `_check_share`: the share of outputs off by more than
    2e-3 + 2^-7 |ref| (each side's rounding to bf16; left out for f32),
    which must stay under 5e-4."""
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape and bool(out.isfinite().all())
    return float(((out - ref).abs() > 2e-3 + (2.0 ** -7 * ref.abs() if bf16 else 0.0))
                 .float().mean())


def _check_f32(out, ref, v, delta):
    """chip_smoke.py's `_check_f32` with the uniform quantizer's terms: |err| <=
    1e-4 + 2 delta max|V|, the mean within 2^-8 mean|ref| + 0.01 delta max|V|."""
    assert out.dtype == ref.dtype == torch.float32 and bool(out.isfinite().all())
    err = (out - ref).abs()
    vmax = float(v.abs().max())
    assert float(err.max()) <= 1e-4 + 2.0 * delta * vmax
    assert float(err.mean()) <= 2.0 ** -8 * float(ref.abs().mean()) + 0.01 * delta * vmax


def _body_case(body, bh, t, s, d, seed, amp=2.0):
    """bf16 inputs for body (c), f32 for body (e), from one numpy draw."""
    q, k, v = _f32_case(bh, t, s, d, seed, amp)
    return (q.bfloat16(), k.bfloat16(), v.bfloat16()) if body == "bf16" else (q, k, v)


def _check_uniform(out, ref, v, delta):
    """chip_smoke.py's `_check` for bf16 with the uniform quantizer's terms:
    |err| <= 2^-7 |ref| + 1e-5 max|V| + 2 delta max|V|, the mean within
    2^-8 mean|ref| + 0.01 delta max|V|."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    vmax = float(v.float().abs().max())
    assert bool((err <= 2.0 ** -7 * ref.abs() + 1e-5 * vmax + 2.0 * delta * vmax).all())
    assert float(err.mean()) <= 2.0 ** -8 * float(ref.abs().mean()) + 0.01 * delta * vmax


BODIES = ["bf16", "f32"]  # body (c) on bf16 inputs, body (e) (3xTF32) on f32 inputs


def _check_log2(out, ref, body):
    return _check_share(out, ref, bf16=body == "bf16") < 5e-4


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("start_peak", [False, True])
@pytest.mark.parametrize("d", [40, 64, 160])
@pytest.mark.parametrize("s", [77, 256])
def test_real_time_kernel_arithmetic_matches_plain(s, d, start_peak, body):
    """2048 rows: y = a_row - s scale log2 e is a difference of two numbers
    near 16, as in the JAX kernel, so it carries about 2e-6 of f32 error, and
    a probability whose exponent lies that close to a half-integer flips; a
    flip of a row's dominant probability moves the whole row, which the share
    bound absorbs once in 2048 rows (with 384 rows, one draw at s = 256, d = 64,
    start_peak flipped one). Body (e) in f32 is held to the share bound without
    the bf16 rounding term."""
    q, k, v = _body_case(body, 4, 512, s, d, seed=s + d + start_peak)
    scale = d ** -0.5
    out = _rt_emulated(q, k, v, scale, start_peak, body=body)
    ref = TA.attention_reference(q, k, v, scale, "log2_real_time", 8, None, start_peak)
    assert out.dtype == ref.dtype and _check_log2(out, ref, body)
    # the quantizer is live, and under start_peak key 0 carries the row's peak
    plain = TA.attention_reference(q, k, v, scale)
    assert float((out.float() - plain.float()).abs().max()) > 1e-3


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("delta", [1.0 / 255.0, 1.0 / 64.0])
@pytest.mark.parametrize("d", [40, 64, 160])
@pytest.mark.parametrize("s", [77, 256])
def test_uniform_kernel_arithmetic_matches_plain(s, d, delta, body):
    q, k, v = _body_case(body, 4, 96, s, d, seed=3 * s + d)
    scale = d ** -0.5
    out = _uniform_emulated(q, k, v, scale, delta, body=body)
    ref = TA.attention_reference(q, k, v, scale, "uniform", 8, torch.tensor(delta))
    if body == "bf16":
        _check_uniform(out, ref, v, delta)
    else:
        _check_f32(out, ref, v, delta)


def test_rank1_key0_is_exact_where_bf16_p0_is_not():
    """Why key 0 goes in by a rank-1 f32 update: fed as bf16(p0 / delta) into
    P V, as the TPU kernel feeds it, the row's largest probability is rounded
    to 8 bits and the output moves by up to 2^-9 p0 |v0|."""
    q, k, v = _quant_case(2, 64, 77, 40, seed=21)
    q, k[:, 0] = q.abs(), 3.0  # key 0 dominates every row
    scale = 40 ** -0.5
    out = _rt_emulated(q, k, v, scale, True).float()
    ref = TA.attention_reference(q, k, v, scale, "log2_real_time", 8, None, True).float()
    s, m, l = _stats_emulated(q, k, scale)
    z = m * scale + torch.log(l)
    p0 = torch.exp(s[..., 0:1] * scale - z)
    delta = float((torch.exp((s[..., 1:].max(-1, keepdim=True).values - m) * scale) / l).max())
    fed = (p0 / delta).bfloat16().float() * delta
    moved = (fed - p0).abs() * v[:, 0:1, :].float().abs()
    assert float(p0.min()) > 0.5 and float(moved.max()) > 1e-3
    assert float((out - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


def _jax_quant(q, k, v, scale, **kw):
    """The JAX package's kernel on the same numbers (interpret mode, as its own
    tests run it on the CPU), as a torch f32 tensor."""
    j = JA.fused_attention(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), scale,
                           sm_bits=8, interpret=True, block_t=32, block_s=128, **kw)
    return torch.from_numpy(np.array(j))


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("start_peak", [False, True])
def test_real_time_kernel_arithmetic_matches_the_jax_kernel(start_peak, body):
    """The same emulation against the JAX package's kernel
    (`fused_attention(..., sm_mode="log2_real_time")` in interpret mode, as
    its own tests run it on the CPU), on the same inputs (bf16-representable
    f32 for body (c)): the share bound of tests/test_torch_attention.py, with
    the bf16 rounding term for body (c)."""
    q, k, v = _body_case(body, 2, 64, 77, 40, seed=31 + start_peak, amp=1.5)
    scale = 40 ** -0.5
    j = _jax_quant(q, k, v, scale, sm_mode="log2_real_time", start_peak=start_peak)
    out = _rt_emulated(q, k, v, scale, start_peak, body=body)
    assert _check_log2(out, j, body)


@pytest.mark.parametrize("body", BODIES)
def test_uniform_kernel_arithmetic_matches_the_jax_kernel(body):
    """K1's emulation against the JAX package's `_static_uniform_kernel` in
    interpret mode, at delta 1/255: `_check_uniform` for body (c),
    `_check_f32` for body (e)."""
    q, k, v = _body_case(body, 2, 64, 77, 40, seed=37, amp=1.5)
    scale, delta = 40 ** -0.5, 1.0 / 255.0
    j = _jax_quant(q, k, v, scale, sm_mode="uniform", sm_delta=jnp.asarray(delta, jnp.float32))
    out = _uniform_emulated(q, k, v, scale, delta, body=body)
    if body == "bf16":
        _check_uniform(out, j, v, delta)
    else:
        _check_f32(out, j, v, delta)


def _static_emulated(q, k, v, scale, mode, delta, start_peak, sm_bits=8, cap=126, body="bf16"):
    """K4 as the tensor-core kernel computes it: pass 1's m, l; z = scale m +
    ln l in registers; `log2`: q = round(clamp(log2 delta + z / ln 2 - s scale
    log2 e, 0, ub)), ub = min(exponent_field(delta) - 1, 2^b - 1, cap), P
    from `_log2_terms`; `uniform`: K1's codes as P; `_pv_emulated`; under
    start_peak key 0 zero in P and exp(s0 - z) V[0] added in f32. cap=None is
    body (b)'s bound, without the 126, which body (e) keeps too."""
    s, m, l = _stats_emulated(q, k, scale, body)
    z = m * scale + torch.log(l)
    c = scale * LOG2E
    if body == "f32":
        cap = None
    if mode == "uniform":
        e = torch.exp2(s * c - (m * c + torch.log2(l * delta)))
        code = torch.clamp(torch.round(e), max=2 ** sm_bits - 1)
        p, f = code.clone(), delta
        assert torch.equal(code.bfloat16().float() if body == "bf16" else tf32_rna(code), code)
    else:
        ub = min(_exponent_field(delta) - 1, 2 ** sm_bits - 1, 10 ** 9 if cap is None else cap)
        y = torch.clamp(np.log2(delta) + z * LOG2E - s * c, 0, ub)
        code = torch.round(y)
        p, f = _log2_terms(code, delta, body)
    if start_peak:
        p[..., 0] = 0
    out = _pv_emulated(p, v, f, body)
    if start_peak:
        out = out + torch.exp(s[..., 0:1] * scale - z) * v[:, 0:1, :].float()
    return _out(out, body), code


STATIC_MODES = [("log2", False), ("log2", True), ("uniform", True)]


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("delta", [1.0, 0.125])
@pytest.mark.parametrize("mode,start_peak", STATIC_MODES)
@pytest.mark.parametrize("d", [40, 64, 160])
@pytest.mark.parametrize("s", [77, 256])
def test_static_kernel_arithmetic_matches_plain(s, d, mode, start_peak, delta, body):
    """K4's tensor-core arithmetic against the plain version, 2048 rows (the
    log2 quantizer's y is formed from register m and l, a difference of two
    numbers near 16, so a bin can flip at a half-integer; the share bound
    absorbs a flip of a row's dominant probability once in 2048 rows); delta 1
    (`log_max_1`) and a calibrated 2^-3; body (e) without the bf16 rounding
    term."""
    q, k, v = _body_case(body, 4, 512, s, d, seed=s + d + 7 * start_peak + int(8 * delta))
    scale = d ** -0.5
    out, _ = _static_emulated(q, k, v, scale, mode, delta, start_peak, body=body)
    ref = TA.attention_reference(q, k, v, scale, mode, 8, torch.tensor(delta), start_peak)
    assert out.dtype == ref.dtype and _check_log2(out, ref, body)
    plain = TA.attention_reference(q, k, v, scale)
    assert float((out.float() - plain.float()).abs().max()) > 1e-3  # the quantizer is live


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("mode,start_peak", STATIC_MODES)
def test_static_kernel_arithmetic_matches_the_jax_kernel(mode, start_peak, body):
    """The same emulation against the JAX package's K4
    (`fused_attention(..., sm_mode="log2" / "uniform", start_peak=...)` in
    interpret mode, as its own tests run it on the CPU), on the same inputs
    (bf16-representable f32 for body (c)): the share bound, with the bf16
    rounding term for body (c)."""
    q, k, v = _body_case(body, 2, 64, 77, 40, seed=41 + 3 * start_peak + (mode == "uniform"),
                         amp=1.5)
    scale, delta = 40 ** -0.5, 0.125
    j = _jax_quant(q, k, v, scale, sm_mode=mode, sm_delta=jnp.asarray(delta, jnp.float32),
                   start_peak=start_peak)
    out, _ = _static_emulated(q, k, v, scale, mode, delta, start_peak, body=body)
    assert _check_log2(out, j, body)


def test_static_log2_cap_at_126_is_a_kept_difference_from_delta_2():
    """The bf16 tensor-core K4 caps a log2 code at 126 so that 2^-q stays a
    normal bf16; body (b) caps at exponent_field(delta) - 1 alone. For delta <= 1
    (log_max_1, calibrated deltas) the two caps are one; from delta 2 on they
    part, but only for probabilities under delta 2^-126.5, whose products
    with V are below any bf16 output's resolution."""
    for delta in (1.0, 0.125, 2.0 ** -20):
        assert min(_exponent_field(delta) - 1, 255, 126) == min(_exponent_field(delta) - 1, 255)
    delta = 4.0
    assert min(_exponent_field(delta) - 1, 255) == 128
    q, k, v = _quant_case(2, 64, 256, 64, seed=5, amp=8.0)  # scores spread past 90 nats
    scale = 64 ** -0.5
    tc, code_tc = _static_emulated(q, k, v, scale, "log2", delta, False)
    b, code_b = _static_emulated(q, k, v, scale, "log2", delta, False, cap=None)
    moved = code_tc != code_b
    assert bool(moved.any())  # the inputs reach the codes past 126
    s, m, l = _stats_emulated(q, k, scale)
    p = torch.exp((s - m) * scale) / l
    assert bool((p[moved] < delta * 2.0 ** -126).all())
    assert torch.equal(tc, b)  # no bf16 output moves


def test_f32_log2_codes_keep_the_cuda_core_bound_and_its_terms():
    """Body (e) takes no cap at 126: at delta 4 (exponent field 129) its log2
    codes reach ub = 128, as body (b)'s do, where the bf16 body would stop at
    126; each term, 2^(e - q) as the A element times delta's significand
    after, equals body (b)'s p_q = bitcast(bits(delta) - (q << 23)) bit for bit
    for every code 0..128."""
    delta = 4.0
    q, k, v = _f32_case(2, 64, 256, 64, seed=5, amp=8.0)  # scores spread past 90 nats
    scale = 64 ** -0.5
    out, code = _static_emulated(q, k, v, scale, "log2", delta, False, body="f32")
    assert int(code.max()) == _exponent_field(delta) - 1 == 128
    assert bool((code > 126).any())  # kept, where the bf16 body caps them
    _, code_b = _static_emulated(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale, "log2", delta,
                                 False)
    assert int(code_b.max()) == 126
    qs = torch.arange(0, 129, dtype=torch.float32)
    a, f = _log2_terms(qs, delta, "f32")
    terms = (a * torch.tensor(f, dtype=torch.float32)).view(torch.int32)
    want = int(np.asarray(delta, np.float32).view(np.int32)) - (qs.to(torch.int32) << 23)
    assert torch.equal(terms, want)
    ref = TA.attention_reference(q, k, v, scale, "log2", 8, torch.tensor(delta))
    assert _check_log2(out, ref, "f32")


@pytest.mark.parametrize("mode,bits,d,want", [
    ("log2", 8, 40, "wgmma_async"),
    ("log2", 12, 40, "wgmma_async"),    # log2 codes are exponents: any length
    ("uniform", 8, 64, "wgmma_async"),
    ("uniform", 9, 40, "cuda_core"),    # 511 is not exact in bf16: f32 copies, body (e)
    ("log2", 8, 160, "wgmma_async"),
])
def test_quant_form_routes_k4(mode, bits, d, want):
    """bf16 K4 / K4p at head_dim <= 192 take the tensor cores through
    `quant_form`; the code bound it weighs is the uniform codes' alone. f32
    takes body (e) at these head dims and codes (511 is exact in TF32)."""
    strides = (256 * d, d) * 3
    got = TA.quant_form(torch.bfloat16, d, ALIGNED, strides, 0, TA._static_max_code(mode, bits))
    assert got == want
    assert TA.quant_form(torch.float32, d, ALIGNED, strides, 0,
                         TA._static_max_code(mode, bits)) == "tf32x3_vector"


def _int8_layer_shapes():
    """(M, K, N) of every linear and 1x1 conv of SD v1.4 (CFG batch 4 at
    512px: 64 to 8 px, the 77 text tokens, the time embedding) and of
    SDXL-turbo (batch 2 at 1024px: 128 to 32 px, the text tokens, the time
    and add embeddings), each (K, N) at every M its model runs."""
    shapes = set()
    for spec, ms in ((sd_unet_spec(), (16384, 4096, 1024, 256, 308, 4)),
                     (sdxl_unet_spec(), (32768, 8192, 2048, 154, 2))):
        for _, kind, meta in spec:
            if kind == "linear" or (kind == "conv" and meta[2] == 1):
                shapes.update((m, meta[0], meta[1]) for m in ms)
    return shapes


# the six shapes chip_smoke.py times (label, M, K, N), and its two ragged ones
INT8_SMOKE = [(16384, 320, 2560), (256, 5120, 1280), (308, 768, 320), (4, 320, 1280),
              (2048, 1280, 10240), (2, 2816, 1280), (333, 1000, 640), (77, 1001, 200)]


@pytest.mark.parametrize("m,k,n", sorted(_int8_layer_shapes() | set(INT8_SMOKE)))
def test_int8_plan_covers_k_exactly_once(m, k, n):
    plan = TM.int8_plan(m, n, k)
    assert plan == TM.int8_plan(m, n, k)  # a pure function of the shape
    assert plan.m_tiles * TM.TILE_M >= m > (plan.m_tiles - 1) * TM.TILE_M
    assert plan.n_tiles * TM.TILE_N >= n > (plan.n_tiles - 1) * TM.TILE_N
    assert plan.steps * TM.TILE_K >= k > (plan.steps - 1) * TM.TILE_K
    assert 1 <= plan.splits <= TM.MAX_SPLITS
    # what the kernel's launcher demands of the plan: no empty split, none missing
    assert plan.splits * plan.steps_per_split >= plan.steps
    assert (plan.splits - 1) * plan.steps_per_split < plan.steps
    ranges = TM.plan_k_ranges(plan, k)
    seen = np.zeros(k, dtype=np.int64)
    for lo, hi in ranges:
        assert 0 <= lo < hi <= k
        seen[lo:hi] += 1
    assert (seen == 1).all() and ranges == sorted(ranges)
    tiles = plan.m_tiles * plan.n_tiles
    assert tiles * plan.splits <= max(tiles, TM.SM_COUNT)  # a split never adds a wave
    if 2 * tiles <= TM.SM_COUNT and plan.steps > 1:
        # fewer tiles than SMs, and two splits still fit one wave: K is split
        assert plan.splits > 1
    if 2 * tiles > TM.SM_COUNT:
        assert plan.splits == 1


def test_int8_plan_splits_the_small_m_layers():
    """The time embedding (5 tiles), SD's 8px FF-out (10 tiles, 40 steps) and
    SDXL's add_embedding (5 tiles, 22 steps) split; the wide shapes fill the
    card with tiles alone."""
    assert TM.int8_plan(4, 1280, 320).splits == 3
    deep = TM.int8_plan(256, 1280, 5120)
    assert deep.splits == 10 and deep.steps_per_split == 4
    assert TM.int8_plan(2, 1280, 2816).splits == 11
    assert TM.int8_plan(16384, 2560, 320).splits == 1
    assert TM.int8_plan(2048, 10240, 1280).splits == 1


@pytest.mark.parametrize("k,x_ptr,w_ptr,want", [
    (320, 0, 4096, "cp_async"),
    (5120, 256, 512, "cp_async"),
    (1000, 0, 0, "element"),    # K % 16 = 8: weight rows off 16 bytes
    (36, 0, 0, "element"),
    (320, 2, 0, "element"),     # x one bf16 element off
    (320, 0, 8, "element"),     # codes 8 bytes off
])
def test_int8_form_is_a_rule_on_k_and_addresses(k, x_ptr, w_ptr, want):
    assert TM.int8_form(k, x_ptr, w_ptr) == want
    assert TM.INT8_FORMS[want] in (1, 2)


def _int8_split_emulated(x, wq, dw, zw, dx, zx, bias, plan, a_bits=8, f32_partials=False):
    """K6 as the kernel computes it under `plan`: the codes, each split's
    partial product and row sums over its K range as exact integers, the
    partials added in s32 (or, to show why not, rounded to f32 first), then
    the f32 epilogue in the plain version's order."""
    k = x.shape[1]
    nb, pb = -(2 ** (a_bits - 1)), 2 ** (a_bits - 1) - 1
    xq = torch.clamp(torch.round(x.float() / dx) + zx, nb, pb).long()
    acc = torch.zeros(x.shape[0], wq.shape[0], dtype=torch.float32 if f32_partials else torch.long)
    xsum = torch.zeros(x.shape[0], 1, dtype=torch.long)
    for lo, hi in TM.plan_k_ranges(plan, k):
        part = xq[:, lo:hi] @ wq[:, lo:hi].long().t()
        assert int(part.abs().max()) < 2 ** 31  # an s32 partial holds it
        acc = acc + (part.float() if f32_partials else part)
        xsum = xsum + xq[:, lo:hi].sum(dim=1, keepdim=True)
    assert f32_partials or int(acc.abs().max()) < 2 ** 31
    wsum = wq.long().sum(dim=1).float()[None, :]
    dwr, zwr = dw.float()[None, :], zw.float()[None, :]
    y = (dx * dwr) * (acc.float() - zx * wsum - zwr * xsum.float() + (float(k) * zx) * zwr)
    return y + bias.float()[None, :]


def _int8_split_case(m, k, n, w_bits, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((1.5 * rng.standard_normal((m, k))).astype(np.float32))
    lo = 2 ** (w_bits - 1)
    wq = torch.from_numpy(rng.integers(-lo, lo, (n, k)).astype(np.int8))
    dw = torch.from_numpy((0.005 + 0.01 * rng.random(n)).astype(np.float32))
    zw = torch.from_numpy(np.round(2.0 * rng.standard_normal(n)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x, wq, dw, zw, torch.tensor(6.0 / 256), torch.tensor(5.0), bias


@pytest.mark.parametrize("m,k,n,w_bits", [(40, 700, 300, 4), (8, 5120, 16, 8), (4, 320, 1280, 4),
                                          (130, 1001, 33, 8)])
def test_int8_split_k_sums_in_s32_give_the_unsplit_bits(m, k, n, w_bits):
    """Under the plan's split the s32 partials add to the unsplit product
    exactly, so the output equals the plain version (one exact product) bit
    for bit, and the JAX kernel in interpret mode within its 1e-5."""
    x, wq, dw, zw, dx, zx, bias = _int8_split_case(m, k, n, w_bits, seed=m + k + n)
    plan = TM.int8_plan(m, n, k)
    assert plan.splits > 1
    out = _int8_split_emulated(x, wq, dw, zw, dx, zx, bias, plan)
    ref = TM.quantized_matmul_reference(x, wq, dw, zw, dx, zx, bias)
    assert torch.equal(out, ref)
    j = JM.quantized_matmul(jnp.asarray(x.numpy()), jnp.asarray(wq.numpy().T),
                            jnp.asarray(dw.numpy()), jnp.asarray(zw.numpy()),
                            jnp.asarray(float(dx), jnp.float32), jnp.asarray(float(zx), jnp.float32),
                            jnp.asarray(bias.numpy()), block_m=16, block_n=128,
                            out_dtype=jnp.float32, interpret=True)
    j = np.asarray(j, np.float64)
    assert np.abs(out.double().numpy() - j).max() <= 1e-5 * np.abs(j).max()


def test_int8_f32_partials_would_change_bits_at_wide_k():
    """Why the partials add in s32: W8 x A8 codes near 127 at K = 5120 pass
    2^24, where an f32 partial rounds; added as f32 they miss the exact sum."""
    rng = np.random.default_rng(0)
    m, k, n = 8, 5120, 16
    x = torch.from_numpy((rng.random((m, k)) * 127.0 * (6.0 / 256)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(100, 128, (n, k)).astype(np.int8))
    one, zero = torch.ones(n), torch.zeros(n)
    dx, zx = torch.tensor(6.0 / 256), torch.tensor(0.0)
    plan = TM.int8_plan(m, n, k)
    assert plan.splits > 1
    exact = _int8_split_emulated(x, wq, one, zero, dx, zx, zero, plan)
    rounded = _int8_split_emulated(x, wq, one, zero, dx, zx, zero, plan, f32_partials=True)
    assert torch.equal(exact, TM.quantized_matmul_reference(x, wq, one, zero, dx, zx, zero))
    assert not torch.equal(rounded, exact)


def _fold_inputs(c, o, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((3, 3, c, o), dtype=np.float32) / np.sqrt(9 * c)).astype(np.float32)
    dm = (0.02 + 0.06 * rng.random((9, c), dtype=np.float32)).astype(np.float32)
    zm = (100.0 + 56.0 * rng.random((9, c), dtype=np.float32)).astype(np.float32)
    dl = np.asarray([1.37], dtype=np.float32)
    zl = np.asarray([3.0], dtype=np.float32)
    return w, dm, zm, dl, zl


def _bits(x):
    """A float array's bit patterns (bf16 through its f32 widening, which is exact)."""
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,o", [(32, 64), (40, 24), (320, 320)])
def test_fold_matches_the_jax_fold_bit_for_bit(c, o, dtype):
    """`_fold`'s w_t, rd and z against the fold that
    dgq_tpu/ops/pallas/group_conv.py writes inline before its pallas_call
    (f32 product, one rounding to x's dtype; 1 / (dm dl); zm + zl), on the
    same numpy inputs: the one rounding to bf16 falls alike in both
    frameworks."""
    w, dm, zm, dl, zl = _fold_inputs(c, o, seed=c + o)
    tdt = getattr(torch, dtype)
    x = torch.zeros(1, 4, 4, c, dtype=tdt)
    wt = torch.from_numpy(w).to(tdt)
    w_t, rd, z = TG._fold(x, wt, torch.from_numpy(dm), torch.from_numpy(zm),
                          torch.from_numpy(dl), torch.from_numpy(zl), 3, 3)
    assert w_t.dtype == tdt and w_t.shape == (9, c, o) and w_t.is_contiguous()
    assert rd.dtype == z.dtype == torch.float32 and rd.shape == z.shape == (9, c)

    jdt = jnp.dtype(dtype)
    wj = jnp.asarray(w).astype(jdt)  # the weights in x's dtype, as the model holds them
    dmf = jnp.asarray(dm).astype(jnp.float32)
    dlf = jnp.asarray(dl).reshape(()).astype(jnp.float32)
    w_t_j = (jnp.reshape(wj, (9, c, o)).astype(jnp.float32) * (dmf * dlf)[:, :, None]).astype(jdt)
    rd_j = 1.0 / (dmf * dlf)
    z_j = jnp.asarray(zm).astype(jnp.float32) + jnp.asarray(zl).reshape(()).astype(jnp.float32)

    np.testing.assert_array_equal(_bits(wt.float().numpy()),
                                  _bits(np.asarray(wj.astype(jnp.float32))))
    np.testing.assert_array_equal(_bits(w_t.float().numpy()),
                                  _bits(np.asarray(w_t_j.astype(jnp.float32))))
    np.testing.assert_array_equal(_bits(rd.numpy()), _bits(np.asarray(rd_j)))
    np.testing.assert_array_equal(_bits(z.numpy()), _bits(np.asarray(z_j)))


def test_fold_reads_the_hwio_view_of_an_oihw_weight():
    """The model hands the conv `w.permute(2, 3, 1, 0)` of its OIHW weight: the
    fold of the view equals the fold of its contiguous copy."""
    w, dm, zm, dl, zl = _fold_inputs(16, 24, seed=5)
    oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    view = oihw.permute(2, 3, 1, 0)
    assert not view.is_contiguous() and view.stride(0) == 3 * view.stride(1)
    x = torch.zeros(1, 4, 4, 16)
    args = (torch.from_numpy(dm), torch.from_numpy(zm), torch.from_numpy(dl),
            torch.from_numpy(zl), 3, 3)
    for a, b in zip(TG._fold(x, view, *args), TG._fold(x, view.contiguous(), *args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w_dtype,dtype,match", [
    (torch.float32, torch.bfloat16, "w in x's dtype"),
    (torch.bfloat16, torch.float32, "w in x's dtype"),
    (torch.float32, torch.float32, "CUDA tensor"),
])
def test_fold_wrapper_raises_rather_than_fold_in_torch(w_dtype, dtype, match):
    """`fold_weights` is the fold kernel's wrapper: a weight in another dtype
    than the conv's, or one that is not on a card, raises before any launch.
    `_fold` serves the plain version and the CPU only."""
    w, dm, zm, dl, zl = (torch.from_numpy(a) for a in _fold_inputs(16, 24, seed=9))
    with pytest.raises(ValueError, match=match):
        TG.fold_weights(dtype, w.to(w_dtype), dm, zm, dl, zl, 3, 3)


def test_cpu_conv_takes_a_mixed_dtype_pair_through_the_plain_version():
    """On the CPU `group_quant_conv` is the plain version, which folds w into
    x's dtype with `_fold`; only a CUDA tensor must match its weight's dtype."""
    w, dm, zm, dl, zl = (torch.from_numpy(a) for a in _fold_inputs(16, 24, seed=10))
    x = torch.from_numpy(np.random.RandomState(10).randn(1, 5, 5, 16).astype(np.float32))
    TG.reset_launch_counts()
    out = TG.group_quant_conv(x.bfloat16(), w, dm, zm, dl, zl, None)
    ref = TG.group_quant_conv_reference(x.bfloat16(), w, dm, zm, dl, zl, None)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 5, 5, 24)
    assert TG.LAUNCHES["group_quant_conv"] == 0
    assert torch.equal(out, ref)


def test_jax_runs_on_the_cpu_here():
    assert jax.default_backend() == "cpu"


# ---- the f32 bodies: three TF32 products a product ----

# (f32 bits in, TF32 bits out) of `cvt.rna.tf32.f32`: round to nearest on the
# 13 dropped bits, ties away from zero, a carry into the exponent, infinity
# past the largest finite number, subnormals kept
TF32_EDGES = [
    (0x3F800000, 0x3F800000),  # 1
    (0x3F800FFF, 0x3F800000),  # just under half a unit: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero, not to even
    (0x3F803000, 0x3F804000),  # a tie over an odd last bit: up
    (0x3F805000, 0x3F806000),  # a tie over an even last bit: up too
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),
    (0x3FFFF000, 0x40000000),  # carry into the exponent: 2
    (0x7F7FFFFF, 0x7F800000),  # the largest finite f32: infinity
    (0x7F7FEFFF, 0x7F7FE000),
    (0x7F800000, 0x7F800000),  # infinity stays
    (0xFF800000, 0xFF800000),
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),  # -0
    (0x00001000, 0x00002000),  # subnormal tie: away from zero
    (0x00000FFF, 0x00000000),  # subnormal below half a unit
    (0x007FF000, 0x00800000),  # the largest subnormals round into the normals
    (0x00A5B7E9, 0x00A5C000),  # a normal number whose dropped bits are past half: up
    (0x4B3FFFFF, 0x4B400000),  # 12582911: integers above 2^11 lose bits
    (0x437F0000, 0x437F0000),  # 255: an 8-bit code is exact
    (0x43FF8000, 0x43FF8000),  # 511: a 9-bit code is exact
]


def test_tf32_rna_is_round_to_nearest_ties_away_bit_for_bit():
    bits = torch.tensor([a for a, _ in TF32_EDGES], dtype=torch.int64)
    x = (bits - (bits >= 2 ** 31).long() * 2 ** 32).to(torch.int32).view(torch.float32)
    got = tf32_rna(x).view(torch.int32).long() & 0xFFFFFFFF
    assert [hex(v) for v in got.tolist()] == [hex(b) for _, b in TF32_EDGES]
    # an independent numpy statement of the same rule on random bit patterns
    rng = np.random.default_rng(0)
    r = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    r = r[(r & 0x7FFFFFFF) < 0x7F7FF000]  # finite and clear of overflow
    val = r.view(np.float32).astype(np.float64)
    ulp = np.ldexp(1.0, np.frexp(np.abs(val))[1] - 11)       # a TF32 unit at |val|
    ulp = np.maximum(ulp, np.ldexp(1.0, -136))                # the subnormal unit
    want = np.sign(val) * np.floor(np.abs(val) / ulp + 0.5) * ulp
    got = tf32_rna(torch.from_numpy(r.view(np.float32).copy())).double().numpy()
    np.testing.assert_array_equal(got, want)
    # the split leaves less than 2^-22 of x
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    big, small = tf32_split(x)
    assert torch.equal(tf32_rna(big), big) and torch.equal(tf32_rna(small), small)
    assert float(((x.double() - big.double() - small.double()).abs()
                  / x.double().abs()).max()) < 2.0 ** -22


def _tf32_products(a, b, products=3):
    """a @ b^T as the kernels form it: three TF32 products (the two small
    terms first), or one, summed in f32."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    if products == 1:
        return torch.matmul(ab, bb.transpose(-1, -2))
    return (torch.matmul(ab, bs.transpose(-1, -2)) + torch.matmul(as_, bb.transpose(-1, -2))
            + torch.matmul(ab, bb.transpose(-1, -2)))


def _flash_tf32_emulated(q, k, v, scale, products=3):
    """`flash_tf32_kernel`'s arithmetic in torch: key tiles of 64 (32 past head
    dim 160), S from TF32 products, the online softmax in base 2 on the raw
    scores, P split in registers and multiplied by V's TF32 parts, O divided by
    the row sum of the unsplit P at the end."""
    bk = 64 if q.shape[-1] <= 160 else 32
    c = scale * LOG2E
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for key0 in range(0, k.shape[1], bk):
        s = _tf32_products(q, k[:, key0:key0 + bk], products)
        mn = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        corr = torch.exp2((m - mn) * c)
        p = torch.exp2(s * c - mn * c)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = mn
        o = o * corr + _tf32_products(p, v[:, key0:key0 + bk].transpose(-1, -2), products)
    return o / l


def _f32_case(bh, t, s, d, seed, amp=2.0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(amp * rng.standard_normal((bh, t, d), dtype=np.float32)),
            torch.from_numpy(amp * rng.standard_normal((bh, s, d), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((bh, s, d), dtype=np.float32)))


@pytest.mark.parametrize("s", [77, 1024])
@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
def test_flash_tf32_arithmetic_is_within_the_f32_bound(d, s):
    """Three TF32 products a product keep the f32 flash kernel within
    `_check_f32`'s 1e-4 of the f32 plain version (scores of spread 4, as the
    card's checks draw them)."""
    q, k, v = _f32_case(2, 48, s, d, seed=d + s)
    scale = d ** -0.5
    out = _flash_tf32_emulated(q, k, v, scale)
    ref = TA.attention_reference(q, k, v, scale)
    assert float((out - ref).abs().max()) <= 1e-4


def test_flash_tf32_arithmetic_matches_the_jax_kernel():
    """The same emulation against the JAX package's `_flash_kernel`
    (`fused_attention(..., sm_mode="none")` in interpret mode, as its own tests
    run it on the CPU), at the f32 bound."""
    q, k, v = _f32_case(2, 64, 200, 40, seed=3)
    scale = 40 ** -0.5
    j = JA.fused_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)), scale, sm_mode="none",
                           interpret=True, block_t=32, block_s=128)
    out = _flash_tf32_emulated(q, k, v, scale)
    assert float((out - torch.from_numpy(np.array(j))).abs().max()) <= 1e-4


def test_one_tf32_product_breaks_the_f32_bound():
    """Why three: with one TF32 product (11 significant bits) the scores of
    the VAE's spread are off by some 1e-3, and the output by more than 1e-4,
    where three products stay inside it."""
    q, k, v = _f32_case(1, 64, 1024, 512, seed=7)
    scale = 512 ** -0.5
    ref = TA.attention_reference(q, k, v, scale)
    one = float((_flash_tf32_emulated(q, k, v, scale, products=1) - ref).abs().max())
    three = float((_flash_tf32_emulated(q, k, v, scale) - ref).abs().max())
    assert one > 1e-4 >= three
    assert one > 10 * three


def _conv_tf32_emulated(x, w, dm, zm, dl, zl, bias, a_bits=8):
    """`group_conv_tf32_kernel`'s arithmetic in torch: per tap, the codes as the
    plain version forms them, split into TF32 parts, against the fold's
    panels (`fold_panels`), three products summed in f32; bias in f32."""
    w_t, rd, z = TG._fold(x, w, dm, zm, dl, zl, 3, 3)
    panels = TG.fold_panels(w_t)
    b, h, wd, c = x.shape
    qmax = float(2 ** a_bits - 1)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(b * h * wd, w_t.shape[2])
    for t in range(9):
        i, j = divmod(t, 3)
        code = torch.clamp(torch.round(xp[:, i:i + h, j:j + wd, :] * rd[t]), -z[t], qmax - z[t])
        cb, cs = tf32_split(code.reshape(-1, c))
        acc += (torch.matmul(cb, panels[1, t].T) + torch.matmul(cs, panels[0, t].T)
                + torch.matmul(cb, panels[0, t].T))
    return (acc + bias).reshape(b, h, wd, -1)


@pytest.mark.parametrize("c,o,zp", [(64, 48, (100.0, 156.0)), (40, 24, (-40.0, 300.0)),
                                    (96, 160, (20.0, 40.3))])
def test_conv_tf32_arithmetic_is_within_the_f32_bound(c, o, zp):
    """K5's f32 body within `_check_conv(bf16=False)`'s 2e-3 of
    `group_quant_conv_reference`, with zero points that put the clip bounds
    inside and outside [0, 255] and fractional ones (a code's small part is
    then not 0)."""
    rng = np.random.default_rng(c + o)
    x = torch.from_numpy(2.0 * rng.standard_normal((2, 8, 8, c), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32))
    dm = torch.from_numpy((0.02 + 0.06 * rng.random((9, c))).astype(np.float32))
    zm = torch.from_numpy((zp[0] + (zp[1] - zp[0]) * rng.random((9, c))).astype(np.float32))
    dl, zl = torch.tensor([1.0]), torch.tensor([0.25])
    bias = torch.from_numpy(0.1 * rng.standard_normal(o).astype(np.float32))
    ref = TG.group_quant_conv_reference(x, w, dm, zm, dl, zl, bias)
    out = _conv_tf32_emulated(x, w, dm, zm, dl, zl, bias)
    assert float((out - ref).abs().max()) <= 2e-3
    assert float(ref.abs().max()) > 0.5


def _np_tf32_rna(a):
    """TF32 rounding in numpy on uint32 bit patterns (finite inputs)."""
    u = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    mag = u & 0x7FFFFFFF
    return ((((mag + 0x1000) & ~np.uint64(0x1FFF)) | (u & 0x80000000)).astype(np.uint32)
            .view(np.float32))


@pytest.mark.parametrize("c,o", [(32, 64), (40, 24), (320, 320)])
def test_fold_panels_are_the_split_transposed_w_t_bit_for_bit(c, o):
    """The f32 body's weights: `fold_panels` of `_fold`'s w_t is (2, taps, O,
    C), w_t transposed to K-major, big = rna(w_t), small = rna(w_t - big),
    bit for bit against a numpy statement of the same rule; big + small is
    w_t within 2^-22."""
    w, dm, zm, dl, zl = _fold_inputs(c, o, seed=c * o)
    x = torch.zeros(1, 4, 4, c)
    w_t, _, _ = TG._fold(x, torch.from_numpy(w), *(torch.from_numpy(a) for a in (dm, zm, dl, zl)),
                         3, 3)
    panels = TG.fold_panels(w_t)
    assert panels.shape == (2, 9, o, c) and panels.dtype == torch.float32
    assert panels.is_contiguous()
    wt = np.ascontiguousarray(w_t.numpy().transpose(0, 2, 1))
    big = _np_tf32_rna(wt)
    small = _np_tf32_rna(wt - big)
    np.testing.assert_array_equal(_bits(panels[0].numpy()), _bits(big))
    np.testing.assert_array_equal(_bits(panels[1].numpy()), _bits(small))
    err = np.abs(wt.astype(np.float64) - big - small.astype(np.float64))
    assert float((err / np.maximum(np.abs(wt), 1e-30)).max()) < 2.0 ** -22


def _sdxl_conv_shapes():
    """(pixels, C, O, taps) of every stride-1 k x k conv of SDXL's UNet at
    each resolution a 128 x 128 latent passes through (batch 2, 1024px)."""
    shapes = set()
    for _, kind, meta in sdxl_unet_spec():
        if kind == "conv" and meta[2] > 1 and meta[3] == 1:
            for side in (128, 64, 32):
                shapes.add((2 * side * side, meta[0], meta[1], meta[2] ** 2))
    return sorted(shapes)


@pytest.mark.parametrize("m,c,o,taps",
                         sorted(set(_unet_conv_shapes() + _sdxl_conv_shapes() + SMOKE_SHAPES)))
def test_conv_plan_f32_covers_k_exactly_once(m, c, o, taps):
    """The f32 body's plan (160 outputs a tile, 32 channels a step) at every
    stride-1 conv of SD v1.4 and SDXL and at chip_smoke.py's six shapes."""
    plan = TG.conv_plan(m, c, o, taps, torch.float32)
    assert plan == TG.conv_plan(m, c, o, taps, torch.float32)  # a pure function
    assert plan.tile_k == TG.TILE_K_F32
    assert plan.m_tiles * TG.TILE_M >= m > (plan.m_tiles - 1) * TG.TILE_M
    assert plan.n_tiles * TG.TILE_N_F32 >= o > (plan.n_tiles - 1) * TG.TILE_N_F32
    assert plan.c_chunks * TG.TILE_K_F32 >= c > (plan.c_chunks - 1) * TG.TILE_K_F32
    assert plan.steps == taps * plan.c_chunks and 1 <= plan.splits <= TG.MAX_SPLITS
    assert plan.splits * plan.steps_per_split >= plan.steps
    assert (plan.splits - 1) * plan.steps_per_split < plan.steps
    seen = np.zeros((taps, c), dtype=np.int64)
    ranges = TG.plan_k_ranges(plan, c)
    assert len(ranges) == plan.splits and all(ranges)
    for pieces in ranges:
        for tap, lo, hi in pieces:
            assert 0 <= lo < hi <= c and hi - lo <= TG.TILE_K_F32
            seen[tap, lo:hi] += 1
    assert (seen == 1).all()
    flat = [piece for pieces in ranges for piece in pieces]
    assert flat == sorted(flat)
    tiles = plan.m_tiles * plan.n_tiles
    assert tiles * plan.splits <= max(tiles, TG.SM_COUNT)  # a split never adds a wave


def test_conv_plan_f32_splits_the_small_images():
    """At 8 x 8 and 16 x 16 the f32 body has 16 and 64 output tiles for 132
    SMs: K is split until a wave is full; at 64 x 64 it is not split."""
    assert TG.conv_plan(BATCH * 64 * 64, 320, 320, 9, torch.float32).splits == 1
    for m, c, o in ((BATCH * 8 * 8, 2560, 1280), (BATCH * 16 * 16, 1280, 1280)):
        plan = TG.conv_plan(m, c, o, 9, torch.float32)
        assert plan.splits > 1
        assert TG.SM_COUNT // 2 < plan.m_tiles * plan.n_tiles * plan.splits <= TG.SM_COUNT
