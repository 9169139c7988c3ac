"""The hand-written CUDA attention kernels (dgq_tpu_torch/csrc/attention.cu)
against their plain PyTorch version on the card. Marked `cuda`: they skip
when torch.cuda.is_available() is false (a CUDA kernel has no CPU mode).
Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(`--noconftest`: the suite's conftest imports JAX, which a GPU machine need
not have). The cases mirror tests/test_pallas_kernels.py: ragged S = 77,
head dims of the main path (40/80/160 UNet, 512 VAE), two deltas, bf16 and
f32.

Tolerances, with reasons:
  * K2 (flash): f32 atol 1e-4 (f32 reassociation of online vs materialized
    softmax, measured ~1e-5); bf16 |err| <= 2^-7 |ref| + 1e-5 max|V| (each
    side rounds its f32 result to bf16 once: half an ulp, <= 2^-8 relative).
  * K1 (uniform softmax quant): the same, plus at most a few one-bin flips,
    |err| <= 2 delta max|V| elementwise with a bounded mean. exp and the
    summation order differ, so a probability within float error of a bin
    boundary may round to the neighbouring code.
"""
import pytest
import torch

from dgq_tpu_torch.ops import attention as TA

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 80, 160, 512])
@pytest.mark.parametrize("s", [77, 256])
def test_flash_kernel_matches_plain(s, d, dtype):
    q, k, v = _qkv(4, 200, s, d, dtype, seed=d + s)
    before = TA.LAUNCHES["flash_attention"]
    out = TA.fused_attention(q, k, v, d ** -0.5, sm_mode="none")
    torch.cuda.synchronize()
    assert TA.LAUNCHES["flash_attention"] == before + 1
    _check(out, TA.attention_reference(q, k, v, d ** -0.5), v, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta", [1.0 / 255.0, 1.0 / 64.0])
@pytest.mark.parametrize("d", [40, 80, 160, 512])
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


@pytest.mark.parametrize("mode,sp", [("log2_real_time", False), ("log2_real_time", True),
                                     ("log2", False), ("uniform", True)])
def test_unported_mode_on_cuda_raises(mode, sp):
    q, k, v = _qkv(2, 64, 77, 40, torch.bfloat16, seed=0)
    counts = dict(TA.LAUNCHES)
    with pytest.raises(NotImplementedError, match="K3/K4"):
        TA.fused_attention(q, k, v, 40 ** -0.5, sm_mode=mode,
                           sm_delta=torch.tensor(0.5, device="cuda"), start_peak=sp)
    assert TA.LAUNCHES == counts


def test_wrapper_rejects_bad_inputs():
    q, k, v = _qkv(2, 64, 77, 40, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        TA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        TA.flash_attention(q.half(), k.half(), v.half(), 0.1)
    with pytest.raises(ValueError, match="512"):
        big = torch.zeros(1, 8, 520, device="cuda")
        TA.flash_attention(big, big, big, 0.1)
