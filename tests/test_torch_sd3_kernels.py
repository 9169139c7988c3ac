"""SD3's joint attention on the card (marker `cuda`; run with `python -m
pytest --noconftest -m cuda tests/test_torch_sd3_kernels.py`):

  * K3b (`rt_stats` + `quant_accum`) at SD3 medium's joint shape, T = S =
    4429 (4096 image and 333 text tokens, ragged: 4429 = 69 x 64 + 13),
    head dim 64, BH = 4 x 24, with the start peak at key 0 (the port's
    text-first order), against the plain reference in diffusers' order
    [image; text] with the peak at key 4096: the same keys, permuted;
  * a full-width transformer call under the W4A8 g=8 policy launches K3b
    once a block (24 `rt_stats`, 24 `quant_accum`) and sends every
    activation quantizer to the fake-quant kernel.
"""
import pytest
import torch

import sd3_reference as R
from dgq_tpu_torch.ops import attention as TA
from dgq_tpu_torch.ops import fake_quant as TF

pytestmark = pytest.mark.cuda

IMAGE, TEXT = 4096, 333


@pytest.fixture(autouse=True)
def _cuda_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is false")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_k3b_joint_attention_at_4429_matches_the_permuted_reference():
    bh, n, d = 96, IMAGE + TEXT, 64
    g = torch.Generator(device="cuda").manual_seed(22)
    q = 2.0 * torch.randn(bh, n, d, generator=g, device="cuda")
    k = 2.0 * torch.randn(bh, n, d, generator=g, device="cuda")
    v = torch.randn(bh, n, d, generator=g, device="cuda")
    k[:, 0] = 0.3 * q.mean(dim=1)  # CLIP's start token (text first: key 0) draws weight
    before = dict(TA.LAUNCHES)
    out = TA.fused_attention(q, k, v, d ** -0.5, sm_mode="log2_real_time", start_peak=True)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["rt_stats"] == before["rt_stats"] + 1
    assert TA.LAUNCHES["quant_accum"] == before["quant_accum"] + 1

    def diffusers_order(x):  # [text; image] -> [image; text]
        return torch.cat([x[:, TEXT:], x[:, :TEXT]], dim=1)

    ref = R.attention_core(diffusers_order(q), diffusers_order(k), diffusers_order(v),
                           d ** -0.5, True, 8, peak_col=IMAGE)
    ref = torch.cat([ref[:, IMAGE:], ref[:, :IMAGE]], dim=1)
    err = (out - ref).abs()
    # a log2 code that flips on the kernel's other order of f32 sums moves its
    # weight by a factor 2; such elements are rare, every other is f32 rounding
    assert float((err > 2e-3).float().mean()) < 5e-4
    assert R.rel_gap(out, ref) < 1e-3
    plain = R.attention_core(q, k, v, d ** -0.5)
    assert R.rel_gap(plain, ref) > 1e-2


def test_full_width_call_launches_k3b_once_a_block():
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models import mmdit_sd3 as M
    from dgq_tpu_torch.models.qconfig import QConfig, joint_act_sites
    from dgq_tpu_torch.pipeline.sampler import select_slot_qstate
    from dgq_tpu_torch.utils.synthetic import synthetic_mmdit_qstate

    spec = M.mmdit_sd3_spec()
    cfg = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True)
    with torch.no_grad():
        params, _ = quantize_model_weights(
            M.init_mmdit_sd3(torch.Generator(device="cuda").manual_seed(0), "cuda", spec),
            M.quantized_spec(spec), cfg)
        qs = select_slot_qstate(synthetic_mmdit_qstate(spec, 2), 1)
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(2, 128, 128, 16, generator=g, device="cuda")
        ehs = torch.randn(2, TEXT, 4096, generator=g, device="cuda")
        pooled = torch.randn(2, 2048, generator=g, device="cuda")
        TA.reset_launch_counts()
        TF.reset_launch_counts()
        out = M.mmdit_sd3_apply(params, x, torch.tensor([500.0, 500.0], device="cuda"), ehs,
                                pooled, qstate=qs, cfg=cfg)
        torch.cuda.synchronize()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert TA.LAUNCHES["rt_stats"] == 24 and TA.LAUNCHES["quant_accum"] == 24
    assert TA.LAUNCHES["k3b_tma"] == 24 + 24  # body (f) takes every K3b launch of the call
    assert TF.LAUNCHES["fake_quant"] == len(joint_act_sites(spec))
    assert TF.LAUNCHES["fake_quant_plain"] == 0
