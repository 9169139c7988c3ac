"""dgq_tpu_torch.ops.attention (the module holding kernels K1 to K4) on the
CPU: its plain version, which `fused_attention` takes for CPU tensors,
against the JAX package's Pallas `fused_attention` run in interpret mode.

Tolerance: atol 2e-3 against the Pallas kernels, the bound
tests/test_pallas_kernels.py uses (blockwise online softmax and f32
reassociation against a materialized softmax); 1e-5 against the JAX
materialized oracle, which does the same math in another summation order.
The log2 modes flip a bin at a half-integer exponent (a factor of 2 on that
probability), and under real_time the delta itself comes from a sum taken in
another order, so there the share of outputs off by more than 2e-3 is
bounded, under 5e-4, as tests/test_pallas_kernels.py:168-172 does.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.ops.pallas import attention as JA  # noqa: E402
from dgq_tpu_torch.ops import attention as TA  # noqa: E402


def _qkv(t, s, d, bh=2, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(bh, t, d) * 1.5).astype(np.float32)
    k = (rng.randn(bh, s, d) * 1.5).astype(np.float32)
    v = rng.randn(bh, s, d).astype(np.float32)
    return q, k, v


def _run_both(q, k, v, mode, delta, start_peak=False, **jax_kw):
    scale = q.shape[-1] ** -0.5
    jd = None if delta is None else jnp.asarray(delta)
    j = JA.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                           sm_mode=mode, sm_bits=8, sm_delta=jd, start_peak=start_peak,
                           interpret=True, **jax_kw)
    td = None if delta is None else torch.tensor(delta)
    t = TA.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           scale, sm_mode=mode, sm_bits=8, sm_delta=td, start_peak=start_peak)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("d", [4, 40, 80])
@pytest.mark.parametrize("s", [77, 128])
@pytest.mark.parametrize("mode", ["none", "uniform"])
def test_plain_matches_pallas_kernel(mode, s, d):
    q, k, v = _qkv(64, s, d, seed=d + s)
    delta = np.float32(1.0 / 64.0) if mode == "uniform" else None
    j, t = _run_both(q, k, v, mode, delta, block_t=32, block_s=128)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)
    if mode == "uniform":
        # quantization is live: a delta this coarse changes the output
        f = TA.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), d ** -0.5).numpy()
        assert np.abs(f - t).max() > 1e-2


def _mismatch_share(t, j):
    return float((np.abs(t - j) > 2e-3).mean())


QUANT_MODES = [("log2_real_time", False), ("log2_real_time", True), ("log2", False),
               ("log2", True), ("uniform", True)]


@pytest.mark.parametrize("s", [64, 77])
@pytest.mark.parametrize("mode,sp", QUANT_MODES)
def test_log2_and_start_peak_modes_match_pallas_kernel(mode, sp, s):
    """K3 (one call) and K4 in interpret mode against the port's plain
    version, at a self shape (S = T) and at the cross shape S = 77."""
    q, k, v = _qkv(64, s, 40, seed=3 * s + sp)
    delta = None if mode == "log2_real_time" else np.float32(0.7)
    j, t = _run_both(q, k, v, mode, delta, start_peak=sp, block_t=32, block_s=128)
    assert _mismatch_share(t, j) < 5e-4, (_mismatch_share(t, j), np.abs(t - j).max())
    f = TA.attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               40 ** -0.5).numpy()
    assert np.abs(f - t).max() > 1e-3  # quantization is live


@pytest.mark.parametrize("sp", [False, True])
def test_real_time_two_call_form_matches_plain(sp):
    """K3b, the two-launch form the CUDA kernels follow (`rt_impl="two_call"`)."""
    q, k, v = _qkv(64, 77, 40, seed=21)
    j, t = _run_both(q, k, v, "log2_real_time", None, start_peak=sp, block_t=32, block_s=128,
                     rt_impl="two_call")
    assert _mismatch_share(t, j) < 5e-4, np.abs(t - j).max()


def test_real_time_delta_spans_batch_and_heads():
    """One delta for the whole call: scaling one head's scores changes the
    other head's output, which a per-head delta would leave alone."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 32, 8, bh=2, seed=5))
    q2 = q.clone()
    q2[1] *= 8.0  # head 1 gets peaky: the call's largest probability grows
    a = TA.fused_attention(q, k, v, 0.35, sm_mode="log2_real_time", sm_bits=4)
    b = TA.fused_attention(q2, k, v, 0.35, sm_mode="log2_real_time", sm_bits=4)
    assert float((a[0] - b[0]).abs().max()) > 1e-3


def test_start_peak_dominant_column0():
    """Key 0 dominates every row: the real_time delta is the largest non-peak
    probability, not ~1 (tests/test_pallas_kernels.py:184)."""
    rng = np.random.RandomState(11)
    q = (rng.randn(1, 32, 40) * 0.5).astype(np.float32)
    k = (rng.randn(1, 77, 40) * 0.5).astype(np.float32)
    k[:, 0, :] = 30.0 * np.sign(rng.randn(40))
    v = rng.randn(1, 77, 40).astype(np.float32)
    j, t = _run_both(q, k, v, "log2_real_time", None, start_peak=True, block_t=32,
                     block_s=128)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)
    # a delta taken over all columns would put the non-peak mass on a grid
    # two orders of magnitude coarser
    all_cols = TA.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 40 ** -0.5,
        "log2_real_time", 8, start_peak=False).numpy()
    assert np.abs(all_cols - t).max() > 2e-3


def test_start_peak_padded_rows():
    """T = 40 with 32-row tiles pads 24 zero query rows, whose largest
    non-peak probability 1/77 exceeds every real row's: the kernels must
    keep padded rows out of the reduction (tests/test_pallas_kernels.py:217)."""
    t_len, s_len, d = 40, 77, 40
    scale = d ** -0.5
    rng = np.random.RandomState(12)
    q = (0.5 + 0.1 * np.abs(rng.randn(1, t_len, d))).astype(np.float32)
    k = (rng.randn(s_len, d) * 0.05).astype(np.float32)
    k[0, :] = 5.2 / (scale * 0.55 * d)
    v = rng.randn(1, s_len, d).astype(np.float32)
    j, t = _run_both(q, k[None], v, "log2_real_time", None, start_peak=True, block_t=32,
                     block_s=128)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)


def test_plain_matches_flash_kernel_at_vae_threshold():
    """One head, T = S = 1024 (the VAE's flash threshold), D = 128: K2's path."""
    q, k, v = _qkv(1024, 1024, 128, bh=1, seed=3)
    j, t = _run_both(q, k, v, "none", None)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)


@pytest.mark.parametrize("mode,sp", [("uniform", False), ("uniform", True), ("log2", False),
                                     ("log2", True), ("log2_real_time", False),
                                     ("log2_real_time", True), ("none", False)])
def test_reference_every_mode_matches_jax_reference(mode, sp):
    q, k, v = _qkv(32, 77, 40, seed=11)
    delta = None if mode in ("none", "log2_real_time") else np.float32(0.3)
    args = (q.shape[-1] ** -0.5, mode, 8)
    j = JA.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *args,
                               sm_delta=None if delta is None else jnp.asarray(delta),
                               start_peak=sp)
    t = TA.attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               *args, sm_delta=None if delta is None else torch.tensor(delta),
                               start_peak=sp)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_cpu_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 77, 40))
    TA.reset_launch_counts()
    out = TA.fused_attention(q, k, v, 0.1, sm_mode="uniform", sm_delta=torch.tensor(0.01))
    ref = TA.attention_reference(q, k, v, 0.1, "uniform", 8, torch.tensor(0.01))
    assert torch.equal(out, ref)
    classic = {"static_uniform_attention", "flash_attention", "rt_stats", "quant_accum",
               "static_quant_attention"}
    # "k3b_tma": the K3b launches that ran body (f), counted beside their own names
    assert set(TA.LAUNCHES) == classic | {f"{n}_packed" for n in classic} | {"k3b_tma"}
    assert all(n == 0 for n in TA.LAUNCHES.values())


@pytest.mark.parametrize("mode,sp", [("log2_real_time", False), ("log2", False),
                                     ("uniform", True)])
def test_non_cpu_tensor_in_unported_mode_raises(mode, sp):
    """A non-CPU tensor never reaches the plain version: the log2 and
    start_peak modes (K3/K4) go to their kernel wrappers, which reject a
    non-CUDA tensor before any device work."""
    q = torch.empty(2, 16, 40, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.fused_attention(q, q, q, 0.1, sm_mode=mode, sm_delta=torch.tensor(0.1),
                           start_peak=sp)
    assert all(n == 0 for n in TA.LAUNCHES.values())


@pytest.mark.parametrize("mode", ["none", "uniform"])
def test_non_cpu_tensor_goes_to_kernel_wrapper(mode):
    """The ported modes go to the kernel wrappers, which reject a non-CUDA
    tensor instead of falling back."""
    q = torch.empty(2, 16, 40, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.fused_attention(q, q, q, 0.1, sm_mode=mode, sm_delta=torch.tensor(0.1))
