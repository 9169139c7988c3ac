"""dgq_tpu_torch.ops.attention (the module holding kernels K1 and K2) on the
CPU: its plain version, which `fused_attention` takes for CPU tensors,
against the JAX package's Pallas `fused_attention` run in interpret mode.

Tolerance: atol 2e-3 against the Pallas kernels, the bound
tests/test_pallas_kernels.py uses (blockwise online softmax and f32
reassociation against a materialized softmax); 1e-5 against the JAX
materialized oracle, which does the same math in another summation order.
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
    assert TA.LAUNCHES == {"static_uniform_attention": 0, "flash_attention": 0}


@pytest.mark.parametrize("mode,sp", [("log2_real_time", False), ("log2", False),
                                     ("uniform", True)])
def test_non_cpu_tensor_in_unported_mode_raises(mode, sp):
    """A non-CPU tensor never reaches the plain version: modes without a CUDA
    kernel (K3/K4) raise, before any device work."""
    q = torch.empty(2, 16, 40, device="meta")
    with pytest.raises(NotImplementedError, match="K3/K4"):
        TA.fused_attention(q, q, q, 0.1, sm_mode=mode, sm_delta=torch.tensor(0.1),
                           start_peak=sp)


@pytest.mark.parametrize("mode", ["none", "uniform"])
def test_non_cpu_tensor_goes_to_kernel_wrapper(mode):
    """The ported modes go to the kernel wrappers, which reject a non-CUDA
    tensor instead of falling back."""
    q = torch.empty(2, 16, 40, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.fused_attention(q, q, q, 0.1, sm_mode=mode, sm_delta=torch.tensor(0.1))
