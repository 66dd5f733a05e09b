"""Parity of repro_torch's attention layer with the JAX package's, on the
CPU.

The port's plain version (what `ops.attention` runs for CPU tensors) is
held against the JAX package's Pallas kernel in interpret mode over every
case of test_kernels_attention.py, and at causal S != T, where both align
the mask top-left (row i sees columns j <= i; the reference's `mha_ref`
aligns it bottom-right instead, so it is not the oracle there). A ragged
S = 40 is held against `flash_attn_jnp`, the model path's attention, with
and without a local window (RecurrentGemma's local_attn: row i sees
columns (i - window, i], the JAX package's `_mask`), and head dim 256
(RecurrentGemma's) against the Pallas kernel without one.
Tolerances: 2e-5 in float32 (summation order differs), 3e-2 in bfloat16.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.models.attention import flash_attn_jnp
from repro_torch.kernels.flash_attention import attention, flash_attention_ref


def rand_qkv(rng, B, H, Hkv, S, T, D):
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


def torch_attention(q, k, v, dtype=torch.float32, **kw):
    out = attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                    **kw)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal", [
    (1, 1, 1, 128, 128, 64, True),
    (2, 4, 2, 256, 256, 64, True),
    (1, 8, 1, 128, 128, 128, False),
    (1, 2, 2, 384, 384, 32, True),
    (1, 4, 2, 128, 256, 32, True),     # causal S < T, top-left
    (1, 4, 2, 256, 128, 32, True),     # causal S > T, top-left
])
def test_plain_matches_pallas_kernel(B, H, Hkv, S, T, D, causal):
    rng = np.random.default_rng(S + D)
    q, k, v = rand_qkv(rng, B, H, Hkv, S, T, D)
    ref = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, interpret=True)
    np.testing.assert_allclose(torch_attention(q, k, v, causal=causal),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_plain_matches_pallas_kernel_bf16():
    rng = np.random.default_rng(0)
    q, k, v = rand_qkv(rng, 1, 2, 2, 128, 128, 64)
    ref = pallas_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           causal=True, interpret=True)
    np.testing.assert_allclose(
        torch_attention(q, k, v, dtype=torch.bfloat16, causal=True),
        np.asarray(ref, np.float32), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_matches_model_path(causal):
    rng = np.random.default_rng(40)
    q, k, v = rand_qkv(rng, 2, 4, 2, 40, 40, 32)
    ref = flash_attn_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, chunk_q=16, chunk_k=16)
    np.testing.assert_allclose(torch_attention(q, k, v, causal=causal),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [1, 16, 39, None])
@pytest.mark.parametrize("causal", [True, False])
def test_window_matches_model_path(causal, window):
    rng = np.random.default_rng(41)
    q, k, v = rand_qkv(rng, 2, 4, 2, 40, 40, 32)
    ref = flash_attn_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, chunk_q=16,
                         chunk_k=16)
    np.testing.assert_allclose(
        torch_attention(q, k, v, causal=causal, window=window),
        np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_256_matches_pallas_kernel(causal):
    rng = np.random.default_rng(256)
    q, k, v = rand_qkv(rng, 1, 2, 1, 128, 128, 256)
    ref = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, interpret=True)
    np.testing.assert_allclose(torch_attention(q, k, v, causal=causal),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_window_where_rows_see_nothing_raises():
    """A window so narrow that rows past T + window - 1 see no column is
    refused, by the plain version as by the kernels' wrapper."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in rand_qkv(rng, 1, 2, 1, 9, 4, 8))
    out = attention(q, k, v, causal=True, window=6)     # rows <= 8 = 4 + 5
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="without a column"):
        attention(q, k, v, causal=True, window=5)
    with pytest.raises(ValueError, match=">= 1"):
        attention(q, k, v, window=0)


def test_empty_kv_gives_zeros():
    q = torch.ones((1, 2, 3, 8))
    kv = torch.ones((1, 1, 0, 8))
    assert torch.equal(flash_attention_ref(q, kv, kv), torch.zeros_like(q))


def test_impl_dispatch_on_cpu():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in rand_qkv(rng, 1, 2, 1, 8, 8, 4))
    torch.testing.assert_close(attention(q, k, v, impl="ref"),
                               attention(q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        attention(q, k, v, impl="pallas")


@pytest.mark.parametrize("dtype,head_dim,lane", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 160, "f32"),
    (torch.float32, 256, "f32"),
    (torch.bfloat16, 12, "f32"),
    (torch.bfloat16, 32, "f32"),
    (torch.bfloat16, 96, "f32"),
    (torch.float32, 64, "f32"),
    (torch.float32, 128, "f32"),
    (torch.float32, 20, "f32"),
])
def test_kernel_lane_by_dtype_and_head_dim(dtype, head_dim, lane):
    from repro_torch.kernels.flash_attention import kernel_lane
    assert kernel_lane(dtype, head_dim) == lane


def test_tensor_core_lane_refuses_unaligned_pointers():
    from repro_torch.kernels.flash_attention import check_aligned
    flat = torch.zeros(2 * 64 + 8, dtype=torch.bfloat16)
    aligned = flat[:128].view(1, 1, 2, 64)
    assert aligned.data_ptr() % 16 == 0
    check_aligned(q=aligned, k=aligned, v=aligned)
    shifted = flat[1:129].view(1, 1, 2, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="k must start on a 16-byte "
                                         "boundary for the tensor-core lane"):
        check_aligned(q=aligned, k=shifted, v=aligned)


@pytest.mark.parametrize("head_dim,dtype,error", [
    (0, torch.float32, ValueError),
    (257, torch.bfloat16, ValueError),
    (64, torch.float16, TypeError),
])
def test_kernel_info_refuses_bad_arguments(head_dim, dtype, error):
    """The CUDA-core lane's occupancy query checks its arguments before it
    builds or loads anything."""
    from repro_torch.kernels.flash_attention import kernel_info
    with pytest.raises(error):
        kernel_info(head_dim, dtype)
