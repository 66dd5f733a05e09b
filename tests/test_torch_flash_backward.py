"""The flash-attention gradient on the CPU: the plain backward
(`flash_attention_bwd_ref`, the backward kernel's plain version) against
`jax.vjp` of the JAX package's `flash_attn_jnp` (its model path's
attention, differentiated by XLA) and against torch.autograd through the
plain forward; and `attention`'s torch.autograd.Function on its plain lane.

Cases: causal and not, S != T both ways (Whisper's cross attention is
S < T, not causal), ragged lengths off the JAX chunks, GQA (G = 1, 3, 4),
a local window, a prefix, MLA's (Dk, Dv) = (24, 16) (the smoke
config's; DeepSeek-V3's (192, 128) at full width), and head dim 256 (the
tensor-core backward's widest: RecurrentGemma-2B's local attention) with
a window, a prefix, and not causal; (24, 16), head dim 96 and head dim
256 with a window and a prefix together (the CUDA-core backward's lane:
float32, and bf16 off the tensor-core dims). Tolerance: 2e-5 of each
gradient's largest element in float32 (summation order differs), 1e-10
against torch.autograd in float64. At T = 1 the exact dq and dk are 0 (the
one key has weight 1 whatever its score) and both sides leave the rounding
of dP - Delta there, so those two are held to the same numbers absolutely.
The Function passes torch.autograd.gradcheck in float64 on the plain lane.

The log-sum-exp every lane carries from the forward to the backward: the
plain forward's `return_lse` against torch.logsumexp of the masked scores
in float64 (base 2, 1e-5 absolute: float32 sums), the plain backward given
it equal bit for bit to the one without (it rebuilds the same quantity the
same way) and to `jax.vjp` within 2e-5, the Function carrying it under
"ref" and requesting it from the kernels under "cuda" on both lanes, the
wrappers handing it to the CUDA-core kernels (their Python path run on
the CPU against libraries that record each launch), and `bwd_lane`'s
dispatch.
"""
import contextlib
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attn_jnp
from repro_torch.kernels.flash_attention import (FlashAttention, attention,
                                                 bwd_lane,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)

# (B, H, Hkv, S, T, Dk, Dv, causal, window, prefix)
CASES = [
    (2, 4, 2, 40, 40, 16, 16, True, None, 0),
    (1, 4, 4, 33, 33, 16, 16, False, None, 0),
    (2, 6, 2, 20, 56, 16, 16, False, None, 0),     # cross: S < T
    (1, 3, 1, 45, 17, 16, 16, True, None, 0),      # causal S > T
    (1, 3, 1, 17, 45, 16, 16, True, None, 0),      # causal S < T
    (1, 4, 1, 50, 50, 8, 8, True, 9, 0),           # window
    (1, 4, 2, 30, 30, 16, 16, True, None, 7),      # prefix
    (1, 4, 2, 30, 30, 16, 16, True, 6, 12),        # prefix and window
    (2, 4, 4, 24, 24, 24, 16, True, None, 0),      # MLA's Dk != Dv
    (1, 2, 1, 1, 1, 16, 16, True, None, 0),
    # head dim 256, the tensor-core backward's widest (RecurrentGemma's
    # local attention: one kv head, a window)
    (1, 4, 1, 64, 64, 256, 256, True, 24, 0),      # window
    (1, 2, 1, 48, 48, 256, 256, True, None, 11),   # prefix
    (1, 2, 2, 40, 56, 256, 256, False, None, 0),   # not causal, S < T
    # the CUDA-core lane's dims with a window and a prefix together
    (1, 4, 2, 40, 40, 24, 16, True, 9, 13),        # MLA's smoke dims
    (1, 2, 1, 48, 48, 96, 96, True, 10, 5),        # D = 96
    (1, 2, 1, 48, 48, 256, 256, True, 12, 20),     # D = 256
]


def _draw(B, H, Hkv, S, T, Dk, Dv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype) for s in (
        (B, H, S, Dk), (B, Hkv, T, Dk), (B, Hkv, T, Dv), (B, H, S, Dv)))


def _close(ours, ref, tol, T):
    """dq, dk, dv within tol of each plain gradient's largest element; at
    T = 1, dq and dk (0 in exact arithmetic) within tol absolutely."""
    for i, (a, b) in enumerate(zip(ours, ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        scale = 1.0 if T == 1 and i < 2 else np.abs(b).max()
        assert np.abs(a - b).max() <= tol * scale


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,window,prefix", CASES)
def test_plain_backward_matches_jax_vjp(B, H, Hkv, S, T, Dk, Dv, causal,
                                        window, prefix):
    q, k, v, do = _draw(B, H, Hkv, S, T, Dk, Dv, seed=S * T + Dk)
    o, vjp = jax.vjp(lambda a, b, c: flash_attn_jnp(
        a, b, c, causal=causal, window=window, prefix_len=prefix,
        chunk_q=16, chunk_k=16), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    to = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                             prefix_len=prefix)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), rtol=2e-5,
                               atol=2e-5)
    ours = flash_attention_bwd_ref(tq, tk, tv, to, tdo, causal=causal,
                                   window=window, prefix_len=prefix)
    _close([t.numpy() for t in ours], [np.asarray(r) for r in ref], 2e-5, T)


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,window,prefix", CASES)
def test_plain_backward_matches_autograd(B, H, Hkv, S, T, Dk, Dv, causal,
                                         window, prefix):
    """In float64 against torch.autograd through the plain forward, and
    the Function's gradients on the plain lane are the plain backward's."""
    arrays = _draw(B, H, Hkv, S, T, Dk, Dv, seed=S + T, dtype=np.float64)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    do = torch.from_numpy(arrays[3])
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o = flash_attention_ref(q, k, v, **kw)
    auto = torch.autograd.grad(o, (q, k, v), do)
    ours = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   o.detach(), do, **kw)
    _close([t.numpy() for t in ours], [t.numpy() for t in auto], 1e-10, T)
    of = attention(q, k, v, impl="ref", **kw)
    assert of.grad_fn is not None and "FlashAttention" in type(
        of.grad_fn).__name__
    fn = torch.autograd.grad(of, (q, k, v), do)
    for a, b in zip(fn, ours):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=3),
                                dict(causal=True, prefix_len=2)])
def test_function_gradcheck(kw):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 4, 5, 6), (1, 2, 7, 6), (1, 2, 7, 4)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: attention(a, b, c, impl="ref", **kw), (q, k, v))


def test_no_grad_path_bypasses_function():
    """Without a gradient to take, `attention` calls the forward directly
    (inference costs what it did); bf16 gradients come back in bf16."""
    q, k, v, do = (torch.from_numpy(a) for a in _draw(1, 4, 2, 9, 9, 8, 8,
                                                       seed=1))
    assert attention(q, k, v).grad_fn is None
    qb, kb, vb = (t.bfloat16().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        assert attention(qb, kb, vb).grad_fn is None
    o = attention(qb, kb, vb)
    grads = torch.autograd.grad(o, (qb, kb, vb), do.bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)
    ref = flash_attention_bwd_ref(qb.detach(), kb.detach(), vb.detach(),
                                  o.detach(), do.bfloat16())
    for a, b in zip(grads, ref):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The backward kernel runs only on CUDA tensors: on the CPU it
    raises, and impl="cuda" through the Function raises too."""
    q, k, v, do = (torch.from_numpy(a) for a in _draw(1, 2, 1, 4, 4, 8, 8,
                                                       seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, do, do)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, do, do,
                            lse=torch.zeros(q.shape[:3]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        FlashAttention.apply(q.requires_grad_(), k, v, True, None, None, 0,
                             "cuda")


def test_bwd_errors_scale():
    """The card's measure of the backward against its plain version: each
    error over the plain gradient's largest element, and absolute for dq
    and dk at T = 1, where they are 0 in exact arithmetic."""
    from repro_torch.kernels.flash_attention.bwd_cases import bwd_errors
    ref = [torch.full((2, 3), 0.5), torch.full((2, 3), 1e-7),
           torch.full((2, 3), 4.0)]
    got = [r + 0.01 for r in ref]
    assert bwd_errors(got, ref, 7) == pytest.approx(
        [0.02, 1e5, 0.0025], rel=1e-4)      # float32's rounding of + 0.01
    assert bwd_errors(got, ref, 1) == pytest.approx(
        [0.01, 0.01, 0.0025], rel=1e-4)
    assert bwd_errors(ref, ref, 7) == [0.0, 0.0, 0.0]


def _masked_scores64(q, k, causal, window, prefix, scale=None):
    """scale q k^T in float64 with the JAX package's mask as -inf, per
    query head (GQA read in place): (B, H, S, T)."""
    B, H, S, Dk = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = Dk ** -0.5 if scale is None else scale
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=1)
    s = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), kk) * scale
    rows, cols = np.arange(S)[:, None], np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok = (cols <= rows) | (cols < prefix)
    if window is not None:
        ok &= cols > rows - window
    return np.where(ok, s, -np.inf)


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,window,prefix", CASES)
def test_plain_forward_lse_is_logsumexp(B, H, Hkv, S, T, Dk, Dv, causal,
                                        window, prefix):
    """return_lse gives o unchanged and each row's base-2 log-sum-exp of
    its masked scaled scores: torch.logsumexp in float64 over ln 2."""
    q, k, v, _ = _draw(B, H, Hkv, S, T, Dk, Dv, seed=S * 7 + T)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o, lse = flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(o, flash_attention_ref(tq, tk, tv, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    want = torch.logsumexp(torch.from_numpy(
        _masked_scores64(q, k, causal, window, prefix)), dim=-1) / np.log(2)
    np.testing.assert_allclose(lse.double().numpy(), want.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,window,prefix", CASES)
def test_plain_backward_given_lse_matches_jax_vjp(B, H, Hkv, S, T, Dk, Dv,
                                                  causal, window, prefix):
    """The plain backward given the forward's lse: the same bits as
    without it, and within 2e-5 of jax.vjp(flash_attn_jnp) as there."""
    q, k, v, do = _draw(B, H, Hkv, S, T, Dk, Dv, seed=S * T + Dk)
    _, vjp = jax.vjp(lambda a, b, c: flash_attn_jnp(
        a, b, c, causal=causal, window=window, prefix_len=prefix,
        chunk_q=16, chunk_k=16), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    to, lse = flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    given = flash_attention_bwd_ref(tq, tk, tv, to, tdo, lse=lse, **kw)
    rebuilt = flash_attention_bwd_ref(tq, tk, tv, to, tdo, **kw)
    for a, b in zip(given, rebuilt):
        assert torch.equal(a, b)
    _close([t.numpy() for t in given], [np.asarray(r) for r in ref], 2e-5,
           T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_carries_lse_under_ref(dtype):
    """`FlashAttention` on the plain lane saves the forward's lse beside
    q, k, v and o and hands it to the plain backward."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _draw(
        1, 4, 2, 13, 13, 16, 16, seed=3))
    q.requires_grad_()
    o = attention(q, k, v, impl="ref", window=5)
    saved = o.grad_fn.saved_tensors
    _, lse = flash_attention_ref(q.detach(), k, v, return_lse=True,
                                 window=5)
    assert len(saved) == 5 and torch.equal(saved[4], lse)
    (dq,) = torch.autograd.grad(o, (q,), do)
    ref = flash_attention_bwd_ref(q.detach(), k, v, o.detach(), do,
                                  window=5, lse=lse)
    assert torch.equal(dq, ref[0])


@pytest.mark.parametrize("dtype,dk,dv,lane", [
    (torch.bfloat16, 64, 64, "wgmma"), (torch.bfloat16, 128, 128, "wgmma"),
    (torch.bfloat16, 256, 256, "wgmma"), (torch.bfloat16, 192, 128, "f32"),
    (torch.bfloat16, 96, 96, "f32"), (torch.bfloat16, 64, 128, "f32"),
    (torch.float32, 64, 64, "f32"), (torch.float32, 128, 128, "f32"),
    (torch.float16, 64, 64, "f32")])
def test_bwd_lane_dispatch(dtype, dk, dv, lane):
    """The backward's lane from the dtype and head dims alone: the tensor
    cores for bf16 at (64, 64), (128, 128) and (256, 256), the CUDA cores
    for the rest (the forward's tensor-core lane also takes (192, 128),
    whose gradient stays on the CUDA cores)."""
    assert bwd_lane(dtype, dk, dv) == lane
    if dk == dv:
        assert bwd_lane(dtype, dk) == lane


_FA = importlib.import_module("repro_torch.kernels.flash_attention."
                              "flash_attention")


class _Recorder:
    """A kernel library that records each launch's arguments and reports
    success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_error_string"):
            return lambda err: b""
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorded_launches(monkeypatch):
    """CPU tensors taken for CUDA ones and the kernel libraries replaced
    by a recorder: the wrappers' Python path without a card."""
    lib = _Recorder()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("_lib", "_wgmma_lib", "_bwd_lib", "_bwd_wgmma_lib"):
        monkeypatch.setattr(_FA, name, lambda: lib)
    return lib.calls


def test_cuda_core_forward_returns_lse(recorded_launches):
    """return_lse on the CUDA-core lane (float32, and bf16 at dims the
    tensor-core lane lacks) hands the kernel a (B, H, S) float32 buffer
    for it, and None without it."""
    for dtype, dk in ((torch.float32, 64), (torch.bfloat16, 24)):
        q, k, v = (torch.zeros(s, dtype=dtype) for s in (
            (1, 4, 10, dk), (1, 2, 10, dk), (1, 2, 10, dk)))
        assert _FA.kernel_lane(dtype, dk) == "f32"
        o, lse = _FA.flash_attention(q, k, v, return_lse=True)
        assert o.shape == q.shape and o.dtype == dtype
        assert lse.shape == (1, 4, 10) and lse.dtype == torch.float32
        name, args = recorded_launches[-1]
        assert name == "flash_attention_launch"
        assert args[4] == lse.data_ptr()
        assert _FA.flash_attention(q, k, v).shape == q.shape
        assert recorded_launches[-1][1][4] is None


def test_cuda_core_backward_reads_lse(recorded_launches):
    """The CUDA-core backward hands the kernel the forward's lse (None
    rebuilds it), and takes cp.async copies only for head dims of whole
    16-byte chunks."""
    for dk, vec in ((64, 1), (33, 0)):
        q, k, v = (torch.zeros(s) for s in ((1, 4, 10, dk), (1, 2, 10, dk),
                                             (1, 2, 10, dk)))
        lse = torch.zeros((1, 4, 10))
        assert _FA.bwd_lane(torch.float32, dk) == "f32"
        for given in (lse, None):
            dq, dk_, dv = _FA.flash_attention_bwd(q, k, v, q, q, lse=given)
            assert dq.shape == q.shape and dk_.shape == dv.shape == k.shape
            name, args = recorded_launches[-1]
            assert name == "flash_attention_bwd_launch"
            assert args[5] == (None if given is None else lse.data_ptr())
            assert args[-2] == vec


@pytest.mark.parametrize("dtype,dk,dv", [(torch.float32, 64, 64),
                                         (torch.bfloat16, 192, 128),
                                         (torch.bfloat16, 64, 64)])
def test_function_saves_lse_on_both_lanes_under_cuda(monkeypatch, dtype, dk,
                                                     dv):
    """Under "cuda" `FlashAttention.forward` asks the forward for its lse
    on the CUDA-core lane too (float32, bf16 at (192, 128)), saves it, and
    hands it to the backward (the kernels stood in for by their plain
    versions, recording their arguments)."""
    from repro_torch.kernels.flash_attention import ops
    seen = {}

    def fwd(q, k, v, **kw):
        seen["fwd"] = kw
        return flash_attention_ref(q, k, v, **kw)

    def bwd(q, k, v, o, do, **kw):
        seen["bwd"] = kw
        return flash_attention_bwd_ref(q, k, v, o, do, **kw)

    monkeypatch.setattr(ops, "flash_attention", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd", bwd)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _draw(
        1, 4, 2, 12, 12, dk, dv, seed=5))
    q.requires_grad_()
    o = FlashAttention.apply(q, k, v, True, None, 4, 0, "cuda")
    assert seen["fwd"].get("return_lse") is True
    lse = o.grad_fn.saved_tensors[4]
    _, want = flash_attention_ref(q.detach(), k, v, return_lse=True,
                                  window=4)
    assert torch.equal(lse, want)
    (dq,) = torch.autograd.grad(o, (q,), do)
    assert seen["bwd"]["lse"] is lse
    ref = flash_attention_bwd_ref(q.detach(), k, v, o.detach(), do,
                                  window=4, lse=lse)
    assert torch.equal(dq, ref[0])


def test_cuda_core_return_lse_refuses_cpu_tensors():
    """return_lse no longer depends on the lane, but the kernel wrapper
    still takes only CUDA tensors."""
    q, k, v, _ = (torch.from_numpy(a) for a in _draw(1, 2, 1, 4, 4, 8, 8,
                                                     seed=6))
    assert _FA.kernel_lane(q.dtype, 8) == "f32"
    with pytest.raises(ValueError, match="CUDA tensor"):
        _FA.flash_attention(q, k, v, return_lse=True)
