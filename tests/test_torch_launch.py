"""The dry run of the port (`repro_torch.launch.{mesh,specs,dryrun}`,
`repro_torch.analysis.count`) against the JAX package's, on the CPU.

The shapes, the optimizer settings and the skip set equal the JAX
package's; every cell's parameters, optimizer state, batch and cache match
the JAX avals leaf by leaf in shape and dtype (through the mapping of
`interop.lm_params_from_arrays`) with equal byte totals and nothing
allocated; the counter's FLOPs equal a hand count; each kernel's meta lane
gives the plain version's shapes and dtypes and books the shared formulas
(`analysis.bounds`); the multiplied count equals the full count; a cell's
record is written.

`repro/launch/dryrun.py` sets XLA_FLAGS to 512 host devices when it is
imported, so it is imported only in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.launch.mesh import make_test_mesh
from repro.models.param import abstract_params
from repro.models.transformer import model_defs as jax_model_defs
from repro.training.optimizer import OptConfig as JaxOptConfig
from repro.training.optimizer import abstract_opt_state

from repro_torch import interop
from repro_torch.analysis import bounds
from repro_torch.analysis.count import (ALLOC_GRANULE, StepCounter,
                                        count_step, storage_bytes)
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.kernels import resolve_impl
from repro_torch.kernels.flash_attention import (bwd_lane,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref,
                                                 kernel_lane)
from repro_torch.kernels.flash_attention.flash_attention import (
    bwd_workspace_numel, flash_attention, flash_attention_bwd)
from repro_torch.kernels.rglru_scan import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.kernels.rglru_scan.rglru_scan import (
    bwd_part_bytes, rglru_scan_bwd_kernel, rglru_scan_kernel,
    scan_workspace_bytes as lru_workspace_bytes)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (
    bwd_workspace_bytes as ssd_bwd_workspace_bytes, scan_workspace_bytes,
    ssd_scan_bwd_kernel, ssd_scan_kernel)
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import dp_size, make_mesh, tp_size
from repro_torch.models.transformer import encoder_config

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")


# ------------------------------------------------------ shapes and skips --
@pytest.fixture(scope="module")
def jax_dryrun_settings():
    """SHAPES, opt_config_for(cfg) and supports_shape(shape) of every arch,
    from the JAX package's dryrun module imported in a subprocess."""
    code = (
        "import dataclasses, json\n"
        "from repro.launch import dryrun\n"
        "from repro.configs import ARCH_NAMES, get_config\n"
        "out = {'shapes': dryrun.SHAPES, 'archs': ARCH_NAMES, 'opt': {},\n"
        "       'skip': {}}\n"
        "for a in ARCH_NAMES:\n"
        "    cfg = get_config(a)\n"
        "    out['opt'][a] = dataclasses.asdict(dryrun.opt_config_for(cfg))\n"
        "    out['skip'][a] = {s: list(cfg.supports_shape(s))\n"
        "                      for s in dryrun.SHAPES}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_shapes_opt_configs_and_skips_match_jax(jax_dryrun_settings):
    ref = jax_dryrun_settings
    assert specs.SHAPES == ref["shapes"] == jspecs.SHAPES
    assert sorted(ARCH_NAMES) == sorted(ref["archs"])
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        assert dataclasses.asdict(dryrun.opt_config_for(cfg)) == \
            ref["opt"][arch], arch
        for shape in specs.SHAPES:
            assert list(cfg.supports_shape(shape)) == ref["skip"][arch][shape]
    assert dataclasses.asdict(dryrun.opt_config_for(
        get_config("deepseek-v3-671b")))["accum_steps"] == 8


def test_one_card_mesh():
    mesh = make_mesh()
    assert mesh.axis_names == ("data", "model") and mesh.shape == (1, 1)
    assert dp_size(mesh) == tp_size(mesh) == mesh.size == 1
    assert mesh.tag == "1xH100"


# --------------------------------------------------------------- specs ----
def _avals_of(tree):
    """numpy-free stand-ins of a tree of jax avals."""
    return jax.tree_util.tree_map(
        lambda a: SimpleNamespace(shape=tuple(a.shape),
                                  dtype=np.dtype(a.dtype).name), tree)


def _unstack(tree, r):
    if isinstance(tree, dict):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return SimpleNamespace(shape=tree.shape[1:], dtype=tree.dtype)


def _jax_layers(cfg, group, n_layers, first_dense, where, monkeypatch):
    """The layers of a JAX stacked group (parameters or cache) in the
    port's order, by `interop._stacked_layers`' mapping, leaves as
    (shape, dtype) stand-ins."""
    monkeypatch.setattr(interop, "_index", _unstack)
    return interop._stacked_layers(cfg, group, n_layers, first_dense, where)


def _jax_param_tree(jcfg, cfg, tree, monkeypatch):
    """A JAX LM parameter tree (or a moment tree) in the port's layout."""
    tree = dict(_avals_of(tree))
    ours = {"embed": tree.pop("embed"),
            "layers": _jax_layers(cfg, tree.pop("decoder"), cfg.n_layers,
                                  cfg.first_dense_layers, "decoder",
                                  monkeypatch),
            "final_norm": tree.pop("final_norm")}
    if cfg.is_encdec:
        ours["encoder"] = _jax_layers(encoder_config(cfg),
                                      tree.pop("encoder"), cfg.n_enc_layers,
                                      0, "encoder", monkeypatch)
        ours["enc_norm"] = tree.pop("enc_norm")
    assert not tree, sorted(tree)
    return ours


def _assert_same_leaves(ours, theirs, path=""):
    """Every port tensor on the meta device and equal in shape and dtype
    to its JAX stand-in; returns the bytes compared."""
    if isinstance(ours, torch.Tensor):
        assert ours.is_meta, path
        assert tuple(ours.shape) == tuple(theirs.shape), path
        assert str(ours.dtype).removeprefix("torch.") == theirs.dtype, path
        return ours.numel() * ours.element_size()
    if isinstance(ours, dict):
        assert set(ours) == set(theirs), (path, set(ours) ^ set(theirs))
        return sum(_assert_same_leaves(ours[k], theirs[k], f"{path}/{k}")
                   for k in ours)
    assert len(ours) == len(theirs), path
    return sum(_assert_same_leaves(a, b, f"{path}/{i}")
               for i, (a, b) in enumerate(zip(ours, theirs)))


def _jax_bytes(tree):
    return sum(int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
               for a in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_jax_avals(arch, monkeypatch):
    """Every supported cell: the parameters, the optimizer state, the batch
    and the cache match the JAX package's avals leaf by leaf, with equal
    byte totals, every tensor on the meta device."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jparams = abstract_params(jax_model_defs(jcfg))
    mesh = make_test_mesh(1, 1)
    for shape, sh in specs.SHAPES.items():
        if not cfg.supports_shape(shape)[0]:
            continue
        if sh["kind"] == "train":
            opt = dryrun.opt_config_for(cfg)
            state = specs.state_specs(cfg, opt)
            jopt = abstract_opt_state(jparams, JaxOptConfig(
                **dataclasses.asdict(opt)))
            n = _assert_same_leaves(state["params"], _jax_param_tree(
                jcfg, cfg, jparams, monkeypatch))
            assert n == _jax_bytes(jparams)
            for k in ("m", "v"):
                n = _assert_same_leaves(state["opt"][k], _jax_param_tree(
                    jcfg, cfg, jopt[k], monkeypatch))
                assert n == _jax_bytes(jopt[k])
            _assert_same_leaves(state["opt"]["step"],
                                _avals_of(jopt["step"]))
        batch = specs.batch_specs(cfg, shape)
        jbatch, _ = jspecs.batch_specs(jcfg, shape, mesh)
        n = _assert_same_leaves(batch, _avals_of(jbatch))
        assert n == _jax_bytes(jbatch)
        if sh["kind"] != "decode":
            continue
        cache = specs.cache_abstract(cfg, shape)
        jcache = dict(_avals_of(jspecs.cache_abstract(jcfg, shape)))
        # the JAX cache's step count is an int32 scalar, the port's an int
        assert jcache.pop("length").shape == () and cache["length"] == 0
        jcross = jcache.pop("cross", None)
        layers = _jax_layers(cfg, jcache, cfg.n_layers,
                             cfg.first_dense_layers, "cache", monkeypatch)
        n = _assert_same_leaves(cache["layers"], layers)
        if cfg.is_encdec:
            n += _assert_same_leaves(cache["cross"], _jax_layers(
                cfg, jcross, cfg.n_layers, cfg.first_dense_layers, "cross",
                monkeypatch))
        total = _jax_bytes(jspecs.cache_abstract(jcfg, shape))
        assert n + 4 == total, (n, total)


def test_specs_allocate_nothing():
    """The 671B state and the largest cache are meta tensors: built in a
    blink, holding no memory."""
    cfg = get_config("deepseek-v3-671b")
    state = specs.state_specs(cfg, dryrun.opt_config_for(cfg))
    leaves = [t for t in jax.tree_util.tree_leaves(state)
              if isinstance(t, torch.Tensor)]
    assert leaves and all(t.is_meta for t in leaves)
    assert storage_bytes(state["params"]) > 1.3e12
    cache = specs.cache_abstract(get_config("recurrentgemma-2b"),
                                 "long_500k")
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(cache)
               if isinstance(t, torch.Tensor))


# ------------------------------------------------------------- counter ----
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=250, act="silu_glu", tie_embeddings=True)


def test_counter_flops_equal_a_hand_count():
    """One prefill forward of a tiny dense config: the products' FLOPs
    (q, k, v, o and the MLP's three projections a layer, the logits) and
    the attention kernel's 2 (Dk + Dv) a masked pair and head."""
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), **TINY)
    B, S = 2, 48
    c = dryrun.count_cell(cfg, "prefill", B, S)
    D, H, Hkv, dh, F = 64, 4, 2, 16, 128
    V = cfg.padded_vocab
    proj = 2 * B * S * (D * H * dh + 2 * D * Hkv * dh + H * dh * D
                        + 3 * D * F)
    pairs = S * (S + 1) // 2
    attn = 2 * (dh + dh) * pairs * B * H
    logits = 2 * B * S * D * V
    assert c.aten_flops == cfg.n_layers * proj + logits
    assert c.kernel_flops == cfg.n_layers * attn
    assert c.flops == c.aten_flops + c.kernel_flops
    fa = c.kernels["flash_attention"]
    assert fa["calls"] == cfg.n_layers and fa["launches"] == {
        "fwd": cfg.n_layers, "wgmma": 0}
    assert c.memory.argument_size_in_bytes == storage_bytes(
        specs.params_specs_only(cfg)) + ALLOC_GRANULE


def test_counter_tracks_live_storages():
    """Arguments held before the step, a temporary freed inside it, and
    the peak of the live bytes."""
    x = torch.empty((1024,), device=META)               # 4 KiB

    def step(x):
        t = torch.empty((4096,), device=META)           # 16 KiB, freed
        del t
        return x + 1                                    # 4 KiB out

    c = count_step(step, (x,))
    m = c.memory
    assert m.argument_size_in_bytes == 4096
    assert m.peak_bytes == 4096 + 16384
    assert m.temp_size_in_bytes == 16384
    assert m.output_size_in_bytes == 4096
    assert c.aten_bytes == 2 * 4096                     # the add only


# ----------------------------------------------------------- meta lanes ----
def _meta(*tensors):
    return [None if t is None else t.to(META) for t in tensors]


def _same_results(meta_out, ref_out):
    for a, b in zip(meta_out, ref_out):
        if b is None:
            assert a is None
            continue
        assert a.is_meta and a.shape == b.shape and a.dtype == b.dtype


def _counted(fn, *args, **kw):
    counter = StepCounter()
    counter.hold(args)
    with counter:
        out = fn(*args, **kw)
    return out, counter


def test_resolve_impl_meta_lane():
    m, c = torch.empty(2, device=META), torch.empty(2)
    assert resolve_impl("auto", m) == "meta"
    assert resolve_impl("auto", c) == "ref"
    assert resolve_impl("ref", m) == "ref"
    with pytest.raises(ValueError, match="CUDA"):
        resolve_impl("cuda", m)
    with pytest.raises(ValueError, match="meta"):
        resolve_impl("meta", c)


@pytest.mark.parametrize("dtype,dk,dv,window,prefix", [
    (torch.float32, 16, 16, None, 0), (torch.bfloat16, 64, 64, None, 0),
    (torch.bfloat16, 192, 128, None, 0), (torch.bfloat16, 24, 24, 8, 0),
    (torch.float32, 32, 32, None, 5)])
def test_flash_meta_lane(dtype, dk, dv, window, prefix):
    """Forward and backward: the plain version's shapes and dtypes, the
    workspace the card's call allocates, one booking each with the
    bounds' formulas and the lane's launch keys."""
    B, H, Hkv, S = 2, 4, 2, 20
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, S, dk, generator=g).to(dtype)
    k = torch.randn(B, Hkv, S, dk, generator=g).to(dtype)
    v = torch.randn(B, Hkv, S, dv, generator=g).to(dtype)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    o_ref, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    (o, lse), counter = _counted(flash_attention, *_meta(q, k, v),
                                 return_lse=True, **kw)
    _same_results((o, lse), (o_ref, lse_ref))
    work, nbytes = bounds.attention_cost(
        B, H, S, S, dk, dv, Hkv, q.element_size(),
        str(dtype).removeprefix("torch."), True, window, prefix)
    wg = int(kernel_lane(dtype, dk, dv) == "wgmma")
    assert counter.kernels == {"flash_attention": {
        "calls": 1, "launches": {"fwd": 1, "wgmma": wg}, "flops": work,
        "bytes": nbytes}}
    do = torch.randn(o_ref.shape, generator=g).to(dtype)
    grads_ref = flash_attention_bwd_ref(q, k, v, o_ref, do, lse=lse_ref, **kw)
    args = _meta(q, k, v, o_ref, do)
    grads, counter = _counted(flash_attention_bwd, *args,
                              lse=lse.to(META), **kw)
    _same_results(grads, grads_ref)
    lane = bwd_lane(dtype, dk, dv)
    work, nbytes = bounds.flash_bwd_cost(
        B, H, S, S, dk, dv, Hkv, q.element_size(),
        str(dtype).removeprefix("torch."), True, window, prefix)
    assert counter.kernels["flash_attention"] == {
        "calls": 1, "launches": {"bwd": 1, "bwd_wgmma": int(lane == "wgmma")},
        "flops": work, "bytes": nbytes}
    ws = 4 * bwd_workspace_numel(B, H, Hkv, S, S, dk, dv, lane)
    results = sum(-(-t.numel() * t.element_size() // ALLOC_GRANULE)
                  * ALLOC_GRANULE for t in grads)
    held = counter.arguments
    assert counter.peak == held + results + -(-ws // ALLOC_GRANULE) * \
        ALLOC_GRANULE


def test_flash_workspace_formula():
    """The tensor-core backward's workspace: each row's lse and Delta over
    S padded to 128, and the head splits' partials where they split."""
    assert bwd_workspace_numel(1, 4, 4, 100, 100, 64, 64, "f32") == 800
    # SmolLM-360M's training shape: G = 3 heads a group, no split
    assert bwd_workspace_numel(8, 15, 5, 2048, 2048, 64, 64, "wgmma") == \
        2 * 8 * 15 * 2048
    # RecurrentGemma-2B's: G = 10 over 1 kv head, split 5 ways at 132 SMs
    n = bwd_workspace_numel(1, 10, 1, 4096, 4096, 256, 256, "wgmma")
    assert n == 2 * 10 * 4096 + 2 * 5 * 4096 * 256


@pytest.mark.parametrize("dtype,S,P,N,h0", [
    (torch.float32, 40, 16, 8, False), (torch.bfloat16, 40, 12, 10, True),
    (torch.float32, 1, 16, 8, True)])
def test_ssd_meta_lane(dtype, S, P, N, h0):
    B, H, Q = 2, 3, 16
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, H, P, generator=g).to(dtype)
    b = torch.randn(B, S, N, generator=g).to(dtype)
    c = torch.randn(B, S, N, generator=g).to(dtype)
    dt = torch.rand(B, S, H, generator=g)
    a_log = torch.randn(H, generator=g)
    h = torch.randn(B, H, P, N, generator=g) if h0 else None
    ref = ssd_scan_ref(x, b, c, dt, a_log, Q, h)
    out, counter = _counted(ssd_scan_kernel, *_meta(x, b, c, dt, a_log), Q,
                            *_meta(h))
    _same_results(out, ref)
    itemsize, bf16 = x.element_size(), dtype == torch.bfloat16
    if S == 1:
        work, nbytes = bounds.ssd_step_cost(B, H, P, N, itemsize)
        launches = {"step": 1}
    else:
        work, nbytes = bounds.ssd_scan_cost(B, S, H, P, N, Q, itemsize, bf16)
        launches = {"scan": 3}
    assert counter.kernels == {"ssd_scan": {
        "calls": 1, "launches": launches, "flops": work, "bytes": nbytes}}
    dy = torch.randn(ref[0].shape, generator=g).to(dtype)
    dh_last = torch.randn(B, H, P, N, generator=g)
    grads_ref = ssd_scan_bwd_ref(x, b, c, dt, a_log, Q, dy, dh_last, h)
    grads, counter = _counted(ssd_scan_bwd_kernel, *_meta(x, b, c, dt, a_log),
                              Q, *_meta(dy, dh_last, h))
    _same_results(grads, grads_ref)
    work, nbytes = bounds.ssd_bwd_cost(B, S, H, P, N, min(Q, S), itemsize,
                                       bf16)
    assert counter.kernels["ssd_scan"] == {
        "calls": 1, "launches": {"bwd": 1}, "flops": work, "bytes": nbytes}


def test_ssd_workspace_formulas():
    """Mamba2-2.7B's training shape, by hand: 16 chunks of 256."""
    B, S, H, P, N, Q = 1, 4096, 80, 64, 128, 256
    nc = 16
    assert scan_workspace_bytes(B, S, H, P, N, Q) == 4 * nc * (
        H * P * N + Q * Q + H * Q)
    assert scan_workspace_bytes(B, 1, H, P, N, Q) == 0
    pieces = 1 + 4
    assert ssd_bwd_workspace_bytes(B, S, H, P, N, Q) == 4 * (
        2 * nc * H * P * N + nc * Q * Q + 3 * nc * H * Q + 2 * nc * Q * Q
        + 2 * pieces * S * N + nc * H)


@pytest.mark.parametrize("dtype,S,h0", [(torch.float32, 70, False),
                                        (torch.bfloat16, 130, True),
                                        (torch.float32, 1, True)])
def test_rglru_meta_lane(dtype, S, h0):
    B, W = 2, 40
    g = torch.Generator().manual_seed(2)
    u = torch.randn(B, S, W, generator=g).to(dtype)
    ga, gi = (torch.randn(B, S, W, generator=g) for _ in range(2))
    b_a, b_i, lam = (torch.randn(W, generator=g) for _ in range(3))
    h = torch.randn(B, W, generator=g) if h0 else None
    ref = rglru_scan_ref(u, ga, gi, b_a, b_i, lam, h)
    out, counter = _counted(rglru_scan_kernel,
                            *_meta(u, ga, gi, b_a, b_i, lam, h))
    _same_results((out,), (ref,))
    work, nbytes = bounds.rglru_cost(B, S, W, u.element_size(), h0)
    assert counter.kernels == {"rglru_scan": {
        "calls": 1, "launches": {"step" if S == 1 else "scan": 1},
        "flops": work, "bytes": nbytes}}
    ws = lru_workspace_bytes(B, S, W)
    assert counter.peak - counter.arguments == (
        -(-ref.numel() * 4 // ALLOC_GRANULE) * ALLOC_GRANULE
        + -(-ws // ALLOC_GRANULE) * ALLOC_GRANULE)
    dh = torch.randn(B, S, W, generator=g)
    grads_ref = rglru_scan_bwd_ref(u, ga, gi, b_a, b_i, lam, ref, dh, h)
    grads, counter = _counted(rglru_scan_bwd_kernel,
                              *_meta(u, ga, gi, b_a, b_i, lam, ref, dh, h))
    _same_results(grads, grads_ref)
    work, nbytes = bounds.rglru_bwd_cost(B, S, W, u.element_size(), h0)
    assert counter.kernels["rglru_scan"] == {
        "calls": 1, "launches": {"bwd": 1}, "flops": work, "bytes": nbytes}
    assert bwd_part_bytes(B, S, W) == 12 * B * -(-S // 64) * W


def test_lru_workspace_groups():
    """Past 64 chunks the composites come in groups of ceil(sqrt(chunks)):
    1 x 32768 x 2560 is 512 chunks in 23 groups."""
    assert lru_workspace_bytes(1, 32768, 2560) == 16 + 8 * (512 + 23) * 2560
    assert lru_workspace_bytes(1, 4096, 2560) == 16 + 8 * (64 + 1) * 2560
    assert lru_workspace_bytes(4, 1, 2560) == 0


# ------------------------------------------------------- multiplication ----
@pytest.mark.parametrize("arch,n_layers,accum", [
    ("deepseek-v3-671b", 5, 4), ("smollm-360m", 4, 3)])
def test_multiplied_count_equals_full_count(arch, n_layers, accum):
    """A train step with micro-batches at a small config, counted in full
    and by the cut counts extended: FLOPs, bytes, ops and bookings equal
    exactly, and so do the memory's fields."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=n_layers)
    opt = dataclasses.replace(dryrun.opt_config_for(cfg), accum_steps=accum)
    full = dryrun.count_cell(cfg, "train", accum, 32, opt, multiply=False)
    mult = dryrun.count_cell(cfg, "train", accum, 32, opt, multiply=True)
    for f in ("flops", "hbm_bytes", "aten_flops", "aten_bytes",
              "kernel_flops", "kernel_bytes", "ops"):
        assert getattr(mult, f) == pytest.approx(getattr(full, f),
                                                 rel=1e-12, abs=0), f
    assert mult.kernels.keys() == full.kernels.keys()
    for name, b in full.kernels.items():
        m = mult.kernels[name]
        assert m["calls"] == b["calls"] and m["launches"] == b["launches"]
        assert m["bytes"] == pytest.approx(b["bytes"], rel=1e-12)
        assert m["flops"].keys() == b["flops"].keys()
    assert mult.memory == full.memory


# ----------------------------------------------------------------- memo ----
class _NoMemo(dict):
    """A memo that keeps nothing: every op runs its meta kernel."""

    def __setitem__(self, key, value):
        pass


@pytest.mark.parametrize("arch,kind", [("recurrentgemma-2b", "train"),
                                       ("mamba2-2.7b", "decode"),
                                       ("deepseek-v3-671b", "decode"),
                                       ("whisper-base", "prefill")])
def test_memoized_results_count_the_same(arch, kind, monkeypatch):
    """The counter's memo of functional ops' results changes nothing: a
    step counted with it (twice, the second from a full memo) and without
    it comes to the same FLOPs, bytes, ops, memory and bookings."""
    from repro_torch.analysis import count
    cfg = get_smoke_config(arch)
    monkeypatch.setattr(count, "_MEMO", {})
    first = dryrun.count_cell(cfg, kind, 8, 32)
    again = dryrun.count_cell(cfg, kind, 8, 32)
    assert count._MEMO and any(v is not None for v in count._MEMO.values())
    monkeypatch.setattr(count, "_MEMO", _NoMemo())
    plain = dryrun.count_cell(cfg, kind, 8, 32)
    for c in (first, again):
        assert dataclasses.asdict(c) == dataclasses.asdict(plain)


# ------------------------------------------------------------ run_cell ----
def test_run_cell_writes_its_record(tmp_path):
    rec = dryrun.run_cell("whisper-base", "decode_32k", tmp_path,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    path = tmp_path / "whisper-base_decode_32k_1xH100.json"
    assert json.loads(path.read_text())["status"] == "ok"
    assert rec["mesh"] == "1xH100" and rec["chips"] == 1
    assert rec["kind"] == "decode" and rec["roofline"]["dominant"]
    m = rec["memory"]
    assert m["alias_size_in_bytes"] > 0
    assert m["peak_bytes"] == m["argument_size_in_bytes"] + \
        m["temp_size_in_bytes"]
    assert rec["fits"] == (m["peak_bytes"] <= rec["device_memory_bytes"])
    model, args, alias = dryrun.input_specs("whisper-base", "decode_32k")
    assert alias is args[2] and all(
        t.is_meta for t in jax.tree_util.tree_leaves(args)
        if isinstance(t, torch.Tensor))
    assert storage_bytes(args) == m["argument_size_in_bytes"]
    assert storage_bytes(alias) == m["alias_size_in_bytes"]
    skip = dryrun.run_cell("yi-6b", "long_500k", tmp_path, verbose=False)
    assert skip["status"] == "skipped" and "quadratic" in skip["reason"]
    assert (tmp_path / "yi-6b_long_500k_1xH100.json").exists()
