"""Guards on the port's boundaries: it imports neither JAX nor the JAX
package, its entry points default to the CUDA card and never fall back to
the CPU, and its kernels refuse CPU tensors."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_imports_without_jax_or_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core.pagerank, repro_torch.interop\n"
        "import repro_torch.kernels.bsr_spmv, repro_torch.kernels.build\n"
        "import repro_torch.configs.pagerank\n"
        "import repro_torch.kernels.flash_attention, repro_torch.models\n"
        "import repro_torch.models.decode, repro_torch.serving.engine\n"
        "import repro_torch.launch.serve, repro_torch.configs\n"
        "import repro_torch.core.spmd, repro_torch.core.engine\n"
        "import repro_torch.core.partition, repro_torch.core.termination\n"
        "import repro_torch.runtime, repro_torch.kernels.csr_spmv\n"
        "import repro_torch.core.des, repro_torch.runtime.device\n"
        "import repro_torch.runtime.local, repro_torch.runtime.state\n"
        "import repro_torch.runtime.schedule, repro_torch.runtime.observe\n"
        "import repro_torch.streaming, repro_torch.streaming.delta\n"
        "import repro_torch.streaming.incremental\n"
        "import repro_torch.streaming.sharded\n"
        "import repro_torch.streaming.server\n"
        "import repro_torch.streaming.scenario\n"
        "import repro_torch.runtime.transport, repro_torch.runtime.executor\n"
        "import repro_torch.runtime.faults, repro_torch.runtime.supervisor\n"
        "import repro_torch.runtime.step, repro_torch.runtime.exchange\n"
        "import repro_torch.runtime.driver\n"
        "import repro_torch.serving, repro_torch.serving.batcher\n"
        "import repro_torch.serving.ppr_cache, repro_torch.serving.router\n"
        "import repro_torch.training, repro_torch.training.async_dp\n"
        "import repro_torch.analysis, repro_torch.analysis.roofline\n"
        "import repro_torch.analysis.flops, repro_torch.models.moe\n"
        "import repro_torch.configs.qwen2_moe_a2p7b\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.kernels.rglru_scan\n"
        "import repro_torch.models.ssm, repro_torch.models.rglru\n"
        "import repro_torch.configs.mamba2_2p7b\n"
        "import repro_torch.configs.recurrentgemma_2b\n"
        "import repro_torch.configs.whisper_base, repro_torch.data\n"
        "import repro_torch.data.pipeline, repro_torch.launch.train\n"
        "import repro_torch.training.optimizer\n"
        "import repro_torch.training.train_step\n"
        "import repro_torch.training.checkpoint\n"
        "import repro_torch.launch.mesh, repro_torch.launch.specs\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis.count\n"
        "import repro_torch.analysis.bounds\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_default_to_cuda():
    from repro_torch.core import solve_linear, solve_power
    from repro_torch.device import resolve_device
    from repro_torch.graph import GoogleOperator, TransitionT, cycle_graph
    from repro_torch.kernels.bsr_spmv import build_bsr, spmv
    op = GoogleOperator(pt=TransitionT.from_graph(cycle_graph(16)))
    bsr = build_bsr(np.arange(4), np.arange(4), np.ones(4), 4, 4, bm=4,
                    bn=4)
    x = np.ones((1, 4, 1), np.float32)
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
        return
    for call in (lambda: solve_power(op), lambda: solve_linear(op),
                 lambda: solve_power(op, backend="bsr"),
                 lambda: spmv(bsr, x), lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_spmd_entry_points_default_to_cuda():
    from repro_torch.core import AsyncFixedPoint, SPMDConfig, solve_spmd
    from repro_torch.graph import GoogleOperator, TransitionT, cycle_graph
    from repro_torch.graph.csr import pt_matvec
    op = GoogleOperator(pt=TransitionT.from_graph(cycle_graph(16)))
    cfg = SPMDConfig(p=2, tol=1e-9)
    if torch.cuda.is_available():
        return
    afp = AsyncFixedPoint(op)
    for call in (lambda: solve_spmd(op, cfg),
                 lambda: solve_spmd(op, SPMDConfig(p=2, backend="bsr")),
                 lambda: afp.solve_spmd(cfg),
                 lambda: afp.solve_sync()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for r in (solve_spmd(op, cfg, device="cpu"),
              afp.solve_spmd(cfg, device="cpu")):
        np.testing.assert_allclose(r.x, 1.0 / 16, rtol=1e-6)
    dev = op.pt.device_arrays(torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        pt_matvec(dev, torch.ones(16), 16, impl="cuda")


def test_streaming_entry_points_default_to_cuda():
    """Every streaming entry point that can reach the device resolves it
    at entry (None: the card) and raises without one, before the graph
    changes, even where its path would stay on the host; with
    device="cpu" each runs."""
    from repro_torch.core.partition import block_rows
    from repro_torch.graph import cycle_graph
    from repro_torch.streaming import (DeltaGraph, EdgeDelta, RankServer,
                                       ReplayConfig, StreamingBlockOperator,
                                       cold_state, ppr_push_batched,
                                       replay_trace, update_ranks,
                                       update_ranks_sharded)
    if torch.cuda.is_available():
        return
    dg = DeltaGraph(cycle_graph(16))
    st = cold_state(dg, tol=1e-6, device="cpu")
    delta = EdgeDelta.inserts([0], [5])
    for call in (lambda: cold_state(dg),
                 lambda: update_ranks(dg, delta, st),
                 lambda: update_ranks_sharded(dg, delta, st, p=2),
                 lambda: update_ranks_sharded(dg, delta, st, p=2,
                                              mode="async",
                                              transport="device"),
                 lambda: ppr_push_batched(dg, [[1]]),
                 lambda: ppr_push_batched(dg, [[1]], backend="scipy"),
                 lambda: RankServer(dg),
                 lambda: replay_trace(dg, st, [delta], ReplayConfig()),
                 lambda: StreamingBlockOperator(dg, block_rows(16, 2))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        assert dg.version == 0 and st.version == 0
    st, stats = update_ranks(dg, delta, st, tol=1e-6, device="cpu")
    assert stats.cert <= 1e-6 and dg.version == 1
    x, certs, _ = ppr_push_batched(dg, [[1], [2, 3]], device="cpu")
    assert (certs <= 1e-4).all()
    srv = RankServer(dg, tol=1e-6, device="cpu")
    assert srv.snapshot().cert <= 1e-6


def test_query_tier_defaults_to_cuda():
    """The query tier's lane solves resolve their device at construction
    (None: the card) and raise without one, before anything attaches to
    the server; with device="cpu" the tier attaches and answers."""
    from repro_torch.graph import cycle_graph
    from repro_torch.serving import QueryBatcher, attach_query_tier
    from repro_torch.streaming import DeltaGraph, RankServer
    if torch.cuda.is_available():
        return
    srv = RankServer(DeltaGraph(cycle_graph(16)), tol=1e-6, device="cpu")
    for call in (lambda: QueryBatcher(srv),
                 lambda: attach_query_tier(srv, replicas=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        assert srv._ppr_batcher is None and srv._ppr_cache is None
    from _torch_async_drains import within
    batcher, cache, router = attach_query_tier(srv, replicas=1,
                                               device="cpu")
    try:
        x, cert, _ = within(srv.personalized, [3], tol=1e-3)
        assert cert <= 1e-3 and router.top_k(2)[0].size == 2
    finally:
        within(batcher.stop)


def test_lm_entry_points_default_to_cuda():
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.models import Transformer, init_cache
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config("yi-6b")
    if torch.cuda.is_available():
        return
    model = Transformer(cfg, device="cpu")
    for call in (lambda: Transformer(cfg),
                 lambda: ServeEngine(cfg, model),
                 lambda: init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        model(np.zeros((1, 4), np.int64), impl="cuda")


def test_training_and_moe_default_to_cuda():
    """The asynchronous training run and the MoE model resolve their
    device at entry (None: the card) and raise without one; with
    device="cpu" each runs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Transformer
    from repro_torch.training import run_async_training_sim
    if torch.cuda.is_available():
        return
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    for call in (lambda: run_async_training_sim(p=2),
                 lambda: Transformer(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    logits, aux = Transformer(cfg, device="cpu")(np.zeros((1, 4), np.int64))
    assert logits.shape == (1, 4, cfg.padded_vocab) and float(aux) > 0


def test_lm_unported_paths_raise():
    """A local window and a prefix-LM mask, which raised until
    RecurrentGemma's local_attn layers and PaliGemma's prefix were ported,
    now run: a window equals the full attention where it covers the
    sequence and differs where it binds; a prefix equals the causal
    attention where it covers nothing (one position, which every causal
    row sees already) and differs where it binds, in the prefix's rows
    only."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.attention import gqa_attention
    from repro_torch.models import Transformer
    cfg = get_smoke_config("yi-6b")
    model = Transformer(cfg, device="cpu")
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(4)
    full = gqa_attention(model.layers[0].attn, x, cfg, positions=pos)
    wide = gqa_attention(model.layers[0].attn, x, cfg, positions=pos,
                         window=4)
    narrow = gqa_attention(model.layers[0].attn, x, cfg, positions=pos,
                           window=2)
    assert torch.equal(full, wide) and not torch.allclose(full, narrow)
    torch.testing.assert_close(narrow[:, :2], full[:, :2])
    one = gqa_attention(model.layers[0].attn, x, cfg, positions=pos,
                        prefix_len=1)
    two = gqa_attention(model.layers[0].attn, x, cfg, positions=pos,
                        prefix_len=2)
    assert torch.equal(full, one) and not torch.allclose(full[:, :1],
                                                         two[:, :1])
    torch.testing.assert_close(two[:, 2:], full[:, 2:])


def test_cuda_impl_refuses_cpu_tensors():
    from repro_torch.core import BackendSpec, solve_power
    from repro_torch.graph import GoogleOperator, TransitionT, cycle_graph
    op = GoogleOperator(pt=TransitionT.from_graph(cycle_graph(16)))
    with pytest.raises(ValueError, match="CUDA"):
        solve_power(op, backend=BackendSpec(name="bsr", impl="cuda"),
                    device="cpu")
    with pytest.raises(ValueError, match="impl"):
        solve_power(op, backend=BackendSpec(name="bsr", impl="pallas"),
                    device="cpu")


def test_cycle_graph_uniform_on_cpu():
    from repro_torch.core import solve_linear, solve_power
    from repro_torch.graph import GoogleOperator, TransitionT, cycle_graph
    op = GoogleOperator(pt=TransitionT.from_graph(cycle_graph(37)))
    for solve in (solve_power, solve_linear):
        for backend in ("segment_sum", "bsr"):
            r = solve(op, tol=1e-9 if backend == "bsr" else 1e-12,
                      backend=backend, device="cpu")
            np.testing.assert_allclose(r.x, 1.0 / 37, rtol=1e-6)


def test_lm_training_defaults_to_cuda():
    """The training path's entry points (the launcher, make_batch, a
    trainable model, Whisper's engine) resolve their device at entry
    (None: the card) and raise without one; with device="cpu" they run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.launch import train
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine
    if torch.cuda.is_available():
        return
    cfg = get_smoke_config("whisper-base")
    pipe = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                      global_batch=2))
    model = Transformer(cfg, device="cpu")
    for call in (lambda: train.main(["--arch", "whisper-base", "--smoke",
                                     "--steps", "1"]),
                 lambda: make_batch(pipe, cfg, 0),
                 lambda: Transformer(cfg, trainable=True),
                 lambda: ServeEngine(cfg, model)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    batch = make_batch(pipe, cfg, 0, device="cpu")
    assert batch["enc_inputs"].shape == (2, 8, cfg.d_model)
    assert len(train.main(["--arch", "whisper-base", "--smoke", "--steps",
                           "1", "--batch", "2", "--seq", "8", "--device",
                           "cpu"])) == 1
