"""Helpers shared by the tests/test_torch_*.py parity tests: they read the
JAX package's containers into the plain arrays `repro_torch.interop` takes,
and run the JAX package's float64 paths on any installed JAX."""
import contextlib

import jax
import jax.experimental
import pytest


def op_arrays(op):
    """The arrays `operator_from_arrays` takes, read off a JAX-package
    GoogleOperator."""
    pt = op.pt
    return dict(n=pt.n, indptr=pt.indptr, src=pt.src, weight=pt.weight,
                row_ids=pt.row_ids, dangling=pt.dangling, alpha=op.alpha,
                v=op.v)


def hybrid_arrays(h):
    """The arrays `bsr_from_arrays` takes, read off a JAX-package
    HybridBSR."""
    b = h.bsr
    return dict(n_rows=b.n_rows, n_cols=b.n_cols, bm=b.bm, bn=b.bn,
                blocks=b.blocks, blk_cols=b.blk_cols,
                fill_ratio=b.fill_ratio, hub_rows=h.hub_rows,
                hub_cols=h.hub_cols, hub_vals=h.hub_vals,
                hub_nnz_frac=h.hub_nnz_frac)


def x64() -> contextlib.AbstractContextManager:
    """JAX's scoped float64 mode: `jax.experimental.enable_x64()` before
    JAX 0.9, `jax.enable_x64(True)` from it on."""
    if hasattr(jax.experimental, "enable_x64"):
        return jax.experimental.enable_x64()
    return jax.enable_x64(True)


@pytest.fixture
def ref_x64(monkeypatch):
    """The JAX package's float64 solve scopes x64 with
    `jax.experimental.enable_x64()`, which JAX 0.9 removed; for the length
    of one test, supply it where it is missing so the reference runs."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def graph_arrays(g):
    """The arrays `csr_graph_from_arrays` takes, read off a JAX-package
    CSRGraph."""
    return dict(n=g.n, indptr=g.indptr, indices=g.indices)


def delta_arrays(d):
    """The arrays `edge_delta_from_arrays` takes, read off a JAX-package
    EdgeDelta."""
    return dict(add_src=d.add_src, add_dst=d.add_dst, del_src=d.del_src,
                del_dst=d.del_dst, new_nodes=d.new_nodes)


def state_arrays(s):
    """The arrays `rank_state_from_arrays` takes, read off a JAX-package
    RankState."""
    return dict(x=s.x, r=s.r, version=s.version, alpha=s.alpha, v=s.v)
