"""PageRank workload configs — the paper's own experiment presets."""
from __future__ import annotations

import dataclasses

from ..core.des import DESConfig


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    name: str
    n: int
    nnz: int
    n_dangling: int
    alpha: float = 0.85
    locality: float = 0.8
    site_size: int = 512
    seed: int = 0

    def build(self):
        from ..graph.csr import TransitionT
        from ..graph.generate import powerlaw_webgraph
        from ..graph.google import GoogleOperator
        g = powerlaw_webgraph(n=self.n, target_nnz=self.nnz,
                              n_dangling=self.n_dangling,
                              locality=self.locality,
                              site_size=self.site_size, seed=self.seed)
        return GoogleOperator(pt=TransitionT.from_graph(g),
                              alpha=self.alpha)


# the paper's experiment (§5.2): Stanford-Web, alpha = 0.85, local tol 1e-6
STANFORD = PageRankConfig(
    name="stanford-web", n=281_903, nnz=2_312_497, n_dangling=172,
    locality=0.93, site_size=256)

SMALL = PageRankConfig(name="small", n=20_000, nnz=160_000, n_dangling=50)


def paper_des_config(seed: int = 7) -> DESConfig:
    """The DES testbed calibrated to the paper's cluster (Tables 1-2)."""
    return DESConfig(tol=1e-6, norm="l2", barrier_overhead=0.5, seed=seed)
