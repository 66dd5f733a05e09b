"""Synthetic web-graph generation.

The paper's experiments use the Stanford-Web matrix (281,903 pages,
2,312,497 non-zeros, 172 dangling nodes) from an actual web crawl. That file
is not reachable from this offline container, so we synthesize graphs whose
statistics match the published numbers, following the measured structure of
the web (power-law in/out-degrees, Broder et al., WWW 2000) — the same
statistical-generation route the paper itself cites as an alternative to
crawling ("synthetically generated using statistical results, e.g. [10]").
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph

# Published Stanford-Web statistics (paper §5.2).
STANFORD_N = 281_903
STANFORD_NNZ = 2_312_497
STANFORD_DANGLING = 172


def powerlaw_webgraph(
    n: int,
    target_nnz: int,
    n_dangling: int = 0,
    alpha_out: float = 2.2,
    alpha_in: float = 2.1,
    locality: float = 0.8,
    site_size: int = 512,
    seed: int = 0,
) -> CSRGraph:
    """Directed power-law graph with ~target_nnz edges and exactly
    n_dangling out-degree-0 nodes.

    Out-degrees ~ truncated zeta(alpha_out); targets chosen by a Zipf
    popularity ranking (preferential-attachment-like in-degree tail,
    Broder et al. report alpha_in ≈ 2.1). A fraction `locality` of links
    stay within the source's "site" (consecutive-id block of `site_size`
    pages) — real crawls are dominated by intra-site links, which both
    slows mixing (second eigenvalue close to alpha, hence the paper's ~44
    power iterations) and produces the block structure that consecutive-row
    partitioning exploits (Kamvar et al. [18])."""
    rng = np.random.default_rng(seed)

    # --- out-degrees -----------------------------------------------------
    n_linked = n - n_dangling
    # zipf gives k >= 1; cap to keep max outdegree realistic (~1k)
    deg = rng.zipf(alpha_out, size=n_linked).astype(np.int64)
    deg = np.minimum(deg, 1000)
    # rescale to hit target_nnz
    scale = target_nnz / max(deg.sum(), 1)
    if scale > 1.0:
        # add uniform extra links where needed
        extra = rng.multinomial(target_nnz - deg.sum(), np.ones(n_linked) / n_linked)
        deg = deg + extra
    else:
        deg = np.maximum((deg * scale).astype(np.int64), 1)
    # exact correction toward target
    diff = int(target_nnz - deg.sum())
    if diff != 0:
        idx = rng.choice(n_linked, size=abs(diff), replace=True)
        np.add.at(deg, idx, 1 if diff > 0 else -1)
        deg = np.maximum(deg, 1)

    nnz = int(deg.sum())

    # --- targets: Zipf-ranked popularity --------------------------------
    # popularity rank permutation so popular pages are spread over id space
    perm = rng.permutation(n)
    src_linked = np.repeat(np.arange(n_linked, dtype=np.int64), deg)
    # place dangling nodes at random ids: build a permutation mapping
    node_perm = rng.permutation(n)
    src = node_perm[src_linked]
    # dangling ids are node_perm[n_linked:]; nothing points out of them.

    def draw_dst(k, src_ids):
        ranks = (rng.zipf(alpha_in, size=k).astype(np.int64) - 1) % n
        global_dst = perm[ranks].astype(np.int64)
        if locality <= 0.0:
            return global_dst
        local = rng.random(k) < locality
        site_start = (src_ids // site_size) * site_size
        local_dst = site_start + rng.integers(0, site_size, size=k)
        local_dst = np.minimum(local_dst, n - 1)
        return np.where(local, local_dst, global_dst)

    # Zipf targets collide heavily; redraw duplicate (src, dst) pairs so the
    # deduplicated edge count stays close to target_nnz.
    dst = draw_dst(nnz, src)
    key = src * n + dst
    for _ in range(40):
        order = np.argsort(key, kind="stable")
        key_sorted = key[order]
        dup_sorted = np.zeros(nnz, dtype=bool)
        dup_sorted[1:] = key_sorted[1:] == key_sorted[:-1]
        dup = np.zeros(nnz, dtype=bool)
        dup[order] = dup_sorted
        ndup = int(dup.sum())
        if ndup == 0:
            break
        # redraw: mostly Zipf, some uniform to break persistent collisions
        new_dst = draw_dst(ndup, src[dup])
        uni = rng.random(ndup) < 0.5
        new_dst[uni] = rng.integers(0, n, size=int(uni.sum()))
        dst[dup] = new_dst
        key[dup] = src[dup] * n + dst[dup]

    g = CSRGraph.from_edges(n, src, dst)
    return g


def stanford_web_replica(seed: int = 0) -> CSRGraph:
    """A graph matching the published Stanford-Web statistics.

    locality/site_size are calibrated so the synchronous power method needs
    a similar iteration count to the paper's 44 (we get ~33 at l2 tol 1e-6;
    the residual gap is real-crawl structure a generator cannot copy)."""
    return powerlaw_webgraph(
        n=STANFORD_N,
        target_nnz=STANFORD_NNZ,
        n_dangling=STANFORD_DANGLING,
        locality=0.93,
        site_size=256,
        seed=seed,
    )


def small_test_graph(n: int = 64, avg_deg: int = 6, n_dangling: int = 3,
                     seed: int = 0) -> CSRGraph:
    """Small deterministic graph for unit tests."""
    return powerlaw_webgraph(n=n, target_nnz=n * avg_deg,
                             n_dangling=n_dangling, seed=seed)


def cycle_graph(n: int) -> CSRGraph:
    """n-cycle: closed-form PageRank = uniform. Useful oracle."""
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    return CSRGraph.from_edges(n, src, dst)
