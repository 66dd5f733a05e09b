"""Plain PyTorch version of the block-CSR SpMV kernel.

Layout (see bsr_spmv.py):
  blocks:   (n_block_rows, K, bm, bn)  dense nonzero blocks, zero-padded
  blk_cols: (n_block_rows, K) int32    block-column index of each block
  x:        (n_block_cols, bn, nv)     the iterate(s); nv > 1 computes
                                        several personalized PageRank
                                        vectors at once
  out:      (n_block_rows, bm, nv)
"""
from __future__ import annotations

import torch

ACCUMS = ("f32", "f64", "kahan", "kahan_limit")


def bsr_spmv_ref(blocks: torch.Tensor, blk_cols: torch.Tensor,
                 x: torch.Tensor, accum: str = "f32") -> torch.Tensor:
    """y[i] = sum_k blocks[i, k] @ x[blk_cols[i, k]]; `accum` selects how
    the K slots are summed:

      "f32"         f32 accumulate, one einsum over (k, n).
      "f64"         inputs upcast, contraction in float64, result in x's
                    dtype: the segment-sum-grade lane the compensated lane
                    is held against.
      "kahan"       the compensated loop the CUDA kernel runs: each slot's
                    (bm, bn) @ (bn, nv) product is a plain f32 dot, and the
                    slots are summed with Kahan compensation
                    (y = prod - c; t = acc + y; c = (t - acc) - y).
      "kahan_limit" what an exactly compensated f32 sum converges to: f64
                    accumulate cast back to float32 (the JAX package's
                    plain `accum="kahan"` lane).
    """
    if accum not in ACCUMS:
        raise ValueError(f"unknown accum {accum!r}; expected one of {ACCUMS}")
    xg = x[blk_cols.long()]                       # (nbr, K, bn, nv)
    if accum == "f32":
        return torch.einsum("rkmn,rknv->rmv", blocks.float(), xg.float())
    if accum == "kahan":
        blocks, xg = blocks.float(), xg.float()
        acc = blocks.new_zeros(blocks.shape[0], blocks.shape[2], x.shape[2])
        comp = torch.zeros_like(acc)
        for k in range(blocks.shape[1]):
            prod = torch.bmm(blocks[:, k], xg[:, k])
            y = prod - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        return acc
    y = torch.einsum("rkmn,rknv->rmv", blocks.double(), xg.double())
    return y.float() if accum == "kahan_limit" else y.to(x.dtype)
