"""Plain PyTorch version of the CSR segment-sum kernel: a gather of the
sources (`index_select`) and a scatter-add into the destination rows
(`index_add_`). On the CPU it adds in edge order; on the card `index_add_`
adds in atomic order, which the kernel (csr_spmv.py) does not."""
from __future__ import annotations

import torch


def csr_spmv_ref(row_ids: torch.Tensor, src: torch.Tensor,
                 weight: torch.Tensor, x: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """y[r] = sum over edges e with row_ids[e] == r of weight[e] *
    x[src[e]]; x is (n_cols,) or (n_cols, nv)."""
    w = weight if x.ndim == 1 else weight[:, None]
    contrib = w * x.index_select(0, src)
    y = x.new_zeros((n_rows,) + tuple(x.shape[1:]))
    return y.index_add_(0, row_ids, contrib)
