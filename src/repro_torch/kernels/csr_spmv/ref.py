"""Plain PyTorch versions of the CSR segment-sum kernel's lanes: a gather
of the sources (`index_select`) and a scatter-add into the destination rows
(`index_add_`). On the CPU they add in edge order; on the card `index_add_`
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


def csr_spmv_hub_add_ref(indptr: torch.Tensor, src: torch.Tensor,
                         weight: torch.Tensor, x: torch.Tensor,
                         row_map: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """The hub lane's plain version: float64 products, summed per CSR row
    by `index_add_`, rounded to y's dtype and added into y[row_map] in
    place (row_map's rows are distinct). x (n_cols, nv), y (n_out, nv);
    returns y."""
    counts = indptr[1:] - indptr[:-1]
    row_ids = torch.repeat_interleave(
        torch.arange(row_map.shape[0], device=x.device), counts)
    hub = csr_spmv_ref(row_ids, src, weight.double(), x.double(),
                       row_map.shape[0])
    return y.index_add_(0, row_map, hub.to(y.dtype))
