"""The backward kernel's checks against its plain version on the card: one
list of cases, their limits and their error measure, read by chip_smoke.py's
"flash attention backward against its plain version" phase and by
tests/test_torch_gpu.py."""
from __future__ import annotations

from typing import Sequence

import torch

from .flash_attention import bwd_lane

# (B, H, Hkv, S, T, Dk, Dv, causal, dtype, window, prefix)
BWD_CASES = [
    (1, 4, 2, 128, 128, 64, 64, True, "f32", None, 0),
    (2, 4, 4, 100, 77, 64, 64, False, "f32", None, 0),        # S > T
    (1, 8, 8, 448, 1500, 64, 64, False, "bf16", None, 0),     # Whisper cross
    (1, 8, 8, 448, 1500, 64, 64, False, "f32", None, 0),
    (8, 8, 8, 448, 448, 64, 64, True, "bf16", None, 0),       # Whisper's
    (8, 8, 8, 448, 448, 64, 64, False, "bf16", None, 0),      # training
    (1, 4, 2, 77, 300, 64, 64, True, "f32", None, 0),         # causal S < T
    (1, 4, 2, 300, 77, 128, 128, True, "f32", None, 0),       # causal S > T
    (1, 4, 1, 1, 1, 64, 64, True, "f32", None, 0),            # ragged
    (1, 4, 2, 33, 33, 128, 128, True, "f32", None, 0),        # 1 / 33 / 129
    (1, 4, 2, 129, 129, 64, 64, False, "bf16", None, 0),
    (1, 3, 3, 200, 200, 64, 64, True, "bf16", None, 0),       # G = 1
    (1, 15, 5, 256, 256, 64, 64, True, "bf16", None, 0),      # G = 3
    (1, 8, 1, 300, 300, 128, 128, True, "bf16", None, 0),     # G = 8
    (1, 4, 2, 200, 200, 256, 256, True, "bf16", None, 0),     # D = 256
    (1, 4, 2, 200, 200, 256, 256, True, "f32", None, 0),
    (1, 4, 4, 200, 200, 192, 128, True, "bf16", None, 0),     # MLA
    (1, 4, 4, 129, 129, 192, 128, True, "f32", None, 0),
    (1, 8, 1, 500, 500, 128, 128, True, "f32", 100, 0),       # window
    (1, 4, 2, 300, 300, 64, 64, False, "bf16", 64, 0),
    (1, 10, 1, 1024, 1024, 256, 256, True, "bf16", 512, 0),   # RG's heads
    (1, 4, 2, 300, 300, 128, 128, True, "f32", None, 37),     # prefix
    (1, 4, 2, 300, 300, 256, 256, True, "bf16", None, 129),
    (1, 4, 2, 300, 300, 64, 64, True, "bf16", 77, 150),       # both
    (2, 4, 4, 40, 40, 16, 16, True, "f32", None, 0),          # smoke dims
    (2, 4, 4, 40, 40, 24, 16, True, "f32", None, 0),
    (1, 4, 1, 40, 40, 16, 16, True, "f32", None, 8),
    (1, 32, 4, 1024, 1024, 128, 128, True, "bf16", None, 0),  # Yi-6B heads
    (2, 15, 5, 512, 512, 64, 64, True, "bf16", None, 0),      # SmolLM heads
    # the tensor-core lane's edges (bf16 at (64, 64) and (128, 128)):
    # ragged S and T, S = 1, T = 1, causal S < T and S > T, G in {1, 3, 8}
    # at both head dims (G = 8 at B Hkv = 1: the heads split over blocks),
    # window, prefix, both, not causal
    (1, 4, 2, 200, 333, 64, 64, False, "bf16", None, 0),
    (1, 4, 2, 77, 300, 128, 128, True, "bf16", None, 0),
    (1, 4, 2, 300, 77, 64, 64, True, "bf16", None, 0),
    (2, 4, 2, 1, 200, 64, 64, False, "bf16", None, 0),
    (1, 4, 2, 1, 1, 128, 128, True, "bf16", None, 0),
    (1, 4, 1, 100, 1, 128, 128, True, "bf16", None, 0),
    (1, 8, 1, 300, 300, 64, 64, True, "bf16", None, 0),
    (1, 3, 3, 200, 200, 128, 128, False, "bf16", None, 0),
    (1, 15, 5, 333, 333, 128, 128, True, "bf16", None, 0),
    (1, 8, 1, 500, 500, 128, 128, True, "bf16", 100, 0),
    (1, 4, 2, 300, 300, 128, 128, False, "bf16", 64, 0),
    (1, 4, 2, 300, 300, 128, 128, True, "bf16", None, 37),
    (1, 4, 2, 300, 300, 64, 64, True, "bf16", None, 129),
    (1, 4, 2, 300, 300, 128, 128, True, "bf16", 77, 150),
    # the same edges at (256, 256) (one consumer warpgroup, 64-row q tiles
    # and 64-key tiles): G = 10 at B Hkv = 1 is RecurrentGemma's
    (1, 4, 2, 200, 333, 256, 256, False, "bf16", None, 0),
    (1, 4, 2, 77, 300, 256, 256, True, "bf16", None, 0),
    (1, 4, 2, 300, 77, 256, 256, True, "bf16", None, 0),
    (2, 4, 2, 1, 200, 256, 256, False, "bf16", None, 0),
    (1, 4, 2, 1, 1, 256, 256, True, "bf16", None, 0),
    (1, 4, 1, 100, 1, 256, 256, True, "bf16", None, 0),
    (1, 3, 3, 200, 200, 256, 256, True, "bf16", None, 0),
    (1, 8, 1, 300, 300, 256, 256, True, "bf16", None, 0),
    (1, 10, 1, 333, 333, 256, 256, True, "bf16", None, 0),
    (1, 10, 1, 500, 500, 256, 256, True, "bf16", 100, 0),
    (1, 4, 2, 300, 300, 256, 256, False, "bf16", 64, 0),
    (1, 4, 2, 300, 300, 256, 256, True, "bf16", None, 37),
    (1, 4, 2, 300, 300, 256, 256, True, "bf16", 77, 150),
    (1, 4, 2, 129, 129, 256, 256, False, "bf16", None, 0),
    # the CUDA-core lane's edges (float32 at every head dim, bf16 at the
    # dims the tensor-core backward lacks): its q and kv tiles of 32, 64
    # and 128 rows and keys (63 / 64 / 65, 127 / 128 / 129), S = 1, T = 1,
    # causal S > T, G in {1, 3, 8} (G = 8 at B Hkv = 1), window, prefix,
    # both, not causal, (192, 128) and (24, 16), D = 96 and 33 (33: rows
    # off 16 bytes, synchronous loads)
    (1, 4, 2, 63, 63, 64, 64, True, "f32", None, 0),
    (1, 4, 2, 64, 64, 64, 64, True, "f32", None, 0),
    (1, 4, 2, 65, 65, 64, 64, True, "f32", None, 0),
    (1, 4, 2, 127, 127, 64, 64, True, "f32", None, 0),
    (1, 4, 2, 128, 128, 128, 128, True, "f32", None, 0),
    (1, 4, 2, 129, 129, 64, 64, True, "f32", None, 0),
    (1, 4, 2, 127, 129, 128, 128, False, "f32", None, 0),
    (1, 4, 2, 65, 63, 256, 256, True, "f32", None, 0),
    (2, 4, 2, 1, 200, 64, 64, False, "f32", None, 0),
    (1, 4, 2, 1, 1, 256, 256, True, "f32", None, 0),
    (1, 4, 1, 100, 1, 128, 128, True, "f32", None, 0),
    (1, 3, 3, 200, 200, 64, 64, True, "f32", None, 0),
    (1, 15, 5, 333, 333, 64, 64, True, "f32", None, 0),
    (1, 8, 1, 300, 300, 64, 64, True, "f32", None, 0),
    (1, 8, 1, 300, 300, 256, 256, True, "f32", 100, 0),
    (1, 10, 1, 500, 500, 256, 256, True, "f32", 128, 0),
    (1, 4, 2, 300, 300, 64, 64, False, "f32", 64, 0),
    (1, 4, 2, 300, 300, 64, 64, True, "f32", None, 129),
    (1, 4, 2, 300, 300, 192, 128, True, "f32", 77, 150),
    (1, 4, 2, 200, 333, 96, 96, False, "f32", None, 0),
    (1, 4, 2, 129, 129, 33, 33, True, "f32", None, 0),
    (2, 4, 4, 64, 64, 24, 16, True, "f32", None, 0),
    (1, 4, 2, 129, 129, 33, 33, True, "bf16", None, 0),
    (1, 4, 2, 200, 200, 96, 96, True, "bf16", None, 0),
    (1, 4, 4, 300, 300, 192, 128, True, "bf16", 77, 150),
    (1, 8, 8, 129, 333, 192, 128, False, "bf16", None, 0),
    (1, 8, 1, 1, 1, 192, 128, True, "bf16", None, 0),
    (1, 4, 1, 65, 65, 24, 16, True, "bf16", None, 0),
    (1, 4, 2, 128, 128, 16, 16, True, "bf16", None, 8),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the cases each backward lane takes: each also runs with the forward
# kernel's o and lse, as training feeds it
WGMMA_BWD_CASES = [c for c in BWD_CASES
                   if bwd_lane(DTYPES[c[8]], c[5], c[6]) == "wgmma"]
F32_BWD_CASES = [c for c in BWD_CASES
                 if bwd_lane(DTYPES[c[8]], c[5], c[6]) == "f32"]
# bwd_errors' bound: float32 rounds in another order; bf16 writes its
# gradients rounded to bf16 (one ulp is 3.9e-3 of an element; the
# forward's row error is 4e-3)
BWD_LIMIT = {"f32": 1e-5, "bf16": 1e-2}
# either forward kernel's lse against the plain one, absolute in base-2
# units (a relative error of P of 6.9e-5): the scores' float32 sums run in
# another order
LSE_LIMIT = 1e-4


def bwd_errors(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
               T: int) -> list:
    """max |kernel - plain| of dq, dk and dv, each over the plain
    gradient's largest element. With T = 1 every row sees one key, so the
    softmax has no gradient and dq, dk are 0 in exact arithmetic: their
    plain values are rounding noise, and their errors stay absolute."""
    errs = []
    for i, (a, b) in enumerate(zip(got, ref)):
        err = float((a.float() - b.float()).abs().max())
        scale = 1.0 if T == 1 and i < 2 else float(b.float().abs().max())
        errs.append(err / scale if err else 0.0)
    return errs
