"""The RG-LRU backward kernel's checks against its plain version on the
card: one list of cases, their inputs, limits and error measure, read by
chip_smoke.py's "RG-LRU backward against its plain version" phase and by
tests/test_torch_gpu.py."""
from __future__ import annotations

from typing import Sequence

import torch

# (B, S, W, dtype of u, h0, clamp): the forward kernel's cases
# (RecurrentGemma-2B's width at its prefill and training length, S = 1,
# one chunk + 1, 128 chunks, 512 chunks in groups, ragged W, the smoke
# width), float32 u at the training shape, one where the clamp of
# m = sqrt(max(1 - a^2, 1e-12)) holds (ga + b_a <= -30 on half the
# steps), and three at the edges of the backward's channel tiles
BWD_CASES = [
    (1, 4096, 2560, "bf16", False, False),            # recurrentgemma-2b
    (1, 4096, 2560, "f32", False, False),
    (4, 128, 2560, "bf16", False, False),
    (4, 1, 2560, "bf16", True, False),                # one step
    (4, 1, 2560, "f32", True, False),
    (2, 129, 2560, "bf16", True, False),              # one chunk + 1
    (1, 16384, 256, "f32", True, False),              # 256 chunks
    (1, 32768, 2560, "bf16", True, False),            # 512 chunks, groups
    (2, 1000, 300, "f32", True, False),               # ragged W, h0
    (3, 65, 64, "f32", False, False),                 # smoke width
    (1, 7, 5, "f32", True, False),
    (2, 300, 2560, "f32", True, True),                # the clamp holds
    (2, 300, 2560, "bf16", False, True),
    # the edges of the backward's tiles of 32 channels: W past a tile
    # edge with 16-byte copies (2600) and without (70), B > 1 so that the
    # last block of a tile adds B nch rows, S = 4097 (65 chunks, groups)
    (2, 4097, 2600, "bf16", True, False),
    (3, 4097, 200, "f32", False, False),
    (3, 1000, 70, "bf16", True, False),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
GRADS = ("du", "dga", "dgi", "db_a", "db_i", "dlam", "dh0")
# bwd_errors' bound for each gradient: du, dga, dgi and dh0 from float32
# recurrences that round in another order (du with bf16 u: one bf16
# rounding of each element); db_a, db_i and dlam sums over B S terms in
# another order
ELEM_LIMIT, BF16_DU_LIMIT, SUM_LIMIT = 1e-5, 1e-2, 1e-4


def bwd_limits(dtype: str) -> list:
    """The limit of each gradient of GRADS for u of `dtype`."""
    du = BF16_DU_LIMIT if dtype == "bf16" else ELEM_LIMIT
    return [du, ELEM_LIMIT, ELEM_LIMIT, SUM_LIMIT, SUM_LIMIT, SUM_LIMIT,
            ELEM_LIMIT]


def bwd_inputs(B: int, S: int, W: int, dtype: str, h0: bool, clamp: bool,
               device, seed: int) -> tuple:
    """(u, ga, gi, b_a, b_i, lam, h0 or None) and dh of a case, drawn on
    `device` from `seed`: u, ga, gi, dh standard normal, b_a and b_i at
    0.5, lam about 1; with `clamp` the first half of the steps' ga put at
    -30 - b_a - |ga|."""
    g = torch.Generator(device=device).manual_seed(seed)

    def t(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=device)
    u, ga, gi = t(B, S, W).to(DTYPES[dtype]), t(B, S, W), t(B, S, W)
    b_a, b_i, lam = t(W, scale=0.5), t(W, scale=0.5), t(W) + 1.0
    if clamp:
        ga[:, :S // 2] = -30.0 - b_a - ga[:, :S // 2].abs()
    state = t(B, W) if h0 else None
    return (u, ga, gi, b_a, b_i, lam, state), t(B, S, W)


def bwd_errors(got: Sequence, ref: Sequence) -> list:
    """max |kernel - plain| of each gradient over the plain gradient's
    largest element (0 where the plain one is 0 too; None for a dh0 not
    asked for)."""
    errs = []
    for a, b in zip(got, ref):
        if b is None:
            errs.append(None)
            continue
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        errs.append(err / scale if scale else err)
    return errs
