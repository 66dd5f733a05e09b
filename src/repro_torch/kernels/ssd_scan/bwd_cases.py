"""The SSD scan backward kernel's checks against its plain version on the
card: one list of cases, their inputs, limits and error measure, read by
chip_smoke.py's "SSD backward against its plain version" phase and by
tests/test_torch_gpu.py."""
from __future__ import annotations

from typing import Sequence

import torch

# (B, S, H, P, N, Q, dtype of x, b, c, h0, dh_last, steep): Mamba2-2.7B's
# training and prefill shapes, S < Q, S = Q + 1, a ragged S % Q, the state
# carried in and out over several chunks, the smoke shapes, P, N and Q
# that are not multiples of the tiles, one step, a steep dt under which
# cum falls below -200 inside a chunk, and the edges of the bf16 lane's
# head groups, pieces and tiles
BWD_CASES = [
    (1, 4096, 80, 64, 128, 256, "bf16", False, False, False),  # training
    (1, 2048, 80, 64, 128, 256, "bf16", False, False, False),  # prefill
    (4, 128, 80, 64, 128, 256, "bf16", False, False, False),   # S < Q
    (1, 257, 80, 64, 128, 256, "bf16", False, False, False),   # S = Q + 1
    (2, 257, 8, 64, 128, 256, "f32", True, False, False),
    (1, 600, 8, 64, 128, 256, "f32", False, False, False),     # ragged
    (2, 300, 4, 64, 128, 128, "f32", True, True, False),       # carry
    (2, 21, 8, 16, 16, 8, "f32", False, False, False),         # smoke
    (2, 37, 3, 40, 100, 16, "f32", True, False, False),        # P, N, Q
    (2, 1, 80, 64, 128, 256, "bf16", True, True, False),       # one step
    (2, 1, 8, 64, 128, 256, "f32", True, True, False),
    (1, 600, 8, 64, 128, 256, "f32", True, True, True),        # steep dt
    (1, 600, 80, 64, 128, 256, "bf16", False, False, True),
    # the bf16 design's edges: head counts off its groups of 2 and pieces
    # of 16 heads (3, 12, 81), a last chunk shorter than a 64-row tile
    # (44, 8, 14, 4 steps), P, N and Q off its tiles and its k16 steps,
    # and the steep dt at H = 80 with a state in and out
    (1, 300, 3, 64, 128, 256, "bf16", True, True, False),
    (2, 520, 12, 64, 128, 256, "bf16", False, True, False),
    (1, 270, 81, 64, 128, 256, "bf16", True, False, False),
    (2, 100, 81, 40, 100, 48, "bf16", True, True, False),
    (1, 200, 12, 24, 72, 40, "bf16", False, True, False),
    (1, 1000, 80, 64, 128, 256, "bf16", True, True, True),
    (1, 300, 3, 64, 128, 256, "f32", True, True, False),
    (1, 270, 81, 40, 100, 48, "f32", True, False, False),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
GRADS = ("dx", "db", "dc", "ddt", "da_log", "dh0")
# bwd_errors' bound for each gradient: a float32 result within 1e-4 of its
# largest element (the forward kernel's own limit), one rounded to bf16
# (dx, db and dc with bf16 x) within 1e-2
F32_LIMIT, BF16_LIMIT = 1e-4, 1e-2


def bwd_limits(dtype: str) -> list:
    """The limit of each gradient of GRADS for x of `dtype`."""
    rounded = BF16_LIMIT if dtype == "bf16" else F32_LIMIT
    return [rounded] * 3 + [F32_LIMIT] * 3


def bwd_inputs(B: int, S: int, H: int, P: int, N: int, dtype: str,
               h0: bool, dh_last: bool, steep: bool, device,
               seed: int) -> tuple:
    """((x, b, c, dt, a_log, h0 or None), dy, dh_last or None) of a case,
    drawn on `device` from `seed`: x and dy standard normal, b and c at
    0.3, dt = softplus(normal - 1), a_log at 0.5; with `steep` dt =
    softplus(normal + 1.5) and a_log 0.5 higher, so that cum falls
    several units a step (to -1,400 over the first chunk of 256 at
    seed 608)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def t(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=device)
    dt_ = DTYPES[dtype]
    x, b, c = t(B, S, H, P).to(dt_), t(B, S, N, scale=0.3).to(dt_), \
        t(B, S, N, scale=0.3).to(dt_)
    dt = torch.nn.functional.softplus(t(B, S, H) + (1.5 if steep else -1.0))
    a_log = t(H, scale=0.5) + (0.5 if steep else 0.0)
    state = t(B, H, P, N) if h0 else None
    dy = t(B, S, H, P).to(dt_)
    return ((x, b, c, dt, a_log, state), dy,
            t(B, H, P, N) if dh_last else None)


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
