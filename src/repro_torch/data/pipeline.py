"""Deterministic synthetic token pipeline (no corpora offline).

A reproducible mixture resembling language statistics: Zipf unigrams +
short-range Markov structure + copy spans, so models have something
learnable (the loss drops measurably within a few hundred steps). Batch t
is a pure function of (seed, t), so a run restarted at step k reads the
same stream (checkpoint/resume). `DataConfig` and `SyntheticTokens` are
numpy only, copied from the JAX package's (so its stream is reproduced bit
for bit); `make_batch` places a batch on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 32_000
    seq_len: int = 512
    global_batch: int = 8
    zipf_a: float = 1.3
    markov_strength: float = 0.7   # prob of a structured transition
    copy_prob: float = 0.1         # chance of a copy-back span
    seed: int = 1234


class SyntheticTokens:
    """Stateless-per-step generator: batch t is a pure function of (seed, t),
    so restart-at-step-k reproduces the exact stream (checkpoint/resume)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed Zipf unigram table + a sparse deterministic successor map
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.unigram = p / p.sum()
        self.successor = base.permutation(v)  # tok -> likely next tok

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S), p=self.unigram)
        # Markov structure: with prob markov_strength, next = successor[cur]
        use = rng.random((B, S)) < cfg.markov_strength
        for t in range(1, S):
            toks[:, t] = np.where(use[:, t], self.successor[toks[:, t - 1]],
                                  toks[:, t])
        # copy spans
        n_copy = int(B * cfg.copy_prob)
        if n_copy and S >= 32:
            rows = rng.choice(B, size=n_copy, replace=False)
            for r in rows:
                src = rng.integers(0, S // 2 - 8)
                dst = rng.integers(S // 2, S - 8)
                toks[r, dst:dst + 8] = toks[r, src:src + 8]
        return toks.astype(np.int32)

    def shard_iter(self, shard: int, n_shards: int,
                   start_step: int = 0) -> Iterator[np.ndarray]:
        """Host-sharded stream: each host materializes only its rows."""
        if self.cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {self.cfg.global_batch} does "
                             f"not split into {n_shards} shards")
        rows = self.cfg.global_batch // n_shards
        step = start_step
        while True:
            b = self.batch(step)
            yield b[shard * rows:(shard + 1) * rows]
            step += 1


def make_batch(pipe: SyntheticTokens, cfg_model, step: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The global batch of `step` on `device` (None: the CUDA card):
    tokens (B, S) int32 and, for an encoder-decoder, enc_inputs (B,
    int(S * enc_seq_ratio), d_model) and, for a prefix-LM, prefix_embeds
    (B, prefix_len, d_model), both N(0, 0.02^2) in the compute dtype
    drawn from the seeds (seed, step, 7) and (seed, step, 11)."""
    dev = resolve_device(device)
    tokens = pipe.batch(step)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    B = tokens.shape[0]
    if cfg_model.is_encdec:
        rng = np.random.default_rng((pipe.cfg.seed, step, 7))
        s_enc = int(pipe.cfg.seq_len * cfg_model.enc_seq_ratio)
        batch["enc_inputs"] = torch.as_tensor(
            rng.standard_normal((B, s_enc, cfg_model.d_model)) * 0.02,
            dtype=cfg_model.dtype(), device=dev)
    if cfg_model.prefix_len:
        rng = np.random.default_rng((pipe.cfg.seed, step, 11))
        batch["prefix_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg_model.prefix_len,
                                 cfg_model.d_model)) * 0.02,
            dtype=cfg_model.dtype(), device=dev)
    return batch

