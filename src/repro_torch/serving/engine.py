"""Batched serving engine: prefill (token-by-token through the cache —
exactly consistent with decode by construction) + sampled generation. An
encoder-decoder's encoder runs once, when the engine is built."""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.decode import decode_step, init_cache
from ..models.transformer import Transformer


class ServeEngine:
    """Serves one model on one device (None = the CUDA card; raises without
    one). The model is moved there if it is not.

    An encoder-decoder (Whisper) encodes `enc_inputs` (B or 1, S_enc,
    d_model) frame embeddings once, here, or zeros of (1, 16, d_model)
    without them, as the JAX package does; every cache then carries the
    encoder output's cross keys and values, the output broadcast over the
    batch where it has one row."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 max_len: int = 512, device: DeviceLike = None,
                 enc_inputs=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.max_len = max_len
        self.enc_out: Optional[torch.Tensor] = None
        if cfg.is_encdec:
            if enc_inputs is None:
                enc_inputs = torch.zeros((1, 16, cfg.d_model),
                                         dtype=cfg.dtype())
            with torch.no_grad():
                self.enc_out = self.model.encode(enc_inputs)

    def new_cache(self, batch: int) -> dict:
        enc = self.enc_out
        if enc is not None and enc.shape[0] != batch:
            enc = enc.expand((batch,) + tuple(enc.shape[1:]))
        return init_cache(self.cfg, batch, self.max_len, self.device,
                          enc_out=enc, model=self.model)

    def prefill(self, tokens, cache=None):
        """tokens: (B, S). Feeds the prompt through the decode path; returns
        the last position's logits (B, padded_vocab) and the cache."""
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        cache = cache or self.new_cache(B)
        logits = None
        for t in range(S):
            logits, cache = decode_step(self.model, tokens[:, t], cache)
        return logits, cache

    def generate(self, prompts, n_tokens: int, temperature: float = 1.0,
                 seed: int = 0) -> torch.Tensor:
        """prompts: (B, S). Returns (B, n_tokens) sampled token ids, drawn
        from a torch.Generator seeded with `seed` (greedy at temperature
        <= 0)."""
        logits, cache = self.prefill(prompts)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = self._sample(logits, gen, temperature)
        out = [tok]
        for _ in range(n_tokens - 1):
            logits, cache = decode_step(self.model, tok, cache)
            tok = self._sample(logits, gen, temperature)
            out.append(tok)
        return torch.stack(out, dim=1)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator,
                temperature: float) -> torch.Tensor:
        # mask padded vocab tail
        tail = torch.arange(logits.shape[-1], device=logits.device) >= \
            self.cfg.vocab_size
        logits = logits.masked_fill(tail, -1e30)
        if temperature <= 0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
