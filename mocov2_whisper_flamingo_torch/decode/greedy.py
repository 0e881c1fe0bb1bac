"""Greedy autoregressive decode with a static KV cache (counterpart of
``decode/greedy.py``): the forced prefix is teacher-forced through the same
loop, and each example stops at its first EOS (later slots stay EOS)."""

from __future__ import annotations

import torch

from mocov2_whisper_flamingo_torch.decode.beam import prefix_tensor


@torch.no_grad()
def greedy_decode(
    decoder,
    encoder_out: torch.Tensor,
    prefix_ids,
    max_len: int = 224,
    eos_id: int = 0,
    encoder_valid: torch.Tensor | None = None,
    logit_rules=None,
    cache_quant: str | None = None,
) -> torch.Tensor:
    """Token ids ``[B, max_len]`` (prefix included, EOS-padded).
    ``decoder`` is a prepared ``WhisperDecoder``; ``prefix_ids``: ints, or a
    long tensor on the encoder output's device. ``logit_rules``: an
    optional ``decode.logit_rules.LogitRules`` applied to the step's logits
    before the argmax (masking and forcing commute with it, so one rules
    object serves greedy and beam decoding). ``cache_quant``: ``"int8"`` or
    ``"int8-cross"`` (``init_cache``)."""
    dev = encoder_out.device
    b = encoder_out.shape[0]
    prefix = prefix_tensor(prefix_ids, dev)
    n_prefix = int(prefix.shape[0])

    cache = decoder.init_cache(encoder_out, max_len=max_len, quant=cache_quant)
    tokens = torch.full((b, max_len), eos_id, dtype=torch.long, device=dev)
    tokens[:, :n_prefix] = prefix
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(max_len - 1):
        logits, cache = decoder.decode_step(tokens[:, i:i + 1], cache, i, encoder_valid)
        if i + 1 < n_prefix:  # within the forced prefix the next token is given
            continue
        if logit_rules is not None:
            logits = logit_rules(logits, tokens, i + 1, n_prefix)
        nxt = torch.where(done, eos_id, torch.argmax(logits, dim=-1))
        done = done | (nxt == eos_id)
        tokens[:, i + 1] = nxt
    return tokens
