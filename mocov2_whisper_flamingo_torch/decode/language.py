"""Spoken-language identification from the encoder output (counterpart of
``decode/language.py``): feed the decoder only the start-of-transcript token,
keep the logits of the language tokens and take their softmax. The decoder's
first prediction after SOT is the language token, so that restricted
distribution is the language posterior. One ``decode_step``, batched."""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def detect_language(
    decoder,
    encoder_out: torch.Tensor,
    sot_id: int,
    language_token_ids: Sequence[int],
    encoder_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(best [B], probs [B, n_languages])``: the most likely language
    token id per example and the softmax over the given language tokens
    only, columns in the order of ``language_token_ids``. ``decoder`` is a
    prepared ``WhisperDecoder``; the caller maps token ids to language codes."""
    dev = encoder_out.device
    lang_ids = torch.as_tensor(list(language_token_ids), dtype=torch.long, device=dev)
    if lang_ids.ndim != 1 or lang_ids.shape[0] == 0:
        raise ValueError("language_token_ids must be a non-empty 1-D list")
    b = encoder_out.shape[0]
    cache = decoder.init_cache(encoder_out, max_len=2)
    sot = torch.full((b, 1), sot_id, dtype=torch.long, device=dev)
    logits, _ = decoder.decode_step(sot, cache, 0, encoder_valid)
    lang_logits = logits.float()[:, lang_ids]
    probs = torch.softmax(lang_logits, dim=-1)
    return lang_ids[lang_logits.argmax(dim=-1)], probs
