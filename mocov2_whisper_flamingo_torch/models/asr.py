"""Audio-only Whisper ASR pipeline (counterpart of ``models/asr.py``)::

  wav -> log-mel (``ops/mel.py``) -> Whisper encoder -> KV-cached greedy or
  beam decode -> token ids

The encoder's self-attention runs the flash-attention kernel. Weights come
from the JAX-layout tree through ``models/convert.py::load_jax_params``, or
from an HF Whisper state dict through ``load_whisper_torch``. Long-form
transcription (``transcribe``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mocov2_whisper_flamingo_torch.decode.beam import beam_search
from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode
from mocov2_whisper_flamingo_torch.decode.language import detect_language
from mocov2_whisper_flamingo_torch.device import resolve_device
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, whisper_decoder_from_torch, whisper_encoder_from_torch)
from mocov2_whisper_flamingo_torch.models.whisper import (
    WhisperConfig, WhisperDecoder, WhisperEncoder, config_for)
from mocov2_whisper_flamingo_torch.ops.mel import whisper_log_mel


class WhisperASR(nn.Module):
    """Encoder-decoder ASR with an end-to-end ``transcribe_tokens``."""

    def __init__(self, whisper_name: str = "whisper-base",
                 precision: L.Precision = L.FP32,
                 device: str | torch.device | None = "cuda",
                 config: WhisperConfig | None = None):
        """``config`` overrides the size named by ``whisper_name`` (small
        test configurations)."""
        super().__init__()
        self.device = resolve_device(device)
        self.config = config or config_for(whisper_name)
        self.precision = precision
        self.encoder = WhisperEncoder(self.config, precision, self.device)
        self.decoder = WhisperDecoder(self.config, precision, self.device)

    def load_whisper_torch(self, state_dict) -> "WhisperASR":
        """Install an HF ``WhisperModel`` / ``WhisperForConditionalGeneration``
        state dict (in place)."""
        cfg = self.config
        return load_jax_params(self, {
            "encoder": whisper_encoder_from_torch(state_dict, cfg.encoder_layers),
            "decoder": whisper_decoder_from_torch(state_dict, cfg.decoder_layers)})

    def features(self, audio, pad_to: int | None = 480_000) -> torch.Tensor:
        """wav ``[T]`` or ``[B, T]`` (array or tensor) -> log-mel ``[B, 80,
        frames]`` on the model's device."""
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        mel = whisper_log_mel(audio, pad_to=pad_to)
        return mel[None] if mel.ndim == 2 else mel

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    @torch.no_grad()
    def transcribe_tokens(
        self,
        audio,
        prefix_ids: Sequence[int],
        beam_size: int = 1,
        max_len: int = 224,
        eos_id: int = 50257,
        pad_to: int | None = 480_000,
        logit_rules=None,
        weight_quant: str | None = None,
    ) -> torch.Tensor:
        """wav -> token ids ``[B, max_len]`` (the best beam when ``beam_size
        > 1``). ``logit_rules``: an optional ``decode.logit_rules.LogitRules``.
        The decoder's weights are fused and cast to the compute dtype once
        per call, not per token step. ``weight_quant`` is not ported yet."""
        enc = self.encode(self.features(audio, pad_to=pad_to))
        decoder = self.decoder.prepare_decode_params(weight_quant)
        if beam_size <= 1:
            return greedy_decode(decoder, enc, prefix_ids, max_len, eos_id,
                                 logit_rules=logit_rules)
        res = beam_search(decoder, enc, prefix_ids, beam_size=beam_size, max_len=max_len,
                          eos_id=eos_id, logit_rules=logit_rules)
        return res.sequences[:, 0]

    @torch.no_grad()
    def detect_language(self, audio, sot_id: int, language_token_ids: Sequence[int],
                        pad_to: int | None = 480_000,
                        decoder: WhisperDecoder | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Spoken-language id from the first 30 s: ``([B]`` best language
        token id, ``[B, n_lang]`` probabilities in the order of
        ``language_token_ids``). ``decoder``: an already prepared decoder to
        reuse in place of a second cast."""
        enc = self.encode(self.features(audio, pad_to=pad_to))
        if decoder is None:
            decoder = self.decoder.prepare_decode_params()
        return detect_language(decoder, enc, sot_id, language_token_ids)

    def transcribe(self, *args, **kwargs):
        raise NotImplementedError(
            "long-form transcription (window loop, temperature fallback, streaming decode, "
            "word times) is not ported yet: ROADMAP.md Queue 1 item 10 (decode extras); "
            "use transcribe_tokens for clips of up to 30 s")
