"""AVWhisperNet: AV fusion trunk + Whisper decoder for beam decoding
(counterpart of ``models/av_whisper.py``)::

  mel   -> frozen Whisper encoder --\\
                                      gated fusion -> bridge Linear(d -> d_w)
  video -> frozen MoCo frontend  ----/         |
                                               v
                       Whisper decoder -> greedy / KV-cached beam search

Weights come from the JAX parameter tree through
``models/convert.py::load_jax_params``, or from an HF Whisper state dict
through ``load_whisper_torch``. On the card the encode and the decode loops
replay CUDA graphs (``encode_program``, ``decode_programs``;
``decode/programs.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
from torch import nn

from mocov2_whisper_flamingo_torch.decode.beam import BeamResult
from mocov2_whisper_flamingo_torch.decode.programs import DecodePrograms, EncodeProgram
from mocov2_whisper_flamingo_torch.device import resolve_device
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.av_net import AVNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, whisper_decoder_from_torch)
from mocov2_whisper_flamingo_torch.models.whisper import (
    WhisperConfig, WhisperDecoder, config_for)
from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline


class AVWhisperNet(nn.Module):
    def __init__(
        self,
        modal: str = "audiovisual",
        MoCofile: str | None = None,
        reqInpLen: int = 96,
        modelargs: Sequence = (512, 8, 6, 3000, 2048, 0.1),
        vocab_size: int = 51865,
        whisper_name: str = "whisper-small",
        precision: L.Precision = L.FP32,
        device: str | torch.device | None = "cuda",
        whisper_config: WhisperConfig | None = None,
    ):
        """``whisper_config`` overrides the size named by ``whisper_name``
        (small test configurations); its vocab is replaced by ``vocab_size``."""
        super().__init__()
        device = resolve_device(device)
        cfg = whisper_config or config_for(whisper_name)
        if cfg.vocab_size != vocab_size:
            cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
        self.whisper_config = cfg
        self.trunk = AVNet(modal, MoCofile, reqInpLen, modelargs, vocab_size,
                           precision=precision, device=device, whisper_config=cfg)
        self.bridge = L.Linear(modelargs[0], cfg.d_model, True, precision, device)
        self.decoder = WhisperDecoder(cfg, precision, device)
        # The encode and the decode loops compiled (CUDA graphs on the card,
        # the eager functions on the CPU); the decoder prepared once.
        # The program holds the modules, not the net: a net dropped by its last
        # name frees its graphs' pools without waiting for the collector.
        self.encode_program = EncodeProgram(functools.partial(_encode, self.trunk, self.bridge),
                                            self.trunk, self.bridge)
        self.decode_programs = DecodePrograms(self.decoder)
        self.d_model = modelargs[0]
        self.precision = precision

    def set_attention_backend(self, backend: str) -> None:
        """See ``AVNet.set_attention_backend``; also the decoder's
        teacher-forced forward (its decode step always runs the plain
        attention)."""
        self.trunk.set_attention_backend(backend)
        self.decoder.backend = backend

    def load_whisper_torch(self, state_dict) -> "AVWhisperNet":
        """Install an HF ``WhisperModel`` state dict's encoder and decoder
        (in place)."""
        self.trunk.load_whisper_torch(state_dict)
        load_jax_params(self.decoder, whisper_decoder_from_torch(
            state_dict, self.whisper_config.decoder_layers))
        return self

    @torch.no_grad()
    def encode(self, input_batch: tuple,
               video_resize: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """AV trunk up to the fused features, bridged to the decoder width.
        Returns ``(features [B, T, d_w], valid [B, T])``. ``video_resize``:
        the batch's video is raw frames (uint8 ``[B, T, 3, H, W]``), which
        the encode first puts through ``eval_video_pipeline`` at that size.
        On the card a replay of ``encode_program``'s graph for the batch's
        shapes (captured at their first call), with K1 inside."""
        return self.encode_program(*input_batch, video_resize=video_resize)

    @torch.no_grad()
    def ctc_logits(self, input_batch: tuple) -> torch.Tensor:
        """The trunk's frame-wise linear head."""
        return self.trunk(input_batch)

    def decoder_logits(self, input_batch: tuple, target_ids: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder logits ``[B, L, V]`` (fp32) over the fused
        features: the decoder's causal self-attention and its cross-attention
        under the video validity mask run the flash-attention kernel."""
        features, valid = self.encode(input_batch)
        return self.decoder(target_ids, features, encoder_valid=valid)

    def greedy(self, input_batch: tuple, prefix_ids, max_len: int = 224,
               eos_id: int = 0, logit_rules=None,
               weight_quant: str | None = None,
               cache_quant: str | None = None) -> torch.Tensor:
        """The encode, then ``greedy_decode`` through ``decode_programs``: on
        the card a replay of each one's CUDA graph for the shape, the decode's
        refreshing the prepared decoder from the weights as they stand.
        ``weight_quant="int8"``: the decode step's weights in int8
        (``WhisperDecoder.prepare_decode_params``); ``cache_quant``:
        ``"int8"`` or ``"int8-cross"`` caches (``init_cache``)."""
        features, valid = self.encode(input_batch)
        return self.decode_programs.greedy(features, valid, prefix_ids, max_len, eos_id,
                                           logit_rules=logit_rules, cache_quant=cache_quant,
                                           weight_quant=weight_quant)

    def beam(self, input_batch: tuple, prefix_ids, beam_size: int = 5,
             max_len: int = 224, eos_id: int = 0, length_penalty: float = 1.0,
             logit_rules=None, cache_quant: str | None = None,
             weight_quant: str | None = None, read_windows=None,
             cache_layout: str = "rows") -> BeamResult:
        """The encode, then ``beam_search`` through ``decode_programs`` (as
        ``greedy``)."""
        features, valid = self.encode(input_batch)
        return self.decode_programs.beam(
            features, valid, prefix_ids, beam_size=beam_size, max_len=max_len, eos_id=eos_id,
            length_penalty=length_penalty, logit_rules=logit_rules, cache_quant=cache_quant,
            weight_quant=weight_quant, read_windows=read_windows, cache_layout=cache_layout)


def _encode(trunk: AVNet, bridge: L.Linear, audio, audio_mask, video, video_mask, video_len,
            video_resize: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``AVWhisperNet.encode``'s eager function, the program's plain version."""
    if video_resize is not None:
        video = eval_video_pipeline(video, resize=video_resize)
    out, video_valid = trunk.fused_features((audio, audio_mask, video, video_mask, video_len))
    return bridge(out), video_valid
