"""AVNet: the audio-visual fusion trunk (counterpart of ``models/av_net.py``).

Keeps the reference constructor ``AVNet(modal, MoCofile, reqInpLen,
modelargs, vocab_size, enable_logging)`` with ``modelargs = (d_model,
n_heads, n_layers, pe_max_len, fc_hidden_size, dropout)`` and the 5-tuple
input ``(audio [B, 3000, 80], audio_mask, video [B, T, 3, H, W],
video_mask, video_len)``. Eval path only: mel -> frozen Whisper encoder ->
Linear + LN + PE; video -> frozen MoCo frontend -> Linear + LN + PE; both
truncated to the shorter length; gated fusion under the video mask;
``fused + audio + video``; and the frame-wise CTC head in ``forward``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from mocov2_whisper_flamingo_torch.device import resolve_device
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.fusion import GatedCrossModalFusion
from mocov2_whisper_flamingo_torch.models.visual_frontend import MoCoVisualFrontend
from mocov2_whisper_flamingo_torch.models.whisper import (
    WhisperConfig, WhisperEncoder, config_for)


class AVNet(nn.Module):
    def __init__(
        self,
        modal: str,
        MoCofile: str | None,
        reqInpLen: int,
        modelargs: Sequence[Any],
        vocab_size: int,
        enable_logging: bool = False,
        whisper_name: str = "whisper-small",
        precision: L.Precision = L.FP32,
        device: str | torch.device | None = "cuda",
        whisper_config: WhisperConfig | None = None,
    ):
        super().__init__()
        if MoCofile:
            raise NotImplementedError("loading a MoCo checkpoint is not ported yet; "
                                      "load weights through models/convert.py")
        device = resolve_device(device)
        d_model, n_heads, n_layers, pe_max_len, fc_hidden_size, dropout = modelargs
        self.modal = modal
        self.req_inp_len = reqInpLen
        self.enable_logging = enable_logging
        self.d_model = d_model
        self.vocab_size = vocab_size
        self.precision = precision
        self.whisper_config = whisper_config or config_for(whisper_name)
        wd = self.whisper_config.d_model
        self.whisper_encoder = WhisperEncoder(self.whisper_config, precision, device)
        self.audio_proj = L.Linear(wd, d_model, True, precision, device)
        self.audio_ln = L.LayerNorm(d_model, device=device)
        self.visual_frontend = MoCoVisualFrontend(precision, device)
        self.video_proj = L.Linear(MoCoVisualFrontend.OUT_DIM, d_model, True, precision, device)
        self.video_ln = L.LayerNorm(d_model, device=device)
        # n_layers // 2 fusion blocks, as the reference wires it.
        self.fusion = GatedCrossModalFusion(d_model, n_heads, max(n_layers // 2, 1),
                                            dropout, precision, device)
        self.decoder = L.Linear(d_model, vocab_size, True, precision, device)
        pe = L.interleaved_position_encoding(max(pe_max_len, 5000), d_model)
        self.register_buffer("_pe", torch.from_numpy(pe).to(device), persistent=False)

    @torch.no_grad()
    def fused_features(self, input_batch: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """``fused + audio + video`` features ``[B, T', D]`` and the video
        validity ``[B, T']`` they were fused under."""
        audio, _audio_mask, video, _video_mask, video_len = input_batch
        prec = self.precision
        mel = audio.transpose(1, 2) if audio.shape[1] == 3000 else audio
        whisper_out = self.whisper_encoder(mel)
        audio_feat = self.audio_ln(self.audio_proj(prec.cast(whisper_out)))
        audio_feat = audio_feat + prec.cast(self._pe[: audio_feat.shape[1]])

        video_raw = self.visual_frontend(prec.cast(video), video_len)
        video_feat = self.video_ln(self.video_proj(video_raw))
        video_feat = video_feat + prec.cast(self._pe[: video_feat.shape[1]])

        min_len = min(audio_feat.shape[1], video_feat.shape[1])
        audio_feat = audio_feat[:, :min_len]
        video_feat = video_feat[:, :min_len]
        video_len = torch.clamp(video_len.to(audio_feat.device), max=min_len)
        video_valid = (torch.arange(min_len, device=audio_feat.device)[None, :]
                       < video_len[:, None])
        fused = self.fusion(audio_feat, video_feat, video_valid)
        return fused + audio_feat + video_feat, video_valid

    def forward(self, input_batch: tuple) -> torch.Tensor:
        """Frame-wise CTC logits ``[B, T', vocab]`` (fp32)."""
        out, _ = self.fused_features(input_batch)
        return self.decoder(out).float()
