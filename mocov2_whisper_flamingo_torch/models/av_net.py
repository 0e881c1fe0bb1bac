"""AVNet: the audio-visual fusion trunk (counterpart of ``models/av_net.py``).

Keeps the reference constructor ``AVNet(modal, MoCofile, reqInpLen,
modelargs, vocab_size, enable_logging)`` with ``modelargs = (d_model,
n_heads, n_layers, pe_max_len, fc_hidden_size, dropout)`` and the 5-tuple
input ``(audio [B, 3000, 80], audio_mask, video [B, T, 3, H, W],
video_mask, video_len)``: mel -> frozen Whisper encoder -> Linear + LN + PE;
video -> frozen MoCo frontend -> Linear + LN + PE; both truncated to the
shorter length; gated fusion under the video mask; ``fused + audio +
video``; and the frame-wise CTC head in ``forward``.

The Whisper encoder and the MoCo frontend are frozen: they run under
``torch.no_grad()`` and their parameters never require a gradient. Every
other parameter is trainable (``trainable_parameters``).
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
        remat: bool = False,
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
                                            dropout, precision, device, remat=remat)
        self.decoder = L.Linear(d_model, vocab_size, True, precision, device)
        pe = L.interleaved_position_encoding(max(pe_max_len, 5000), d_model)
        self.register_buffer("_pe", torch.from_numpy(pe).to(device), persistent=False)
        for _, param in self.trainable_parameters():
            param.requires_grad_(True)

    # -- params ---------------------------------------------------------------

    FROZEN = ("whisper_encoder", "visual_frontend")

    @classmethod
    def trainable_filter(cls, name: str) -> bool:
        """True for the name of a trainable parameter: everything except the
        frozen Whisper encoder and MoCo frontend."""
        return name.split(".")[0] not in cls.FROZEN

    def trainable_parameters(self) -> list[tuple[str, nn.Parameter]]:
        """``(name, parameter)`` of every trainable parameter, in module order."""
        return [(n, p) for n, p in self.named_parameters() if self.trainable_filter(n)]

    def cast_frozen_params(self, dtype: torch.dtype = torch.bfloat16) -> "AVNet":
        """Store the frozen trees (Whisper encoder, MoCo frontend) in
        ``dtype``. They are never differentiated, and under the BF16 policy
        their matmul and conv operands are rounded to bf16 at every use
        anyway, so bf16 storage makes that cast a no-op and halves the bytes
        each step reads; only the fp32 LayerNorm islands then see rounded
        weights. Trainable parameters stay as they are. In place."""
        for name in self.FROZEN:
            for param in getattr(self, name).parameters():
                param.data = param.data.to(dtype)
        return self

    def quantize_frozen_params(self) -> "AVNet":
        raise NotImplementedError("int8 storage of the frozen Whisper encoder belongs to the "
                                  "int8 slice of the port and is not ported yet")

    # -- forward ----------------------------------------------------------------

    def frozen_features(self, input_batch: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """The frozen part of the forward, without a graph: Whisper encoder
        output ``[B, 1500, d_w]`` and MoCo features ``[B, T, 2048]``."""
        audio, _audio_mask, video, _video_mask, video_len = input_batch
        mel = audio.transpose(1, 2) if audio.shape[1] == 3000 and audio.shape[2] == 80 else audio
        with torch.no_grad():
            whisper_out = self.whisper_encoder(mel)
            video_raw = self.visual_frontend(self.precision.cast(video), video_len)
        return whisper_out, video_raw

    def fuse(self, whisper_out: torch.Tensor, video_raw: torch.Tensor, video_len: torch.Tensor,
             train: bool = False, generator: torch.Generator | None = None,
             return_gates: bool = False) -> dict:
        """The trainable part up to the head: ``features`` = ``fused + audio +
        video`` ``[B, T', D]``, the ``audio`` stream, the ``video_valid``
        mask ``[B, T']`` it was fused under, and ``gates`` when asked."""
        prec = self.precision
        audio_feat = self.audio_ln(self.audio_proj(prec.cast(whisper_out)))
        audio_feat = audio_feat + prec.cast(self._pe[: audio_feat.shape[1]])
        video_feat = self.video_ln(self.video_proj(video_raw))
        video_feat = video_feat + prec.cast(self._pe[: video_feat.shape[1]])

        min_len = min(audio_feat.shape[1], video_feat.shape[1])
        audio_feat = audio_feat[:, :min_len]
        video_feat = video_feat[:, :min_len]
        video_len = torch.clamp(video_len.to(audio_feat.device), max=min_len)
        video_valid = (torch.arange(min_len, device=audio_feat.device)[None, :]
                       < video_len[:, None])
        fused = self.fusion(audio_feat, video_feat, video_valid, train=train,
                            generator=generator, return_gates=return_gates)
        gates = None
        if return_gates:
            fused, gates = fused
        return {"features": fused + audio_feat + video_feat, "audio": audio_feat,
                "video_valid": video_valid, "gates": gates}

    def fused_features(self, input_batch: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode ``fused + audio + video`` features ``[B, T', D]`` and the
        video validity ``[B, T']`` they were fused under."""
        out = self.fuse(*self.frozen_features(input_batch), input_batch[4])
        return out["features"], out["video_valid"]

    def forward(self, input_batch: tuple, train: bool = False,
                generator: torch.Generator | None = None, return_gates: bool = False):
        """Frame-wise CTC logits ``[B, T', vocab]`` (fp32); with
        ``return_gates`` also ``tanh`` of every fusion gate. ``train`` with a
        ``generator`` on the model's device turns the fusion dropout on."""
        out = self.fuse(*self.frozen_features(input_batch), input_batch[4], train=train,
                        generator=generator, return_gates=return_gates)
        logits = self.decoder(out["features"]).float()
        return (logits, out["gates"]) if return_gates else logits

    def forward_features(self, input_batch: tuple, train: bool = False,
                         generator: torch.Generator | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pre-head fused features and the audio-stream features, both
        ``[B, T', D]`` (the surface of the feature-alignment objective)."""
        out = self.fuse(*self.frozen_features(input_batch), input_batch[4], train=train,
                        generator=generator)
        return out["features"], out["audio"]

