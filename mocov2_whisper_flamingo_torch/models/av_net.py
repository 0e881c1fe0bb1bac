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

Pretrained weights: ``MoCofile`` (or ``load_moco``) installs a MoCo v2
checkpoint's ResNet-50 layers into the frontend, and ``load_whisper_torch``
an HF Whisper state dict into the encoder.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Sequence

import torch
from torch import nn

from mocov2_whisper_flamingo_torch.device import resolve_device
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, resnet50_from_moco, whisper_encoder_from_torch)
from mocov2_whisper_flamingo_torch.models.fusion import GatedCrossModalFusion
from mocov2_whisper_flamingo_torch.models.visual_frontend import MoCoVisualFrontend
from mocov2_whisper_flamingo_torch.models.whisper import (
    WhisperConfig, WhisperEncoder, config_for)
from mocov2_whisper_flamingo_torch.utils.profiling import span

logger = logging.getLogger(__name__)


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
        """``MoCofile``: a MoCo v2 checkpoint loaded into the frontend when
        the file exists (a missing file is skipped with a warning, as the
        JAX ``init`` skips it); the other weights start at zero until a
        tree or state dict is loaded."""
        super().__init__()
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
        self.moco_report: dict | None = None
        if MoCofile:
            self.load_moco(MoCofile)

    # -- params ---------------------------------------------------------------

    def load_moco(self, path: str) -> dict | None:
        """Install the query encoder's layer1-4 of the MoCo v2 checkpoint at
        ``path`` into the frozen frontend, BN folded
        (``convert.resnet50_from_moco``); blocks the checkpoint lacks keep
        their weights. Returns the conversion report, or None (with a
        warning) when the file does not exist."""
        if not os.path.exists(path):
            logger.warning("MoCo checkpoint %s not found: the frontend keeps its weights", path)
            return None
        try:
            checkpoint = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise RuntimeError(
                f"{path} cannot be read with torch.load(weights_only=True): it holds objects "
                "other than tensors and containers; save its state dict alone") from e
        weights, report = resnet50_from_moco(checkpoint)
        body = self.visual_frontend.body.state_dict()
        with torch.no_grad():
            for name, value in weights.items():
                body[name].copy_(torch.from_numpy(value))
        logger.info("MoCo v2 checkpoint: %d blocks loaded, %d skipped",
                    report["blocks_loaded"], len(report["skipped"]))
        self.moco_report = report
        return report

    def load_whisper_torch(self, state_dict) -> "AVNet":
        """Install an HF ``WhisperModel`` state dict's encoder into the frozen
        Whisper encoder (in place)."""
        load_jax_params(self.whisper_encoder, whisper_encoder_from_torch(
            state_dict, self.whisper_config.encoder_layers))
        return self

    def tensor_parallel_units(self) -> list:
        """The CTC head, split over the vocabulary and gathered whole
        (``parallel/mesh.py``); it stays whole where the vocabulary does not
        divide by the model axis."""
        return [(None, [(self.decoder, "gather")])]

    def set_attention_backend(self, backend: str) -> None:
        """``"flash"`` (the default: the hand-written kernel on CUDA tensors)
        or ``"plain"`` for every attention of the encoder and the fusion.
        Under tensor parallelism each rank calls the kernel on its own heads,
        so no backend needs a mesh of its own."""
        if backend not in ("flash", "plain"):
            raise ValueError(f"unknown attention backend {backend!r}; expected 'flash' or 'plain'")
        for layer in (*self.whisper_encoder.layers, *self.fusion.layers):
            layer.backend = backend

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
        weights. Every floating parameter is cast, the int8 scales of
        ``quantize_frozen_params`` included (the JAX package casts every
        floating leaf of the frozen trees); int8 weights stay int8.
        Trainable parameters stay as they are. In place."""
        for name in self.FROZEN:
            for param in getattr(self, name).parameters():
                if param.is_floating_point():
                    param.data = param.data.to(dtype)
        return self

    def quantize_frozen_params(self) -> "AVNet":
        """Weight-only int8 of the frozen Whisper encoder's q/k/v/out and
        fc1/fc2 (``WhisperEncoder.quantize_encoder_params``): stored and read
        each step at a quarter of their fp32 bytes. The quantized weights and
        their scales are parameters (never trainable), so ``state_dict`` and
        checkpoints hold them and ``cast_frozen_params`` reaches the scales.
        Call it before ``cast_frozen_params``, on fp32 weights. In place."""
        self.whisper_encoder.quantize_encoder_params()
        return self

    # -- forward ----------------------------------------------------------------

    def frozen_features(self, input_batch: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """The frozen part of the forward, without a graph: Whisper encoder
        output ``[B, 1500, d_w]`` and MoCo features ``[B, T, 2048]``, in the
        spans ``frozen_audio`` and ``frozen_video``."""
        audio, _audio_mask, video, _video_mask, video_len = input_batch
        mel = audio.transpose(1, 2) if audio.shape[1] == 3000 and audio.shape[2] == 80 else audio
        with torch.no_grad():
            with span("frozen_audio", mel.device):
                whisper_out = self.whisper_encoder(mel)
            with span("frozen_video", video.device):
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

        # Both streams cut to the shorter. Written so that torch.export can
        # keep the video length symbolic (tools/export_model.py): the
        # comparison is decided by the length's range, where min() is not,
        # and the audio stream is gathered, where a slice's contiguity
        # would depend on whether the lengths are equal.
        t_a, t_v = audio_feat.shape[1], video_feat.shape[1]
        min_len = t_v if t_v <= t_a else t_a
        frames = torch.arange(min_len, device=audio_feat.device)
        audio_feat = audio_feat.index_select(1, frames)
        video_feat = video_feat[:, :min_len]
        video_len = torch.clamp(video_len.to(audio_feat.device), max=min_len)
        video_valid = frames[None, :] < video_len[:, None]
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
        ``generator`` on the model's device turns the fusion dropout on.
        After the frozen part, the span ``trainable_forward``: the fusion,
        the head and the logits' cast."""
        whisper_out, video_raw = self.frozen_features(input_batch)
        with span("trainable_forward", whisper_out.device):
            out = self.fuse(whisper_out, video_raw, input_batch[4], train=train,
                            generator=generator, return_gates=return_gates)
            logits = self.decoder(out["features"]).float()
        return (logits, out["gates"]) if return_gates else logits

    def forward_features(self, input_batch: tuple, train: bool = False,
                         generator: torch.Generator | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pre-head fused features and the audio-stream features, both
        ``[B, T', D]`` (the surface of the feature-alignment objective);
        the fusion in the span ``trainable_forward``."""
        whisper_out, video_raw = self.frozen_features(input_batch)
        with span("trainable_forward", whisper_out.device):
            out = self.fuse(whisper_out, video_raw, input_batch[4], train=train,
                            generator=generator)
        return out["features"], out["audio"]

