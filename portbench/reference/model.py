"""Plain PyTorch reference of the audio-visual Whisper model, in float32.

It follows the model's layer equations, written again from its description:

- the video pipeline: raw uint8 frames, bilinear resize (half-pixel
  centres, antialiased), ``/255`` and ImageNet normalisation;
- the MoCo v2 frontend: a Conv3d stem (5 frames deep, 3x3 spatial, stride
  (1, 2, 2), padding (2, 3, 3), BatchNorm folded into the weights, as a
  frozen network holds it), ReLU, 3x3/2 max-pool, the ResNet-50 body, the
  spatial mean, zeros past each clip's frame count;
- the Whisper encoder: two GELU convolutions (the second of stride 2),
  learned positions, pre-LN layers (the key projection has no bias);
- the trunk: each stream projected, layer-normed and given interleaved
  sinusoid positions, both cut to the shorter; the Flamingo fusion blocks
  (cross-attention of the audio stream's queries over the video stream under
  the video's frame mask, each residual branch scaled by ``tanh`` of its
  gate); ``fused + audio + video``; the frame-wise vocabulary head;
- the bridge to the decoder's width and the Whisper decoder (causal
  self-attention, cross-attention under the frame mask, tied vocabulary
  projection).

Every product goes through a ``Precision``: exact float32 (TF32 off) for the
reference, or, for the control, the next precision below the bfloat16 the
configuration states: operands and results rounded to float8 (e4m3, one
scale per tensor) where the bfloat16 program rounds to bfloat16.
Nothing here imports the program; large batches go through in blocks.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

NEG_INF = -1e30
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def exact_float32() -> None:
    """Float32 products in full float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale per tensor (its largest
    magnitude to 448), back in float32."""
    if not x.numel():
        return x
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


# Ops that the bfloat16 program keeps in float32 (LayerNorm and softmax
# islands, the losses), forward and backward: their results are not rounded.
FP32_ISLANDS = frozenset((
    "native_layer_norm", "native_layer_norm_backward", "_softmax", "_softmax_backward_data",
    "_log_softmax", "_log_softmax_backward_data", "_ctc_loss", "_ctc_loss_backward",
    "_cudnn_ctc_loss"))


class _RoundResults(TorchDispatchMode):
    """Every float32 result of an op (forward, and backward where autograd
    runs under the mode) rounded to float8, as a bfloat16 program rounds
    each result to bfloat16; views, in-place ops and ``FP32_ISLANDS`` as
    they are."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.is_mutable or \
                func._overloadpacket.__name__ in FP32_ISLANDS:
            return out
        return tree_map(lambda t: round_fp8(t) if isinstance(t, torch.Tensor)
                        and t.dtype == torch.float32 else t, out)


class Precision:
    """``fp32``: every product and result in float32. ``fp8``, the control:
    the computation the bfloat16 program does, one step down: each operand
    of a product and each result of an op rounded to float8 e4m3 (one scale
    per tensor), with float32 accumulation inside each op and the program's
    float32 islands (LayerNorm, softmax, the losses) kept."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        # the rounded value forward; the gradient passes as it is (a float8
        # cast under autograd would flush small gradients to zero)
        return x + (round_fp8(x.detach()) - x.detach())

    def rounding(self):
        """The context in which results are rounded (none in fp32)."""
        return contextlib.nullcontext() if self.name == "fp32" else _RoundResults()


FP32 = Precision("fp32")


def linear(P: Precision, W: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    y = P.q(x) @ P.q(W[f"{name}.kernel"])
    bias = W.get(f"{name}.bias")
    return y if bias is None else y + bias


def layer_norm(W: dict, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.scale"], W[f"{name}.bias"], eps)


def attention(P: Precision, q, k, v, key_valid=None, causal: bool = False) -> torch.Tensor:
    """Softmax attention over ``[B, T, H, Dh]``; ``key_valid [B, Tk]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", P.q(q), P.q(k)) * q.shape[-1] ** -0.5
    if key_valid is not None:
        s = s.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.arange(tk, device=q.device)[None, :] <= \
            torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        s = s.masked_fill(~keep, NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", P.q(torch.softmax(s, dim=-1)), P.q(v))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.reshape(*x.shape[:2], h, x.shape[-1] // h)


def _merge(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:2], -1)


# -- video ------------------------------------------------------------------------------

def video_pipeline(raw: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 ``[..., 3, H, W]`` -> normalised float ``[..., 3, size, size]``."""
    lead = raw.shape[:-3]
    x = F.interpolate(raw.reshape(-1, *raw.shape[-3:]).float(), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    mean = torch.tensor(IMAGENET_MEAN, device=raw.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=raw.device)[:, None, None]
    return ((x / 255.0 - mean) / std).reshape(*lead, 3, size, size)


def _conv2d(P, W, name, x, stride, pad):
    return F.conv2d(P.q(x), P.q(W[f"{name}.weight"]), W[f"{name}.bias"], stride=stride,
                    padding=pad)


def _bottleneck(P, W, p, x, stride):
    h = F.relu(_conv2d(P, W, f"{p}.conv1", x, 1, 0))
    h = F.relu(_conv2d(P, W, f"{p}.conv2", h, stride, 1))
    h = _conv2d(P, W, f"{p}.conv3", h, 1, 0)
    idt = _conv2d(P, W, f"{p}.downsample", x, stride, 0) if f"{p}.downsample.weight" in W else x
    return F.relu(h + idt)


STAGES = ((3, 1), (4, 2), (6, 2), (3, 2))  # blocks, first stride


def _rounded(fn):
    """Run ``fn(P, ...)`` inside ``P.rounding()``."""
    @functools.wraps(fn)
    def run(P, *args, **kwargs):
        with P.rounding():
            return fn(P, *args, **kwargs)

    return run


@torch.no_grad()
@_rounded
def frontend(P: Precision, W: dict, video: torch.Tensor, lengths: torch.Tensor,
             prefix: str = "trunk.visual_frontend", block: int = 800) -> torch.Tensor:
    """``video [B, T, 3, H, W]`` (normalised) -> ``[B, T, 2048]``, zero past
    each clip's length. The stem's 5-frame depth is laid out kd-major over
    the channels, frames past either end are zeros."""
    b, t = video.shape[:2]
    padded = F.pad(video, (0, 0, 0, 0, 0, 0, 2, 2))
    stacked = torch.cat([padded[:, i:i + t] for i in range(5)], dim=2).reshape(b * t, 15,
                                                                                *video.shape[-2:])
    feats = []
    for start in range(0, b * t, block):
        x = F.relu(_conv2d(P, W, f"{prefix}.stem", stacked[start:start + block], 2, 3))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for li, (blocks, stride) in enumerate(STAGES, start=1):
            for i in range(blocks):
                x = _bottleneck(P, W, f"{prefix}.body.layer{li}.{i}", x, stride if i == 0 else 1)
        feats.append(x.mean(dim=(2, 3)))
    out = torch.cat(feats).reshape(b, t, -1)
    valid = torch.arange(t, device=video.device)[None, :] < lengths[:, None]
    return out * valid[..., None]


# -- Whisper encoder ---------------------------------------------------------------------

@torch.no_grad()
@_rounded
def whisper_encoder(P: Precision, W: dict, w: dict, mel: torch.Tensor,
                    prefix: str = "trunk.whisper_encoder", block: int = 2) -> torch.Tensor:
    """``mel [B, 3000, 80]`` -> ``[B, 1500, d]``."""
    outs = []
    for start in range(0, mel.shape[0], block):
        x = mel[start:start + block].transpose(1, 2)
        x = F.gelu(F.conv1d(P.q(x), P.q(W[f"{prefix}.conv1.weight"]), W[f"{prefix}.conv1.bias"],
                            padding=1))
        x = F.gelu(F.conv1d(P.q(x), P.q(W[f"{prefix}.conv2.weight"]), W[f"{prefix}.conv2.bias"],
                            stride=2, padding=1))
        x = x.transpose(1, 2) + W[f"{prefix}.pos_embed"][: x.shape[-1]]
        for i in range(w["encoder_layers"]):
            lp = f"{prefix}.layers.{i}"
            y = layer_norm(W, f"{lp}.self_attn_ln", x)
            a = attention(P, *(_heads(linear(P, W, f"{lp}.self_attn.{n}", y), w["n_heads"])
                               for n in "qkv"))
            x = x + linear(P, W, f"{lp}.self_attn.out", _merge(a))
            y = layer_norm(W, f"{lp}.mlp_ln", x)
            x = x + linear(P, W, f"{lp}.mlp.fc2", F.gelu(linear(P, W, f"{lp}.mlp.fc1", y)))
        outs.append(layer_norm(W, f"{prefix}.ln_post", x))
    return torch.cat(outs)


# -- trunk -------------------------------------------------------------------------------

def interleaved_positions(length: int, dim: int, device) -> torch.Tensor:
    """sin on the even features, cos on the odd, wavelengths from 2pi to
    10000 * 2pi."""
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    freq = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64) * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * freq)
    pe[:, 1::2] = torch.cos(pos * freq)
    return pe.to(torch.float32).to(device)


@_rounded
def trunk(P: Precision, W: dict, cfg: dict, whisper_out: torch.Tensor, video_feats: torch.Tensor,
          video_len: torch.Tensor) -> dict:
    """The trainable trunk up to the head: ``features [B, T', D]`` and the
    ``video_valid`` mask they were fused under."""
    m = cfg["model"]
    d, heads = m["d_model"], m["n_heads"]
    pe = interleaved_positions(max(m["pe_max_len"], 5000), d, whisper_out.device)
    audio = layer_norm(W, "trunk.audio_ln", linear(P, W, "trunk.audio_proj", whisper_out))
    audio = audio + pe[: audio.shape[1]]
    video = layer_norm(W, "trunk.video_ln", linear(P, W, "trunk.video_proj", video_feats))
    video = video + pe[: video.shape[1]]
    t = min(audio.shape[1], video.shape[1])
    audio, video = audio[:, :t], video[:, :t]
    valid = torch.arange(t, device=audio.device)[None, :] < video_len.clamp(max=t)[:, None]
    x = linear(P, W, "trunk.fusion.audio_proj", audio)
    xa = linear(P, W, "trunk.fusion.video_proj", video)
    for i in range(max(m["n_layers"] // 2, 1)):
        lp = f"trunk.fusion.layers.{i}"
        q = _heads(linear(P, W, f"{lp}.attn.q", layer_norm(W, f"{lp}.attn_ln", x)), heads)
        k = _heads(linear(P, W, f"{lp}.attn.k", xa), heads)
        v = _heads(linear(P, W, f"{lp}.attn.v", xa), heads)
        a = linear(P, W, f"{lp}.attn.out", _merge(attention(P, q, k, v, valid)))
        x = x + a * torch.tanh(W[f"{lp}.attn_gate"])
        ff = linear(P, W, f"{lp}.ff2", F.gelu(linear(P, W, f"{lp}.ff1",
                                                      layer_norm(W, f"{lp}.ff_ln", x))))
        x = x + ff * torch.tanh(W[f"{lp}.ff_gate"])
    fused = layer_norm(W, "trunk.fusion.ln_post", x)
    return {"features": fused + audio + video, "valid": valid}


@_rounded
def ctc_logits(P: Precision, W: dict, features: torch.Tensor) -> torch.Tensor:
    return linear(P, W, "trunk.decoder", features)


# -- serving -----------------------------------------------------------------------------

@torch.no_grad()
def encode(P: Precision, W: dict, cfg: dict, mel: torch.Tensor, raw: torch.Tensor,
           video_len: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One or more clips -> (decoder-width features ``[B, T', d_w]``, frame
    validity ``[B, T']``)."""
    whisper_out = whisper_encoder(P, W, cfg["whisper"], mel)
    feats = frontend(P, W, video_pipeline(raw, size), video_len)
    out = trunk(P, W, cfg, whisper_out, feats, video_len)
    with P.rounding():
        return linear(P, W, "bridge", out["features"]), out["valid"]


@torch.no_grad()
def decoder_logits(P: Precision, W: dict, w: dict, tokens: torch.Tensor, enc: torch.Tensor,
                   enc_valid: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits ``[B, L, V]`` of ``tokens [B, L]``: position i
    scores the token at i + 1."""
    with P.rounding():
        h = w["n_heads"]
        x = W["decoder.embed_tokens.embedding"][tokens] + W["decoder.pos_embed"][: tokens.shape[1]]
        for i in range(w["decoder_layers"]):
            lp = f"decoder.layers.{i}"
            y = layer_norm(W, f"{lp}.self_attn_ln", x)
            a = attention(P, *(_heads(linear(P, W, f"{lp}.self_attn.{n}", y), h) for n in "qkv"),
                          causal=True)
            x = x + linear(P, W, f"{lp}.self_attn.out", _merge(a))
            y = layer_norm(W, f"{lp}.cross_attn_ln", x)
            q = _heads(linear(P, W, f"{lp}.cross_attn.q", y), h)
            k = _heads(linear(P, W, f"{lp}.cross_attn.k", enc), h)
            v = _heads(linear(P, W, f"{lp}.cross_attn.v", enc), h)
            x = x + linear(P, W, f"{lp}.cross_attn.out", _merge(attention(P, q, k, v, enc_valid)))
            y = layer_norm(W, f"{lp}.mlp_ln", x)
            x = x + linear(P, W, f"{lp}.mlp.fc2", F.gelu(linear(P, W, f"{lp}.mlp.fc1", y)))
    x = layer_norm(W, "decoder.ln_post", x)
    return P.q(x) @ P.q(W["decoder.embed_tokens.embedding"]).T
