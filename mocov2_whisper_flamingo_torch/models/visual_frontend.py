"""MoCo-v2 lip-video frontend (counterpart of ``models/visual_frontend.py``).

Conv3d stem written as a time-unfolded 2D conv, 3x3/2 max-pool, ResNet-50
body over the frames folded into the batch, global average pool, and
features zeroed past ``x_len``. The backbone is frozen, so every BatchNorm
is folded into the conv before it once, by the weight bridge
(``models/convert.py::fold_bn``): each conv here holds a folded fp32 weight
in torch's ``[C_out, C_in, kh, kw]`` layout and a bias. Convs run in
channels-last layout. A bottleneck block's three 1x1 convs (``conv1``,
``conv3`` with the residual add, the downsample) go through
``ops/bottleneck_gemm.py``: on the card in bf16, a hand-written GEMM whose
epilogue adds the bias and the residual and applies the ReLU; otherwise (the
FP32 policy, the CPU, ``torch.export``) its plain version, cuDNN on the card.
The stem and the 3x3 convs go to cuDNN. The JAX package has no kernel on
this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.ops import bottleneck_gemm as BG

# torchvision ResNet-50 stage spec: (blocks, mid_channels, stride).
RESNET50_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
EXPANSION = 4
STEM_DEPTH = 5  # Conv3d kernel depth (time)


class FoldedConv2d(nn.Module):
    """Conv2d with a frozen BatchNorm folded into weight and bias."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, padding: int,
                 precision: L.Precision, device=None):
        super().__init__()
        self.stride, self.padding, self.precision = stride, padding, precision
        self.weight = L.zeros_param((c_out, c_in, k, k), device)
        self.bias = L.zeros_param((c_out,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        prec = self.precision
        w = prec.cast(self.weight).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, prec.cast(self.bias), stride=self.stride,
                        padding=self.padding)

    def gemm(self, x: torch.Tensor, residual: torch.Tensor | None = None, relu: bool = False,
             kernel: bool = False) -> torch.Tensor:
        """A 1x1 conv with its epilogue, ``act(conv(x) + bias (+ residual))``:
        the hand-written GEMM with ``kernel``, else its plain version."""
        fn = BG.bottleneck_gemm if kernel else BG.plain_bottleneck_gemm
        return fn(x, self.precision.cast(self.weight), self.bias, self.stride, residual, relu)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, mid: int, stride: int, precision, device=None):
        super().__init__()
        # The 1x1 convs on their plain version on any tensor, as an exported
        # artifact holds them (tools/export_model.py::as_traced sets it).
        self.plain_gemm = False
        c_out = mid * EXPANSION
        self.conv1 = FoldedConv2d(c_in, mid, 1, 1, 0, precision, device)
        self.conv2 = FoldedConv2d(mid, mid, 3, stride, 1, precision, device)
        self.conv3 = FoldedConv2d(mid, c_out, 1, 1, 0, precision, device)
        self.downsample = (FoldedConv2d(c_in, c_out, 1, stride, 0, precision, device)
                           if stride != 1 or c_in != c_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = not self.plain_gemm and BG.takes_kernel(x)
        h = self.conv1.gemm(x, relu=True, kernel=kernel)
        h = F.relu(self.conv2(h))
        identity = x if self.downsample is None else self.downsample.gemm(x, kernel=kernel)
        return self.conv3.gemm(h, residual=identity, relu=True, kernel=kernel)


class ResNet50Body(nn.Module):
    """ResNet-50 without stem and fc: ``[N, 64, H, W] -> [N, 2048]``."""

    def __init__(self, precision: L.Precision = L.FP32, device=None):
        super().__init__()
        c_in = 64
        for idx, (blocks, mid, stride) in enumerate(RESNET50_STAGES, start=1):
            stage = []
            for i in range(blocks):
                stage.append(Bottleneck(c_in, mid, stride if i == 0 else 1,
                                        precision, device))
                c_in = mid * EXPANSION
            setattr(self, f"layer{idx}", nn.ModuleList(stage))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for idx in range(1, len(RESNET50_STAGES) + 1):
            for block in getattr(self, f"layer{idx}"):
                x = block(x)
        return x.mean(dim=(2, 3))


class MoCoVisualFrontend(nn.Module):
    """``forward(video [B, T, C, H, W], x_len [B]) -> [B, T, 2048]`` with
    padded frames zeroed."""

    OUT_DIM = 2048

    def __init__(self, precision: L.Precision = L.FP32, device=None):
        super().__init__()
        self.precision = precision
        # Conv3d(3->64, k=(5,3,3), s=(1,2,2), p=(2,3,3)) as a 2D conv over the
        # kd-major / c_in-minor concatenation of the 5 neighbouring frames.
        self.stem = FoldedConv2d(STEM_DEPTH * 3, 64, 3, 2, 3, precision, device)
        self.body = ResNet50Body(precision, device)

    def forward(self, video: torch.Tensor, x_len: torch.Tensor) -> torch.Tensor:
        b, t = video.shape[:2]
        x = self.precision.cast(video)
        half = STEM_DEPTH // 2
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, half, half))  # zero frames on both ends
        x5 = torch.cat([xp[:, dt:dt + t] for dt in range(STEM_DEPTH)], dim=2)
        x5 = x5.reshape(b * t, *x5.shape[2:]).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem(x5))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        feats = self.body(x).reshape(b, t, self.OUT_DIM)
        valid = torch.arange(t, device=feats.device)[None, :] < x_len.to(feats.device)[:, None]
        return torch.where(valid[..., None], feats, torch.zeros((), dtype=feats.dtype,
                                                                device=feats.device))
