"""Weight bridge from the JAX package's parameter tree to the port.

The JAX models keep their parameters as nested dicts (and lists) of arrays;
given that tree as numpy arrays, ``from_jax_params`` returns the port's
``state_dict`` (numpy, fp32 or int8) and ``load_jax_params`` installs it. Names
follow the tree (``trunk.fusion.layers.0.attn.q.kernel``); layouts change
only where the port applies torch ops:

- linear kernels stay ``[d_in, d_out]``; biases, LayerNorm, embeddings,
  ``pos_embed`` and the scalar fusion gates are copied as they are;
- the int8 leaves of a quantized tree (``kernel_q``, ``embedding_q``) stay
  int8, bit for bit, and their ``scale`` leaves are copied as fp32: they
  load into a module quantized the same way (``layers.QuantLinear`` /
  ``QuantEmbedding``, e.g. ``WhisperDecoder.prepare_decode_params("int8")``);
- conv1d kernels ``WIO`` become ``[O, I, W]``;
- every frozen BatchNorm of the MoCo frontend is folded into the conv before
  it (``fold_bn``): ResNet ``HWIO`` kernels become folded ``OIHW`` weights
  plus a bias, and the ``DHWIO`` stem becomes the folded 2D kernel of its
  time-unfolded form (kd-major, c_in-minor input channels).

``random_jax_params`` (``AVWhisperNet``), ``random_avnet_params`` (``AVNet``)
and ``random_asr_params`` (``WhisperASR``) make a tree of the JAX layout from a
seed with numpy, for runs that need full-size random weights without JAX.

``whisper_encoder_from_torch`` / ``whisper_decoder_from_torch`` turn an HF
``WhisperModel`` state dict into the same JAX-layout numpy trees (the port's
own copy of the JAX package's converters), so one tree loads into the JAX
models and, through ``load_jax_params``, into the port's.
``resnet50_from_moco`` turns a MoCo v2 checkpoint into the folded weights of
the frontend's ResNet-50 body.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.visual_frontend import EXPANSION, RESNET50_STAGES


def fold_bn(kernel: np.ndarray, bn: dict, eps: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """Fold a frozen BatchNorm into the conv kernel before it (fp32; the
    output channel is the kernel's last axis). Returns (kernel, bias)."""
    f32 = lambda x: np.asarray(x, np.float32)
    inv = (1.0 / np.sqrt(f32(bn["var"]) + np.float32(eps))).astype(np.float32)
    s = f32(bn["scale"]) * inv
    b = f32(bn["bias"]) - f32(bn["mean"]) * s
    return f32(kernel) * s, b


def _hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _bottleneck(block: dict, prefix: str, out: dict) -> None:
    for i in (1, 2, 3):
        w, b = fold_bn(block[f"conv{i}"]["kernel"], block[f"bn{i}"])
        out[f"{prefix}conv{i}.weight"], out[f"{prefix}conv{i}.bias"] = _hwio_to_oihw(w), b
    if "downsample" in block:
        ds = block["downsample"]
        w, b = fold_bn(ds["conv"]["kernel"], ds["bn"])
        out[f"{prefix}downsample.weight"], out[f"{prefix}downsample.bias"] = _hwio_to_oihw(w), b


def _frontend(tree: dict, prefix: str, out: dict) -> None:
    w, b = fold_bn(tree["stem_conv"]["kernel"], tree["stem_bn"])
    kd, kh, kw, cin, cout = w.shape
    w2 = w.transpose(1, 2, 0, 3, 4).reshape(kh, kw, kd * cin, cout)
    out[f"{prefix}stem.weight"], out[f"{prefix}stem.bias"] = _hwio_to_oihw(w2), b
    _convert(tree["body"], f"{prefix}body.", out)


INT8_LEAVES = ("kernel_q", "embedding_q")


def _convert(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        if "stem_conv" in tree:
            _frontend(tree, prefix, out)
        elif "conv1" in tree and "bn1" in tree:
            _bottleneck(tree, prefix, out)
        else:
            for key, val in tree.items():
                _convert(val, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            _convert(val, f"{prefix}{i}.", out)
    elif isinstance(tree, str):
        return  # metadata entries (e.g. conversion reports) carry no weights
    else:
        name = prefix[:-1]
        if name.split(".")[-1] in INT8_LEAVES:  # int8 weights, bit for bit
            arr = np.asarray(tree)
            if arr.dtype != np.int8:
                raise ValueError(f"{name} must be int8, not {arr.dtype}")
            out[name] = arr
            return
        arr = np.asarray(tree, np.float32)
        if arr.ndim == 3 and name.split(".")[-1] == "kernel":  # conv1d WIO -> [O, I, W]
            out[name[: -len("kernel")] + "weight"] = np.ascontiguousarray(arr.transpose(2, 1, 0))
        else:
            out[name] = arr


def from_jax_params(np_tree) -> dict[str, np.ndarray]:
    """The port's state_dict (numpy: fp32, int8 for the int8 leaves) for a
    JAX parameter tree."""
    out: dict[str, np.ndarray] = {}
    _convert(np_tree, "", out)
    return out


def load_jax_params(module: torch.nn.Module, np_tree) -> torch.nn.Module:
    """Install a JAX parameter tree into a port module of the same structure
    (strict: every parameter must be given, and nothing else)."""
    sd = {k: torch.tensor(v) for k, v in from_jax_params(np_tree).items()}
    module.load_state_dict(sd, strict=True)
    return module


# -- random trees of the JAX layout ---------------------------------------------


class _Init:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def uniform(self, shape, bound):
        return self.rng.uniform(-bound, bound, shape).astype(np.float32)

    def normal(self, shape, std=1.0):
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def linear(self, d_in, d_out, bias=True):
        bound = 1.0 / math.sqrt(d_in)
        p = {"kernel": self.uniform((d_in, d_out), bound)}
        if bias:
            p["bias"] = self.uniform((d_out,), bound)
        return p

    @staticmethod
    def ln(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    @staticmethod
    def bn(c):
        return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32),
                "mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}

    def conv1d(self, c_in, c_out, k):
        bound = 1.0 / math.sqrt(c_in * k)
        return {"kernel": self.uniform((k, c_in, c_out), bound),
                "bias": self.uniform((c_out,), bound)}

    def conv2d(self, k, c_in, c_out):
        return {"kernel": self.normal((k, k, c_in, c_out), math.sqrt(2.0 / (k * k * c_out)))}

    def attn(self, d, k_bias=True):
        return {"q": self.linear(d, d), "k": self.linear(d, d, bias=k_bias),
                "v": self.linear(d, d), "out": self.linear(d, d)}

    def mlp(self, d, d_ff):
        return {"fc1": self.linear(d, d_ff), "fc2": self.linear(d_ff, d)}


def _random_frontend(init: _Init) -> dict:
    body, c_in = {}, 64
    for idx, (blocks, mid, stride) in enumerate(RESNET50_STAGES, start=1):
        stage = []
        for i in range(blocks):
            c_out = mid * EXPANSION
            block = {"conv1": init.conv2d(1, c_in, mid), "bn1": init.bn(mid),
                     "conv2": init.conv2d(3, mid, mid), "bn2": init.bn(mid),
                     "conv3": init.conv2d(1, mid, c_out), "bn3": init.bn(c_out)}
            if i == 0 and (stride != 1 or c_in != c_out):
                block["downsample"] = {"conv": init.conv2d(1, c_in, c_out), "bn": init.bn(c_out)}
            stage.append(block)
            c_in = c_out
        body[f"layer{idx}"] = stage
    return {"stem_conv": {"kernel": init.normal((5, 3, 3, 3, 64), math.sqrt(2.0 / (5 * 3 * 3 * 64)))},
            "stem_bn": init.bn(64), "body": body}


def _random_whisper_encoder(cfg, init: _Init) -> dict:
    return {
        "conv1": init.conv1d(cfg.n_mels, cfg.d_model, 3),
        "conv2": init.conv1d(cfg.d_model, cfg.d_model, 3),
        "pos_embed": L.sinusoid_position_encoding(cfg.max_source_positions, cfg.d_model),
        "layers": [{"self_attn": init.attn(cfg.d_model, k_bias=False),
                    "self_attn_ln": init.ln(cfg.d_model),
                    "mlp": init.mlp(cfg.d_model, cfg.d_ff),
                    "mlp_ln": init.ln(cfg.d_model)} for _ in range(cfg.encoder_layers)],
        "ln_post": init.ln(cfg.d_model),
    }


def _random_whisper_decoder(cfg, init: _Init) -> dict:
    return {
        "embed_tokens": {"embedding": init.normal((cfg.vocab_size, cfg.d_model))},
        "pos_embed": init.normal((cfg.max_target_positions, cfg.d_model), 0.01),
        "layers": [{"self_attn": init.attn(cfg.d_model, k_bias=False),
                    "self_attn_ln": init.ln(cfg.d_model),
                    "cross_attn": init.attn(cfg.d_model, k_bias=False),
                    "cross_attn_ln": init.ln(cfg.d_model),
                    "mlp": init.mlp(cfg.d_model, cfg.d_ff),
                    "mlp_ln": init.ln(cfg.d_model)} for _ in range(cfg.decoder_layers)],
        "ln_post": init.ln(cfg.d_model),
    }


def _random_trunk(trunk, init: _Init) -> dict:
    cfg = trunk.whisper_config
    d = trunk.d_model
    enc = _random_whisper_encoder(cfg, init)
    fusion = {
        "audio_proj": init.linear(d, d),
        "video_proj": init.linear(d, d),
        "layers": [{"attn": init.attn(d), "attn_ln": init.ln(d), "ff_ln": init.ln(d),
                    "ff1": init.linear(d, 4 * d), "ff2": init.linear(4 * d, d),
                    "attn_gate": np.zeros((), np.float32),
                    "ff_gate": np.zeros((), np.float32)}
                   for _ in range(len(trunk.fusion.layers))],
        "ln_post": init.ln(d),
    }
    return {
        "whisper_encoder": enc,
        "audio_proj": init.linear(cfg.d_model, d),
        "audio_ln": init.ln(d),
        "visual_frontend": _random_frontend(init),
        "video_proj": init.linear(2048, d),
        "video_ln": init.ln(d),
        "fusion": fusion,
        "decoder": init.linear(d, trunk.vocab_size),
    }


def random_avnet_params(net, seed: int = 0) -> dict:
    """A random parameter tree in the JAX ``AVNet`` layout for the port's
    ``AVNet`` ``net``, drawn from the same distributions as the JAX ``init``.
    Fusion gates start at 0."""
    return _random_trunk(net, _Init(seed))


def random_jax_params(net, seed: int = 0) -> dict:
    """A random parameter tree in the JAX ``AVWhisperNet`` layout for the
    port model ``net`` (its configuration decides the shapes), drawn from
    the same distributions as the JAX ``init``. Fusion gates start at 0."""
    init = _Init(seed)
    cfg = net.whisper_config
    d = net.d_model
    tree_trunk = _random_trunk(net.trunk, init)
    decoder = _random_whisper_decoder(cfg, init)
    return {"trunk": tree_trunk, "bridge": init.linear(d, cfg.d_model), "decoder": decoder}


def random_asr_params(model, seed: int = 0) -> dict:
    """A random parameter tree in the JAX ``WhisperASR`` layout
    (``{"encoder": ..., "decoder": ...}``) for the port's ``WhisperASR``
    ``model``, drawn from the same distributions as the JAX ``init``."""
    init = _Init(seed)
    return {"encoder": _random_whisper_encoder(model.config, init),
            "decoder": _random_whisper_decoder(model.config, init)}


# -- HF Whisper state dicts -> trees of the JAX layout ---------------------------


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _hf_linear(sd: Mapping, prefix: str) -> dict:
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _hf_layer_norm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _hf_conv1d(sd: Mapping, prefix: str) -> dict:
    # torch Conv1d weight [out, in, k] -> the JAX layout [k, in, out]
    return {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 1, 0),
            "bias": _np(sd[f"{prefix}.bias"])}


def _hf_attn(sd: Mapping, prefix: str) -> dict:
    # HF Whisper's k_proj has no bias
    return {name: _hf_linear(sd, f"{prefix}.{name}_proj") for name in ("q", "k", "v", "out")}


def _hf_layers(sd: Mapping, num_layers: int, cross: bool) -> list[dict]:
    layers = []
    for i in range(num_layers):
        p = f"layers.{i}"
        layer = {"self_attn": _hf_attn(sd, f"{p}.self_attn"),
                 "self_attn_ln": _hf_layer_norm(sd, f"{p}.self_attn_layer_norm")}
        if cross:
            layer["cross_attn"] = _hf_attn(sd, f"{p}.encoder_attn")
            layer["cross_attn_ln"] = _hf_layer_norm(sd, f"{p}.encoder_attn_layer_norm")
        layer["mlp"] = {"fc1": _hf_linear(sd, f"{p}.fc1"), "fc2": _hf_linear(sd, f"{p}.fc2")}
        layer["mlp_ln"] = _hf_layer_norm(sd, f"{p}.final_layer_norm")
        layers.append(layer)
    return layers


def whisper_encoder_from_torch(state_dict: Mapping, num_layers: int) -> dict:
    """HF ``WhisperModel`` (or its ``.encoder``) state dict -> the JAX
    ``WhisperEncoder`` parameter tree (numpy)."""
    sd = {k.removeprefix("model.").removeprefix("encoder."): v
          for k, v in state_dict.items() if "decoder." not in k}
    return {
        "conv1": _hf_conv1d(sd, "conv1"),
        "conv2": _hf_conv1d(sd, "conv2"),
        "pos_embed": _np(sd["embed_positions.weight"]),
        "layers": _hf_layers(sd, num_layers, cross=False),
        "ln_post": _hf_layer_norm(sd, "layer_norm"),
    }


def whisper_decoder_from_torch(state_dict: Mapping, num_layers: int) -> dict:
    """HF ``WhisperModel`` (or its ``.decoder``) state dict -> the JAX
    ``WhisperDecoder`` parameter tree (numpy)."""
    sd = {k.removeprefix("model.").removeprefix("decoder."): v
          for k, v in state_dict.items() if "encoder." not in k or k.startswith("decoder.")}
    return {
        "embed_tokens": {"embedding": _np(sd["embed_tokens.weight"])},
        "pos_embed": _np(sd["embed_positions.weight"]),
        "layers": _hf_layers(sd, num_layers, cross=True),
        "ln_post": _hf_layer_norm(sd, "layer_norm"),
    }


# -- MoCo v2 ResNet-50 checkpoints ----------------------------------------------------


def _moco_bn(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"]),
            "mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}


def _moco_conv(sd: Mapping, prefix: str) -> np.ndarray:
    # torch Conv2d weight [out, in, kh, kw] -> the JAX layout [kh, kw, in, out]
    return _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)


def resnet50_from_moco(checkpoint: Mapping) -> tuple[dict[str, np.ndarray], dict]:
    """MoCo v2 checkpoint -> folded weights of the frontend's ResNet-50 body,
    with the JAX converter's ``load_state_dict(strict=False)`` semantics: the
    query encoder's layer1-4 keys land (``module.`` and ``encoder_q.``
    stripped), the stem and the MoCo MLP head are dropped, and a block with a
    missing key is reported in ``skipped`` and keeps its current weights.

    ``checkpoint``: the ``torch.load`` result (with ``"state_dict"``) or a
    plain state dict. Returns ``({name: array}, report)``: names relative to
    ``ResNet50Body`` (``layer1.0.conv1.weight``), each BatchNorm folded into
    its conv by ``fold_bn``; the report is the JAX converter's
    ``{"blocks_loaded": n, "skipped": ["layerN.i: 'missing key'", ...]}``.
    Within a block the (conv, BN) pairs before the first missing key still
    land, as the JAX converter writes them before it stops; a conv whose own
    BN is missing is left as it was (the folded form cannot pair it with the
    old BN)."""
    sd = checkpoint.get("state_dict", checkpoint)
    clean = {k.removeprefix("module.").removeprefix("encoder_q."): v for k, v in sd.items()}
    out: dict[str, np.ndarray] = {}
    loaded, skipped = 0, []
    c_in = 64
    for stage_idx, (blocks, mid, stride) in enumerate(RESNET50_STAGES, start=1):
        for block_idx in range(blocks):
            pfx = f"layer{stage_idx}.{block_idx}"
            pairs = [(f"conv{i}", f"{pfx}.conv{i}", f"{pfx}.bn{i}") for i in (1, 2, 3)]
            if block_idx == 0 and (stride != 1 or c_in != mid * EXPANSION):
                pairs.append(("downsample", f"{pfx}.downsample.0", f"{pfx}.downsample.1"))
            c_in = mid * EXPANSION
            try:
                for name, conv, bn in pairs:
                    w, b = fold_bn(_moco_conv(clean, conv), _moco_bn(clean, bn))
                    out[f"{pfx}.{name}.weight"], out[f"{pfx}.{name}.bias"] = _hwio_to_oihw(w), b
                loaded += 1
            except KeyError as e:
                skipped.append(f"{pfx}: {e}")
    return out, {"blocks_loaded": loaded, "skipped": skipped}


# -- the other direction, for the trainable leaves ---------------------------------


def trainable_to_jax_tree(net) -> dict:
    """The trainable parameters of a port ``AVNet`` as a nested tree of numpy
    arrays in the JAX layout (lists for ``layers``, scalar gates): the
    trainable part of the JAX ``AVNet`` parameter tree. Every trainable leaf
    is a linear kernel ``[d_in, d_out]``, a bias, a LayerNorm vector or a
    scalar gate, all of which the two packages store alike."""
    tree: dict = {}
    for name, param in net.trainable_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = param.detach().float().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)
