"""The parameters of the audio-visual Whisper model, by name, shape and kind
of initial value, from a configuration file's sizes.

The names are the benchmark's: the harness fills the program's parameters
of the same names from the seed (``portbench/weights.py``) and the plain
reference reads the same values by these names. ``kind`` chooses the
distribution (see ``weights.py``).
"""

from __future__ import annotations

RESNET50_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
EXPANSION = 4
STEM_DEPTH = 5
FRONTEND_OUT = 2048


def _linear(out, name, d_in, d_out, bias=True):
    out.append((f"{name}.kernel", (d_in, d_out), "linear"))
    if bias:
        out.append((f"{name}.bias", (d_out,), "bias"))


def _ln(out, name, d):
    out.append((f"{name}.scale", (d,), "ln_scale"))
    out.append((f"{name}.bias", (d,), "ln_bias"))


def _conv(out, name, c_out, c_in, k, kind="conv"):
    out.append((f"{name}.weight", (c_out, c_in, k, k), kind))
    out.append((f"{name}.bias", (c_out,), "bias"))


def _attention(out, name, d, k_bias):
    _linear(out, f"{name}.q", d, d)
    _linear(out, f"{name}.k", d, d, bias=k_bias)
    _linear(out, f"{name}.v", d, d)
    _linear(out, f"{name}.out", d, d)


def _whisper_encoder(out, p, w):
    d = w["d_model"]
    out.append((f"{p}.pos_embed", (w["max_source_positions"], d), "pos"))
    out.append((f"{p}.conv1.weight", (d, w["n_mels"], 3), "conv1d"))
    out.append((f"{p}.conv1.bias", (d,), "bias"))
    out.append((f"{p}.conv2.weight", (d, d, 3), "conv1d"))
    out.append((f"{p}.conv2.bias", (d,), "bias"))
    for i in range(w["encoder_layers"]):
        lp = f"{p}.layers.{i}"
        _attention(out, f"{lp}.self_attn", d, k_bias=False)
        _ln(out, f"{lp}.self_attn_ln", d)
        _linear(out, f"{lp}.mlp.fc1", d, w["d_ff"])
        _linear(out, f"{lp}.mlp.fc2", w["d_ff"], d)
        _ln(out, f"{lp}.mlp_ln", d)
    _ln(out, f"{p}.ln_post", d)


def _frontend(out, p):
    _conv(out, f"{p}.stem", 64, STEM_DEPTH * 3, 3, "conv_relu")
    c_in = 64
    for idx, (blocks, mid, stride) in enumerate(RESNET50_STAGES, start=1):
        for i in range(blocks):
            bp = f"{p}.body.layer{idx}.{i}"
            c_out = mid * EXPANSION
            _conv(out, f"{bp}.conv1", mid, c_in, 1, "conv_relu")
            _conv(out, f"{bp}.conv2", mid, mid, 3, "conv_relu")
            _conv(out, f"{bp}.conv3", c_out, mid, 1, "conv_residual")
            if (stride if i == 0 else 1) != 1 or c_in != c_out:
                _conv(out, f"{bp}.downsample", c_out, c_in, 1, "conv_relu")
            c_in = c_out


def trunk_parameters(cfg: dict, prefix: str = "trunk") -> list[tuple[str, tuple, str]]:
    """The AV trunk: frozen Whisper encoder and MoCo frontend, the stream
    projections, the gated fusion and the frame-wise CTC head."""
    m, w = cfg["model"], cfg["whisper"]
    d = m["d_model"]
    out: list = []
    _whisper_encoder(out, f"{prefix}.whisper_encoder", w)
    _linear(out, f"{prefix}.audio_proj", w["d_model"], d)
    _ln(out, f"{prefix}.audio_ln", d)
    _frontend(out, f"{prefix}.visual_frontend")
    _linear(out, f"{prefix}.video_proj", FRONTEND_OUT, d)
    _ln(out, f"{prefix}.video_ln", d)
    fp = f"{prefix}.fusion"
    _linear(out, f"{fp}.audio_proj", d, d)
    _linear(out, f"{fp}.video_proj", d, d)
    for i in range(max(m["n_layers"] // 2, 1)):
        lp = f"{fp}.layers.{i}"
        out.append((f"{lp}.attn_gate", (), "gate"))
        out.append((f"{lp}.ff_gate", (), "gate"))
        _attention(out, f"{lp}.attn", d, k_bias=True)
        _ln(out, f"{lp}.attn_ln", d)
        _ln(out, f"{lp}.ff_ln", d)
        _linear(out, f"{lp}.ff1", d, 4 * d)
        _linear(out, f"{lp}.ff2", 4 * d, d)
    _ln(out, f"{fp}.ln_post", d)
    _linear(out, f"{prefix}.decoder", d, cfg["vocab_size"])
    return out


def model_parameters(cfg: dict) -> list[tuple[str, tuple, str]]:
    """The served model: the trunk, the bridge to the decoder's width and
    the Whisper decoder (tied vocabulary projection)."""
    w = cfg["whisper"]
    d = w["d_model"]
    out = trunk_parameters(cfg)
    _linear(out, "bridge", cfg["model"]["d_model"], d)
    out.append(("decoder.pos_embed", (w["max_target_positions"], d), "pos"))
    out.append(("decoder.embed_tokens.embedding", (cfg["vocab_size"], d), "embed"))
    for i in range(w["decoder_layers"]):
        lp = f"decoder.layers.{i}"
        _attention(out, f"{lp}.self_attn", d, k_bias=False)
        _ln(out, f"{lp}.self_attn_ln", d)
        _attention(out, f"{lp}.cross_attn", d, k_bias=False)
        _ln(out, f"{lp}.cross_attn_ln", d)
        _linear(out, f"{lp}.mlp.fc1", d, w["d_ff"])
        _linear(out, f"{lp}.mlp.fc2", w["d_ff"], d)
        _ln(out, f"{lp}.mlp_ln", d)
    _ln(out, "decoder.ln_post", d)
    return out


FROZEN = ("trunk.whisper_encoder.", "trunk.visual_frontend.")


def is_trainable(name: str) -> bool:
    """Everything of the trunk except the frozen Whisper encoder and MoCo
    frontend."""
    return name.startswith("trunk.") and not name.startswith(FROZEN)
