"""Configuration system (the port's own copy of the JAX package's
``config.py``: same sections, keys and defaults).

Every leaf can be overridden from the command line with dotted keys
(``--set model.d_model=256``); importing the module has no side effects (the
trainer creates the checkpoint and log directories when it starts). The
``mesh`` section is kept for the key names: the port trains on one card, and
``mesh.data`` or ``mesh.model`` above 1 is refused by the trainer.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Iterable, Mapping


class ConfigDict(dict):
    """Attribute-access dict (API-compatible with the reference ``DotDict``,
    reference: config.py:98-102) with deep-copy, freeze, and dotted-key
    override support."""

    def __getattr__(self, attr: str) -> Any:
        try:
            return self[attr]
        except KeyError:
            return None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def copy(self) -> "ConfigDict":
        return copy.deepcopy(self)

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        """Set ``a.b.c`` style key, creating intermediate ConfigDicts."""
        parts = dotted_key.split(".")
        node: Any = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = ConfigDict()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    def get_dotted(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted_key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def flatten(self, prefix: str = "") -> dict:
        out = {}
        for k, v in self.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(ConfigDict(v).flatten(prefix=key + "."))
            else:
                out[key] = v
        return out


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping) and not isinstance(obj, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    return obj


# ---------------------------------------------------------------------------
# Defaults — same hyperparameters as the reference full-size config
# (reference: config.py:7-96, matching all 55 logged hparams.yaml dumps).
# ---------------------------------------------------------------------------

DATA_ROOT = os.environ.get("AVSR_DATA_ROOT", "data/avsr")
MOCO_PRETRAINED = os.environ.get("AVSR_MOCO_CKPT", "moco_v2_800ep_pretrain.pth.tar")

MODEL_DEFAULTS = dict(
    d_model=512,
    n_heads=8,
    n_layers=6,
    pe_max_len=3000,
    fc_hidden_size=2048,
    dropout=0.1,
    fusion_layers=6,
    fusion_dropout=0.1,
    required_input_length=96,
    frontend_d_model=512,
    video_feature_size=512,
    frame_length=96,
    rate_ratio=640,
    prob_av=0.5,
    prob_a=0.25,
    beam_width=3,
    ctc_lambda=0.6,
)

TRAIN_DEFAULTS = dict(
    epochs=30,
    warmup_ratio=0.1,
    max_lr=1e-3,
    min_lr=1e-5,
    weight_decay=0.01,
    gradient_clip_val=1.0,
    early_stopping_patience=10,
    accumulate_grad_batches=4,
    label_smoothing=0.1,
    seed=0,
    # bias/LN/gate no-decay param groups (notebook-trainer recipe; the main
    # reference trainer decays everything, so off by default for parity)
    no_decay_groups=False,
    # remap collate's 0-padding to -100 before the CE (fixes quirk Q3; off
    # by default for parity with the reference numerics)
    pad_to_ignore=False,
    # "ctc_ce" (committed trainer, reference train.py) or "feature_mse"
    # (notebook-era feature-alignment pretraining, reference train.ipynb).
    loss_mode="ctc_ce",
    # "int8": store the frozen whisper-encoder kernels int8 (w8a16) inside
    # the train step (AVNet.quantize_frozen_params; checkpoints hold the
    # quantized encoder, so keep the knob constant across a run). Off: the
    # int8 step is slower than bf16 storage (PERF.md).
    # (training.frozen_param_dtype="bf16", not a default key, stores the
    # frozen trees in bf16: AVNet.cast_frozen_params.)
    frozen_weight_quant=None,
)

AUGMENTATION_DEFAULTS = dict(
    # Run the stochastic train augmentation (SpecAugment, babble mix,
    # layer-norm, flip/ColorJitter/grayscale/time-mask/normalize) batched
    # on the device inside the train step instead of per-sample on the host
    # (ops.augment.make_batch_augment). Off by default, as in the reference's
    # host pipeline; turn on when the host cannot feed the device step.
    on_device=False,
    # With on_device: the train loader ships the raw 16 kHz waveform (packed
    # to 480200 samples) and the mel is computed on the card inside the train
    # step (ops.augment.make_batch_augment), with fp32 matmuls: TF32 must be
    # off, or the step raises.
    on_device_mel=False,
    video=dict(
        train=dict(
            resize=64,
            random_flip_prob=0.5,
            color_jitter=dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1),
            grayscale_prob=0.2,
            time_mask_window=10,
            time_mask_stride=25,
        ),
        val=dict(resize=64),
    ),
    audio=dict(
        train=dict(
            freq_mask_param=48,
            n_freq_masks=2,
            time_mask_ratio=8,  # time_mask_param = length // 8
            n_time_masks=2,
            # Babble noise is mixed into the *mel* (not the waveform) at a
            # random SNR, faithfully replicating the reference quirk Q1
            # (reference: transforms.py:123-131 — AddNoise sits after
            # MelSpectrogram).  Set noise_domain="waveform" for the fixed
            # behavior.
            snr_levels=(-5, 0, 5, 10, 15, 20, 999999),
            noise_domain="mel",
            noise_file=None,  # path to a 16 kHz babble wav; None -> no noise
        ),
    ),
)

WHISPER_DEFAULTS = dict(
    model_name="whisper-small",
    freeze_encoder=True,
    use_flash_attention=True,
    language="vietnamese",
    task="transcribe",
)

MOCO_DEFAULTS = dict(freeze_encoder=True, feature_dim=512)

OUTPUT_DEFAULTS = dict(
    checkpoint_dir="checkpoints",
    log_dir="logs",
    save_top_k=3,
    monitor="val_loss",
    monitor_mode="min",
    log_every_n_steps=100,
    save_predictions=True,
    log_gates=True,
    enable_logging=False,
)

MESH_DEFAULTS = dict(
    # Devices laid out (data, model). One card only for now: the trainer
    # raises on either axis above 1.
    data=-1,   # -1 = all remaining devices
    model=1,
)

PRECISION_DEFAULTS = dict(
    # bf16 compute with fp32 LayerNorm/softmax islands, in place of the
    # reference's "16-mixed" AMP (reference: train.py:316).
    compute_dtype="bfloat16",
    param_dtype="float32",
    rematerialize=True,
)


def get_config(overrides: Iterable[str] | Mapping[str, Any] | None = None) -> ConfigDict:
    """Build the default config tree (same sections/keys as the reference
    ``get_config()``, reference: config.py:104-146) and apply overrides.

    ``overrides`` may be a mapping of dotted keys to values, or an iterable of
    ``"dotted.key=value"`` strings (values parsed as Python literals when
    possible).
    """
    config = ConfigDict(
        data=ConfigDict(
            root_dir=DATA_ROOT,
            moco_file=MOCO_PRETRAINED,
            batch_size=4,
            val_batch_size=2,
            test_batch_size=2,
            num_workers=0,
            max_frames=400,
            max_frames_val=400,
            rate_ratio=MODEL_DEFAULTS["rate_ratio"],
            modality="audiovisual",
            updated_tokenizer_dir=None,
            # Batch sizes quantized to powers of two and targets padded to
            # length buckets (the data module's knobs; set to False/None for
            # the reference's exact pad-to-batch-max behavior).
            quantize_batch_sizes=True,
            target_len_buckets=(64, 128, 256, 448),
            # Inter-batch prefetch depth (0 = synchronous loader): batch
            # N+1's fetch+collate+H2D overlaps step N's device compute —
            # the torch DataLoader worker/pin_memory overlap analog
            # (reference: data_module.py:243-252).
            prefetch_batches=2,
            dataset=ConfigDict(root_dir=DATA_ROOT),
        ),
        model=ConfigDict(
            d_model=MODEL_DEFAULTS["d_model"],
            n_heads=MODEL_DEFAULTS["n_heads"],
            n_layers=MODEL_DEFAULTS["n_layers"],
            pe_max_len=MODEL_DEFAULTS["pe_max_len"],
            fc_hidden_size=MODEL_DEFAULTS["fc_hidden_size"],
            dropout=MODEL_DEFAULTS["dropout"],
            fusion_layers=MODEL_DEFAULTS["fusion_layers"],
            required_input_length=MODEL_DEFAULTS["required_input_length"],
        ),
        training=ConfigDict(**TRAIN_DEFAULTS),
        augmentation=_wrap(AUGMENTATION_DEFAULTS),
        whisper=ConfigDict(**WHISPER_DEFAULTS),
        moco=ConfigDict(**MOCO_DEFAULTS),
        output=ConfigDict(**OUTPUT_DEFAULTS),
        mesh=ConfigDict(**MESH_DEFAULTS),
        precision=ConfigDict(**PRECISION_DEFAULTS),
        trainer=ConfigDict(num_nodes=1),
    )

    if overrides:
        items: Iterable
        if isinstance(overrides, Mapping):
            items = overrides.items()
        else:
            pairs = []
            for s in overrides:
                key, _, raw = s.partition("=")
                try:
                    val = ast.literal_eval(raw)
                except (ValueError, SyntaxError):
                    # lowercase true/false/null read naturally on a CLI but
                    # are not Python literals — without this, "false" would
                    # land as a TRUTHY string and silently enable flags
                    lowered = raw.strip().lower()
                    val = {"true": True, "false": False,
                           "null": None, "none": None}.get(lowered, raw)
                pairs.append((key.strip(), val))
            items = pairs
        for key, val in items:
            config.set_dotted(key, val)

    return config


def add_config_flags(parser) -> None:
    """Attach ``--set section.key=value`` override flags to an argparse parser."""
    parser.add_argument(
        "--set",
        dest="config_overrides",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="Override a config leaf, e.g. --set model.d_model=256",
    )


def config_from_args(args) -> ConfigDict:
    return get_config(getattr(args, "config_overrides", None))
