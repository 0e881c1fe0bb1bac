#!/usr/bin/env python
"""Model verification: stability, memory, and shape sweeps.

    python -m mocov2_whisper_flamingo_torch.tools.verify_model [--tiny] [--device cpu]

Counterpart of the JAX package's ``tools/verify_model.py``:

- ``test_model_stability``: forward under each modality pattern (AV / AO /
  VO), NaN/Inf scan on the logits;
- ``test_memory_usage``: forward + backward, then the device's memory: on a
  CUDA card ``torch.cuda.memory_allocated`` and ``max_memory_allocated``
  since a reset just before the step (the JAX keys ``bytes_in_use`` and
  ``peak_bytes_in_use``), 0 on the CPU as JAX's CPU ``memory_stats`` gives;
- ``test_input_shapes``: forward at several (batch, audio_len, video_len)
  combos.

The gradient is that of ``sum(logits**2) * 1e-9`` over
``AVNet.trainable_parameters()``: the frozen Whisper encoder and MoCo
frontend get none (the JAX package's get zeros through ``stop_gradient``).
The net is built by ``train.build_net`` on ``--device`` (the CUDA card
unless ``cpu`` is asked for), so its attention runs the flash-attention
kernel there. The three functions are named ``test_*`` as in the JAX
package: import the module, not the names, where pytest collects.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

logger = logging.getLogger("verify_model")


def _make_batch(rng, b, t_audio, t_video, hw=64, modality="audiovisual", device="cpu"):
    """The JAX tool's batch, drawn from ``rng`` in the same order: mel
    ``[B, 3000, 80]`` valid up to ``t_audio``, video ``[B, t_video, 3, hw,
    hw]``; the other stream zeroed for a single-modality pattern."""
    audio = np.asarray(rng.standard_normal((b, 3000, 80)), np.float32)
    if modality == "video":
        audio = np.zeros_like(audio)
    audio_mask = np.arange(3000)[None] < t_audio * np.ones((b, 1))
    video = np.asarray(rng.standard_normal((b, t_video, 3, hw, hw)), np.float32)
    if modality == "audio":
        video = np.zeros_like(video)
    return (torch.from_numpy(audio).to(device), torch.from_numpy(audio_mask).to(device),
            torch.from_numpy(video).to(device),
            torch.ones((b, t_video), dtype=torch.bool, device=device),
            torch.full((b,), t_video, dtype=torch.int32, device=device))


def _device(net) -> torch.device:
    return next(net.parameters()).device


@torch.no_grad()
def test_model_stability(net, rng=None, modalities=("audiovisual", "audio", "video")) -> dict:
    """Forward under each modality pattern; scan outputs for NaN/Inf."""
    rng = rng or np.random.default_rng(0)
    results = {}
    for modality in modalities:
        logits = net(_make_batch(rng, 2, 2400, 16, modality=modality, device=_device(net)))
        finite = bool(torch.isfinite(logits).all())
        results[modality] = {
            "finite": finite,
            "shape": tuple(logits.shape),
            "logit_range": (float(logits.min()), float(logits.max())),
        }
        status = "OK" if finite else "FAILED (NaN/Inf)"
        logger.info("modality=%s %s shape=%s", modality, status, tuple(logits.shape))
    return results


def test_memory_usage(net, rng=None) -> dict:
    """Forward + backward, then the device's memory in use and its peak
    since the step began (0 and 0 on the CPU)."""
    rng = rng or np.random.default_rng(0)
    dev = _device(net)
    batch = _make_batch(rng, 2, 2400, 16, device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    loss = torch.sum(net(batch) ** 2) * 1e-9
    grads = torch.autograd.grad(loss, [p for _, p in net.trainable_parameters()])
    report = {
        "bytes_in_use": 0,
        "peak_bytes_in_use": 0,
        "grads_finite": bool(all(torch.isfinite(g).all() for g in grads)),
    }
    if cuda:
        torch.cuda.synchronize(dev)
        report["bytes_in_use"] = torch.cuda.memory_allocated(dev)
        report["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(dev)
    logger.info("memory: %s", report)
    return report


@torch.no_grad()
def test_input_shapes(net, rng=None,
                      combos=((1, 500, 8), (2, 1000, 12), (4, 750, 10))) -> dict:
    """Forward at several (B, audio_valid_len, T_video) shapes."""
    rng = rng or np.random.default_rng(0)
    results = {}
    for b, t_audio, t_video in combos:
        logits = net(_make_batch(rng, b, t_audio, t_video, device=_device(net)))
        results[(b, t_audio, t_video)] = tuple(logits.shape)
        logger.info("shapes (B=%d, Ta=%d, Tv=%d) -> %s", b, t_audio, t_video,
                    tuple(logits.shape))
    return results


def apply_tiny(config) -> None:
    """``--tiny``: whisper-tiny under a 64-wide fusion of 2 heads of 32 (the
    flash-attention kernel takes head dims 32, 64 and 128)."""
    config.set_dotted("whisper.model_name", "whisper-tiny")
    config.set_dotted("model.d_model", 64)
    config.set_dotted("model.n_heads", 2)
    config.set_dotted("model.fc_hidden_size", 128)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    from mocov2_whisper_flamingo_torch.config import add_config_flags, config_from_args

    add_config_flags(parser)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny whisper encoder for quick runs")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    args = parser.parse_args(argv)
    config = config_from_args(args)
    logging.basicConfig(level=logging.INFO)

    from mocov2_whisper_flamingo_torch.train import build_net

    if args.tiny:
        apply_tiny(config)
    net = build_net(config, vocab_size=51865, device=args.device)
    stability = test_model_stability(net)
    memory = test_memory_usage(net)
    test_input_shapes(net)

    ok = all(r["finite"] for r in stability.values()) and memory["grads_finite"]
    print("VERIFY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
