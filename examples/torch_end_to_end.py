#!/usr/bin/env python
"""End-to-end walkthrough of the PyTorch port on synthetic data: dataset ->
train -> evaluate -> export -> beam decode, with a tiny model (swap the
config overrides for the full-size run). Runs on the CUDA card, or on the
CPU with ``--cpu``.

    python examples/torch_end_to_end.py [--workdir DIR] [--cpu]

The twin of ``examples/end_to_end.py`` (the JAX package's walkthrough):
``mocov2_whisper_flamingo_torch.train.build_net`` + ``Trainer`` for the
training, ``tools/export_model.py`` for the ``torch.export`` artifact, and
``AVWhisperNet.beam`` for the decode. The fusion uses 2 heads of 32: the
flash-attention kernel takes head dims 32, 64 and 128.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import wave as wave_mod

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_dataset(root: str, n_clips: int = 4) -> None:
    """The reference's on-disk layout: ``{split}_{video,text}_seg12s`` with
    sibling WAVs."""
    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        vdir = os.path.join(root, split, f"{split}_video_seg12s", "spk")
        tdir = os.path.join(root, split, f"{split}_text_seg12s", "spk")
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(tdir, exist_ok=True)
        for i in range(n_clips):
            frames = rng.integers(0, 255, (8 + 2 * i, 64, 64, 3), dtype=np.uint8)
            np.save(os.path.join(vdir, f"clip{i}.npy"), frames)
            t = np.arange(8000 + 2000 * i) / 16000
            x = 0.4 * np.sin(2 * np.pi * (300 + 50 * i) * t)
            with wave_mod.open(os.path.join(vdir, f"clip{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((x * 32767).astype("<i2").tobytes())
            with open(os.path.join(tdir, f"clip{i}.txt"), "w") as f:
                f.write(f"xin chao so {i}")


def example_batch(device, b: int = 1, t_video: int = 16):
    import torch

    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((b, 3000, 80)).astype(np.float32)).to(device),
            torch.ones((b, 3000), dtype=torch.bool, device=device),
            torch.from_numpy(rng.standard_normal((b, t_video, 3, 64, 64)).astype(np.float32)
                             ).to(device),
            torch.ones((b, t_video), dtype=torch.bool, device=device),
            torch.full((b,), t_video, dtype=torch.int32, device=device))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args()
    workdir = args.workdir or tempfile.mkdtemp(prefix="avsr_torch_demo_")
    data_root = os.path.join(workdir, "data")
    make_dataset(data_root)
    print(f"[1/5] synthetic dataset at {data_root}")

    import torch

    from mocov2_whisper_flamingo_torch.config import get_config
    from mocov2_whisper_flamingo_torch.datamodule.data_module import DataModule
    from mocov2_whisper_flamingo_torch.device import resolve_device
    from mocov2_whisper_flamingo_torch.train import build_net
    from mocov2_whisper_flamingo_torch.training.trainer import Trainer

    device = resolve_device("cpu" if args.cpu else "cuda")
    config = get_config({
        "data.root_dir": data_root,
        "data.batch_size": 2,
        "data.max_frames": 16,
        "data.max_frames_val": 16,
        "training.epochs": 1,
        "training.accumulate_grad_batches": 1,
        "output.checkpoint_dir": os.path.join(workdir, "checkpoints"),
        "output.log_dir": os.path.join(workdir, "logs"),
        "output.log_every_n_steps": 1,
        "mesh.model": 1,
        # tiny model so the demo runs fast
        "whisper.model_name": "whisper-tiny",
        "model.d_model": 64,
        "model.n_heads": 2,
        "model.fc_hidden_size": 128,
    })

    datamodule = DataModule(config)
    datamodule.setup()
    net = build_net(config, datamodule.vocab_size, device)
    trainer = Trainer(config, net, datamodule.tokenizer, device=device)
    print(f"[2/5] training 1 epoch on {device} ...")
    trainer.fit(datamodule)

    print("[3/5] evaluating (reference-parity greedy decode)...")
    metrics = trainer.test(datamodule)
    print("      test metrics:", json.dumps(metrics))

    print("[4/5] exporting with torch.export + reload-verify...")
    from mocov2_whisper_flamingo_torch.tools.export_model import export_forward, verify_export

    batch = example_batch(device, b=2)
    pt2_path = os.path.join(workdir, "avsr.pt2")
    export_forward(net, batch, pt2_path)
    # The artifact holds plain attention; the live net runs the flash kernel
    # on the card. bf16 compute: the JAX walkthrough's tolerance.
    with torch.no_grad():
        live = net(batch)
    assert verify_export(pt2_path, batch, reference_out=live, atol=0.1)
    print(f"      exported + verified {pt2_path}")

    print("[5/5] beam=3 decode through the Whisper decoder bridge...")
    from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_jax_params
    from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig

    tiny = WhisperConfig(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=2,
                         n_heads=2, d_ff=128, vocab_size=datamodule.vocab_size,
                         max_source_positions=1500, max_target_positions=48)
    av = AVWhisperNet(modelargs=(64, 2, 2, 3000, 128, 0.0), vocab_size=datamodule.vocab_size,
                      device=device, whisper_config=tiny)
    load_jax_params(av, random_jax_params(av, 0))
    tok = datamodule.tokenizer
    result = av.beam(example_batch(device), tok.prefix_token_ids, beam_size=3, max_len=16,
                     eos_id=tok.eos_token_id)
    texts = tok.batch_decode(result.sequences[:, 0].cpu().numpy(), skip_special_tokens=True)
    print("      beam hypotheses (random weights):", texts)
    print(f"DONE. artifacts in {workdir}")


if __name__ == "__main__":
    main()
