"""The port's model and data tools against the JAX package's on the CPU:
``verify_model`` (fp32 logits of every modality and shape within 1e-4 of the
JAX forward, the same memory report), ``convert_checkpoint`` (bit for bit
against the JAX converters through the bridge), ``monitor``,
``max_frame_count`` and ``smoke_test`` (the same reports on the same files),
and the tools' refusal to leave the card silently. The tiny configuration
is tests/test_tools.py's."""

import dataclasses
import os
import re
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_avnet_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.tools import verify_model as vm
from mocov2_whisper_flamingo_tpu.models.av_net import AVNet as JNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
from mocov2_whisper_flamingo_tpu.tools import verify_model as jvm
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

VOCAB = 64
MODELARGS = (32, 4, 2, 3000, 128, 0.0)
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=1500, max_target_positions=32)
ATOL = 1e-4  # fp32 logits
COMBOS = ((1, 500, 8), (2, 1000, 12))


@pytest.fixture(scope="module")
def nets():
    tnet = TNet("audiovisual", None, 96, MODELARGS, VOCAB, device="cpu",
                whisper_config=TConfig(**TINY))
    tree = random_avnet_params(tnet, 1)
    for layer in tree["fusion"]["layers"]:  # the fusion attention reaches the logits
        layer["attn_gate"] = np.float32(0.5)
        layer["ff_gate"] = np.float32(-0.3)
    load_jax_params(tnet, tree)
    jnet = JNet("audiovisual", None, 96, MODELARGS, VOCAB, backend="xla")
    cfg = JConfig(**TINY)
    jnet.whisper_config = cfg
    jnet.whisper_encoder = JEncoder(cfg, jnet.precision, "xla")
    return tnet, jnet, jax.tree.map(jnp.asarray, tree)


# -- verify_model ------------------------------------------------------------------------


def test_verify_model_matches_the_jax_forward(nets):
    """The same batches from the two ``_make_batch`` twins (one seed), the
    same logits, and the reports that follow from them."""
    tnet, jnet, params = nets
    jforward = jax.jit(jnet.forward)
    t_rng, j_rng = np.random.default_rng(0), np.random.default_rng(0)
    expected = {}
    for modality in ("audiovisual", "audio", "video"):
        tb = vm._make_batch(t_rng, 2, 2400, 16, modality=modality)
        ref = np.asarray(jforward(params, jvm._make_batch(j_rng, 2, 2400, 16,
                                                          modality=modality)))
        with torch.no_grad():
            np.testing.assert_allclose(tnet(tb).numpy(), ref, atol=ATOL, rtol=0)
        expected[modality] = (ref.shape, ref.min(), ref.max())
    stability = vm.test_model_stability(tnet, np.random.default_rng(0))
    assert set(stability) == set(expected)
    for modality, (shape, lo, hi) in expected.items():
        got = stability[modality]
        assert got["finite"] and got["shape"] == shape == (2, 16, VOCAB)
        np.testing.assert_allclose(got["logit_range"], (lo, hi), atol=ATOL, rtol=0)

    shapes = {}
    t_rng, j_rng = np.random.default_rng(3), np.random.default_rng(3)
    for b, ta, tv in COMBOS:
        ref = np.asarray(jforward(params, jvm._make_batch(j_rng, b, ta, tv)))
        with torch.no_grad():
            np.testing.assert_allclose(tnet(vm._make_batch(t_rng, b, ta, tv)).numpy(), ref,
                                       atol=ATOL, rtol=0)
        shapes[(b, ta, tv)] = ref.shape
    assert vm.test_input_shapes(tnet, np.random.default_rng(3), COMBOS) == shapes
    assert shapes == {(1, 500, 8): (1, 8, VOCAB), (2, 1000, 12): (2, 12, VOCAB)}


def test_verify_model_memory_report_matches_jax(nets):
    """Forward + backward over the trainable parameters: finite gradients,
    and 0 bytes in use and at peak on the CPU, as JAX reports there."""
    tnet, jnet, params = nets
    ours = vm.test_memory_usage(tnet, np.random.default_rng(0))
    assert ours == jvm.test_memory_usage(jnet, params, np.random.default_rng(0))
    assert ours == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "grads_finite": True}
    assert all(p.grad is None for p in tnet.parameters())  # autograd.grad, no .grad left


def test_model_tools_refuse_to_leave_the_card_silently():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from mocov2_whisper_flamingo_torch.tools import export_model

    for tool in (vm, export_model):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--tiny"])


# -- convert_checkpoint --------------------------------------------------------------------


def _moco_checkpoint(path, seed: int, missing: str | None = None) -> None:
    """A MoCo v2 checkpoint of random weights in its own layout (query
    encoder stem, layer1-4 with BN statistics off their init, MLP head);
    ``missing`` names a block left out."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + offset).astype(np.float32))

    def conv_bn(conv, bn, c_out, c_in, k):
        sd[f"{conv}.weight"] = t((c_out, c_in, k, k), (2.0 / (c_in * k * k)) ** 0.5)
        sd[f"{bn}.weight"], sd[f"{bn}.bias"] = t((c_out,), 0.1, 1.0), t((c_out,), 0.1)
        sd[f"{bn}.running_mean"] = t((c_out,), 0.1)
        sd[f"{bn}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c_out).astype(np.float32))

    q = "module.encoder_q"
    conv_bn(f"{q}.conv1", f"{q}.bn1", 64, 3, 7)
    c_in = 64
    for stage, (blocks, mid) in enumerate(((3, 64), (4, 128), (6, 256), (3, 512)), start=1):
        for i in range(blocks):
            p = f"{q}.layer{stage}.{i}"
            if f"layer{stage}.{i}" != missing:
                conv_bn(f"{p}.conv1", f"{p}.bn1", mid, c_in, 1)
                conv_bn(f"{p}.conv2", f"{p}.bn2", mid, mid, 3)
                conv_bn(f"{p}.conv3", f"{p}.bn3", mid * 4, mid, 1)
                if i == 0:
                    conv_bn(f"{p}.downsample.0", f"{p}.downsample.1", mid * 4, c_in, 1)
            c_in = mid * 4
    sd[f"{q}.fc.0.weight"] = t((2048, 2048), 0.01)
    torch.save({"epoch": 800, "arch": "resnet50", "state_dict": sd}, path)


def test_convert_moco_matches_the_jax_converter(tmp_path):
    """The port's output, loaded into the port's frontend, equals the JAX
    ``convert_moco`` output installed by ``load_jax_params``, bit for bit,
    and equals what ``AVNet.load_moco`` installs; a block missing from the
    checkpoint is reported as the JAX converter reports it."""
    from mocov2_whisper_flamingo_torch.models.visual_frontend import (
        MoCoVisualFrontend, ResNet50Body)
    from mocov2_whisper_flamingo_torch.tools import convert_checkpoint as cc
    from mocov2_whisper_flamingo_tpu.models.convert import (
        resnet50_from_moco as j_resnet50_from_moco)
    from mocov2_whisper_flamingo_tpu.tools import convert_checkpoint as jcc

    src, out = tmp_path / "moco_v2_800ep_pretrain.pth.tar", tmp_path / "conv" / "moco.pt"
    _moco_checkpoint(src, 4)
    assert cc.main(["--kind", "moco", "--input", str(src), "--output", str(out)]) == 0
    converted = torch.load(out, weights_only=True)
    assert converted["conversion_report"] == {"blocks_loaded": 16, "skipped": []}
    ours = MoCoVisualFrontend(device="cpu")
    ours.load_state_dict(converted["state_dict"], strict=False)

    jax_body = jcc.convert_moco(jcc.load_torch_state_dict(str(src)))
    ref = load_jax_params(ResNet50Body(device="cpu"),
                          jax.tree.map(lambda x: np.array(x, np.float32), jax_body))
    got = ours.body.state_dict()
    assert set(got) == set(ref.state_dict())
    for name, value in ref.state_dict().items():
        assert torch.equal(got[name], value), name

    net = TNet("audiovisual", None, 96, MODELARGS, VOCAB, device="cpu",
               whisper_config=TConfig(**TINY))
    net.load_moco(str(src))
    assert all(torch.equal(net.visual_frontend.state_dict()[k], v)
               for k, v in converted["state_dict"].items())

    partial = tmp_path / "partial.pth.tar"
    _moco_checkpoint(partial, 5, missing="layer3.2")
    checkpoint = torch.load(partial, weights_only=True)
    jax_report = j_resnet50_from_moco(checkpoint, jax_body)["_conversion_report"]
    assert cc.convert_moco(checkpoint)["conversion_report"] == jax_report
    assert jax_report["blocks_loaded"] == 15


def test_convert_whisper_matches_the_jax_converter(tmp_path):
    """An HF Whisper checkpoint (a directory holding ``pytorch_model.bin``)
    -> the port's state dict: it loads into the port's ``WhisperASR``
    whole, through ``tools/serve.py::load_checkpoint`` too, and equals the
    JAX ``convert_whisper`` output installed by ``load_jax_params``, bit
    for bit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # no TensorFlow import: the torch model is all this needs
        transformers = pytest.importorskip("transformers")
    from mocov2_whisper_flamingo_torch.models import whisper as TW
    from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
    from mocov2_whisper_flamingo_torch.tools import convert_checkpoint as cc
    from mocov2_whisper_flamingo_torch.tools import serve
    from mocov2_whisper_flamingo_tpu.models import whisper as JW
    from mocov2_whisper_flamingo_tpu.tools import convert_checkpoint as jcc

    hf_cfg = transformers.WhisperConfig(
        vocab_size=VOCAB, num_mel_bins=80, encoder_layers=1, encoder_attention_heads=4,
        decoder_layers=1, decoder_attention_heads=4, d_model=32, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_source_positions=20, max_target_positions=16,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)
    torch.manual_seed(0)
    src = tmp_path / "hf"
    src.mkdir()
    torch.save(transformers.WhisperModel(hf_cfg).state_dict(), src / "pytorch_model.bin")

    shape = dict(d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
                 vocab_size=VOCAB, max_source_positions=20, max_target_positions=16)
    out = tmp_path / "whisper_tiny.pt"
    with pytest.MonkeyPatch.context() as mp:
        for sizes in (TW.WHISPER_SIZES, JW.WHISPER_SIZES):
            mp.setitem(sizes, "whisper-tiny",
                       dataclasses.replace(sizes["whisper-tiny"], **shape))
        assert cc.main(["--kind", "whisper", "--size", "whisper-tiny", "--input", str(src),
                        "--output", str(out)]) == 0
        jax_tree = jcc.convert_whisper(jcc.load_torch_state_dict(str(src)), "whisper-tiny")
        ours, ref = (WhisperASR("whisper-tiny", device="cpu") for _ in range(2))
    ours.load_state_dict(torch.load(out, weights_only=True), strict=True)
    load_jax_params(ref, jax.tree.map(lambda x: np.array(x, np.float32), jax_tree))
    for name, value in ref.state_dict().items():
        assert torch.equal(ours.state_dict()[name], value), name
    served = WhisperASR("whisper-tiny", device="cpu", config=ours.config)
    serve.load_checkpoint(served, str(out))
    assert all(torch.equal(served.state_dict()[k], v) for k, v in ref.state_dict().items())


# -- monitor ---------------------------------------------------------------------------------


def test_monitor_reads_the_port_writer_and_matches_jax(tmp_path):
    from mocov2_whisper_flamingo_torch.tools import monitor
    from mocov2_whisper_flamingo_torch.utils.tb_writer import SummaryWriter
    from mocov2_whisper_flamingo_tpu.tools import monitor as jmonitor

    run_dir = str(tmp_path / "run")
    with SummaryWriter(run_dir) as w:
        for step in range(5):
            w.add_scalar("train/loss", 10.0 - step, step)
            w.add_scalar("train_attn_gate_0", 0.01 * step, step)
            w.add_scalar("val/wer", 1.0 - 0.1 * step, step)
            w.add_scalar("lr", 1e-4 * (step + 1), step)
    scalars = monitor.load_scalars(run_dir)
    assert scalars == jmonitor.load_scalars(run_dir)
    assert scalars["train/loss"][0] == (0, 10.0) and len(scalars["train/loss"]) == 5

    written = monitor.plot_training_curves(scalars, str(tmp_path / "plots"))
    assert {os.path.basename(p) for p in written} == {"losses.png", "gates.png", "wer.png",
                                                      "lr.png"}
    assert all(os.path.getsize(p) > 1000 for p in written)

    results = tmp_path / "results.txt"
    results.write_text("Pred: xin chao viet nam\nTarget: xin chao viet nam\n"
                       "Pred: toi la robot\nTarget: toi la nguoi\n"
                       "Pred: mot hai\nTarget: mot hai ba bon\n"
                       "Target: orphan target\n", encoding="utf-8")
    pairs = monitor.parse_results_file(str(results))
    assert pairs == jmonitor.parse_results_file(str(results)) and len(pairs) == 3
    report = monitor.analyze_predictions(pairs)
    assert report == jmonitor.analyze_predictions(pairs)
    assert report["worst_examples"][0]["pred"] == "mot hai" and 0 < report["corpus_wer"] < 1
    assert monitor.analyze_predictions([]) == {"n": 0}


# -- max_frame_count and smoke_test ------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 2])
def test_max_frame_count_matches_jax(tmp_path, workers):
    from mocov2_whisper_flamingo_torch.tools import max_frame_count
    from mocov2_whisper_flamingo_tpu.tools import max_frame_count as jmax_frame_count

    rng = np.random.default_rng(0)
    d = tmp_path / "vids"
    d.mkdir()
    for i, t in enumerate([10, 25, 17]):
        np.save(d / f"clip{i}.npy", rng.integers(0, 255, (t, 8, 8, 3), dtype=np.uint8))
    (d / "notes.txt").write_text("not a clip")
    report = max_frame_count.scan(str(tmp_path), workers=workers)
    assert report == jmax_frame_count.scan(str(tmp_path), workers=1)
    assert (report["n_videos"], report["max_frames"]) == (3, 25)
    assert report["max_file"].endswith("clip1.npy")
    assert max_frame_count.scan(str(tmp_path / "none")) == {"n_videos": 0, "max_frames": 0}


def test_smoke_test_reports_what_the_jax_tool_reports(tmp_path, monkeypatch, capsys):
    """tests/test_tools.py's dataset through both tools: the same batch
    count, keys and shapes (the seconds aside)."""
    import sys

    from mocov2_whisper_flamingo_torch.tools import smoke_test
    from mocov2_whisper_flamingo_tpu.tools import smoke_test as jsmoke_test

    rng = np.random.default_rng(0)
    vdir = tmp_path / "train" / "train_video_seg12s" / "s"
    tdir = tmp_path / "train" / "train_text_seg12s" / "s"
    vdir.mkdir(parents=True)
    tdir.mkdir(parents=True)
    for i in range(2):
        np.save(vdir / f"c{i}.npy", rng.integers(0, 255, (6, 32, 32, 3), dtype=np.uint8))
        with wave_mod.open(str(vdir / f"c{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.sin(np.arange(8000) / 10) * 20000).astype("<i2").tobytes())
        (tdir / f"c{i}.txt").write_text("hello")
    argv = ["--set", f"data.root_dir={tmp_path}", "--set", "data.max_frames=8",
            "--num-batches", "1"]

    def report(text):
        return re.sub(r"\(\d+\.\d+s\)", "(s)", text)

    assert smoke_test.main(argv) == 0
    ours = report(capsys.readouterr().out)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)  # the port has no device axis
    monkeypatch.setattr(sys, "argv", ["smoke_test", *argv])
    jsmoke_test.main()
    assert ours == report(capsys.readouterr().out)
    assert ours.startswith("train batches: 1\nbatch 0 (s): {") and "'video': (2, " in ours
