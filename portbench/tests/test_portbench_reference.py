"""The plain reference against the program at tiny widths on the CPU, both
in float32 from the same seed-made weights: the video pipeline, the encode
(MoCo frontend, Whisper encoder, fusion, bridge) and the teacher-forced
decoder. The program's tolerances here are float32 round-off through a few
layers."""

from __future__ import annotations

import torch

from portbench import inputs, weights
from portbench.reference import model as M
from portbench.reference import spec
from portbench.tests import tiny

CFG = {"whisper": tiny.TINY_WHISPER, "model": tiny.TINY_MODEL, "vocab_size": 51865,
       "mel_frames": 3000}


def _net():
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
    from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig

    m = tiny.TINY_MODEL
    net = AVWhisperNet("audiovisual", None, 96,
                       (m["d_model"], m["n_heads"], m["n_layers"], m["pe_max_len"],
                        m["fc_hidden_size"], m["dropout"]),
                       51865, precision=L.FP32, device="cpu",
                       whisper_config=WhisperConfig(**tiny.TINY_WHISPER))
    weights.fill_module(net, spec.model_parameters(CFG), 17)
    return net.eval()


def _close(a, b, tol):
    scale = b.abs().max().clamp_min(1e-6)
    return float((a - b).abs().max() / scale) < tol


def test_weights_are_the_seeds():
    a = weights.as_dict(spec.trunk_parameters(CFG), 17, "cpu")
    b = weights.as_dict(spec.trunk_parameters(CFG), 17, "cpu")
    c = weights.as_dict(spec.trunk_parameters(CFG), 18, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk.decoder.kernel"], c["trunk.decoder.kernel"])


def test_video_pipeline_matches():
    from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline

    _, raw = inputs.clips(inputs.generator(3, "cpu"), 2, 3000, 80, 3, 88, "cpu")
    assert _close(eval_video_pipeline(raw, resize=64), M.video_pipeline(raw, 64), 1e-6)


def test_encode_and_decoder_match_the_program():
    net = _net()
    W = weights.as_dict(spec.model_parameters(CFG), 17, "cpu")
    mel, raw = inputs.clips(inputs.generator(4, "cpu"), 2, 3000, 80, 6, 88, "cpu")
    lens = torch.tensor([6, 4])
    batch = (mel, torch.ones(2, 3000, dtype=torch.bool), raw, torch.ones(2, 6, dtype=torch.bool),
             lens)
    with torch.no_grad():
        feats, valid = net.encode(batch, video_resize=64)
    ref, ref_valid = M.encode(M.FP32, W, CFG, mel, raw, lens, 64)
    assert torch.equal(valid, ref_valid)
    assert _close(feats, ref, 1e-4)
    tokens = torch.tensor([[50258, 50278, 50359, 50363, 11, 22, 33],
                           [50258, 50278, 50359, 50363, 44, 55, 66]])
    with torch.no_grad():
        logits = net.decoder(tokens, feats, encoder_valid=valid)
    assert _close(logits, M.decoder_logits(M.FP32, W, tiny.TINY_WHISPER, tokens, ref, valid), 1e-4)


def test_the_encode_reaches_the_tokens():
    """The check of served tokens covers the encoder side only if the
    logits depend on the clip: two clips give logits that differ by more
    than an eighth of their spread over the vocabulary, and the decoder
    does not merely repeat its last input token."""
    W = weights.as_dict(spec.model_parameters(CFG), 17, "cpu")
    mel, raw = inputs.clips(inputs.generator(5, "cpu"), 2, 3000, 80, 4, 88, "cpu")
    enc, valid = M.encode(M.FP32, W, CFG, mel, raw, torch.tensor([4, 4]), 64)
    tokens = torch.tensor([[50258, 50278, 50359, 50363]] * 2)
    logits = M.decoder_logits(M.FP32, W, tiny.TINY_WHISPER, tokens, enc, valid)
    assert logits[0, -1].argmax() != logits[1, -1].argmax() or \
        (logits[0, -1] - logits[1, -1]).abs().max() > logits[0, -1].std() / 8
    assert (logits[:, -1].argmax(-1) != tokens[:, -1]).all()
