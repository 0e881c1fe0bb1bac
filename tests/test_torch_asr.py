"""The port's audio-only path (``models/asr.py::WhisperASR``), the
teacher-forced decoder and ``AVWhisperNet.decoder_logits`` against the JAX
package on the CPU in fp32, at a tiny configuration, on the same weights
(one numpy tree loaded into both) and the same inputs made from a seed.

JAX references run jitted, on the XLA attention backend; where the port's
decoder goes through the flash-attention wrapper it takes the kernel's plain
version here (CPU tensors). Tolerances: ``MODULE_ATOL`` for one module's fp32
output, ``SLICE_ATOL`` for logits after a whole decoder (the values
``tests/test_torch_av_whisper.py`` uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models.asr import WhisperASR as TASR
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet as TNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_asr_params, random_jax_params)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_tpu.models.asr import WhisperASR as JASR
from mocov2_whisper_flamingo_tpu.models.av_whisper import AVWhisperNet as JNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder

VOCAB, EOS = 96, 20  # EOS: a token the random decoder emits mid-sequence
PREFIX = [1, 2]
TINY = dict(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=2, n_heads=2, d_ff=128,
            vocab_size=VOCAB, max_source_positions=16, max_target_positions=24)
N_SAMPLES = 32 * 160  # 32 mel frames = 2 * max_source_positions
MAX_LEN = 12
MODULE_ATOL = 1e-5
SLICE_ATOL = 1e-4
PROB_ATOL = 1e-5


def _lively(tree_decoder: dict, rng) -> None:
    """Position embeddings larger than the token embeddings keep a random
    decoder from copying its input token: it emits varied tokens and EOS."""
    tree_decoder["pos_embed"] = 4.0 * rng.standard_normal(
        tree_decoder["pos_embed"].shape).astype(np.float32)
    tree_decoder["embed_tokens"]["embedding"] *= np.float32(0.5)


@pytest.fixture(scope="module")
def pair():
    tasr = TASR(config=TConfig(**TINY), device="cpu")
    tree = random_asr_params(tasr, seed=11)
    rng = np.random.default_rng(12)
    _lively(tree["decoder"], rng)
    load_jax_params(tasr, tree)
    jasr = JASR(config=JConfig(**TINY), backend="xla")
    params = jax.tree.map(jnp.asarray, tree)
    wavs = (0.1 * rng.standard_normal((3, N_SAMPLES))).astype(np.float32)
    return tasr, jasr, params, tree, wavs


def test_random_asr_params_have_the_jax_tree_layout(pair):
    tasr, jasr, _, tree, _ = pair
    init = jasr.init(jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(init)):
        assert a.shape == b.shape and a.dtype == np.float32
    assert not any(p.requires_grad for p in tasr.parameters())


def test_features_match_jax(pair):
    tasr, jasr, _, _, wavs = pair
    for audio, pad_to in ((wavs, N_SAMPLES), (wavs[0], N_SAMPLES), (wavs[:, :3000], N_SAMPLES)):
        ours = tasr.features(audio, pad_to=pad_to).numpy()
        ref = np.asarray(jasr.features(jnp.asarray(audio), pad_to=pad_to))
        assert ours.shape == ref.shape and ours.ndim == 3
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)  # test_torch_mel's log-mel atol


def test_encode_matches_jax(pair):
    tasr, jasr, params, _, wavs = pair
    mel = np.array(jasr.features(jnp.asarray(wavs), pad_to=N_SAMPLES))
    ours = tasr.encode(torch.from_numpy(mel)).numpy()
    ref = np.asarray(jax.jit(jasr.encode)(params, jnp.asarray(mel)))
    assert ours.shape == (3, 16, TINY["d_model"])
    np.testing.assert_allclose(ours, ref, atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_transcribe_tokens_match_jax(pair, beam_size):
    tasr, jasr, params, _, wavs = pair
    run_ref = jax.jit(lambda p, a: jasr.transcribe_tokens(
        p, a, PREFIX, beam_size=beam_size, max_len=MAX_LEN, eos_id=EOS, pad_to=N_SAMPLES))
    ours = tasr.transcribe_tokens(wavs, PREFIX, beam_size=beam_size, max_len=MAX_LEN,
                                  eos_id=EOS, pad_to=N_SAMPLES)
    assert tuple(ours.shape) == (3, MAX_LEN)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(run_ref(params, jnp.asarray(wavs))))
    assert len(np.unique(ours.numpy()[:, len(PREFIX):])) > 2  # not degenerate


def test_transcribe_tokens_with_rules_match_jax(pair):
    from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules as TRules
    from mocov2_whisper_flamingo_tpu.decode.logit_rules import LogitRules as JRules

    tasr, jasr, params, _, wavs = pair
    kwargs = dict(vocab_size=VOCAB, suppress=(5, 9, 33), begin_suppress=(EOS, 7), eos_id=EOS)
    run_ref = jax.jit(lambda p, a: jasr.transcribe_tokens(
        p, a, PREFIX, beam_size=3, max_len=MAX_LEN, eos_id=EOS, pad_to=N_SAMPLES,
        logit_rules=JRules(**kwargs)))
    ours = tasr.transcribe_tokens(wavs, PREFIX, beam_size=3, max_len=MAX_LEN, eos_id=EOS,
                                  pad_to=N_SAMPLES, logit_rules=TRules(**kwargs))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(run_ref(params, jnp.asarray(wavs))))
    assert not np.isin(ours.numpy()[:, len(PREFIX):], [5, 9, 33]).any()


def test_detect_language_matches_jax(pair):
    tasr, jasr, params, _, wavs = pair
    lang_ids = [40, 41, 47, 52]
    best_ref, probs_ref = jax.jit(lambda p, a: jasr.detect_language(
        p, a, PREFIX[0], lang_ids, pad_to=N_SAMPLES))(params, jnp.asarray(wavs))
    best, probs = tasr.detect_language(wavs, PREFIX[0], lang_ids, pad_to=N_SAMPLES)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_ref))
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref), atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(probs.sum(dim=-1).numpy(), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="non-empty"):
        tasr.detect_language(wavs, PREFIX[0], [], pad_to=N_SAMPLES)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_int8_transcribe_tokens_match_jax(pair, beam_size):
    """``weight_quant="int8"``: one int8 decoder for the greedy or beam
    decode, tokens equal to the JAX package's."""
    tasr, jasr, params, _, wavs = pair
    run_ref = jax.jit(lambda p, a: jasr.transcribe_tokens(
        p, a, PREFIX, beam_size=beam_size, max_len=MAX_LEN, eos_id=EOS, pad_to=N_SAMPLES,
        weight_quant="int8"))
    ours = tasr.transcribe_tokens(wavs, PREFIX, beam_size=beam_size, max_len=MAX_LEN,
                                  eos_id=EOS, pad_to=N_SAMPLES, weight_quant="int8")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(run_ref(params, jnp.asarray(wavs))))
    assert len(np.unique(ours.numpy()[:, len(PREFIX):])) > 2


def test_load_whisper_torch_matches_hf():
    """An HF state dict goes through the port's converters into the port's
    model (and the same tree into the JAX model): encoder output and decoder
    logits agree with the ``transformers`` modules."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WhisperConfig(
        vocab_size=VOCAB, num_mel_bins=80, encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2, d_model=64, encoder_ffn_dim=128,
        decoder_ffn_dim=128, max_source_positions=16, max_target_positions=24,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)
    torch.manual_seed(0)
    hf = transformers.WhisperModel(hf_cfg).eval()
    tasr = TASR(config=TConfig(**TINY), device="cpu").load_whisper_torch(hf.state_dict())

    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 80, 32)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, (2, 9))
    with torch.no_grad():
        enc_ref = hf.encoder(torch.from_numpy(mel)).last_hidden_state
        hid_ref = hf.decoder(input_ids=torch.from_numpy(tokens),
                             encoder_hidden_states=enc_ref).last_hidden_state
        logits_ref = hid_ref @ hf.decoder.embed_tokens.weight.T
        enc = tasr.encode(torch.from_numpy(mel))
        logits = tasr.decoder(torch.from_numpy(tokens), enc)
    np.testing.assert_allclose(enc.numpy(), enc_ref.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), logits_ref.numpy(), atol=SLICE_ATOL, rtol=1e-4)

    # the same numpy trees load into the JAX model
    from mocov2_whisper_flamingo_torch.models.convert import (
        whisper_decoder_from_torch, whisper_encoder_from_torch)

    jasr = JASR(config=JConfig(**TINY), backend="xla")
    jparams = jasr.load_whisper_torch(hf.state_dict())
    ours = {"encoder": whisper_encoder_from_torch(hf.state_dict(), 2),
            "decoder": whisper_decoder_from_torch(hf.state_dict(), 2)}
    assert jax.tree.structure(ours) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- the teacher-forced decoder ----------------------------------------------------------


@pytest.fixture(scope="module")
def forced(pair):
    tasr, jasr, params, _, _ = pair
    rng = np.random.default_rng(13)
    enc = rng.standard_normal((3, 16, TINY["d_model"])).astype(np.float32)
    tokens = rng.integers(0, VOCAB, (3, 10))
    valid = np.arange(16)[None, :] < np.array([16, 9, 1])[:, None]
    return tasr.decoder, jasr.decoder, params["decoder"], enc, tokens, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("prepared", [False, True])
def test_teacher_forced_logits_match_jax(forced, masked, prepared):
    tdec, jdec, jparams, enc, tokens, valid = forced
    valid = valid if masked else None
    ref = jax.jit(jdec.apply)(jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(enc),
                              None if valid is None else jnp.asarray(valid))
    dec = tdec.prepare_decode_params() if prepared else tdec
    with torch.no_grad():
        ours = dec(torch.from_numpy(tokens), torch.from_numpy(enc),
                   None if valid is None else torch.from_numpy(valid))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (3, 10, VOCAB)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=SLICE_ATOL, rtol=0)


def test_cross_weights_match_jax(forced):
    tdec, jdec, jparams, enc, tokens, valid = forced
    logits_ref, w_ref = jax.jit(lambda p, t, e, v: jdec.apply(
        p, t, e, v, return_cross_weights=True))(
            jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(enc), jnp.asarray(valid))
    with torch.no_grad():
        logits, w = tdec(torch.from_numpy(tokens), torch.from_numpy(enc),
                         torch.from_numpy(valid), return_cross_weights=True)
        plain = tdec(torch.from_numpy(tokens), torch.from_numpy(enc), torch.from_numpy(valid))
    assert tuple(w.shape) == (2, 3, 2, 10, 16) and w.dtype == torch.float32
    np.testing.assert_allclose(w.sum(dim=-1).numpy(), 1.0, atol=1e-5)
    assert float(w[:, 1, :, :, 9:].abs().max()) == 0.0  # masked keys get no weight
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=MODULE_ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=SLICE_ATOL, rtol=0)
    # the explicit cross path and the kernel path give the same logits
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), atol=SLICE_ATOL, rtol=0)


def test_teacher_forced_logits_equal_decode_steps(forced):
    """Position i of the teacher-forced pass is step i of the cached decode."""
    tdec, _, _, enc, tokens, valid = forced
    dec = tdec.prepare_decode_params()
    enc_t, valid_t, tok_t = (torch.from_numpy(x) for x in (enc, valid, tokens))
    with torch.no_grad():
        full = dec(tok_t, enc_t, valid_t)
    cache = dec.init_cache(enc_t, max_len=tokens.shape[1])
    for i in range(tokens.shape[1]):
        step, cache = dec.decode_step(tok_t[:, i:i + 1], cache, i, valid_t)
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(), atol=SLICE_ATOL, rtol=0)


def test_teacher_forced_pass_is_differentiable(forced):
    """The pass builds a graph through the flash-attention wrapper's
    recompute backward (causal and cross) when its input needs a gradient."""
    tdec, _, _, enc, tokens, valid = forced
    enc_t = torch.from_numpy(enc).requires_grad_()
    logits = tdec(torch.from_numpy(tokens), enc_t, torch.from_numpy(valid))
    (grad,) = torch.autograd.grad(logits.square().mean(), enc_t)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
    assert float(grad[1, 9:].abs().max()) == 0.0  # masked encoder frames get no gradient


# -- AVWhisperNet.decoder_logits -------------------------------------------------------------


def test_av_decoder_logits_match_jax():
    modelargs = (32, 4, 2, 3000, 128, 0.0)
    tiny = dict(TINY, max_source_positions=64)
    tnet = TNet(modelargs=modelargs, vocab_size=VOCAB, device="cpu",
                whisper_config=TConfig(**tiny))
    tree = random_jax_params(tnet, seed=14)
    for layer in tree["trunk"]["fusion"]["layers"]:
        layer["attn_gate"], layer["ff_gate"] = np.float32(0.5), np.float32(-0.3)
    load_jax_params(tnet, tree)
    jnet = JNet(modelargs=modelargs, vocab_size=VOCAB, whisper_name="whisper-tiny",
                backend="xla")
    cfg = JConfig(**tiny)
    jnet.whisper_config = jnet.trunk.whisper_config = cfg
    jnet.trunk.whisper_encoder = JEncoder(cfg, jnet.trunk.precision, "xla")
    jnet.decoder = JDecoder(cfg, jnet.precision, "xla")
    params = jax.tree.map(jnp.asarray, tree)

    rng = np.random.default_rng(15)
    b, tv = 3, 6
    audio = rng.standard_normal((b, 80, 128)).astype(np.float32)
    video = rng.standard_normal((b, tv, 3, 32, 32)).astype(np.float32)
    lens = np.array([6, 4, 1], np.int32)
    target = rng.integers(0, VOCAB, (b, 9))
    jbatch = (jnp.asarray(audio), jnp.ones((b, 128), bool), jnp.asarray(video),
              jnp.ones((b, tv), bool), jnp.asarray(lens))
    tbatch = (torch.from_numpy(audio), torch.ones((b, 128), dtype=torch.bool),
              torch.from_numpy(video), torch.ones((b, tv), dtype=torch.bool),
              torch.from_numpy(lens))
    ref = jax.jit(jnet.decoder_logits)(params, jbatch, jnp.asarray(target, jnp.int32))
    ours = tnet.decoder_logits(tbatch, torch.from_numpy(target))
    assert tuple(ours.shape) == (b, 9, VOCAB) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=SLICE_ATOL, rtol=0)
