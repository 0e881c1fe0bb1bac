"""The long-form rungs and the encode as compiled programs
(``decode/programs.py``) on the CPU, where a program runs its eager function:
``DecodePrograms.sample`` against ``sample_decode`` and the JAX sampler,
``decode_with_fallback(programs=...)`` against the JAX ladder with its
no-speech probe, a second ``WhisperASR.transcribe`` preparing and building
nothing, the encode programs against the eager encode with their keys, and
the K1 counts a CUDA graph's capture holds back. fp32, tiny configurations
from a seed; the card's side (graphs against the eager functions bit for
bit) is in ``tests/test_torch_kernels_cuda.py``.

Sampled rungs take JAX's own Gumbel draws (tests/longform_helpers.py), so
tokens are equal (tolerance 0); summed and average logprobs within
``LOGPROB_ATOL`` (fp32 sums of a dozen log-softmax values from two
frameworks), the no-speech probability within ``PROB_ATOL``. Program and
eager function run the same torch ops, so they are held bit for bit."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode import sampling as T
from mocov2_whisper_flamingo_torch.decode import streaming
from mocov2_whisper_flamingo_torch.decode.programs import DecodePrograms, encode_key
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_asr_params, random_jax_params)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline
from mocov2_whisper_flamingo_tpu.decode import sampling as J
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder

from longform_helpers import JaxDraws, lively
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)
EOS, NO_SPEECH = 3, 5
PREFIX = [1, 2]
MAX_LEN = 12
LOGPROB_ATOL = 1e-5
PROB_ATOL = 1e-6
CHUNK_SECONDS = 2 * CFG["max_source_positions"] * 160 / 16_000  # one window of 32 mel frames


@pytest.fixture(scope="module")
def setup():
    """One JAX decoder and its weights, the port's source decoder on them
    with its programs, and a batch of two encoder outputs."""
    jdec = JDecoder(JConfig(**CFG))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jdec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lively(tree, rng)
    source = load_jax_params(TDecoder(TConfig(**CFG), device="cpu"), tree)
    enc = rng.standard_normal((2, 16, 48)).astype(np.float32)
    return jdec, jax.tree.map(jnp.asarray, tree), DecodePrograms(source), enc


@pytest.mark.parametrize("temperature", [0.0, 0.7, 4.0])
def test_sample_program_equals_sample_decode_and_the_jax_sampler(setup, temperature):
    jdec, params, programs, enc = setup
    enc_t = torch.from_numpy(enc)
    kw = dict(temperature=temperature, num_samples=3, max_len=MAX_LEN, eos_id=EOS)
    decoder = programs.prepared_decoder()
    # the program and the eager loop with the same (default) draws, bit for bit
    got = programs.sample(enc_t, None, PREFIX, seed=4, **kw)
    want = T.sample_decode(decoder, enc_t, PREFIX, seed=4, **kw)
    for name in ("sequences", "sum_logprob", "avg_logprob"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # with JAX's draws, the JAX sampler's tokens
    key = jax.random.PRNGKey(5)
    jax_sample = jax.jit(lambda p, e, k: tuple(vars(J.sample_decode(
        jdec, p, e, PREFIX, k, **kw)).values()))
    seqs, sum_lp, avg_lp = jax_sample(params, jnp.asarray(enc), key)
    got = programs.sample(enc_t, None, PREFIX, draws=JaxDraws(key), **kw)
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(seqs))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(sum_lp),
                               atol=LOGPROB_ATOL, rtol=0)
    np.testing.assert_allclose(got.avg_logprob.numpy(), np.asarray(avg_lp),
                               atol=LOGPROB_ATOL, rtol=0)
    rows = {tuple(r) for r in got.sequences.numpy().reshape(-1, MAX_LEN)}
    assert (len(rows) > 1) == (temperature > 0)  # the draws matter, and only then


def test_fallback_through_programs_equals_the_jax_ladder_with_its_probe(setup):
    """The whole ladder (a logprob threshold no rung meets) with the probe at
    the second prefix token."""
    jdec, params, programs, enc = setup
    key = jax.random.PRNGKey(9)
    kw = dict(temperatures=(0.0, 0.5, 4.0), beam_size=2, best_of=3, max_len=MAX_LEN,
              eos_id=EOS, logprob_threshold=10.0, no_speech_id=NO_SPEECH, sot_index=1)
    want = J.decode_with_fallback(jdec, params, jnp.asarray(enc), PREFIX, key=key, **kw)
    decoder = programs.prepared_decoder()
    got = T.decode_with_fallback(decoder, torch.from_numpy(enc), PREFIX, draws=JaxDraws(key),
                                 programs=programs, **kw)
    for name in ("sequences", "temperature", "gates_passed", "compression_ratio"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.avg_logprob, want.avg_logprob, atol=LOGPROB_ATOL, rtol=0)
    np.testing.assert_allclose(got.no_speech_prob, want.no_speech_prob, atol=PROB_ATOL, rtol=0)
    assert (got.temperature == 4.0).all() and not got.gates_passed.any()
    with pytest.raises(ValueError, match="prepared decoders"):  # a decoder of no program
        T.decode_with_fallback(programs.decoder.prepare_decode_params(),
                               torch.from_numpy(enc), PREFIX, programs=programs, **kw)


def _tiny_asr() -> WhisperASR:
    asr = WhisperASR(config=TConfig(**CFG), device="cpu")
    tree = random_asr_params(asr, seed=2)
    lively(tree["decoder"], np.random.default_rng(2))
    return load_jax_params(asr, tree)


MODES = {
    "quality": dict(temperatures=(0.0, 0.6), beam_size=2, best_of=2, logprob_threshold=10.0,
                    no_speech_id=NO_SPEECH, no_speech_threshold=0.99, sot_id=PREFIX[0],
                    sot_prev_id=9, context_tokens=4),
    "streaming": dict(temperatures=None, beam_size=2, max_tokens_per_chunk=4),
}


@pytest.mark.parametrize("mode", MODES)
def test_a_second_transcribe_prepares_and_builds_nothing(mode, monkeypatch):
    asr = _tiny_asr()
    audio = (0.1 * np.random.default_rng(3).standard_normal(
        int(2.5 * CHUNK_SECONDS * 16_000))).astype(np.float32)
    counts = collections.Counter()
    prepare, stream_init = TDecoder.prepare_decode_params, streaming.StreamingDecoder.__init__

    def counting_prepare(self, *args, **kwargs):
        counts["prepare"] += 1
        return prepare(self, *args, **kwargs)

    def counting_stream_init(self, *args, **kwargs):
        counts["stream_decoder"] += 1
        stream_init(self, *args, **kwargs)

    monkeypatch.setattr(TDecoder, "prepare_decode_params", counting_prepare)
    monkeypatch.setattr(streaming.StreamingDecoder, "__init__", counting_stream_init)
    call = lambda: asr.transcribe(audio, PREFIX, max_len=16, eos_id=EOS,  # noqa: E731
                                  chunk_seconds=CHUNK_SECONDS, **MODES[mode])
    first = call()
    made = dict(counts)
    assert made == ({"prepare": 1} if mode == "quality" else
                    {"prepare": 1, "stream_decoder": 1})
    second = call()
    assert counts == made  # the second call prepared and built nothing
    assert second["tokens"] == first["tokens"] and first["tokens"]
    assert [s["tokens"] for s in second["segments"]] == [s["tokens"] for s in first["segments"]]


@pytest.fixture(scope="module")
def av_net():
    net = AVWhisperNet(modelargs=(32, 4, 1, 3000, 64, 0.0), vocab_size=CFG["vocab_size"],
                       device="cpu", whisper_config=TConfig(**CFG))
    load_jax_params(net, random_jax_params(net, seed=5))
    rng = np.random.default_rng(7)
    b, tv = 2, 4
    raw = torch.from_numpy(rng.integers(0, 255, (b, tv, 3, 40, 40), dtype=np.uint8))
    batch = (torch.from_numpy(rng.standard_normal((b, 80, 32)).astype(np.float32)),
             torch.ones((b, 32), dtype=torch.bool), raw,
             torch.ones((b, tv), dtype=torch.bool), torch.tensor([4, 3], dtype=torch.int32))
    return net, batch


def test_encode_programs_on_the_cpu_equal_the_eager_encode(av_net):
    net, batch = av_net
    video = eval_video_pipeline(batch[2], resize=32)
    eager_batch = batch[:2] + (video,) + batch[3:]
    fused, valid = net.trunk.fused_features(eager_batch)
    for got in (net.encode(batch, video_resize=32), net.encode(eager_batch)):
        assert torch.equal(got[0], net.bridge(fused)) and torch.equal(got[1], valid)
    asr = _tiny_asr()
    mel = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 80, 32))
                           .astype(np.float32))
    assert torch.equal(asr.encode(mel), asr.encoder(mel))
    assert net.encode_program.graphs == {} and asr.encode_program.graphs == {}


def test_encode_keys_follow_shapes_statics_backends_and_weight_addresses(av_net):
    net, batch = av_net
    modules = (net.trunk, net.bridge)
    key = lambda b=batch, **static: encode_key(modules, b, static)  # noqa: E731
    base = key(video_resize=32)
    assert key(video_resize=32) == base
    assert key(video_resize=64) != base
    assert key(batch[:2] + (batch[2][:1],) + batch[3:], video_resize=32) != base
    with torch.no_grad():  # an in-place update is read by the graph: same key
        net.bridge.kernel.mul_(1.0)
    assert key(video_resize=32) == base
    net.set_attention_backend("plain")
    assert key(video_resize=32) != base
    net.set_attention_backend("flash")
    assert key(video_resize=32) == base
    gate = net.trunk.fusion.layers[0].ff_gate
    gate.data = gate.data.clone()  # replaced by assignment: a new address
    assert key(video_resize=32) != base


def test_a_capture_holds_back_its_k1_launches_for_the_replays():
    fa.reset_launches()
    fa.credit(2, collections.Counter({"a": 2}))

    def launch_three():
        fa.credit(3, collections.Counter({"a": 1, "b": 2}))
        return "out"

    out, n, by_kernel = fa.uncounted(launch_three)
    assert (out, n, by_kernel) == ("out", 3, collections.Counter({"a": 1, "b": 2}))
    assert fa.launches == 2 and fa.launches_by_kernel == collections.Counter({"a": 2})
    fa.credit(n, by_kernel)  # one replay
    assert fa.launches == 5 and fa.launches_by_kernel == collections.Counter({"a": 3, "b": 2})
    with pytest.raises(RuntimeError):
        fa.uncounted(lambda: (fa.credit(1, collections.Counter({"c": 1})),
                              (_ for _ in ()).throw(RuntimeError("capture failed"))))
    assert fa.launches == 5 and "c" not in fa.launches_by_kernel
    fa.reset_launches()
