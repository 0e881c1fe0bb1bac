"""The port's word timestamps (``decode/timestamps.py``) and
``WhisperASR.transcribe`` against the JAX package's on the CPU, fp32, at
tiny configurations, on the same weights through the bridge.

The numpy half (median filter, alignment matrix) within ``MATRIX_ATOL``; the
DTW path, the word split and the punctuation merge equal; token and word
times equal (multiples of 0.02 s: one alignment forward of each framework
feeds the same DP). ``WhisperASR.transcribe`` in quality mode, with word
times, an initial prompt and language detection: text, segments and words
equal, ``avg_logprob`` within ``LOGPROB_ATOL``, language probabilities
within ``PROB_ATOL``; its sampled rungs take JAX's draws
(tests/longform_helpers.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.datamodule import native
from mocov2_whisper_flamingo_torch.decode import timestamps as T
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR as TASR
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_torch.tools.transcribe import default_group_fn
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer as TTok
from mocov2_whisper_flamingo_tpu.decode import timestamps as J
from mocov2_whisper_flamingo_tpu.models.asr import WhisperASR as JASR
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.tools.transcribe import default_group_fn as jax_group_fn
from mocov2_whisper_flamingo_tpu.utils.tokenizer import ByteTokenizer as JTok

from longform_helpers import JaxDraws, lively
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

MATRIX_ATOL = 1e-12
LOGPROB_ATOL = 1e-5
PROB_ATOL = 1e-6


# -- the numpy half -----------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 3, 7])
def test_median_filter_matches_jax(width):
    x = np.random.default_rng(width).standard_normal((3, 5, 40))
    np.testing.assert_allclose(T.median_filter(x, width), J.median_filter(x, width),
                               atol=MATRIX_ATOL, rtol=0)


@pytest.mark.parametrize("heads", [None, [(0, 1), (1, 3), (1, 0)]], ids=["default", "listed"])
@pytest.mark.parametrize("n_frames", [None, 17])
def test_alignment_matrix_matches_jax(heads, n_frames):
    w = np.random.default_rng(3).random((2, 2, 4, 9, 25)).astype(np.float32)
    for example in (0, 1):
        got = T.alignment_matrix(w, heads, 7, example=example, n_frames=n_frames)
        want = J.alignment_matrix(w, heads, 7, example=example, n_frames=n_frames)
        assert got.shape == want.shape == (9, n_frames or 25)
        np.testing.assert_allclose(got, want, atol=MATRIX_ATOL, rtol=0)
    assert T.default_alignment_heads(6, 4) == J.default_alignment_heads(6, 4)


DTW_CASES = {
    "1x1": (1, 1), "1x9": (1, 9), "9x1": (9, 1), "12x30": (12, 30), "40x25": (40, 25),
    "ties": "zeros", "row_ties": "rows",
}


@pytest.mark.parametrize("name", DTW_CASES)
def test_dtw_matches_jax_numpy_path(name):
    rng = np.random.default_rng(7)
    case = DTW_CASES[name]
    if case == "zeros":
        cost = np.zeros((6, 6))
    elif case == "rows":
        cost = np.tile(rng.standard_normal(8), (5, 1))
    else:
        cost = rng.standard_normal(case)
    got = T.dtw(cost)
    want = J._dtw_numpy(cost)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], native.plain_dtw(cost)[0])


VIETNAMESE = {
    "greeting": "xin chào các bạn, hôm nay trời đẹp quá!",
    "quotes": 'anh ấy nói: "tôi sẽ đến" (ngày mai).',
    "tones": "Người Việt ở Hà Nội, Huế và Sài Gòn?",
}


@pytest.mark.parametrize("name", VIETNAMESE)
def test_word_split_and_merge_match_jax_on_vietnamese(name):
    text = VIETNAMESE[name]
    ttok, jtok = TTok(), JTok()
    ids = ttok.encode(text, add_special_tokens=False)
    assert ids == jtok.encode(text, add_special_tokens=False)
    for cut in (len(ids), len(ids) - 1):  # whole, and with the last byte cut off
        assert T.split_tokens_on_unicode(ttok, ids[:cut]) == \
            J.split_tokens_on_unicode(jtok, ids[:cut])
        assert T.split_tokens_on_spaces(ttok, ids[:cut]) == \
            J.split_tokens_on_spaces(jtok, ids[:cut])
    assert default_group_fn(ttok)(ids) == jax_group_fn(jtok)(ids)
    words = [(w, toks) for w, toks in T.split_tokens_on_spaces(ttok, ids)]
    timed = [T.WordTiming(w, 0.1 * i, 0.1 * i + 0.05, toks) for i, (w, toks) in enumerate(words)]
    jtimed = [J.WordTiming(w.word, w.start, w.end, list(w.tokens)) for w in timed]
    got = T.merge_punctuations(timed)
    want = J.merge_punctuations(jtimed)
    assert [dict(vars(w)) for w in got] == [dict(vars(w)) for w in want]
    assert len(got) < len(timed)  # some punctuation merged


# -- token and word times through the decoder --------------------------------------------

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)


@pytest.fixture(scope="module")
def decoders():
    jdec = JDecoder(JConfig(**CFG))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jdec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lively(tree, rng)
    for layer in tree["layers"]:  # sharper cross-attention: alignments that differ
        layer["cross_attn"]["q"]["kernel"] *= np.float32(8.0)
    tdec = load_jax_params(TDecoder(TConfig(**CFG), device="cpu"), tree).prepare_decode_params()
    enc = rng.standard_normal((1, 16, 48)).astype(np.float32)
    return jdec, jax.tree.map(jnp.asarray, tree), tdec, enc


TOKEN_CASES = {
    "plain": dict(),
    "prefix_eos": dict(n_prefix=2, n_drop_last=1),
    "frames_heads": dict(n_prefix=2, n_drop_last=1, n_frames=11,
                         alignment_heads=[(0, 2), (1, 1)], medfilt_width=3),
    "padded": dict(n_prefix=2, n_drop_last=1, pad_tokens_to=32, pad_id=3),
}


@pytest.mark.parametrize("name", TOKEN_CASES)
def test_token_timestamps_match_jax(decoders, name):
    jdec, params, tdec, enc = decoders
    tokens = [1, 2, 10, 11, 12, 30, 7, 44, 3]
    kw = TOKEN_CASES[name]
    want = J.token_timestamps(jdec, params, tokens, jnp.asarray(enc), **kw)
    got = T.token_timestamps(tdec, tokens, torch.from_numpy(enc), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(set(np.concatenate(got).tolist())) > 2  # not one frame for all


@pytest.mark.parametrize("merge", [True, False])
def test_word_timestamps_match_jax(decoders, merge):
    jdec, params, tdec, enc = decoders
    tokens = [1, 2, 10, 11, 12, 30, 7, 44, 3]

    def group_fn(text):
        return [("hi", 2), (",", 1), (" em", 2), ('"', 1)]

    punct = {} if merge else dict(prepend_punctuations=None, append_punctuations=None)
    kw = dict(n_prefix=2, n_text=6, n_frames=14, pad_tokens_to=16, pad_id=3, **punct)
    want = J.word_timestamps(jdec, params, tokens, jnp.asarray(enc), group_fn, **kw)
    got = T.word_timestamps(tdec, tokens, torch.from_numpy(enc), group_fn, **kw)
    assert [dict(vars(w)) for w in got] == [dict(vars(w)) for w in want]
    assert len(got) == (2 if merge else 4)


# -- WhisperASR.transcribe ---------------------------------------------------------------

ASR_CFG = dict(CFG, vocab_size=262)  # the byte tokenizer's vocabulary
CHUNK_SECONDS = 2 * ASR_CFG["max_source_positions"] * 160 / 16_000
TRANSCRIBE = dict(beam_size=2, max_len=20, eos_id=0, chunk_seconds=CHUNK_SECONDS,
                  temperatures=(0.0, 0.4), best_of=2, logprob_threshold=-0.67,
                  context_tokens=6, sot_prev_id=5, initial_prompt="xin chào",
                  detect_language_ids=[2, 40, 41, 60], word_times=True)


def _transcribe_both(weight_quant=None, windows=3.4):
    """One JAX and one port ``transcribe`` of the same audio (by default
    1.1 s, four windows), with the byte tokenizer of each package."""
    jasr = JASR(config=JConfig(**ASR_CFG), backend="xla")
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jasr.init(jax.random.PRNGKey(6)))
    rng = np.random.default_rng(6)
    lively(tree["decoder"], rng)
    tree["encoder"]["conv1"]["kernel"] *= np.float32(8.0)
    for layer in tree["decoder"]["layers"]:
        layer["cross_attn"]["q"]["kernel"] *= np.float32(8.0)
        layer["cross_attn"]["v"]["kernel"] *= np.float32(16.0)
    tasr = load_jax_params(TASR(config=TConfig(**ASR_CFG), device="cpu"), tree)
    audio = (0.3 * rng.standard_normal(int(windows * CHUNK_SECONDS * 16_000))).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jtok, ttok = JTok(), TTok()
    want = jasr.transcribe(jax.tree.map(jnp.asarray, tree), jnp.asarray(audio),
                           jtok.prefix_token_ids, tokenizer=jtok,
                           group_fn=jax_group_fn(jtok), key=key, weight_quant=weight_quant,
                           **TRANSCRIBE)
    got = tasr.transcribe(audio, ttok.prefix_token_ids, tokenizer=ttok,
                          group_fn=default_group_fn(ttok), draws=JaxDraws(key),
                          weight_quant=weight_quant, **TRANSCRIBE)
    return got, want


@pytest.fixture(scope="module")
def transcribed():
    return _transcribe_both()


def test_transcribe_matches_jax(transcribed):
    _assert_same_transcript(*transcribed)


def test_int8_transcribe_matches_jax():
    """``weight_quant="int8"``: one int8 decoder serves the decode rungs, the
    language probe and the word-time alignment forward, in both packages."""
    got, want = _transcribe_both("int8", windows=1.4)
    _assert_same_transcript(got, want, n_segments=2)
    assert got["words"]


def _assert_same_transcript(got, want, n_segments=4):
    assert got.keys() == want.keys()
    assert got["tokens"] == [int(t) for t in want["tokens"]] and got["text"] == want["text"]
    assert got["language"] == want["language"]
    assert got["language_probs"].keys() == want["language_probs"].keys()
    for t, p in want["language_probs"].items():
        assert got["language_probs"][t] == pytest.approx(p, abs=PROB_ATOL)
    assert len(got["segments"]) == len(want["segments"]) == n_segments
    for s, w in zip(got["segments"], want["segments"]):
        assert s.keys() == w.keys()
        for name in ("id", "start", "end", "seek", "text", "temperature", "compression_ratio",
                     "gates_passed"):
            assert s[name] == w[name], name
        assert s["tokens"] == [int(t) for t in w["tokens"]]
        assert s["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=LOGPROB_ATOL)
    assert [dict(vars(w)) for w in got["words"]] == [dict(vars(w)) for w in want["words"]]


def test_transcribe_covers_its_options(transcribed):
    """What the parity above exercises: a sampled window and a t = 0 one,
    the detected language in the prefix, words in every window, and word
    times offset into their window."""
    got, _ = transcribed
    temps = {s["temperature"] for s in got["segments"]}
    assert temps == {0.0, 0.4}
    assert got["language"] in TRANSCRIBE["detect_language_ids"]
    origins = sorted({s["seek"] for s in got["segments"]})
    for w in got["words"]:
        origin = max(o for o in origins if o <= w.start + 1e-9)
        assert origin <= w.start <= w.end <= origin + CHUNK_SECONDS + 1e-9
    assert len({max(o for o in origins if o <= w.start + 1e-9) for w in got["words"]}) == 4


def test_transcribe_argument_errors(transcribed):
    from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer

    tasr = TASR(config=TConfig(**ASR_CFG), device="cpu")
    audio = np.zeros(4000, np.float32)
    prefix = ByteTokenizer().prefix_token_ids
    with pytest.raises(ValueError, match="not both"):
        tasr.transcribe(audio, prefix, tokenizer=ByteTokenizer(), initial_prompt="a",
                        initial_prompt_ids=[7])
    with pytest.raises(ValueError, match="needs a tokenizer"):
        tasr.transcribe(audio, prefix, initial_prompt="a")
    with pytest.raises(ValueError, match="group_fn"):
        tasr.transcribe(audio, prefix, word_times=True, chunk_seconds=CHUNK_SECONDS,
                        temperatures=(0.0,), max_len=8, eos_id=0)
