"""``transcribe_long_form``'s quality mode (``decode/streaming.py``) against
the JAX package's on the CPU, fp32, at a tiny configuration (0.32 s
windows), on the same weights through the bridge: the fixed-stride window
loop with the temperature ladder and text conditioning, and the no-speech
skip with its confidence override. Sampled rungs take JAX's own Gumbel draws
(tests/longform_helpers.py) along the window -> temperature -> step fold chain.
Tokens, segments, seek origins, temperatures, ``gates_passed`` and
compression ratios equal (tolerance 0); ``avg_logprob`` and
``no_speech_prob`` within ``LOGPROB_ATOL`` / ``PROB_ATOL``. The JAX
references run once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode import streaming
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR as TASR
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_tpu.decode.streaming import (
    transcribe_long_form as jax_transcribe_long_form)
from mocov2_whisper_flamingo_tpu.models.asr import WhisperASR as JASR
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig

from longform_helpers import JaxDraws, lively, window_mel

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)
N_FRAMES = 2 * CFG["max_source_positions"]
CHUNK_SECONDS = N_FRAMES * 160 / 16_000
EOS, PREFIX, SOT_PREV, PROMPT = 20, [1, 2], 9, [30, 31]
LOGPROB_ATOL = 1e-5
PROB_ATOL = 1e-6
NO_SPEECH = 0.01
COMMON = dict(eos_id=EOS, chunk_seconds=CHUNK_SECONDS, max_len=16, beam_size=2, best_of=3,
              return_segments=True)
MODES = {
    # windows 0 and 3 pass at t = 0, the others climb the ladder (a window
    # above t = 0.5 stops the conditioning); context from the prompt and
    # the committed tokens
    "fixed_stride": dict(temperatures=(0.0, 0.3, 0.6), logprob_threshold=-0.5,
                         context_tokens=4, sot_prev_id=SOT_PREV, initial_prompt_ids=PROMPT),
    # the no-speech probe at the SOT token (found behind the context), a
    # skip threshold that some windows exceed, and the avg-logprob override
    "no_speech": dict(temperatures=(0.0, 0.6), logprob_threshold=-0.5, context_tokens=4,
                      sot_prev_id=SOT_PREV, initial_prompt_ids=PROMPT, no_speech_id=5,
                      sot_id=PREFIX[0], no_speech_threshold=NO_SPEECH),
}


@pytest.fixture(scope="module")
def runs():
    """Both frameworks' results in each mode, and the port's model."""
    jasr = JASR(config=JConfig(**CFG), backend="xla")
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jasr.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(2)
    lively(tree["decoder"], rng)
    for layer in tree["decoder"]["layers"]:  # a decoder that listens to its audio
        layer["cross_attn"]["q"]["kernel"] *= np.float32(8.0)
        layer["cross_attn"]["v"]["kernel"] *= np.float32(16.0)
    tasr = load_jax_params(TASR(config=TConfig(**CFG), device="cpu"), tree)
    params = jax.tree.map(jnp.asarray, tree)
    audio = rng.standard_normal(int(3.3 * CHUNK_SECONDS * 16_000)).astype(np.float32)
    decoder = tasr.decoder.prepare_decode_params()
    key = jax.random.PRNGKey(0)  # the JAX default key
    out = {}
    for name, kw in MODES.items():
        want = jax_transcribe_long_form(
            jasr.encoder, jasr.decoder, params["encoder"], params["decoder"],
            jnp.asarray(audio), PREFIX, mel_fn=lambda w: jnp.asarray(window_mel(w, N_FRAMES)),
            **COMMON, **kw)
        got = streaming.transcribe_long_form(
            tasr.encoder, decoder, audio, PREFIX, mel_fn=lambda w: torch.from_numpy(window_mel(w, N_FRAMES)),
            draws=JaxDraws(key), **COMMON, **kw)
        out[name] = (got, want)
    return out, tasr, decoder, audio


def _assert_same(got, want):
    tokens, segs = got
    want_tokens, want_segs = want
    assert tokens == [int(t) for t in want_tokens]
    assert len(segs) == len(want_segs)
    for s, w in zip(segs, want_segs):
        assert s.keys() == w.keys()
        assert s["tokens"] == [int(t) for t in w["tokens"]]
        for name in ("id", "start", "end", "seek", "temperature", "compression_ratio",
                     "gates_passed"):
            assert s[name] == w[name], name
        assert s["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=LOGPROB_ATOL)
        if "no_speech_prob" in w:
            assert s["no_speech_prob"] == pytest.approx(w["no_speech_prob"], abs=PROB_ATOL)
    assert [t for s in segs for t in s["tokens"]] == tokens


@pytest.mark.parametrize("mode", MODES)
def test_quality_mode_matches_jax(runs, mode):
    results, *_ = runs
    _assert_same(*results[mode])


def test_fixed_stride_windows_climb_and_condition(runs):
    """What the fixed-stride parity covers: four windows at fixed origins,
    some passing at t = 0 and some sampled, the last window clipped to the
    audio."""
    results, *_, audio = runs
    _, segs = results["fixed_stride"][0]
    assert [s["seek"] for s in segs] == pytest.approx([i * CHUNK_SECONDS for i in range(4)])
    temps = [s["temperature"] for s in segs]
    assert 0.0 in temps and any(t > 0 for t in temps)
    assert segs[-1]["end"] == pytest.approx(len(audio) / 16_000)


def test_no_speech_skips_and_overrides(runs):
    """Some windows are skipped as silence, some above the threshold are kept
    by their confident decode, and the rest are under it."""
    results, *_ = runs
    _, segs = results["no_speech"][0]
    kept = {round(s["seek"] / CHUNK_SECONDS) for s in segs}
    assert 0 < len(kept) < 4
    probs = [s["no_speech_prob"] for s in segs]
    overridden = [s for s, p in zip(segs, probs) if p > NO_SPEECH]
    assert overridden and all(s["avg_logprob"] > -0.5 for s in overridden)
    assert any(p <= NO_SPEECH for p in probs)


def test_window_prefixes_carry_prompt_context_and_reset(runs, monkeypatch):
    """The window prefixes that the loop hands ``decode_with_fallback``:
    ``sot_prev`` + the initial prompt + a power-of-two tail of the committed
    transcript, clamped to half the budget (max_len // 2 - len(prefix) - 1
    tokens), + the prefix; after a window above t = 0.5 the transcript part
    starts again empty; each window draws from ``draws.fold(w)``."""
    results, tasr, decoder, audio = runs
    seen = []
    real = streaming.decode_with_fallback

    def spy(dec, enc, window_prefix, **kw):
        seen.append((list(window_prefix), kw["draws"].path))
        return real(dec, enc, window_prefix, **kw)

    monkeypatch.setattr(streaming, "decode_with_fallback", spy)
    got = streaming.transcribe_long_form(
        tasr.encoder, decoder, audio, PREFIX, mel_fn=lambda w: torch.from_numpy(window_mel(w, N_FRAMES)),
        seed=3, **COMMON, **MODES["fixed_stride"])
    _, segs = got
    assert [path for _, path in seen] == [(w,) for w in range(4)]
    assert any(len(prefix) > 1 + len(PROMPT) + len(PREFIX) for prefix, _ in seen)  # context
    committed = []
    reset_since = 0
    for (prefix, _), seg in zip(seen, segs):
        pool = committed[reset_since:][-4:]
        pool = pool[-(1 << (len(pool).bit_length() - 1)):] if pool else []
        ctx = (PROMPT + pool)[-(COMMON["max_len"] // 2 - len(PREFIX) - 1):]
        assert prefix == [SOT_PREV] + ctx + PREFIX
        committed += seg["tokens"]
        if seg["temperature"] > 0.5:
            reset_since = len(committed)
    # seeded default draws: the same result again
    assert streaming.transcribe_long_form(
        tasr.encoder, decoder, audio, PREFIX, mel_fn=lambda w: torch.from_numpy(window_mel(w, N_FRAMES)),
        seed=3, **COMMON, **MODES["fixed_stride"]) == got
