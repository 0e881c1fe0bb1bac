"""The port's timestamp segmentation (``decode/segments.py``) against the JAX
package's on token lists drawn by hypothesis (equal, tolerance 0), and
``transcribe_long_form``'s quality mode with timestamp seek against the JAX
package's on the CPU, fp32, on the same tiny weights through the bridge:
tokens, segments, seek origins and diagnostics equal (``avg_logprob`` within
``LOGPROB_ATOL``), with the sampled rungs fed JAX's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mocov2_whisper_flamingo_torch.decode import segments as T
from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules as TRules
from mocov2_whisper_flamingo_torch.decode.streaming import transcribe_long_form
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR as TASR
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_tpu.decode import segments as J
from mocov2_whisper_flamingo_tpu.decode.logit_rules import LogitRules as JRules
from mocov2_whisper_flamingo_tpu.decode.streaming import (
    transcribe_long_form as jax_transcribe_long_form)
from mocov2_whisper_flamingo_tpu.models.asr import WhisperASR as JASR
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig

from longform_helpers import JaxDraws, lively, window_mel
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

TS0 = 100
HYPOTHESIS = settings(max_examples=300, deadline=None, derandomize=True, database=None)

# token streams: text ids below TS0, timestamps from TS0, mostly nondecreasing
# (the grammar's streams) but not always (the parser must not care)
tokens_st = st.lists(st.one_of(st.integers(0, TS0 - 1), st.integers(TS0, TS0 + 40)),
                     max_size=30)


@HYPOTHESIS
@given(tokens=tokens_st, offset=st.sampled_from([0.0, 4.0, 29.98]),
       duration=st.sampled_from([30.0, 12.5, 0.32]))
def test_segments_from_window_matches_jax(tokens, offset, duration):
    assert T.segments_from_window(tokens, TS0, offset, duration) == \
        J.segments_from_window(tokens, TS0, offset, duration)


@HYPOTHESIS
@given(tokens=tokens_st, eot=st.sampled_from([None, 50, 100, 120]))
def test_strip_timestamps_matches_jax(tokens, eot):
    assert T.strip_timestamps(tokens, TS0, eot=eot) == J.strip_timestamps(tokens, TS0, eot=eot)


def test_time_precision():
    assert T.TIME_PRECISION == J.TIME_PRECISION == 0.02


# -- timestamp-conditioned seek ------------------------------------------------------------

CFG = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
           vocab_size=64, max_source_positions=20, max_target_positions=32)
N_FRAMES = 2 * CFG["max_source_positions"]
CHUNK_SECONDS = N_FRAMES * 160 / 16_000  # 0.4 s windows
EOS, PREFIX = 2, [1, 3]
RULES = dict(vocab_size=64, timestamp_begin=40, no_timestamps_id=39, eos_id=EOS,
             max_initial_timestamp_index=1)
LOGPROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def seek_pair():
    jasr = JASR(config=JConfig(**CFG), backend="xla")
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jasr.init(jax.random.PRNGKey(5)))
    lively(tree["decoder"], np.random.default_rng(5))
    tasr = load_jax_params(TASR(config=TConfig(**CFG), device="cpu"), tree)
    audio = np.random.default_rng(0).standard_normal(
        int(2.6 * CHUNK_SECONDS * 16_000)).astype(np.float32)
    return jasr, jax.tree.map(jnp.asarray, tree), tasr, audio


def test_quality_mode_timestamp_seek_matches_jax(seek_pair):
    """Every window climbs to the sampled rung (an impossible logprob gate),
    under the timestamp grammar: the windows seek by the predicted
    timestamps, segments split at timestamp pairs, the flat stream keeps
    text tokens only."""
    jasr, params, tasr, audio = seek_pair
    key = jax.random.PRNGKey(4)
    kw = dict(eos_id=EOS, chunk_seconds=CHUNK_SECONDS, max_len=14, beam_size=2, best_of=2,
              temperatures=(0.0, 0.6), logprob_threshold=10.0,
              compression_ratio_threshold=None, context_tokens=4, sot_prev_id=9,
              return_segments=True)
    want, want_segs = jax_transcribe_long_form(
        jasr.encoder, jasr.decoder, params["encoder"], params["decoder"], jnp.asarray(audio),
        PREFIX, mel_fn=lambda w: jnp.asarray(window_mel(w, N_FRAMES)), logit_rules=JRules(**RULES),
        key=key, **kw)
    got, segs = transcribe_long_form(
        tasr.encoder, tasr.decoder.prepare_decode_params(), audio, PREFIX,
        mel_fn=lambda w: torch.from_numpy(window_mel(w, N_FRAMES)), logit_rules=TRules(**RULES),
        draws=JaxDraws(key), **kw)
    assert got == [int(t) for t in want]
    assert len(segs) == len(want_segs) >= 2
    for s, w in zip(segs, want_segs):
        assert s.keys() == w.keys()
        assert s["tokens"] == [int(t) for t in w["tokens"]]
        for name in ("id", "start", "end", "seek", "temperature", "compression_ratio",
                     "gates_passed"):
            assert s[name] == w[name], name
        assert s["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=LOGPROB_ATOL)
    assert all(t < RULES["timestamp_begin"] for t in got)
    seeks = [s["seek"] for s in segs]
    assert len(set(seeks)) >= 4 and len(segs) > len(set(seeks))  # some window held a pair
    assert any(seek % CHUNK_SECONDS > 1e-6 for seek in seeks)  # a seek inside a window
    assert [t for s in segs for t in s["tokens"] if t < RULES["timestamp_begin"]] == got
