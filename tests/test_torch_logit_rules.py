"""The port's ``LogitRules`` against the JAX package's: every rule on random
normalised rows and token buffers at several positions, and beam-5 and greedy
decoding under suppress + begin-suppress + forced + timestamp rules, token
for token. A masked score is anything at or below -1e29 (masks add up in
units of -1e30); every other score is compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode.beam import beam_search as tbeam
from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode as tgreedy
from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules as TRules
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR as TASR
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_asr_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_tpu.decode.beam import beam_search as jbeam
from mocov2_whisper_flamingo_tpu.decode.greedy import greedy_decode as jgreedy
from mocov2_whisper_flamingo_tpu.decode.logit_rules import LogitRules as JRules
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder

# A toy vocabulary in the real Whisper order: text < eos < specials < timestamps.
VOCAB, EOS, NO_TS, TS0 = 96, 60, 69, 70
PREFIX = [61, 62, 63]
L_BUF = 12
TINY = dict(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=2, n_heads=2, d_ff=128,
            vocab_size=VOCAB, max_source_positions=16, max_target_positions=24)
SCORE_ATOL = 1e-4  # fp32 beam scores after the whole decode

RULES = {
    "suppress": dict(suppress=(3, 7, 61, 95)),
    "begin_suppress": dict(begin_suppress=(5, EOS)),
    "forced": dict(forced=((3, 9), (5, 11))),
    "timestamps": dict(timestamp_begin=TS0, no_timestamps_id=NO_TS, eos_id=EOS),
    "timestamps_uncapped_no_detect": dict(timestamp_begin=TS0, eos_id=EOS,
                                          max_initial_timestamp_index=None,
                                          detect_timestamp_from_logprob=False),
    "all": dict(suppress=(3, 7, 61), begin_suppress=(5, EOS), forced=((6, 11),),
                timestamp_begin=TS0, no_timestamps_id=NO_TS, eos_id=EOS,
                max_initial_timestamp_index=4),
}


def _pair(kwargs):
    return TRules(vocab_size=VOCAB, **kwargs), JRules(vocab_size=VOCAB, **kwargs)


def _assert_rows_equal(ours: np.ndarray, ref: np.ndarray):
    masked = ref <= -1e29
    np.testing.assert_array_equal(ours <= -1e29, masked)
    np.testing.assert_array_equal(ours[~masked], ref[~masked])


def _token_buffers(rng, rows: int) -> np.ndarray:
    """Random buffers behind the prefix: text, EOS-range specials and
    timestamps in varied orders, plus hand-made pairs and lone timestamps."""
    toks = rng.integers(0, TS0, (rows, L_BUF))
    is_ts = rng.random((rows, L_BUF)) < 0.45
    toks = np.where(is_ts, rng.integers(TS0, VOCAB, (rows, L_BUF)), toks)
    toks[:, :len(PREFIX)] = PREFIX
    toks[0, 3:8] = [72, 10, 11, 80, 80]   # <ts> text text <ts><ts>: a completed pair
    toks[1, 3:8] = [70, 12, 13, 14, 85]   # ... a lone timestamp last
    toks[2, 3:8] = [71, 71, 15, 16, 17]   # text last
    return toks


@pytest.mark.parametrize("name", sorted(RULES))
def test_rules_match_jax_row_for_row(name):
    ours, ref = _pair(RULES[name])
    rng = np.random.default_rng(3)
    toks = _token_buffers(rng, 8)
    apply_ref = jax.jit(lambda lp, tk, pos: ref(lp, tk, pos, len(PREFIX)))
    for pos in range(len(PREFIX), L_BUF):
        raw = 3.0 * rng.standard_normal((8, VOCAB)).astype(np.float32)
        logp = np.array(jax.nn.log_softmax(jnp.asarray(raw), axis=-1))
        got = ours(torch.from_numpy(logp), torch.from_numpy(toks), pos, len(PREFIX))
        want = apply_ref(jnp.asarray(logp), jnp.asarray(toks, jnp.int32), jnp.int32(pos))
        assert got.shape == (8, VOCAB) and got.dtype == torch.float32
        _assert_rows_equal(got.numpy(), np.asarray(want))


def test_rules_take_beam_shaped_rows():
    """``[B, K, V]`` rows with ``[B, K, L]`` buffers, as a caller with
    unflattened beams would pass them."""
    ours, ref = _pair(RULES["all"])
    rng = np.random.default_rng(4)
    toks = _token_buffers(rng, 6).reshape(2, 3, L_BUF)
    logp = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.standard_normal((2, 3, VOCAB)).astype(np.float32)), axis=-1))
    got = ours(torch.from_numpy(logp), torch.from_numpy(toks), 8, len(PREFIX))
    want = ref(jnp.asarray(logp), jnp.asarray(toks, jnp.int32), jnp.int32(8), len(PREFIX))
    _assert_rows_equal(got.numpy(), np.asarray(want))


def test_bias_tables_are_built_once_per_device():
    rules = TRules(vocab_size=VOCAB, **RULES["all"])
    logp = torch.zeros((2, VOCAB))
    toks = torch.from_numpy(_token_buffers(np.random.default_rng(0), 3))[:2]
    rules(logp, toks, 4, 3)
    first = rules.tables("cpu")
    rules(logp, toks, 5, 3)
    assert rules.tables("cpu") is first and len(rules._tables) == 1
    assert hash(rules) == hash(TRules(vocab_size=VOCAB, **RULES["all"]))  # still a value


@pytest.mark.parametrize("timestamps", [False, True])
def test_for_whisper_from_a_dict(timestamps):
    cfg = {"suppress_tokens": [1, 2, 7], "begin_suppress_tokens": [5, EOS],
           "forced_decoder_ids": [[1, 62], [2, 63]], "no_timestamps_token_id": NO_TS,
           "eos_token_id": EOS, "max_initial_timestamp_index": 3}
    ours = TRules.for_whisper(cfg, VOCAB, timestamps=timestamps)
    ref = JRules.for_whisper(cfg, VOCAB, timestamps=timestamps)
    for field in dataclasses.fields(ref):
        assert getattr(ours, field.name) == getattr(ref, field.name), field.name
    assert ours.timestamp_begin == (TS0 if timestamps else None)

    class Obj:
        suppress_tokens = [4]
        eos_token_id = EOS

    assert TRules.for_whisper(Obj(), VOCAB) == TRules(vocab_size=VOCAB, suppress=(4,),
                                                     eos_id=EOS, prompt_eot=EOS)


# -- decoding under the rules ---------------------------------------------------------


@pytest.fixture(scope="module")
def decoders():
    asr = TASR(config=TConfig(**TINY), device="cpu")
    tree = random_asr_params(asr, seed=5)
    rng = np.random.default_rng(6)
    # Position embeddings larger than the token embeddings keep the random
    # decoder from copying its input token: it emits varied tokens and EOS.
    dec = tree["decoder"]
    dec["pos_embed"] = 4.0 * rng.standard_normal(dec["pos_embed"].shape).astype(np.float32)
    dec["embed_tokens"]["embedding"] *= np.float32(0.5)
    load_jax_params(asr, tree)
    jdec = JDecoder(JConfig(**TINY), backend="xla")
    jparams = jax.tree.map(jnp.asarray, tree["decoder"])
    enc = rng.standard_normal((3, 16, TINY["d_model"])).astype(np.float32)
    return asr.decoder, jdec, jparams, enc


DECODE_RULES = dict(suppress=(3, 7, 61), begin_suppress=(5, EOS), forced=((5, 11),),
                    timestamp_begin=TS0, no_timestamps_id=NO_TS, eos_id=EOS,
                    max_initial_timestamp_index=6)


@pytest.mark.parametrize("renorm", [False, True])
def test_beam_tokens_with_rules_match_jax(decoders, renorm):
    tdec, jdec, jparams, enc = decoders
    ours, ref = _pair(DECODE_RULES)
    run_ref = jax.jit(lambda p, e: dataclasses.astuple(jbeam(
        jdec, p, e, PREFIX, beam_size=5, max_len=16, eos_id=EOS, logit_rules=ref,
        renorm_after_rules=renorm)))
    seq_ref, score_ref = run_ref(jparams, jnp.asarray(enc))
    res = tbeam(tdec.prepare_decode_params(), torch.from_numpy(enc), PREFIX, beam_size=5,
                max_len=16, eos_id=EOS, logit_rules=ours, renorm_after_rules=renorm)
    np.testing.assert_array_equal(res.sequences.numpy(), np.asarray(seq_ref))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(score_ref), atol=SCORE_ATOL,
                               rtol=0)
    best = res.sequences[:, 0].numpy()
    assert (best[:, len(PREFIX)] >= TS0).all()  # the first generated token is a timestamp
    assert (best[:, 5] == 11).all()             # the forced position holds its token
    assert not np.isin(best[:, len(PREFIX):], [3, 7, 61, NO_TS]).any()


def test_rules_change_the_beam(decoders):
    tdec, _, _, enc = decoders
    ours, _ = _pair(DECODE_RULES)
    dec = tdec.prepare_decode_params()
    free = tbeam(dec, torch.from_numpy(enc), PREFIX, beam_size=5, max_len=16, eos_id=EOS)
    ruled = tbeam(dec, torch.from_numpy(enc), PREFIX, beam_size=5, max_len=16, eos_id=EOS,
                  logit_rules=ours)
    assert not torch.equal(free.sequences, ruled.sequences)


@pytest.mark.parametrize("name", ["all", "suppress"])
def test_greedy_tokens_with_rules_match_jax(decoders, name):
    tdec, jdec, jparams, enc = decoders
    ours, ref = _pair(RULES[name])
    run_ref = jax.jit(lambda p, e: jgreedy(jdec, p, e, PREFIX, 16, EOS, logit_rules=ref))
    got = tgreedy(tdec.prepare_decode_params(), torch.from_numpy(enc), PREFIX, 16, EOS,
                  logit_rules=ours)
    np.testing.assert_array_equal(got.numpy(), np.asarray(run_ref(jparams, jnp.asarray(enc))))
    assert len(np.unique(got.numpy()[:, len(PREFIX):])) > 2  # the decode is not degenerate
