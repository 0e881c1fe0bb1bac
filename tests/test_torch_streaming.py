"""The port's streaming decode (``decode/streaming.py``) against the JAX
package's on the CPU, at the tiny configuration of tests/test_decode.py, fp32,
on the same weights through the bridge: tokens identical (tolerance 0) over
chunks, beams, window rollovers, deferred collection, the write gate and the
logit rules; ``transcribe_long_form`` in streaming mode over 70 s of audio.
Also the decoder's per-row step (rows at different positions, the write
gate) against its Python-int step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules as TRules
from mocov2_whisper_flamingo_torch.decode.streaming import StreamingDecoder as TStream
from mocov2_whisper_flamingo_torch.decode.streaming import transcribe_long_form
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR as TASR
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_tpu.decode.logit_rules import LogitRules as JRules
from mocov2_whisper_flamingo_tpu.decode.streaming import StreamingDecoder as JStream
from mocov2_whisper_flamingo_tpu.decode.streaming import (
    transcribe_long_form as jax_transcribe_long_form)
from mocov2_whisper_flamingo_tpu.models.asr import WhisperASR as JASR
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)
EOS = 20  # a token the decoder below emits mid-sequence, so beams finish
PREFIX = [1, 2]
SOT_PREV = 4
NO_EOS = dict(vocab_size=50, suppress=(EOS,))  # every chunk runs its whole budget
BANNED = (11, 25, 46)
# ... and the first token of every window is not one of these
NO_EOS_BEGIN = dict(NO_EOS, begin_suppress=BANNED)


def _lively(tree: dict, rng) -> None:
    """Varied tokens and EOS from a random decoder that listens to its
    features (see tests/test_torch_serving.py)."""
    tree["pos_embed"] = 4.0 * rng.standard_normal(tree["pos_embed"].shape).astype(np.float32)
    tree["embed_tokens"]["embedding"] *= np.float32(0.5)
    for layer in tree["layers"]:
        layer["cross_attn"]["q"]["kernel"] *= np.float32(8.0)
        layer["cross_attn"]["v"]["kernel"] *= np.float32(16.0)


@pytest.fixture(scope="module")
def pair():
    jdec = JDecoder(JConfig(**CFG))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jdec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    _lively(tree, rng)
    params = jax.tree.map(jnp.asarray, tree)
    tdec = load_jax_params(TDecoder(TConfig(**CFG), device="cpu"), tree).prepare_decode_params()
    chunks = [rng.standard_normal((1, 16, 48)).astype(np.float32) for _ in range(10)]
    return jdec, params, tdec, chunks, {"decoders": {}, "runs": {}}


def _jax_run(pair, n_chunks, collect=True, rules=None, **kw):
    """The JAX streaming decoder over the first ``n_chunks`` chunks: (per-chunk
    outputs, collected transcript, window prefix, ``_i_bound``, position).
    A decoder is kept per configuration and reset, so that its compiled chunk
    programs serve every test that asks for it."""
    jdec, params, _, chunks, jax_cache = pair
    decoders, runs = jax_cache["decoders"], jax_cache["runs"]
    key = repr((rules, sorted(kw.items())))
    if key not in decoders:
        decoders[key] = JStream(jdec, params, PREFIX, eos_id=EOS,
                                logit_rules=rules and JRules(**rules), **kw)
    run = repr((n_chunks, collect, key))
    if run not in runs:
        js = decoders[key]
        js.reset()
        out = [js.process_chunk(jnp.asarray(c), collect=collect) for c in chunks[:n_chunks]]
        bound = js._i_bound
        runs[run] = (out, js.collected_tokens(), list(js._window_prefix), bound,
                     int(js._state[2]))
    return runs[run]


def _port_run(pair, n_chunks, collect=True, rules=None, **kw):
    """The port's streaming decoder over the same chunks: (per-chunk outputs,
    collected transcript, decoder)."""
    _, _, tdec, chunks, _ = pair
    ts = TStream(tdec, PREFIX, eos_id=EOS, logit_rules=rules and TRules(**rules), **kw)
    out = [ts.process_chunk(torch.from_numpy(c), collect=collect) for c in chunks[:n_chunks]]
    return out, ts.collected_tokens(), ts


@pytest.mark.parametrize("beam", [1, 3])
def test_chunks_match_jax(pair, beam):
    """Over 3 chunks (beam 3: 4), greedy and beam: identical tokens; EOS ends a
    chunk early (finished beams freeze) the same way."""
    n = 3 if beam == 1 else 4
    kw = dict(max_len=32, max_tokens_per_chunk=7, beam_size=beam)
    jo, jt, *_ = _jax_run(pair, n, **kw)
    to, tt, ts = _port_run(pair, n, **kw)
    assert to == jo and tt == jt
    assert tt[: len(PREFIX)] == PREFIX and ts.tokens == tt
    assert sum(map(len, to)) > 0
    if beam > 1:
        assert any(len(o) < 7 for o in to)  # some chunk ended at EOS


def test_int8_decoder_chunks_match_jax(pair):
    """The streaming decode on an int8 prepared decoder (the JAX streaming
    decoder fed the JAX int8 tree): identical tokens, beam 3 over 4 chunks."""
    jdec, params, _, chunks, _ = pair
    kw = dict(max_len=32, max_tokens_per_chunk=7, beam_size=3)
    js = JStream(jdec, jdec.prepare_decode_params(params, "int8"), PREFIX, eos_id=EOS, **kw)
    jo = [js.process_chunk(jnp.asarray(c)) for c in chunks[:4]]
    tdec = load_jax_params(TDecoder(TConfig(**CFG), device="cpu"),
                           jax.tree.map(np.asarray, params)).prepare_decode_params("int8")
    ts = TStream(tdec, PREFIX, eos_id=EOS, **kw)
    to = [ts.process_chunk(torch.from_numpy(c)) for c in chunks[:4]]
    assert to == jo and ts.collected_tokens() == js.collected_tokens()
    assert sum(map(len, to)) > 0


ROLLOVERS = {
    "context_0": dict(context_tokens=0),
    "context_4": dict(context_tokens=4, sot_prev_id=SOT_PREV),
    "initial_context": dict(context_tokens=3, sot_prev_id=SOT_PREV, initial_context=[7, 8, 9]),
}


@pytest.mark.parametrize("name", ROLLOVERS)
def test_rollover_matches_jax(pair, name):
    kw = dict(rules=NO_EOS_BEGIN, max_len=24, max_tokens_per_chunk=6, beam_size=2,
              **ROLLOVERS[name])
    jo, jt, jprefix, *_ = _jax_run(pair, 8, **kw)
    to, tt, ts = _port_run(pair, 8, **kw)
    assert to == jo and tt == jt
    assert len(tt) == len(PREFIX) + 8 * 6  # no truncation across the rollovers
    assert ts._window_prefix == jprefix


@pytest.mark.parametrize("name", ["context_0", "context_4"])
def test_deferred_collect_matches_eager(pair, name):
    kw = dict(rules=NO_EOS_BEGIN, max_len=24, max_tokens_per_chunk=6, beam_size=2,
              **ROLLOVERS[name])
    to, tt, ts = _port_run(pair, 8, collect=False, **kw)
    _, eager, _ = _port_run(pair, 8, **kw)
    assert to == [[]] * 8
    assert tt == eager == _jax_run(pair, 8, **kw)[1] and ts.tokens == tt


def test_deferred_position_bound_follows_jax(pair):
    """In deferred mode the rollover bound stays conservative; it becomes the
    true position only when collecting, as in the JAX package."""
    kw = dict(max_len=32, max_tokens_per_chunk=7, beam_size=3)  # chunks end at EOS
    *_, bound, pos = _jax_run(pair, 4, collect=False, **kw)
    *_, ts = _port_run(pair, 4, collect=False, **kw)
    assert ts._i_bound == bound == len(PREFIX) - 1 + 28 and ts._state[3] == pos
    *_, bound, pos = _jax_run(pair, 4, **kw)
    *_, ts = _port_run(pair, 4, **kw)
    assert ts._i_bound == bound == pos < len(PREFIX) - 1 + 28


def test_exhaustion_steps_are_noops(pair):
    """``rollover=False``: steps past the end of the token buffer change
    nothing: tokens, position and every self-cache entry equal those of a run
    with exactly enough steps; and both equal the JAX package's tokens."""
    _, _, tdec, chunks, _ = pair
    room = 16 - len(PREFIX)
    kw = dict(max_len=16, eos_id=EOS, beam_size=3, rollover=False,
              logit_rules=TRules(**NO_EOS))
    exact = TStream(tdec, PREFIX, max_tokens_per_chunk=room, **kw)
    extra = TStream(tdec, PREFIX, max_tokens_per_chunk=room + 4, **kw)
    chunk = torch.from_numpy(chunks[0])
    out = exact.process_chunk(chunk)
    assert extra.process_chunk(chunk) == out and len(out) == room
    for a, b in zip(exact._state, extra._state):
        if isinstance(a, int):
            assert a == b == 15
        else:
            assert torch.equal(a, b)
    jo, *_ = _jax_run(pair, 2, rules=NO_EOS, max_len=16, max_tokens_per_chunk=room + 4,
                      beam_size=3, rollover=False)
    assert jo == [out, extra.process_chunk(chunk)] == [out, []]  # a full buffer takes no more


def test_logit_rules_with_begin_index(pair):
    """Begin-suppress fires at each window's first generated position
    (``begin_index`` = the window prefix's length, which grows with the
    context after a rollover); the JAX tokens under these rules are held by
    ``test_rollover_matches_jax``."""
    kw = dict(max_len=24, max_tokens_per_chunk=6, beam_size=2, **ROLLOVERS["context_4"])
    to, tt, ts = _port_run(pair, 8, rules=NO_EOS_BEGIN, **kw)
    free, _, _ = _port_run(pair, 8, rules=NO_EOS, **kw)
    assert free[0][0] in BANNED and to[0][0] not in BANNED
    assert to == _jax_run(pair, 8, rules=NO_EOS_BEGIN, **kw)[0]


def test_reset_and_cache_layouts(pair):
    _, _, tdec, chunks, _ = pair
    sd = TStream(tdec, PREFIX, max_len=32, eos_id=EOS, max_tokens_per_chunk=5, beam_size=2,
                 cache_layout="bhjtd")
    first = sd.process_chunk(torch.from_numpy(chunks[0]))
    sd.process_chunk(torch.from_numpy(chunks[1]))
    sd.reset()
    assert sd.tokens == PREFIX and sd._state is None
    assert sd.process_chunk(torch.from_numpy(chunks[0])) == first
    with pytest.raises(ValueError, match="cache_layout"):
        TStream(tdec, PREFIX, cache_layout="hbtd")


# -- transcribe_long_form --------------------------------------------------------------


@pytest.fixture(scope="module")
def asr_pair():
    """A tiny Whisper that takes 30 s windows (1500 encoder positions)."""
    cfg = dict(CFG, max_source_positions=1500, max_target_positions=48)
    jasr = JASR(config=JConfig(**cfg), backend="xla")
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jasr.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    _lively(tree["decoder"], rng)
    tree["encoder"]["conv1"]["kernel"] *= np.float32(8.0)
    tree["encoder"]["conv2"]["kernel"] *= np.float32(4.0)
    tasr = load_jax_params(TASR(config=TConfig(**cfg), device="cpu"), tree)
    t = np.arange(70 * 16_000) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * (200 + 300 * (t // 10)) * t)
             + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    return jasr, jax.tree.map(jnp.asarray, tree), tasr, audio


def test_transcribe_long_form_matches_jax(asr_pair):
    """70 s -> 3 chunks (the last zero-padded) -> the same tokens and
    segments as the JAX package's streaming mode."""
    jasr, params, tasr, audio = asr_pair
    kw = dict(eos_id=EOS, max_len=48, max_tokens_per_chunk=8, beam_size=2,
              return_segments=True)
    want, want_segs = jax_transcribe_long_form(
        jasr.encoder, jasr.decoder, params["encoder"], params["decoder"], jnp.asarray(audio),
        PREFIX, **kw)
    got, segs = transcribe_long_form(tasr.encoder, tasr.decoder.prepare_decode_params(),
                                     audio, PREFIX, **kw)
    assert got == [int(t) for t in want] and len(got) > 0
    assert [(s["start"], s["end"], s["tokens"]) for s in segs] == \
        [(s["start"], s["end"], [int(t) for t in s["tokens"]]) for s in want_segs]
    assert segs[-1]["end"] == pytest.approx(70.0)


# -- the decoder's per-row step ------------------------------------------------------------


def _cache_at(tdec, chunk, rows, steps, rng):
    """A cache over ``rows`` rows with ``steps`` random tokens written by
    Python-int steps."""
    enc = torch.from_numpy(chunk)
    cache = tdec.init_cache(enc, max_len=16, beam_groups=rows)
    for i in range(steps):
        toks = torch.from_numpy(rng.integers(0, 50, (rows, 1)))
        tdec.decode_step(toks, cache, i)
    return cache


def test_per_row_step_matches_python_int_steps(pair):
    """Rows at positions 3, 7, 0, 5 in one step: each row's fp32 logits equal
    those of the Python-int step at its own position, and each row's K/V lands
    at its own position only."""
    _, _, tdec, chunks, _ = pair
    rng = np.random.default_rng(5)
    cache = _cache_at(tdec, chunks[0], 4, 8, rng)
    positions = [3, 7, 0, 5]
    toks = torch.from_numpy(rng.integers(0, 50, (4, 1)))
    ref_cache = {k: v.clone() for k, v in cache.items()}
    got, cache = tdec.decode_step(toks, cache, max(positions), positions=torch.tensor(positions))
    for r, p in enumerate(positions):
        one = {k: (v[:, r:r + 1].clone() if k.startswith("self") else v)
               for k, v in ref_cache.items()}
        want, one = tdec.decode_step(toks[r:r + 1], one, p)
        np.testing.assert_allclose(got[r].numpy(), want[0].numpy(), atol=1e-5, rtol=0)
        for name in ("self_k", "self_v"):
            torch.testing.assert_close(cache[name][:, r], one[name][:, 0], atol=1e-6, rtol=0)
            others = [i for i in range(16) if i != p]
            assert torch.equal(cache[name][:, r, others], ref_cache[name][:, r, others])


def test_python_int_step_unchanged_and_write_gate(pair):
    """The Python-int step equals the JAX decode step; ``write=False`` gives
    the same logits at a position already written and leaves the cache as it
    was."""
    jdec, params, tdec, chunks, _ = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 50, (2, 5))
    jcache = jdec.init_cache(params, jnp.asarray(chunks[1]), max_len=16, beam_groups=2)
    tcache = tdec.init_cache(torch.from_numpy(chunks[1]), max_len=16, beam_groups=2)
    jstep = jax.jit(jdec.decode_step)
    for i in range(5):
        jl, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1]), jcache, jnp.int32(i))
        tl, tcache = tdec.decode_step(torch.from_numpy(toks[:, i:i + 1]), tcache, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    before = {k: v.clone() for k, v in tcache.items()}
    again, tcache = tdec.decode_step(torch.from_numpy(toks[:, 4:5]), tcache, 4, write=False)
    np.testing.assert_allclose(again.numpy(), tl.numpy(), atol=1e-6, rtol=0)
    assert all(torch.equal(tcache[k], before[k]) for k in before)
