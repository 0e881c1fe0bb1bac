"""The loops that run as CUDA graphs on the card, on the CPU: the continuous
engine's segment (``serving/continuous.py``) and the streaming decoder's
chunk (``decode/streaming.py``) work in place on fixed buffers, read their
whole window under the position mask and take their positions on the device.
Against the JAX package at tiny configurations, fp32, on the same weights:
the segment's pools through a scripted schedule with reused rows (tokens
identical, scores within 1e-5), the logit rules at a device position (equal
to the Python-int form and, masked scores aside, to the JAX rules), and the
streaming chunk under rules, rollovers, deferred collection and exhaustion
(tokens identical). Each JAX reference is jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode.beam import reorder_into
from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules as TRules
from mocov2_whisper_flamingo_torch.decode.streaming import StreamingDecoder as TStream
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_torch.serving import continuous as tcont
from mocov2_whisper_flamingo_tpu.decode.logit_rules import LogitRules as JRules
from mocov2_whisper_flamingo_tpu.decode.streaming import StreamingDecoder as JStream
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.serving import continuous as jcont

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)
EOS = 20  # a token the decoder below emits mid-sequence: rows and beams finish early
PREFIX = [1, 2]
K = 3
ENC_LEN = 16
SCORE_ATOL = 1e-5


def _lively(tree: dict, rng) -> None:
    """Varied tokens and EOS from a random decoder that listens to its
    features (see tests/test_torch_serving.py)."""
    tree["pos_embed"] = 4.0 * rng.standard_normal(tree["pos_embed"].shape).astype(np.float32)
    tree["embed_tokens"]["embedding"] *= np.float32(0.5)
    for layer in tree["layers"]:
        layer["cross_attn"]["q"]["kernel"] *= np.float32(8.0)
        layer["cross_attn"]["v"]["kernel"] *= np.float32(16.0)


@pytest.fixture(scope="module")
def setup():
    jdec = JDecoder(JConfig(**CFG))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jdec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    _lively(tree, rng)
    tdec = load_jax_params(TDecoder(TConfig(**CFG), device="cpu"), tree).prepare_decode_params()
    utts = [rng.standard_normal((1, ENC_LEN, 48)).astype(np.float32) for _ in range(6)]
    return jdec, jax.tree.map(jnp.asarray, tree), tdec, utts


# -- the continuous segment ------------------------------------------------------------


def _machine(tdec, seg_steps, n_segments, capacity=3):
    state = tcont.init_state(tdec, capacity=capacity, beam_size=K, seg_steps=seg_steps,
                             n_segments=n_segments, enc_len=ENC_LEN, eos_id=EOS)
    admit = tcont.make_admit_fn(tdec, PREFIX, EOS, K, seg_steps * n_segments)
    kw = dict(beam_size=K, seg_steps=seg_steps, n_segments=n_segments, n_prefix=len(PREFIX),
              eos_id=EOS)
    return state, admit, tcont.make_segment_fn(tdec, **kw), tcont.SegmentProgram(tdec, **kw)


def _addresses(state: dict) -> dict:
    return {name: v.data_ptr() for name, v in state.items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("seg_steps", [3, 4], ids=["odd", "even"])
def test_segment_keeps_every_state_tensor_at_its_address(setup, seg_steps):
    """After each segment (the eager function and the program's CPU path)
    every state tensor, the spare caches included, is where it was; the
    program's state equals the eager function's bit for bit."""
    _, _, tdec, utts = setup
    runs = {}
    for which in ("eager", "program"):
        state, admit, eager, program = _machine(tdec, seg_steps, 3)
        segment = eager if which == "eager" else program
        before = _addresses(state)
        admit(state, torch.from_numpy(np.concatenate(utts[:2])), None, [0, 2])
        for tick in range(3):
            segment(state)
            assert _addresses(state) == before, (which, tick)
        runs[which] = state
    assert set(before) >= {"self_k_spare", "self_v_spare"}
    for name, v in runs["eager"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, runs["program"][name]), name
    assert runs["eager"]["tick"] == runs["program"]["tick"] == 3


@pytest.mark.parametrize("dim", [0, 1])
def test_alternating_reorder_equals_a_fresh_index_select(dim):
    """Reorders into a spare pair that alternates: each step's buffers equal
    a fresh ``index_select`` of the last, and only the two pairs' addresses
    ever hold them."""
    gen = torch.Generator().manual_seed(0)
    shape = (6, 6, 5, 3)
    bufs = (torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))
    spares = tuple(torch.empty_like(b) for b in bufs)
    homes = {b.data_ptr() for b in bufs + spares}
    want = tuple(b.clone() for b in bufs)
    for step in range(5):
        rows = torch.randint(0, 6, (6,), generator=gen)
        want = tuple(w.index_select(dim, rows) for w in want)
        bufs, spares = reorder_into(bufs, spares, rows, dim=dim)
        assert all(torch.equal(b, w) for b, w in zip(bufs, want)), step
        assert {b.data_ptr() for b in bufs + spares} == homes


# Admissions by tick: (row, utterance). Rows 0 and 1 come in together, row 2
# one segment later; rows 0, 1 and 2 are reused once their budget is spent.
SCHEDULE = {0: [(0, 0), (1, 1)], 1: [(2, 2)], 3: [(0, 3)], 4: [(1, 4), (2, 5)]}


def test_fixed_read_segment_pools_equal_the_jax_engine(setup):
    """Odd 5-step segments read the whole 15-slot window under the mask:
    through the scripted schedule every retired row's pool equals the JAX
    machine's (tokens identical, scores within 1e-5)."""
    jdec, params, tdec, utts = setup
    s, m = 5, 3
    jstate = jcont.init_state(jdec, capacity=3, beam_size=K, seg_steps=s, n_segments=m,
                              enc_len=ENC_LEN, eos_id=EOS)
    jadmit = jcont.make_admit_fn(jdec, PREFIX, EOS, K, s * m)
    jsegment = jcont.make_segment_fn(jdec, beam_size=K, seg_steps=s, n_segments=m,
                                     n_prefix=len(PREFIX), eos_id=EOS)
    state, admit, _, program = _machine(tdec, s, m)
    valid = np.ones((1, ENC_LEN), bool)
    live, checked = {}, []
    for tick in range(7):
        entries = SCHEDULE.get(tick, [])
        for row, u in entries:
            jstate = jadmit(params, jstate, jnp.asarray(utts[u]), jnp.asarray(valid),
                            np.int32(row))
            live[row] = (u, tick)
        if entries:
            admit(state, torch.from_numpy(np.concatenate([utts[u] for _, u in entries])),
                  torch.ones((len(entries), ENC_LEN), dtype=torch.bool),
                  [row for row, _ in entries])
        jstate, state = jsegment(params, jstate), program(state)
        for row, (u, t0) in list(live.items()):
            if tick + 1 - t0 < m:
                continue
            np.testing.assert_array_equal(state["pool_tokens"][row].numpy(),
                                          np.asarray(jstate["pool_tokens"][row]))
            np.testing.assert_allclose(state["pool_scores"][row].numpy(),
                                       np.asarray(jstate["pool_scores"][row]),
                                       atol=SCORE_ATOL, rtol=0)
            checked.append(u)
            del live[row]
    assert sorted(checked) == list(range(6))


# -- logit rules at a device position ------------------------------------------------------

VOCAB, R_EOS, NO_TS, TS0 = 96, 60, 69, 70
R_PREFIX = [61, 62, 63]
L_BUF = 12
TIMESTAMPS = dict(timestamp_begin=TS0, no_timestamps_id=NO_TS, eos_id=R_EOS)
# Each position class: the rules, and the positions that exercise it (rows 0
# and 1 of the buffers below hold a completed pair and a lone timestamp).
POSITION_CLASSES = {
    "begin": (dict(begin_suppress=(5, R_EOS), suppress=(3, 7)), [3]),
    "forced": (dict(forced=((3, 9), (6, 11)), suppress=(3,)), [3, 6, 7]),
    "after_pair": (TIMESTAMPS, [8]),
    "after_lone": (TIMESTAMPS, [8]),
    "initial_timestamp": (dict(TIMESTAMPS, max_initial_timestamp_index=4), [3]),
    "every_position": (dict(TIMESTAMPS, suppress=(3, 7, 61), begin_suppress=(5, R_EOS),
                            forced=((6, 11),), max_initial_timestamp_index=4),
                       list(range(3, L_BUF))),
}


def _token_buffers(rng, rows: int) -> np.ndarray:
    toks = rng.integers(0, TS0, (rows, L_BUF))
    is_ts = rng.random((rows, L_BUF)) < 0.45
    toks = np.where(is_ts, rng.integers(TS0, VOCAB, (rows, L_BUF)), toks)
    toks[:, :len(R_PREFIX)] = R_PREFIX
    toks[0, 3:8] = [72, 10, 11, 80, 80]   # <ts> text text <ts><ts>: a completed pair
    toks[1, 3:8] = [70, 12, 13, 14, 85]   # ... a lone timestamp last
    toks[2, 3:8] = [71, 71, 15, 16, 17]   # text last
    return toks


@pytest.mark.parametrize("name", sorted(POSITION_CLASSES))
def test_rules_at_a_device_position_equal_the_int_form_and_jax(name):
    kwargs, positions = POSITION_CLASSES[name]
    ours, ref = TRules(vocab_size=VOCAB, **kwargs), JRules(vocab_size=VOCAB, **kwargs)
    rng = np.random.default_rng(7)
    toks = _token_buffers(rng, 6)
    apply_ref = jax.jit(lambda lp, tk, pos: ref(lp, tk, pos, len(R_PREFIX)))
    for pos in positions:
        logp = np.array(jax.nn.log_softmax(
            jnp.asarray(3.0 * rng.standard_normal((6, VOCAB)).astype(np.float32)), axis=-1))
        at_int = ours(torch.from_numpy(logp), torch.from_numpy(toks), pos, len(R_PREFIX))
        at_dev = ours(torch.from_numpy(logp), torch.from_numpy(toks), torch.tensor(pos),
                      len(R_PREFIX))
        assert torch.equal(at_dev, at_int), pos
        want = np.asarray(apply_ref(jnp.asarray(logp), jnp.asarray(toks, jnp.int32),
                                    jnp.int32(pos)))
        masked = want <= -1e29
        np.testing.assert_array_equal(at_dev.numpy() <= -1e29, masked)
        np.testing.assert_array_equal(at_dev.numpy()[~masked], want[~masked])
        if name in ("after_pair", "after_lone"):  # the class's rows were masked by it
            row = 0 if name == "after_pair" else 1
            assert masked[row, TS0:].all() if name == "after_pair" else \
                masked[row, :R_EOS].all()


# -- the streaming chunk at a device position ------------------------------------------

# Timestamp tokens 40..49 in the tiny vocabulary, EOS suppressed so that every
# chunk runs its whole budget.
STREAM_RULES = dict(vocab_size=50, suppress=(EOS,), timestamp_begin=40, no_timestamps_id=39,
                    eos_id=EOS, max_initial_timestamp_index=3)


def _streams(setup, rules, **kw):
    jdec, params, tdec, _ = setup
    return (JStream(jdec, params, PREFIX, eos_id=EOS, logit_rules=rules and JRules(**rules),
                    **kw),
            TStream(tdec, PREFIX, eos_id=EOS, logit_rules=rules and TRules(**rules), **kw))


def test_device_position_chunks_match_jax_with_rules_rollover_and_deferral(setup):
    """Under the timestamp grammar, with rollovers (4 tokens of context) and
    deferred collection, 7 chunks: the transcript equals the JAX decoder's
    token for token, and the decoder's buffers keep their addresses through
    chunks, rollovers and ``reset``."""
    utts = setup[3]
    kw = dict(max_len=24, max_tokens_per_chunk=6, beam_size=K, context_tokens=4,
              sot_prev_id=4)
    js, ts = _streams(setup, STREAM_RULES, **kw)
    homes = [b.data_ptr() for b in ts._buffers + ts._spares]
    for collect in (False, True):
        js.reset()
        ts.reset()
        for u in range(7):
            want = js.process_chunk(jnp.asarray(utts[u % 6]), collect=collect)
            assert ts.process_chunk(torch.from_numpy(utts[u % 6]), collect=collect) == want
            assert [b.data_ptr() for b in ts._buffers + ts._spares] == homes
        assert ts.collected_tokens() == js.collected_tokens()
        assert ts._window_prefix == js._window_prefix and ts._window_prefix[0] == 4
    generated = ts.tokens[len(PREFIX):]
    assert len(generated) == 7 * 6 and any(t >= 40 for t in generated)


def test_device_position_exhaustion_matches_jax(setup):
    """``rollover=False``: the device-side write gate keeps the steps past
    the end of the buffer from changing anything: the tokens equal the JAX
    decoder's, a full buffer takes no more tokens, and its caches are those
    of a decoder whose chunk had exactly enough steps."""
    utts = setup[3]
    room = 16 - len(PREFIX)
    kw = dict(max_len=16, beam_size=K, rollover=False)
    js, ts = _streams(setup, STREAM_RULES, max_tokens_per_chunk=room + 5, **kw)
    chunk = utts[0]
    want = [js.process_chunk(jnp.asarray(chunk)) for _ in range(2)]
    got = [ts.process_chunk(torch.from_numpy(chunk)) for _ in range(2)]
    assert got == want and len(got[0]) == room and got[1] == []
    exact = TStream(setup[2], PREFIX, eos_id=EOS, logit_rules=TRules(**STREAM_RULES),
                    max_tokens_per_chunk=room, **kw)
    exact.process_chunk(torch.from_numpy(chunk))
    ts.reset()
    ts.process_chunk(torch.from_numpy(chunk))
    for a, b in zip(exact._state, ts._state):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
