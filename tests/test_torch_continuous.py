"""The port's continuous-batching engine (``serving/continuous.py``) on the
CPU at the tiny configuration of tests/test_continuous.py, fp32: the state
machine (``init_state`` / admit / segment) against the JAX package's on the
same weights and schedule (staggered admissions, reused slots; pool tokens
identical, pool scores within 1e-5) and every row against the port's solo
``beam_search`` of the same features; the threaded engine end to end, its
failures and ``close``; ``make_continuous_av_engine`` on a tiny AV model
against the JAX package's engine."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode.beam import beam_search
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet as TNet
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_torch.serving import (
    ContinuousEngine, ServeResult, make_continuous_av_engine, trim_at_eos)
from mocov2_whisper_flamingo_torch.serving import continuous as tcont
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.serving import continuous as jcont
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)
EOS = 20  # a token the decoder below emits mid-sequence: rows finish early
PREFIX = [1, 2]
K, S, M = 3, 8, 3
MAX_LEN = S * M
ENC_LEN = 16
SCORE_ATOL = 1e-5
WAIT = 120


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
    solos = [beam_search(tdec, torch.from_numpy(u), PREFIX, beam_size=K, max_len=MAX_LEN,
                         eos_id=EOS) for u in utts]
    return jdec, jax.tree.map(jnp.asarray, tree), tdec, utts, solos


def _port_machine(tdec, capacity):
    state = tcont.init_state(tdec, capacity=capacity, beam_size=K, seg_steps=S, n_segments=M,
                             enc_len=ENC_LEN, eos_id=EOS)
    admit = tcont.make_admit_fn(tdec, PREFIX, EOS, K, MAX_LEN)
    segment = tcont.make_segment_fn(tdec, beam_size=K, seg_steps=S, n_segments=M,
                                    n_prefix=len(PREFIX), eos_id=EOS)
    return state, admit, segment


# Admissions by tick: (row, utterance). Rows 0 and 1 come in together, row 2
# one segment later; rows 0, 1 and 2 are reused once their budget is spent.
SCHEDULE = {0: [(0, 0), (1, 1)], 1: [(2, 2)], 3: [(0, 3)], 4: [(1, 4), (2, 5)]}


def test_scripted_schedule_matches_jax_and_solo(setup):
    """Staggered admissions, two rows admitted in one call and three reused
    slots: every row's pool equals the JAX machine's on the same schedule
    (tokens identical, scores within 1e-5) and its solo ``beam_search``."""
    jdec, params, tdec, utts, solos = setup
    jstate = jcont.init_state(jdec, capacity=3, beam_size=K, seg_steps=S, n_segments=M,
                              enc_len=ENC_LEN, eos_id=EOS)
    jadmit = jcont.make_admit_fn(jdec, PREFIX, EOS, K, MAX_LEN)
    jsegment = jcont.make_segment_fn(jdec, beam_size=K, seg_steps=S, n_segments=M,
                                     n_prefix=len(PREFIX), eos_id=EOS)
    state, admit, segment = _port_machine(tdec, 3)
    valid = np.ones((1, ENC_LEN), bool)
    live, checked, early = {}, [], 0
    for tick in range(7):
        entries = SCHEDULE.get(tick, [])
        for row, u in entries:
            jstate = jadmit(params, jstate, jnp.asarray(utts[u]), jnp.asarray(valid),
                            np.int32(row))
            live[row] = (u, tick)
        if entries:
            feats = torch.from_numpy(np.concatenate([utts[u] for _, u in entries]))
            state = admit(state, feats, torch.ones((len(entries), ENC_LEN), dtype=torch.bool),
                          [row for row, _ in entries])
        jstate, state = jsegment(params, jstate), segment(state)
        assert state["tick"] == tick + 1
        for row, (u, t0) in list(live.items()):
            if tick + 1 - t0 < M:
                early += not bool(state["heur_ok"][row])
                continue
            got = state["pool_tokens"][row].numpy()
            np.testing.assert_array_equal(got, np.asarray(jstate["pool_tokens"][row]))
            np.testing.assert_array_equal(got, solos[u].sequences[0].numpy())
            np.testing.assert_allclose(state["pool_scores"][row].numpy(),
                                       np.asarray(jstate["pool_scores"][row]), atol=SCORE_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(state["pool_scores"][row].numpy(),
                                       solos[u].scores[0].numpy(), atol=SCORE_ATOL, rtol=0)
            assert bool(state["heur_ok"][row]) == bool(jstate["heur_ok"][row])
            checked.append(u)
            del live[row]
    assert sorted(checked) == list(range(6))
    assert early > 0  # some pool froze before its budget: the engine retires such rows


def test_admit_rejects_a_bad_batch(setup):
    _, _, tdec, utts, _ = setup
    state, admit, _ = _port_machine(tdec, 2)
    with pytest.raises(ValueError, match="utterances"):
        admit(state, torch.zeros((1, ENC_LEN + 1, 48)), None, 0)
    with pytest.raises(ValueError, match="utterances"):
        admit(state, torch.from_numpy(utts[0]), None, [0, 1])
    with pytest.raises(ValueError, match="cache_layout"):
        tcont.init_state(tdec, capacity=1, beam_size=K, seg_steps=S, n_segments=M,
                         enc_len=ENC_LEN, eos_id=EOS, cache_layout="hbtd")


# -- the threaded engine ---------------------------------------------------------------


def _concat(payloads):
    """The engine's encode over payloads that are already features."""
    return (torch.cat([torch.from_numpy(f) for f, _ in payloads]),
            torch.cat([torch.from_numpy(v) for _, v in payloads]))


def _engine(tdec, encode=_concat, capacity=2, **kw):
    return ContinuousEngine(tdec, encode, prefix_ids=PREFIX, eos_id=EOS, enc_len=ENC_LEN,
                            capacity=capacity, beam_size=K, seg_steps=S, n_segments=M, **kw)


def _trimmed(solo):
    return trim_at_eos(solo.sequences[0, 0].numpy(), EOS, len(PREFIX))


def test_engine_end_to_end(setup):
    """Five requests through two rows: every result equals its solo decode,
    rows are retired early and refilled, admission waits for segments."""
    _, _, tdec, utts, solos = setup
    valid = np.ones((1, ENC_LEN), bool)
    with _engine(tdec) as eng:
        futs = [eng.submit(utts[i], valid) for i in range(5)]
        results = [f.result(timeout=WAIT) for f in futs]
        stats = eng.stats()
    for i, r in enumerate(results):
        assert isinstance(r, ServeResult) and r.bucket == 2 and r.text is None
        np.testing.assert_array_equal(r.tokens, _trimmed(solos[i]), err_msg=f"request {i}")
        assert r.total_ms >= r.decode_ms > 0 and r.queue_ms >= 0
    assert stats == {"segments_run": stats["segments_run"], "pending": 0, "live_rows": 0}
    assert stats["segments_run"] < 5 * M  # retirement before the budget freed rows
    assert max(r.queue_ms for r in results[2:]) > 0


def test_engine_warmup_and_tokenizer(setup):
    _, _, tdec, utts, solos = setup

    class Tok:
        def decode(self, ids):
            return ",".join(map(str, ids))

    sizes = []

    def encode(payloads):
        sizes.append(len(payloads))
        return _concat(payloads)

    valid = np.ones((1, ENC_LEN), bool)
    with _engine(tdec, encode, capacity=4, tokenizer=Tok()) as eng:
        eng.warmup((utts[0], valid), encode_buckets=(1, 2, 4, 8))
        res = eng.transcribe(utts[1], valid, timeout=WAIT)
    assert sizes == [4, 2, 1, 1, 1]  # buckets up to capacity, largest first, then the two decodes
    want = _trimmed(solos[1])
    assert res.text == ",".join(str(t) for t in want[len(PREFIX):])


def test_failed_segment_fails_its_requests_and_the_engine_goes_on(setup):
    _, _, tdec, utts, solos = setup

    def encode(payloads):
        if any(f is None for f, _ in payloads):
            raise ValueError("bad payload")
        return _concat(payloads)

    valid = np.ones((1, ENC_LEN), bool)
    with _engine(tdec, encode) as eng:
        bad = eng.submit(None, valid)
        with pytest.raises(ValueError, match="bad payload"):
            bad.result(timeout=WAIT)
        good = eng.transcribe(utts[2], valid, timeout=WAIT)
    np.testing.assert_array_equal(good.tokens, _trimmed(solos[2]))


def test_close_fails_pending(setup):
    _, _, tdec, utts, _ = setup
    started = threading.Event()

    def encode(payloads):
        started.set()
        time.sleep(0.05)
        return _concat(payloads)

    eng = _engine(tdec, encode, capacity=1)
    valid = np.ones((1, ENC_LEN), bool)
    futs = [eng.submit(utts[0], valid) for _ in range(3)]
    assert started.wait(WAIT)
    eng.close()
    assert all(f.done() for f in futs)
    assert any(isinstance(f.exception(), RuntimeError) for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(utts[0], valid)
    assert not eng._thread.is_alive()


# -- the AV builder ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_av():
    """A tiny AV model whose Whisper takes 3000-frame mels (the JAX
    builder's length probe needs them), and three uint8 payloads."""
    cfg = dict(CFG, vocab_size=64, d_model=32, max_source_positions=1500)
    modelargs = (32, 4, 2, 3000, 128, 0.0)
    tnet = TNet(modelargs=modelargs, vocab_size=64, device="cpu",
                whisper_config=TConfig(**cfg))
    tree = random_jax_params(tnet, seed=1)
    rng = np.random.default_rng(1)
    for layer in tree["trunk"]["fusion"]["layers"]:
        layer["attn_gate"], layer["ff_gate"] = np.float32(0.5), np.float32(-0.3)
    _lively(tree["decoder"], rng)
    load_jax_params(tnet, tree)
    t_video, hw = 6, 32
    payloads = [(rng.standard_normal((80, 128)).astype(np.float32), np.ones(128, bool),
                 rng.integers(0, 255, (t_video, 3, hw, hw)).astype(np.uint8),
                 np.ones(t_video, bool), np.int32(t_video - i)) for i in range(3)]
    return tnet, tree, cfg, modelargs, payloads, hw


def test_int8_continuous_av_engine_matches_direct_beam(tiny_av):
    """``weight_quant="int8"``: each row equals a direct int8 ``net.beam``
    of its request (the caches stay in the compute dtype, as in the JAX
    engine)."""
    from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline

    tnet, _, _, _, payloads, hw = tiny_av
    kw = dict(beam_size=K, max_len=MAX_LEN, eos_id=EOS, capacity=4, seg_steps=S,
              video_resize=hw)
    with make_continuous_av_engine(tnet, PREFIX, weight_quant="int8", **kw) as eng:
        got = [f.result(timeout=WAIT) for f in [eng.submit(*p) for p in payloads]]
    for p, g in zip(payloads, got):
        audio, audio_mask, video_u8, video_mask, video_len = (
            torch.from_numpy(np.asarray(x)[None]) for x in p)
        video = eval_video_pipeline(video_u8, resize=hw)
        direct = tnet.beam((audio, audio_mask, video, video_mask, video_len), PREFIX,
                           beam_size=K, max_len=MAX_LEN, eos_id=EOS,
                           weight_quant="int8").sequences[0, 0].numpy()
        np.testing.assert_array_equal(g.tokens, trim_at_eos(direct, EOS, len(PREFIX)))
    assert len({tuple(g.tokens) for g in got}) == 3


def test_continuous_av_engine_matches_the_jax_engine(tiny_av):
    """``make_continuous_av_engine`` on a tiny AV model (a Whisper that takes
    3000-frame mels, as the JAX builder's length probe needs) against the JAX
    package's engine on the same weights and payloads, and against the port's
    direct ``net.beam``."""
    from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline
    from mocov2_whisper_flamingo_tpu.models.av_whisper import AVWhisperNet as JNet
    from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
    from mocov2_whisper_flamingo_tpu.serving import make_continuous_av_engine as jax_engine

    tnet, tree, cfg, modelargs, payloads, hw = tiny_av
    jnet = JNet(modelargs=modelargs, vocab_size=64, whisper_name="whisper-tiny", backend="xla")
    jcfg = JConfig(**cfg)
    jnet.whisper_config = jnet.trunk.whisper_config = jcfg
    jnet.trunk.whisper_encoder = JEncoder(jcfg, jnet.trunk.precision, "xla")
    jnet.decoder = JDecoder(jcfg, jnet.precision, "xla")
    params = jax.tree.map(jnp.asarray, tree)
    kw = dict(beam_size=K, max_len=MAX_LEN, eos_id=EOS, capacity=4, seg_steps=S,
              video_resize=hw)
    with make_continuous_av_engine(tnet, PREFIX, **kw) as eng:
        assert eng.state["enc_valid"].shape[1] == tcont.fused_length(tnet) == 400
        got = [f.result(timeout=WAIT) for f in [eng.submit(*p) for p in payloads]]
    with jax_engine(jnet, params, PREFIX, **kw) as jeng:
        want = [f.result(timeout=WAIT) for f in [jeng.submit(*p) for p in payloads]]
    for p, g, w in zip(payloads, got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        audio, audio_mask, video_u8, video_mask, video_len = (
            torch.from_numpy(np.asarray(x)[None]) for x in p)
        video = eval_video_pipeline(video_u8, resize=hw)
        direct = tnet.beam((audio, audio_mask, video, video_mask, video_len), PREFIX,
                           beam_size=K, max_len=MAX_LEN, eos_id=EOS).sequences[0, 0].numpy()
        np.testing.assert_array_equal(g.tokens, trim_at_eos(direct, EOS, len(PREFIX)))
    assert len({tuple(g.tokens) for g in got}) == 3  # three different transcripts


def test_continuous_av_engine_refusals():
    with pytest.raises(ValueError, match="multiple of seg_steps"):
        make_continuous_av_engine(None, PREFIX, max_len=100, seg_steps=32)
