"""The port's serving subsystem on the CPU: the micro-batcher policy, the
pad/trim helpers, the engine against direct decodes (fp32: a padded batch's
rows equal solo decodes), bucket bookkeeping, warm-up, failure handling, the
AV engine, the HTTP front end, and the port's audio engine against the JAX
package's on the same waveforms. Every wait has a timeout and every engine is
closed by its ``with`` block or a ``finally``."""

import base64
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_asr_params, random_jax_params)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig
from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline
from mocov2_whisper_flamingo_torch.serving import (
    DEFAULT_BUCKETS, MicroBatcher, Plan, ServeResult, ServingEngine, TranscriptionServer,
    canonical_wav, make_audio_engine, make_av_engine, pad_rows, quantize_bucket, trim_at_eos)
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

TINY = dict(n_mels=80, d_model=64, encoder_layers=1, decoder_layers=1, n_heads=2, d_ff=96,
            vocab_size=64, max_source_positions=16, max_target_positions=32)
PREFIX = [1, 2]
EOS = 3
# 32 mel frames = 2 * max_source_positions -> 32 * 160 samples of 16 kHz
SECONDS = 32 * 160 / 16_000
MAX_LEN = 10
BEAM = 2
WAIT = 120  # seconds, for every future, join and HTTP call


# -- policy ------------------------------------------------------------------------


def test_quantize_bucket():
    assert quantize_bucket(1, (1, 2, 4)) == 1
    assert quantize_bucket(3, (1, 2, 4)) == 4
    assert quantize_bucket(9, (1, 2, 4)) == 4  # overflow -> max bucket
    with pytest.raises(ValueError):
        quantize_bucket(0, (1, 2, 4))
    assert DEFAULT_BUCKETS == (1, 2, 4, 8, 16)


def test_plan_empty_queue():
    assert MicroBatcher((1, 2, 4), 0.01).plan([], now=1.0) is None


def test_plan_full_bucket_fires_immediately():
    mb = MicroBatcher((1, 2, 4), max_wait_s=10.0)
    assert mb.plan([1.0] * 4, now=1.0) == Plan(4, 4)
    assert mb.plan([1.0] * 9, now=1.0) == Plan(4, 4)  # takes one full bucket


def test_plan_deadline():
    mb = MicroBatcher((1, 2, 4), max_wait_s=0.05)
    assert mb.plan([1.00, 1.01], now=1.01) is None  # still inside the window
    assert mb.plan([1.00, 1.01], now=1.06) == Plan(2, 2)
    assert mb.plan([1.00] * 3, now=1.06) == Plan(3, 4)  # pad 3 -> bucket 4
    assert mb.next_deadline([1.00, 1.01]) == pytest.approx(1.05)
    assert mb.next_deadline([]) is None


def test_bad_ladder_rejected():
    with pytest.raises(ValueError):
        MicroBatcher((), 0.01)
    with pytest.raises(ValueError):
        MicroBatcher((0, 2), 0.01)


def test_plans_match_the_jax_batcher():
    from mocov2_whisper_flamingo_tpu.serving.batcher import MicroBatcher as JBatcher

    rng = np.random.default_rng(0)
    ours, ref = MicroBatcher((1, 2, 4, 8), 0.02), JBatcher((1, 2, 4, 8), 0.02)
    for _ in range(200):
        times = sorted(rng.uniform(0.0, 0.05, rng.integers(0, 11)).tolist())
        now = float(rng.uniform(0.0, 0.08))
        got, want = ours.plan(times, now), ref.plan(times, now)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.count, got.bucket) == (want.count, want.bucket)
        assert ours.next_deadline(times) == ref.next_deadline(times)


# -- helpers -----------------------------------------------------------------------


def _host_rows():
    return [(np.ones(3, np.float32), np.int32(2), np.array([True, False])),
            (np.full(3, 2.0, np.float32), np.int32(5), np.array([True, True]))]


def test_pad_rows_stacks_and_pads():
    wav, lens, mask = pad_rows(_host_rows(), 4)
    assert isinstance(wav, np.ndarray)
    assert wav.shape == (4, 3) and lens.shape == (4,) and mask.shape == (4, 2)
    assert wav.dtype == np.float32 and lens.dtype == np.int32 and mask.dtype == np.bool_
    np.testing.assert_array_equal(wav[0], 1.0)
    np.testing.assert_array_equal(wav[2:], 0.0)
    assert lens.tolist() == [2, 5, 0, 0]
    assert mask.tolist() == [[True, False], [True, True], [False, False], [False, False]]
    full = pad_rows(_host_rows(), 2)
    np.testing.assert_array_equal(full[0], wav[:2])


def test_pad_rows_tensor_rows_collate_on_their_device():
    """``torch.Tensor`` payload rows are stacked with torch ops where they
    lie (on the card: no trip through the host) and match the host collate
    bit for bit, dtypes included."""
    host = pad_rows(_host_rows(), 4)
    dev_rows = [tuple(torch.as_tensor(x) for x in row) for row in _host_rows()]
    dev = pad_rows(dev_rows, 4)
    for h, d in zip(host, dev):
        assert isinstance(d, torch.Tensor) and d.device.type == "cpu"
        np.testing.assert_array_equal(h, d.numpy())
        assert torch.from_numpy(h).dtype == d.dtype


def test_trim_at_eos():
    row = np.array([1, 2, 7, 8, EOS, 9], np.int32)
    np.testing.assert_array_equal(trim_at_eos(row, EOS, 2), [1, 2, 7, 8])
    # EOS inside the prefix region does not count
    row2 = np.array([EOS, 2, 7, 8], np.int32)
    np.testing.assert_array_equal(trim_at_eos(row2, EOS, 2), row2)
    row3 = np.array([1, 2, 7, 8], np.int32)
    np.testing.assert_array_equal(trim_at_eos(row3, EOS, 2), row3)


def test_canonical_wav():
    out = canonical_wav(np.ones(10, np.float64), seconds=1.0, sample_rate=16)
    assert out.shape == (16,) and out.dtype == np.float32
    assert out[9] == 1.0 and out[10] == 0.0
    out = canonical_wav(np.ones(99), seconds=1.0, sample_rate=16)
    assert out.shape == (16,)


# -- audio engine ------------------------------------------------------------------


class DummyTok:
    def decode(self, ids):
        return ",".join(str(i) for i in ids)


def _lively(tree_decoder: dict, rng) -> None:
    """A random decoder that emits varied tokens and EOS (see
    tests/test_torch_av_whisper.py) and listens to its encoder: sharper
    cross-attention queries and louder values, so that different clips get
    different transcripts and a row mix-up in the engine would show."""
    tree_decoder["pos_embed"] = 4.0 * rng.standard_normal(
        tree_decoder["pos_embed"].shape).astype(np.float32)
    tree_decoder["embed_tokens"]["embedding"] *= np.float32(0.5)
    for layer in tree_decoder["layers"]:
        layer["cross_attn"]["q"]["kernel"] *= np.float32(8.0)
        layer["cross_attn"]["v"]["kernel"] *= np.float32(16.0)


@pytest.fixture(scope="module")
def asr_setup():
    asr = WhisperASR(config=WhisperConfig(**TINY), device="cpu")
    tree = random_asr_params(asr, seed=0)
    rng = np.random.default_rng(0)
    _lively(tree["decoder"], rng)
    # louder convolutions, so that the clip and not the sinusoid position
    # embedding decides the encoder's output
    tree["encoder"]["conv1"]["kernel"] *= np.float32(8.0)
    tree["encoder"]["conv2"]["kernel"] *= np.float32(4.0)
    load_jax_params(asr, tree)
    n = int(SECONDS * 16_000)
    t = np.arange(n) / 16_000
    wavs = [canonical_wav(0.3 * np.sin(2 * np.pi * (200 + 500 * i) * t)
                          + 0.02 * rng.standard_normal(n), seconds=SECONDS) for i in range(7)]

    def direct(wav):
        toks = asr.transcribe_tokens(wav[None], PREFIX, beam_size=BEAM, max_len=MAX_LEN,
                                     eos_id=EOS, pad_to=n).numpy()[0]
        return trim_at_eos(toks, EOS, len(PREFIX))

    return asr, tree, wavs, direct


def make_engine(asr, **kw):
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("max_wait_s", 0.05)
    return make_audio_engine(asr, PREFIX, beam_size=BEAM, max_len=MAX_LEN, eos_id=EOS,
                             seconds=SECONDS, **kw)


def test_engine_single_request_matches_direct(asr_setup):
    asr, _, wavs, direct = asr_setup
    with make_engine(asr, max_wait_s=0.0) as eng:
        res = eng.transcribe(wavs[0], timeout=WAIT)
    assert isinstance(res, ServeResult)
    np.testing.assert_array_equal(res.tokens, direct(wavs[0]))
    assert res.text is None
    assert res.bucket == 1
    assert res.total_ms >= res.decode_ms > 0 and res.queue_ms >= 0


def test_engine_batched_rows_match_independent_decodes(asr_setup):
    """Concurrent requests share a padded bucket, yet each row's tokens equal
    its own single-request decode: in fp32 on the CPU the padding is exact."""
    asr, _, wavs, direct = asr_setup
    with make_engine(asr, max_wait_s=0.25) as eng:
        futs = [eng.submit(w) for w in wavs[:3]]
        results = [f.result(timeout=WAIT) for f in futs]
        stats = eng.stats()
    for w, r in zip(wavs[:3], results):
        np.testing.assert_array_equal(r.tokens, direct(w))
    assert [r.bucket for r in results] == [4, 4, 4]
    assert stats["requests"] == 3 and stats["batches"] == 1
    assert stats["compiled_buckets"] == [4]
    assert len({tuple(r.tokens) for r in results}) == 3  # three different transcripts


def test_engine_bucket_counts_under_load(asr_setup):
    asr, _, wavs, direct = asr_setup
    with make_engine(asr, max_wait_s=0.01) as eng:
        futs = [eng.submit(w) for w in wavs]
        results = [f.result(timeout=WAIT) for f in futs]
        stats = eng.stats()
        log = list(eng.batch_log)
    for w, r in zip(wavs, results):
        np.testing.assert_array_equal(r.tokens, direct(w))
    assert stats["requests"] == len(wavs)
    assert set(stats["compiled_buckets"]) <= {1, 2, 4}
    assert sum(stats["bucket_counts"].values()) == stats["batches"] == len(log)
    assert sum(entry["rows"] for entry in log) == len(wavs)
    assert stats["pending"] == 0 and stats["latency_ms"]["p50"] > 0
    for entry in log:
        assert (entry["t_collate"] <= entry["t_dispatch"] <= entry["t_copied"]
                <= entry["t_launched"] <= entry["t_ready"])
        assert entry["h2d_device_ms"] is None  # no card, no copy to time


def test_engine_warmup_marks_every_bucket(asr_setup):
    asr, _, wavs, _ = asr_setup
    with make_engine(asr) as eng:
        eng.warmup((wavs[0],))
        stats = eng.stats()
    assert stats["compiled_buckets"] == [1, 2, 4]
    assert stats["requests"] == 0 and stats["batches"] == 0  # warm-up is not traffic


def test_engine_tokenizer_text(asr_setup):
    asr, _, wavs, direct = asr_setup
    with make_engine(asr, tokenizer=DummyTok(), max_wait_s=0.0) as eng:
        res = eng.transcribe(wavs[1], timeout=WAIT)
    expect = direct(wavs[1])
    assert res.text == ",".join(str(i) for i in expect[len(PREFIX):])


def test_engine_rejects_after_close(asr_setup):
    asr, _, wavs, _ = asr_setup
    eng = make_engine(asr)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(wavs[0])
    assert not eng._dispatcher.is_alive() and not eng._completer.is_alive()


def test_engine_applies_logit_rules(asr_setup):
    from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules

    asr, _, wavs, direct = asr_setup
    free = direct(wavs[2])
    banned = tuple(int(t) for t in np.unique(free[len(PREFIX):]))
    rules = LogitRules(vocab_size=TINY["vocab_size"], suppress=banned, eos_id=EOS)
    with make_engine(asr, logit_rules=rules, max_wait_s=0.0) as eng:
        res = eng.transcribe(wavs[2], timeout=WAIT)
    assert not np.isin(res.tokens[len(PREFIX):], banned).any()
    want = asr.transcribe_tokens(wavs[2][None], PREFIX, beam_size=BEAM, max_len=MAX_LEN,
                                 eos_id=EOS, pad_to=len(wavs[2]), logit_rules=rules).numpy()[0]
    np.testing.assert_array_equal(res.tokens, trim_at_eos(want, EOS, len(PREFIX)))


def test_int8_audio_engine_rows_match_direct_decodes(asr_setup):
    """``weight_quant="int8"``: batched rows equal each clip's own int8
    decode."""
    asr, _, wavs, _ = asr_setup
    n = int(SECONDS * 16_000)
    with make_engine(asr, weight_quant="int8", max_wait_s=0.25) as eng:
        results = [f.result(timeout=WAIT) for f in [eng.submit(w) for w in wavs[:3]]]
    for w, r in zip(wavs[:3], results):
        want = asr.transcribe_tokens(w[None], PREFIX, beam_size=BEAM, max_len=MAX_LEN,
                                     eos_id=EOS, pad_to=n, weight_quant="int8").numpy()[0]
        np.testing.assert_array_equal(r.tokens, trim_at_eos(want, EOS, len(PREFIX)))
    assert [r.bucket for r in results] == [4, 4, 4]
    assert len({tuple(r.tokens) for r in results}) == 3


# -- the generic engine: failures, threads, defaults -----------------------------------


def test_failed_decode_fails_its_futures_and_the_engine_goes_on():
    calls = []

    def decode(batch):
        (x,) = batch
        calls.append(int(x.shape[0]))
        if bool((x < 0).any()):
            raise ValueError("bad batch")
        return (x[:, None] * torch.ones(3)).long()

    with ServingEngine(decode, buckets=(1, 2), max_wait_s=0.0, device="cpu") as eng:
        bad = eng.submit(np.float32(-1.0))
        with pytest.raises(ValueError, match="bad batch"):
            bad.result(timeout=WAIT)
        good = eng.transcribe(np.float32(4.0), timeout=WAIT)
        with pytest.raises(ValueError, match="bad batch"):  # warm-up raises to its caller
            eng.warmup((np.float32(-1.0),))
        stats = eng.stats()
    np.testing.assert_array_equal(good.tokens, [4, 4, 4])
    assert stats["requests"] == 1 and stats["batches"] == 1  # the failed batch counts nowhere


def test_failed_postprocess_fails_only_its_row():
    def post(row):
        if row[0] == 7:
            raise KeyError("no text for 7")
        return row, "ok"

    decode = lambda batch: batch[0][:, None].long()
    with ServingEngine(decode, buckets=(2,), max_wait_s=0.2, postprocess=post,
                       device="cpu") as eng:
        f_bad, f_good = eng.submit(np.float32(7)), eng.submit(np.float32(5))
        assert f_good.result(timeout=WAIT).text == "ok"
        with pytest.raises(KeyError):
            f_bad.result(timeout=WAIT)


def test_decode_runs_without_grad_on_the_dispatch_thread():
    seen = {}

    def decode(batch):
        seen["grad"] = torch.is_grad_enabled()
        seen["thread"] = threading.current_thread().name
        seen["type"] = type(batch[0])
        return torch.zeros((batch[0].shape[0], 2), dtype=torch.long)

    with ServingEngine(decode, buckets=(1,), max_wait_s=0.0, device="cpu") as eng:
        eng.transcribe(np.zeros(4, np.float32), timeout=WAIT)
    assert seen == {"grad": False, "thread": "serve-dispatch", "type": torch.Tensor}
    assert torch.is_grad_enabled()  # the caller's thread keeps its own mode


def test_queue_limit_and_pending_requests_fail_on_close():
    release = threading.Event()

    def decode(batch):
        release.wait(timeout=WAIT)
        return torch.zeros((batch[0].shape[0], 1), dtype=torch.long)

    eng = ServingEngine(decode, buckets=(1,), max_wait_s=0.0, max_queue=2, device="cpu")
    try:
        first = eng.submit(np.float32(0))
        for _ in range(200):  # until the dispatch thread has taken the first request
            if eng.stats()["pending"] == 0:
                break
            threading.Event().wait(0.01)
        waiting = [eng.submit(np.float32(i)) for i in (1, 2)]
        with pytest.raises(RuntimeError, match="queue full"):
            eng.submit(np.float32(3))
    finally:
        closer = threading.Thread(target=eng.close)
        closer.start()
        release.set()
        closer.join(timeout=WAIT)
    assert not closer.is_alive()
    assert first.result(timeout=WAIT).bucket == 1
    for fut in waiting:  # resolved by a late dispatch or failed by close, never left hanging
        assert fut.done() or fut.exception(timeout=WAIT) is not None


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(lambda batch: batch[0])


def test_concurrent_submitters_lose_no_request():
    """More submitting threads than cores, a short switch interval: every
    request gets its own row back and the counters add up."""
    import sys

    decode = lambda batch: batch[0][:, None].long().expand(-1, 2)
    results, errors = {}, []

    def client(eng, base):
        try:
            for i in range(base, base + 8):
                results[i] = eng.transcribe(np.float32(i), timeout=WAIT).tokens.tolist()
        except Exception as e:  # collected and asserted empty below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServingEngine(decode, buckets=(1, 2, 4, 8), max_wait_s=0.002,
                           device="cpu") as eng:
            threads = [threading.Thread(target=client, args=(eng, 8 * t)) for t in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
            stats = eng.stats()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert results == {i: [i, i] for i in range(128)}
    assert stats["requests"] == 128
    assert sum(stats["bucket_counts"].values()) == stats["batches"]


# -- AV engine ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def av_setup():
    """A tiny AVWhisperNet and raw uint8 per-request payloads in the
    engine's convention."""
    cfg = dict(TINY, max_source_positions=64)
    net = AVWhisperNet(modelargs=(32, 4, 2, 3000, 128, 0.0), vocab_size=64, device="cpu",
                       whisper_config=WhisperConfig(**cfg))
    tree = random_jax_params(net, seed=1)
    rng = np.random.default_rng(1)
    for layer in tree["trunk"]["fusion"]["layers"]:
        layer["attn_gate"], layer["ff_gate"] = np.float32(0.5), np.float32(-0.3)
    _lively(tree["decoder"], rng)
    load_jax_params(net, tree)
    t_video, hw = 6, 32

    def payload(i):
        return (np.asarray(rng.standard_normal((80, 128)), np.float32), np.ones(128, bool),
                rng.integers(0, 255, (t_video, 3, hw, hw)).astype(np.uint8),
                np.ones(t_video, bool), np.int32(t_video - (i % 2)))

    payloads = [payload(i) for i in range(3)]

    def direct(p):
        audio, audio_mask, video_u8, video_mask, video_len = (
            torch.from_numpy(np.asarray(x)[None]) for x in p)
        video = eval_video_pipeline(video_u8, resize=hw)
        toks = net.beam((audio, audio_mask, video, video_mask, video_len), PREFIX,
                        beam_size=BEAM, max_len=MAX_LEN, eos_id=EOS).sequences[0, 0].numpy()
        return trim_at_eos(toks, EOS, len(PREFIX))

    return net, payloads, direct, hw


def _av_engine(net, hw, **kw):
    return make_av_engine(net, PREFIX, beam_size=BEAM, max_len=MAX_LEN, eos_id=EOS,
                          video_resize=hw, **kw)


def test_av_engine_matches_direct_beam(av_setup):
    """``make_av_engine`` rows equal the top beam hypothesis of a
    single-request decode (uint8 frames preprocessed by the engine's decode)."""
    net, payloads, direct, hw = av_setup
    with _av_engine(net, hw, buckets=(1, 2), max_wait_s=0.25) as eng:
        futs = [eng.submit(*p) for p in payloads]
        results = [f.result(timeout=WAIT) for f in futs]
        stats = eng.stats()
    for p, r in zip(payloads, results):
        assert r.tokens.ndim == 1  # one row per request, not [beam, L]
        np.testing.assert_array_equal(r.tokens, direct(p))
    assert stats["requests"] == 3
    assert set(stats["compiled_buckets"]) <= {1, 2}


def test_av_engine_tensor_payloads_and_explicit_layout(av_setup):
    """Tensor payload rows take the torch collate and reproduce the host
    rows; explicit ``read_windows`` / ``cache_layout`` are accepted no-ops."""
    net, payloads, direct, hw = av_setup
    rows = [tuple(torch.as_tensor(x) for x in p) for p in payloads[:2]]
    with _av_engine(net, hw, buckets=(2,), max_wait_s=0.25, read_windows=(4, MAX_LEN),
                    cache_layout="bhjtd") as eng:
        futs = [eng.submit(*p) for p in rows]
        results = [f.result(timeout=WAIT) for f in futs]
    for p, r in zip(payloads, results):
        np.testing.assert_array_equal(r.tokens, direct(p))


@pytest.mark.parametrize("quant", [dict(cache_quant="int8-cross"),
                                   dict(cache_quant="int8", weight_quant="int8")],
                         ids=["c8x", "w8-c8"])
def test_int8_av_engine_matches_direct_beam(av_setup, quant):
    net, payloads, _, hw = av_setup

    def direct(p):
        audio, audio_mask, video_u8, video_mask, video_len = (
            torch.from_numpy(np.asarray(x)[None]) for x in p)
        video = eval_video_pipeline(video_u8, resize=hw)
        toks = net.beam((audio, audio_mask, video, video_mask, video_len), PREFIX,
                        beam_size=BEAM, max_len=MAX_LEN, eos_id=EOS,
                        **quant).sequences[0, 0].numpy()
        return trim_at_eos(toks, EOS, len(PREFIX))

    with _av_engine(net, hw, buckets=(1, 2), max_wait_s=0.25, **quant) as eng:
        results = [f.result(timeout=WAIT) for f in [eng.submit(*p) for p in payloads]]
    for p, r in zip(payloads, results):
        np.testing.assert_array_equal(r.tokens, direct(p))


def test_av_engine_tokenizer_text(av_setup):
    net, payloads, direct, hw = av_setup
    with _av_engine(net, hw, tokenizer=DummyTok(), buckets=(1,), max_wait_s=0.0) as eng:
        res = eng.transcribe(*payloads[0], timeout=WAIT)
    expect = direct(payloads[0])
    assert res.text == ",".join(str(i) for i in expect[len(PREFIX):])


# -- HTTP server -------------------------------------------------------------------


def _post(host, port, path, body) -> tuple[int, dict]:
    conn = http.client.HTTPConnection(host, port, timeout=WAIT)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _get(host, port, path) -> tuple[int, dict]:
    conn = http.client.HTTPConnection(host, port, timeout=WAIT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_http_server_roundtrip(asr_setup):
    asr, _, wavs, direct = asr_setup
    with make_engine(asr, tokenizer=DummyTok(), max_wait_s=0.0) as eng:
        with TranscriptionServer(eng, port=0, seconds=SECONDS) as srv:
            host, port = srv.address
            assert host == "127.0.0.1" and port > 0
            status, body = _get(host, port, "/healthz")
            assert status == 200 and body == {"ok": True}

            status, body = _post(host, port, "/v1/transcribe", {"audio": wavs[0].tolist()})
            assert status == 200, body
            expect = direct(wavs[0])
            assert body["tokens"] == [int(t) for t in expect]
            assert body["text"] == ",".join(str(i) for i in expect[len(PREFIX):])
            assert body["bucket"] == 1
            assert set(body) == {"text", "tokens", "queue_ms", "decode_ms", "total_ms",
                                 "bucket"}

            status, body2 = _post(
                host, port, "/v1/transcribe",
                {"audio_b64": base64.b64encode(wavs[0].astype(np.float32).tobytes()).decode()})
            assert status == 200 and body2["tokens"] == body["tokens"]


def test_http_metrics_and_errors(asr_setup):
    asr, _, wavs, _ = asr_setup
    with make_engine(asr, max_wait_s=0.0) as eng:
        with TranscriptionServer(eng, port=0, seconds=SECONDS) as srv:
            host, port = srv.address
            for _ in range(2):
                assert _post(host, port, "/v1/transcribe", {"audio": wavs[3].tolist()})[0] == 200
            status, metrics = _get(host, port, "/metrics")
            assert status == 200 and metrics["requests"] == 2
            assert set(metrics) == {"requests", "batches", "bucket_counts", "compiled_buckets",
                                    "pending", "latency_ms"}
            assert metrics["bucket_counts"] == {"1": 2}  # JSON object keys are strings

            status, err = _post(host, port, "/v1/transcribe", {"nope": 1})
            assert status == 400 and "error" in err
            status, err = _post(host, port, "/v1/other", {"audio": [0.0]})
            assert status == 404
            status, err = _get(host, port, "/nothing")
            assert status == 404


def test_http_decode_failure_is_a_503():
    def decode(batch):
        raise RuntimeError("kernel build failed")

    with ServingEngine(decode, buckets=(1,), max_wait_s=0.0, device="cpu") as eng:
        with TranscriptionServer(eng, port=0, seconds=SECONDS) as srv:
            status, err = _post(*srv.address, "/v1/transcribe", {"audio": [0.0, 0.1]})
    assert status == 503 and "kernel build failed" in err["error"]


def test_http_concurrent_requests_batched(asr_setup):
    """Several simultaneous HTTP clients ride one micro-batch and all get
    their own correct transcripts back."""
    asr, _, wavs, direct = asr_setup
    results = {}

    def client(host, port, i):
        results[i] = _post(host, port, "/v1/transcribe", {"audio": wavs[i].tolist()})

    with make_engine(asr, max_wait_s=0.5) as eng:
        with TranscriptionServer(eng, port=0, seconds=SECONDS) as srv:
            host, port = srv.address
            threads = [threading.Thread(target=client, args=(host, port, i)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
            stats = eng.stats()
    for i in range(3):
        status, body = results[i]
        assert status == 200, body
        assert body["tokens"] == [int(t) for t in direct(wavs[i])]
    assert stats["batches"] < 3  # at least two of the three shared a batch


# -- the command -----------------------------------------------------------------------


def test_serve_tool_on_the_cpu_answers_a_request(tmp_path):
    """``tools.serve`` with ``--device cpu``: random whisper-tiny weights
    from a seed, a saved and reloaded checkpoint, one request over HTTP."""
    from mocov2_whisper_flamingo_torch.tools import serve

    common = ["--model", "whisper-tiny", "--device", "cpu", "--no-warmup", "--buckets", "1",
              "--max-len", "7", "--beam-size", "2", "--max-wait-ms", "0"]
    engine = serve.build_engine(serve.parse_args(["--random-init", "--seed", "3", *common]))
    try:
        with TranscriptionServer(engine, port=0) as srv:
            wav = (0.1 * np.random.default_rng(0).standard_normal(8000)).astype(np.float32)
            status, body = _post(*srv.address, "/v1/transcribe", {"audio": wav.tolist()})
            assert status == 200, body
            assert _get(*srv.address, "/metrics")[1]["requests"] == 1
    finally:
        engine.close()
    assert body["tokens"][:4] == [1, 2, 3, 4] and isinstance(body["text"], str)

    # the same weights through --checkpoint give the same tokens
    asr = WhisperASR("whisper-tiny", device="cpu")
    load_jax_params(asr, random_asr_params(asr, 3))
    path = tmp_path / "asr.pt"
    torch.save(asr.state_dict(), path)
    engine = serve.build_engine(serve.parse_args(["--checkpoint", str(path), *common]))
    try:
        res = engine.transcribe(canonical_wav(wav), timeout=WAIT)
    finally:
        engine.close()
    assert [int(t) for t in res.tokens] == body["tokens"]


def test_serve_tool_refuses_an_orbax_directory_and_a_missing_source(tmp_path):
    from mocov2_whisper_flamingo_torch.tools import serve

    with pytest.raises(SystemExit, match="tools/convert_checkpoint"):
        serve.load_checkpoint(None, str(tmp_path))
    with pytest.raises(SystemExit):  # neither --checkpoint nor --random-init
        serve.parse_args(["--model", "whisper-tiny"])


# -- parity with the JAX package's engine ----------------------------------------------


def test_audio_engine_tokens_match_the_jax_engine(asr_setup):
    """The same three waveforms through the port's audio engine and through
    the JAX package's, on the same weights: identical token rows."""
    from mocov2_whisper_flamingo_tpu.models.asr import WhisperASR as JASR
    from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
    from mocov2_whisper_flamingo_tpu.serving import make_audio_engine as jax_audio_engine

    asr, tree, wavs, _ = asr_setup
    jasr = JASR(config=JConfig(**TINY), backend="xla")
    params = jax.tree.map(jnp.asarray, tree)
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, eos_id=EOS, seconds=SECONDS, buckets=(1, 4),
              max_wait_s=0.25)
    with jax_audio_engine(jasr, params, PREFIX, **kw) as jeng:
        want = [f.result(timeout=WAIT) for f in [jeng.submit(w) for w in wavs[:3]]]
    with make_audio_engine(asr, PREFIX, **kw) as eng:
        got = [f.result(timeout=WAIT) for f in [eng.submit(w) for w in wavs[:3]]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.bucket == w.bucket == 4
    assert len({tuple(g.tokens) for g in got}) == 3  # three different transcripts
