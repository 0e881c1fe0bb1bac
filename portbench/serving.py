"""What the serving drivers share: the continuous engine built from a
configuration, the pool of clips on the card, the request records, the
traced stretch, and the check of what was served.

Each request is one 30 s clip (its log-mel and its raw uint8 lip frames)
through ``ContinuousEngine.submit``. A request's record keeps when it was
due (its place in the schedule, or its submission in a closed loop), when
its result arrived (the future's callback, on the engine's thread) and the
engine's own ``queue_ms`` and ``decode_ms``.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import numpy as np
import torch

from portbench import inputs, weights
from portbench.reference import compare
from portbench.reference import model as M
from portbench.reference import spec
from portbench.trace import MARK_FROM, MARK_TO, Stretch

NO_ANSWER = 1e30  # the token gap of a run that served nothing to check


@dataclasses.dataclass
class Request:
    clip: int
    due: float
    done: float | None = None
    ok: bool = False
    error: str | None = None
    queue_ms: float | None = None
    decode_ms: float | None = None
    tokens: np.ndarray | None = None


def _finished(req: Request, fut) -> None:
    req.done = time.monotonic()
    try:
        res = fut.result()
    except Exception as e:  # the engine failed the request: a miss
        req.error = repr(e)
        return
    req.ok, req.queue_ms, req.decode_ms, req.tokens = True, res.queue_ms, res.decode_ms, res.tokens


class Pool:
    """``clips`` distinct clips on the device, made from the seed."""

    def __init__(self, ctx):
        cfg, p = ctx.config, ctx.params
        gen = inputs.generator(ctx.seed, ctx.device)
        self.mel, self.raw = inputs.clips(gen, p["clips"], cfg["mel_frames"],
                                          cfg["whisper"]["n_mels"], p["frames"], p["raw_size"],
                                          ctx.device)
        dev = ctx.device
        self.audio_mask = torch.ones(cfg["mel_frames"], dtype=torch.bool, device=dev)
        self.video_mask = torch.ones(p["frames"], dtype=torch.bool, device=dev)
        self.video_len = torch.tensor(p["frames"], dtype=torch.long, device=dev)
        self.order = torch.randperm(p["clips"], generator=torch.Generator().manual_seed(
            int(ctx.seed) % (1 << 63))).tolist()

    def __len__(self) -> int:
        return self.mel.shape[0]

    def payload(self, i: int) -> tuple:
        return (self.mel[i], self.audio_mask, self.raw[i], self.video_mask, self.video_len)

    def clip_of(self, j: int) -> int:
        """The clip of the ``j``-th request."""
        return self.order[j % len(self.order)]


def build(ctx):
    """The net (weights from the seed) and its continuous engine, warmed up:
    the admission encode at every bucket, the segment's graph, one full
    decode through the loop."""
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
    from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig
    from mocov2_whisper_flamingo_torch.serving import make_continuous_av_engine

    cfg, p = ctx.config, ctx.params
    m = cfg["model"]
    net = AVWhisperNet("audiovisual", None, 96,
                       (m["d_model"], m["n_heads"], m["n_layers"], m["pe_max_len"],
                        m["fc_hidden_size"], m["dropout"]),
                       cfg["vocab_size"], precision=L.BF16, device=ctx.device,
                       whisper_config=WhisperConfig(**cfg["whisper"]))
    weights.fill_module(net, spec.model_parameters(cfg), ctx.seed)
    net.eval()
    engine = make_continuous_av_engine(
        net, cfg["prefix_ids"], beam_size=p["beam"], max_len=p["max_tokens"],
        eos_id=cfg["eos_id"], capacity=p["capacity"], seg_steps=p["seg_steps"],
        video_resize=p["resize"])
    return net, engine


class Session:
    """One run's engine, pool and requests."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.net, self.engine = build(ctx)
        self.pool = Pool(ctx)
        self.engine.warmup(self.pool.payload(self.pool.clip_of(0)), ctx.params["buckets"])
        self.requests: list[Request] = []
        self._lock = threading.Lock()

    def submit(self, due: float | None = None, on_done=None) -> Request:
        with self._lock:
            req = Request(clip=self.pool.clip_of(len(self.requests)),
                          due=time.monotonic() if due is None else due)
            self.requests.append(req)
        fut = self.engine.submit(*self.pool.payload(req.clip))

        def done(f):
            _finished(req, f)
            if on_done is not None:
                on_done(req)

        fut.add_done_callback(done)
        return req

    def open_loop(self, gaps, t0: float) -> dict:
        """Start a thread that submits one request after each of ``gaps``
        (seconds, from ``t0``), each due at its place in the schedule.
        Returns the thread's record: ``thread`` and ``late_s`` (how late it
        ran at worst)."""
        out = {"late_s": 0.0}

        def generate():
            due = t0
            for gap in gaps:
                due += gap
                while (now := time.monotonic()) < due:
                    time.sleep(min(due - now, 0.002))
                out["late_s"] = max(out["late_s"], now - due)
                self.submit(due)

        out["thread"] = threading.Thread(target=generate, name="portbench-arrivals", daemon=True)
        out["thread"].start()
        return out

    def closed_loop(self, clients: int, stagger_s: float):
        """Start ``clients`` callers, each sending its next clip when its
        last is answered; their first clips come one after another over
        ``stagger_s``. Returns the function that stops them.

        Staggered first requests are admitted at different segment
        boundaries, and every row keeps its phase after (a row refills the
        boundary it empties), so answers come at every boundary. Sent at
        once, 16 rows would answer in waves of 16, and the answers a
        window counts would jump by a whole wave with its edges."""
        stopped = threading.Event()

        def again(_req):
            if not stopped.is_set():
                self.submit(on_done=again)

        def start():
            for i in range(clients):
                if stopped.wait(stagger_s / clients if i else 0.0):
                    return
                self.submit(on_done=again)

        threading.Thread(target=start, name="portbench-clients", daemon=True).start()
        return stopped.set

    def drain(self, t1: float) -> None:
        """Wait for every answer until ``drain_s`` past the window's close."""
        deadline = max(t1, time.monotonic()) + self.ctx.params["drain_s"]
        while time.monotonic() < deadline:
            with self._lock:
                if all(r.done is not None for r in self.requests):
                    return
            time.sleep(0.01)

    def traced_stretch(self, traffic) -> dict:
        """The traced run's device trace, after the window: the profiler
        starts with the engine idle, ``traffic(t0)`` starts the cell's
        traffic again and returns the function that ends it; the stretch
        kept is ``trace_s`` seconds from ``trace_after`` on (the loop in its
        steady state), and the engine is closed, its work over, before the
        profiler stops (a profiler started or stopped while another thread
        launches graphs has been seen to record nothing, or to hang)."""
        p = self.ctx.params
        first = len(self.requests)
        stretch = Stretch(self.ctx.tmp)
        stretch.start()
        t0 = time.monotonic()
        end_traffic = traffic(t0)
        time.sleep(max(t0 + p["trace_after"] - time.monotonic(), 0.0))
        stretch.mark(MARK_FROM)
        lo = time.monotonic()
        time.sleep(p["trace_s"])
        stretch.mark(MARK_TO)
        hi = time.monotonic()
        end_traffic()
        self.engine.close()
        stretch.stop()
        with self._lock:
            extra, self.requests = self.requests[first:], self.requests[:first]
        traced = stretch.read()
        traced["requests_done"] = sum(1 for r in extra if r.ok and lo <= r.done <= hi)
        return traced

    def finish(self, t0: float, t1: float, setup_s: float, in_window, traffic=None) -> dict:
        """Read the peak, draw the sample, trace (a traced run: ``traffic``
        as ``traced_stretch`` takes it), close the engine and free the
        program; the run's record. ``in_window(req)``: whether a request
        counts as attempted."""
        ctx = self.ctx
        peak = torch.cuda.max_memory_reserved(ctx.device) if ctx.device.type == "cuda" else 0
        with self._lock:
            requests = list(self.requests)
        attempted = [r for r in requests if in_window(r)]
        sample = self._sample([r for r in requests if r.ok])
        traced = self.traced_stretch(traffic) if ctx.trace else None
        self.engine.close()
        record = {"setup_s": setup_s, "window": (t0, t1), "window_s": t1 - t0,
                  "requests": [dataclasses.replace(r, tokens=None) for r in requests],
                  "audio_s": ctx.config["mel_frames"] / 100.0,
                  "attempted": len(attempted), "failed": sum(1 for r in attempted if not r.ok),
                  "peak_mem_bytes": peak, "trace": traced, "kind": "serve",
                  "sample": [(r.clip, r.tokens) for r in sample],
                  "sample_clips": (self.pool.mel[[r.clip for r in sample]].cpu(),
                                   self.pool.raw[[r.clip for r in sample]].cpu())}
        del self.net, self.engine, self.pool
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return record

    def _sample(self, served: list) -> list:
        """``sample`` served requests drawn from the seed, the longest first."""
        n = min(self.ctx.params["sample"], len(served))
        if not n:
            return []
        longest = max(served, key=lambda r: len(r.tokens))
        rest = [r for r in served if r is not longest]
        g = torch.Generator().manual_seed(int(self.ctx.seed) % (1 << 63) + 1)
        picks = torch.randperm(len(rest), generator=g)[: n - 1].tolist()
        return [longest] + [rest[i] for i in picks]


def reference_logits(ctx, record, precision: M.Precision = M.FP32, W: dict | None = None):
    """Teacher-forced reference logits of each sampled request, as
    ``[(tokens, logits [L - 1, V])]``."""
    cfg, p = ctx.config, ctx.params
    dev = ctx.device
    if dev.type == "cuda":
        M.exact_float32()
    if W is None:
        W = weights.as_dict(spec.model_parameters(cfg), ctx.seed, dev)
    mel, raw = record["sample_clips"]
    out = []
    for i, (_, tokens) in enumerate(record["sample"]):
        enc, valid = M.encode(precision, W, cfg, mel[i:i + 1].to(dev), raw[i:i + 1].to(dev),
                              torch.tensor([p["frames"]], device=dev), p["resize"])
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
        logits = M.decoder_logits(precision, W, cfg["whisper"], toks[None, :-1], enc, valid)[0]
        out.append((toks, logits))
    return out


def check(ctx, record) -> dict:
    """``token_gap`` over the sampled requests; a run that served none fails."""
    k = 2 * ctx.params["beam"]
    first = len(ctx.config["prefix_ids"]) - 1
    gaps = [compare.token_gap(logits, toks, first, k) for toks, logits in
            reference_logits(ctx, record)]
    tokens = sum(len(toks) for _, toks in record.pop("sample"))
    record.pop("sample_clips")
    return {"token_gap": max(gaps) if gaps else NO_ANSWER, "_served_tokens_checked": tokens}
