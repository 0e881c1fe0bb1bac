"""Online serving engine: dynamic batching over the decode paths (counterpart
of ``serving/engine.py``)::

    requests --> FIFO queue --> micro-batcher (bucket ladder, deadline)
             --> pad + stack --> copy to the card, decode   (dispatch thread)
             --> result on the host --> per-row futures     (completion thread)

How the JAX engine's asynchronous dispatch is rendered in PyTorch:

- **Two threads, one stream.** The encode and the decode are replayed CUDA
  graphs (``decode/programs.py``), so the dispatch thread enqueues a batch
  in a few launches: it collates a batch into pinned host memory, copies it
  to the card, replays the encode and the decode and starts the copy of
  the token rows into a pinned host buffer, all on one CUDA stream that the
  engine owns, then records an event and hands the batch on. The completion thread
  waits on that event (the GIL is released while it waits), runs
  ``postprocess`` and resolves the futures. What overlaps is the tail of
  batch N on the device and its post-processing with the collate of batch
  N+1; ``batch_log`` keeps the timestamps that show how much.
- **Warm-up on the same stream.** The caching allocator pools memory per
  stream, so ``warmup`` runs through the engine's stream too; warm-up and
  live batches take turns under one lock. A warmed bucket has had its
  kernels built, cuDNN's algorithms chosen, its encode and its decode
  captured as CUDA graphs (through the model's ``encode`` and
  ``decode_programs``) and its allocator pools filled;
  ``stats()["compiled_buckets"]`` lists the warmed buckets under the JAX
  engine's name for them.
- **Thread-local state.** Grad mode and the current stream are per thread;
  every decode sets both itself.
- **Row independence.** Decoding is per row (beam search carries no state
  across rows), so padding with zero rows and slicing them off is exact in
  exact arithmetic. On the card a library may pick another algorithm at
  another batch size, so a bf16 row is reproducible per bucket: it equals a
  direct decode of the same padded batch.

A decode that raises fails the futures of its batch; nothing falls back to
another device or another kernel.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.device import resolve_device
from mocov2_whisper_flamingo_torch.serving.batcher import DEFAULT_BUCKETS, MicroBatcher


@dataclass
class ServeResult:
    """Per-request result: raw token row plus (optional) text and timing."""

    tokens: np.ndarray
    text: str | None
    queue_ms: float   # enqueue -> dispatch
    decode_ms: float  # dispatch -> result on the host (shared by the batch)
    total_ms: float   # enqueue -> future resolved
    bucket: int


@dataclass
class _Pending:
    payload: tuple
    future: Future
    t_enqueue: float


@dataclass
class _InFlight:
    rows: list  # of _Pending
    host_out: torch.Tensor  # token rows on the host (pinned while the copy runs)
    done: Any  # CUDA event recorded after the result's copy, None on the CPU
    bucket: int
    t_dispatch: float
    log: dict


def pad_rows(payloads: Sequence[tuple], bucket: int, pin_memory: bool = False) -> tuple:
    """Stack per-request payload tuples into one batch tree, zero-padded to
    ``bucket`` rows. Exact: the pad rows are sliced off after the decode.

    Host rows (numpy) are stacked on the host into numpy arrays, or, with
    ``pin_memory``, written straight into page-locked CPU tensors from which
    the copy to the card does not block the host. Rows that are
    ``torch.Tensor``s (a pipeline whose payloads already live on the card)
    are stacked on their device, pad rows included, with no trip through
    the host."""
    n = len(payloads)
    if any(isinstance(x, torch.Tensor) for x in payloads[0]):
        device = next(x.device for x in payloads[0] if isinstance(x, torch.Tensor))
        leaves = []
        for parts in zip(*payloads):
            stacked = torch.stack([torch.as_tensor(p, device=device) for p in parts])
            if n < bucket:
                pad = torch.zeros((bucket - n,) + stacked.shape[1:], dtype=stacked.dtype,
                                  device=device)
                stacked = torch.cat([stacked, pad])
            leaves.append(stacked)
        return tuple(leaves)
    leaves = []
    for parts in zip(*payloads):
        first = np.asarray(parts[0])
        if pin_memory:
            out = torch.empty((bucket,) + first.shape, pin_memory=True,
                              dtype=torch.from_numpy(np.empty((0,), first.dtype)).dtype)
            stacked = out.numpy()
        else:
            out = stacked = np.empty((bucket,) + first.shape, first.dtype)
        for i, p in enumerate(parts):
            stacked[i] = p
        stacked[n:] = 0
        leaves.append(out)
    return tuple(leaves)


class ServingEngine:
    """Generic batched-decode service.

    ``decode_batch(batch_tree) -> tokens``: a function over a stacked payload
    tree (one tensor on the engine's device per payload element, leading dim
    = bucket) that returns per-row token ids ``[bucket, L]``. It runs under
    ``torch.no_grad()`` on the engine's stream.

    ``postprocess(tokens_row) -> (tokens_row, text | None)``: host-side
    per-row finishing (EOS trim, tokenizer decode); runs on the completion
    thread.

    ``device``: where the batches go; the CUDA card unless ``"cpu"`` is asked
    for. ``batch_log`` holds, for the last 256 batches, the bucket, the row
    count, the host times of collate and dispatch, the time the result was
    ready and the copy's time on the device.
    """

    def __init__(
        self,
        decode_batch: Callable[[tuple], Any],
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_wait_s: float = 0.005,
        postprocess: Callable[[np.ndarray], tuple] | None = None,
        max_queue: int = 1024,
        device: str | torch.device | None = "cuda",
    ):
        self._decode = decode_batch
        self._batcher = MicroBatcher(tuple(buckets), max_wait_s)
        self._post = postprocess or (lambda row: (row, None))
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = None
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            # The model's weights were written on the current stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._device_lock = threading.Lock()  # warm-up and live batches take turns
        self._pending: list[_Pending] = []
        self._lock = threading.Condition()
        self._inflight: queue.Queue[_InFlight | None] = queue.Queue(maxsize=4)
        self._running = True
        self._max_queue = max_queue
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._bucket_counts: dict[int, int] = {}
        self._latency_ms: list[float] = []  # bounded ring, see _record
        self._compiled: set[int] = set()
        self.batch_log: collections.deque[dict] = collections.deque(maxlen=256)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name="serve-complete", daemon=True)
        self._dispatcher.start()
        self._completer.start()

    # -- client API ---------------------------------------------------------------

    def submit(self, *payload) -> Future:
        """Enqueue one request (payload = per-row arrays matching the
        ``decode_batch`` tree). Returns a Future resolving to ``ServeResult``."""
        fut: Future = Future()
        with self._lock:
            if not self._running:
                raise RuntimeError("engine is closed")
            if len(self._pending) >= self._max_queue:
                raise RuntimeError(
                    f"serving queue full ({self._max_queue}); shed load")
            self._pending.append(_Pending(payload, fut, time.monotonic()))
            self._lock.notify()
        return fut

    def transcribe(self, *payload, timeout: float | None = None) -> ServeResult:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(*payload).result(timeout=timeout)

    def warmup(self, example_payload: tuple,
               buckets: Sequence[int] | None = None) -> None:
        """Decode one batch of every bucket from a replicated example row, on
        the engine's stream, so that live traffic never waits for a kernel
        build, cuDNN's algorithm search, a decode program's capture or a
        first allocation. On the card every bucket is decoded twice: the
        first batch captures the bucket's decode program
        (``decode/programs.py``), and a capture empties the allocator's cache,
        which the second fills again. Raises what the decode raises."""
        passes = 2 if self._cuda else 1
        for b in sorted(buckets or self._batcher.buckets) * passes:
            self._wait(self._run([tuple(example_payload)] * b, b, rows=[]))
            with self._stats_lock:
                self._compiled.add(b)

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latency_ms)
            pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
                   if lat else None)
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "bucket_counts": dict(self._bucket_counts),
                "compiled_buckets": sorted(self._compiled),
                "pending": len(self._pending),
                "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                               "p99": pct(0.99)},
            }

    def close(self) -> None:
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._dispatcher.join(timeout=30)
        self._inflight.put(None)
        self._completer.join(timeout=30)
        with self._lock:
            for p in self._pending:
                p.future.set_exception(RuntimeError("engine closed"))
            self._pending.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- one batch ------------------------------------------------------------------

    def _to_device(self, batch: tuple) -> tuple:
        """The collated tree as tensors on the engine's device. Pinned host
        tensors are copied without blocking the host; tensors that already
        lie on the card stay there, and the engine's stream waits for the
        card's default stream, on which their producer is taken to have run."""
        if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda for leaf in batch):
            self._stream.wait_stream(torch.cuda.default_stream(self.device))
        out = []
        for leaf in batch:
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(leaf)
            if leaf.is_cuda:
                leaf.record_stream(self._stream)
            out.append(leaf.to(self.device, non_blocking=True))
        return tuple(out)

    def _run(self, payloads: Sequence[tuple], bucket: int, rows: list) -> _InFlight:
        """Collate, copy to the device, decode and start the result's copy to
        the host, for the pending requests ``rows`` (none for a warm-up).
        Returns without waiting for the device."""
        t_collate = time.monotonic()
        batch = pad_rows(payloads, bucket, pin_memory=self._cuda)
        t_dispatch = time.monotonic()
        log = {"bucket": bucket, "rows": len(payloads), "t_collate": t_collate,
               "t_dispatch": t_dispatch}
        with self._device_lock, torch.no_grad():
            if not self._cuda:
                dev_batch = self._to_device(batch)
                log["t_copied"] = time.monotonic()
                out = torch.as_tensor(self._decode(dev_batch))
                log["t_launched"] = time.monotonic()
                return _InFlight(rows, out, None, bucket, t_dispatch, log)
            with torch.cuda.stream(self._stream):
                copy_start = torch.cuda.Event(enable_timing=True)
                copy_end = torch.cuda.Event(enable_timing=True)
                copy_start.record()
                dev_batch = self._to_device(batch)
                copy_end.record()
                log["t_copied"] = time.monotonic()
                out = torch.as_tensor(self._decode(dev_batch))
                if out.is_cuda:
                    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    host.copy_(out, non_blocking=True)
                else:
                    host = out
                done = torch.cuda.Event()
                done.record()
        log["t_launched"] = time.monotonic()
        log["copy_events"] = (copy_start, copy_end)
        return _InFlight(rows, host, done, bucket, t_dispatch, log)

    def _wait(self, item: _InFlight) -> np.ndarray:
        """Block until the batch's token rows are on the host."""
        if item.done is not None:
            item.done.synchronize()
        item.log["t_ready"] = time.monotonic()
        events = item.log.pop("copy_events", None)
        item.log["h2d_device_ms"] = events[0].elapsed_time(events[1]) if events else None
        self.batch_log.append(item.log)
        return item.host_out.numpy()

    # -- pipeline threads -----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                while self._running:
                    now = time.monotonic()
                    plan = self._batcher.plan(
                        [p.t_enqueue for p in self._pending], now)
                    if plan is not None:
                        break
                    deadline = self._batcher.next_deadline(
                        [p.t_enqueue for p in self._pending])
                    self._lock.wait(timeout=None if deadline is None
                                    else max(deadline - now, 1e-4))
                if not self._running:
                    return
                rows = self._pending[: plan.count]
                del self._pending[: plan.count]
            try:
                item = self._run([r.payload for r in rows], plan.bucket, rows)
            except Exception as e:  # the batch's decode failed: fail its rows, keep serving
                for r in rows:
                    r.future.set_exception(e)
                continue
            with self._stats_lock:
                self._compiled.add(plan.bucket)
            self._inflight.put(item)

    def _complete_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            try:
                tokens = self._wait(item)  # blocks on the device
            except Exception as e:  # an asynchronous device error surfaces here
                for r in item.rows:
                    r.future.set_exception(e)
                continue
            t_done = time.monotonic()
            decode_ms = (t_done - item.t_dispatch) * 1e3
            with self._stats_lock:
                self._n_batches += 1
                self._bucket_counts[item.bucket] = (
                    self._bucket_counts.get(item.bucket, 0) + 1)
            for i, r in enumerate(item.rows):
                try:
                    row, text = self._post(tokens[i])
                    res = ServeResult(
                        tokens=row, text=text,
                        queue_ms=(item.t_dispatch - r.t_enqueue) * 1e3,
                        decode_ms=decode_ms,
                        total_ms=(time.monotonic() - r.t_enqueue) * 1e3,
                        bucket=item.bucket)
                    r.future.set_result(res)
                    self._record(res.total_ms)
                except Exception as e:  # a row's post-processing failed: fail that row
                    r.future.set_exception(e)

    def _record(self, total_ms: float) -> None:
        with self._stats_lock:
            self._n_requests += 1
            self._latency_ms.append(total_ms)
            if len(self._latency_ms) > 4096:
                del self._latency_ms[:2048]


# -- model-specific engine constructors --------------------------------------------


def trim_at_eos(tokens: np.ndarray, eos_id: int, n_prefix: int) -> np.ndarray:
    """Cut a decode row at (and excluding) the first EOS past the prefix."""
    hits = np.nonzero(tokens[n_prefix:] == eos_id)[0]
    return tokens[: n_prefix + int(hits[0])] if hits.size else tokens


def canonical_wav(wav: np.ndarray, seconds: float = 30.0,
                  sample_rate: int = 16_000) -> np.ndarray:
    """Pad or trim a waveform to the engine's fixed length (zero-padded
    tail, as Whisper's pad-to-30 s front end does)."""
    n = int(seconds * sample_rate)
    wav = np.asarray(wav, np.float32).reshape(-1)[:n]
    if wav.shape[0] < n:
        wav = np.pad(wav, (0, n - wav.shape[0]))
    return wav


def _postprocess(prefix: list[int], eos_id: int, tokenizer):
    def post(row):
        row = trim_at_eos(row, eos_id, len(prefix))
        text = None
        if tokenizer is not None:
            text = tokenizer.decode([int(t) for t in row[len(prefix):]])
        return row, text

    return post


def make_audio_engine(
    asr,
    prefix_ids: Sequence[int],
    tokenizer=None,
    beam_size: int = 5,
    max_len: int = 224,
    eos_id: int = 50257,
    seconds: float = 30.0,
    sample_rate: int = 16_000,
    logit_rules=None,
    weight_quant: str | None = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    max_wait_s: float = 0.005,
) -> ServingEngine:
    """Serving engine over ``models.asr.WhisperASR`` on the model's device
    (audio only, clips of up to ``seconds``; the payload is one float32
    waveform row made canonical by ``canonical_wav``). Text output when a
    tokenizer is given. ``weight_quant="int8"``: int8 decode weights."""
    n_samples = int(seconds * sample_rate)
    prefix = [int(t) for t in prefix_ids]

    def decode_batch(batch):
        (wav,) = batch
        return asr.transcribe_tokens(
            wav, prefix, beam_size=beam_size, max_len=max_len, eos_id=eos_id,
            pad_to=n_samples, logit_rules=logit_rules, weight_quant=weight_quant)

    return ServingEngine(decode_batch, buckets=buckets, max_wait_s=max_wait_s,
                         postprocess=_postprocess(prefix, eos_id, tokenizer),
                         device=asr.device)


def make_av_engine(
    net,
    prefix_ids: Sequence[int],
    tokenizer=None,
    beam_size: int = 5,
    max_len: int = 224,
    eos_id: int = 50257,
    logit_rules=None,
    cache_quant: str | None = None,
    weight_quant: str | None = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    max_wait_s: float = 0.005,
    video_resize: int = 64,
    read_windows: Sequence[int] | str | None = "auto",
    cache_layout: str = "auto",
) -> ServingEngine:
    """Serving engine over ``models.av_whisper.AVWhisperNet`` on the model's
    device.

    Payload per request (fixed shapes): mel ``[3000, 80]`` f32, audio mask
    ``[3000]`` bool, video uint8 ``[T, 3, H, W]`` raw lip frames (resized
    and normalised on the device, inside the encode's CUDA graph), video mask
    ``[T]`` bool, video length int32.

    ``read_windows`` and ``cache_layout`` choose, in the JAX package, how a
    TPU reads and lays out the self cache, per bucket under ``"auto"``; they
    leave the tokens unchanged, and the port's beam search accepts them as
    no-ops, so ``"auto"`` passes the plain choices on. ``cache_quant`` and
    ``weight_quant``: as ``AVWhisperNet.beam``."""
    prefix = [int(t) for t in prefix_ids]
    windows = None if read_windows == "auto" else read_windows
    layout = "rows" if cache_layout == "auto" else cache_layout

    def decode_batch(batch):
        features, valid = net.encode(batch, video_resize=video_resize)
        return net.decode_programs.beam(
            features, valid, prefix, beam_size=beam_size, max_len=max_len, eos_id=eos_id,
            logit_rules=logit_rules, cache_quant=cache_quant, weight_quant=weight_quant,
            read_windows=windows, cache_layout=layout).sequences[:, 0]  # top hypothesis

    return ServingEngine(decode_batch, buckets=buckets, max_wait_s=max_wait_s,
                         postprocess=_postprocess(prefix, eos_id, tokenizer),
                         device=next(net.parameters()).device)
