"""Iteration-level (continuous) batching for the KV-cached beam decode
(counterpart of ``serving/continuous.py``).

The whole-utterance ``ServingEngine`` spends one full decode on every batch,
however few rows it holds. Here the decode runs as a perpetual sequence of
``seg_steps``-step segments over a fixed pool of ``capacity`` requests × K
beams, and requests are admitted into free rows at segment boundaries: a
request waits at most one segment to start, and a row whose beam search has
finished (its hypothesis pool can no longer improve) is retired and refilled
at the next boundary instead of riding out the token budget.

How the TPU design is rendered on the GPU:

- **Logical positions in place of phase stripes.** The JAX segment writes
  every row into one shared physical stripe (the TPU's shared-scalar
  ``dynamic_update_slice``) and hides stale slots behind a
  written-since-admission mask. Here each row writes its K/V at its own
  logical position (``WhisperDecoder.decode_step(positions=...)``: one
  indexed write per layer per step over the ``[R*K]`` rows) and attends to
  the keys at or before it through one mask over the whole window, as the
  JAX segment reads its whole window. A reused row's stale slots lie past
  its position, so the mask hides them and nothing is cleared; a free row's
  position clamps to 0, so it reads slot 0 only.
- **Bookkeeping on the host.** ``admit_tick`` and ``tick`` are host integers
  in the state; each segment sends the rows' first positions to the device
  once, from page-locked memory, with every step's positions and masks
  derived from them on the card. No host float or int becomes a device
  tensor per step. The ``[R]`` ``heur_ok`` read-back is the one
  synchronisation per segment, and the retired rows' best hypotheses come
  back in one transfer per boundary.
- **Beams are reordered physically**, within each request's K rows only
  (``row_base + sel_beam``; rows whose state is frozen, in their forced
  prefix, past their budget or free, take the identity): one
  ``index_select`` per step over the stacked self caches, written into the
  state's spare pair of caches, and the two pairs alternate. An odd
  segment ends with one copy back, so every state tensor keeps its address
  (the JAX segment donates its state; a graph replays fixed addresses).
- **One CUDA graph per engine** (``SegmentProgram``, the counterpart of the
  JAX segment's ``jax.jit`` over its ``lax.scan``): on the card the engine
  replays the segment over its state, with the rows' first positions as the
  one static input; ``warmup`` captures it. A capture or replay error fails
  the segment's requests; nothing runs the segment eagerly behind it. On
  the CPU the same object runs the segment eagerly, as ``make_segment_fn``
  does (the plain version).
- **Exactness.** A row's beam semantics are ``decode/beam.py``'s: the same
  two-stage 2K expansion, EOS banking, force-bank at the budget and
  early-stop heuristic, the stable ``_top_k`` and per-row length-penalty
  denominators gathered from the same table of 0-d powers. So a row admitted
  mid-flight, into a reused slot or not, decodes like a solo ``beam_search``
  of the same features.
- **Threads and streams follow ``serving/engine.py``.** The loop thread runs
  admission, the encode and the segments on one CUDA stream that the engine
  owns, and sets ``no_grad`` and the stream itself; ``warmup`` runs on that
  stream under the same lock. A failed segment fails the futures in flight
  and the loop goes on. ``cache_layout`` is a TPU layout choice, accepted as
  a no-op.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.decode.beam import (
    NEG_INF, _length_denominators, _take_rows, _top_k, reorder_into)
from mocov2_whisper_flamingo_torch.decode.programs import GraphPool
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.serving.engine import (
    ServeResult, _postprocess, pad_rows)

logger = logging.getLogger(__name__)

# admit_tick of a free row: far enough in the future that its position
# (tick - FREE_TICK) * seg_steps + s stays negative.
FREE_TICK = 2**30


def init_state(decoder, *, capacity: int, beam_size: int, seg_steps: int,
               n_segments: int, enc_len: int, eos_id: int,
               cache_layout: str = "bhjtd") -> dict:
    """State of the continuous engine on the decoder's device: stacked self
    caches ``[layers, R*K, L, H, Dh]`` (never cleared between occupants)
    and their spare pair (``self_k_spare``, ``self_v_spare``: the beams'
    reorder target), per-row cross caches ``[layers, R, enc_len, H, Dh]`` and key validity,
    per-row beam state, and the admission bookkeeping on the host
    (``admit_tick`` ``[R]`` int64, ``tick``). ``decoder`` is a prepared
    ``WhisperDecoder``."""
    if cache_layout not in ("bhjtd", "rows"):
        raise ValueError(f"unknown cache_layout {cache_layout!r}")
    cfg = decoder.config
    dev = decoder.pos_embed.device
    dtype = decoder.precision.compute_dtype
    r, k = capacity, beam_size
    l_ = seg_steps * n_segments
    self_shape = (cfg.decoder_layers, r * k, l_, cfg.n_heads, cfg.head_dim)
    cross_shape = (cfg.decoder_layers, r, enc_len, cfg.n_heads, cfg.head_dim)
    return {
        "self_k": torch.zeros(self_shape, dtype=dtype, device=dev),
        "self_v": torch.zeros(self_shape, dtype=dtype, device=dev),
        "self_k_spare": torch.zeros(self_shape, dtype=dtype, device=dev),
        "self_v_spare": torch.zeros(self_shape, dtype=dtype, device=dev),
        "cross_k": torch.zeros(cross_shape, dtype=dtype, device=dev),
        "cross_v": torch.zeros(cross_shape, dtype=dtype, device=dev),
        "enc_valid": torch.zeros((r, enc_len), dtype=torch.bool, device=dev),
        "run_tokens": torch.full((r, k, l_), eos_id, dtype=torch.long, device=dev),
        "run_scores": torch.zeros((r, k), dtype=torch.float32, device=dev),
        "pool_tokens": torch.full((r, k, l_), eos_id, dtype=torch.long, device=dev),
        "pool_scores": torch.full((r, k), NEG_INF, dtype=torch.float32, device=dev),
        "heur_ok": torch.zeros((r,), dtype=torch.bool, device=dev),
        "admit_tick": np.full((r,), FREE_TICK, np.int64),
        "tick": 0,
    }


def make_admit_fn(decoder, prefix_ids: Sequence[int], eos_id: int,
                  beam_size: int, max_len: int) -> Callable:
    """``admit(state, enc_out [n, T, D], enc_valid [n, T] | None, rows) ->
    state``: write each utterance's cross K/V and key validity into its row
    (``rows``: one int, or ``n`` ints), reset that row's beam state and mark
    it admitted at the current tick. In place. The self cache is not
    touched: a reused row's stale slots lie past its position."""
    dev = decoder.pos_embed.device
    k = beam_size
    prefix = [int(t) for t in prefix_ids]
    tokens0 = torch.full((k, max_len), eos_id, dtype=torch.long, device=dev)
    tokens0[:, : len(prefix)] = torch.tensor(prefix, dtype=torch.long, device=dev)
    scores0 = torch.full((k,), NEG_INF, dtype=torch.float32, device=dev)
    scores0[0] = 0.0

    @torch.no_grad()
    def admit(state: dict, enc_out: torch.Tensor, enc_valid: torch.Tensor | None,
              rows) -> dict:
        rows = [rows] if isinstance(rows, (int, np.integer)) else [int(r) for r in rows]
        t = enc_out.shape[1]
        if len(rows) != enc_out.shape[0] or t > state["enc_valid"].shape[1]:
            raise ValueError(f"admit: {enc_out.shape[0]} utterances of {t} frames for rows "
                             f"{rows} of an engine of {state['enc_valid'].shape[1]} frames")
        cross_k, cross_v = decoder.cross_caches(enc_out)
        for i, row in enumerate(rows):
            state["cross_k"][:, row, :t] = cross_k[:, i]
            state["cross_v"][:, row, :t] = cross_v[:, i]
            state["enc_valid"][row] = False
            state["enc_valid"][row, :t] = True if enc_valid is None else enc_valid[i]
            state["run_tokens"][row] = tokens0
            state["run_scores"][row] = scores0
            state["pool_tokens"][row] = eos_id
            state["pool_scores"][row] = NEG_INF
            state["heur_ok"][row] = True
            state["admit_tick"][row] = state["tick"]
        return state

    return admit


# The state tensors a segment writes.
SEGMENT_WRITES = ("self_k", "self_v", "run_tokens", "run_scores", "pool_tokens", "pool_scores",
                  "heur_ok")


def first_positions(state: dict, seg_steps: int) -> np.ndarray:
    """``[R]`` int64: each row's position at the segment's first step
    (negative for a row admitted at this boundary's tick + 1 or later: a
    free row)."""
    phase = state["tick"] - state["admit_tick"]
    return np.maximum(phase, -1) * seg_steps


def _segment_body(decoder, *, beam_size: int, seg_steps: int, n_segments: int,
                  n_prefix: int, eos_id: int, length_penalty: float) -> Callable:
    """``body(state, pos0)``: one segment's device work, in place on the
    state's tensors, from the rows' first positions ``pos0 [R]`` on the
    device. No host value enters it, so a CUDA graph can capture it."""
    dev = decoder.pos_embed.device
    k, k2, s_len = beam_size, 2 * beam_size, seg_steps
    max_len = s_len * n_segments
    # gen_len ** length_penalty for gen_len 0 .. max_len, each the 0-d power
    # that beam_search divides by (a vector power rounds some entries otherwise)
    denoms = torch.stack(_length_denominators(max_len + 1, length_penalty, dev))
    can_bank = (torch.arange(k2, device=dev) < k)[None, :]
    beam_ids = torch.arange(k, device=dev)[None, :]
    steps = torch.arange(s_len, device=dev)[:, None]
    slots = torch.arange(max_len, device=dev)

    def body(state: dict, pos0: torch.Tensor) -> None:
        r = state["run_tokens"].shape[0]
        row_base = torch.arange(r, device=dev)[:, None] * k
        pos_all = pos0[None, :] + steps                        # [S, R]
        posc_all = pos_all.clamp(0, max_len - 1)
        live_all = (pos_all >= 0) & (pos_all + 1 <= max_len - 1)
        keep_all = (pos_all + 1 < n_prefix) | ~live_all        # frozen beam state
        positions_all = posc_all.repeat_interleave(k, dim=1)   # [S, R*K]
        ends_all = pos_all + 2 >= max_len                      # force-bank
        wr_all = (slots[None, None, :] == (pos_all + 1).clamp(0, max_len - 1)[..., None]) \
            & live_all[..., None]                              # [S, R, L] token write
        denom_all = denoms[(pos_all + 2 - n_prefix).clamp(1, max_len)]  # [S, R]

        run_tokens, run_scores = state["run_tokens"], state["run_scores"]
        pool_tokens, pool_scores = state["pool_tokens"], state["pool_scores"]
        heur_ok = state["heur_ok"]
        selfs = (state["self_k"], state["self_v"])
        spares = (state["self_k_spare"], state["self_v_spare"])
        for s in range(s_len):
            posc, keep, denom = posc_all[s], keep_all[s], denom_all[s]
            cur = run_tokens.gather(2, posc[:, None, None].expand(r, k, 1))
            cache = {"self_k": selfs[0], "self_v": selfs[1], "cross_k": state["cross_k"],
                     "cross_v": state["cross_v"]}
            logits, _ = decoder.decode_step(cur.reshape(r * k, 1), cache, max_len - 1,
                                            state["enc_valid"], positions=positions_all[s])
            logp = torch.log_softmax(logits.float(), dim=-1)

            # decode/beam.py's step, batched over the R requests.
            s1, t1 = torch.topk(logp, k2, dim=-1)
            total1 = run_scores[..., None] + s1.reshape(r, k, k2)
            s2k, flat = _top_k(total1.reshape(r, k * k2), k2)
            beam2k = flat // k2
            tok2k = t1.reshape(r, k * k2).gather(1, flat)
            hits = (tok2k == eos_id) | ends_all[s][:, None]
            cand_tokens = torch.where(wr_all[s][:, None, :], tok2k[..., None],
                                      _take_rows(run_tokens, beam2k))

            bank_ok = hits & can_bank & ~keep[:, None] & heur_ok[:, None]
            bank = torch.where(bank_ok, s2k / denom[:, None], NEG_INF)
            pool_scores_new, pool_idx = _top_k(torch.cat([pool_scores, bank], dim=1), k)
            pool_tokens_new = _take_rows(torch.cat([pool_tokens, cand_tokens], dim=1),
                                         pool_idx)
            run_scores_new, sel = _top_k(s2k + hits * NEG_INF, k)
            sel_beam = torch.where(keep[:, None], beam_ids, beam2k.gather(1, sel))
            run_tokens = torch.where(keep[:, None, None], run_tokens,
                                     _take_rows(cand_tokens, sel))
            run_scores = torch.where(keep[:, None], run_scores, run_scores_new)
            pool_tokens = torch.where(keep[:, None, None], pool_tokens, pool_tokens_new)
            pool_scores = torch.where(keep[:, None], pool_scores, pool_scores_new)
            selfs, spares = reorder_into(selfs, spares, (row_base + sel_beam).reshape(-1))

            best_possible = run_scores[:, 0] / denom
            pool_done = (pool_scores > NEG_INF / 2).all(dim=-1)
            worst = pool_scores.min(dim=-1).values
            heur_ok = torch.where(keep, heur_ok,
                                  heur_ok & (~pool_done | (best_possible > worst)))
        if selfs[0] is not state["self_k"]:  # an odd segment: back into the state's pair
            state["self_k"].copy_(selfs[0])
            state["self_v"].copy_(selfs[1])
        for name, value in (("run_tokens", run_tokens), ("run_scores", run_scores),
                            ("pool_tokens", pool_tokens), ("pool_scores", pool_scores),
                            ("heur_ok", heur_ok)):
            state[name].copy_(value)

    return body


def make_segment_fn(decoder, *, beam_size: int, seg_steps: int, n_segments: int,
                    n_prefix: int, eos_id: int, length_penalty: float = 1.0) -> Callable:
    """``segment(state) -> state``: advance every row by ``seg_steps`` steps
    of its own timeline (``decode/beam.py``'s step per row; rows in their
    forced prefix, past their budget or free keep their beam state), then
    advance the tick. In place: every state tensor keeps its address. The
    eager segment, the plain version of ``SegmentProgram``'s graph."""
    dev = decoder.pos_embed.device
    body = _segment_body(decoder, beam_size=beam_size, seg_steps=seg_steps,
                         n_segments=n_segments, n_prefix=n_prefix, eos_id=eos_id,
                         length_penalty=length_penalty)

    @torch.no_grad()
    def segment(state: dict) -> dict:
        body(state, torch.from_numpy(first_positions(state, seg_steps)).to(dev))
        state["tick"] += 1
        return state

    return segment


class SegmentProgram(GraphPool):
    """The continuous segment as one CUDA graph over one engine's state:
    ``program(state) -> state`` as ``make_segment_fn``'s segment. On the
    card the rows' first positions go into a static ``[R]`` buffer from
    page-locked memory and the graph replays; it is captured at the first
    call (or by ``capture``) and again when the state's key changes: the
    capacity, the encoder length, the segment's static arguments, the
    compute dtype, the device, the prepared decoder's ``weight_quant`` and
    the addresses of the state tensors. A capture or replay error raises.
    On the CPU it runs the same segment eagerly. ``captures`` / ``replays``
    / ``pool``: see ``GraphPool``."""

    def __init__(self, decoder, *, beam_size: int, seg_steps: int, n_segments: int,
                 n_prefix: int, eos_id: int, length_penalty: float = 1.0):
        super().__init__()
        self.device = decoder.pos_embed.device
        self.seg_steps = seg_steps
        weight_quant = "int8" if isinstance(decoder.embed_tokens, L.QuantEmbedding) else None
        self._static = (beam_size, seg_steps, n_segments, n_prefix, eos_id,
                        float(length_penalty), decoder.precision.compute_dtype, self.device,
                        weight_quant)
        self._body = _segment_body(decoder, beam_size=beam_size, seg_steps=seg_steps,
                                   n_segments=n_segments, n_prefix=n_prefix, eos_id=eos_id,
                                   length_penalty=length_penalty)
        self.key = None
        self.graph = None
        self._pos0 = None  # the graph's static input

    def state_key(self, state: dict) -> tuple:
        return (state["run_tokens"].shape[0], state["enc_valid"].shape[1], *self._static,
                tuple(v.data_ptr() for v in state.values() if isinstance(v, torch.Tensor)))

    @torch.no_grad()
    def capture(self, state: dict) -> None:
        """Capture the segment over ``state`` on the current stream. The
        capture's eager run is undone: the state is left as it was."""
        key = self.state_key(state)
        self.graph = self.key = None
        pos0 = torch.from_numpy(first_positions(state, self.seg_steps)).to(self.device)
        self.graph, _ = self.capture_graph(
            lambda: self._body(state, pos0), torch.cuda.current_stream(self.device),
            restore=[state[name] for name in SEGMENT_WRITES], loop="segment",
            rows=int(state["self_k"].shape[1]))
        self.key, self._pos0 = key, pos0

    @torch.no_grad()
    def __call__(self, state: dict) -> dict:
        pos0 = torch.from_numpy(first_positions(state, self.seg_steps))
        if self.device.type != "cuda":
            self._body(state, pos0.to(self.device))
        else:
            if self.key != self.state_key(state):
                self.capture(state)
            self._pos0.copy_(pos0.pin_memory(), non_blocking=True)
            self.replay(self.graph)
        state["tick"] += 1
        return state


@dataclass
class _Slot:
    future: Future
    t_enqueue: float
    t_admit: float
    admit_tick: int


class ContinuousEngine:
    """Request/response service over the segment loop.

    ``decoder`` is a prepared ``WhisperDecoder``. ``encode(payloads:
    list[tuple]) -> (features [n, T, D], valid [n, T])`` encodes every
    payload admitted at one boundary, on the decoder's device (the AV builder
    below pads to power-of-two buckets); it runs on the engine's stream.

    The loop thread: admit queued requests into free rows -> run one segment
    -> read the ``[R]`` heuristic flags back (the segment's one sync) ->
    retire rows that spent their ``n_segments`` budget or whose hypothesis
    pool can no longer change. Results resolve as ``ServeResult``
    (``queue_ms`` = enqueue -> admission, ``decode_ms`` = admission ->
    retirement, ``bucket`` = row capacity). ``segment_program``: the
    ``SegmentProgram`` the loop runs (one CUDA graph on the card).
    """

    def __init__(self, decoder, encode: Callable, *, prefix_ids: Sequence[int], eos_id: int,
                 enc_len: int, capacity: int = 16, beam_size: int = 5, seg_steps: int = 32,
                 n_segments: int = 5, length_penalty: float = 1.0,
                 cache_layout: str = "bhjtd", tokenizer=None, postprocess=None):
        self.decoder = decoder
        self.encode = encode
        self.capacity = capacity
        self.n_segments = n_segments
        self.eos_id = eos_id
        self.prefix = [int(t) for t in prefix_ids]
        self.max_len = seg_steps * n_segments
        self._post = postprocess or _postprocess(self.prefix, eos_id, tokenizer)
        self.device = decoder.pos_embed.device
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # The model's weights were written on the current stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_device():
            self.state = init_state(
                decoder, capacity=capacity, beam_size=beam_size, seg_steps=seg_steps,
                n_segments=n_segments, enc_len=enc_len, eos_id=eos_id,
                cache_layout=cache_layout)
            self._admit = make_admit_fn(decoder, self.prefix, eos_id, beam_size,
                                        self.max_len)
            self.segment_program = SegmentProgram(
                decoder, beam_size=beam_size, seg_steps=seg_steps, n_segments=n_segments,
                n_prefix=len(self.prefix), eos_id=eos_id, length_penalty=length_penalty)
        self._device_lock = threading.Lock()  # warm-up and the loop take turns
        self._slots: dict[int, _Slot] = {}
        self._pending: list[tuple[tuple, Future, float]] = []
        self._lock = threading.Condition()
        self._running = True
        self._segments_run = 0
        self._thread = threading.Thread(target=self._loop, name="continuous-decode",
                                        daemon=True)
        self._thread.start()

    def _on_device(self):
        """``no_grad`` on the engine's stream (both are per thread)."""
        stack = ExitStack()
        stack.enter_context(torch.no_grad())
        if self._stream is not None:
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    # -- client API -------------------------------------------------------------

    def submit(self, *payload) -> Future:
        fut: Future = Future()
        with self._lock:
            if not self._running:
                raise RuntimeError("engine is closed")
            self._pending.append((payload, fut, time.monotonic()))
            self._lock.notify()
        return fut

    def transcribe(self, *payload, timeout: float | None = None) -> ServeResult:
        return self.submit(*payload).result(timeout=timeout)

    def warmup(self, example_payload: tuple,
               encode_buckets: Sequence[int] = (1, 2, 4, 8, 16)) -> None:
        """Run the encode at every admission bucket (boundary admissions are
        padded to powers of two) on the engine's stream, the largest first
        (with the AV builder's encode, this captures each bucket's encode
        graph on the card into one pool, where each smaller bucket reuses
        the blocks the larger ones freed), capture the segment there
        (``segment_program.captures`` records its seconds), then one full
        decode of the example through the loop, so that live traffic meets
        built kernels, chosen cuDNN algorithms, filled allocator pools and
        the encode's and the segment's graphs."""
        for b in sorted(encode_buckets, reverse=True):
            if b <= self.capacity:
                with self._device_lock, self._on_device():
                    self.encode([tuple(example_payload)] * b)
        if self.device.type == "cuda":
            with self._device_lock, self._on_device():
                self.segment_program.capture(self.state)
        self.transcribe(*example_payload, timeout=1800)

    def stats(self) -> dict:
        with self._lock:
            return {"segments_run": self._segments_run, "pending": len(self._pending),
                    "live_rows": len(self._slots)}

    def close(self) -> None:
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._thread.join(timeout=60)
        with self._lock:
            for _, fut, _ in self._pending:
                fut.set_exception(RuntimeError("engine closed"))
            for slot in self._slots.values():
                slot.future.set_exception(RuntimeError("engine closed"))
            self._pending.clear()
            self._slots.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- decode loop --------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._lock:
                while self._running and not self._pending and not self._slots:
                    self._lock.wait()
                if not self._running:
                    return
                # Admission plan under the lock; device work outside it.
                free = [i for i in range(self.capacity) if i not in self._slots]
                to_admit = []
                while self._pending and free:
                    payload, fut, t_enq = self._pending.pop(0)
                    to_admit.append((free.pop(0), payload, fut, t_enq))
            try:
                with self._device_lock, self._on_device():
                    if to_admit:
                        feats, valid = self.encode([p for _, p, _, _ in to_admit])
                        tick = self.state["tick"]
                        self.state = self._admit(self.state, feats, valid,
                                                 [row for row, _, _, _ in to_admit])
                        now = time.monotonic()
                        with self._lock:
                            for row, _, fut, t_enq in to_admit:
                                self._slots[row] = _Slot(fut, t_enq, now, tick)
                    self.state = self.segment_program(self.state)
                    # the segment's sync; a copy, not a view of the state on the CPU
                    heur = self.state["heur_ok"].to("cpu", copy=True).numpy()
                self._segments_run += 1
            except Exception as e:  # fail everything in flight, keep serving
                logger.exception("continuous decode segment failed")
                with self._lock:
                    for row, _, fut, _ in to_admit:
                        if row not in self._slots:
                            fut.set_exception(e)
                        self.state["admit_tick"][row] = FREE_TICK
                    for row, slot in self._slots.items():
                        slot.future.set_exception(e)
                        self.state["admit_tick"][row] = FREE_TICK
                    self._slots.clear()
                continue
            tick = self.state["tick"]
            done_rows = []
            with self._lock:
                for row, slot in list(self._slots.items()):
                    if tick - slot.admit_tick >= self.n_segments or not heur[row]:
                        done_rows.append((row, slot))
                        del self._slots[row]
                        # a free row keeps its beam state frozen and reads
                        # nothing past slot 0
                        self.state["admit_tick"][row] = FREE_TICK
            if not done_rows:
                continue
            with self._device_lock, self._on_device():
                best = self.state["pool_tokens"][:, 0].to("cpu", copy=True).numpy()
            for row, slot in done_rows:
                try:
                    toks, text = self._post(best[row])
                    now = time.monotonic()
                    slot.future.set_result(ServeResult(
                        tokens=toks, text=text,
                        queue_ms=(slot.t_admit - slot.t_enqueue) * 1e3,
                        decode_ms=(now - slot.t_admit) * 1e3,
                        total_ms=(now - slot.t_enqueue) * 1e3,
                        bucket=self.capacity))
                except Exception as e:
                    slot.future.set_exception(e)


# The AV engine's payload: a 30 s mel of 3000 frames and 400 lip frames (the
# shapes the JAX builder probes its feature length with).
AV_MEL_FRAMES, AV_VIDEO_FRAMES = 3000, 400


def fused_length(net) -> int:
    """Length of the features ``AVWhisperNet.encode`` returns for the AV
    engine's payload: the Whisper encoder's convolutions set the audio
    stream's length, the MoCo frontend keeps one feature per frame, and the
    trunk cuts both streams to the shorter."""
    t = AV_MEL_FRAMES
    enc = net.trunk.whisper_encoder
    for conv in (enc.conv1, enc.conv2):
        t = (t + 2 * conv.padding - conv.weight.shape[-1]) // conv.stride + 1
    return min(t, AV_VIDEO_FRAMES)


def make_continuous_av_engine(
    net,
    prefix_ids: Sequence[int],
    tokenizer=None,
    beam_size: int = 5,
    max_len: int = 160,
    eos_id: int = 50257,
    capacity: int = 16,
    seg_steps: int = 32,
    weight_quant: str | None = None,
    video_resize: int = 64,
    cache_layout: str = "bhjtd",
) -> ContinuousEngine:
    """Continuous-batching engine over ``models.av_whisper.AVWhisperNet``
    on the model's device, with ``make_av_engine``'s payload per request.
    Admissions are encoded by ``AVWhisperNet.encode`` (the video pipeline
    inside), one CUDA graph per admission bucket on the card, in one pool.
    ``max_len`` must be a multiple of ``seg_steps`` (the segment grid).
    ``weight_quant="int8"``: int8 decode weights (the caches stay in the
    compute dtype, as in the JAX engine)."""
    if max_len % seg_steps:
        raise ValueError(f"max_len={max_len} must be a multiple of seg_steps={seg_steps}")
    decoder = net.decoder.prepare_decode_params(weight_quant)
    device = decoder.pos_embed.device
    cuda = device.type == "cuda"

    def encode(payloads):
        # Pad the boundary's admissions to a power-of-two bucket and slice
        # the pads off: exact, rows are independent (serving/engine.py).
        n = len(payloads)
        bucket = 1
        while bucket < n:
            bucket *= 2
        batch = tuple(torch.as_tensor(x).to(device, non_blocking=True)
                      for x in pad_rows(payloads, bucket, pin_memory=cuda))
        feats, valid = net.encode(batch, video_resize=video_resize)
        return feats[:n], valid[:n]

    return ContinuousEngine(
        decoder, encode, prefix_ids=prefix_ids, eos_id=eos_id, enc_len=fused_length(net),
        capacity=capacity, beam_size=beam_size, seg_steps=seg_steps,
        n_segments=max_len // seg_steps, cache_layout=cache_layout, tokenizer=tokenizer)
