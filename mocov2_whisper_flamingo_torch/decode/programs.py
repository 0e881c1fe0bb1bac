"""Compiled decode programs: beam and greedy decoding as one CUDA graph per
shape (port-only, like ``device.py``). This is the counterpart of the JAX
package's ``jax.jit`` over the ``lax.scan`` of ``decode/beam.py`` and
``decode/greedy.py``, with the decoder's fusion and cast inside the program
as in its ``models/av_whisper.py``.

A ``DecodePrograms`` serves one source ``WhisperDecoder``. It holds one
prepared decoder per ``weight_quant`` (``prepare_decode_params``, made once),
one CUDA graph memory pool and the captured graphs. A graph records, on the
card, the refresh of the prepared decoder from the source weights
(``WhisperDecoder.refresh_decode_params``) and then the unchanged
``beam_search`` or ``greedy_decode`` over it, on static inputs
(``features [B, T_enc, D]``, ``valid [B, T_enc]``, ``prefix [n_prefix]``).
A call copies its inputs into them, replays the graph and returns clones of
the static outputs, so that the next replay never overwrites a result that a
caller holds.

- **The key** of a graph (``program_key``) is what fixes its kernels and
  addresses: the loop, the features' shape, dtype and device, whether a
  validity mask is given, the prefix length, the loop's static arguments,
  ``id(logit_rules)`` (the graph keeps the rules object alive: it reads the
  rules' tables), the quant modes and the ``data_ptr()`` of every source
  parameter. A parameter replaced by assignment (``p.data = ...``) makes a
  new key, and the graphs that read the old addresses are dropped; an
  in-place update (an optimizer step, ``load_state_dict``) is read by the
  refresh at the next replay.
- **Capture** (``GraphPool.capture_graph``, shared with the continuous
  engine's segment and the streaming decoder's chunk) follows PyTorch's
  recipe: one eager run on the capture stream first, which builds what a
  capture refuses to build (the logit rules' tables, copied from the host;
  cuBLAS handles and workspaces; sort workspaces), then ``torch.cuda.graph``
  on the caller's stream (on a side stream of the pool's when the caller is
  on the default stream) in ``thread_local`` error mode, since a serving
  engine's completion thread waits on events while its dispatch thread
  captures. A capture or replay error raises: on the card nothing decodes
  eagerly behind a program.
- **Order.** The graphs of one object share its prepared decoders and its
  pool, so its calls are serialised across threads (a lock) and streams
  (each call's stream waits for the event after the last replay).
- **On the CPU** there is no graph: the same object refreshes its prepared
  decoder and runs the eager loop, the plain version of the program.

These callers stay eager: ``sample_decode`` (a fresh noise per fold path),
``decode_with_fallback``'s beam rung (its prefix length changes window by
window), the encode, and ``tools/export_model.py``'s ``BeamProgram``
(``torch.export`` traces the loop, not a replay).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from mocov2_whisper_flamingo_torch.decode.beam import BeamResult, beam_search
from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode


def program_key(loop: str, decoder, features: torch.Tensor, valid: torch.Tensor | None,
                n_prefix: int, logit_rules, weight_quant: str | None, **static) -> tuple:
    """The key of the graph that decodes ``features`` with ``loop``
    ("beam" or "greedy") over ``decoder`` (the source decoder); ``static``:
    the loop's other arguments (beam size, ``max_len``, ``eos_id``, ...)."""
    return (loop, tuple(features.shape), features.dtype, features.device, valid is not None,
            n_prefix, id(logit_rules), weight_quant, tuple(sorted(static.items())),
            tuple(p.data_ptr() for p in decoder.parameters()))


def _pinned_prefix(prefix_ids) -> torch.Tensor:
    """The prefix as a tensor to copy into a graph's static input: a
    tensor as it is, ints in page-locked host memory, whose copy does not
    wait for the work already queued on the stream (a copy from pageable
    memory would, and a serving engine's dispatch thread with it)."""
    if isinstance(prefix_ids, torch.Tensor):
        return prefix_ids
    return torch.tensor([int(t) for t in prefix_ids], dtype=torch.long).pin_memory()


class GraphPool:
    """What the CUDA graphs of one owner share: a memory pool (``pool``, None
    until the first capture), a side stream for callers on the default
    stream, the graphs whose capture raised, one record per capture
    (``captures``: the caller's fields, and the seconds of the capture and
    of the graph's instantiation) and the count of replays (``replays``)."""

    def __init__(self):
        self.pool = None
        self.captures: list[dict] = []
        self.replays = 0
        self._side = None  # capture stream for callers on the default stream
        self._failed: list = []  # graphs whose capture raised

    def capture_graph(self, fn, stream, restore=(), **record) -> tuple:
        """Capture ``fn()`` into a new graph in this pool and return
        ``(graph, fn's outputs in the pool)``. ``fn`` runs once eagerly on
        the capture stream first; ``restore``: tensors that ``fn`` writes in
        place, copied aside before that run and back after it, so that the
        eager run leaves them as they were and the first replay does the
        call's work."""
        dev = stream.device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        capture_stream = stream
        if stream == torch.cuda.default_stream(dev):
            if self._side is None:
                self._side = torch.cuda.Stream(dev)
            capture_stream = self._side
        capture_stream.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(capture_stream):
            saved = [t.clone() for t in restore]
            fn()  # eager: the rules' tables, library handles, workspaces
            for t, s in zip(restore, saved):
                t.copy_(s)
            del saved
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=capture_stream,
                                      capture_error_mode="thread_local"):
                    outputs = fn()
                    t1 = time.perf_counter()
            except BaseException:
                # PyTorch stops a pool's recording only when a capture ends
                # well, so the next capture takes a new pool; the failed
                # graph stays alive, as the allocator's recording filter
                # refers to it.
                self.pool = None
                self._failed.append(graph)
                raise
            t2 = time.perf_counter()
        stream.wait_stream(capture_stream)
        self.captures.append({**record, "capture_s": t1 - t0, "instantiate_s": t2 - t1})
        return graph, outputs

    def replay(self, graph: torch.cuda.CUDAGraph) -> None:
        graph.replay()
        self.replays += 1


@dataclasses.dataclass
class _Program:
    graph: torch.cuda.CUDAGraph
    inputs: tuple        # static (features, valid or None, prefix)
    outputs: tuple       # static outputs, in the graph's pool
    logit_rules: object  # kept alive: the graph reads its tables


class DecodePrograms(GraphPool):
    """The compiled beam and greedy decodes of one source ``WhisperDecoder``
    (see the module doc). ``captures`` holds one record per capture: the
    loop, the features' shape, and the seconds of the capture and of the
    graph's instantiation. ``pool`` is the graphs' memory pool handle (None
    until the first capture)."""

    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder
        self.prepared: dict = {}  # weight_quant -> prepared decoder
        self.programs: dict = {}  # program_key -> _Program
        self._lock = threading.Lock()
        self._last = None  # CUDA event after the last replay

    def prepared_decoder(self, weight_quant: str | None = None):
        """The prepared decoder for ``weight_quant``, made on first use (as
        it stood then; the programs refresh it before every decode)."""
        if weight_quant not in self.prepared:
            self.prepared[weight_quant] = self.decoder.prepare_decode_params(weight_quant)
        return self.prepared[weight_quant]

    def beam(self, features: torch.Tensor, valid: torch.Tensor | None, prefix_ids,
             beam_size: int = 5, max_len: int = 224, eos_id: int = 0,
             length_penalty: float = 1.0, early_stopping: bool = False, logit_rules=None,
             renorm_after_rules: bool = False, cache_quant: str | None = None,
             weight_quant: str | None = None, read_windows=None,
             cache_layout: str = "rows") -> BeamResult:
        """``beam_search`` over the prepared decoder (``read_windows`` and
        ``cache_layout`` are its no-ops)."""
        if cache_layout not in ("rows", "bhjtd"):
            raise ValueError(f"unknown cache_layout {cache_layout!r}; expected 'rows' or 'bhjtd'")
        del read_windows
        static = dict(beam_size=beam_size, max_len=max_len, eos_id=eos_id,
                      length_penalty=float(length_penalty), early_stopping=bool(early_stopping),
                      renorm_after_rules=bool(renorm_after_rules), cache_quant=cache_quant)

        def loop(decoder, f, v, p):
            res = beam_search(decoder, f, p, encoder_valid=v, logit_rules=logit_rules, **static)
            return res.sequences, res.scores

        sequences, scores = self._run("beam", loop, features, valid, prefix_ids, logit_rules,
                                      weight_quant, static)
        return BeamResult(sequences=sequences, scores=scores)

    def greedy(self, features: torch.Tensor, valid: torch.Tensor | None, prefix_ids,
               max_len: int = 224, eos_id: int = 0, logit_rules=None,
               cache_quant: str | None = None, weight_quant: str | None = None) -> torch.Tensor:
        """``greedy_decode`` over the prepared decoder."""
        static = dict(max_len=max_len, eos_id=eos_id, cache_quant=cache_quant)

        def loop(decoder, f, v, p):
            return (greedy_decode(decoder, f, p, encoder_valid=v, logit_rules=logit_rules,
                                  **static),)

        (tokens,) = self._run("greedy", loop, features, valid, prefix_ids, logit_rules,
                              weight_quant, static)
        return tokens

    # -- one call -----------------------------------------------------------------

    def _run(self, name: str, loop, features, valid, prefix_ids, logit_rules, weight_quant,
             static: dict) -> tuple:
        def program(f, v, p):
            decoder = self.prepared_decoder(weight_quant)
            self.decoder.refresh_decode_params(decoder)
            return loop(decoder, f, v, p)

        with self._lock, torch.no_grad():
            self.prepared_decoder(weight_quant)  # made outside any capture
            if features.device.type != "cuda":
                return program(features, valid, prefix_ids)
            prefix = _pinned_prefix(prefix_ids)
            key = program_key(name, self.decoder, features, valid, int(prefix.shape[0]),
                              logit_rules, weight_quant, **static)
            stream = torch.cuda.current_stream(features.device)
            if self._last is not None:
                stream.wait_event(self._last)
            prog = self.programs.get(key)
            if prog is None:
                prog = self._capture(key, program, features, valid, prefix, logit_rules, stream)
            else:
                for dst, src in zip(prog.inputs, (features, valid, prefix)):
                    if dst is not None:
                        dst.copy_(src, non_blocking=True)
            self.replay(prog.graph)
            out = tuple(o.clone() for o in prog.outputs)
            self._last = torch.cuda.Event()
            self._last.record(stream)
        return out

    def _capture(self, key: tuple, program, features, valid, prefix, logit_rules,
                 stream) -> _Program:
        """Capture ``program`` on static copies of this call's inputs."""
        # Graphs that read parameters at addresses the source no longer has.
        self.programs = {k: p for k, p in self.programs.items() if k[-1] == key[-1]}
        inputs = (features.clone(), None if valid is None else valid.clone(),
                  torch.empty(prefix.shape, dtype=torch.long, device=features.device).copy_(
                      prefix, non_blocking=True))
        graph, outputs = self.capture_graph(lambda: program(*inputs), stream, loop=key[0],
                                            shape=list(features.shape))
        prog = self.programs[key] = _Program(graph, inputs, outputs, logit_rules)
        return prog
