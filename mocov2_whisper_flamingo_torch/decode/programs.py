"""Compiled programs: the decode loops (beam, greedy and sampled decoding,
and the no-speech probe) and the encode as one CUDA graph per shape
(port-only, like ``device.py``). This is the counterpart of the JAX
package's ``jax.jit`` over the ``lax.scan`` of ``decode/beam.py``,
``decode/greedy.py`` and ``decode/sampling.py``, with the decoder's fusion
and cast inside the program as in its ``models/av_whisper.py``, and of the
jitted encode of its engines and ``models/asr.py``.

A ``DecodePrograms`` serves one source ``WhisperDecoder``. It holds one
prepared decoder per ``weight_quant`` (``prepare_decode_params``, made once),
one CUDA graph memory pool and the captured graphs. A graph records, on the
card, the refresh of the prepared decoder from the source weights
(``WhisperDecoder.refresh_decode_params``) and then the unchanged
``beam_search``, ``greedy_decode``, ``sample_decode`` or
``no_speech_probability`` over it, on static inputs (``features [B, T_enc,
D]``, ``valid [B, T_enc]``, ``prefix [n_prefix]``). A call copies its inputs
into them, replays the graph and returns clones of the static outputs, so
that the next replay never overwrites a result that a caller holds.

- **The key** of a graph (``program_key``) is what fixes its kernels and
  addresses: the loop, the features' shape, dtype and device, whether a
  validity mask is given, the prefix length, the loop's static arguments
  (the sampler's temperature among them), ``id(logit_rules)`` (the graph
  keeps the rules object alive: it reads the rules' tables), the quant modes
  and the ``data_ptr()`` of every source parameter. A parameter replaced by
  assignment (``p.data = ...``) makes a new key, and the graphs that read
  the old addresses are dropped; an in-place update (an optimizer step,
  ``load_state_dict``) is read by the refresh at the next replay.
- **The sampler's noise** is a static input too: a call fills one
  ``[max_len - 1, rows, V]`` fp32 buffer per shape from its draw source,
  outside the graph, and the graph reads step ``i``'s row at step ``i``.
- **Capture** (``GraphPool.capture_graph``, shared with the encode, the
  continuous engine's segment and the streaming decoder's chunk) follows
  PyTorch's recipe: one eager run on the capture stream first, which builds
  what a capture refuses to build (the logit rules' tables, copied from the
  host; cuBLAS handles and workspaces; sort workspaces; K1's tensor-map
  entry point and shared-memory limit), then ``torch.cuda.graph`` on the
  caller's stream (on a side stream of the pool's when the caller is on the
  default stream) in ``thread_local`` error mode, since a serving engine's
  completion thread waits on events while its dispatch thread captures. A
  capture or replay error raises: on the card nothing runs eagerly behind a
  program.
- **The kernels' launch counts** (K1's in ``ops/flash_attention.py``, the
  CTC's in ``ops/losses.py``, the ResNet's 1x1 GEMM's in
  ``ops/bottleneck_gemm.py``) leave out the eager run's and the capture's
  launches; the capture's are added at each replay, so a count stays the
  kernels sent to the card.
- **Order.** The graphs of one object share its prepared decoders and its
  pool, so its calls are serialised across threads (a lock) and streams
  (each call's stream waits for the event after the last replay).
- **On the CPU** there is no graph: the same object refreshes its prepared
  decoder and runs the eager loop, the plain version of the program.

An ``EncodeProgram`` is a net's encode (``AVWhisperNet.encode``,
``WhisperASR.encode``) the same way: one graph per key (the inputs' shapes
and dtypes, the device, the static arguments, the attention backends and the
``data_ptr()`` of every parameter and buffer the encode reads), one pool for
all of them, inputs copied into static buffers, clones returned. K1 runs
inside it: its TMA tensor maps are kernel parameters, so a graph holds the
static buffers' addresses, which every replay fills.

The train and eval steps are programs of this kind too
(``training/programs.py``: one graph per batch shape that replays the whole
step, on a mesh of NCCL groups its collectives included). ``tools/export_model.py``'s
``BeamProgram`` is no graph: ``torch.export`` traces its prefix and its
search, a ``while_loop`` each over ``decode/beam.py::BeamLoop.prefix_step``
and ``BeamLoop.step``, into a ``.pt2``, and cannot trace a replay.
"""

from __future__ import annotations

import threading
import time

import torch

from mocov2_whisper_flamingo_torch.decode.beam import BeamResult, beam_search
from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode
from mocov2_whisper_flamingo_torch.decode.sampling import (
    GumbelDraws, SampleResult, no_speech_probability, sample_decode, sample_noise)
from mocov2_whisper_flamingo_torch.ops import bottleneck_gemm as BG
from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops import losses


def program_key(loop: str, decoder, features: torch.Tensor, valid: torch.Tensor | None,
                n_prefix: int, logit_rules, weight_quant: str | None, **static) -> tuple:
    """The key of the graph that decodes ``features`` with ``loop``
    ("beam", "greedy", "sample" or "no_speech") over ``decoder`` (the source
    decoder); ``static``: the loop's other arguments (beam size,
    ``max_len``, ``eos_id``, the temperature, ...)."""
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


# The kernels whose launches a graph's capture keeps and its replays credit, by
# the name its capture record gives them.
COUNTED = {"k1": fa, "ctc": losses, "bottleneck_gemm": BG}


def _uncounted(fn, counted=tuple(COUNTED.values())) -> tuple:
    """``fn()`` with none of its kernel launches counted: ``(its result,
    ((launches, by kernel) of each of COUNTED's kernels, in its order))``."""
    if not counted:
        return fn(), ()
    (out, rest), n, by_kernel = counted[0].uncounted(lambda: _uncounted(fn, counted[1:]))
    return out, ((n, by_kernel), *rest)


class GraphPool:
    """What the CUDA graphs of one owner share: a memory pool (``pool``, None
    until the first capture), a side stream for callers on the default
    stream, the graphs whose capture raised, one record per capture
    (``captures``: the caller's fields, the seconds of the capture and of
    the graph's instantiation, and the K1 launches the graph holds) and the
    count of replays (``replays``)."""

    def __init__(self):
        self.pool = None
        self.captures: list[dict] = []
        self.replays = 0
        self._side = None  # capture stream for callers on the default stream
        self._failed: list = []  # graphs whose capture raised

    def capture_graph(self, fn, stream, restore=(), generators=(), **record) -> tuple:
        """Capture ``fn()`` into a new graph in this pool and return
        ``(graph, fn's outputs in the pool)``. ``fn`` runs once eagerly on
        the capture stream first; ``restore``: tensors that ``fn`` writes in
        place, copied aside before that run and back after it, so that the
        eager run leaves them as they were and the first replay does the
        call's work. ``generators``: CUDA generators that ``fn`` draws from;
        each is put back where the eager run found it and registered with
        the graph, so that every replay draws from the generator's state
        then and advances it as the eager function would. Neither run counts
        the kernels' launches (K1's, the CTC's, the 1x1 GEMM's): the
        capture's are kept with the graph and counted at each replay."""
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
            states = [g.get_state() for g in generators]
            _uncounted(fn)  # eager: the rules' tables, library handles, workspaces
            for t, s in zip(restore, saved):
                t.copy_(s)
            for g, state in zip(generators, states):
                g.set_state(state)
                graph.register_generator_state(g)
            del saved
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=capture_stream,
                                      capture_error_mode="thread_local"):
                    outputs, launched = _uncounted(fn)
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
        graph.launched = launched
        self.captures.append({**record, "capture_s": t1 - t0, "instantiate_s": t2 - t1,
                              **{f"{name}_launches": n
                                 for name, (n, _) in zip(COUNTED, launched)}})
        return graph, outputs

    def replay(self, graph: torch.cuda.CUDAGraph) -> None:
        """Replay a graph of this pool and count the kernel launches it holds."""
        graph.replay()
        self.replays += 1
        for kernel, launched in zip(COUNTED.values(), graph.launched):
            kernel.credit(*launched)

    def run_keyed(self, graphs: dict, key: tuple, fn, inputs: tuple, stream, keep=None,
                  **record) -> tuple:
        """Replay the graph of ``key`` in ``graphs`` (key -> (graph, static
        inputs, static outputs, ``keep``)) with ``inputs`` copied into its
        static inputs, and return clones of its outputs. A new key first
        captures ``fn(*static inputs)`` on copies of ``inputs`` on the
        stream's device, and drops the graphs whose key ends otherwise (the
        weights' addresses). ``None`` inputs stay None; ``keep``: an object
        the graph reads, kept alive with it."""
        prog = graphs.get(key)
        if prog is None:
            for stale in [k for k in graphs if k[-1] != key[-1]]:
                del graphs[stale]
            held = tuple(None if x is None else
                         torch.empty_like(x, device=stream.device).copy_(x, non_blocking=True)
                         for x in inputs)
            graph, outputs = self.capture_graph(lambda: fn(*held), stream, **record)
            prog = graphs[key] = (graph, held, outputs, keep)
        else:
            for dst, src in zip(prog[1], inputs):
                if dst is not None:
                    dst.copy_(src, non_blocking=True)
        self.replay(prog[0])
        return tuple(o.clone() for o in prog[2])


class DecodePrograms(GraphPool):
    """The compiled beam, greedy and sampled decodes and no-speech probe of
    one source ``WhisperDecoder`` (see the module doc). ``captures`` holds
    one record per capture: the loop, the features' shape, the seconds of
    the capture and of the graph's instantiation and its K1 launches.
    ``pool`` is the graphs' memory pool handle (None until the first
    capture)."""

    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder
        self.prepared: dict = {}  # weight_quant -> prepared decoder
        # program_key -> (graph, static (features, valid, prefix), outputs, logit rules)
        self.programs: dict = {}
        self._noise: dict = {}  # (shape, device) -> the sampler's static noise
        self._lock = threading.Lock()
        self._last = None  # CUDA event after the last replay

    def prepared_decoder(self, weight_quant: str | None = None):
        """The prepared decoder for ``weight_quant``, made on first use (as
        it stood then; the programs refresh it before every decode)."""
        if weight_quant not in self.prepared:
            self.prepared[weight_quant] = self.decoder.prepare_decode_params(weight_quant)
        return self.prepared[weight_quant]

    def refreshed_decoder(self, weight_quant: str | None = None):
        """The prepared decoder for ``weight_quant``, brought up to date with
        the source weights now, after the last replay: for the callers that
        read it outside a program (language detection, the word-time
        alignment, the streaming decoder's chunk graphs)."""
        with self._lock, torch.no_grad():
            decoder = self.prepared_decoder(weight_quant)
            if self._last is not None:
                torch.cuda.current_stream(decoder.pos_embed.device).wait_event(self._last)
            return self.decoder.refresh_decode_params(decoder)

    def weight_quant_of(self, decoder) -> str | None:
        """The ``weight_quant`` whose prepared decoder is ``decoder``."""
        for weight_quant, prepared in self.prepared.items():
            if prepared is decoder:
                return weight_quant
        raise ValueError("the decoder is none of the prepared decoders of these programs")

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

    def sample(self, features: torch.Tensor, valid: torch.Tensor | None, prefix_ids,
               temperature: float = 1.0, num_samples: int = 1, max_len: int = 224,
               eos_id: int = 0, logit_rules=None, cache_quant: str | None = None,
               weight_quant: str | None = None, seed: int = 0, draws=None) -> SampleResult:
        """``sample_decode`` over the prepared decoder. Its noise, from
        ``draws`` (default ``GumbelDraws(seed)``) along ``sample_decode``'s
        fold path, fills a static buffer outside the graph (``sample_noise``).
        The temperature is in the key, as the JAX package compiles one
        program per temperature: the graph divides by it as a host scalar,
        which ATen's CUDA division takes as a multiplication by its
        reciprocal, where a device tensor would be divided by."""
        t = float(temperature)
        static = dict(temperature=t, num_samples=num_samples, max_len=max_len, eos_id=eos_id,
                      cache_quant=cache_quant)
        shared = None
        if t > 0.0:
            draws = draws if draws is not None else GumbelDraws(seed)
            n_prefix = len(prefix_ids)
            shape = (max_len - 1, features.shape[0] * num_samples,
                     self.decoder.config.vocab_size)

            def shared():
                key = (shape, features.device)
                if features.device.type == "cuda" and key not in self._noise:
                    self._noise[key] = torch.empty(shape, dtype=torch.float32,
                                                   device=features.device)
                return (sample_noise(draws, n_prefix, shape, features.device,
                                     out=self._noise.get(key)),)

        def loop(decoder, f, v, p, noise=None):
            r = sample_decode(decoder, f, p, encoder_valid=v, logit_rules=logit_rules,
                              noise=noise, **static)
            return r.sequences, r.sum_logprob, r.avg_logprob

        sequences, sum_lp, avg_lp = self._run("sample", loop, features, valid, prefix_ids,
                                              logit_rules, weight_quant, static, shared)
        return SampleResult(sequences=sequences, sum_logprob=sum_lp, avg_logprob=avg_lp)

    def no_speech(self, features: torch.Tensor, valid: torch.Tensor | None, prefix_ids,
                  no_speech_id: int, sot_index: int = 0,
                  weight_quant: str | None = None) -> torch.Tensor:
        """``no_speech_probability`` over the prepared decoder: the prefix up
        to ``sot_index`` is the graph's static input, so the key holds
        ``sot_index``."""
        n = int(sot_index) + 1
        prefix = prefix_ids[:n] if isinstance(prefix_ids, torch.Tensor) else list(prefix_ids)[:n]

        def loop(decoder, f, v, p):
            return (no_speech_probability(decoder, f, p, no_speech_id, sot_index=n - 1,
                                          encoder_valid=v),)

        (prob,) = self._run("no_speech", loop, features, valid, prefix, None, weight_quant,
                            dict(no_speech_id=int(no_speech_id)))
        return prob

    # -- one call -----------------------------------------------------------------

    def _run(self, name: str, loop, features, valid, prefix_ids, logit_rules, weight_quant,
             static: dict, shared=None) -> tuple:
        """One call of ``loop``; ``shared()`` fills and returns the static
        inputs that every graph of their shape reads in place (called on the
        call's stream after the last replay)."""
        def program(f, v, p, *extra):
            decoder = self.prepared_decoder(weight_quant)
            self.decoder.refresh_decode_params(decoder)
            return loop(decoder, f, v, p, *extra)

        with self._lock, torch.no_grad():
            self.prepared_decoder(weight_quant)  # made outside any capture
            if features.device.type != "cuda":
                return program(features, valid, prefix_ids, *(shared() if shared else ()))
            prefix = _pinned_prefix(prefix_ids)
            key = program_key(name, self.decoder, features, valid, int(prefix.shape[0]),
                              logit_rules, weight_quant, **static)
            stream = torch.cuda.current_stream(features.device)
            if self._last is not None:
                stream.wait_event(self._last)
            extra = shared() if shared else ()
            out = self.run_keyed(self.programs, key, lambda f, v, p: program(f, v, p, *extra),
                                 (features, valid, prefix), stream, keep=logit_rules,
                                 loop=name, shape=list(features.shape))
            self._last = torch.cuda.Event()
            self._last.record(stream)
        return out


def encode_key(modules, inputs: tuple, static: dict) -> tuple:
    """The key of the encode graph of ``inputs`` over ``modules``: the
    inputs' shapes and dtypes, the device, the static arguments, the
    attention backend of every layer that has one and the ``data_ptr()`` of
    every parameter and buffer (last, as in ``program_key``)."""
    return (tuple((tuple(x.shape), x.dtype) for x in inputs), inputs[0].device,
            tuple(sorted(static.items())),
            tuple(m.backend for mod in modules for m in mod.modules() if hasattr(m, "backend")),
            tuple(t.data_ptr() for mod in modules for t in (*mod.parameters(), *mod.buffers())))


class EncodeProgram(GraphPool):
    """A net's encode, ``fn(*inputs, **static) -> tuple of tensors`` over the
    weights of ``modules``, as one CUDA graph per ``encode_key`` in one pool
    (see the module doc). ``graphs``: key -> (graph, static inputs, static
    outputs, None). On the CPU a call runs ``fn``."""

    def __init__(self, fn, *modules):
        super().__init__()
        self.fn = fn
        self.modules = modules
        self.graphs: dict = {}
        self._lock = threading.Lock()
        self._last = None  # CUDA event after the last replay

    def __call__(self, *inputs: torch.Tensor, **static) -> tuple:
        with self._lock, torch.no_grad():
            dev = inputs[0].device
            if dev.type != "cuda":
                return self.fn(*inputs, **static)
            key = encode_key(self.modules, inputs, static)
            stream = torch.cuda.current_stream(dev)
            if self._last is not None:
                stream.wait_event(self._last)
            out = self.run_keyed(self.graphs, key, lambda *held: self.fn(*held, **static),
                                 inputs, stream, loop="encode", shape=list(inputs[0].shape))
            self._last = torch.cuda.Event()
            self._last.record(stream)
        return out
