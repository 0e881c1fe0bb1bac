"""Long-form streaming decode: 30 s chunks with a persistent KV cache
(counterpart of ``decode/streaming.py``).

Long audio goes through the encoder as consecutive 30 s chunks while the
decoder state persists: the generated tokens stay in the self-attention
cache across chunks and each chunk swaps in its own cross-attention K/V, so
the transcript continues without re-decoding. Within a chunk the K beams run
the JAX package's chunk-local beam search (top K of the K×K expansion, EOS
freezes a beam); at the chunk boundary the best beam is committed: its
tokens and self cache are copied to all K rows and the next chunk restarts
from that one hypothesis. When the next chunk could overflow the ``max_len``
token and position budget, the window rolls over: the decoder state is reset
and the next chunk re-primes with ``sot_prev_id`` + the last
``context_tokens`` committed tokens + the prefix (Whisper's
condition-on-previous-text window restart).

How the TPU design is rendered on the GPU:

- **Ancestry becomes a physical reorder.** The JAX chunk never moves a cache
  line: it folds an append-only one-hot ancestry tensor into attention and
  commits the best beam with one einsum. Here, as in ``decode/beam.py``, the
  self cache is reordered physically after each step (one ``index_select``
  over the stacked caches), and the commit is one more ``index_select`` that
  copies the best row over all K rows. The decoder owns its self caches and
  its ``[K, L]`` token buffer, each with a spare: a reorder writes into the
  spare and the two alternate, and the chunk ends in the buffers it began
  with (one copy back when needed), so every chunk reads and writes the
  same addresses.
- **The step's position lives on the card.** The chunk starts at a 0-d
  device position ``i0``; step ``s`` stands at ``i0 + s`` and
  ``idx = min(i, L - 2)`` is computed there. Every step reads the whole
  window under the ``<= position`` mask (``decode_step(positions=...)``,
  all K rows at ``idx``), the logit rules take the position as a tensor,
  and the token buffer is read and written at ``idx`` by a gather and a
  scatter. The priming steps keep Python-int positions: their count is
  static. The committed position ``i_new`` (the last non-EOS position of
  the best row, at least the chunk's start) is read back once per chunk:
  one int per ``max_tokens_per_chunk`` steps. ``collect=False`` still skips
  the token transfer. The host-side ``_i_bound`` that decides rollovers
  follows the JAX bookkeeping to the letter: a conservative bound in
  deferred mode, exact only when collecting, so rollovers fire at the same
  chunks as in the JAX package.
- **One CUDA graph per chunk key** (the counterpart of the JAX chunk's
  ``jax.jit``, a few per stream: each window's first chunk and its steady
  chunks): ``(n_prime, has_valid, begin_index)``, the encoder output's shape, dtype and device, and
  ``id(logit_rules)``. The encoder output and its validity are copied into
  static inputs and the cross K/V are made inside the graph. On the card
  every chunk replays its key's graph (captured at the key's first chunk,
  the capture's eager run undone); a capture or replay error raises. On the
  CPU the same chunk runs eagerly, the plain version. The graph reads the
  prepared decoder it is given, so a decoder kept across calls
  (``transcribe_long_form(stream_decoders=...)``, as ``WhisperASR`` keeps
  one per configuration) captures its keys once.
- **Resume.** The next chunk's first step re-feeds the token at ``i_new`` at
  position ``i_new``, which overwrites that position's K/V against the new
  chunk's cross K/V; keys past ``i_new`` (EOS steps of finished beams) are
  never read, because a step at position ``i`` attends to keys ``0 .. i``
  only.
- **Write gate.** Steps past the end of the token buffer (reachable only when
  the window cannot roll over) keep the cache as it was
  (``WhisperDecoder.decode_step(write=...)`` with a device-side gate, traced
  only when ``rollover=False`` as in the JAX chunk), so they change nothing.
- ``cache_layout`` ("rows" / "bhjtd") chooses a TPU layout in the JAX
  package and is accepted here as a no-op, as ``beam_search`` accepts it.

``transcribe_long_form`` has both of the JAX package's modes: this
streaming decode, and the quality mode (openai's window loop with
temperature fallback, the no-speech skip and timestamp seek, over
``decode/sampling.py`` and ``decode/segments.py``).
"""

from __future__ import annotations

import logging

import torch

from mocov2_whisper_flamingo_torch.decode.beam import NEG_INF, _top_k, reorder_into
from mocov2_whisper_flamingo_torch.decode.programs import GraphPool
from mocov2_whisper_flamingo_torch.decode.sampling import GumbelDraws, decode_with_fallback
from mocov2_whisper_flamingo_torch.decode.segments import (
    TIME_PRECISION, segments_from_window, strip_timestamps)

logger = logging.getLogger(__name__)


class StreamingDecoder:
    """Feed chunks of encoder features; carries transcript + decoder cache.

    ``decoder`` is a prepared ``WhisperDecoder`` (``prepare_decode_params``);
    it holds the weights the JAX class takes as ``params``.
    ``beam_size=1`` is greedy; ``beam_size>1`` runs chunk-local beam search
    with best-path commit at each chunk boundary.

    ``rollover`` (default True): when the next chunk could overflow the
    ``max_len`` token/PE budget, commit the window and restart the decoder
    context, re-priming with ``sot_prev_id`` + the last ``context_tokens``
    committed text tokens + the prefix (``context_tokens=0`` restarts from the
    bare prefix). With ``rollover=False`` decoding hard-stops at ``max_len``
    tokens.

    ``logit_rules``: optional ``decode.logit_rules.LogitRules`` applied at
    each step; begin-index rules fire at each window's first generated
    position. ``initial_context``: conditioning tokens decoded against but
    never committed (openai's ``initial_prompt``).

    ``graphs``: the chunk graphs' ``GraphPool`` (captures, replays, pool).
    """

    def __init__(self, decoder, prefix_ids, max_len: int = 448, eos_id: int = 0,
                 max_tokens_per_chunk: int = 64, beam_size: int = 1,
                 length_penalty: float = 1.0, rollover: bool = True,
                 context_tokens: int = 0, sot_prev_id: int | None = None,
                 logit_rules=None, initial_context: list[int] | None = None,
                 cache_layout: str = "rows"):
        if cache_layout not in ("rows", "bhjtd"):
            raise ValueError(f"unknown cache_layout {cache_layout!r}; "
                             "expected 'rows' or 'bhjtd'")
        self.decoder = decoder
        self.cache_layout = cache_layout
        self.prefix_ids = [int(t) for t in prefix_ids]
        self.initial_context = [int(t) for t in (initial_context or [])]
        self.max_len = max_len
        self.eos_id = eos_id
        self.max_tokens_per_chunk = max_tokens_per_chunk
        self.beam_size = beam_size
        self.length_penalty = length_penalty
        self.rollover = rollover
        self.context_tokens = context_tokens
        self.sot_prev_id = sot_prev_id
        self.logit_rules = logit_rules
        self.device = decoder.pos_embed.device
        eos_only = torch.full((decoder.config.vocab_size,), NEG_INF, dtype=torch.float32,
                              device=self.device)
        eos_only[eos_id] = 0.0
        self._eos_only = eos_only
        cfg = decoder.config
        shape = (cfg.decoder_layers, beam_size, max_len, cfg.n_heads, cfg.head_dim)
        dtype = decoder.precision.compute_dtype

        def buffers():  # (self_k, self_v, tokens [K, L])
            return (torch.zeros(shape, dtype=dtype, device=self.device),
                    torch.zeros(shape, dtype=dtype, device=self.device),
                    torch.full((beam_size, max_len), eos_id, dtype=torch.long,
                               device=self.device))

        self._buffers, self._spares = buffers(), buffers()
        self.graphs = GraphPool()
        self._programs: dict = {}  # chunk key -> (graph, static inputs, i_new)
        self.reset()

    def reset(self) -> None:
        self.tokens = list(self.prefix_ids)
        # Transcript committed from closed, drained windows (original prefix
        # included; window re-prime context is never re-emitted).
        self._committed = list(self.prefix_ids)
        # Closed windows not yet read back: (token row [L] on the device,
        # i_new, window prefix length).
        self._stash: list[tuple] = []
        # The current window's forced prefix (context + prefix after a
        # rollover; initial_context + prefix for window 0).
        self._window_prefix = self._context_prefix(self.initial_context)
        self._state = None  # (self_k, self_v, tokens [K, L] on the device, i)
        # Host-side conservative bound on the position, for the rollover
        # decision (the JAX bookkeeping, see the module docstring).
        self._i_bound = len(self._window_prefix) - 1

    def _context_prefix(self, ctx: list[int]) -> list[int]:
        """sot_prev + context + prefix (the window's forced tokens). The
        context is clamped to half the token budget (openai's prompt clamp)
        so every window keeps room to generate."""
        budget = self.max_len // 2 - len(self.prefix_ids) - 1
        ctx = list(ctx)[-budget:] if budget > 0 else []
        if ctx and self.sot_prev_id is not None:
            ctx = [self.sot_prev_id] + ctx
        return ctx + list(self.prefix_ids)

    # -- one chunk -------------------------------------------------------------

    def _init_state(self, window_prefix: list[int]) -> tuple:
        self_k, self_v, tokens = self._buffers
        self_k.zero_()
        self_v.zero_()
        tokens.fill_(self.eos_id)
        prefix = torch.tensor(window_prefix, dtype=torch.long)
        if self.device.type == "cuda":  # a copy that does not wait for the queued work
            prefix = prefix.pin_memory()
        tokens[:, : len(window_prefix)] = prefix.to(self.device, non_blocking=True)
        return self_k, self_v, tokens, len(window_prefix) - 1

    def _chunk(self, encoder_out: torch.Tensor, encoder_valid: torch.Tensor | None,
               i0: torch.Tensor, n_prime: int, begin_index: int) -> torch.Tensor:
        """Decode one chunk in place on the decoder's buffers from the 0-d
        device position ``i0``, commit the best beam and return the
        committed position ``i_new`` (0-d, on the device). No host value
        enters it, so a CUDA graph can capture it."""
        dec, eos, rules = self.decoder, self.eos_id, self.logit_rules
        k, l_ = self.beam_size, self.max_len
        caches, cache_spares = self._buffers[:2], self._spares[:2]
        (tokens,), (token_spare,) = self._buffers[2:], self._spares[2:]
        cross_k, cross_v = dec.cross_caches(encoder_out)  # the JAX _cross_caches
        cache = {"self_k": caches[0], "self_v": caches[1], "cross_k": cross_k,
                 "cross_v": cross_v}
        for i in range(n_prime):  # the window's forced tokens, the same in every row
            dec.decode_step(tokens[:1, i:i + 1].expand(k, 1), cache, i, encoder_valid)

        def reorder(rows):  # beams into the spare buffers, which take over
            nonlocal caches, cache_spares, tokens, token_spare
            (tokens,), (token_spare,) = reorder_into((tokens,), (token_spare,), rows, dim=0)
            if k > 1:
                caches, cache_spares = reorder_into(caches, cache_spares, rows)

        scores = torch.full((k,), NEG_INF, dtype=torch.float32, device=self.device)
        scores[:1].fill_(0.0)  # a fill, not a copy from the host: a graph can capture it
        done = torch.zeros((k,), dtype=torch.bool, device=self.device)
        for s in range(self.max_tokens_per_chunk):
            i = i0 + s
            past_end = i > l_ - 2  # no room to write at i + 1
            idx = i.clamp(max=l_ - 2)
            done = done | past_end
            cache["self_k"], cache["self_v"] = caches
            logits, _ = dec.decode_step(tokens.gather(1, idx.expand(k, 1)), cache, l_ - 1,
                                        encoder_valid, positions=idx.expand(k),
                                        write=True if self.rollover else ~past_end)
            logp = torch.log_softmax(logits.float(), dim=-1)
            if rules is not None:
                logp = rules(logp, tokens, idx + 1, begin_index)
            logp = torch.where(done[:, None], self._eos_only, logp)

            # Per-beam top K over the vocab, then top K of the K*K union.
            s1, t1 = torch.topk(logp, k, dim=-1)
            top_scores, flat = _top_k((scores[:, None] + s1).reshape(1, k * k), k)
            beam_idx = flat[0] // k
            token_idx = t1.reshape(-1).gather(0, flat[0])
            reorder(beam_idx)
            done = done.index_select(0, beam_idx)
            token_idx = torch.where(done, eos, token_idx)
            at = (idx + 1).expand(k, 1)  # kept as it was past the end
            tokens.scatter_(1, at, torch.where(past_end, tokens.gather(1, at)[:, 0],
                                               token_idx)[:, None])
            done = done | (token_idx == eos)
            scores = top_scores[0]

        # Commit the best beam (chunk-local length-normalised score): its
        # tokens and self cache go to every row.
        gen = (tokens != eos).sum(dim=-1) - (i0 + 1)
        norm = scores / torch.pow(gen.clamp(min=1).float(), self.length_penalty)
        reorder(torch.argmax(norm).expand(k))
        for dst, src in zip(self._buffers, (*caches, tokens)):
            if src is not dst:  # back into the decoder's own buffers
                dst.copy_(src)
        pos = torch.arange(l_, device=self.device)
        return torch.maximum(torch.where(self._buffers[2][0] != eos, pos, 0).max(), i0)

    def _run_chunk(self, encoder_out: torch.Tensor, encoder_valid: torch.Tensor | None,
                   i0: int, n_prime: int, begin_index: int) -> torch.Tensor:
        """The chunk from position ``i0``: on the card a replay of its key's
        graph (captured at the key's first chunk), on the CPU the eager
        chunk. Returns ``i_new`` (0-d, on the device)."""
        if self.device.type != "cuda":
            return self._chunk(encoder_out, encoder_valid,
                               torch.tensor(i0, device=self.device), n_prime, begin_index)
        i0_host = torch.tensor(i0).pin_memory()
        key = (n_prime, encoder_valid is not None, begin_index, tuple(encoder_out.shape),
               encoder_out.dtype, encoder_out.device, id(self.logit_rules))
        prog = self._programs.get(key)
        if prog is None:
            inputs = (encoder_out.clone(), None if encoder_valid is None else encoder_valid.clone(),
                      i0_host.to(self.device, non_blocking=True))
            graph, i_new = self.graphs.capture_graph(
                lambda: self._chunk(*inputs, n_prime, begin_index),
                torch.cuda.current_stream(self.device), restore=self._buffers, loop="chunk",
                n_prime=n_prime, begin_index=begin_index, shape=list(encoder_out.shape))
            prog = self._programs[key] = (graph, inputs, i_new)
        else:
            for dst, src in zip(prog[1], (encoder_out, encoder_valid, i0_host)):
                if dst is not None:
                    dst.copy_(src, non_blocking=True)
        self.graphs.replay(prog[0])
        return prog[2]

    # -- window rollover -------------------------------------------------------

    def _drain_stash(self) -> None:
        """Read back the stashed closed windows into the committed
        transcript."""
        for row, i_new, wp_len in self._stash:
            self._committed.extend(row[wp_len: i_new + 1].tolist())
        self._stash = []

    def _window_generation(self) -> list[int]:
        """The current window's generated tokens (window prefix excluded),
        read back from the device."""
        if self._state is None:
            return []
        _, _, tokens, i_new = self._state
        return tokens[0, len(self._window_prefix): i_new + 1].tolist()

    def _maybe_rollover(self) -> None:
        """Restart the decoder window if the next chunk could overflow the
        token/PE budget (host-side trigger on ``_i_bound``). With
        ``context_tokens=0`` the closed window's token row is stashed on the
        device and read back at the next collecting call;
        ``context_tokens>0`` needs the tokens now."""
        if not self.rollover or self._state is None:
            return
        if self._i_bound + self.max_tokens_per_chunk <= self.max_len - 2:
            return
        _, _, tokens, i_new = self._state
        if self.context_tokens > 0:
            self._drain_stash()
            self._committed = self._committed + self._window_generation()
            # context is text only: no EOS, and no timestamp tokens when the
            # timestamp grammar is active
            ts0 = getattr(self.logit_rules, "timestamp_begin", None) \
                if self.logit_rules is not None else None
            pool = [t for t in self._committed[len(self.prefix_ids):]
                    if t != self.eos_id and (ts0 is None or t < ts0)]
            # initial_context ahead of the rolling transcript, tail-clamped
            ctx = (self.initial_context + pool)[
                -max(self.context_tokens, len(self.initial_context)):]
            self._window_prefix = self._context_prefix(ctx)
            self.tokens = list(self._committed)
        else:  # a copy: the next window reuses the buffer
            self._stash.append((tokens[0].clone(), i_new, len(self._window_prefix)))
            self._window_prefix = self._context_prefix(self.initial_context)
        self._state = None
        self._i_bound = len(self._window_prefix) - 1

    # -- public API ------------------------------------------------------------

    @torch.no_grad()
    def process_chunk(self, encoder_out: torch.Tensor,
                      encoder_valid: torch.Tensor | None = None,
                      collect: bool = True) -> list[int]:
        """Decode against one chunk's encoder output (``[1, T, D]`` on the
        decoder's device); returns the newly committed token ids (EOS ends
        the chunk, not the stream).

        ``collect=False`` skips the token transfer to the host (the chunk's
        position, one int, is still read back); call ``collected_tokens()``
        at any boundary to drain the transcript."""
        self._maybe_rollover()
        first = self._state is None
        if first:
            self._state = self._init_state(self._window_prefix)
        i0 = self._state[3]
        n_prime = max(len(self._window_prefix) - 1, 0) if first else 0
        i_new = int(self._run_chunk(encoder_out, encoder_valid, i0, n_prime,
                                    len(self._window_prefix)))
        self_k, self_v, tokens = self._buffers
        self._state = (self_k, self_v, tokens, i_new)
        self._i_bound = min(self._i_bound + self.max_tokens_per_chunk, self.max_len - 1)
        if not collect:
            return []
        self._drain_stash()
        row = tokens[0, : i_new + 1].tolist()
        # the true position replaces the conservative bound
        self._i_bound = i_new
        self.tokens = self._committed + row[len(self._window_prefix):]
        return row[i0 + 1:]

    def collected_tokens(self) -> list[int]:
        """Return the full transcript committed so far (original prefix
        included, window re-prime context excluded), read back from the
        device; the companion of ``process_chunk(collect=False)``. Also
        reconciles ``self.tokens``."""
        self._drain_stash()
        self.tokens = self._committed + self._window_generation()
        return list(self.tokens)


def transcribe_long_form(
    encoder,
    decoder,
    audio,
    prefix_ids,
    eos_id: int = 0,
    chunk_seconds: float = 30.0,
    sample_rate: int = 16_000,
    max_len: int = 448,
    max_tokens_per_chunk: int = 64,
    beam_size: int = 1,
    length_penalty: float = 1.0,
    mel_fn=None,
    rollover: bool = True,
    context_tokens: int = 0,
    sot_prev_id: int | None = None,
    initial_prompt_ids=None,
    logit_rules=None,
    temperatures=None,
    best_of: int = 5,
    logprob_threshold: float | None = -1.0,
    compression_ratio_threshold: float | None = 2.4,
    no_speech_threshold: float | None = None,
    no_speech_id: int | None = None,
    sot_id: int | None = None,
    text_fn=None,
    seed: int = 0,
    draws=None,
    return_segments: bool = False,
    cache_layout: str = "rows",
    programs=None,
    stream_decoders: dict | None = None,
) -> list[int] | tuple[list[int], list[dict]]:
    """Long-form ASR: waveform of any length -> 30 s windows -> log-mel ->
    encoder -> decode. Returns every generated token id (prefix excluded);
    ``return_segments`` also returns segment dicts ``{"id", "start", "end",
    "seek", "tokens", ...}``.

    ``encoder`` is a ``WhisperEncoder`` or another callable ``mel [1,
    n_mels, T] -> [1, T', D]`` (``WhisperASR.encode``, whose CUDA graph
    replays), ``decoder`` a prepared ``WhisperDecoder`` on the same device
    (they hold the weights the JAX function takes as ``encoder_params`` /
    ``decoder_params``); ``audio`` a ``[T]`` waveform. Each window is
    encoded once, on that device.

    **Streaming mode** (``temperatures=None``): one persistent-cache
    ``StreamingDecoder``; with ``rollover`` the transcript is not bounded by
    ``max_len``. One segment per chunk that produced tokens (window bounds
    clipped to the audio). ``stream_decoders``: a dict that keeps one
    ``StreamingDecoder`` per configuration across calls (made on first use,
    ``reset`` at each call), so that its chunk graphs are captured once.

    **Quality mode** (``temperatures`` given): openai ``transcribe``'s window
    loop. Each window is decoded on its own through
    ``decode_with_fallback`` (context prompt = ``sot_prev_id`` + the initial
    prompt + the last ``context_tokens`` committed tokens, the transcript
    part cut to a power of two, the whole clamped to half of ``max_len``),
    with the compression-ratio and avg-logprob gates. With
    ``no_speech_threshold`` and ``no_speech_id`` a window whose
    ``<|nospeech|>`` probability at the SOT position (``sot_id``'s index in
    the window prefix, else the start of ``prefix_ids``) exceeds the
    threshold is skipped as silence, unless its avg logprob clears
    ``logprob_threshold``. When ``logit_rules`` enable timestamps, timestamp
    pairs split each window into timed segments (timestamp tokens kept in
    the segments), the next window seeks to the last finished timestamp (at
    least 0.02 s on; past ``10 * n_chunks + 10`` windows whole windows), and
    the flat return keeps text tokens only. A window that had to go above
    t = 0.5 stops conditioning later windows. Segments carry
    ``temperature``, ``avg_logprob``, ``compression_ratio``,
    ``gates_passed`` and, when probed, ``no_speech_prob``. Window ``w``
    samples from ``draws.fold(w)`` (default ``GumbelDraws(seed)``), the JAX
    key chain ``fold_in(key, w)``. This mode reads each rung's tokens back:
    the gates inspect them. ``programs``: the ``DecodePrograms`` whose
    prepared decoder ``decoder`` is; the rungs and the probe then replay its
    graphs (``decode_with_fallback``)."""
    from mocov2_whisper_flamingo_torch.ops.mel import whisper_log_mel

    chunk_samples = int(chunk_seconds * sample_rate)
    mel_fn = mel_fn or (lambda wav: whisper_log_mel(wav, pad_to=chunk_samples))
    device = decoder.pos_embed.device
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device)
    n_chunks = max(-(-audio.shape[-1] // chunk_samples), 1)
    duration = audio.shape[-1] / sample_rate

    def window_bounds(i):
        return i * chunk_seconds, min((i + 1) * chunk_seconds, duration)

    def features_at(start_sample):
        chunk = audio[..., start_sample: start_sample + chunk_samples]
        pad = chunk_samples - chunk.shape[-1]
        if pad > 0:  # the last window is zero-padded to the full length
            chunk = torch.nn.functional.pad(chunk, (0, pad))
        with torch.no_grad():
            return encoder(mel_fn(chunk)[None])

    if temperatures is not None:
        draws = draws if draws is not None else GumbelDraws(seed)
        prefix = [int(t) for t in prefix_ids]
        # openai ``initial_prompt``: conditioning text ahead of the committed
        # transcript; it falls out of the tail slice once the transcript
        # fills the budget, and with ``context_tokens == 0`` it conditions
        # every window.
        prompt0 = [int(t) for t in (initial_prompt_ids or [])]
        committed: list[int] = []
        segments: list[dict] = []
        probe_ns = no_speech_threshold is not None and no_speech_id is not None
        ts0 = getattr(logit_rules, "timestamp_begin", None) if logit_rules is not None else None
        seek = 0.0
        window_index = 0
        reset_since = 0  # openai prompt_reset_since
        # A model could seek by tiny steps forever: past this many windows
        # every window advances a whole window.
        max_windows = n_chunks * 10 + 10
        while (seek < duration - 1e-9) if ts0 is not None else window_index < n_chunks:
            pool = [t for t in committed[reset_since:] if t != eos_id][-context_tokens:] \
                if context_tokens > 0 else []
            # The transcript context is cut to a power of two (oldest tokens
            # first), as in the JAX package, where it bounds the compiled
            # programs; the tokens follow it.
            if pool:
                b = 1
                while b * 2 <= len(pool):
                    b *= 2
                pool = pool[-b:]
            ctx = prompt0 + pool
            # openai clamps the prompt to half the budget, leaving room to
            # generate under max_len.
            ctx_budget = max_len // 2 - len(prefix) - 1
            ctx = ctx[-ctx_budget:] if ctx_budget > 0 else []
            if ctx and sot_prev_id is not None:
                ctx = [sot_prev_id] + ctx
            window_prefix = ctx + prefix
            sot_index = (window_prefix.index(sot_id)
                         if sot_id is not None and sot_id in window_prefix else len(ctx))
            start_sample = (int(round(seek * sample_rate)) if ts0 is not None
                            else window_index * chunk_samples)
            r = decode_with_fallback(
                decoder, features_at(start_sample), window_prefix,
                temperatures=temperatures, beam_size=beam_size, best_of=best_of,
                max_len=max_len, eos_id=eos_id, logit_rules=logit_rules,
                length_penalty=length_penalty, logprob_threshold=logprob_threshold,
                compression_ratio_threshold=compression_ratio_threshold, text_fn=text_fn,
                no_speech_id=no_speech_id if probe_ns else None, sot_index=sot_index,
                no_speech_threshold=no_speech_threshold if probe_ns else None,
                draws=draws.fold(window_index), programs=programs)
            window_index += 1
            skipped = False
            if probe_ns:
                # silence, unless the decode is confident all the same
                skipped = float(r.no_speech_prob[0]) > no_speech_threshold
                if logprob_threshold is not None and float(r.avg_logprob[0]) > logprob_threshold:
                    skipped = False
            if skipped:
                seek += chunk_seconds
                continue
            row = [int(t) for t in r.sequences[0][len(window_prefix):]]
            while row and row[-1] == eos_id:
                row.pop()
            diag = {"temperature": float(r.temperature[0]),
                    "avg_logprob": float(r.avg_logprob[0]),
                    "compression_ratio": float(r.compression_ratio[0]),
                    "gates_passed": bool(r.gates_passed[0])}
            if probe_ns:
                diag["no_speech_prob"] = float(r.no_speech_prob[0])
            if ts0 is not None:
                segs, advance = segments_from_window(
                    row, ts0, time_offset=seek,
                    segment_duration=min(chunk_seconds, duration - seek))
                for s in segs:
                    s.update(diag)
                    s["id"] = len(segments)
                    s["seek"] = seek  # the window's origin (openai's segment key)
                    segments.append(s)
                    # the flat stream keeps text tokens only
                    committed.extend(strip_timestamps(
                        s["tokens"], ts0, eot=getattr(logit_rules, "prompt_eot", None)))
                advance = max(advance, TIME_PRECISION)
                if window_index >= max_windows:
                    logger.warning("timestamp seek exceeded %d windows at %.2f s: degrading "
                                   "to full-window strides", max_windows, seek)
                    advance = max(advance, chunk_seconds)
                seek += advance
            else:
                start, end = window_bounds(window_index - 1)
                segments.append({"id": len(segments), "start": start, "end": end,
                                 "seek": start, "tokens": row, **diag})
                committed.extend(row)
            if float(r.temperature[0]) > 0.5:
                reset_since = len(committed)
        return (committed, segments) if return_segments else committed

    config = dict(max_len=max_len, eos_id=eos_id, max_tokens_per_chunk=max_tokens_per_chunk,
                  beam_size=beam_size, length_penalty=length_penalty, rollover=rollover,
                  context_tokens=context_tokens, sot_prev_id=sot_prev_id,
                  logit_rules=logit_rules,
                  initial_context=[int(t) for t in (initial_prompt_ids or [])] or None,
                  cache_layout=cache_layout)
    key = (id(decoder), tuple(int(t) for t in prefix_ids), id(logit_rules),
           *((k, tuple(v) if isinstance(v, list) else v) for k, v in config.items()
             if k != "logit_rules"))
    stream = None if stream_decoders is None else stream_decoders.get(key)
    if stream is None:
        stream = StreamingDecoder(decoder, prefix_ids, **config)
        if stream_decoders is not None:
            stream_decoders[key] = stream
    stream.reset()
    out: list[int] = []
    segments = []
    for i in range(n_chunks):
        new = stream.process_chunk(features_at(i * chunk_samples))
        if new:
            start, end = window_bounds(i)
            segments.append({"id": len(segments), "start": start, "end": end,
                             "seek": start, "tokens": new})
        out.extend(new)
    return (out, segments) if return_segments else out
