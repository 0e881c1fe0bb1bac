"""Temperature sampling decode and Whisper's quality-gated fallback
(counterpart of ``decode/sampling.py``).

openai ``transcribe`` pairs the deterministic decode with a temperature
fallback: a window whose output fails a quality gate is decoded again by
sampling at the next temperature, with openai's gate rules
(``whisper/transcribe.py``):

- ``compression_ratio > 2.4``: too repetitive (zlib ratio of the text);
- ``avg_logprob < -1.0``: too little confidence;
- a failed gate retries at the next temperature of ``(0.0, 0.2, 0.4, 0.6,
  0.8, 1.0)``; the first attempt that passes (or the last) wins. t = 0 is
  beam search; t > 0 draws ``best_of`` samples and keeps the row with the
  highest average logprob.

**The draw is an input.** The JAX sampler picks
``jax.random.categorical(fold_in(key, i), logp / t)``, which is
``argmax(gumbel + logp / t)`` with Gumbel noise from JAX's counter-based
generator; torch cannot reproduce that noise. So the noise comes from a draw
source with ``fold(n) -> source`` and ``gumbel(shape, device) -> Tensor``,
folded along the JAX key chain (window, then ``int(t * 1000)``, then the
step index), and the sampler picks ``argmax(logp / t + gumbel)``. The
default source, ``GumbelDraws``, draws on the tensors' device from an
explicit ``torch.Generator`` seeded from ``seed`` and the fold path; a test
can hand in JAX's own draws and get the JAX package's tokens.

The noise of every step is drawn before the loop into one ``[max_len - 1,
rows, V]`` buffer (``sample_noise``), which the loop reads row by row: a
CUDA graph of the loop (``decode/programs.py``) takes the buffer as a static
input that each call fills anew. The sampling loop is one Python loop over
``decode_step`` with no read-back inside it: ``done``, the summed logprob
and the scored-step count stay tensors. The ``best_of`` rows ride
``init_cache(beam_groups=best_of)`` in the JAX row order (example-major)
and never reorder. Scoring follows openai:
the summed logprob takes the un-tempered, rule-masked, renormalised logprob
of each chosen token up to and including the EOS emission, and
``avg_logprob`` divides by that count. The temperature ladder is host
control flow and reads each rung's result back: the gates inspect the text.
With a ``DecodePrograms`` (``decode_with_fallback(programs=...)``) every
rung and the no-speech probe replay that object's graphs.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import zlib

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.decode.beam import beam_search, prefix_tensor


class GumbelDraws:
    """Standard Gumbel noise for the sampler, from an explicit
    ``torch.Generator`` seeded by ``seed`` and the fold path.

    ``fold(n)`` returns the source one level down the key chain (as
    ``jax.random.fold_in``); ``gumbel(shape, device)`` returns
    ``-log(-log(u))`` for ``u`` uniform in ``[tiny, 1)``, float32. The noise
    is made on ``device``, or on ``generate_on`` and then moved to ``device``
    (one noise for runs on different devices)."""

    def __init__(self, seed: int = 0, path: tuple[int, ...] = (),
                 generate_on: str | torch.device | None = None):
        self.seed = int(seed)
        self.path = tuple(int(n) for n in path)
        self.generate_on = generate_on

    def fold(self, n: int) -> "GumbelDraws":
        return GumbelDraws(self.seed, self.path + (int(n),), self.generate_on)

    def _generator_seed(self) -> int:
        digest = hashlib.blake2b(repr((self.seed, self.path)).encode(), digest_size=8).digest()
        return int.from_bytes(digest, "little") & ((1 << 63) - 1)

    def gumbel(self, shape, device) -> torch.Tensor:
        where = torch.device(self.generate_on if self.generate_on is not None else device)
        gen = torch.Generator(device=where)
        gen.manual_seed(self._generator_seed())
        u = torch.rand(tuple(shape), generator=gen, device=where, dtype=torch.float32)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return g.to(device)


def sample_noise(draws, n_prefix: int, shape: tuple, device, out=None) -> torch.Tensor:
    """The sampler's noise ``[max_len - 1, rows, V]`` fp32 (``shape``): row
    ``i`` is ``draws.fold(i).gumbel((rows, V), device)``, the noise of step
    ``i``, for the sampled steps ``n_prefix - 1 .. max_len - 2``; the rows
    of the forced prefix are never read. Written into ``out`` when given."""
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    for i in range(n_prefix - 1, shape[0]):
        out[i].copy_(draws.fold(i).gumbel(shape[1:], device))
    return out


@dataclasses.dataclass
class SampleResult:
    sequences: torch.Tensor    # [B, N, L] token ids (EOS-filled past the end)
    sum_logprob: torch.Tensor  # [B, N] summed logprob over scored steps
    avg_logprob: torch.Tensor  # [B, N] sum / n_scored (openai convention)


@torch.no_grad()
def sample_decode(
    decoder,
    encoder_out: torch.Tensor,
    prefix_ids,
    temperature: float = 1.0,
    num_samples: int = 1,
    max_len: int = 224,
    eos_id: int = 0,
    encoder_valid: torch.Tensor | None = None,
    logit_rules=None,
    cache_quant: str | None = None,
    seed: int = 0,
    draws=None,
    noise: torch.Tensor | None = None,
) -> SampleResult:
    """Draw ``num_samples`` independent sampled continuations per example.

    ``decoder`` is a prepared ``WhisperDecoder``. ``temperature=0`` is
    greedy (all rows equal). ``logit_rules`` are applied to the
    log-softmaxed scores before both the draw and the scoring, which then
    renormalises. Step ``i`` draws its noise from ``draws.fold(i)``
    (default ``GumbelDraws(seed)``), or reads row ``i`` of ``noise``
    (``sample_noise``) when it is given. Returns every row; callers rank by
    ``avg_logprob``. ``prefix_ids``: ints, or a long tensor on the encoder
    output's device. ``cache_quant``: ``"int8"`` or ``"int8-cross"``
    (``init_cache``)."""
    dev = encoder_out.device
    rows = encoder_out.shape[0] * num_samples
    prefix = prefix_tensor(prefix_ids, dev)
    n_prefix = int(prefix.shape[0])
    t = float(temperature)
    if t > 0.0 and noise is None:
        noise = sample_noise(draws if draws is not None else GumbelDraws(seed), n_prefix,
                             (max_len - 1, rows, decoder.config.vocab_size), dev)

    cache = decoder.init_cache(encoder_out, max_len=max_len, beam_groups=num_samples,
                               quant=cache_quant)
    tokens = torch.full((rows, max_len), eos_id, dtype=torch.long, device=dev)
    tokens[:, :n_prefix] = prefix
    for i in range(n_prefix - 1):
        decoder.decode_step(prefix[i].expand(rows, 1), cache, i, encoder_valid)

    sum_lp = torch.zeros((rows,), dtype=torch.float32, device=dev)
    n_scored = torch.zeros((rows,), dtype=torch.int32, device=dev)
    done = torch.zeros((rows,), dtype=torch.bool, device=dev)
    for i in range(n_prefix - 1, max_len - 1):
        logits, cache = decoder.decode_step(tokens[:, i:i + 1], cache, i, encoder_valid)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if logit_rules is not None:
            # Rules mask with -1e30; renormalise so that scores are logprobs
            # over the allowed set (openai log-softmaxes after its filters).
            logp = torch.log_softmax(logit_rules(logp, tokens, i + 1, n_prefix), dim=-1)
        if t > 0.0:
            nxt = torch.argmax(logp / t + noise[i], dim=-1)
        else:
            nxt = torch.argmax(logp, dim=-1)
        nxt = torch.where(done, eos_id, nxt)
        tok_lp = logp.gather(1, nxt[:, None])[:, 0]
        # The EOS-emitting step is scored, later steps are not.
        sum_lp = sum_lp + torch.where(done, 0.0, tok_lp)
        n_scored = n_scored + (~done).int()
        done = done | (nxt == eos_id)
        tokens[:, i + 1] = nxt

    avg = sum_lp / n_scored.clamp_min(1).float()
    b = encoder_out.shape[0]
    return SampleResult(sequences=tokens.reshape(b, num_samples, max_len),
                        sum_logprob=sum_lp.reshape(b, num_samples),
                        avg_logprob=avg.reshape(b, num_samples))


@torch.no_grad()
def no_speech_probability(
    decoder,
    encoder_out: torch.Tensor,
    prefix_ids,
    no_speech_id: int,
    sot_index: int = 0,
    encoder_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Probability of ``<|nospeech|>`` at the SOT position (openai
    ``probs_at_sot[:, no_speech_token]``): teacher-force ``prefix_ids[:
    sot_index + 1]`` and softmax the logits that the SOT token produces.
    ``prefix_ids``: ints, or a long tensor on the encoder output's device.
    Returns ``[B]`` fp32 on the decoder's device."""
    b = encoder_out.shape[0]
    prefix = prefix_tensor(prefix_ids, encoder_out.device)
    n = int(sot_index) + 1
    cache = decoder.init_cache(encoder_out, max_len=n + 1)
    for i in range(n):
        logits, cache = decoder.decode_step(prefix[i].expand(b, 1), cache, i, encoder_valid)
    return torch.softmax(logits.float(), dim=-1)[:, no_speech_id]


# -- quality gates (openai whisper/transcribe.py semantics) -------------------


def compression_ratio(text: str | bytes) -> float:
    """UTF-8 length / zlib-compressed length: openai's repetition detector
    (above 2.4 the window is looping)."""
    data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def needs_fallback(
    avg_logprob: float,
    text: str | bytes,
    logprob_threshold: float | None = -1.0,
    compression_ratio_threshold: float | None = 2.4,
    no_speech_prob: float | None = None,
    no_speech_threshold: float | None = None,
) -> bool:
    """Retry when the text is too repetitive or the average logprob too low;
    a confident silence detection overrides both (openai sets
    ``needs_fallback = False`` last when ``no_speech_prob >
    no_speech_threshold``). ``None`` disables a gate."""
    needs = False
    if (compression_ratio_threshold is not None
            and compression_ratio(text) > compression_ratio_threshold):
        needs = True
    if logprob_threshold is not None and float(avg_logprob) < logprob_threshold:
        needs = True
    if (no_speech_threshold is not None and no_speech_prob is not None
            and float(no_speech_prob) > no_speech_threshold):
        needs = False
    return needs


@dataclasses.dataclass
class FallbackResult:
    sequences: np.ndarray      # [B, L] winning sequence per example
    avg_logprob: np.ndarray    # [B]
    temperature: np.ndarray    # [B] temperature that produced each row
    gates_passed: np.ndarray   # [B] bool; False: the last rung still fails
    compression_ratio: np.ndarray | None = None  # [B] of the winning rows
    no_speech_prob: np.ndarray | None = None     # [B] when probed


def _beam_avg_logprob(sequences: np.ndarray, scores: np.ndarray, n_prefix: int, eos_id: int,
                      length_penalty: float) -> np.ndarray:
    """openai-convention average logprob of a beam row: the score is sum /
    gen ** lp with gen counting the EOS, so avg = score * gen ** lp / gen."""
    l_ = sequences.shape[-1]
    pos = np.arange(l_)
    nonfill = np.where(sequences != eos_id, pos, 0).max(axis=-1)
    # the EOS right after the last non-EOS token, or the buffer's end when
    # the budget ran out first
    gen = np.minimum(nonfill + 1, l_ - 1) - n_prefix + 1
    gen = np.maximum(gen, 1).astype(np.float64)
    return scores * np.power(gen, length_penalty) / gen


def decode_with_fallback(
    decoder,
    encoder_out: torch.Tensor,
    prefix_ids,
    temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    beam_size: int = 5,
    best_of: int = 5,
    max_len: int = 224,
    eos_id: int = 0,
    encoder_valid: torch.Tensor | None = None,
    logit_rules=None,
    length_penalty: float = 1.0,
    logprob_threshold: float | None = -1.0,
    compression_ratio_threshold: float | None = 2.4,
    text_fn=None,
    no_speech_id: int | None = None,
    sot_index: int | None = None,
    no_speech_threshold: float | None = None,
    seed: int = 0,
    draws=None,
    programs=None,
) -> FallbackResult:
    """openai ``decode_with_fallback``: beam search at t = 0
    (``renorm_after_rules=True``, so its average logprob sits on the sampled
    rungs' scale), then sampled retries at rising temperature until the
    gates pass. The rung at temperature ``t`` draws from
    ``draws.fold(int(t * 1000))`` (default ``GumbelDraws(seed)``).

    Every rung decodes the whole batch, but an example's result freezes at
    the first rung whose gates it passes. ``text_fn(token_list) -> str``
    detokenises for the compression gate; without it the gate runs on the
    token ids' bytes. ``no_speech_id`` also probes
    ``no_speech_probability`` at ``sot_index`` (default 0); with
    ``no_speech_threshold`` a probability above it accepts the current rung
    whatever the gates say (openai's silence override).

    ``programs``: a ``DecodePrograms`` (``decode/programs.py``) of which
    ``decoder`` is a prepared decoder. The beam rung, the sampled rungs and
    the probe then replay its graphs (one per prefix length, temperature
    and ``sot_index``, on the card), each over a refresh of ``decoder``;
    without it they run the eager loops over ``decoder`` as it is."""
    temperatures = tuple(temperatures)
    if not temperatures:
        raise ValueError("temperatures must be non-empty")
    draws = draws if draws is not None else GumbelDraws(seed)
    if programs is not None:
        weight_quant = programs.weight_quant_of(decoder)
        probe, beam, sample = (functools.partial(fn, weight_quant=weight_quant) for fn in
                               (programs.no_speech, programs.beam, programs.sample))
    else:  # (features, valid, prefix, ...) as the programs take them
        def probe(f, v, p, no_speech_id, **kw):
            return no_speech_probability(decoder, f, p, no_speech_id, encoder_valid=v, **kw)

        def beam(f, v, p, **kw):
            return beam_search(decoder, f, p, encoder_valid=v, **kw)

        def sample(f, v, p, **kw):
            return sample_decode(decoder, f, p, encoder_valid=v, **kw)

    n_prefix = len(list(prefix_ids))
    b = encoder_out.shape[0]
    best_seq = np.full((b, max_len), eos_id, np.int32)
    best_avg = np.full((b,), -np.inf, np.float64)
    best_temp = np.zeros((b,), np.float64)
    best_cr = np.zeros((b,), np.float64)
    frozen = np.zeros((b,), bool)

    ns_prob = None
    if no_speech_id is not None:
        ns_prob = probe(encoder_out, encoder_valid, prefix_ids, no_speech_id,
                        sot_index=0 if sot_index is None else sot_index).cpu().numpy()

    def to_text(row: np.ndarray) -> str | bytes:
        ids = [int(x) for x in row[n_prefix:]]
        while ids and ids[-1] == eos_id:
            ids.pop()
        if text_fn is not None:
            return text_fn(ids)
        return np.asarray(ids, np.int32).tobytes()

    for t in temperatures:
        if t == 0.0:
            r = beam(encoder_out, encoder_valid, prefix_ids, beam_size=beam_size,
                     max_len=max_len, eos_id=eos_id, length_penalty=length_penalty,
                     logit_rules=logit_rules, renorm_after_rules=True)
            seq = r.sequences[:, 0].cpu().numpy()
            avg = _beam_avg_logprob(seq, r.scores[:, 0].cpu().numpy(), n_prefix, eos_id,
                                    length_penalty)
        else:
            r = sample(encoder_out, encoder_valid, prefix_ids, temperature=t,
                       num_samples=best_of, max_len=max_len, eos_id=eos_id,
                       logit_rules=logit_rules, draws=draws.fold(int(t * 1000)))
            pick = torch.argmax(r.avg_logprob, dim=-1)
            rows = torch.arange(b, device=pick.device)
            seq = r.sequences[rows, pick].cpu().numpy()
            avg = r.avg_logprob[rows, pick].cpu().numpy()

        for e in range(b):
            if frozen[e]:
                continue
            best_seq[e], best_avg[e], best_temp[e] = seq[e], avg[e], t
            text = to_text(seq[e])
            best_cr[e] = compression_ratio(text)
            if not needs_fallback(avg[e], text, logprob_threshold, compression_ratio_threshold,
                                  no_speech_prob=None if ns_prob is None else float(ns_prob[e]),
                                  no_speech_threshold=no_speech_threshold):
                frozen[e] = True
        if frozen.all():
            break

    return FallbackResult(sequences=best_seq, avg_logprob=best_avg, temperature=best_temp,
                          gates_passed=frozen.copy(), compression_ratio=best_cr,
                          no_speech_prob=ns_prob)
