"""Audio-only Whisper ASR pipeline (counterpart of ``models/asr.py``)::

  wav -> log-mel (``ops/mel.py``) -> Whisper encoder -> KV-cached greedy or
  beam decode -> token ids

The encoder's self-attention runs the flash-attention kernel. On the card
the encode and the decode loops replay CUDA graphs (``decode/programs.py``):
``encode_program`` holds one graph per mel shape, ``decode_programs`` the
decodes, the sampled rungs and the no-speech probe over a decoder prepared
once, and ``transcribe`` keeps its streaming decoders across calls, so a
second call of a shape captures nothing and prepares nothing. Weights come
from the JAX-layout tree through ``models/convert.py::load_jax_params``, or
from an HF Whisper state dict through ``load_whisper_torch``. ``transcribe``
runs audio of any length: the long-form window loop with temperature
fallback (or the streaming decode), language detection, prompts and DTW word
times.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mocov2_whisper_flamingo_torch.decode.language import detect_language
from mocov2_whisper_flamingo_torch.decode.programs import DecodePrograms, EncodeProgram
from mocov2_whisper_flamingo_torch.device import resolve_device
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, whisper_decoder_from_torch, whisper_encoder_from_torch)
from mocov2_whisper_flamingo_torch.models.whisper import (
    WhisperConfig, WhisperDecoder, WhisperEncoder, config_for)
from mocov2_whisper_flamingo_torch.ops.mel import whisper_log_mel


class WhisperASR(nn.Module):
    """Encoder-decoder ASR with an end-to-end ``transcribe_tokens``."""

    def __init__(self, whisper_name: str = "whisper-base",
                 precision: L.Precision = L.FP32,
                 device: str | torch.device | None = "cuda",
                 config: WhisperConfig | None = None):
        """``config`` overrides the size named by ``whisper_name`` (small
        test configurations)."""
        super().__init__()
        self.device = resolve_device(device)
        self.config = config or config_for(whisper_name)
        self.precision = precision
        self.encoder = WhisperEncoder(self.config, precision, self.device)
        self.decoder = WhisperDecoder(self.config, precision, self.device)
        # The encode and the decode loops compiled (CUDA graphs on the card,
        # the eager functions on the CPU); the decoder prepared once.
        self.encode_program = EncodeProgram(lambda mel: (self.encoder(mel),), self.encoder)
        self.decode_programs = DecodePrograms(self.decoder)
        self.stream_decoders: dict = {}  # transcribe's streaming mode, by configuration

    def load_whisper_torch(self, state_dict) -> "WhisperASR":
        """Install an HF ``WhisperModel`` / ``WhisperForConditionalGeneration``
        state dict (in place)."""
        cfg = self.config
        return load_jax_params(self, {
            "encoder": whisper_encoder_from_torch(state_dict, cfg.encoder_layers),
            "decoder": whisper_decoder_from_torch(state_dict, cfg.decoder_layers)})

    def features(self, audio, pad_to: int | None = 480_000) -> torch.Tensor:
        """wav ``[T]`` or ``[B, T]`` (array or tensor) -> log-mel ``[B, 80,
        frames]`` on the model's device."""
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        mel = whisper_log_mel(audio, pad_to=pad_to)
        return mel[None] if mel.ndim == 2 else mel

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel ``[B, n_mels, frames]`` -> encoder output ``[B, frames // 2,
        D]``: on the card a replay of ``encode_program``'s graph for the
        shape (captured at its first call)."""
        (out,) = self.encode_program(mel)
        return out

    @torch.no_grad()
    def transcribe_tokens(
        self,
        audio,
        prefix_ids: Sequence[int],
        beam_size: int = 1,
        max_len: int = 224,
        eos_id: int = 50257,
        pad_to: int | None = 480_000,
        logit_rules=None,
        weight_quant: str | None = None,
    ) -> torch.Tensor:
        """wav -> token ids ``[B, max_len]`` (the best beam when ``beam_size
        > 1``). ``logit_rules``: an optional ``decode.logit_rules.LogitRules``.
        The encode and the decode replay their CUDA graphs on the card
        (``encode_program``, ``decode_programs``); the prepared decoder (fused and
        cast to the compute dtype, or with ``weight_quant="int8"`` the decode
        step's weights quantized, ``prepare_decode_params``) is made once and
        refreshed from the weights inside the program."""
        enc = self.encode(self.features(audio, pad_to=pad_to))
        if beam_size <= 1:
            return self.decode_programs.greedy(enc, None, prefix_ids, max_len, eos_id,
                                               logit_rules=logit_rules,
                                               weight_quant=weight_quant)
        res = self.decode_programs.beam(enc, None, prefix_ids, beam_size=beam_size,
                                        max_len=max_len, eos_id=eos_id, logit_rules=logit_rules,
                                        weight_quant=weight_quant)
        return res.sequences[:, 0]

    @torch.no_grad()
    def detect_language(self, audio, sot_id: int, language_token_ids: Sequence[int],
                        pad_to: int | None = 480_000,
                        decoder: WhisperDecoder | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Spoken-language id from the first 30 s: ``([B]`` best language
        token id, ``[B, n_lang]`` probabilities in the order of
        ``language_token_ids``). ``decoder``: a prepared decoder up to date
        with the weights (default: ``decode_programs``' own, refreshed)."""
        enc = self.encode(self.features(audio, pad_to=pad_to))
        if decoder is None:
            decoder = self.decode_programs.refreshed_decoder()
        return detect_language(decoder, enc, sot_id, language_token_ids)

    @torch.no_grad()
    def transcribe(
        self,
        audio,
        prefix_ids: Sequence[int],
        tokenizer=None,
        beam_size: int = 5,
        max_len: int = 448,
        eos_id: int = 50257,
        chunk_seconds: float = 30.0,
        sample_rate: int = 16_000,
        max_tokens_per_chunk: int = 64,
        temperatures: Sequence[float] | None = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        best_of: int = 5,
        length_penalty: float = 1.0,
        logprob_threshold: float | None = -1.0,
        compression_ratio_threshold: float | None = 2.4,
        no_speech_threshold: float | None = None,
        no_speech_id: int | None = None,
        sot_id: int | None = None,
        condition_on_previous_text: bool = True,
        context_tokens: int = 128,
        sot_prev_id: int | None = None,
        initial_prompt: str | None = None,
        initial_prompt_ids: Sequence[int] | None = None,
        detect_language_ids: Sequence[int] | None = None,
        language_slot: int = 1,
        logit_rules=None,
        word_times: bool = False,
        group_fn=None,
        alignment_heads: Sequence[tuple[int, int]] | None = None,
        seed: int = 0,
        draws=None,
        weight_quant: str | None = None,
    ) -> dict:
        """Transcribe audio of any length (openai ``whisper.transcribe``).

        ``temperatures`` given (the default): the quality window loop of
        ``decode/streaming.py::transcribe_long_form``, with the
        compression-ratio and avg-logprob gates, the optional no-speech skip
        (``no_speech_threshold`` + ``no_speech_id``) and
        ``condition_on_previous_text`` context prompts; sampled rungs draw
        from ``draws`` (default ``GumbelDraws(seed)``). ``None``: the
        persistent-cache streaming decode.

        ``detect_language_ids``: detect the language on the first window and
        put the best language token at ``prefix_ids[language_slot]``.
        ``initial_prompt`` (text, needs ``tokenizer``) or
        ``initial_prompt_ids``: conditioning ahead of the transcript.

        Returns ``{"tokens", "text", "segments", "words", "language",
        "language_probs"}``: ``text`` (whole and per segment) when a
        ``tokenizer`` is given; ``words`` (``decode.timestamps.WordTiming``)
        when ``word_times`` with a ``group_fn``, aligned per window by DTW
        and offset by the window's origin. The decoder is ``decode_programs``'
        prepared decoder for ``weight_quant`` (made once, refreshed once a
        call) and serves the decode, the no-speech probe and the alignment
        forward; the window encodes replay ``encode_program``, the rungs and
        the probe ``decode_programs``' graphs, and streaming mode a
        ``StreamingDecoder`` kept per configuration (``stream_decoders``)."""
        from mocov2_whisper_flamingo_torch.decode.streaming import transcribe_long_form

        decoder = self.decode_programs.refreshed_decoder(weight_quant)
        text_fn = (lambda ids: tokenizer.decode(ids)) if tokenizer else None
        prefix_ids = [int(t) for t in prefix_ids]
        language = language_probs = None
        chunk_samples = int(chunk_seconds * sample_rate)
        if detect_language_ids is not None:
            best, probs = self.detect_language(
                audio[..., :chunk_samples], prefix_ids[0], list(detect_language_ids),
                pad_to=chunk_samples, decoder=decoder)
            language = int(best[0])
            language_probs = {int(t): float(p) for t, p in
                              zip(detect_language_ids, probs[0].tolist())}
            prefix_ids[language_slot] = language
        if initial_prompt is not None:
            if initial_prompt_ids is not None:
                raise ValueError("pass initial_prompt OR initial_prompt_ids, not both")
            if tokenizer is None:
                raise ValueError("initial_prompt (text) needs a tokenizer")
            initial_prompt_ids = tokenizer.encode(" " + initial_prompt.strip(),
                                                  add_special_tokens=False)
        tokens, segments = transcribe_long_form(
            self.encode, decoder, audio, prefix_ids, eos_id=eos_id,
            chunk_seconds=chunk_seconds, sample_rate=sample_rate, max_len=max_len,
            max_tokens_per_chunk=max_tokens_per_chunk, beam_size=beam_size,
            length_penalty=length_penalty, logit_rules=logit_rules,
            context_tokens=context_tokens if condition_on_previous_text else 0,
            sot_prev_id=sot_prev_id, initial_prompt_ids=initial_prompt_ids,
            temperatures=temperatures, best_of=best_of, logprob_threshold=logprob_threshold,
            compression_ratio_threshold=compression_ratio_threshold,
            no_speech_threshold=no_speech_threshold, no_speech_id=no_speech_id, sot_id=sot_id,
            text_fn=text_fn, seed=seed, draws=draws, return_segments=True,
            programs=self.decode_programs, stream_decoders=self.stream_decoders)
        if text_fn:
            for seg in segments:
                seg["text"] = text_fn(seg["tokens"])
        out = {"tokens": tokens, "text": text_fn(tokens) if text_fn else None,
               "segments": segments, "words": None, "language": language,
               "language_probs": language_probs}
        if word_times:
            if group_fn is None:
                raise ValueError("word_times needs a tokenizer-aware group_fn")
            out["words"] = self._word_times(
                decoder, audio, segments, prefix_ids, group_fn, chunk_seconds=chunk_seconds,
                sample_rate=sample_rate, eos_id=eos_id, alignment_heads=alignment_heads,
                timestamp_begin=getattr(logit_rules, "timestamp_begin", None)
                if logit_rules is not None else None)
        return out

    def _word_times(self, decoder, audio, segments, prefix, group_fn, chunk_seconds,
                    sample_rate, eos_id, alignment_heads=None, timestamp_begin=None):
        """One DTW alignment per decode window (openai
        ``add_word_timestamps``): the window's text tokens, gathered from its
        segments by their ``seek`` origin, are scored teacher-forced against
        that window's encoder output, and the times are offset by the
        origin. The forward runs at a power-of-two token length (at least 32,
        at most the decoder's positions); its pad rows are cropped before the
        statistics."""
        from mocov2_whisper_flamingo_torch.decode.timestamps import word_timestamps

        chunk_samples = int(chunk_seconds * sample_rate)
        windows: dict[float, list[int]] = {}
        for seg in segments:
            toks = seg["tokens"]
            if timestamp_begin is not None:
                toks = [t for t in toks if t < timestamp_begin]
            # segments without a seek key: the window origin is the floor
            # multiple of the window length
            start_s = seg.get("seek", int(seg["start"] // chunk_seconds) * chunk_seconds)
            windows.setdefault(start_s, []).extend(toks)
        words = []
        max_pos = self.config.max_target_positions
        for start_s, window in windows.items():
            if not window:
                continue
            s0 = int(round(start_s * sample_rate))
            chunk = audio[..., s0:s0 + chunk_samples]
            enc = self.encode(self.features(chunk, pad_to=chunk_samples))
            n_frames = min(max(chunk.shape[-1] // 320, 1), enc.shape[1])
            seq = prefix + window + [eos_id]
            if len(seq) > max_pos:
                # no room for the EOS row in the position table; trailing
                # rows are off the DTW path anyway
                seq = seq[:max_pos]
            n_text = min(len(window), len(seq) - len(prefix))
            pad_len = min(max_pos, 1 << max(5, (len(seq) - 1).bit_length()))
            ws = word_timestamps(decoder, seq, enc, group_fn, n_prefix=len(prefix),
                                 n_text=n_text, n_frames=n_frames,
                                 alignment_heads=alignment_heads, pad_tokens_to=pad_len,
                                 pad_id=eos_id)
            for w in ws:
                w.start += start_s
                w.end += start_s
            words.extend(ws)
        return words
