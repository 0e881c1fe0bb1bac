"""Whisper decode-time logit rules (counterpart of ``decode/logit_rules.py``):
suppress / begin-suppress / forced tokens and the timestamp grammar, with the
semantics of ``transformers.generation.logits_process``:

- suppress: ``-1e30`` at the suppress ids, every step;
- begin-suppress: ``-1e30`` at the begin ids only when the first generated
  position is chosen (``pos == begin_index``);
- forced: at a forced position, ``-1e30`` everywhere and **0.0** at the forced
  token, so a forced step leaves the hypothesis score unchanged;
- timestamp grammar: timestamps come in pairs, never decrease, the first
  generated token is a timestamp (optionally capped), ``<|notimestamps|>`` is
  suppressed, and when the total timestamp probability beats every single
  text token the text tokens are suppressed.

``begin_index`` is a Python int. ``pos`` takes two forms. A Python int (the
loops that unroll in Python: beam, greedy, sampling) makes the position rules
plain ``if``s. A 0-d long tensor on the scores' device (the streaming chunk,
whose steps stand at a position held on the card) makes them
``torch.where``s, the reads at ``pos - 1`` and ``pos - 2`` gathers and the
generated span a mask over positions, as in the JAX rules; both forms give
the same rows. Everything that depends on the tokens is tensor arithmetic on
the ``[..., V]`` score rows with no read-back to the host. The static bias
rows are built once per rules object, device and dtype. Scores arrive already
log-softmaxed in beam search (HF normalises before its processors and never
after) and as raw logits in greedy decoding, where masking commutes with the
argmax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LogitRules:
    """Static decode-time token rules.

    Positions are absolute indices into the decoded sequence (prefix
    included), HF's ``input_ids.shape[-1]`` convention: ``begin_index`` is
    the length of the forced prefix, the position of the first freely
    generated token.
    """

    vocab_size: int
    suppress: tuple[int, ...] = ()
    begin_suppress: tuple[int, ...] = ()
    forced: tuple[tuple[int, int], ...] = ()  # (absolute position, token id)
    # Timestamp grammar (None = disabled). ``timestamp_begin`` is
    # no_timestamps_token_id + 1 in real Whisper vocabularies.
    timestamp_begin: int | None = None
    no_timestamps_id: int | None = None
    eos_id: int = 0
    max_initial_timestamp_index: int | None = 1
    detect_timestamp_from_logprob: bool = True
    # Upper bound of the text token range where the vocabulary follows the
    # real Whisper layout (text < eot < specials < timestamps); set by
    # ``for_whisper``, None for toy vocabularies.
    prompt_eot: int | None = None
    _tables: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)

    @classmethod
    def for_whisper(cls, generation_config, vocab_size: int,
                    timestamps: bool = False) -> "LogitRules":
        """Build from an HF ``GenerationConfig``-like object or a plain dict
        (a loaded ``generation_config.json``: the published Whisper
        checkpoints carry their suppress lists there)."""
        if isinstance(generation_config, dict):
            get = lambda k, d=None: generation_config.get(k, d)
        else:
            get = lambda k, d=None: getattr(generation_config, k, d)
        no_ts = get("no_timestamps_token_id")
        eos = get("eos_token_id")
        return cls(
            vocab_size=vocab_size,
            suppress=tuple(get("suppress_tokens") or ()),
            begin_suppress=tuple(get("begin_suppress_tokens") or ()),
            forced=tuple((int(p), int(t)) for p, t in (get("forced_decoder_ids") or ())),
            timestamp_begin=int(no_ts) + 1 if timestamps and no_ts is not None else None,
            no_timestamps_id=int(no_ts) if no_ts is not None else None,
            eos_id=int(eos or 0),
            max_initial_timestamp_index=get("max_initial_timestamp_index", 1),
            prompt_eot=int(eos) if eos is not None else None,
        )

    # -- static rows, once per device and dtype ---------------------------------

    def tables(self, device, dtype: torch.dtype = torch.float32) -> dict:
        """The rules' constant ``[V]`` rows on ``device``."""
        key = (torch.device(device), dtype)
        if key not in self._tables:
            self._tables[key] = self._build_tables(*key)
        return self._tables[key]

    def _build_tables(self, device: torch.device, dtype: torch.dtype) -> dict:
        v = self.vocab_size

        def bias(ids) -> np.ndarray:
            vec = np.zeros((v,), np.float32)
            vec[list(ids)] = NEG_INF
            return vec

        rows = {"suppress": bias(self.suppress), "begin_suppress": bias(self.begin_suppress)}
        for fpos, ftok in self.forced:
            row = np.full((v,), NEG_INF, np.float32)
            row[ftok] = 0.0
            rows[("forced", fpos)] = row
        out = {k: torch.from_numpy(r).to(device, dtype) for k, r in rows.items()}
        if self.timestamp_begin is not None:
            arange_v = np.arange(v)
            is_ts = arange_v >= self.timestamp_begin
            begin = (~is_ts).astype(np.float32) * np.float32(NEG_INF)
            if self.max_initial_timestamp_index is not None:
                last_allowed = self.timestamp_begin + self.max_initial_timestamp_index
                begin = begin + (arange_v > last_allowed) * np.float32(NEG_INF)
            ts_rows = {
                "no_timestamps": bias(() if self.no_timestamps_id is None
                                      else (self.no_timestamps_id,)),
                "after_pair": is_ts * np.float32(NEG_INF),
                "after_lone": (arange_v < self.eos_id) * np.float32(NEG_INF),
                "at_begin": begin,
            }
            out.update({k: torch.from_numpy(np.asarray(r, np.float32)).to(device, dtype)
                        for k, r in ts_rows.items()})
            out["is_ts"] = torch.from_numpy(is_ts).to(device)
            out["arange_v"] = torch.arange(v, device=device)
        return out

    def __call__(self, logp: torch.Tensor, tokens: torch.Tensor, pos: int | torch.Tensor,
                 begin_index: int) -> torch.Tensor:
        """Apply all rules to one step's scores.

        ``logp [..., V]`` scores; ``tokens [..., L]`` token buffer
        (positions below ``pos`` are committed); ``pos``: absolute position
        of the token being chosen, a Python int or a 0-d long tensor on the
        device; ``begin_index``: length of the forced prefix. Returns the
        scores with the rule masks applied."""
        begin_index = int(begin_index)
        on_device = isinstance(pos, torch.Tensor)
        if not on_device:
            pos = int(pos)
        t = self.tables(logp.device, logp.dtype)
        if self.suppress:
            logp = logp + t["suppress"]
        if self.begin_suppress:
            if on_device:
                logp = torch.where(pos == begin_index, logp + t["begin_suppress"], logp)
            elif pos == begin_index:
                logp = logp + t["begin_suppress"]
        for fpos, _ in self.forced:
            if on_device:
                logp = torch.where(pos == fpos, t[("forced", fpos)], logp)
            elif pos == fpos:
                logp = t[("forced", fpos)].expand_as(logp)
        if self.timestamp_begin is not None:
            rules = self._timestamp_rules_at_device_pos if on_device else self._timestamp_rules
            logp = rules(logp, tokens, pos, begin_index, t)
        return logp

    # -- timestamp grammar -----------------------------------------------------------

    def _timestamp_rules(self, logp, tokens, pos: int, begin_index: int, t: dict):
        """``WhisperTimeStampLogitsProcessor`` on whole rows."""
        ts0 = self.timestamp_begin
        is_ts, arange_v = t["is_ts"], t["arange_v"]
        if self.no_timestamps_id is not None:
            logp = logp + t["no_timestamps"]

        n_gen = pos - begin_index
        never = torch.zeros(tokens.shape[:-1], dtype=torch.bool, device=tokens.device)
        last_was_ts = tokens[..., pos - 1] >= ts0 if n_gen >= 1 else never
        penult_was_ts = tokens[..., pos - 2] >= ts0 if n_gen >= 2 else ~never
        logp = self._pair_rules(logp, last_was_ts, penult_was_ts, t)

        # Timestamps never decrease: forbid those below the most recent one
        # (+1 once its pair is complete, so it is not emitted again).
        if n_gen >= 1:
            generated = tokens[..., begin_index:pos]
            tok_is_ts = generated >= ts0
            any_ts = tok_is_ts.any(dim=-1)
            positions = torch.arange(n_gen, device=tokens.device)
            last_ts_pos = torch.where(tok_is_ts, positions, -1).amax(dim=-1)
            ts_last = generated.gather(-1, last_ts_pos.clamp(min=0)[..., None])[..., 0]
            ts_floor = torch.where(last_was_ts & ~penult_was_ts, ts_last, ts_last + 1)
            dec_mask = is_ts & (arange_v < ts_floor[..., None])
            logp = logp + torch.where(any_ts[..., None] & dec_mask, NEG_INF, 0.0).to(logp.dtype)

        if pos == begin_index:  # the first generated token is a timestamp
            logp = logp + t["at_begin"]
        return self._detect_timestamps(logp, t)

    def _timestamp_rules_at_device_pos(self, logp, tokens, pos: torch.Tensor,
                                       begin_index: int, t: dict):
        """``_timestamp_rules`` at a position held on the device (the JAX
        rules' form): the same rows, with no read-back."""
        ts0 = self.timestamp_begin
        is_ts, arange_v = t["is_ts"], t["arange_v"]
        if self.no_timestamps_id is not None:
            logp = logp + t["no_timestamps"]

        def tok_at(i):  # tokens[..., i] for a 0-d device index
            return tokens.gather(-1, i.clamp(min=0).expand(*tokens.shape[:-1], 1))[..., 0]

        n_gen = pos - begin_index
        last_was_ts = (n_gen >= 1) & (tok_at(pos - 1) >= ts0)
        penult_was_ts = (n_gen < 2) | (tok_at(pos - 2) >= ts0)
        logp = self._pair_rules(logp, last_was_ts, penult_was_ts, t)

        positions = torch.arange(tokens.shape[-1], device=tokens.device)
        tok_is_ts = (tokens >= ts0) & (positions >= begin_index) & (positions < pos)
        any_ts = tok_is_ts.any(dim=-1)
        last_ts_pos = torch.where(tok_is_ts, positions, -1).amax(dim=-1)
        ts_last = tokens.gather(-1, last_ts_pos.clamp(min=0)[..., None])[..., 0]
        ts_floor = torch.where(last_was_ts & ~penult_was_ts, ts_last, ts_last + 1)
        dec_mask = is_ts & (arange_v < ts_floor[..., None])
        logp = logp + torch.where(any_ts[..., None] & dec_mask, NEG_INF, 0.0).to(logp.dtype)

        logp = torch.where(pos == begin_index, logp + t["at_begin"], logp)
        return self._detect_timestamps(logp, t)

    @staticmethod
    def _pair_rules(logp, last_was_ts, penult_was_ts, t: dict):
        """After a completed pair the next token must be text; after a lone
        timestamp it may not be normal text."""
        zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
        pair_mask = torch.where((last_was_ts & penult_was_ts)[..., None], t["after_pair"], zero)
        lone_mask = torch.where((last_was_ts & ~penult_was_ts)[..., None], t["after_lone"], zero)
        return logp + pair_mask + lone_mask

    def _detect_timestamps(self, logp, t: dict):
        """Text suppressed where the total timestamp probability beats
        every single text token."""
        if self.detect_timestamp_from_logprob:
            is_ts = t["is_ts"]
            norm = torch.log_softmax(logp, dim=-1)
            ts_lp = torch.logsumexp(norm.masked_fill(~is_ts, -torch.inf), dim=-1)
            text_lp = norm.masked_fill(is_ts, -torch.inf).amax(dim=-1)
            force_ts = (ts_lp > text_lp)[..., None] & ~is_ts
            logp = logp.masked_fill(force_ts, NEG_INF)
        return logp
