"""KV-cached beam search with hypothesis banking (counterpart of
``decode/beam.py``), with the HF ``GenerationMixin`` semantics of the JAX
package:

- each step expands the K live beams to the top **2K** candidates;
- a candidate whose new token is EOS is **banked** into a K-slot pool (only
  candidates ranked below K may bank), scored by
  ``sum_logprob / gen_len ** length_penalty`` with gen_len counting the EOS;
- the K best unfinished candidates continue; finished ones hold no live slot;
- at the last step every live candidate is force-banked;
- ``early_stopping=True`` freezes the pool once it holds K hypotheses;
  ``False`` stops banking once the best live score can no longer beat the
  worst pooled one (HF's heuristic).

The self caches are reordered physically after each step (one
``index_select`` over the stacked cache, and over its scales when it is int8)
where the JAX package folds a one-hot ancestry tensor into the attention; the
cross K/V stays B-major and is never reordered. With an int8 self cache the
prefix steps dequantize it in the compute dtype and the loop steps fold its
scales into the attention, the two reads the JAX package's search makes.
Ties between equal scores are broken towards the lower index, as
``lax.top_k`` does.

``BeamLoop`` holds one search's state and its step, in two forms:
``beam_search`` loops over it in Python with an int step index (what the
decode graphs of ``decode/programs.py`` capture), and
``tools/export_model.py::BeamProgram`` runs two ``while_loop`` calls with
the index a device tensor, one over the prefix's teacher-forced step and
one over the search step, the counterparts of the JAX beam's two
``lax.scan`` calls.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30


@dataclasses.dataclass
class BeamResult:
    sequences: torch.Tensor  # [B, K, L] token ids, best hypothesis first
    scores: torch.Tensor     # [B, K] length-normalized log probs


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, N, L]`` rows picked by ``idx [B, M]`` -> ``[B, M, L]``."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def reorder_into(bufs: tuple, spares: tuple, rows: torch.Tensor,
                 dim: int = 1) -> tuple[tuple, tuple]:
    """Each buffer's entries along ``dim`` picked by ``rows``, written into
    its spare (``index_select(out=)``): returns ``(the reordered buffers,
    the old ones as the next spares)``. Two fixed buffers that alternate,
    where a fresh ``index_select`` would allocate each time."""
    for src, dst in zip(bufs, spares):
        torch.index_select(src, dim, rows, out=dst)
    return spares, bufs


def prefix_tensor(prefix_ids, device) -> torch.Tensor:
    """The forced prefix as a long tensor on ``device``: a long tensor
    already there is taken as it is (no host copy, so a CUDA graph can
    capture the loop), a sequence of ints is copied up."""
    if isinstance(prefix_ids, torch.Tensor):
        return prefix_ids.to(device=device, dtype=torch.long)
    return torch.as_tensor(list(prefix_ids), dtype=torch.long, device=device)


def _length_denominators(max_len: int, length_penalty: float, device) -> list[torch.Tensor]:
    """``gen_len ** length_penalty`` for ``gen_len`` in ``range(max_len)`` as
    0-d fp32 tensors on ``device``, made from one ``arange`` so that no step
    of the search copies a host scalar to the card (the exponent is a
    filled 0-d tensor, not a copy, so a CUDA graph can capture it). Each
    entry is the 0-d power a step would take by itself (a vector power
    rounds some entries differently)."""
    lp = torch.full((), float(length_penalty), dtype=torch.float32, device=device)
    gen_lens = torch.arange(max_len, dtype=torch.float32, device=device)
    return [gen_lens[g] ** lp for g in range(max_len)]


class BeamLoop:
    """One beam search: its constants, its carried state and its step.

    The constructor allocates the caches and the state and teacher-forces
    the prefix (``n_prefix - 1`` steps, beams identical). ``state`` is then
    the carried state, a flat tuple: ``(run_tokens [B, K, L], run_scores
    [B, K], pool_tokens [B, K, L], pool_scores [B, K], heur_ok [B])``
    followed by the self caches (``self_k``, ``self_v`` and, with an int8
    cache, their scales), stacked over layers. ``step(state, i)`` returns
    the state after step ``i``, for ``i`` in ``n_prefix - 1 .. max_len - 2``;
    the cross caches and the encoder mask are loop constants.

    The loop takes its index in one of two forms, fixed per loop:

    - a Python int (``device_steps=False``): ``beam_search``'s loop, which
      the decode graphs of ``decode/programs.py`` capture. The prefix is a
      Python loop of decode steps. Each step reads the keys ``0 .. i`` and
      writes its K/V into the self caches in place.
    - a 0-d long tensor on the device (``device_steps=True``): the loops
      that ``tools/export_model.py::BeamProgram`` exports, as the JAX beam
      is two ``lax.scan`` calls. The prefix is one ``while_loop`` over
      ``prefix_step`` (none for a one-token prefix, as in JAX), and ``step``
      is the body of the search's. Both bodies' decode steps read the whole
      window under the ``<= position`` mask, as the JAX scans' steps do: a
      traced body has one shape at every ``i``, while the keys ``0 .. i``
      grow with it, and the masked keys weigh exactly 0. They write their
      K/V out of place, so no carried tensor is mutated. In the search body
      the current token is a gather at ``i``, the new token an out-of-place
      scatter and the length denominator an index into one stacked table of
      the same 0-d powers. The device form takes no logit rules and no
      cache quant.
    """

    def __init__(self, decoder, encoder_out: torch.Tensor, prefix_ids, *, beam_size: int,
                 max_len: int, eos_id: int, length_penalty: float = 1.0,
                 encoder_valid: torch.Tensor | None = None, early_stopping: bool = False,
                 logit_rules=None, renorm_after_rules: bool = False,
                 cache_quant: str | None = None, device_steps: bool = False):
        if device_steps and (logit_rules is not None or cache_quant is not None):
            raise ValueError("a beam loop with device steps takes no logit rules and no "
                             "cache quant")
        dev = encoder_out.device
        b, k = encoder_out.shape[0], beam_size
        self.decoder, self.encoder_valid = decoder, encoder_valid
        self.b, self.k, self.max_len, self.eos_id = b, k, max_len, eos_id
        self.early_stopping, self.logit_rules = early_stopping, logit_rules
        self.renorm_after_rules, self.device_steps = renorm_after_rules, device_steps
        prefix = prefix_tensor(prefix_ids, dev)
        self.n_prefix = n_prefix = int(prefix.shape[0])
        self.denoms = _length_denominators(max_len, length_penalty, dev)

        cache = decoder.init_cache(encoder_out, max_len=max_len, beam_groups=k,
                                   quant=cache_quant)
        self.self_names = [n for n in ("self_k", "self_v", "self_k_scale", "self_v_scale")
                           if n in cache]
        run_tokens = torch.full((b, k, max_len), eos_id, dtype=torch.long, device=dev)
        run_tokens[:, :, :n_prefix] = prefix
        run_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        run_scores[:, 0] = 0.0
        pool_tokens = torch.full((b, k, max_len), eos_id, dtype=torch.long, device=dev)
        pool_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        heur_ok = torch.ones((b,), dtype=torch.bool, device=dev)
        self.can_bank = (torch.arange(2 * k, device=dev) < k)[None, :]
        self.row_base = torch.arange(b, device=dev)[:, None] * k
        self.prefix = prefix
        self.cross = {n: v for n, v in cache.items() if n not in self.self_names}
        selfs = tuple(cache[n] for n in self.self_names)
        # Teacher-force the prefix (beams identical).
        if device_steps:
            self.denom_table = torch.stack(self.denoms)
            selfs = self._prefix_loop(selfs)
        else:
            for i in range(n_prefix - 1):
                decoder.decode_step(prefix[i].expand(b * k, 1), cache, i, encoder_valid)
        self.state = (run_tokens, run_scores, pool_tokens, pool_scores, heur_ok, *selfs)

    def prefix_step(self, selfs: tuple, i: torch.Tensor) -> tuple:
        """The self caches after teacher-forcing prefix token ``i`` (a 0-d
        long tensor on the device; device form only), all beams alike: the
        body of the prefix's ``while_loop``. Like ``step``'s device form it
        reads the whole window under the ``<= position`` mask and returns
        written copies."""
        if not self.device_steps:
            raise TypeError("only a beam loop with device steps runs its prefix by steps")
        cache = dict(self.cross, **dict(zip(self.self_names, selfs)))
        rows = self.b * self.k
        cur = self.prefix.index_select(0, i.reshape(1)).expand(rows, 1)
        _, cache = self.decoder.decode_step(cur, cache, self.max_len - 1, self.encoder_valid,
                                            positions=i.expand(rows), in_place=False)
        return tuple(cache[n] for n in self.self_names)

    def _prefix_loop(self, selfs: tuple) -> tuple:
        """The self caches after the whole prefix, in the device form: one
        ``while_loop`` over ``prefix_step`` from ``i = 0``, the counterpart of
        the JAX prefix's ``lax.scan``. As there, a one-token prefix has no
        loop."""
        from torch._higher_order_ops import while_loop

        if self.n_prefix == 1:
            return selfs
        last = self.n_prefix - 1
        start = torch.zeros((), dtype=torch.long, device=self.prefix.device)
        _, *selfs = while_loop(lambda i, *_: i < last,
                               lambda i, *selfs: (i + 1, *self.prefix_step(selfs, i)),
                               (start, *selfs))
        return tuple(selfs)

    def step(self, state: tuple, i) -> tuple:
        """The state after step ``i`` (a Python int or a 0-d long tensor on
        the device, as the loop was made)."""
        if isinstance(i, torch.Tensor) != self.device_steps:
            raise TypeError(f"this beam loop takes its step index as "
                            f"{'a 0-d tensor' if self.device_steps else 'an int'}")
        run_tokens, run_scores, pool_tokens, pool_scores, heur_ok, *selfs = state
        b, k, max_len, n_prefix = self.b, self.k, self.max_len, self.n_prefix
        k2 = 2 * k
        cache = dict(self.cross, **dict(zip(self.self_names, selfs)))
        flat_tokens = run_tokens.reshape(b * k, max_len)
        if self.device_steps:
            cur = flat_tokens.gather(1, i.expand(b * k, 1))
            logits, cache = self.decoder.decode_step(
                cur, cache, max_len - 1, self.encoder_valid, positions=i.expand(b * k),
                fold_scales=True, in_place=False)
        else:
            cur = flat_tokens[:, i:i + 1]
            logits, cache = self.decoder.decode_step(cur, cache, i, self.encoder_valid,
                                                     fold_scales=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if self.logit_rules is not None:
            logp = self.logit_rules(logp, flat_tokens, i + 1, n_prefix)
            if self.renorm_after_rules:
                logp = torch.log_softmax(logp, dim=-1)
        # Per-beam top-2K, then top-2K of the K*2K union: exact, since every
        # global top-2K candidate is inside its own beam's top-2K.
        s1, t1 = torch.topk(logp, k2, dim=-1)
        total1 = run_scores[..., None] + s1.reshape(b, k, k2)
        s2k, flat = _top_k(total1.reshape(b, k * k2), k2)
        beam2k = flat // k2
        tok2k = t1.reshape(b, k * k2).gather(1, flat)
        hits = (tok2k == self.eos_id) | (i + 2 >= max_len)

        cand_tokens = _take_rows(run_tokens, beam2k)
        # Generated length after this step: the loop starts at n_prefix - 1,
        # so the index runs over 1 .. max_len - n_prefix and is never negative.
        if self.device_steps:
            cand_tokens = cand_tokens.scatter(2, (i + 1).expand(b, k2, 1), tok2k[..., None])
            denom = self.denom_table.gather(0, (i + 2 - n_prefix).reshape(1))[0]
        else:
            cand_tokens[:, :, i + 1] = tok2k
            denom = self.denoms[i + 2 - n_prefix]

        # ---- bank finished candidates into the hypothesis pool ----
        bank_ok = hits & self.can_bank & heur_ok[:, None]
        if self.early_stopping:
            pool_full = (pool_scores > NEG_INF / 2).all(dim=-1)
            bank_ok &= ~pool_full[:, None]
        bank = torch.where(bank_ok, s2k / denom, NEG_INF)
        pool_scores, pool_idx = _top_k(torch.cat([pool_scores, bank], dim=1), k)
        pool_tokens = _take_rows(torch.cat([pool_tokens, cand_tokens], dim=1), pool_idx)

        # ---- the K best unfinished candidates continue ----
        run_scores, sel = _top_k(s2k + hits * NEG_INF, k)
        sel_beam = beam2k.gather(1, sel)
        run_tokens = _take_rows(cand_tokens, sel)
        rows = (self.row_base + sel_beam).reshape(-1)
        selfs = [cache[name].index_select(1, rows) for name in self.self_names]

        # ---- early-stop heuristic (the pool can no longer improve) ----
        best_possible = run_scores[:, 0] / denom
        pool_done = (pool_scores > NEG_INF / 2).all(dim=-1)
        worst = pool_scores.min(dim=-1).values
        heur_ok = heur_ok & (~pool_done | (best_possible > worst))
        if self.device_steps:  # a while_loop's body returns its carries' strides
            run_scores, pool_scores = (x.clone(memory_format=torch.contiguous_format)
                                       for x in (run_scores, pool_scores))
        return (run_tokens, run_scores, pool_tokens, pool_scores, heur_ok, *selfs)


@torch.no_grad()
def beam_search(
    decoder,
    encoder_out: torch.Tensor,
    prefix_ids,
    beam_size: int = 5,
    max_len: int = 224,
    eos_id: int = 0,
    length_penalty: float = 1.0,
    encoder_valid: torch.Tensor | None = None,
    early_stopping: bool = False,
    logit_rules=None,
    renorm_after_rules: bool = False,
    cache_quant: str | None = None,
    read_windows=None,
    cache_layout: str = "rows",
) -> BeamResult:
    """Batched beam search; returns the K best finished hypotheses per
    example, best first, EOS-filled past each end. A Python loop over
    ``BeamLoop.step`` with an int index; ``tools/export_model.py`` exports
    the same step as the body of a ``while_loop``.

    ``decoder`` is a prepared ``WhisperDecoder``
    (``prepare_decode_params``). ``prefix_ids``: ints, or a long tensor on
    the encoder output's device. ``read_windows`` and ``cache_layout`` are
    accepted for API compatibility and ignored: in the JAX package they
    choose how the TPU reads and lays out the self cache and leave the
    results unchanged, and this search always reads exactly the live prefix
    of a row-aligned cache.

    ``logit_rules``: an optional ``decode.logit_rules.LogitRules``, applied
    to the log-softmaxed scores of each step where HF's logits processors
    run in its beam loop. HF never renormalises after them, so accumulated
    scores are deflated wherever a rule masked probability mass;
    ``renorm_after_rules=True`` takes the log-softmax again after the rules
    (openai's convention), which makes the scores true log probabilities
    over the allowed set and can change the ranking across beams.
    ``cache_quant``: ``"int8"`` or ``"int8-cross"`` (``init_cache``).
    """
    if cache_layout not in ("rows", "bhjtd"):
        raise ValueError(f"unknown cache_layout {cache_layout!r}; expected 'rows' or 'bhjtd'")
    del read_windows
    loop = BeamLoop(decoder, encoder_out, prefix_ids, beam_size=beam_size, max_len=max_len,
                    eos_id=eos_id, length_penalty=length_penalty, encoder_valid=encoder_valid,
                    early_stopping=early_stopping, logit_rules=logit_rules,
                    renorm_after_rules=renorm_after_rules, cache_quant=cache_quant)
    state = loop.state
    for i in range(loop.n_prefix - 1, max_len - 1):
        state = loop.step(state, i)
    return BeamResult(sequences=state[2], scores=state[3])
