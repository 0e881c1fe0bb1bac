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
    example, best first, EOS-filled past each end.

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
    dev = encoder_out.device
    b, k = encoder_out.shape[0], beam_size
    k2 = 2 * k
    prefix = prefix_tensor(prefix_ids, dev)
    n_prefix = int(prefix.shape[0])
    denoms = _length_denominators(max_len, length_penalty, dev)

    cache = decoder.init_cache(encoder_out, max_len=max_len, beam_groups=k, quant=cache_quant)
    self_names = [n for n in ("self_k", "self_v", "self_k_scale", "self_v_scale") if n in cache]
    run_tokens = torch.full((b, k, max_len), eos_id, dtype=torch.long, device=dev)
    run_tokens[:, :, :n_prefix] = prefix
    run_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    run_scores[:, 0] = 0.0
    pool_tokens = torch.full((b, k, max_len), eos_id, dtype=torch.long, device=dev)
    pool_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    heur_ok = torch.ones((b,), dtype=torch.bool, device=dev)
    can_bank = (torch.arange(k2, device=dev) < k)[None, :]
    row_base = torch.arange(b, device=dev)[:, None] * k

    for i in range(n_prefix - 1):  # teacher-force the prefix (beams identical)
        decoder.decode_step(prefix[i].expand(b * k, 1), cache, i, encoder_valid)

    for i in range(n_prefix - 1, max_len - 1):
        cur = run_tokens.reshape(b * k, max_len)[:, i:i + 1]
        logits, cache = decoder.decode_step(cur, cache, i, encoder_valid, fold_scales=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if logit_rules is not None:
            logp = logit_rules(logp, run_tokens.reshape(b * k, max_len), i + 1, n_prefix)
            if renorm_after_rules:
                logp = torch.log_softmax(logp, dim=-1)
        # Per-beam top-2K, then top-2K of the K*2K union: exact, since every
        # global top-2K candidate is inside its own beam's top-2K.
        s1, t1 = torch.topk(logp, k2, dim=-1)
        total1 = run_scores[..., None] + s1.reshape(b, k, k2)
        s2k, flat = _top_k(total1.reshape(b, k * k2), k2)
        beam2k = flat // k2
        tok2k = t1.reshape(b, k * k2).gather(1, flat)
        hits = (tok2k == eos_id) | (i + 2 >= max_len)

        cand_tokens = _take_rows(run_tokens, beam2k)
        cand_tokens[:, :, i + 1] = tok2k

        # ---- bank finished candidates into the hypothesis pool ----
        # Generated length after this step: the loop starts at n_prefix - 1,
        # so the index runs over 1 .. max_len - n_prefix and is never negative.
        denom = denoms[i + 2 - n_prefix]
        bank_ok = hits & can_bank & heur_ok[:, None]
        if early_stopping:
            pool_full = (pool_scores > NEG_INF / 2).all(dim=-1)
            bank_ok &= ~pool_full[:, None]
        bank = torch.where(bank_ok, s2k / denom, NEG_INF)
        pool_scores, pool_idx = _top_k(torch.cat([pool_scores, bank], dim=1), k)
        pool_tokens = _take_rows(torch.cat([pool_tokens, cand_tokens], dim=1), pool_idx)

        # ---- the K best unfinished candidates continue ----
        run_scores, sel = _top_k(s2k + hits * NEG_INF, k)
        sel_beam = beam2k.gather(1, sel)
        run_tokens = _take_rows(cand_tokens, sel)
        rows = (row_base + sel_beam).reshape(-1)
        for name in self_names:
            cache[name] = cache[name].index_select(1, rows)

        # ---- early-stop heuristic (the pool can no longer improve) ----
        best_possible = run_scores[:, 0] / denom
        pool_done = (pool_scores > NEG_INF / 2).all(dim=-1)
        worst = pool_scores.min(dim=-1).values
        heur_ok = heur_ok & (~pool_done | (best_possible > worst))

    return BeamResult(sequences=pool_tokens, scores=pool_scores)
