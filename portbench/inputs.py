"""Inputs made from the seed on the device: 30 s log-mel clips, raw uint8
lip frames and target transcripts. The same seed gives the same inputs;
what every seed shares is fixed: the multiset of target lengths (put in
the run's order) and the arrival schedule (drawn from the traffic file's
own seed).
"""

from __future__ import annotations

import torch

INPUT_STREAM = 0x1F2E3D4C  # the inputs' generator: seed + this (the weights' is the seed)


def generator(seed: int, device, stream: int = INPUT_STREAM) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + stream) % (1 << 63))
    return gen


def clips(gen: torch.Generator, n: int, mel_frames: int, n_mels: int, frames: int,
          raw_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` clips: log-mel ``[n, mel_frames, n_mels]`` fp32 (standard
    normal scaled by 0.5, the range of Whisper's normalised log-mel) and
    raw frames ``[n, frames, 3, raw_size, raw_size]`` uint8."""
    mel = torch.randn((n, mel_frames, n_mels), generator=gen, device=device) * 0.5
    raw = torch.randint(0, 256, (n, frames, 3, raw_size, raw_size), generator=gen,
                        device=device, dtype=torch.uint8)
    return mel, raw


def repeated_labels(ids: torch.Tensor) -> torch.Tensor:
    """``ids [B, L]`` with every fourth label repeated next to itself and
    again two places on, as transcripts repeat tokens (the CTC lattice's
    skip rule then matters)."""
    ids = ids.clone()
    n1, n3 = ids[:, 1::4].shape[1], ids[:, 3::4].shape[1]
    ids[:, 1::4] = ids[:, 0::4][:, :n1]
    ids[:, 3::4] = ids[:, 0::4][:, :n3]
    return ids


def target_lengths(count: int, low: int, high: int, gen: torch.Generator) -> torch.Tensor:
    """``count`` target lengths spread evenly over ``[low, high]``, in the
    generator's order: every seed trains on the same lengths."""
    lengths = torch.linspace(low, high, count).round().long()
    return lengths[torch.randperm(count, generator=gen, device=gen.device).cpu()]


def targets(gen: torch.Generator, lengths: torch.Tensor, pad_to: int, vocab: int,
            device) -> torch.Tensor:
    """Token ids in ``[1, vocab)`` with repeats, zero past each length."""
    ids = torch.randint(1, vocab, (len(lengths), pad_to), generator=gen, device=device)
    ids = repeated_labels(ids)
    keep = torch.arange(pad_to, device=device)[None, :] < lengths.to(device)[:, None]
    return torch.where(keep, ids, torch.zeros_like(ids))


def arrival_gaps(count: int, seconds: float, traffic_seed: int) -> list[float]:
    """The gaps before each of ``count`` arrivals of a Poisson process
    conditioned on ``count`` arrivals in ``seconds`` (sorted uniform
    points), drawn from the traffic's own seed: every run has the same
    schedule, and its seed changes which clip each arrival brings (how many
    requests an open window finishes depends on when its last ones come, so
    a schedule that moved with the seed would move the rate)."""
    g = torch.Generator().manual_seed(int(traffic_seed))
    points = torch.sort(torch.rand(count, generator=g, dtype=torch.float64)).values * seconds
    return torch.diff(points, prepend=torch.zeros(1, dtype=torch.float64)).tolist()
