"""Autoregressive decoding: greedy and beam search."""
