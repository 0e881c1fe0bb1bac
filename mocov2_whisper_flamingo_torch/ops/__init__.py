"""Attention, video preprocessing and the hand-written kernels."""
