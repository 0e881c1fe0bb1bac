"""Helpers of the tests that hold the port's long-form decoding against the
JAX package's.

``JaxDraws`` is a draw source for the port's sampler backed by JAX's
generator. The JAX sampler draws ``jax.random.categorical(fold_in(key, i),
logp / t)``, which is ``argmax(jax.random.gumbel(fold_in(key, i)) + logp /
t)``. Fed this source along the same fold chain, the port adds the same
noise."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


class JaxDraws:
    """``fold`` is ``jax.random.fold_in``; ``gumbel`` is
    ``jax.random.gumbel`` (float32), moved to the requested device."""

    def __init__(self, key):
        self.key = key

    def fold(self, n):
        return JaxDraws(jax.random.fold_in(self.key, n))

    def gumbel(self, shape, device):
        noise = np.array(jax.random.gumbel(self.key, tuple(shape), jnp.float32))
        return torch.from_numpy(noise).to(device)


def lively(tree: dict, rng) -> None:
    """Position embeddings larger than the token embeddings keep a random
    decoder (a JAX-layout tree) from copying its input token: it emits varied
    tokens and EOS."""
    tree["pos_embed"] = 4.0 * rng.standard_normal(tree["pos_embed"].shape).astype(np.float32)
    tree["embed_tokens"]["embedding"] *= np.float32(0.5)


def window_mel(wav, n_frames: int) -> np.ndarray:
    """A stand-in log-mel that either framework can call: 80 x ``n_frames``
    values from the window's samples (np.asarray reads a JAX array and a CPU
    tensor alike)."""
    w = np.asarray(wav, np.float32)
    n = min(w.shape[-1] // 160, n_frames)
    m = np.zeros((80, n_frames), np.float32)
    m[:, :n] = np.resize(w[: 80 * n], (80, n))
    return m
