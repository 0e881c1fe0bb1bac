"""PyTorch/CUDA port of the audio-visual Whisper-Flamingo serving path.

Mirrors the layout of ``mocov2_whisper_flamingo_tpu`` (``models/``, ``ops/``,
``decode/``) so each module has a named counterpart, but imports nothing from
it. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel is replaced by its
plain PyTorch version.
"""

from mocov2_whisper_flamingo_torch.device import resolve_device

__all__ = ["resolve_device"]
