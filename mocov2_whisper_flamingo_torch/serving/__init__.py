"""Online serving: dynamic batching and an HTTP front end over the decode
paths (counterpart of ``serving/``; the continuous-batching engine is not
ported yet)."""

from mocov2_whisper_flamingo_torch.serving.batcher import (  # noqa: F401
    DEFAULT_BUCKETS, MicroBatcher, Plan, quantize_bucket)
from mocov2_whisper_flamingo_torch.serving.engine import (  # noqa: F401
    ServeResult, ServingEngine, canonical_wav, make_audio_engine,
    make_av_engine, pad_rows, trim_at_eos)
from mocov2_whisper_flamingo_torch.serving.server import (  # noqa: F401
    TranscriptionServer)

_NOT_PORTED = ("ContinuousEngine", "make_continuous_av_engine")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"serving.{name}: the continuous-batching engine (serving/continuous.py over "
            "decode/streaming.py) is not ported yet (ROADMAP.md Queue 1 item 13)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
