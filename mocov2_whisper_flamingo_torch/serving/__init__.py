"""Online serving: dynamic batching, continuous batching and an HTTP front
end over the decode paths (counterpart of ``serving/``)."""

from mocov2_whisper_flamingo_torch.serving.batcher import (  # noqa: F401
    DEFAULT_BUCKETS, MicroBatcher, Plan, quantize_bucket)
from mocov2_whisper_flamingo_torch.serving.continuous import (  # noqa: F401
    ContinuousEngine, make_continuous_av_engine)
from mocov2_whisper_flamingo_torch.serving.engine import (  # noqa: F401
    ServeResult, ServingEngine, canonical_wav, make_audio_engine,
    make_av_engine, pad_rows, trim_at_eos)
from mocov2_whisper_flamingo_torch.serving.server import (  # noqa: F401
    TranscriptionServer)
