"""Autoregressive decoding: greedy and beam search (and both as CUDA graphs,
``programs.DecodePrograms``), chunked streaming with a persistent cache,
temperature sampling with the quality-gated fallback, timestamp segments, DTW
word times and language detection."""

from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode  # noqa: F401
from mocov2_whisper_flamingo_torch.decode.beam import beam_search  # noqa: F401
from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules  # noqa: F401
from mocov2_whisper_flamingo_torch.decode.programs import DecodePrograms  # noqa: F401
from mocov2_whisper_flamingo_torch.decode.streaming import (  # noqa: F401
    StreamingDecoder, transcribe_long_form)
from mocov2_whisper_flamingo_torch.decode.sampling import (  # noqa: F401
    GumbelDraws, compression_ratio, decode_with_fallback, needs_fallback,
    no_speech_probability, sample_decode)
from mocov2_whisper_flamingo_torch.decode.timestamps import (  # noqa: F401
    WordTiming, token_timestamps, word_timestamps)
from mocov2_whisper_flamingo_torch.decode.language import detect_language  # noqa: F401
