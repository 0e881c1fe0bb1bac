"""The frozen MoCo ResNet-50 (``AVNet.frozen_features``, span ``frozen_video``): device ms per traced
step, from its open to its close marker (``portbench/spans.py``)."""

from portbench.spans import phase_ms


def read(record):
    return phase_ms(record, "frozen_video")
