"""Host data pipeline: dataset IO, transforms, bucketed sampling, collate
(counterpart of ``datamodule/``)."""

from mocov2_whisper_flamingo_torch.datamodule.av_dataset import (  # noqa: F401
    AVDataset,
    DataProcessor,
)
from mocov2_whisper_flamingo_torch.datamodule.data_module import (  # noqa: F401
    DataLoader,
    DataModule,
    collate_fn,
)
from mocov2_whisper_flamingo_torch.datamodule.transforms import (  # noqa: F401
    AudioTransform,
    VideoTransform,
)
