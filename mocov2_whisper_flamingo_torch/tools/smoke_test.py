#!/usr/bin/env python
"""Dataloader smoke test: build the DataModule, iterate a few train batches,
print keys and timing.

    python -m mocov2_whisper_flamingo_torch.tools.smoke_test \\
        --set data.root_dir=/data/avsr [--num-batches 3]

Counterpart of the JAX package's ``tools/smoke_test.py``, over the port's
``datamodule.DataModule``: the loader's host batches, no device involved.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    from mocov2_whisper_flamingo_torch.config import add_config_flags, config_from_args

    add_config_flags(parser)
    parser.add_argument("--num-batches", type=int, default=3)
    args = parser.parse_args(argv)
    config = config_from_args(args)

    from mocov2_whisper_flamingo_torch.datamodule.data_module import DataModule

    dm = DataModule(config)
    dm.setup("fit")
    loader = dm.train_dataloader()
    print(f"train batches: {len(loader)}")
    t0 = time.time()
    for i, batch in enumerate(loader):
        if i >= args.num_batches:
            break
        shapes = {k: getattr(v, "shape", len(v) if v is not None else None)
                  for k, v in batch.items()}
        print(f"batch {i} ({time.time() - t0:.2f}s): {shapes}")
        t0 = time.time()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
