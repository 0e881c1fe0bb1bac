#!/usr/bin/env python
"""Dataset prep: scan every clip, report the global max frame count.

    python -m mocov2_whisper_flamingo_torch.tools.max_frame_count --root /data/avsr

Counterpart of the JAX package's ``tools/max_frame_count.py``: the port's
header readers (``datamodule/av_dataset.py::probe_video_frames``: npy
headers, cv2 for mp4) over a process pool, to choose ``data.max_frames``.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from mocov2_whisper_flamingo_torch.datamodule.av_dataset import (
    VIDEO_EXTENSIONS, probe_video_frames)


def find_videos(root: str) -> list[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(VIDEO_EXTENSIONS):
                out.append(os.path.join(dirpath, f))
    return out


def scan(root: str, workers: int = 8) -> dict:
    paths = find_videos(root)
    if not paths:
        return {"n_videos": 0, "max_frames": 0}
    if workers <= 1:
        counts = [probe_video_frames(p) for p in paths]
    else:
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            counts = list(pool.map(probe_video_frames, paths, chunksize=64))
    max_idx = max(range(len(counts)), key=lambda i: counts[i])
    return {
        "n_videos": len(paths),
        "max_frames": counts[max_idx],
        "max_file": paths[max_idx],
        "mean_frames": sum(counts) / len(counts),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True, help="dataset root to scan")
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)
    report = scan(args.root, args.workers)
    for k, v in report.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
