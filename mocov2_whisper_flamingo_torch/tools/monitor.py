#!/usr/bin/env python
"""Offline training-log analysis.

    python -m mocov2_whisper_flamingo_torch.tools.monitor \\
        --log-dir logs/avsr_logs/version_0 [--results-file preds.txt] [--out-dir monitor_out]

Counterpart of the JAX package's ``tools/monitor.py``: loads the tfevents
scalars that the port's ``utils/tb_writer.py`` writes (readable by stock
TensorBoard), plots loss / gate-weight / WER / learning-rate curves, and
analyses a ``Pred:`` / ``Target:`` predictions file (``tools/evaluate.py
--predictions-out``): length statistics, word frequencies, the worst examples
by WER (``utils/wer.py``). A host tool: ``tensorboard`` and ``matplotlib``
are imported where they are used, and no device is involved.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter


def load_scalars(log_dir: str) -> dict[str, list[tuple[int, float]]]:
    """tag -> [(step, value)] from all tfevents under log_dir."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    out = {}
    for tag in acc.Tags()["scalars"]:
        out[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out


def plot_training_curves(scalars: dict, out_dir: str) -> list[str]:
    """Loss curves, gate-weight curves, WER, learning rate: one PNG each.
    Headless (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    groups = {
        "losses.png": [t for t in scalars if t.endswith(("ctc_loss", "ce_loss", "/loss"))],
        "gates.png": [t for t in scalars if "gate" in t],
        "wer.png": [t for t in scalars if t.endswith("wer")],
        "lr.png": [t for t in scalars if t == "lr"],
    }
    for fname, tags in groups.items():
        if not tags:
            continue
        fig, ax = plt.subplots(figsize=(8, 5))
        for tag in sorted(tags):
            pts = scalars[tag]
            ax.plot([s for s, _ in pts], [v for _, v in pts], label=tag)
        ax.set_xlabel("step")
        ax.legend(fontsize=7)
        ax.set_title(fname[:-4])
        path = os.path.join(out_dir, fname)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written


def parse_results_file(path: str) -> list[dict]:
    """Parse 'Pred: .../Target: ...' prediction dumps."""
    pairs = []
    pred = None
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line.startswith("Pred:"):
                pred = line[5:].strip()
            elif line.startswith("Target:") and pred is not None:
                pairs.append({"pred": pred, "target": line[7:].strip()})
                pred = None
    return pairs


def analyze_predictions(pairs: list[dict]) -> dict:
    """Length stats, word frequencies, worst examples."""
    from mocov2_whisper_flamingo_torch.utils.wer import wer

    if not pairs:
        return {"n": 0}
    pred_lens = [len(p["pred"].split()) for p in pairs]
    tgt_lens = [len(p["target"].split()) for p in pairs]
    words = Counter(w for p in pairs for w in p["target"].split())
    scored = sorted(pairs, key=lambda p: wer(p["target"], p["pred"]), reverse=True)
    return {
        "n": len(pairs),
        "corpus_wer": wer([p["target"] for p in pairs], [p["pred"] for p in pairs]),
        "mean_pred_len": sum(pred_lens) / len(pairs),
        "mean_target_len": sum(tgt_lens) / len(pairs),
        "top_words": words.most_common(20),
        "worst_examples": scored[:5],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log-dir", required=True,
                        help="tfevents run dir (e.g. logs/avsr_logs/version_0)")
    parser.add_argument("--results-file", default=None,
                        help="optional Pred:/Target: predictions file")
    parser.add_argument("--out-dir", default="monitor_out")
    args = parser.parse_args(argv)

    scalars = load_scalars(args.log_dir)
    print(f"loaded {len(scalars)} scalar tags from {args.log_dir}")
    written = plot_training_curves(scalars, args.out_dir)
    for path in written:
        print("wrote", path)

    if args.results_file:
        report = analyze_predictions(parse_results_file(args.results_file))
        report_path = os.path.join(args.out_dir, "prediction_report.json")
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2, ensure_ascii=False, default=str)
        print("wrote", report_path)
        print(f"corpus WER: {report.get('corpus_wer')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
