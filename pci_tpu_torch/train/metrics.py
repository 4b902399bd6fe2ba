"""Experiment tracking (counterpart of ``pci_tpu/train/metrics.py``): one
JSON record a line in ``<log_dir>/metrics.jsonl``, and its export to a
wandb-style CSV.  The port logs JSONL only: ``use_wandb`` is accepted for
the CLIs' flag and says so."""

from __future__ import annotations

import csv
import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        if use_wandb:
            print("[metrics] wandb is not ported; JSONL only")

    def log(self, metrics: dict, step: int | None = None):
        rec = {"time": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def metrics_to_csv(jsonl_path: str, csv_path: str | None = None) -> str:
    """Export a metrics.jsonl to a CSV with one column per metric key (the
    union over all records; empty cells where a record lacks a key).
    Returns the path written."""
    records = []
    keys: list[str] = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            records.append(rec)
            for k in rec:
                if k not in keys:
                    keys.append(k)
    csv_path = csv_path or os.path.splitext(jsonl_path)[0] + ".csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, restval="")
        w.writeheader()
        w.writerows(records)
    return csv_path
