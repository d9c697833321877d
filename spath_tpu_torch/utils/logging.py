"""Structured metrics logging for the training loop
(``spath_tpu/utils/logging.py``): a JSONL logger, one event per line,
flushed line by line so that a killed run keeps its tail, and the
gradient-norm metric."""

from __future__ import annotations

import json
import time

import torch


class JsonlLogger:
    """Append-only JSONL metrics log; ``close`` releases the file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "t": round(time.time() - self._t0, 3)}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over a list or dict of tensors (``None`` entries skipped),
    a 0-d float32 tensor."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    squares = [t.detach().float().square().sum() for t in tensors
               if t is not None]
    return torch.sqrt(sum(squares)) if squares else torch.tensor(0.0)
