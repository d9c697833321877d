"""Checkpoint and resume for the inverse-rendering loop
(``spath_tpu/utils/checkpoint.py``, whose orbax files become
``torch.save`` files here).

A directory holds one file per saved step, ``step_00000042.pt``. Each is
written to a temporary file and moved into place with ``os.replace``, so
a crash never leaves a half-written checkpoint under a step's name, and
only the newest ``keep`` are kept. The state saved is anything with
``state_dict()`` and ``load_state_dict(d)``, the latter returning the
restored state (``models/inverse.py::TrainState``).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    """Numbered step checkpoints under one directory."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep={keep}: keep at least one checkpoint")
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = keep

    def _path(self, step: int) -> Path:
        return self._dir / f"step_{step:08d}.pt"

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        final = self._path(step)
        tmp = final.with_name(f".{final.name}.{os.getpid()}.tmp")
        try:
            torch.save(state.state_dict(), tmp)
            os.replace(tmp, final)
        finally:
            tmp.unlink(missing_ok=True)
        for old in self.steps()[:-self._keep]:
            self._path(old).unlink(missing_ok=True)

    def restore_latest(self, template: Any):
        """The newest checkpoint loaded into ``template``; ``None`` if the
        directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return template.load_state_dict(saved)
