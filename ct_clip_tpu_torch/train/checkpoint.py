"""Checkpoints of the whole train state with torch.save.

Port of ct_clip_tpu/train/checkpoint.py::CheckpointManager (:18-54): one
file per saved step, `step_{n}.pt`, holding the model in the reference
state-dict layout (the VQ buffers included), the optimizer state and the
step; at most `max_to_keep` are kept, and `restore` loads the latest (or a
given) step.  Orbax's sharded and asynchronous writes are not ported.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> Path:
        path = self.directory / f"step_{step}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(), "step": step}, tmp)
        tmp.replace(path)
        for old in self.steps()[:-self.max_to_keep]:
            (self.directory / f"step_{old}.pt").unlink()
        return path

    def restore(self, state, step: Optional[int] = None):
        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = state.model.temperature.device
        sd = torch.load(self.directory / f"step_{step}.pt", map_location=device,
                        weights_only=True)
        state.model.load_state_dict(sd["model"], strict=True)
        state.optimizer.load_state_dict(sd["optimizer"])
        state.step = int(sd["step"])
        return state
