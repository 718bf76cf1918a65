"""Checkpoint lifecycle (``ptlflow_tpu/utils/checkpoint_manager.py``): last
and top-k saving, the HPC auto-resume scan and the resume priority, with
``.ckpt`` files in the reference Lightning layout
(``{"state_dict", "hyper_parameters"}``) that ``utils/ckpt.py::
load_torch_state_dict`` and a plain ``load_state_dict`` read.

- ``save_step`` keeps ``last.ckpt`` plus the top-k checkpoints by a
  monitored metric (lower is better by default, like EPE), listed in
  ``index.json``;
- ``hpc_save``/``max_hpc_version`` implement the SLURM-style
  ``hpc_ckpt_N.ckpt`` auto-resume scan;
- ``resolve_resume_path`` implements the resume priority: explicit path >
  HPC checkpoint > last, with named pretrained checkpoints resolved through
  ``ckpt.resolve_checkpoint_path``.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from .ckpt import load_torch_state_dict, resolve_checkpoint_path


def save_checkpoint(path, state_dict: Dict[str, torch.Tensor],
                    hyper_parameters: Optional[Dict[str, Any]] = None,
                    **extra) -> None:
    """Write ``{"state_dict", "hyper_parameters", **extra}`` to ``path``,
    tensors on the CPU; the file appears whole (written beside it, then
    renamed)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()},
                "hyper_parameters": dict(hyper_parameters or {}), **extra},
               tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, top_k: int = 1,
                 monitor: str = "val/epe", mode: str = "min"):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.monitor = monitor
        self.mode = mode
        self._topk: List[Tuple[float, str]] = []
        self._load_index()

    # ------------------------------------------------------------- indexing
    def _index_path(self) -> Path:
        return self.dir / "index.json"

    def _load_index(self):
        if self._index_path().exists():
            data = json.loads(self._index_path().read_text())
            self._topk = [(float(s), n) for s, n in data.get("topk", [])]

    def _save_index(self):
        self._index_path().write_text(json.dumps({
            "topk": self._topk, "monitor": self.monitor, "mode": self.mode}))

    # --------------------------------------------------------------- saving
    def save_step(self, state_dict: Dict[str, torch.Tensor], step: int,
                  metrics: Optional[Dict[str, float]] = None,
                  hyper_parameters: Optional[Dict[str, Any]] = None):
        save_checkpoint(self.dir / "last.ckpt", state_dict, hyper_parameters)
        (self.dir / "last_step.json").write_text(json.dumps({"step": step}))
        if metrics and self.monitor in metrics:
            score = float(metrics[self.monitor])
            better = (score < max((s for s, _ in self._topk),
                                  default=float("inf"))) \
                if self.mode == "min" else \
                (score > min((s for s, _ in self._topk),
                             default=-float("inf")))
            if len(self._topk) < self.top_k or better:
                name = f"step{step}.ckpt"
                save_checkpoint(self.dir / name, state_dict,
                                hyper_parameters)
                self._topk.append((score, name))
                reverse = self.mode == "max"
                self._topk.sort(key=lambda t: t[0], reverse=reverse)
                while len(self._topk) > self.top_k:
                    _, evict = self._topk.pop()
                    (self.dir / evict).unlink(missing_ok=True)
                self._save_index()

    def best_path(self) -> Optional[str]:
        if not self._topk:
            return None
        return str(self.dir / self._topk[0][1])

    # ------------------------------------------------------------------ hpc
    def hpc_save(self, state_dict: Dict[str, torch.Tensor], step: int) -> str:
        version = self.max_hpc_version() + 1
        name = f"hpc_ckpt_{version}"
        save_checkpoint(self.dir / f"{name}.ckpt", state_dict)
        (self.dir / f"{name}_step.json").write_text(
            json.dumps({"step": step}))
        return str(self.dir / f"{name}.ckpt")

    def max_hpc_version(self) -> int:
        best = 0
        for p in self.dir.glob("hpc_ckpt_*.ckpt"):
            m = re.match(r"hpc_ckpt_(\d+)\.ckpt$", p.name)
            if m:
                best = max(best, int(m.group(1)))
        return best

    # --------------------------------------------------------------- resume
    def resolve_resume_path(self, explicit: Optional[str] = None,
                            model=None) -> Optional[str]:
        """Resume priority: explicit path/name > hpc ckpt > last."""
        if explicit is not None:
            if Path(explicit).exists():
                return explicit
            if model is not None:
                return resolve_checkpoint_path(model, explicit)
            raise FileNotFoundError(explicit)
        v = self.max_hpc_version()
        if v > 0:
            return str(self.dir / f"hpc_ckpt_{v}.ckpt")
        if (self.dir / "last.ckpt").exists():
            return str(self.dir / "last.ckpt")
        return None

    def load(self, path: str) -> Dict[str, torch.Tensor]:
        return load_torch_state_dict(path)[0]
