"""Checkpoint loading (``ptlflow_tpu/utils/ckpt.py``): a local torch or
Lightning ``.ckpt``/``.pth`` file, or a named pretrained checkpoint that is
already in the torch-hub cache, loads with a plain ``load_state_dict``.
Nothing is downloaded."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

# Checkpoint keys that belong to the Lightning harness, not the network.
_IGNORED_PREFIXES = ("loss_fn.", "train_metrics.", "val_metrics.",
                     "test_metrics.")


def load_checkpoint(path: str) -> Any:
    """The object a torch/Lightning .ckpt/.pth file holds, on the CPU."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # Lightning checkpoints pickle their hyper-parameters; the file is
        # one the caller named
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(path: str) -> Tuple[Dict[str, torch.Tensor],
                                              Dict[str, Any]]:
    """Load a torch/Lightning .ckpt/.pth file on the CPU ->
    (state_dict, hyper_parameters)."""
    return split_checkpoint(load_checkpoint(path))


def split_checkpoint(ckpt: Any) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, Any]]:
    """(state_dict, hyper_parameters) of a loaded checkpoint, without the
    keys of the Lightning harness."""
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        state = ckpt["state_dict"]
        hparams = ckpt.get("hyper_parameters", {}) or {}
    else:
        state, hparams = ckpt, {}
    state = {k: v for k, v in state.items()
             if not any(k.startswith(p) for p in _IGNORED_PREFIXES)}
    return state, hparams


def resolve_checkpoint_path(model, ckpt_path: Optional[str]) -> Optional[str]:
    """A local file, or a named pretrained checkpoint's file in the
    torch-hub cache (where the reference stores its downloads)."""
    if ckpt_path is None:
        return None
    if Path(ckpt_path).is_file():
        return ckpt_path
    names = getattr(model, "pretrained_checkpoints", {}) or {}
    if ckpt_path in names:
        local = (Path(torch.hub.get_dir()) / "checkpoints"
                 / names[ckpt_path].split("/")[-1])
        if local.is_file():
            return str(local)
        raise FileNotFoundError(
            f"pretrained checkpoint '{ckpt_path}' is not in the torch-hub "
            f"cache ({local}); this package downloads nothing, so fetch "
            f"{names[ckpt_path]} there or pass a local path")
    raise ValueError(
        f"ckpt_path '{ckpt_path}' is neither an existing file nor one of the "
        f"named pretrained checkpoints {sorted(names)}")


def restore_model(model, ckpt_path: Optional[str] = None,
                  strict: bool = True):
    """Load a checkpoint into ``model``; with no checkpoint, give it the
    seeded random weights of ``init_params()``."""
    path = resolve_checkpoint_path(model, ckpt_path)
    if path is None:
        return model.init_params()
    state, hparams = load_torch_state_dict(path)
    model.load_state_dict(state, strict=strict)
    if hparams.get("train_size") is not None:
        model.train_size = tuple(hparams["train_size"])
    if hparams.get("train_avg_length") is not None:
        model.train_avg_length = hparams["train_avg_length"]
    if hparams.get("extra_params") is not None:
        model.extra_params = dict(hparams["extra_params"])
    return model
