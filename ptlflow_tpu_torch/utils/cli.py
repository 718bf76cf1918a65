"""The entry-point scripts' shared CLI (``ptlflow_tpu/utils/cli.py``):
``--model``, ``--ckpt_path``, ``--config`` YAML with ``model.init_args`` /
``data.*`` trees, dotted ``--set`` overrides, and ``--device``, the card
unless the caller asks for the CPU.  The YAML is read by ``yaml_subset``
(no PyYAML)."""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Any, Dict, Optional

import torch

from . import yaml_subset


def parse_value(v: str) -> Any:
    """A ``--set`` value: a Python literal, YAML's ``true``/``false``/``null``
    (any case), else the string itself."""
    words = {"true": True, "false": False, "null": None, "none": None}
    if v.lower() in words:
        return words[v.lower()]
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def add_common_model_args(parser: argparse.ArgumentParser):
    parser.add_argument("--model", type=str, required=False,
                        help="Registered model name")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="Checkpoint name (e.g. 'things') or local path")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config (model.init_args / data trees)")
    parser.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                        help="Dotted config overrides, e.g. model.iters=12")
    add_device_arg(parser)


def add_device_arg(parser: argparse.ArgumentParser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: the card; "
                        "'cpu' runs the kernels' plain versions)")


def parse_with_config(parser: argparse.ArgumentParser,
                      argv=None) -> argparse.Namespace:
    """Parse CLI args with CLI > ``--config`` YAML > parser default:
    top-level keys of the YAML fill any argument the user left at its
    default, except the mappings (``model:``, ``data:``, ``trainer:``),
    which are config trees for ``load_config``."""
    args = parser.parse_args(argv)
    if getattr(args, "config", None):
        cfg = yaml_subset.load(args.config) or {}
        passed = {a.split("=")[0].lstrip("-").replace("-", "_")
                  for a in (argv if argv is not None else sys.argv[1:])
                  if a.startswith("--")}
        for action in parser._actions:
            d = action.dest
            if d in ("help", "config", "set") or d not in cfg:
                continue
            if d not in passed and cfg[d] is not None \
                    and not isinstance(cfg[d], dict):
                setattr(args, d, cfg[d])
    return args


def load_config(args: argparse.Namespace) -> Dict[str, Any]:
    cfg: Dict[str, Any] = {}
    if args.config:
        cfg = yaml_subset.load(args.config) or {}
    for kv in args.set:
        key, _, value = kv.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_value(value)
    return cfg


def resolve_device(args: argparse.Namespace) -> torch.device:
    """``args.device`` (default the card); raises where CUDA is absent,
    never falls back to the CPU."""
    device = torch.device(getattr(args, "device", None) or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    return device


def model_name_from_args(args: argparse.Namespace,
                         cfg: Dict[str, Any]) -> str:
    """``args.model``, else the config's ``model.name`` or the last part of
    its ``model.class_path``."""
    model_cfg = cfg.get("model", {})
    name = args.model or model_cfg.get("name") \
        or str(model_cfg.get("class_path", "")).split(".")[-1]
    if not name:
        raise SystemExit("--model is required (or set model.name in config)")
    return name


def model_from_args(args: argparse.Namespace, cfg: Dict[str, Any],
                    init_args: Optional[Dict[str, Any]] = None):
    """The registered model ``args.model`` (or the config's) on
    ``args.device``, with ``model.init_args`` of the config updated by
    ``init_args``."""
    import ptlflow_tpu_torch

    name = model_name_from_args(args, cfg)
    kwargs = dict(cfg.get("model", {}).get("init_args", {}))
    kwargs.update(init_args or {})
    ckpt = args.ckpt_path or cfg.get("ckpt_path")
    model = ptlflow_tpu_torch.get_model(name, ckpt_path=ckpt, args=kwargs,
                                        device=resolve_device(args))
    return model, name


def datamodule_from_cfg(cfg: Dict[str, Any], output_stride: int = 8,
                        **overrides):
    """The config's ``data`` tree as a ``FlowDataModule``, updated by the
    ``overrides`` that are not None: the scripts' dataset selections and
    the training flags (``train_batch_size``, ``train_crop_size``,
    ``train_num_workers``).  ``train_transform_cuda`` and
    ``train_transform_fp16`` come through ``--set data.<key>=true``."""
    from ..data import FlowDataModule

    data_cfg = dict(cfg.get("data", {}))
    data_cfg.update({k: v for k, v in overrides.items() if v is not None})
    data_cfg.setdefault("output_stride", output_stride)
    return FlowDataModule(**data_cfg)
