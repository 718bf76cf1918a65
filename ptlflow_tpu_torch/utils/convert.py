"""JAX parameter trees to the port's ``state_dict``.

The inverse of ``Module.from_torch`` in ``ptlflow_tpu/nn/module.py``: nested
names become dotted ones, convolution weights (``CONV_WEIGHTS``) go from
HWIO back to OIHW, linear weights from (in, out) back to (out, in), the
``LEAF_TRANSPOSES`` back to the reference's axis order, and every
BatchNorm gets the ``num_batches_tracked`` counter that the JAX tree
drops.  Takes numpy
leaves (the caller converts JAX arrays), so nothing here imports JAX.

A 2-D ``weight`` is a linear layer's unless the target module says it is an
embedding table, which the JAX package stores as torch does.  Given the
target, the result also holds what the JAX tree drops and a strict load
needs: a second name of a tensor the target registers twice (SEA-RAFT's
``bn3``, SCV's and MS-RAFT+'s ``norm3`` are also ``downsample.1``; the JAX
tree keeps one of the two) and the buffers the JAX package rebuilds
on every call (GMA's ``rel_ind``, LCV-RAFT's ``corr_block.eye``), and the
reference's names where the JAX package renames a tensor and its
``from_torch`` undoes the rename (``RENAMES``: FlowFormer's FFNs, whose
reference ``Sequential`` holds dropouts at indices 2 and 4, and its
decoder's nested cross-attention; ``PREFIXES``: MemFlow's ``network.``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Set

import numpy as np
import torch

# Convolution weights, stored HWIO by the JAX package: a convolution's, and
# the two rank-1 factors of NeXt1D's depthwise kernel
# (ptlflow_tpu/models/rapidflow/next1d.py:56-64).  ``ConvTranspose2d``'s
# (kh, kw, O, I) takes the same transpose to torch's (I, O, kh, kw).  A 5-D
# ``weight`` is a 3-D convolution's, DHWIO (ptlflow_tpu/nn/layers.py:312-316),
# or a ``ConvTranspose3d``'s, DHWOI (:367-371): one transpose gives torch's
# OIDHW or IODHW.  SeparableFlow's ``_BN3d`` stores BatchNorm3d's leaves
# under its own name, as torch does.
CONV_WEIGHTS = ("weight", "weight_h", "weight_v")

# Leaves that the JAX package stores in another axis order, with the
# transpose back to the reference's: VideoFlow-MOF's initial motion state,
# (1, 1, 1, 1, 48) there and (1, 1, 48, 1, 1) in the reference
# (ptlflow_tpu/models/videoflow/videoflow.py:239-251).
LEAF_TRANSPOSES = {"init_hidden_state": (0, 1, 4, 2, 3)}

# Buffers that the JAX package computes where the reference stores them:
# GMA's relative positions, LCV-RAFT's identity (ptlflow_tpu/models/lcv/
# lcv_raft.py:45-48), GMFlowNet's POLA bias index
# (ptlflow_tpu/models/gmflownet/pola.py:114-120).
STATIC_BUFFERS = ("rel_ind", "eye", "relative_position_index")

# Prefixes under which the reference nests the whole network and the JAX
# package's from_torch strips (MemFlow's ``network.``,
# ptlflow_tpu/models/memflow/memflow.py:209-216).
PREFIXES = ("network.",)

# (JAX name, reference name) of a dotted path segment, undone by the JAX
# package's from_torch (ptlflow_tpu/models/flowformer/flowformer.py:129-137,
# 166-173, 456-463 and 550-559; flowformerplusplus.py:130-139).
RENAMES = (("decoder_layer_cross_attend.", "decoder_layer.cross_attend."),
           ("ffn.2.", "ffn.3."))

# (JAX name, reference name) of the module that holds a leaf, tried where
# the target lacks the name: the torchvision ConvNeXt block of ReCoVEr,
# whose ``block`` Sequential the JAX package names by layer
# (ptlflow_tpu/models/recover/backbones.py:154-166).
MODULE_RENAMES = {"conv": "block.0", "norm": "block.2", "fc1": "block.3",
                  "fc2": "block.5"}

# Leaves that the JAX package stores flattened: the ConvNeXt block's
# ``layer_scale``, (dim,) there and (dim, 1, 1) in the reference
# (ptlflow_tpu/models/recover/backbones.py:143-152).  VCN's 4-D
# convolutions are also reshaped: 2-D convolutions there, ``Conv3d`` with
# a (k, k, 1) or (1, k, k) kernel in the reference
# (ptlflow_tpu/models/vcn/conv4d.py:66-78), so a 4-D weight whose target
# is 5-D takes the target's shape.
LEAF_RESHAPES = ("layer_scale",)


def state_dict_from_jax(params: Dict[str, Any],
                        target: Optional[torch.nn.Module] = None
                        ) -> Dict[str, torch.Tensor]:
    """``params``, a nested dict of numpy arrays, as a ``state_dict`` of
    ``target`` (which only decides the cases above; without it every 2-D
    ``weight`` is a linear layer's and nothing is added)."""
    embeddings: Set[str] = set()
    if target is not None:
        embeddings = {f"{name}.weight" for name, mod in target.named_modules()
                      if isinstance(mod, torch.nn.Embedding)}
        # the JAX tree's names lack the reference's outer prefix
        embeddings |= {n[len(p):] for n in embeddings for p in PREFIXES
                       if n.startswith(p)}
    out = _convert(params, "", embeddings)
    if target is not None:
        out = _rename_to_target(out, set(target.state_dict()))
        _add_target_only(out, target)
        _reshape_to_target(out, target)
    return out


def _reshape_to_target(out: Dict[str, torch.Tensor],
                       target: torch.nn.Module) -> None:
    """Each of the ``LEAF_RESHAPES``, and each 4-D convolution weight of a
    5-D target, to the target's shape, where it holds as many elements in
    another shape."""
    for name, t in target.state_dict().items():
        have = out.get(name)
        if have is None or have.shape == t.shape or have.numel() != t.numel():
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf in LEAF_RESHAPES or (leaf == "weight" and have.dim() == 4
                                     and t.dim() == 5):
            out[name] = have.reshape(t.shape)


def _rename_to_target(out: Dict[str, torch.Tensor],
                      own: Set[str]) -> Dict[str, torch.Tensor]:
    """Each name that the target lacks under its ``RENAMES`` form, with or
    without one of the ``PREFIXES``, or with its leaf's module under its
    ``MODULE_RENAMES`` name, where the target has that form."""
    renamed = {}
    for name, t in out.items():
        if name not in own:
            alt = name
            for jax_name, ref_name in RENAMES:
                alt = re.sub(r"(^|\.)" + re.escape(jax_name),
                             r"\g<1>" + ref_name, alt)
            *path, module, leaf = [""] + name.split(".")
            moved = ".".join(path[1:] + [MODULE_RENAMES.get(module, module),
                                         leaf])
            name = next((c for c in [alt] + [p + alt for p in PREFIXES]
                         + [moved] if c in own), name)
        renamed[name] = t
    return renamed


def _convert(params: Dict[str, Any], prefix: str,
             embeddings: Set[str]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_convert(v, name + ".", embeddings))
            continue
        a = np.asarray(v)
        if k in LEAF_TRANSPOSES:
            a = np.transpose(a, LEAF_TRANSPOSES[k])
        elif k in CONV_WEIGHTS and a.ndim == 4:  # conv HWIO -> OIHW
            a = np.transpose(a, (3, 2, 0, 1))
        elif k == "weight" and a.ndim == 5:  # 3-D conv DHWIO -> OIDHW
            a = np.transpose(a, (4, 3, 0, 1, 2))
        elif k == "weight" and a.ndim == 2 and name not in embeddings:
            a = a.T  # linear (in, out) -> (out, in)
        out[name] = torch.from_numpy(np.ascontiguousarray(a).copy())
        if k == "running_mean":
            out[f"{prefix}num_batches_tracked"] = torch.tensor(0)
    return out


def _add_target_only(out: Dict[str, torch.Tensor],
                     target: torch.nn.Module) -> None:
    """Add the target's names of tensors it registers under two names, and
    its static buffers, where the converted tree lacks them."""
    own = target.state_dict(keep_vars=True)
    names_of: Dict[int, list] = {}
    for name, t in own.items():
        names_of.setdefault(id(t), []).append(name)
    for name, t in own.items():
        if name in out:
            continue
        twin = next((n for n in names_of[id(t)] if n in out), None)
        if twin is not None:
            out[name] = out[twin]
        elif name.rsplit(".", 1)[-1] in STATIC_BUFFERS:
            out[name] = t.detach().clone()
