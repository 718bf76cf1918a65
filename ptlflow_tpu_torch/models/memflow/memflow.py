"""MemFlow (``ptlflow_tpu/models/memflow/memflow.py``), NCHW: streaming
optical flow with a key/value motion memory.

Per frame pair, the context encoder gives the decoder's hidden state, its
input, and a query and a key (GMA's ``att.to_qk`` split in two); the
feature encoder runs once on both frames, concatenated along the batch.
Each of ``decoder_depth`` steps (15) looks the pyramid up (the lookup
prepared once a forward, one kernel launch a step), encodes the motion
with SKFlow's super-kernel blocks (``models/skflow/skflow.py``) and its
value with ``aggregator.to_v``, and adds to the motion features ``gamma``
times a readout of the memory: a softmax of the query against the keys of
the stored frames and of the current one, over the keys, with the
temperature ``att.scale * log(N) / log(train_avg_length)``, N the number
of keys, applied to their values (the current frame's value is the
step's).

The memory is a ring of ``max_mid_term_frames`` (2) frames of keys and
values with a count of the frames written; :func:`match_affinity` reads the
``count`` newest and the current frame.  The affinity and the stored
frames' readout depend on neither the step nor the value, so they are
computed once a frame, outside the decoder loop; each step contracts only
the current value.  The two contractions are ``torch.matmul`` (cuBLAS),
as the JAX package computes them outside any Pallas kernel.

``model(inputs)`` in eval mode is the JAX package's stateful
``MemFlow.infer``: ``inputs["meta"]["is_seq_start"]`` clears the memory,
and a frame writes its key and last value into it when ``mem_every``
frames have passed since the last write and it is not
``meta["is_seq_end"]`` (without ``meta`` it counts as the end, so nothing
is written; ``validate`` passes none).  The memory lives on the model's
device and is rebuilt when the batch or the 1/8 size changes.
``model(inputs, training=True)`` is the JAX package's pure ``forward``,
which the train step calls: an empty memory read, none written.

The reference nests the network under ``network.``, so the port does too:
its ``state_dict`` names are the reference's, and a reference checkpoint
loads with a plain ``load_state_dict``.  ``memflow_t`` takes the port's
Twins-SVT (``models/flowformer/twins.py``) for both encoders, with
``proj`` after the context encoder and ``channel_convertor`` after the
feature encoder.  It computes in fp32: no mixed-precision mode, as in the
JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import (build_corr_pyramid, coords_grid,
                                make_corr_lookup)
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..flowformer.twins import twins_svt_large
from ..gma.gma_utils import Aggregate, Attention
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss
from ..skflow.skflow import (PCBlock4_Deep_nopool_res,
                             SKMotionEncoder6_Deep_nopool_res)

Memory = Dict[str, Any]


class SKUpdateBlockMem(nn.Module):
    """SKFlow's update block with the memory readout in place of the
    aggregation: the motion encoder is SKFlow's, the value head the
    aggregator's ``to_v``."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 hidden_dim: int = 128):
        super().__init__()
        k_conv = (1, 15)
        self.encoder = SKMotionEncoder6_Deep_nopool_res(
            corr_levels, corr_radius, k_conv)
        self.gru = PCBlock4_Deep_nopool_res(
            128 + hidden_dim + hidden_dim + 128, 128, (1, 7))
        self.flow_head = PCBlock4_Deep_nopool_res(128, 2, k_conv)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9, 1, padding=0))
        self.aggregator = Aggregate(dim=128, dim_head=128, heads=1)

    def get_motion_and_value(self, flow: torch.Tensor, corr: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        motion_features = self.encoder(flow, corr)
        return motion_features, self.aggregator.to_v(motion_features)

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        # 0.25 scales the mask gradients, as in the reference
        return 0.25 * self.mask(net)

    def forward(self, net, inp, motion_features, motion_features_global,
                with_mask: bool = True):
        """(net, mask, delta_flow); the mask is None unless
        ``with_mask``."""
        inp_cat = torch.cat([inp, motion_features, motion_features_global],
                            dim=1)
        net = self.gru(torch.cat([net, inp_cat], dim=1))
        delta_flow = self.flow_head(net)
        mask = self.upsample_mask(net) if with_mask else None
        return net, mask, delta_flow


# ------------------------------------------------------------- the memory
def empty_memory(b: int, hw: int, capacity: int, device=None) -> Memory:
    """A ring of ``capacity`` frames of float32 keys and values
    (B, capacity, HW, 128), the newest last, and the count of frames
    written (a Python int, at most ``capacity``)."""
    return {"key": torch.zeros((b, capacity, hw, 128), device=device),
            "value": torch.zeros((b, capacity, hw, 128), device=device),
            "count": 0}


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _stored(ring: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` newest frames of a ring (B, capacity, HW, C) as
    (B, n*HW, C), oldest first."""
    b, cap, hw, c = ring.shape
    return ring[:, cap - n:].reshape(b, n * hw, c)


def match_affinity(query: torch.Tensor, cur_key: torch.Tensor,
                   memory: Memory, att_scale: float,
                   train_avg_length: float) -> torch.Tensor:
    """The query's affinity to the keys of the memory's ``count`` stored
    frames, oldest first, and of the current frame: (B, (count+1)*HW, HW),
    a softmax over the keys (axis 1) of their products with the query,
    scaled by ``att_scale * log((count+1)*HW) / log(train_avg_length)``,
    in float32.  ``query`` and ``cur_key`` are (B, C, H, W).

    The JAX package keeps every ring slot and gives the unfilled ones -inf
    logits, which the softmax turns into exact zeros; this reads only the
    filled slots, so it gives the same numbers without those rows."""
    hw = query.shape[-2] * query.shape[-1]
    n = min(memory["count"], memory["key"].shape[1])
    keys = torch.cat([_stored(memory["key"], n), _tokens(cur_key)], dim=1)
    scale = (att_scale * math.log((n + 1) * hw)
             / math.log(train_avg_length))
    # the logits are laid out (B, HW, keys), so that the softmax runs over
    # the contiguous last axis: over axis 1 of (B, keys, HW) PyTorch's CUDA
    # softmax takes its strided ("spatial") kernel, tens of times slower
    # than the bytes need (PERF.md, PR 8); the transposed view returned is
    # the same numbers
    sim = torch.matmul(_tokens(query).float(),
                       keys.float().transpose(1, 2)) * scale
    return torch.softmax(sim, dim=-1).to(query.dtype).transpose(1, 2)


def _readout(affinity: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum over keys t of affinity[b, t, l] * values[b, t, c] ->
    (B, HW, C), accumulated in float32 and returned in the affinity's
    dtype."""
    return torch.matmul(affinity.float().transpose(1, 2),
                        values.float()).to(affinity.dtype)


def match_memory(query: torch.Tensor, cur_key: torch.Tensor,
                 cur_value: torch.Tensor, memory: Memory, att_scale: float,
                 train_avg_length: float) -> torch.Tensor:
    """The whole readout, (B, Cv, H, W): :func:`match_affinity` applied to
    the stored frames' values and ``cur_value`` (B, Cv, H, W).  The model
    splits it (see the module docstring); the tests hold both forms to the
    JAX package's."""
    b, _, h, w = query.shape
    affinity = match_affinity(query, cur_key, memory, att_scale,
                              train_avg_length)
    n = affinity.shape[1] // (h * w) - 1
    values = torch.cat([_stored(memory["value"], n), _tokens(cur_value)],
                       dim=1)
    return _readout(affinity, values).transpose(1, 2).reshape(b, -1, h, w)


def add_memory(memory: Memory, key: torch.Tensor,
               value: torch.Tensor) -> Memory:
    """A new memory with the frame of ``key`` and ``value`` (B, C, H, W)
    rolled in at the end, the oldest frame out, and the count saturating
    at the capacity."""
    cap = memory["key"].shape[1]
    return {"key": torch.cat([memory["key"][:, 1:],
                              _tokens(key)[:, None]], dim=1),
            "value": torch.cat([memory["value"][:, 1:],
                                _tokens(value)[:, None]], dim=1),
            "count": min(memory["count"] + 1, cap)}


# -------------------------------------------------------------- the model
class MemFlowNet(nn.Module):
    """The network the reference holds under ``network.``."""

    def __init__(self, corr_levels: int, corr_radius: int, cnet: str,
                 fnet: str, hidden_dim: int, context_dim: int):
        super().__init__()
        if cnet == "twins":
            self.cnet = twins_svt_large()
            self.proj = CastConv2d(256, 256, 1)
        else:
            self.cnet = BasicEncoder(output_dim=256, norm_fn="batch")
        if fnet == "twins":
            self.fnet = twins_svt_large()
            self.channel_convertor = CastConv2d(256, 256, 1, bias=False)
        else:
            self.fnet = BasicEncoder(output_dim=256, norm_fn="instance")
        self.update_block = SKUpdateBlockMem(corr_levels, corr_radius,
                                             hidden_dim=hidden_dim)
        self.att = Attention(dim=context_dim, heads=1, max_pos_size=160,
                             dim_head=context_dim)


class MemFlow(BaseModel):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memflow-things-90d0b74c.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memflow-sintel-38621d84.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memflow-kitti-ee6cbf09.ckpt",
        "spring": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memflow-spring-7ee1b984.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 cnet: str = "basicencoder", fnet: str = "basicencoder",
                 gma: str = "GMA-SK2", decoder_depth: int = 15,
                 mem_every: int = 1, max_mid_term_frames: int = 2,
                 min_mid_term_frames: int = 2,
                 train_avg_length: Optional[int] = None,
                 filter_epe: bool = False, gamma: float = 0.8,
                 max_flow: float = 400, **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.cnet_name = cnet
        self.fnet_name = fnet
        self.decoder_depth = decoder_depth
        self.mem_every = mem_every
        self.capacity = max_mid_term_frames
        self.train_avg_length = (train_avg_length if train_avg_length
                                 is not None else 6750)
        self.hidden_dim = 128
        self.context_dim = 128
        self.network = MemFlowNet(corr_levels, corr_radius, cnet, fnet,
                                  self.hidden_dim, self.context_dim)
        self.clear_memory()

    # ------------------------------------------------------ streaming
    def clear_memory(self) -> None:
        self.curr_ti = -1
        self.last_mem_ti = -self.mem_every
        self._memory: Optional[Memory] = None

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Training: the pure forward (an empty memory, none written).
        Eval: the stateful step of the JAX package's ``MemFlow.infer``."""
        if training:
            return self._step(inputs, None, write_memory=False,
                              training=True)[0]
        meta = inputs.get("meta", {})
        if isinstance(meta, dict) and meta.get("is_seq_start"):
            self.clear_memory()
        self.curr_ti += 1
        end = (bool(meta.get("is_seq_end", True)) if isinstance(meta, dict)
               else True)
        is_mem_frame = ((self.curr_ti - self.last_mem_ti >= self.mem_every)
                        and not end)
        images = inputs["images"]
        b = images.shape[0]
        hw = -(-images.shape[-2] // 8) * -(-images.shape[-1] // 8)
        mem = self._memory
        if (mem is None or tuple(mem["key"].shape[:3]) != (b, self.capacity,
                                                           hw)
                or mem["key"].device != images.device):
            mem = empty_memory(b, hw, self.capacity, device=images.device)
        outputs, self._memory = self._step(inputs, mem,
                                           write_memory=is_mem_frame,
                                           training=False)
        if is_mem_frame:
            self.last_mem_ti = self.curr_ti
        return outputs

    # ------------------------------------------------------------ step
    def _encode_context(self, image: torch.Tensor):
        net_mod = self.network
        cnet = net_mod.cnet(image)
        if self.cnet_name == "twins":
            cnet = net_mod.proj(cnet)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        query, key = net_mod.att.to_qk(inp).chunk(2, dim=1)
        return query, key, net, inp

    def _step(self, inputs: Dict[str, Any], memory: Optional[Memory],
              write_memory: bool, training: bool
              ) -> Tuple[Dict[str, torch.Tensor], Optional[Memory]]:
        net_mod = self.network
        ub = net_mod.update_block
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]

        query, ctx_key, net, inp = self._encode_context(image1)
        fmaps = net_mod.fnet(torch.cat([image1, image2], dim=0))
        if self.fnet_name == "twins":
            fmaps = net_mod.channel_convertor(fmaps)
        fmap1, fmap2 = fmaps.chunk(2, dim=0)
        corr_lookup = make_corr_lookup(
            build_corr_pyramid(fmap1, fmap2, self.corr_levels),
            self.corr_radius)

        b, _, h, w = fmap1.shape
        hw = h * w
        if memory is None:
            memory = empty_memory(b, hw, self.capacity, device=fmap1.device)
        coords0 = coords_grid(b, h, w, dtype=image1.dtype,
                              device=fmap1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])

        # the affinity and the stored frames' readout are the same at every
        # step: taken once, each step contracts only its current value
        affinity = match_affinity(query, ctx_key, memory, net_mod.att.scale,
                                  self.train_avg_length)
        n = affinity.shape[1] // hw - 1
        aff_cur = affinity[:, n * hw:]
        mem_readout = None
        if n:
            mem_readout = _readout(affinity[:, :n * hw],
                                   _stored(memory["value"], n))
        gamma = ub.aggregator.gamma

        flows_lr, masks = [], []
        value = None
        for _ in range(self.decoder_depth):
            coords1 = coords1.detach()
            corr = corr_lookup(coords1)
            flow = coords1 - coords0
            motion_features, value = ub.get_motion_and_value(flow, corr)
            readout = _readout(aff_cur, _tokens(value))
            if mem_readout is not None:
                readout = mem_readout + readout
            readout = readout.transpose(1, 2).reshape(b, -1, h, w)
            net, up_mask, delta_flow = ub(
                net, inp, motion_features,
                motion_features + gamma.to(flow.dtype) * readout,
                with_mask=training)
            coords1 = coords1 + delta_flow
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(up_mask)

        if training:
            flow_ups = convex_upsample(torch.stack(flows_lr).flatten(0, 1),
                                       torch.stack(masks).flatten(0, 1))
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b)), image_resizer,
                is_flow=True)
            outputs = {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups}
        else:
            # the last step's mask, a function of the final hidden state,
            # taken once: the steps before need none in eval
            flow_lr = coords1 - coords0
            flow_up = convex_upsample(flow_lr, ub.upsample_mask(net))
            flow_up = self.postprocess_predictions(flow_up, image_resizer,
                                                   is_flow=True)
            outputs = {"flows": flow_up[:, None], "flow_small": flow_lr}

        if write_memory:
            memory = add_memory(memory, ctx_key, value)
        return outputs, memory


class MemFlowT(MemFlow):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memflow_t-things-6028d89f.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memflow_t-sintel-d2df0424.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memflow_t-kitti-9eeabb65.ckpt",
    }

    def __init__(self, cnet: str = "twins", fnet: str = "twins", **kwargs):
        super().__init__(cnet=cnet, fnet=fnet, **kwargs)


@register_model
@trainable
class memflow(MemFlow):
    pass


@register_model
@trainable
class memflow_t(MemFlowT):
    pass
