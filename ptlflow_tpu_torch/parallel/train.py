"""Train step: AdamW with a linear OneCycle schedule and global-norm
clipping, as ``ptlflow_tpu/parallel/train.py`` builds them with optax.

The recipe is the reference's (AdamW(lr, weight_decay) with
OneCycleLR(pct_start=0.05, anneal='linear'), stepped per optimizer step),
reproduced value for value from the optax chain the JAX package uses:
``clip_by_global_norm`` then ``adamw`` with the schedule read at the
pre-increment step count, and ``optax.MultiSteps`` around the chain for
gradient accumulation.  ``torch.optim.AdamW``, ``OneCycleLR`` and
``clip_grad_norm_`` are not used: each differs from optax in some detail.

JAX's arrays are immutable, so its step returns new parameters; here the
step updates the model's parameters, the optimizer's moments and the
BatchNorm running statistics in place, to hold one copy of each.  The step
runs on the model's device: the card unless the model is on the CPU.  Data
parallelism (the JAX package's ``mesh`` argument) is queued in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn import split_trainable


def onecycle_linear(max_lr: float, total_steps: int,
                    pct_start: float = 0.05) -> Callable[[int], float]:
    """OneCycleLR with linear anneal (torch semantics: warm up from
    max_lr/25 to max_lr, then anneal to max_lr/(25*1e4)), as the JAX
    package's ``optax.join_schedules`` of two ``linear_schedule``s: the same
    float32 arithmetic, so the values agree with optax's to the bit."""
    initial = max_lr / 25.0
    final = initial / 1e4
    warm = max(int(pct_start * total_steps) - 1, 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        # optax.polynomial_schedule with power 1, in float32
        count = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - count / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    def schedule(step: int) -> float:
        if step < warm:
            return float(linear(initial, max_lr, warm, step))
        return float(linear(max_lr, final, max(total_steps - warm, 1),
                            step - warm))

    return schedule


@dataclass
class AdamWState:
    count: int  # optimizer steps taken; the schedule is read at this count
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    # gradient accumulation (``accumulate_steps > 1``): micro-batches
    # averaged so far since the last optimizer step, and their mean
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps, weight_decay))``, updating the parameters in place.

    Clipping scales every gradient by min(1, grad_clip/||g||), with ||g||
    the global norm (optax's formula; ``clip_grad_norm_`` adds 1e-6).  Adam
    keeps fp32 moments, corrects their bias, and the decoupled weight decay
    applies to every trainable tensor before the learning rate scales the
    update.

    With ``accumulate_steps`` k > 1 the chain sits inside
    ``optax.MultiSteps(every_k_schedule=k)``: each micro-batch's gradients
    join a running mean (``acc + (g - acc) / (n + 1)``, optax's), and every
    k-th micro-batch clips that mean, takes the Adam step and advances the
    count (and so the schedule) once; the micro-batches between leave the
    parameters as they are."""

    def __init__(self, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4,
                 grad_clip: Optional[float] = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 accumulate_steps: int = 1):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.accumulate_steps = max(int(accumulate_steps or 1), 1)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        def zeros():
            return [torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for p in params.values()]

        return AdamWState(count=0, mu=zeros(), nu=zeros(),
                          acc=zeros() if self.accumulate_steps > 1 else None)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor],
               grad_norm: Optional[torch.Tensor] = None) -> AdamWState:
        """One micro-batch: ``params``, the moments and the running mean
        change in place; returns the new state.  Without accumulation every
        call is an optimizer step.  ``grad_norm``, the global norm of
        ``grads`` where the caller has it, saves computing it again."""
        grads = list(grads)
        params = list(params)
        if self.accumulate_steps > 1:
            n = state.mini_step
            # acc += (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(state.acc, delta)
            if n + 1 < self.accumulate_steps:
                return AdamWState(state.count, state.mu, state.nu, n + 1,
                                  state.acc)
            grads, grad_norm = state.acc, None  # zeroed after the step
        lr = self.schedule(state.count)
        if self.grad_clip is not None:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            scale = torch.clamp(self.grad_clip / norm, max=1.0)
            grads = torch._foreach_mul(grads, scale)
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - b2)
        # mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps)
        denom = torch._foreach_div(state.nu, 1 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(state.mu, 1 - b1 ** count)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_add_(params, updates, alpha=-lr)
        if state.acc is not None:
            torch._foreach_zero_(state.acc)
        return AdamWState(count, state.mu, state.nu, 0, state.acc)


def make_optimizer(lr: float = 1e-4, wdecay: float = 1e-4,
                   total_steps: int = 100000, pct_start: float = 0.05,
                   grad_clip: Optional[float] = 1.0,
                   schedule: Optional[Callable[[int], float]] = None,
                   accumulate_steps: int = 1) -> AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay ``wdecay``) on
    the ``onecycle_linear`` schedule, after clipping to global norm
    ``grad_clip`` (None: no clipping); ``accumulate_steps > 1`` averages
    the gradients of that many micro-batches per optimizer step, as
    ``optax.MultiSteps`` does (Lightning's ``accumulate_grad_batches``)."""
    sched = schedule or onecycle_linear(lr, total_steps, pct_start)
    return AdamW(sched, weight_decay=wdecay, grad_clip=grad_clip,
                 accumulate_steps=accumulate_steps)


@dataclass
class TrainState:
    params: Dict[str, torch.nn.Parameter]  # trainable, the model's own
    state: Dict[str, torch.Tensor]  # non-trainable (BN running statistics)
    opt_state: AdamWState
    step: int


def create_train_state(model: torch.nn.Module, tx: AdamW) -> TrainState:
    """The model's trainable parameters and state (``nn.split_trainable``
    with its ``frozen_prefixes``) and a fresh optimizer state.  The tensors
    are the model's own: the train step updates them in place."""
    trainable, state = split_trainable(
        model, getattr(model, "frozen_prefixes", ()))
    return TrainState(params=trainable, state=state,
                      opt_state=tx.init(trainable), step=0)


def optimizer_state_dict(state: TrainState) -> Dict[str, object]:
    """The optimizer state and step of ``state`` as plain values and CPU
    tensors keyed by parameter name, for a checkpoint: the step, the
    schedule's count, Adam's moments ``mu`` and ``nu`` and, under gradient
    accumulation, the running mean ``acc`` and its ``mini_step``."""
    names = list(state.params)
    opt = state.opt_state

    def named(tensors):
        return None if tensors is None else {
            k: t.detach().cpu() for k, t in zip(names, tensors)}

    return {"step": state.step, "count": opt.count,
            "mini_step": opt.mini_step, "mu": named(opt.mu),
            "nu": named(opt.nu), "acc": named(opt.acc)}


def load_optimizer_state(state: TrainState, saved: Dict[str, object]
                         ) -> TrainState:
    """``state`` with the optimizer state and step of
    ``optimizer_state_dict``'s ``saved`` copied into its tensors (exactly:
    the values are the saved ones to the bit)."""
    names = list(state.params)
    opt = state.opt_state
    if (saved["acc"] is None) != (opt.acc is None):
        raise ValueError("the checkpoint's gradient accumulation does not "
                         "match the optimizer's accumulate_steps")
    for key in ("mu", "nu", "acc"):
        dst = getattr(opt, key)
        if dst is None:
            continue
        if set(saved[key]) != set(names):
            raise ValueError(f"the checkpoint's optimizer '{key}' does not "
                             f"name this model's parameters")
        with torch.no_grad():
            for k, t in zip(names, dst):
                t.copy_(saved[key][k])
    return TrainState(state.params, state.state,
                      AdamWState(int(saved["count"]), opt.mu, opt.nu,
                                 int(saved["mini_step"]), opt.acc),
                      int(saved["step"]))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element: ``optax.global_norm``."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack(norms))


def loss_and_grads(model: torch.nn.Module,
                   params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The training forward, ``model.loss_fn`` and the gradient of the loss
    with respect to each of ``params``: zeros for a parameter the forward
    does not use, as ``jax.grad`` gives.  BatchNorm running statistics move
    as in the JAX package's ``loss_and_updates``."""
    outputs = model(batch, training=True)
    loss = model.loss_fn(outputs, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), grads


def build_train_step(model: torch.nn.Module, tx: AdamW,
                     mesh=None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.  ``batch`` holds
    ``images`` (B, 2, 3, H, W), ``flows`` (B, 1, 2, H, W) and ``valids``
    (B, 1, 1, H, W); ``metrics`` the loss and ``grad_norm``, the global norm
    of the gradients before clipping, as 0-d tensors on the model's device
    (reading them waits for the card)."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training (the mesh argument) is not ported yet; "
            "DDP is queued in ROADMAP.md")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        dev = next(iter(state.params.values())).device
        batch = {k: v.to(dev, non_blocking=True)
                 if isinstance(v, torch.Tensor) else v
                 for k, v in batch.items()}
        loss, grads = loss_and_grads(model, state.params, batch)
        gnorm = global_norm(grads)
        opt_state = tx.update(grads, state.opt_state,
                              state.params.values(), grad_norm=gnorm)
        new_state = TrainState(state.params, state.state, opt_state,
                               state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
