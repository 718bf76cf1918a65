"""Flow metrics (``ptlflow_tpu/utils/flow_metrics.py``) in torch, computed on
the tensors' device: EPE, px1/px3/px5, Fl-all, WAUC, their occluded and
non-occluded splits, and the occlusion, motion-boundary and confidence F1.

- per-sample masked means (invalid pixels excluded, clamp(valid_sum, 1));
- Fl-all = 100 * mean[(epe > 3) & (epe > 0.05*|gt|)];
- WAUC per the Spring spec, from a 102-bin histogram of ceil(20 * epe);
- multi-hypothesis 5-D GT reduces to the min-EPE hypothesis.

``FlowMetrics`` accumulates epoch means (or an EMA) on the host: one copy of
all of a batch's per-sample values per ``update``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..ops.grid_sample import interpolate


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-sample masked mean over all but the leading dim."""
    x = (x * valid).reshape(x.shape[0], -1)
    vs = valid.reshape(valid.shape[0], -1).sum(dim=1).clamp(min=1)
    return x.sum(dim=1) / vs


def _wauc(epe: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Spring WAUC per sample.  err_i = #(epe <= i/20), w_i = 1-(i-1)/100."""
    b = epe.shape[0]
    epe = torch.where(valid > 0.5, epe, torch.full_like(epe, 100.0))
    epe = epe.reshape(b, -1)
    n = valid.reshape(b, -1).sum(dim=1)
    # bin index: smallest i with epe <= i/20 is ceil(epe*20); clamp to 101
    idx = torch.ceil(epe * 20.0).clamp(0, 101).long()
    hist = torch.zeros(b, 102, dtype=epe.dtype, device=epe.device)
    hist.scatter_add_(1, idx, torch.ones_like(epe))
    cum = hist.cumsum(dim=1)  # cum[:, i] = #(epe <= i/20)
    i = torch.arange(1, 101, dtype=epe.dtype, device=epe.device)
    wi = 1.0 - (i - 1.0) / 100.0
    wauc = (wi[None] * cum[:, 1:101]).sum(dim=1)
    return 100.0 * wauc / (n * wi.sum() + 1e-8)


def _f1_score(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Macro F1 over the binary maps, per sample (f1_mode='macro')."""
    b = pred.shape[0]
    pred = pred.reshape(b, -1) > 0.5
    target = target.reshape(b, -1) > 0.5

    def f1(p, t):
        tp = (p & t).sum(dim=1).float()
        fp = (p & ~t).sum(dim=1).float()
        fn = (~p & t).sum(dim=1).float()
        return 2 * tp / (2 * tp + fp + fn).clamp(min=1e-8)

    return 0.5 * (f1(pred, target) + f1(~pred, ~target))


def _split_metrics(epe, tnorm, mask, suffix: str) -> Dict[str, torch.Tensor]:
    return {
        f"epe{suffix}": _masked_mean(epe, mask),
        f"px1{suffix}": _masked_mean((epe < 1).float(), mask),
        f"px3{suffix}": _masked_mean((epe < 3).float(), mask),
        f"px5{suffix}": _masked_mean((epe < 5).float(), mask),
        f"flall{suffix}": _masked_mean(
            100.0 * ((epe > 3) & (epe > 0.05 * tnorm)).float(), mask),
        f"wauc{suffix}": _wauc(epe, mask),
    }


def compute_flow_metrics(
    pred_flows: torch.Tensor, target_flows: torch.Tensor,
    valids: Optional[torch.Tensor] = None,
    occs: Optional[torch.Tensor] = None,
    pred_occs: Optional[torch.Tensor] = None,
    mbs: Optional[torch.Tensor] = None, pred_mbs: Optional[torch.Tensor] = None,
    pred_confs: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """All metrics, per sample.  Tensors are (B, 2, H, W) NCHW (or
    (B, K, 2, H, W) multi-hypothesis GT); masks (B, 1, H, W)."""
    pf = pred_flows.float()
    tf = target_flows.float()
    tf = torch.nan_to_num(tf, nan=0.0) if valids is not None else tf

    if tf.dim() == 5:  # multi-hypothesis GT: pick the min-EPE hypothesis
        epe_k = torch.linalg.vector_norm(pf[:, None] - tf, dim=2)
        epe, min_idx = epe_k.min(dim=1)
        tnorm_k = torch.linalg.vector_norm(tf, dim=2)
        tnorm = torch.gather(tnorm_k, 1, min_idx[:, None])[:, 0]
    else:
        epe = torch.linalg.vector_norm(pf - tf, dim=1)
        tnorm = torch.linalg.vector_norm(tf, dim=1)

    b = epe.shape[0]
    if valids is None:
        valid = torch.ones_like(epe)
    else:
        valid = valids.float().reshape(b, *epe.shape[1:])

    out = _split_metrics(epe, tnorm, valid, "")
    if occs is not None:
        occ = occs.float().reshape(b, *epe.shape[1:])
        out.update(_split_metrics(epe, tnorm, occ * valid, "_occ"))
        out.update(_split_metrics(epe, tnorm, (1 - occ) * valid, "_non_occ"))
        if pred_occs is not None:
            out["occ_f1"] = _f1_score(pred_occs, occs)
    if mbs is not None and pred_mbs is not None:
        out["mb_f1"] = _f1_score(pred_mbs, mbs)
    if pred_confs is not None:
        conf_target = torch.exp(-((tf - pf) ** 2).sum(dim=1))
        out["conf_f1"] = _f1_score(pred_confs, conf_target)
    return out


class FlowMetrics:
    """Metric accumulator over batches.

    ``average_mode`` is ``"epoch_mean"`` (default) or ``"ema"`` with
    ``ema_decay`` and the reference's bias correction for the first
    ``min(100, 1/(1-decay))`` steps.  ``interpolate_pred_to_target_size``
    bilinearly resizes predictions to the GT resolution (align_corners=True)
    and rescales flow vectors.

    Usage: ``m.update(preds, targets)`` with the model's output/input dicts
    ((B, N, 2, H, W) contract), then ``m.compute()``.
    """

    def __init__(self, prefix: str = "", average_mode: str = "epoch_mean",
                 ema_decay: float = 0.99,
                 interpolate_pred_to_target_size: bool = False):
        if average_mode not in ("epoch_mean", "ema"):
            raise ValueError(f"average_mode {average_mode!r}: 'epoch_mean' "
                             f"or 'ema'")
        self.prefix = prefix
        self.average_mode = average_mode
        self.ema_decay = ema_decay
        self.ema_max_count = min(100, int(1.0 / max(1.0 - ema_decay, 1e-8)))
        self.interpolate_pred_to_target_size = interpolate_pred_to_target_size
        self.reset()

    def reset(self):
        self._sums: Dict[str, float] = {}
        self._count = 0
        self._steps = 0

    @staticmethod
    def _interp_to(v: torch.Tensor, size, is_flow: bool) -> torch.Tensor:
        h, w = v.shape[-2:]
        if (h, w) == tuple(size):
            return v
        lead = v.shape[:-3]
        out = interpolate(v.reshape(-1, *v.shape[-3:]), tuple(size),
                          mode="bilinear", align_corners=True)
        out = out.reshape(*lead, v.shape[-3], *size)
        if is_flow:
            scale = torch.tensor([size[1] / w, size[0] / h], dtype=out.dtype,
                                 device=out.device)
            out = out * scale.reshape(2, 1, 1)
        return out

    @staticmethod
    def _collapse(x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
        return x

    def update(self, preds: Dict[str, Any], targets: Dict[str, Any]):
        tflows = targets["flows"]
        multi_hyp = tflows.dim() == 6
        if self.interpolate_pred_to_target_size:
            size = tuple(tflows.shape[-2:])
            preds = {k: (self._interp_to(v, size, "flow" in k)
                         if isinstance(v, torch.Tensor) and v.dim() >= 4
                         else v)
                     for k, v in preds.items()}
        pf = self._collapse(preds["flows"])
        tf = (tflows.reshape(-1, *tflows.shape[2:]) if multi_hyp
              else self._collapse(tflows))

        def opt(d, k):
            v = d.get(k)
            return self._collapse(v) if v is not None else None

        vals = compute_flow_metrics(
            pf, tf, valids=opt(targets, "valids"), occs=opt(targets, "occs"),
            pred_occs=opt(preds, "occs"), mbs=opt(targets, "mbs"),
            pred_mbs=opt(preds, "mbs"), pred_confs=opt(preds, "confs"))
        # one copy to the host for all of this batch's metrics
        names = list(vals)
        sums = torch.stack([vals[k].double().sum() for k in names]).cpu()
        if self.average_mode == "epoch_mean":
            prev_w, next_w = 1.0, 1.0
        else:
            prev_w, next_w = self.ema_decay, 1.0 - self.ema_decay
        for k, v in zip(names, sums.tolist()):
            self._sums[k] = prev_w * self._sums.get(k, 0.0) + next_w * v
        self._count += pf.shape[0]
        self._steps += 1

    def compute(self) -> Dict[str, float]:
        if self.average_mode == "epoch_mean":
            c = max(self._count, 1)
        else:
            c = 1.0
            if self._steps < self.ema_max_count:  # bias correction
                c -= self.ema_decay ** self._steps
            c = max(c, 1e-8)
        return {f"{self.prefix}{k}": v / c for k, v in self._sums.items()}
