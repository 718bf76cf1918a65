"""Training observability (``ptlflow_tpu/utils/logger.py``): scalar and
image logging.

Replaces the reference's LoggerCallback (ptlflow's utils/callbacks/
logger.py:56-460): collects N uniformly sampled validation images per
validation run and renders image / flow-RGB / EPE-map grids.  Five
backends, as the reference dispatches to: TensorBoard, Weights & Biases,
Comet, Neptune and SwanLab.  Each imports its package when it is built; a
backend whose package is missing is skipped with a notice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .flow_viz import flow_to_rgb


class TensorBoardLogger:
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self.writer = SummaryWriter(log_dir=log_dir)

    def log_scalars(self, scalars: Dict[str, float], step: int):
        for k, v in scalars.items():
            self.writer.add_scalar(k, float(v), step)

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int):
        self.writer.add_image(tag, image_hwc, step, dataformats="HWC")

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class WandbLogger:
    """Weights & Biases backend (reference logger.py dispatch); requires the
    optional ``wandb`` package."""

    def __init__(self, project: str = "ptlflow_tpu", run_name: str = None,
                 config: Dict = None):
        import wandb  # optional dependency

        self.run = wandb.init(project=project, name=run_name, config=config)
        self._wandb = wandb

    def log_scalars(self, scalars: Dict[str, float], step: int):
        self.run.log({k: float(v) for k, v in scalars.items()}, step=step)

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int):
        self.run.log({tag: self._wandb.Image(image_hwc)}, step=step)

    def flush(self):
        pass

    def close(self):
        self.run.finish()


class CometLogger:
    """Comet backend (reference logger.py:118-119: experiment.log_image /
    log_metrics); requires the optional ``comet_ml`` package."""

    def __init__(self, project: str = "ptlflow_tpu", run_name: str = None):
        import comet_ml  # optional dependency

        self.experiment = comet_ml.Experiment(project_name=project)
        if run_name:
            self.experiment.set_name(run_name)

    def log_scalars(self, scalars: Dict[str, float], step: int):
        self.experiment.log_metrics(
            {k: float(v) for k, v in scalars.items()}, step=step)

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int):
        self.experiment.log_image(image_hwc, name=tag, step=step)

    def flush(self):
        pass

    def close(self):
        self.experiment.end()


class NeptuneLogger:
    """Neptune backend (reference logger.py:120-121:
    experiment[title].log(File.as_image(...))); requires ``neptune``."""

    def __init__(self, project: str = None, run_name: str = None):
        import neptune  # optional dependency

        self.run = neptune.init_run(project=project, name=run_name)
        self._neptune = neptune

    def log_scalars(self, scalars: Dict[str, float], step: int):
        for k, v in scalars.items():
            self.run[k].append(float(v), step=step)

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int):
        from neptune.types import File

        img = image_hwc
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        self.run[tag].append(File.as_image(img), step=step)

    def flush(self):
        pass

    def close(self):
        self.run.stop()


class SwanLabLogger:
    """SwanLab backend (reference logger.py:127-130: swanlab.Image on a
    0-255 uint8 array); requires the optional ``swanlab`` package."""

    def __init__(self, project: str = "ptlflow_tpu", run_name: str = None):
        import swanlab  # optional dependency

        self.run = swanlab.init(project=project, experiment_name=run_name)
        self._swanlab = swanlab

    def log_scalars(self, scalars: Dict[str, float], step: int):
        self.run.log({k: float(v) for k, v in scalars.items()}, step=step)

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int):
        img = image_hwc
        if img.dtype != np.uint8:
            img = (255 * np.clip(img, 0, 1)).astype(np.uint8)
        # reference replaces '/' (logger.py:128)
        self.run.log({tag.replace("/", "-"): self._swanlab.Image(img)},
                     step=step)

    def flush(self):
        pass

    def close(self):
        self.run.finish()


_BACKENDS = {
    "tensorboard": lambda log_dir, project: TensorBoardLogger(log_dir),
    "wandb": lambda log_dir, project: WandbLogger(project=project),
    "comet": lambda log_dir, project: CometLogger(project=project),
    "neptune": lambda log_dir, project: NeptuneLogger(),
    "swanlab": lambda log_dir, project: SwanLabLogger(project=project),
}


class MultiLogger:
    """Fan-out to several backends — the 5 the reference LoggerCallback
    dispatches to (TB/W&B/Comet/Neptune/SwanLab, logger.py:56-131);
    backends whose package is missing are skipped with a notice."""

    def __init__(self, log_dir: str, backends=("tensorboard",),
                 project: str = "ptlflow_tpu"):
        self.loggers = []
        for b in backends:
            try:
                if b not in _BACKENDS:
                    raise ImportError(
                        f"unknown backend {b!r}; available: "
                        f"{sorted(_BACKENDS)}")
                self.loggers.append(_BACKENDS[b](log_dir, project))
            except ImportError as e:
                print(f"[logger] backend '{b}' unavailable: {e}")

    def log_scalars(self, scalars: Dict[str, float], step: int):
        for lg in self.loggers:
            lg.log_scalars(scalars, step)

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int):
        for lg in self.loggers:
            lg.log_image(tag, image_hwc, step)

    def flush(self):
        for lg in self.loggers:
            lg.flush()

    def close(self):
        for lg in self.loggers:
            lg.close()


def make_flow_grid(image_bgr: np.ndarray, pred_flow: np.ndarray,
                   gt_flow: Optional[np.ndarray] = None,
                   max_height: int = 400) -> np.ndarray:
    """Stacked visualization: image / pred flow / gt flow / EPE map
    (reference LoggerCallback._make_image_grid, logger.py:428-460).

    image_bgr: (H, W, 3) in [0, 1]; flows: (H, W, 2).
    """
    rows = [np.clip(image_bgr[..., ::-1] * 255, 0, 255).astype(np.uint8)]
    max_radius = None
    if gt_flow is not None:
        valid = ~np.isnan(gt_flow[..., 0])
        if valid.any():
            max_radius = float(np.nanmax(
                np.linalg.norm(np.nan_to_num(gt_flow), axis=-1)))
    rows.append(flow_to_rgb(pred_flow, flow_max_radius=max_radius))
    if gt_flow is not None:
        rows.append(flow_to_rgb(gt_flow, flow_max_radius=max_radius))
        epe = np.linalg.norm(pred_flow - np.nan_to_num(gt_flow), axis=-1)
        epe = np.clip(epe / 5.0, 0, 1)
        epe_rgb = (np.stack([epe, epe, epe], axis=-1) * 255).astype(np.uint8)
        rows.append(epe_rgb)
    grid = np.concatenate(rows, axis=0)
    if grid.shape[0] > max_height * len(rows):
        stride = int(np.ceil(grid.shape[0] / (max_height * len(rows))))
        grid = grid[::stride, ::stride]
    return grid


class ImageSampler:
    """Uniformly sample up to N batches per epoch for image logging
    (logger.py:100-132)."""

    def __init__(self, num_images: int = 5, epoch_size: int = 1000):
        self.num_images = num_images
        self.stride = max(epoch_size // max(num_images, 1), 1)

    def should_log(self, batch_idx: int) -> bool:
        return batch_idx % self.stride == 0 and \
            batch_idx // self.stride < self.num_images
