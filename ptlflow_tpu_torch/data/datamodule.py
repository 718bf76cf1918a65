"""FlowDataModule (``ptlflow_tpu/data/datamodule.py``): the dataset-selection
mini-language and the canonical training recipes.

- selection strings like
  "chairs-train+3*sintel-clean-trainval+kitti-2015-train*5"
  (``parse_dataset_selection``);
- per-dataset factories encode the canonical RAFT-style augmentation recipes
  and crop sizes, including the ``sintel_finetune`` mixture and the
  single-sample ``overfit`` set;
- dataset roots from ``datasets.yaml`` (read without PyYAML), overridable
  per dataset with ``<key>_root_dir``;
- the train loader shuffles and batches numpy dicts (a torch ``DataLoader``
  with ``numpy_collate`` when ``train_num_workers > 0``, else
  ``SimpleLoader`` in the main process); with ``train_transform_cuda`` the
  augmentations run on the card (``device_transforms.DeviceCompose``) in
  the main process; validation and test loaders run batch 1 over
  un-augmented samples.
"""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader

from ..utils import yaml_subset
from . import transforms as ft
from .datasets import (
    BaseFlowDataset, AutoFlowDataset, FlyingChairsDataset,
    FlyingChairs2Dataset, FlyingThings3DDataset,
    FlyingThings3DSubsetDataset, Hd1kDataset, KittiDataset, KubricDataset,
    MiddleburyDataset, MiddleburySTDataset, MonkaaDataset, SintelDataset,
    SpringDataset, TartanAirDataset, ViperDataset,
)


def make_divisible(v: int, div: int) -> int:
    """Reference utils.make_divisible (utils.py:291): round up to multiple."""
    if div <= 1:
        return v
    return max(div, int(math.ceil(v / div)) * div)


def numpy_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of samples: numpy arrays with ``np.stack``, tensors
    (``DeviceCompose``'s output, on the card) with ``torch.stack``, and
    ``meta`` into lists."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if k == "meta":
            out["meta"] = {
                mk: [s["meta"].get(mk) for s in samples]
                for mk in samples[0]["meta"]
            }
        elif isinstance(samples[0][k], torch.Tensor):
            out[k] = torch.stack([s[k] for s in samples])
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[d][idx - int(self._offsets[d])]


class RepeatedDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


class SimpleLoader:
    """Minimal shuffling batch iterator over an indexable dataset."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield numpy_collate([self.dataset[j] for j in chunk])


class FlowDataModule:
    DATASET_KEYS = (
        "autoflow", "flying_chairs", "flying_chairs2", "flying_things3d",
        "flying_things3d_subset", "mpi_sintel", "kitti_2012", "kitti_2015",
        "hd1k", "tartanair", "spring", "kubric", "middlebury",
        "middlebury_st", "monkaa", "viper",
    )

    def __init__(self,
                 train_dataset: Optional[str] = None,
                 val_dataset: Optional[str] = None,
                 test_dataset: Optional[str] = None,
                 predict_dataset: Optional[str] = None,
                 train_batch_size: int = 8,
                 train_num_workers: int = 4,
                 train_crop_size: Optional[Tuple[int, int]] = None,
                 train_transform_cuda: bool = False,
                 train_transform_fp16: bool = False,
                 dataset_config_path: str = "./datasets.yaml",
                 output_stride: int = 8,
                 **root_dir_overrides):
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.train_transform_cuda = train_transform_cuda
        self.train_transform_fp16 = train_transform_fp16
        self.test_dataset = test_dataset
        self.predict_dataset = predict_dataset
        self.train_batch_size = train_batch_size
        self.train_num_workers = train_num_workers
        self.train_crop_size = train_crop_size
        self.dataset_config_path = dataset_config_path
        self.output_stride = output_stride

        for key in self.DATASET_KEYS:
            setattr(self, f"{key}_root_dir",
                    root_dir_overrides.get(f"{key}_root_dir"))
        self._load_dataset_paths()

        self.train_data = None
        self.val_data: List = []
        self.val_dataset_names: List[str] = []
        self.test_data: List = []
        self.test_dataset_names: List[str] = []

    # ------------------------------------------------------------ path config
    def _load_dataset_paths(self):
        p = Path(self.dataset_config_path)
        if not p.exists():
            return
        dataset_paths = yaml_subset.load(p) or {}
        for name, path in dataset_paths.items():
            attr = f"{name}_root_dir"
            if hasattr(self, attr) and getattr(self, attr) is None:
                setattr(self, attr, path)

    # --------------------------------------------------------------- parsing
    @staticmethod
    def parse_dataset_selection(dataset_selection: str):
        """'chairs-train+3*sintel-clean' -> [(1,'chairs','train'),
        (3,'sintel','clean')] (flow_datamodule.py:254-302)."""
        if dataset_selection is None:
            return []
        dataset_selection = dataset_selection.replace(" ", "")
        parsed = []
        for token in dataset_selection.split("+"):
            parts = token.split("*")
            if len(parts) == 1:
                parsed.append((1,) + tuple(parts[0].split("-")))
            elif len(parts) == 2:
                try:
                    mult, params = int(parts[0]), parts[1]
                except ValueError:
                    params, mult = parts[0], int(parts[1])
                parsed.append((mult,) + tuple(params.split("-")))
            else:
                raise ValueError(f"invalid dataset string '{token}'")
        return parsed

    # ----------------------------------------------------------------- setup
    def setup(self, stage: Optional[str] = None):
        if stage in (None, "fit") and self.train_dataset is not None:
            parts = []
            for sel in self.parse_dataset_selection(self.train_dataset):
                mult, name, *args = sel
                ds = self._get_dataset(True, name, *args)
                parts.append(RepeatedDataset(ds, mult) if mult > 1 else ds)
            self.train_data = parts[0] if len(parts) == 1 \
                else ConcatDataset(parts)
        if stage in (None, "fit", "validate") and self.val_dataset is not None:
            self.val_data = []
            self.val_dataset_names = []
            for sel in self.parse_dataset_selection(self.val_dataset):
                mult, name, *args = sel
                self.val_data.append(self._get_dataset(False, name, *args))
                self.val_dataset_names.append("-".join([name] + list(args)))
        if stage in (None, "test") and self.test_dataset is not None:
            self.test_data = []
            self.test_dataset_names = []
            for sel in self.parse_dataset_selection(self.test_dataset):
                mult, name, *args = sel
                self.test_data.append(self._get_dataset(False, name, *args))
                self.test_dataset_names.append("-".join([name] + list(args)))

    # --------------------------------------------------------------- loaders
    def train_dataloader(self):
        """Shuffled batches of ``train_batch_size``, the last partial one
        dropped: a torch ``DataLoader`` whose workers (persistent, started
        by ``spawn``: this process may hold threads, which ``fork`` does not
        carry over safely) decode and augment, or, with no workers,
        ``SimpleLoader`` in this process."""
        if self.train_data is None:
            raise RuntimeError("train_dataloader() needs setup('fit') with "
                               "a train_dataset")
        if self.train_transform_cuda:
            # the card's transform runs in the main process: worker
            # processes must not touch the card (the reference pins workers
            # too, flow_datamodule.py:208-216)
            if self.train_num_workers:
                print("train_transform_cuda: forcing train_num_workers=0")
            self.train_num_workers = 0
        if self.train_num_workers and self.train_num_workers > 0:
            return DataLoader(
                self.train_data, batch_size=self.train_batch_size,
                shuffle=True, num_workers=self.train_num_workers,
                collate_fn=numpy_collate, drop_last=True,
                persistent_workers=True, multiprocessing_context="spawn")
        return SimpleLoader(self.train_data,
                            batch_size=self.train_batch_size, shuffle=True,
                            drop_last=True)

    def val_dataloader(self):
        return [SimpleLoader(d, batch_size=1) for d in self.val_data]

    def test_dataloader(self):
        return [SimpleLoader(d, batch_size=1) for d in self.test_data]

    # ------------------------------------------------------------- factories
    def _get_dataset(self, is_train: bool, name: str, *args) -> Any:
        fn = getattr(self, f"_get_{name}_dataset", None)
        if fn is None:
            raise ValueError(f"unknown dataset '{name}'")
        ds = fn(is_train, *args)
        if (is_train and self.train_transform_cuda
                and isinstance(getattr(ds, "transform", None), ft.Compose)):
            # the reference's train_transform_cuda (flow_datamodule.py:318):
            # the whole Compose as torch ops on the card; pipelines with no
            # device form (sparse scatter resize) keep the numpy path
            from .device_transforms import DeviceCompose

            max_frames = max(2, int(getattr(ds, "sequence_length", 2) or 2))
            out_dtype = torch.bfloat16 if self.train_transform_fp16 else None
            dev = DeviceCompose.from_compose(ds.transform,
                                             max_frames=max_frames,
                                             out_dtype=out_dtype)
            if dev is not None:
                ds.transform = dev
            else:
                print(f"[{name}] train_transform_cuda: pipeline has no "
                      f"device equivalent (sparse resize); using numpy")
        return ds

    def _crop(self, default_hw: Tuple[int, int]) -> Tuple[int, int]:
        md = make_divisible
        if self.train_crop_size is None:
            return (md(default_hw[0], self.output_stride),
                    md(default_hw[1], self.output_stride))
        return (md(self.train_crop_size[0], self.output_stride),
                md(self.train_crop_size[1], self.output_stride))

    @staticmethod
    def _seq_args(args):
        kw = {}
        rest = []
        for v in args:
            if isinstance(v, str) and v.startswith("seqlen"):
                kw["sequence_length"] = int(v.split("_")[1])
            elif isinstance(v, str) and v.startswith("seqpos"):
                kw["sequence_position"] = v.split("_")[1]
            else:
                rest.append(v)
        return kw, rest

    # RAFT-style canonical recipes (flow_datamodule.py factories)
    def _get_chairs_dataset(self, is_train: bool, *args):
        split = "trainval"
        for v in args:
            if v in ("train", "val", "trainval"):
                split = v
        if is_train:
            cy, cx = self._crop((368, 496))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.1, 1.0), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.1),
            ])
        else:
            transform = None
        return FlyingChairsDataset(self.flying_chairs_root_dir, split=split,
                                   transform=transform)

    def _get_chairs2_dataset(self, is_train: bool, *args):
        split = "train"
        add_occ = False
        for v in args:
            if v in ("train", "val"):
                split = v
            elif v == "occ":
                add_occ = True
        if is_train:
            cy, cx = self._crop((368, 496))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.1, 1.0), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.1),
            ])
        else:
            transform = None
        return FlyingChairs2Dataset(
            self.flying_chairs2_root_dir, split=split, transform=transform,
            get_occlusion_mask=add_occ, get_motion_boundary_mask=add_occ,
            get_backward=add_occ)

    def _get_things_dataset(self, is_train: bool, *args):
        pass_names = ["clean", "final"]
        split = "train"
        side_names = ["left", "right"]
        seq_kw, rest = self._seq_args(args)
        for v in rest:
            if v in ("clean", "final"):
                pass_names = [v]
            elif v in ("train", "val", "test"):
                split = v
            elif v in ("left", "right"):
                side_names = [v]
        if is_train:
            cy, cx = self._crop((400, 720))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.4, 0.8), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.1),
            ])
        else:
            transform = None
        return FlyingThings3DDataset(
            self.flying_things3d_root_dir, split=split, pass_names=pass_names,
            side_names=side_names, transform=transform, **seq_kw)

    def _get_sintel_dataset(self, is_train: bool, *args):
        pass_names = ["clean", "final"]
        split = "trainval"
        get_occ = False
        seq_kw, rest = self._seq_args(args)
        for v in rest:
            if v in ("clean", "final"):
                pass_names = [v]
            elif v in ("train", "val", "trainval", "test"):
                split = v
            elif v == "occ":
                get_occ = True
        if is_train:
            cy, cx = self._crop((368, 768))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.2, 0.6), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.1),
            ])
        else:
            transform = None
        return SintelDataset(
            self.mpi_sintel_root_dir, split=split, pass_names=pass_names,
            transform=transform, get_occlusion_mask=get_occ, **seq_kw)

    def _get_kitti_dataset(self, is_train: bool, *args):
        versions = ["2012", "2015"]
        split = "trainval"
        for v in args:
            if v in ("2012", "2015"):
                versions = [v]
            elif v in ("train", "val", "trainval", "test"):
                split = v
        if is_train:
            cy, cx = self._crop((288, 960))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.2, 0.4), (-0.2, 0.2),
                                      sparse=True),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.0),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.0),
            ])
        else:
            transform = None
        return KittiDataset(
            self.kitti_2012_root_dir, self.kitti_2015_root_dir,
            versions=versions, split=split, transform=transform)

    def _get_hd1k_dataset(self, is_train: bool, *args):
        seq_kw, rest = self._seq_args(args)
        split = "trainval"
        for v in rest:
            if v in ("train", "val", "trainval", "test"):
                split = v
        if is_train:
            cy, cx = self._crop((368, 768))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.5, 0.2), (-0.2, 0.2),
                                      sparse=True),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.0),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.0),
            ])
        else:
            transform = None
        return Hd1kDataset(self.hd1k_root_dir, split=split,
                           transform=transform, **seq_kw)

    def _get_spring_dataset(self, is_train: bool, *args):
        seq_kw, rest = self._seq_args(args)
        split = "train"
        side_names = ["left"]
        subsample = True
        for v in rest:
            if v in ("train", "val", "test"):
                split = v
            elif v in ("left", "right"):
                side_names = [v]
            elif v == "4k":
                subsample = False
        if is_train:
            cy, cx = self._crop((368, 768))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.2, 0.6), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.1),
            ])
        else:
            transform = None
        return SpringDataset(self.spring_root_dir, split=split,
                             side_names=side_names, transform=transform,
                             subsample=subsample, **seq_kw)

    def _get_middlebury_dataset(self, is_train: bool, *args):
        return MiddleburyDataset(self.middlebury_root_dir)

    def _get_autoflow_dataset(self, is_train: bool, *args):
        split = "trainval"
        for v in args:
            if v in ("train", "val", "trainval"):
                split = v
        if is_train:
            cy, cx = self._crop((368, 496))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.1, 1.0), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.1),
            ])
        else:
            transform = None
        return AutoFlowDataset(self.autoflow_root_dir, split=split,
                               transform=transform)

    def _get_things_subset_dataset(self, is_train: bool, *args):
        pass_names = ["clean"]
        split = "train"
        seq_kw, rest = self._seq_args(args)
        for v in rest:
            if v in ("clean", "final"):
                pass_names = [v]
            elif v in ("train", "val", "trainval"):
                split = v
        if is_train:
            cy, cx = self._crop((400, 720))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.4, 0.8), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.GaussianNoise(0.02),
                ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
                ft.RandomFlip(0.5, 0.1),
            ])
        else:
            transform = None
        return FlyingThings3DSubsetDataset(
            self.flying_things3d_subset_root_dir, split=split,
            pass_names=pass_names, transform=transform, **seq_kw)

    def _get_tartanair_dataset(self, is_train: bool, *args):
        seq_kw, rest = self._seq_args(args)
        difficulties = [v for v in rest if v in ("Easy", "Hard")] or ["Easy"]
        transform = None
        if is_train:
            cy, cx = self._crop((360, 480))
            transform = ft.Compose([
                ft.RandomScaleAndCrop((cy, cx), (-0.2, 0.6), (-0.2, 0.2)),
                ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
                ft.RandomFlip(0.5, 0.1),
            ])
        return TartanAirDataset(self.tartanair_root_dir,
                                difficulties=difficulties,
                                transform=transform, **seq_kw)

    def _get_kubric_dataset(self, is_train: bool, *args):
        seq_kw, rest = self._seq_args(args)
        get_backward = "back" in rest
        max_seq = None
        for v in rest:
            if isinstance(v, str) and v.startswith("maxseq"):
                max_seq = int(v.split("_")[1])
        return KubricDataset(self.kubric_root_dir, get_backward=get_backward,
                             max_seq=max_seq, **seq_kw)

    def _get_monkaa_dataset(self, is_train: bool, *args):
        seq_kw, rest = self._seq_args(args)
        pass_names = [v for v in rest if v in ("clean", "final")] or ["clean"]
        side_names = [v for v in rest if v in ("left", "right")] or ["left"]
        return MonkaaDataset(self.monkaa_root_dir, pass_names=pass_names,
                             side_names=side_names, **seq_kw)

    def _get_middlebury_st_dataset(self, is_train: bool, *args):
        return MiddleburySTDataset(self.middlebury_st_root_dir)

    def _get_viper_dataset(self, is_train: bool, *args):
        split = "train"
        for v in args:
            if v in ("train", "val", "test"):
                split = v
        return ViperDataset(self.viper_root_dir, split=split)

    def _get_sintel_finetune_dataset(self, is_train: bool, *args):
        """The canonical RAFT sintel-finetune mixture
        (flow_datamodule.py:756-935): things(clean) + sintel-clean*M +
        sintel-final*M + kitti2015*K + hd1k*H, where (M, K, H) =
        (100, 200, 5) by default or (20, 80, 30) with the ``searaft_split``
        arg (SEA-RAFT's TSKH mixture).  ``fbocc`` appends the
        forward-backward occlusion-check transform, as in the reference.

        Note: the reference's dpflow-train3 config selects
        ``sintel-searaft_split``, which its own ``_get_sintel_dataset``
        rejects (flow_datamodule.py:693-706 ``raise ValueError``); the
        working selector is ``sintel_finetune-searaft_split``.
        """
        if not is_train:
            raise ValueError("sintel_finetune is a training mixture")
        fbocc = False
        searaft = False
        for v in args:
            if v == "fbocc":
                fbocc = True
            elif v == "searaft_split":
                searaft = True
            else:
                raise ValueError(f"Invalid arg: {v}")

        cy, cx = self._crop((368, 768))
        fb = [ft.GenerateFBCheckFlowOcclusion(threshold=1)] if fbocc else []
        # Dense parts (things + both sintel passes); no GaussianNoise in the
        # finetune recipe (flow_datamodule.py:788-803).
        transform1 = ft.Compose([
            ft.RandomScaleAndCrop((cy, cx), (-0.2, 0.6), (-0.2, 0.2)),
            ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
            ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
            ft.RandomFlip(0.5, 0.1),
        ] + fb)
        transform2 = ft.Compose([
            ft.RandomScaleAndCrop((cy, cx), (-0.3, 0.5), (-0.2, 0.2),
                                  sparse=True),
            ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
            ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
            ft.RandomFlip(0.5, 0.1),
        ] + fb)
        transform3 = ft.Compose([
            ft.RandomScaleAndCrop((cy, cx), (-0.5, 0.2), (-0.2, 0.2),
                                  sparse=True),
            ft.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
            ft.RandomPatchEraser(0.5, ((50, 100), (50, 100)), 3, "mean"),
            ft.RandomFlip(0.5, 0.1),
        ] + fb)

        things = FlyingThings3DDataset(
            self.flying_things3d_root_dir, split="train",
            pass_names=["clean"], side_names=["left"], transform=transform1)
        sintel_clean = SintelDataset(
            self.mpi_sintel_root_dir, split="trainval", pass_names=["clean"],
            transform=transform1)
        sintel_final = SintelDataset(
            self.mpi_sintel_root_dir, split="trainval", pass_names=["final"],
            transform=transform1)
        kitti = KittiDataset(
            self.kitti_2012_root_dir, self.kitti_2015_root_dir,
            versions=["2015"], split="trainval", transform=transform2)
        hd1k = Hd1kDataset(self.hd1k_root_dir, split="trainval",
                           transform=transform3)
        parts = [
            things,
            RepeatedDataset(sintel_clean, 20 if searaft else 100),
            RepeatedDataset(sintel_final, 20 if searaft else 100),
            RepeatedDataset(kitti, 80 if searaft else 200),
            RepeatedDataset(hd1k, 30 if searaft else 5),
        ]
        usable = [p for p in parts if len(p) > 0]
        return ConcatDataset(usable)

    def _get_overfit_dataset(self, is_train: bool, *args):
        """Single-sample overfit set (flow_datamodule.py:1233-1283)."""
        dataset = self._get_sintel_dataset(False, "clean", "trainval")
        cy, cx = self._crop((436, 1024))
        transform = ft.Resize((cy, cx))
        dataset.transform = transform
        dataset.img_paths = dataset.img_paths[:1]
        dataset.flow_paths = dataset.flow_paths[:1]
        dataset.metadata = dataset.metadata[:1]
        return dataset
