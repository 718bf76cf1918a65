"""FlowDataModule (``ptlflow_tpu/data/datamodule.py``): the dataset-selection
mini-language and the validate and test stages.

- selection strings like "sintel-clean-trainval+kitti-2015-trainval"
  (``parse_dataset_selection``);
- dataset roots from ``datasets.yaml`` (read without PyYAML), overridable
  per dataset with ``<key>_root_dir``;
- validation and test loaders run batch 1 over un-augmented samples.

Training datasets need the augmentations of ``ptlflow_tpu/data/
transforms.py`` and ``device_transforms.py``, which the port does not have
yet: selecting one raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import yaml_subset
from .datasets import (
    AutoFlowDataset, FlyingChairsDataset, FlyingChairs2Dataset,
    FlyingThings3DDataset, FlyingThings3DSubsetDataset, Hd1kDataset,
    KittiDataset, KubricDataset, MiddleburyDataset, MiddleburySTDataset,
    MonkaaDataset, SintelDataset, SpringDataset, TartanAirDataset,
    ViperDataset,
)

_NO_TRAINING = ("training datasets need the augmentations of "
                "ptlflow_tpu/data/transforms.py, which the PyTorch port does "
                "not have yet (ROADMAP, queue 1, item 1)")


def make_divisible(v: int, div: int) -> int:
    """Round ``v`` up to a multiple of ``div``."""
    if div <= 1:
        return v
    return max(div, int(math.ceil(v / div)) * div)


def numpy_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if k == "meta":
            out["meta"] = {
                mk: [s["meta"].get(mk) for s in samples]
                for mk in samples[0]["meta"]
            }
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
        self.test_dataset = test_dataset
        self.predict_dataset = predict_dataset
        self.train_batch_size = train_batch_size
        self.train_num_workers = train_num_workers
        self.train_crop_size = train_crop_size
        self.train_transform_cuda = train_transform_cuda
        self.train_transform_fp16 = train_transform_fp16
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
        (3,'sintel','clean')]."""
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
            raise NotImplementedError(_NO_TRAINING)
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
        raise NotImplementedError(_NO_TRAINING)

    def val_dataloader(self):
        return [SimpleLoader(d, batch_size=1) for d in self.val_data]

    def test_dataloader(self):
        return [SimpleLoader(d, batch_size=1) for d in self.test_data]

    # ------------------------------------------------------------- factories
    def _get_dataset(self, is_train: bool, name: str, *args) -> Any:
        if is_train or name in ("sintel_finetune", "overfit"):
            raise NotImplementedError(f"dataset '{name}': {_NO_TRAINING}")
        fn = getattr(self, f"_get_{name}_dataset", None)
        if fn is None:
            raise ValueError(f"unknown dataset '{name}'")
        return fn(*args)

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

    # the JAX package's factories with transform=None (is_train False)
    def _get_chairs_dataset(self, *args):
        split = "trainval"
        for v in args:
            if v in ("train", "val", "trainval"):
                split = v
        return FlyingChairsDataset(self.flying_chairs_root_dir, split=split)

    def _get_chairs2_dataset(self, *args):
        split = "train"
        add_occ = False
        for v in args:
            if v in ("train", "val"):
                split = v
            elif v == "occ":
                add_occ = True
        return FlyingChairs2Dataset(
            self.flying_chairs2_root_dir, split=split,
            get_occlusion_mask=add_occ, get_motion_boundary_mask=add_occ,
            get_backward=add_occ)

    def _get_things_dataset(self, *args):
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
        return FlyingThings3DDataset(
            self.flying_things3d_root_dir, split=split, pass_names=pass_names,
            side_names=side_names, **seq_kw)

    def _get_sintel_dataset(self, *args):
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
        return SintelDataset(
            self.mpi_sintel_root_dir, split=split, pass_names=pass_names,
            get_occlusion_mask=get_occ, **seq_kw)

    def _get_kitti_dataset(self, *args):
        versions = ["2012", "2015"]
        split = "trainval"
        for v in args:
            if v in ("2012", "2015"):
                versions = [v]
            elif v in ("train", "val", "trainval", "test"):
                split = v
        return KittiDataset(
            self.kitti_2012_root_dir, self.kitti_2015_root_dir,
            versions=versions, split=split)

    def _get_hd1k_dataset(self, *args):
        seq_kw, rest = self._seq_args(args)
        split = "trainval"
        for v in rest:
            if v in ("train", "val", "trainval", "test"):
                split = v
        return Hd1kDataset(self.hd1k_root_dir, split=split, **seq_kw)

    def _get_spring_dataset(self, *args):
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
        return SpringDataset(self.spring_root_dir, split=split,
                             side_names=side_names, subsample=subsample,
                             **seq_kw)

    def _get_middlebury_dataset(self, *args):
        return MiddleburyDataset(self.middlebury_root_dir)

    def _get_autoflow_dataset(self, *args):
        split = "trainval"
        for v in args:
            if v in ("train", "val", "trainval"):
                split = v
        return AutoFlowDataset(self.autoflow_root_dir, split=split)

    def _get_things_subset_dataset(self, *args):
        pass_names = ["clean"]
        split = "train"
        seq_kw, rest = self._seq_args(args)
        for v in rest:
            if v in ("clean", "final"):
                pass_names = [v]
            elif v in ("train", "val", "trainval"):
                split = v
        return FlyingThings3DSubsetDataset(
            self.flying_things3d_subset_root_dir, split=split,
            pass_names=pass_names, **seq_kw)

    def _get_tartanair_dataset(self, *args):
        seq_kw, rest = self._seq_args(args)
        difficulties = [v for v in rest if v in ("Easy", "Hard")] or ["Easy"]
        return TartanAirDataset(self.tartanair_root_dir,
                                difficulties=difficulties, **seq_kw)

    def _get_kubric_dataset(self, *args):
        seq_kw, rest = self._seq_args(args)
        get_backward = "back" in rest
        max_seq = None
        for v in rest:
            if isinstance(v, str) and v.startswith("maxseq"):
                max_seq = int(v.split("_")[1])
        return KubricDataset(self.kubric_root_dir, get_backward=get_backward,
                             max_seq=max_seq, **seq_kw)

    def _get_monkaa_dataset(self, *args):
        seq_kw, rest = self._seq_args(args)
        pass_names = [v for v in rest if v in ("clean", "final")] or ["clean"]
        side_names = [v for v in rest if v in ("left", "right")] or ["left"]
        return MonkaaDataset(self.monkaa_root_dir, pass_names=pass_names,
                             side_names=side_names, **seq_kw)

    def _get_middlebury_st_dataset(self, *args):
        return MiddleburySTDataset(self.middlebury_st_root_dir)

    def _get_viper_dataset(self, *args):
        split = "train"
        for v in args:
            if v in ("train", "val", "test"):
                split = v
        return ViperDataset(self.viper_root_dir, split=split)
