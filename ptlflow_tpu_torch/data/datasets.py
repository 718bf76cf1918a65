"""Flow datasets: path-list driven loaders for the standard benchmarks.

Behavioral parity with ptlflow's ptlflow/data/datasets.py:35-2650:
- samples are dicts of NCHW float32 numpy arrays {images, flows, valids,
  occs, mbs, flows_b, ..., meta}; N = frames per key;
- valid-mask synthesis: NaNs and |flow| >= max_flow are marked invalid and
  the flow clipped (datasets.py:220-259);
- sequence extension by seq_position first/middle/last/all
  (datasets.py:261-289).

A copy of ``ptlflow_tpu/data/datasets.py`` that decodes images through
``utils/image_io.py`` (numpy and zlib) in place of OpenCV.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..utils import flow_io, image_io


class BaseFlowDataset:
    """Path-list driven dataset. Indexable, returns numpy dicts."""

    def __init__(self, dataset_name: str, split_name: str = "",
                 transform: Optional[Callable] = None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_occlusion_mask: bool = True,
                 get_motion_boundary_mask: bool = True,
                 get_backward: bool = True, get_meta: bool = True):
        self.dataset_name = dataset_name
        self.split_name = split_name
        self.transform = transform
        self.max_flow = max_flow
        self.get_valid_mask = get_valid_mask
        self.get_occlusion_mask = get_occlusion_mask
        self.get_motion_boundary_mask = get_motion_boundary_mask
        self.get_backward = get_backward
        self.get_meta = get_meta

        self.img_paths: List[List[str]] = []
        self.flow_paths: List[List[str]] = []
        self.occ_paths: List[List[str]] = []
        self.mb_paths: List[List[str]] = []
        self.flow_b_paths: List[List[str]] = []
        self.occ_b_paths: List[List[str]] = []
        self.mb_b_paths: List[List[str]] = []
        self.metadata: List[Any] = []
        self.flow_format: Optional[str] = None
        self.is_two_file_flow = False

    # ------------------------------------------------------------------ core
    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        inputs: Dict[str, Any] = {}
        images = [image_io.imread(p) for p in self.img_paths[index]]
        inputs["images"] = images

        if index < len(self.flow_paths):
            flows, valids = self._get_flows_and_valids(self.flow_paths[index])
            inputs["flows"] = flows
            if self.get_valid_mask:
                inputs["valids"] = valids

        if self.get_occlusion_mask:
            if index < len(self.occ_paths):
                occs = []
                for p in self.occ_paths[index]:
                    occs.append(np.load(p)[:, :, None]
                                if str(p).endswith("npy") else _imread_gray(p))
                inputs["occs"] = occs
            elif self.dataset_name.startswith("KITTI") and "flows" in inputs:
                noc_paths = [str(p).replace("flow_occ", "flow_noc")
                             for p in self.flow_paths[index]]
                if all(Path(p).exists() for p in noc_paths):
                    _, valids_noc = self._get_flows_and_valids(noc_paths)
                    inputs["occs"] = [
                        inputs["valids"][i] - valids_noc[i]
                        for i in range(len(valids_noc))]
        if self.get_motion_boundary_mask and index < len(self.mb_paths):
            inputs["mbs"] = [_imread_gray(p) for p in self.mb_paths[index]]

        if self.get_backward:
            if index < len(self.flow_b_paths):
                flows_b, valids_b = self._get_flows_and_valids(
                    self.flow_b_paths[index])
                inputs["flows_b"] = flows_b
                if self.get_valid_mask:
                    inputs["valids_b"] = valids_b
            if self.get_occlusion_mask and index < len(self.occ_b_paths):
                inputs["occs_b"] = [_imread_gray(p)
                                    for p in self.occ_b_paths[index]]
            if self.get_motion_boundary_mask and index < len(self.mb_b_paths):
                inputs["mbs_b"] = [_imread_gray(p)
                                   for p in self.mb_b_paths[index]]

        inputs = _to_tensor_dict(inputs)
        if self.transform is not None:
            inputs = self.transform(inputs)

        if self.get_meta:
            meta = {"dataset_name": self.dataset_name,
                    "split_name": self.split_name}
            if index < len(self.metadata):
                meta.update(self.metadata[index])
            inputs["meta"] = meta
        return inputs

    def _get_flows_and_valids(self, flow_paths: Sequence[Any]):
        flows, valids = [], []
        for path in flow_paths:
            if self.is_two_file_flow:
                fx = -flow_io.flow_read(path[0], format=self.flow_format)
                fy = -flow_io.flow_read(path[1], format=self.flow_format)
                flow = np.stack([fx, fy], 2)
            else:
                flow = flow_io.flow_read(path, format=self.flow_format)
            nan_mask = np.isnan(flow)
            flow[nan_mask] = self.max_flow + 1
            if self.get_valid_mask:
                valid = (np.abs(flow) < self.max_flow).astype(np.uint8) * 255
                valid = np.minimum(valid[:, :, 0], valid[:, :, 1])
                valids.append(valid[:, :, None])
            flow[nan_mask] = 0
            flows.append(np.clip(flow, -self.max_flow, self.max_flow))
        return flows, valids

    def _extend_paths_list(self, paths_list, sequence_length: int,
                           sequence_position: str):
        if sequence_position == "first":
            begin_pad, end_pad = 0, sequence_length - 2
        elif sequence_position == "middle":
            begin_pad = sequence_length // 2
            end_pad = int(math.ceil(sequence_length / 2.0)) - 2
        elif sequence_position == "last":
            begin_pad, end_pad = sequence_length - 2, 0
        elif sequence_position == "all":
            begin_pad, end_pad = 0, 0
        else:
            raise ValueError(f"invalid sequence_position {sequence_position}")
        for _ in range(begin_pad):
            paths_list.insert(0, paths_list[0])
        for _ in range(end_pad):
            paths_list.append(paths_list[-1])
        return paths_list


def _imread_gray(path) -> np.ndarray:
    """An 8-bit mask as (H, W, 1), as ``cv2.imread(path, 0)[:, :, None]``."""
    return image_io.imread(path, image_io.IMREAD_GRAYSCALE)[:, :, None]


def _to_tensor_dict(inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Lists of HWC numpy -> stacked NCHW float32 (images scaled to [0,1])."""
    out = {}
    for k, v in inputs.items():
        if not isinstance(v, list):
            out[k] = v
            continue
        arrs = []
        for a in v:
            a = np.asarray(a)
            if a.ndim == 2:
                a = a[:, :, None]
            a = np.transpose(a, (2, 0, 1)).astype(np.float32)
            arrs.append(a)
        stacked = np.stack(arrs)
        if k == "images":
            stacked = stacked / 255.0
        elif k in ("valids", "occs", "mbs", "valids_b", "occs_b", "mbs_b"):
            stacked = np.clip(stacked / 255.0, 0, 1) if stacked.max() > 1 \
                else stacked
        out[k] = stacked
    return out


# ---------------------------------------------------------------------------
# Concrete datasets
# ---------------------------------------------------------------------------

THIS_DIR = Path(__file__).resolve().parent


def _read_split_file(name: str) -> List[str]:
    p = THIS_DIR / name
    if not p.exists():
        return []
    return [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]


class FlyingChairsDataset(BaseFlowDataset):
    """FlyingChairs: data/NNNNN_{img1,img2,flow}.{ppm,flo}
    (reference datasets.py:378-477, split via FlyingChairs_train_val.txt)."""

    def __init__(self, root_dir: str, split: str = "train",
                 transform=None, max_flow: float = 10000.0,
                 get_valid_mask: bool = True, get_meta: bool = True):
        super().__init__(dataset_name="FlyingChairs", split_name=split,
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        root = Path(root_dir)
        img1_paths = sorted((root / "data").glob("*img1.ppm"))
        split_file = root / "FlyingChairs_train_val.txt"
        if split_file.exists():
            labels = [int(v) for v in split_file.read_text().split()]
        else:
            labels = [1] * len(img1_paths)
        keep = {"train": 1, "val": 2}.get(split)
        for i, p1 in enumerate(img1_paths):
            if keep is not None and i < len(labels) and labels[i] != keep:
                continue
            base = str(p1)[:-8]
            self.img_paths.append([base + "img1.ppm", base + "img2.ppm"])
            self.flow_paths.append([base + "flow.flo"])
            self.metadata.append({
                "image_paths": [base + "img1.ppm", base + "img2.ppm"],
                "is_val": (i < len(labels) and labels[i] == 2),
                "misc": "", "is_seq_start": True})
        self._check()

    def _check(self):
        assert len(self.img_paths) == len(self.flow_paths) or \
            len(self.flow_paths) == 0


class FlyingChairs2Dataset(BaseFlowDataset):
    """FlyingChairs2 with occ/mb/backward (reference datasets.py:477-675)."""

    def __init__(self, root_dir: str, split: str = "train", transform=None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_occlusion_mask: bool = True,
                 get_motion_boundary_mask: bool = True,
                 get_backward: bool = True, get_meta: bool = True):
        super().__init__(dataset_name="FlyingChairs2", split_name=split,
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=get_occlusion_mask,
                         get_motion_boundary_mask=get_motion_boundary_mask,
                         get_backward=get_backward, get_meta=get_meta)
        root = Path(root_dir)
        sdir = root / ("train" if split == "train" else "val")
        img1_paths = sorted(sdir.glob("*img_0.png"))
        for p1 in img1_paths:
            base = str(p1)[:-9]
            self.img_paths.append([base + "img_0.png", base + "img_1.png"])
            self.flow_paths.append([base + "flow_01.flo"])
            if get_occlusion_mask and Path(base + "occ_01.png").exists():
                self.occ_paths.append([base + "occ_01.png"])
            if get_motion_boundary_mask and Path(base + "mb_01.png").exists():
                self.mb_paths.append([base + "mb_01.png"])
            if get_backward and Path(base + "flow_10.flo").exists():
                self.flow_b_paths.append([base + "flow_10.flo"])
                if get_occlusion_mask and Path(base + "occ_10.png").exists():
                    self.occ_b_paths.append([base + "occ_10.png"])
                if get_motion_boundary_mask and Path(base + "mb_10.png").exists():
                    self.mb_b_paths.append([base + "mb_10.png"])
            self.metadata.append({
                "image_paths": [base + "img_0.png", base + "img_1.png"],
                "is_val": split == "val", "misc": "", "is_seq_start": True})


class SintelDataset(BaseFlowDataset):
    """MPI-Sintel (reference datasets.py:1509-1675): clean/final passes,
    sequence support, occlusions, trainval split from Sintel_val.txt."""

    def __init__(self, root_dir: str, split: str = "train",
                 pass_names: Union[str, Sequence[str]] = "clean",
                 side_names: Union[str, Sequence[str]] = (),
                 transform=None, max_flow: float = 10000.0,
                 get_valid_mask: bool = True, get_occlusion_mask: bool = True,
                 get_meta: bool = True, sequence_length: int = 2,
                 sequence_position: str = "first"):
        if isinstance(pass_names, str):
            pass_names = [pass_names]
        super().__init__(
            dataset_name="Sintel",
            split_name=split, transform=transform, max_flow=max_flow,
            get_valid_mask=get_valid_mask,
            get_occlusion_mask=get_occlusion_mask,
            get_motion_boundary_mask=False, get_backward=False,
            get_meta=get_meta)
        root = Path(root_dir)
        split_dir = "test" if split == "test" else "training"
        val_names = set(_read_split_file("Sintel_val.txt"))

        for pass_name in pass_names:
            pass_dir = root / split_dir / pass_name
            if not pass_dir.exists():
                continue
            for seq_dir in sorted(pass_dir.iterdir()):
                if not seq_dir.is_dir():
                    continue
                seq = seq_dir.name
                is_val_seq = seq in val_names
                if split == "train" and is_val_seq:
                    continue
                if split == "val" and not is_val_seq:
                    continue
                imgs = sorted(seq_dir.glob("*.png"))
                imgs = self._extend_paths_list(
                    list(imgs), sequence_length, sequence_position)
                for i in range(len(imgs) - sequence_length + 1):
                    window = imgs[i:i + sequence_length]
                    self.img_paths.append([str(p) for p in window])
                    if split != "test":
                        fl = []
                        oc = []
                        for p in window[:-1]:
                            frame = p.stem
                            fl.append(str(root / split_dir / "flow" / seq /
                                          f"{frame}.flo"))
                            oc.append(str(root / split_dir / "occlusions" /
                                          seq / f"{frame}.png"))
                        self.flow_paths.append(fl)
                        if get_occlusion_mask and all(
                                Path(p).exists() for p in oc):
                            self.occ_paths.append(oc)
                    self.metadata.append({
                        "image_paths": [str(p) for p in window],
                        "is_val": is_val_seq,
                        "misc": seq,
                        "is_seq_start": i == 0})


class KittiDataset(BaseFlowDataset):
    """KITTI 2012/2015 (reference datasets.py:1367-1509): sparse 16-bit png
    flow, image_2/colored_0 conventions, val split files."""

    def __init__(self, root_dir_2012: Optional[str] = None,
                 root_dir_2015: Optional[str] = None,
                 split: str = "train",
                 versions: Union[str, Sequence[str]] = ("2012", "2015"),
                 transform=None, max_flow: float = 10000.0,
                 get_valid_mask: bool = True, get_occlusion_mask: bool = False,
                 get_meta: bool = True):
        if isinstance(versions, str):
            versions = [versions]
        super().__init__(
            dataset_name=f"KITTI_{'_'.join(versions)}",
            split_name=split, transform=transform, max_flow=max_flow,
            get_valid_mask=get_valid_mask,
            get_occlusion_mask=get_occlusion_mask,
            get_motion_boundary_mask=False, get_backward=False,
            get_meta=get_meta)
        roots = {"2012": root_dir_2012, "2015": root_dir_2015}
        img_dirs = {"2012": "colored_0", "2015": "image_2"}
        for version in versions:
            root = roots.get(version)
            if root is None:
                continue
            split_dir = "testing" if split == "test" else "training"
            img_dir = Path(root) / split_dir / img_dirs[version]
            if not img_dir.exists():
                continue
            val_names = set(_read_split_file(f"Kitti{version}_val.txt"))
            img1s = sorted(img_dir.glob("*_10.png"))
            for p1 in img1s:
                name = p1.name
                is_val = name in val_names
                if split == "train" and is_val:
                    continue
                if split == "val" and not is_val:
                    continue
                p2 = p1.parent / name.replace("_10", "_11")
                self.img_paths.append([str(p1), str(p2)])
                if split != "test":
                    self.flow_paths.append([
                        str(Path(root) / split_dir / "flow_occ" / name)])
                self.metadata.append({
                    "image_paths": [str(p1), str(p2)],
                    "is_val": is_val, "misc": version,
                    "is_seq_start": True})


class FlyingThings3DDataset(BaseFlowDataset):
    """FlyingThings3D full version (reference datasets.py:675-977): pfm
    flows, forward/backward, occ/mb, left/right, into_future/into_past."""

    def __init__(self, root_dir: str, split: str = "train",
                 pass_names: Union[str, Sequence[str]] = "clean",
                 side_names: Union[str, Sequence[str]] = "left",
                 add_reverse: bool = True, transform=None,
                 max_flow: float = 1000.0, get_valid_mask: bool = True,
                 get_occlusion_mask: bool = True,
                 get_motion_boundary_mask: bool = True,
                 get_backward: bool = True, get_meta: bool = True,
                 sequence_length: int = 2, sequence_position: str = "first"):
        if isinstance(pass_names, str):
            pass_names = [pass_names]
        if isinstance(side_names, str):
            side_names = [side_names]
        super().__init__(
            dataset_name="FlyingThings3D", split_name=split,
            transform=transform, max_flow=max_flow,
            get_valid_mask=get_valid_mask,
            get_occlusion_mask=get_occlusion_mask,
            get_motion_boundary_mask=get_motion_boundary_mask,
            get_backward=get_backward, get_meta=get_meta)
        pass_dirs = {"clean": "frames_cleanpass", "final": "frames_finalpass"}
        side_dirs = {"left": "left", "right": "right"}
        split_dir = {"train": "TRAIN", "val": "TEST", "test": "TEST"}[split]
        root = Path(root_dir)
        directions = [("into_future", False)]
        if add_reverse:
            directions.append(("into_past", True))
        for pass_name in pass_names:
            for side in side_names:
                base = root / pass_dirs[pass_name] / split_dir
                if not base.exists():
                    continue
                for letter_dir in sorted(base.iterdir()):
                    for seq_dir in sorted(letter_dir.iterdir()):
                        img_dir = seq_dir / side_dirs[side]
                        imgs = sorted(img_dir.glob("*.png"))
                        rel = seq_dir.relative_to(root / pass_dirs[pass_name])
                        for direction, reverse in directions:
                            seq_imgs = imgs[::-1] if reverse else imgs
                            seq_imgs = self._extend_paths_list(
                                list(seq_imgs), sequence_length,
                                sequence_position)
                            for i in range(len(seq_imgs) - sequence_length + 1):
                                window = seq_imgs[i:i + sequence_length]
                                fl, oc, mb, flb, ocb, mbb = \
                                    [], [], [], [], [], []
                                ok = True
                                for p in window[:-1]:
                                    frame = p.stem
                                    f = (root / "optical_flow" / rel /
                                         direction / side_dirs[side] /
                                         f"OpticalFlowInto{'Past' if reverse else 'Future'}_{frame}_{'R' if side == 'right' else 'L'}.pfm")
                                    if not f.exists():
                                        ok = False
                                        break
                                    fl.append(str(f))
                                    oc.append(str(
                                        root / "occlusions" / rel / direction /
                                        side_dirs[side] / f"{frame}.png"))
                                    mb.append(str(
                                        root / "motion_boundaries" / rel /
                                        direction / side_dirs[side] /
                                        f"{frame}.png"))
                                if not ok:
                                    continue
                                self.img_paths.append(
                                    [str(p) for p in window])
                                self.flow_paths.append(fl)
                                if get_occlusion_mask and all(
                                        Path(p).exists() for p in oc):
                                    self.occ_paths.append(oc)
                                if get_motion_boundary_mask and all(
                                        Path(p).exists() for p in mb):
                                    self.mb_paths.append(mb)
                                self.metadata.append({
                                    "image_paths": [str(p) for p in window],
                                    "is_val": split in ("val",),
                                    "misc": str(rel),
                                    "is_seq_start": i == 0})


class Hd1kDataset(BaseFlowDataset):
    """HD1K (reference datasets.py:1240-1367): png128-ish 16-bit flow."""

    def __init__(self, root_dir: str, split: str = "train", transform=None,
                 max_flow: float = 512.0, get_valid_mask: bool = True,
                 get_meta: bool = True, sequence_length: int = 2,
                 sequence_position: str = "first"):
        super().__init__(dataset_name="HD1K", split_name=split,
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        root = Path(root_dir)
        img_dir = root / "hd1k_input" / "image_2"
        flow_dir = root / "hd1k_flow_gt" / "flow_occ"
        if not img_dir.exists():
            return
        seqs = sorted({p.name.split("_")[0] for p in img_dir.glob("*.png")})
        for seq in seqs:
            imgs = sorted(img_dir.glob(f"{seq}_*.png"))
            imgs = self._extend_paths_list(
                list(imgs), sequence_length, sequence_position)
            for i in range(len(imgs) - sequence_length + 1):
                window = imgs[i:i + sequence_length]
                flows = [flow_dir / p.name for p in window[:-1]]
                if not all(f.exists() for f in flows):
                    continue
                self.img_paths.append([str(p) for p in window])
                self.flow_paths.append([str(f) for f in flows])
                self.metadata.append({
                    "image_paths": [str(p) for p in window],
                    "is_val": False, "misc": seq, "is_seq_start": i == 0})


class SpringDataset(BaseFlowDataset):
    """Spring (reference datasets.py:1675-1967): flo5 flow at 2x image
    resolution (subsampled [::2, ::2]), FW/BW, left/right."""

    def __init__(self, root_dir: str, split: str = "train",
                 side_names: Union[str, Sequence[str]] = "left",
                 add_reverse: bool = False, transform=None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_meta: bool = True, subsample: bool = True,
                 sequence_length: int = 2, sequence_position: str = "first"):
        if isinstance(side_names, str):
            side_names = [side_names]
        super().__init__(dataset_name="Spring", split_name=split,
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        self.subsample = subsample
        root = Path(root_dir)
        split_dir = "test" if split == "test" else "train"
        base = root / split_dir
        if not base.exists():
            return
        for seq_dir in sorted(base.iterdir()):
            if not seq_dir.is_dir():
                continue
            seq = seq_dir.name
            for side in side_names:
                img_dir = seq_dir / f"frame_{side}"
                imgs = sorted(img_dir.glob("*.png"))
                imgs = self._extend_paths_list(
                    list(imgs), sequence_length, sequence_position)
                for i in range(len(imgs) - sequence_length + 1):
                    window = imgs[i:i + sequence_length]
                    fl = []
                    ok = True
                    for p in window[:-1]:
                        frame = p.stem.split("_")[-1]
                        f = (seq_dir / f"flow_FW_{side}" /
                             f"flow_FW_{side}_{frame}.flo5")
                        if split != "test" and not f.exists():
                            ok = False
                            break
                        fl.append(str(f))
                    if not ok:
                        continue
                    self.img_paths.append([str(p) for p in window])
                    if split != "test":
                        self.flow_paths.append(fl)
                    self.metadata.append({
                        "image_paths": [str(p) for p in window],
                        "is_val": False, "misc": f"{seq}_{side}",
                        "is_seq_start": i == 0})

    def _get_flows_and_valids(self, flow_paths):
        flows, valids = super()._get_flows_and_valids(flow_paths)
        if self.subsample:
            flows = [f[::2, ::2] for f in flows]
            valids = [v[::2, ::2] for v in valids]
        return flows, valids


class FlyingThings3DSubsetDataset(BaseFlowDataset):
    """FlyingThings3D subset (reference datasets.py:977-1240):
    <split>/flow/<side>/<direction>/*.flo grouped by consecutive frame
    index, images at <split>/image_<pass>/<side>/NNNNNNN.png, optional
    flow_occlusions/motion_boundaries, optional reverse + backward."""

    def __init__(self, root_dir: str, split: str = "train",
                 pass_names: Union[str, Sequence[str]] = "clean",
                 side_names: Union[str, Sequence[str]] = "left",
                 add_reverse: bool = True, transform=None,
                 max_flow: float = 1000.0, get_valid_mask: bool = True,
                 get_occlusion_mask: bool = True,
                 get_motion_boundary_mask: bool = True,
                 get_backward: bool = True, get_meta: bool = True,
                 sequence_length: int = 2, sequence_position: str = "first"):
        if isinstance(pass_names, str):
            pass_names = [pass_names]
        if isinstance(side_names, str):
            side_names = [side_names]
        super().__init__(dataset_name="FlyingThings3DSubset",
                         split_name=split, transform=transform,
                         max_flow=max_flow, get_valid_mask=get_valid_mask,
                         get_occlusion_mask=get_occlusion_mask,
                         get_motion_boundary_mask=get_motion_boundary_mask,
                         get_backward=get_backward, get_meta=get_meta)
        root = Path(root_dir)
        split_dirs = [split] if split in ("train", "val") else ["train", "val"]
        directions = [("into_future", "into_past", False)]
        if add_reverse:
            directions.append(("into_past", "into_future", True))

        def group_flows(flow_dir, rev):
            flow_paths = sorted(flow_dir.glob("*.flo"), reverse=rev)
            if not flow_paths:
                return []
            groups = [[flow_paths[0]]]
            prev = int(flow_paths[0].stem)
            for p in flow_paths[1:]:
                idx = int(p.stem)
                if abs(idx - prev) == 1:
                    groups[-1].append(p)
                else:
                    groups.append([p])
                prev = idx
            return groups

        for sp in split_dirs:
            has_occ = (root / sp / "flow_occlusions").exists()
            has_mb = (root / sp / "motion_boundaries").exists()
            for pass_name in pass_names:
                for side in side_names:
                    for fwd_dir, bwd_dir, rev in directions:
                        flow_dir = root / sp / "flow" / side / fwd_dir
                        if not flow_dir.exists():
                            continue
                        for flow_group in group_flows(flow_dir, rev):
                            flow_group = self._extend_paths_list(
                                flow_group, sequence_length,
                                sequence_position)
                            step = (sequence_length - 1) \
                                if sequence_position == "all" else 1
                            for i in range(
                                    0, len(flow_group) - sequence_length + 2,
                                    step):
                                fl = flow_group[i:i + sequence_length - 1]
                                self.flow_paths.append([str(p) for p in fl])
                                img_dir = (root / sp / f"image_{pass_name}" /
                                           side)
                                img_paths = [img_dir / (p.stem + ".png")
                                             for p in fl]
                                idx = int(img_paths[0].stem) - 1 if rev \
                                    else int(img_paths[-1].stem) + 1
                                img_paths.append(img_dir / f"{idx:07d}.png")
                                self.img_paths.append(
                                    [str(p) for p in img_paths])
                                if has_occ:
                                    self.occ_paths.append(
                                        [str(p).replace("flow",
                                                        "flow_occlusions")
                                         .replace(".flo", ".png")
                                         for p in fl])
                                if has_mb:
                                    self.mb_paths.append(
                                        [str(p).replace(
                                            "flow", "motion_boundaries")
                                         .replace(".flo", ".png")
                                         for p in fl])
                                self.metadata.append({
                                    "image_paths":
                                        [str(p) for p in img_paths],
                                    "is_val": sp == "val", "misc": "",
                                    "is_seq_start": i == 0})
                        if get_backward:
                            bdir = root / sp / "flow" / side / bwd_dir
                            if not bdir.exists():
                                continue
                            for flow_group in group_flows(bdir, rev):
                                flow_group = self._extend_paths_list(
                                    flow_group, sequence_length,
                                    sequence_position)
                                for i in range(
                                        len(flow_group) - sequence_length
                                        + 2):
                                    fl = flow_group[i:i + sequence_length - 1]
                                    self.flow_b_paths.append(
                                        [str(p) for p in fl])


class AutoFlowDataset(BaseFlowDataset):
    """AutoFlow (reference datasets.py:290-378): static_40k_png_i_of_4 parts,
    im0/im1/forward.flo per sample dir, AutoFlow_val.txt split."""

    def __init__(self, root_dir: str, split: str = "train", transform=None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_meta: bool = True):
        super().__init__(dataset_name="AutoFlow", split_name=split,
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        root = Path(root_dir)
        sample_paths = []
        for i in range(4):
            pdir = root / f"static_40k_png_{i + 1}_of_4"
            if pdir.exists():
                sample_paths.extend(p for p in sorted(pdir.glob("*"))
                                    if p.is_dir())
        val_names = set(_read_split_file("AutoFlow_val.txt"))
        for p in sample_paths:
            is_val = p.stem in val_names
            if split == "train" and is_val:
                continue
            if split == "val" and not is_val:
                continue
            self.img_paths.append([str(p / "im0.png"), str(p / "im1.png")])
            self.flow_paths.append([str(p / "forward.flo")])
            self.metadata.append({
                "image_paths": self.img_paths[-1], "is_val": is_val,
                "misc": p.stem, "is_seq_start": True})


class TartanAirDataset(BaseFlowDataset):
    """TartanAir (reference datasets.py:1967-2102): <seq>/<difficulty>/
    <trajectory>/image_left/*.png + flow/*_flow.npy."""

    def __init__(self, root_dir: str,
                 difficulties: Union[str, Sequence[str]] = ("Easy",),
                 transform=None, max_flow: float = 10000.0,
                 get_valid_mask: bool = True, get_meta: bool = True,
                 sequence_length: int = 2, sequence_position: str = "first"):
        if isinstance(difficulties, str):
            difficulties = [difficulties]
        super().__init__(dataset_name="TartanAir", split_name="trainval",
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        root = Path(root_dir)
        for seq_path in sorted(p for p in root.glob("*") if p.is_dir()):
            for diff in difficulties:
                if not (seq_path / diff).exists():
                    continue
                for traj in sorted(p for p in (seq_path / diff).glob("*")
                                   if p.is_dir()):
                    imgs = sorted((traj / "image_left").glob("*.png"))
                    flows = sorted((traj / "flow").glob("*_flow.npy"))
                    if len(imgs) - 1 != len(flows):
                        continue
                    imgs = self._extend_paths_list(
                        list(imgs), sequence_length, sequence_position)
                    flows = self._extend_paths_list(
                        list(flows), sequence_length, sequence_position)
                    for i in range(len(imgs) - sequence_length + 1):
                        self.img_paths.append(
                            [str(p) for p in imgs[i:i + sequence_length]])
                        self.flow_paths.append(
                            [str(p) for p in
                             flows[i:i + sequence_length - 1]])
                        self.metadata.append({
                            "image_paths": self.img_paths[-1],
                            "is_val": False,
                            "misc": f"{seq_path.name}_{diff}_{traj.name}",
                            "is_seq_start": i == 0})


class MonkaaDataset(BaseFlowDataset):
    """Monkaa (reference datasets.py:2270-2447): frames_{clean,final}pass
    sequences with pfm optical_flow, left/right sides."""

    def __init__(self, root_dir: str,
                 pass_names: Union[str, Sequence[str]] = "clean",
                 side_names: Union[str, Sequence[str]] = "left",
                 transform=None, max_flow: float = 10000.0,
                 get_valid_mask: bool = True, get_meta: bool = True,
                 sequence_length: int = 2, sequence_position: str = "first"):
        if isinstance(pass_names, str):
            pass_names = [pass_names]
        if isinstance(side_names, str):
            side_names = [side_names]
        super().__init__(dataset_name="Monkaa", split_name="trainval",
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        root = Path(root_dir)
        for pass_name in pass_names:
            passd = f"frames_{pass_name}pass"
            pass_path = root / passd
            if not pass_path.exists():
                continue
            for seq_path in sorted(pass_path.glob("*")):
                for side in side_names:
                    imgs = sorted((seq_path / side).glob("*.png"))
                    flow_dir = (root / "optical_flow" / seq_path.name /
                                "into_future" / side)
                    flows = sorted(flow_dir.glob("*.pfm"))
                    if not flows or len(imgs) < sequence_length:
                        continue
                    imgs = self._extend_paths_list(
                        list(imgs), sequence_length, sequence_position)
                    flows = self._extend_paths_list(
                        list(flows), sequence_length, sequence_position)
                    for i in range(min(len(imgs) - sequence_length + 1,
                                       len(flows) - sequence_length + 2)):
                        self.img_paths.append(
                            [str(p) for p in imgs[i:i + sequence_length]])
                        self.flow_paths.append(
                            [str(p) for p in
                             flows[i:i + sequence_length - 1]])
                        self.metadata.append({
                            "image_paths": self.img_paths[-1],
                            "is_val": False,
                            "misc": f"{seq_path.name}_{side}",
                            "is_seq_start": i == 0})


class KubricDataset(BaseFlowDataset):
    """Kubric (reference datasets.py:2447-2559): per-sequence dirs with
    rgba_*.png + forward/backward_flow_*.png scaled by data_ranges.json."""

    def __init__(self, root_dir: str, transform=None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_backward: bool = False, get_meta: bool = True,
                 sequence_length: int = 2, sequence_position: str = "first",
                 max_seq: Optional[int] = None):
        super().__init__(dataset_name="Kubric", split_name="trainval",
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False,
                         get_backward=get_backward, get_meta=get_meta)
        self.flow_format = "kubric_png"
        root = Path(root_dir)
        seq_dirs = sorted(p for p in root.glob("*") if p.is_dir())
        if max_seq is not None:
            seq_dirs = seq_dirs[:max_seq]
        for seq_dir in seq_dirs:
            imgs = sorted(seq_dir.glob("rgba_*.png"))
            flows = sorted(seq_dir.glob("forward_flow_*.png"))[:-1]
            if len(imgs) - 1 != len(flows):
                continue
            imgs = self._extend_paths_list(
                list(imgs), sequence_length, sequence_position)
            flows = self._extend_paths_list(
                list(flows), sequence_length, sequence_position)
            bflows = sorted(seq_dir.glob("backward_flow_*.png"))[1:]
            for i in range(len(imgs) - sequence_length + 1):
                self.img_paths.append(
                    [str(p) for p in imgs[i:i + sequence_length]])
                self.flow_paths.append(
                    [(str(p), "forward_flow") for p in
                     flows[i:i + sequence_length - 1]])
                if get_backward and bflows:
                    self.flow_b_paths.append(
                        [(str(p), "backward_flow") for p in
                         bflows[i:i + sequence_length - 1]])
                self.metadata.append({
                    "image_paths": self.img_paths[-1], "is_val": False,
                    "misc": seq_dir.name, "is_seq_start": i == 0})


class ViperDataset(BaseFlowDataset):
    """VIPER (reference datasets.py:2559-2650): <split>/img/<seq>/*.png +
    <split>/flow/<seq>/*.npz."""

    def __init__(self, root_dir: str, split: str = "train", transform=None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_meta: bool = True):
        super().__init__(dataset_name="Viper", split_name=split,
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        self.flow_format = "viper_npz"
        root = Path(root_dir)
        img_root = root / split / "img"
        flow_root = root / split / "flow"
        if not img_root.exists():
            return
        for seq_dir in sorted(p for p in img_root.glob("*") if p.is_dir()):
            seq = seq_dir.name
            if not (flow_root / seq).exists():
                continue
            for fpath in sorted((flow_root / seq).glob("*.npz")):
                idx = int(fpath.stem.split("_")[1])
                img1 = seq_dir / f"{seq}_{idx:05d}.png"
                img2 = seq_dir / f"{seq}_{idx + 1:05d}.png"
                if not (img1.exists() and img2.exists()):
                    continue
                self.img_paths.append([str(img1), str(img2)])
                self.flow_paths.append([str(fpath)])
                self.metadata.append({
                    "image_paths": self.img_paths[-1], "is_val": False,
                    "misc": seq, "is_seq_start": True})


class MiddleburySTDataset(BaseFlowDataset):
    """Middlebury-ST (reference datasets.py:2200-2270): stereo pairs whose
    'flow' is the two-file negated disparity (disp0.pfm, disp0y.pfm)."""

    def __init__(self, root_dir: str, transform=None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_meta: bool = True):
        super().__init__(dataset_name="MiddleburyST", split_name="trainval",
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        self.is_two_file_flow = True
        root = Path(root_dir)
        for seq_dir in sorted(p for p in root.glob("*") if p.is_dir()):
            im0 = seq_dir / "im0.png"
            im1 = seq_dir / "im1.png"
            d0 = seq_dir / "disp0.pfm"
            d0y = seq_dir / "disp0y.pfm"
            if not all(p.exists() for p in (im0, im1, d0, d0y)):
                continue
            self.img_paths.append([str(im0), str(im1)])
            self.flow_paths.append([(str(d0), str(d0y))])
            self.metadata.append({
                "image_paths": self.img_paths[-1], "is_val": False,
                "misc": seq_dir.name, "is_seq_start": True})


class MiddleburyDataset(BaseFlowDataset):
    """Middlebury training set (reference datasets.py:2102-2200)."""

    def __init__(self, root_dir: str, split: str = "train", transform=None,
                 max_flow: float = 10000.0, get_valid_mask: bool = True,
                 get_meta: bool = True):
        super().__init__(dataset_name="Middlebury", split_name=split,
                         transform=transform, max_flow=max_flow,
                         get_valid_mask=get_valid_mask,
                         get_occlusion_mask=False,
                         get_motion_boundary_mask=False, get_backward=False,
                         get_meta=get_meta)
        root = Path(root_dir)
        flow_root = root / "other-gt-flow"
        img_root = root / "other-data"
        if not flow_root.exists():
            return
        for seq_dir in sorted(flow_root.iterdir()):
            if not seq_dir.is_dir():
                continue
            seq = seq_dir.name
            f = seq_dir / "flow10.flo"
            i1 = img_root / seq / "frame10.png"
            i2 = img_root / seq / "frame11.png"
            if f.exists() and i1.exists() and i2.exists():
                self.img_paths.append([str(i1), str(i2)])
                self.flow_paths.append([str(f)])
                self.metadata.append({
                    "image_paths": [str(i1), str(i2)], "is_val": False,
                    "misc": seq, "is_seq_start": True})
