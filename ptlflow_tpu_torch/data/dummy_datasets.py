"""Synthetic on-disk dataset replicas for testing (ptlflow's
``utils/dummy_datasets.py``): random images + flows written in each
dataset's exact directory layout and file formats.  A copy of
``ptlflow_tpu/data/dummy_datasets.py`` that writes through ``image_io``
(numpy and zlib) in place of OpenCV; ``write_sintel`` and ``write_kitti``
also take the frames and flows to write (``frames``), so that a tree at full
size can hold content whose motion is known."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import flow_io, image_io


def _rand_img(rng, h, w):
    return rng.randint(0, 256, (h, w, 3), dtype=np.uint8)


def _rand_flow(rng, h, w, scale=5.0):
    return (rng.randn(h, w, 2) * scale).astype(np.float32)


def write_flying_chairs(root: Path, n: int = 3, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "FlyingChairs_release"
    (root / "data").mkdir(parents=True, exist_ok=True)
    labels = []
    for i in range(n):
        base = root / "data" / f"{i + 1:05d}_"
        for tag in ("img1", "img2"):
            image_io.imwrite(str(base) + f"{tag}.ppm", _rand_img(rng, *size))
        flow_io.write_flo(str(base) + "flow.flo", _rand_flow(rng, *size))
        labels.append(1 if i < n - 1 else 2)
    (root / "FlyingChairs_train_val.txt").write_text(
        "\n".join(str(v) for v in labels))
    return root


def write_flying_chairs2(root: Path, n: int = 3, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "FlyingChairs2"
    for split in ("train", "val"):
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            base = root / split / f"{i:07d}-"
            image_io.imwrite(str(base) + "img_0.png", _rand_img(rng, *size))
            image_io.imwrite(str(base) + "img_1.png", _rand_img(rng, *size))
            flow_io.write_flo(str(base) + "flow_01.flo",
                              _rand_flow(rng, *size))
            flow_io.write_flo(str(base) + "flow_10.flo",
                              _rand_flow(rng, *size))
            for tag in ("occ_01", "occ_10", "mb_01", "mb_10"):
                image_io.imwrite(str(base) + f"{tag}.png",
                           rng.randint(0, 2, size, dtype=np.uint8) * 255)
    return root


def write_sintel(root: Path, n_seqs: int = 2, n_frames: int = 3,
                 size=(96, 128), seed=0, frames=None):
    """``frames(seq_idx)``, where given, returns the sequence's
    ``n_frames`` BGR uint8 frames and ``n_frames - 1`` flows (H, W, 2): both
    passes and the test split get those frames, the flows are the GT and
    the occlusion masks are 0; else all are random."""
    rng = np.random.RandomState(seed)
    root = Path(root) / "MPI-Sintel"
    for seq_idx in range(n_seqs):
        seq = f"seq_{seq_idx}"
        given = frames(seq_idx) if frames is not None else None
        for pass_name in ("clean", "final"):
            d = root / "training" / pass_name / seq
            d.mkdir(parents=True, exist_ok=True)
            for f in range(1, n_frames + 1):
                image_io.imwrite(d / f"frame_{f:04d}.png",
                                 _rand_img(rng, *size) if given is None
                                 else given[0][f - 1])
        fd = root / "training" / "flow" / seq
        od = root / "training" / "occlusions" / seq
        fd.mkdir(parents=True, exist_ok=True)
        od.mkdir(parents=True, exist_ok=True)
        for f in range(1, n_frames):
            flow_io.write_flo(fd / f"frame_{f:04d}.flo",
                              _rand_flow(rng, *size) if given is None
                              else given[1][f - 1])
            image_io.imwrite(od / f"frame_{f:04d}.png",
                             rng.randint(0, 2, size, dtype=np.uint8) * 255
                             if given is None else np.zeros(size, np.uint8))
        # test split images
        for pass_name in ("clean", "final"):
            d = root / "test" / pass_name / seq
            d.mkdir(parents=True, exist_ok=True)
            for f in range(1, n_frames + 1):
                image_io.imwrite(d / f"frame_{f:04d}.png",
                                 _rand_img(rng, *size) if given is None
                                 else given[0][f - 1])
    return root


def write_kitti(root: Path, year: str = "2015", n: int = 3, size=(96, 128),
                seed=0, frames=None):
    """``frames(i)``, where given, returns pair ``i``'s two BGR uint8
    frames and its flow (H, W, 2), NaN where invalid: both splits get those
    frames and both GT folders that flow; else all are random, 30% of the
    GT invalid."""
    rng = np.random.RandomState(seed)
    root = Path(root) / f"KITTI_{year}"
    img_dir = "image_2" if year == "2015" else "colored_0"
    given = [frames(i) for i in range(n)] if frames is not None else None
    for split in ("training", "testing"):
        (root / split / img_dir).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            for k, t in enumerate((10, 11)):
                image_io.imwrite(root / split / img_dir / f"{i:06d}_{t}.png",
                                 _rand_img(rng, *size) if given is None
                                 else given[i][0][k])
        if split == "training":
            for sub in ("flow_occ", "flow_noc"):
                (root / split / sub).mkdir(parents=True, exist_ok=True)
                for i in range(n):
                    if given is None:
                        f = _rand_flow(rng, *size)
                        f[rng.rand(*size) < 0.3] = np.nan  # sparse GT
                    else:
                        f = given[i][1]
                    flow_io.write_flow_png(
                        root / split / sub / f"{i:06d}_10.png", f)
    return root


def write_things(root: Path, n_seqs: int = 1, n_frames: int = 3,
                 size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "FlyingThings3D"
    for split in ("TRAIN", "TEST"):
        for letter in ("A",):
            for seq_idx in range(n_seqs):
                seq = f"{seq_idx:04d}"
                for side in ("left", "right"):
                    d = (root / "frames_cleanpass" / split / letter / seq /
                         side)
                    d.mkdir(parents=True, exist_ok=True)
                    for f in range(6, 6 + n_frames):
                        image_io.imwrite(d / f"{f:04d}.png",
                                   _rand_img(rng, *size))
                    for direction, tag in (("into_future", "Future"),
                                           ("into_past", "Past")):
                        fd = (root / "optical_flow" / split / letter / seq /
                              direction / side)
                        od = (root / "occlusions" / split / letter / seq /
                              direction / side)
                        md = (root / "motion_boundaries" / split / letter /
                              seq / direction / side)
                        for dd in (fd, od, md):
                            dd.mkdir(parents=True, exist_ok=True)
                        for f in range(6, 6 + n_frames):
                            letter_side = "R" if side == "right" else "L"
                            flow_io.write_pfm(
                                fd / f"OpticalFlowInto{tag}_{f:04d}_{letter_side}.pfm",
                                _rand_flow(rng, *size))
                            image_io.imwrite(od / f"{f:04d}.png",
                                       rng.randint(0, 2, size,
                                                   dtype=np.uint8) * 255)
                            image_io.imwrite(md / f"{f:04d}.png",
                                       rng.randint(0, 2, size,
                                                   dtype=np.uint8) * 255)
    return root


def write_hd1k(root: Path, n_seqs: int = 1, n_frames: int = 3,
               size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "HD1K"
    (root / "hd1k_input" / "image_2").mkdir(parents=True, exist_ok=True)
    (root / "hd1k_flow_gt" / "flow_occ").mkdir(parents=True, exist_ok=True)
    for s in range(n_seqs):
        for f in range(n_frames):
            name = f"{s:06d}_{f:04d}.png"
            image_io.imwrite(root / "hd1k_input" / "image_2" / name,
                       _rand_img(rng, *size))
            if f < n_frames - 1:
                flow_io.write_flow_png(
                    root / "hd1k_flow_gt" / "flow_occ" / name,
                    _rand_flow(rng, *size))
    return root


def write_spring(root: Path, n_seqs: int = 1, n_frames: int = 3,
                 size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "spring"
    for s in range(n_seqs):
        seq = root / "train" / f"{s:04d}"
        for side in ("left", "right"):
            (seq / f"frame_{side}").mkdir(parents=True, exist_ok=True)
            (seq / f"flow_FW_{side}").mkdir(parents=True, exist_ok=True)
            for f in range(1, n_frames + 1):
                image_io.imwrite(
                    str(seq / f"frame_{side}" / f"frame_{side}_{f:04d}.png"),
                    _rand_img(rng, *size))
                if f < n_frames:
                    # Spring flow is 2x the image resolution
                    flow_io.write_flo5(
                        seq / f"flow_FW_{side}" /
                        f"flow_FW_{side}_{f:04d}.flo5",
                        _rand_flow(rng, size[0] * 2, size[1] * 2))
    return root


def write_autoflow(root: Path, n: int = 3, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "autoflow"
    part = root / "static_40k_png_1_of_4"
    for i in range(n):
        d = part / f"sample_{i:05d}"
        d.mkdir(parents=True, exist_ok=True)
        image_io.imwrite(d / "im0.png", _rand_img(rng, *size))
        image_io.imwrite(d / "im1.png", _rand_img(rng, *size))
        flow_io.write_flo(d / "forward.flo", _rand_flow(rng, *size))
    return root


def write_things_subset(root: Path, n_frames: int = 4, size=(96, 128),
                        seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "FlyingThings3D_subset"
    for split in ("train", "val"):
        for side in ("left",):
            img_dir = root / split / "image_clean" / side
            ff_dir = root / split / "flow" / side / "into_future"
            fb_dir = root / split / "flow" / side / "into_past"
            occ_dir = root / split / "flow_occlusions" / side / "into_future"
            for d in (img_dir, ff_dir, fb_dir, occ_dir):
                d.mkdir(parents=True, exist_ok=True)
            for f in range(n_frames):
                image_io.imwrite(img_dir / f"{f:07d}.png",
                           _rand_img(rng, *size))
                if f < n_frames - 1:
                    flow_io.write_flo(ff_dir / f"{f:07d}.flo",
                                      _rand_flow(rng, *size))
                    image_io.imwrite(occ_dir / f"{f:07d}.png",
                               rng.randint(0, 2, size, dtype=np.uint8) * 255)
                if f > 0:
                    flow_io.write_flo(fb_dir / f"{f:07d}.flo",
                                      _rand_flow(rng, *size))
    return root


def write_tartanair(root: Path, n_frames: int = 3, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "tartanair"
    traj = root / "seasidetown" / "Easy" / "P000"
    (traj / "image_left").mkdir(parents=True, exist_ok=True)
    (traj / "flow").mkdir(parents=True, exist_ok=True)
    for f in range(n_frames):
        image_io.imwrite(traj / "image_left" / f"{f:06d}_left.png",
                   _rand_img(rng, *size))
        if f < n_frames - 1:
            np.save(traj / "flow" / f"{f:06d}_{f + 1:06d}_flow.npy",
                    _rand_flow(rng, *size))
    return root


def write_kubric(root: Path, n_seqs: int = 1, n_frames: int = 3,
                 size=(96, 128), seed=0):
    import json

    rng = np.random.RandomState(seed)
    root = Path(root) / "kubric"
    for s in range(n_seqs):
        d = root / f"seq_{s:04d}"
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "data_ranges.json", "w") as f:
            json.dump({"forward_flow": {"min": -20.0, "max": 20.0},
                       "backward_flow": {"min": -20.0, "max": 20.0}}, f)
        for f_i in range(n_frames):
            image_io.imwrite(d / f"rgba_{f_i:05d}.png", _rand_img(rng, *size))
            raw = rng.randint(0, 65535, (size[0], size[1], 3),
                              dtype=np.uint16)
            image_io.imwrite(d / f"forward_flow_{f_i:05d}.png", raw)
            image_io.imwrite(d / f"backward_flow_{f_i:05d}.png", raw)
    return root


def write_monkaa(root: Path, n_frames: int = 3, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "monkaa"
    seq = "a_rain_of_stones_x2"
    (root / "frames_cleanpass" / seq / "left").mkdir(parents=True,
                                                     exist_ok=True)
    (root / "optical_flow" / seq / "into_future" / "left").mkdir(
        parents=True, exist_ok=True)
    for f in range(n_frames):
        image_io.imwrite(root / "frames_cleanpass" / seq / "left" /
                       f"{f:04d}.png", _rand_img(rng, *size))
        flow_io.write_pfm(root / "optical_flow" / seq / "into_future" /
                          "left" / f"OpticalFlowIntoFuture_{f:04d}_L.pfm",
                          _rand_flow(rng, *size))
    return root


def write_middlebury_st(root: Path, n_seqs: int = 2, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "MiddleburyST"
    for s in range(n_seqs):
        d = root / f"scene{s}"
        d.mkdir(parents=True, exist_ok=True)
        image_io.imwrite(d / "im0.png", _rand_img(rng, *size))
        image_io.imwrite(d / "im1.png", _rand_img(rng, *size))
        flow_io.write_pfm(d / "disp0.pfm",
                          np.abs(_rand_flow(rng, *size)[..., 0]))
        flow_io.write_pfm(d / "disp0y.pfm",
                          np.zeros(size, np.float32))
    return root


def write_viper(root: Path, n_frames: int = 3, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "viper"
    seq = "001"
    (root / "train" / "img" / seq).mkdir(parents=True, exist_ok=True)
    (root / "train" / "flow" / seq).mkdir(parents=True, exist_ok=True)
    for f in range(n_frames):
        image_io.imwrite(root / "train" / "img" / seq /
                       f"{seq}_{f:05d}.png", _rand_img(rng, *size))
        if f < n_frames - 1:
            flow = _rand_flow(rng, *size).astype(np.float16)
            np.savez(root / "train" / "flow" / seq / f"{seq}_{f:05d}.npz",
                     u=flow[..., 0], v=flow[..., 1])
    return root


def write_middlebury(root: Path, n_seqs: int = 2, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    root = Path(root) / "Middlebury"
    for s in range(n_seqs):
        seq = f"seq{s}"
        (root / "other-gt-flow" / seq).mkdir(parents=True, exist_ok=True)
        (root / "other-data" / seq).mkdir(parents=True, exist_ok=True)
        flow_io.write_flo(root / "other-gt-flow" / seq / "flow10.flo",
                          _rand_flow(rng, *size))
        image_io.imwrite(root / "other-data" / seq / "frame10.png",
                   _rand_img(rng, *size))
        image_io.imwrite(root / "other-data" / seq / "frame11.png",
                   _rand_img(rng, *size))
    return root
