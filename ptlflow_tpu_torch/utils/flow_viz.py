"""Flow -> RGB visualization (color-wheel encoding).

Output-identical to the reference flowpy implementation
(ptlflow's ``utils/external/flowpy.py:44-208``): six-hue color
wheel with transition lengths (15, 6, 4, 11, 13, 6), angle-interpolated hue,
radius moves saturation ('bright' background) or value ('dark'), NaNs get
the invalid color.  A copy of ``ptlflow_tpu/utils/flow_viz.py``, plus
OpenCV's JET colormap as data (``apply_jet``) for the EPE images that
``validate`` writes.
"""

from __future__ import annotations

from itertools import accumulate
from typing import Optional

import numpy as np

DEFAULT_TRANSITIONS = (15, 6, 4, 11, 13, 6)


def make_colorwheel(transitions=DEFAULT_TRANSITIONS) -> np.ndarray:
    colorwheel_length = sum(transitions)
    base_hues = [
        np.array([255, 0, 0]), np.array([255, 255, 0]), np.array([0, 255, 0]),
        np.array([0, 255, 255]), np.array([0, 0, 255]),
        np.array([255, 0, 255]), np.array([255, 0, 0]),
    ]
    colorwheel = np.zeros((colorwheel_length, 3), dtype="uint8")
    hue_from = base_hues[0]
    start_index = 0
    for hue_to, end_index in zip(base_hues[1:], accumulate(transitions)):
        transition_length = end_index - start_index
        colorwheel[start_index:end_index] = np.linspace(
            hue_from, hue_to, transition_length, endpoint=False)
        hue_from = hue_to
        start_index = end_index
    return colorwheel


def flow_to_rgb(flow: np.ndarray, flow_max_radius: Optional[float] = None,
                background: str = "bright",
                custom_colorwheel: Optional[np.ndarray] = None) -> np.ndarray:
    """flow: HWC2 numpy (NaN = invalid) -> HW3 uint8 RGB."""
    if background not in ("bright", "dark"):
        raise ValueError(f"invalid background '{background}'")
    wheel = make_colorwheel() if custom_colorwheel is None else custom_colorwheel

    fx = np.array(flow[..., 0], np.float32, copy=True)
    fy = np.array(flow[..., 1], np.float32, copy=True)
    nan_mask = np.isnan(fx) | np.isnan(fy)
    fx[nan_mask] = 0.0
    fy[nan_mask] = 0.0

    radius = np.sqrt(fx ** 2 + fy ** 2)
    angle = np.arctan2(fy, fx)

    if flow_max_radius is None:
        flow_max_radius = np.max(radius)
    if flow_max_radius > 0:
        radius = radius / flow_max_radius

    ncols = len(wheel)
    angle[angle < 0] += 2 * np.pi
    angle = angle * ((ncols - 1) / (2 * np.pi))

    wheel = np.vstack((wheel, wheel[0]))
    angle_fractional, angle_floor = np.modf(angle)
    angle_ceil = np.ceil(angle)
    angle_fractional = angle_fractional[..., None]
    float_hue = (wheel[angle_floor.astype(np.int32)] * (1 - angle_fractional)
                 + wheel[angle_ceil.astype(np.int32)] * angle_fractional)

    def move_hue_on_V_axis(hues, factors):
        return hues * factors[..., None]

    def move_hue_on_S_axis(hues, factors):
        return 255.0 - factors[..., None] * (255.0 - hues)

    if background == "dark":
        move_valid, move_oversized = move_hue_on_V_axis, move_hue_on_S_axis
        invalid_color = np.array([255, 255, 255], np.float32)
    else:
        move_valid, move_oversized = move_hue_on_S_axis, move_hue_on_V_axis
        invalid_color = np.array([0, 0, 0], np.float32)

    colors = move_valid(float_hue, radius)
    oversized = radius > 1
    colors[oversized] = move_oversized(
        float_hue[oversized], 1 / radius[oversized])
    colors[nan_mask] = invalid_color
    return colors.astype(np.uint8)


# cv2.applyColorMap(ramp, cv2.COLORMAP_JET) for ramp = 0..255: 256 BGR
# triples, as hex
_JET_BGR_HEX = (
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080")


def apply_jet(gray: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray, cv2.COLORMAP_JET)`` of a uint8 image:
    (H, W) or (H, W, 1) -> (H, W, 3) BGR uint8."""
    table = np.frombuffer(bytes.fromhex(_JET_BGR_HEX), np.uint8).reshape(
        256, 3)
    gray = np.asarray(gray)
    if gray.dtype != np.uint8:
        raise ValueError(f"apply_jet: uint8 image, not {gray.dtype}")
    if gray.ndim == 3 and gray.shape[2] == 1:
        gray = gray[:, :, 0]
    return table[gray]
