"""Camera intrinsics (port of rpe_tpu/pipeline/calibration.py; numpy only).

Three-level priority, as in the reference: an explicit 3x3 `camera_matrix`,
else an `.npz` file with a 'K' key, else the base simulator intrinsics
scaled linearly to the image size. Distortion coefficients are never
applied anywhere.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class CameraCalibration:
    """Intrinsics provider (the reference's API and defaults)."""

    def __init__(
        self,
        camera_matrix=None,
        calibration_file=None,
        fx_base: float = 924.82939686,
        fy_base: float = 920.4766382,
        cx_base: float = 468.24930789,
        cy_base: float = 353.65863024,
        base_width: int = 960,
        base_height: int = 720,
    ):
        self.fixed_K = None
        if camera_matrix is not None:
            self.fixed_K = np.asarray(camera_matrix, dtype=np.float64)
            if self.fixed_K.shape != (3, 3):
                raise ValueError(
                    f"camera_matrix must be 3x3, got {self.fixed_K.shape}")
        elif calibration_file is not None:
            cal_path = Path(calibration_file)
            if not cal_path.exists():
                raise FileNotFoundError(
                    f"Calibration file not found: {calibration_file}")
            data = np.load(cal_path)
            if "K" not in data:
                raise KeyError(
                    f"Calibration file must contain 'K' key, found: "
                    f"{list(data.keys())}")
            self.fixed_K = np.asarray(data["K"], dtype=np.float64)

        self.fx_base = fx_base
        self.fy_base = fy_base
        self.cx_base = cx_base
        self.cy_base = cy_base
        self.base_width = base_width
        self.base_height = base_height

    def get_matrix(self, image_width=None, image_height=None):
        if self.fixed_K is not None:
            return self.fixed_K
        if image_width is None or image_height is None:
            raise ValueError(
                "image_width and image_height required when using base "
                "parameters")
        sx = image_width / self.base_width
        sy = image_height / self.base_height
        return np.array([
            [self.fx_base * sx, 0.0, self.cx_base * sx],
            [0.0, self.fy_base * sy, self.cy_base * sy],
            [0.0, 0.0, 1.0],
        ], dtype=np.float64)

    def get_matrix_from_image(self, image):
        h, w = image.shape[:2]
        return self.get_matrix(w, h)


def load_K_npz(path) -> np.ndarray:
    """K from an .npz holding 'K' or 'intrinsic_matrix', 3x3 or flattened
    to 9 elements."""
    calib = np.load(path)
    if "K" in calib:
        K = calib["K"]
    elif "intrinsic_matrix" in calib:
        K = calib["intrinsic_matrix"]
    else:
        raise KeyError(
            "Calibration file must contain 'K' or 'intrinsic_matrix'. "
            f"Found: {list(calib.keys())}")
    K = np.asarray(K, dtype=float)
    if K.shape == (9,):
        K = K.reshape(3, 3)
    if K.shape != (3, 3):
        raise ValueError(f"Intrinsic matrix must be 3x3. Got shape {K.shape}")
    return K
