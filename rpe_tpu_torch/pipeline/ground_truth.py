"""Ground-truth pose loading (port of rpe_tpu/pipeline/ground_truth.py,
without pandas).

The file is whitespace-separated with a header row, `frame x y z roll pitch
yaw` (angles in degrees). Each column is int64 when every value parses as
an integer, else float64, as pandas' `read_csv` infers them. The API is the
reference's, with `poses_for_frames` returning dense arrays for a whole
frame list.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _column(values):
    try:
        return np.array([int(v) for v in values], dtype=np.int64)
    except ValueError:
        return np.array([float(v) for v in values], dtype=np.float64)


def _read_table(path) -> dict[str, np.ndarray]:
    """A whitespace-separated table with a header row -> {name: column}."""
    lines = [ln.split() for ln in Path(path).read_text().splitlines()
             if ln.strip()]
    if not lines:
        raise ValueError(f"empty table: {path}")
    names, rows = lines[0], lines[1:]
    for i, r in enumerate(rows):
        if len(r) != len(names):
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, the "
                             f"header {len(names)}")
    cols = list(zip(*rows)) if rows else [()] * len(names)
    return {n: _column(c) for n, c in zip(names, cols)}


class GroundTruthLoader:
    """Loads and serves ground-truth camera poses."""

    def __init__(self, gt_path):
        self.gt_path = Path(gt_path)
        self.data = None

    def load(self):
        """Read the file; returns {column name: array}."""
        self.data = _read_table(self.gt_path)
        return self.data

    def _require_loaded(self):
        if self.data is None:
            raise RuntimeError("Ground truth not loaded. Call load() first.")

    def _rows(self, step):
        frame = self.data["frame"]
        return frame % step == 0

    def get_pose(self, frame_idx):
        """Pose dict for one frame; KeyError if absent."""
        self._require_loaded()
        hits = np.flatnonzero(self.data["frame"] == frame_idx)
        if hits.size == 0:
            raise KeyError(f"Frame {frame_idx} not found in ground truth data")
        i = hits[0]
        d = self.data
        return {"frame": int(d["frame"][i]),
                **{k: float(d[k][i])
                   for k in ("x", "y", "z", "roll", "pitch", "yaw")}}

    def get_frame_indices(self, step: int = 1):
        """Frames whose *number* is divisible by step (the modulo is on the
        frame number, not the row position)."""
        self._require_loaded()
        return self.data["frame"][self._rows(step)]

    def get_all_frames(self):
        self._require_loaded()
        return self.data["frame"]

    def _stack(self, names, rows):
        return np.stack([self.data[k][rows] for k in names], axis=-1)

    def get_trajectory(self, step: int = 1):
        """(N, 3) positions at the step interval."""
        self._require_loaded()
        return self._stack(("x", "y", "z"), self._rows(step))

    def get_orientations(self, step: int = 1):
        """(N, 3) [roll, pitch, yaw] at the step interval."""
        self._require_loaded()
        return self._stack(("roll", "pitch", "yaw"), self._rows(step))

    def poses_for_frames(self, frames):
        """Dense arrays for a frame list: (positions (N, 3), rpy (N, 3)
        degrees), float64. KeyError on any missing frame, as get_pose."""
        self._require_loaded()
        first = {}
        for i, f in enumerate(self.data["frame"].tolist()):
            first.setdefault(f, i)
        missing = [f for f in frames if f not in first]
        if missing:
            raise KeyError(f"Frame {missing[0]} not found in ground truth data")
        rows = np.array([first[f] for f in frames], dtype=np.int64)
        pos = self._stack(("x", "y", "z"), rows).astype(np.float64)
        rpy = self._stack(("roll", "pitch", "yaw"), rows).astype(np.float64)
        return pos, rpy
