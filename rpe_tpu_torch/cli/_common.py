"""Shared CLI plumbing for the dataset runners (port of rpe_tpu/cli/_common.py).

Datasets are read from --data-root (default: $RPE_DATA_ROOT, else the
working directory; the reference also looks for its own dataset checkout
at a fixed path, which the port does not assume); results go under
--results-dir.
"""

from __future__ import annotations

import argparse
import os


def default_data_root() -> str:
    return os.environ.get("RPE_DATA_ROOT") or "."


def sequence_parser(description: str, default_step: int,
                    default_fps: int) -> argparse.ArgumentParser:
    """The dataset runners' flags, plus data-root/results overrides."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--step", type=int, default=default_step,
                   help=f"Frame step interval (default: {default_step})")
    p.add_argument("--no-plot", action="store_true",
                   help="Skip plot generation")
    p.add_argument("--no-video", action="store_true",
                   help="Skip video generation")
    p.add_argument("--video-fps", type=int, default=default_fps,
                   help=f"Video FPS (default: {default_fps})")
    p.add_argument("--data-root", default=default_data_root(),
                   help="Root containing evaluation-runs/ (default: "
                        "$RPE_DATA_ROOT, else the working directory)")
    p.add_argument("--results-dir", default=None,
                   help="Results directory (default: local "
                        "evaluation-runs/<dataset>/results)")
    p.add_argument("--chunk", type=int, default=32,
                   help="Pairs per dispatch (static batch size)")
    p.add_argument("--devices", type=int, default=0,
                   help="Shard pairs over this many devices (0 = no mesh)")
    p.add_argument("--seed", type=int, default=0,
                   help="RANSAC base seed (per-pair key = seed + frame "
                        "index; sweep seeds spaced wider than the max "
                        "frame index, e.g. multiples of 100000)")
    from ..config import PROFILE_NAMES

    p.add_argument("--profile", choices=PROFILE_NAMES, default="parity",
                   help="ORB work-cut profile (default: parity = the "
                        "reference's nfeatures=4000/nlevels=12)")
    p.add_argument("--feature", choices=["ORB", "SIFT"], default="ORB",
                   help="Feature family. SIFT switches matching to L2 with "
                        "the reference's crossCheck semantics; profiles and "
                        "extract-cap are ORB-only knobs, ignored under SIFT")
    p.add_argument("--extract-cap", type=int, default=None,
                   help="Extraction slots per band of the profile's band "
                        "height (multiple of 4; default: the profile's cap, "
                        "72 per 32-row band at parity)")
    return p


def make_mesh(n_devices: int, device=None):
    """None for n_devices <= 0, else a 'pairs' mesh of the first n cards
    (raises when fewer are visible), or of n CPU entries with
    device="cpu"."""
    if n_devices <= 0:
        return None
    from ..parallel.mesh import pairs_mesh

    return pairs_mesh(n_devices, device)
