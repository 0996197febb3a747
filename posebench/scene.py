"""Synthetic piecewise-planar frame chunks with a known relative pose, made
on the device from a seed.

A blocky texture (FAST needs sharp steps) is laid over horizontal strips of
frame 0, strip s on the fronto-parallel plane Z = depths[s]. Every later
frame renders each strip through its plane-induced homography under a
constant per-frame motion X_{i+1} = R X_i + t, so every consecutive pair has
the ground truth (R, t / |t|) in the estimator's convention (x2 ~ R x1 + t).
Nearer strips are drawn over farther ones; pixels that no strip reaches take
the farthest plane's texture, wrapped.

This is the generator of `rpe_tpu_torch/utils/synthetic.py` `make_sequence`
rewritten in PyTorch so that a chunk is made on the card in a few large
calls: the texture comes from a `torch.Generator` on the frames' device, the
motion's few scalars from numpy, and each frame's pixels from one float64
homography per strip. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def mix_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for stream `parts` of run seed `seed` (any int >= 0)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *parts])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def rotation_from_axis_angle(w) -> np.ndarray:
    """Rodrigues: axis-angle (3,) in radians -> (3, 3) float64."""
    w = np.asarray(w, dtype=np.float64)
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return np.eye(3) + math.sin(th) * kx + (1.0 - math.cos(th)) * (kx @ kx)


def camera(traffic: dict) -> np.ndarray:
    """The traffic's intrinsics as a (3, 3) float64 matrix."""
    return np.array([[traffic["fx"], 0.0, traffic["cx"]],
                     [0.0, traffic["fy"], traffic["cy"]],
                     [0.0, 0.0, 1.0]], dtype=np.float64)


def motion(traffic: dict, seed: int):
    """The chunk's per-frame motion: R (3, 3) and t (3,) float64, from the
    traffic's `rot_deg` and `step` and two numbers drawn from `seed`."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3) * np.array([0.3, 1.0, 0.2])
    axis /= np.linalg.norm(axis)
    R = rotation_from_axis_angle(axis * np.deg2rad(traffic["rot_deg"]))
    t = np.asarray(traffic["step"], dtype=np.float64) * (
        0.9 + 0.2 * rng.uniform())
    return R, t


def make_chunk(traffic: dict, n_frames: int, seed: int, device,
               out: torch.Tensor | None = None):
    """Frames (n_frames, h, w) float32 in [0, 255] on `device` (written into
    `out` when given) and the ground truth of every consecutive pair:
    R (3, 3) and unit t (3,) float64 numpy."""
    h, w = int(traffic["height"]), int(traffic["width"])
    cell = int(traffic["cell"])
    depths = [float(d) for d in traffic["depths"]]
    K = camera(traffic)
    Kinv = np.linalg.inv(K)
    R, t = motion(traffic, mix_seed(seed, 1))

    gen = torch.Generator(device=device)
    gen.manual_seed(mix_seed(seed, 0))
    th, tw = -(-h // cell) + 1, -(-w // cell) + 1
    tex = (torch.rand((th, tw), generator=gen, device=device,
                      dtype=torch.float64) * 255.0).to(torch.float32)

    bounds = np.linspace(0, h, len(depths) + 1).round().astype(int)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device, dtype=torch.float64),
        torch.arange(w, device=device, dtype=torch.float64), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(h * w, device=device,
                                  dtype=torch.float64)])      # (3, HW)

    def lookup(u, v):
        iu = torch.clamp(torch.floor(u / cell).long(), 0, tw - 1)
        iv = torch.clamp(torch.floor(v / cell).long(), 0, th - 1)
        return tex[iv, iu]

    if out is None:
        out = torch.empty((n_frames, h, w), dtype=torch.float32,
                          device=device)
    A, b = np.eye(3), np.zeros(3)          # X_i = A X_0 + b
    n = np.array([0.0, 0.0, 1.0])
    order = np.argsort(depths)             # nearest first
    far = int(np.argmax(depths))
    for i in range(n_frames):
        hinv = np.stack([np.linalg.inv(K @ (A + np.outer(b, n) / d) @ Kinv)
                         for d in depths])
        src = torch.matmul(torch.from_numpy(hinv).to(device), pix)
        z = src[:, 2]
        u, v = src[:, 0] / z, src[:, 1] / z                    # (S, HW)
        img = torch.empty(h * w, dtype=torch.float32, device=device)
        filled = torch.zeros(h * w, dtype=torch.bool, device=device)
        for s in order:
            inside = ((z[s] > 0) & (v[s] >= bounds[s]) & (v[s] < bounds[s + 1])
                      & (u[s] >= 0) & (u[s] < w) & ~filled)
            img = torch.where(inside, lookup(u[s], v[s]), img)
            filled |= inside
        wrap = lookup(torch.remainder(u[far].abs(), w),
                      torch.remainder(v[far].abs(), h))
        out[i] = torch.where(filled, img, wrap).reshape(h, w)
        A, b = R @ A, R @ b + t
    return out, (R, t / np.linalg.norm(t))


def make_keys(seed: int, pairs: int) -> np.ndarray:
    """Per-pair threefry keys (pairs, 2) uint32, the port's key layout."""
    rng = np.random.default_rng(mix_seed(seed, 2))
    return rng.integers(0, 2 ** 32, size=(pairs, 2), dtype=np.uint64).astype(
        np.uint32)


class Pool:
    """`traffic["pool"]` distinct chunks of B + 1 frames, each with its own
    texture, motion and keys, made from the run's seed."""

    def __init__(self, traffic: dict, seed: int, device):
        b = int(traffic["pairs"])
        npool = int(traffic["pool"])
        h, w = int(traffic["height"]), int(traffic["width"])
        self.pairs = b
        self.K = camera(traffic)
        self.frames = torch.empty((npool, b + 1, h, w), dtype=torch.float32,
                                  device=device)
        self.truth = []
        self.keys = []
        for c in range(npool):
            _, gt = make_chunk(traffic, b + 1, mix_seed(seed, 10, c), device,
                               out=self.frames[c])
            self.truth.append(gt)
            self.keys.append(make_keys(mix_seed(seed, 11, c), b))

    def __len__(self) -> int:
        return self.frames.shape[0]
