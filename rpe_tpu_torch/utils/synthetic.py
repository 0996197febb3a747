"""Synthetic piecewise-planar sequences with a known relative pose.

A blocky texture (FAST needs sharp steps) is laid over fronto-parallel
strips of frame 0 at different depths. Every later frame renders each strip
through its plane-induced homography under a constant per-frame motion
X_{i+1} = R X_i + t, so every consecutive pair has ground truth (R, t) in
the estimator's convention (x2 ~ R x1 + t). numpy only; made from a seed.
`write_kitti_sequence` writes such a sequence to disk in the KITTI layout,
its PNGs by a stdlib zlib writer (`write_png`), so no imaging library is
needed.

`manhattan_sequence` renders a camera turning inside a tiled box whose walls
are aligned with the world axes: the grout lines run along the three axes,
so they converge on the three vanishing points of the camera's rotation,
and the tiles' random shades give ORB its corners. `write_dataset` writes
such a sequence in the layout of the simulator, phone and Salah runners.
"""

from __future__ import annotations

import numpy as np


def rotation_from_axis_angle(w):
    """Rodrigues: axis-angle (3,) in radians -> (3, 3) float64."""
    w = np.asarray(w, dtype=np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * Kx + (1.0 - np.cos(th)) * (Kx @ Kx)


def camera_matrix(h: int, w: int):
    """A KITTI-like pinhole camera scaled to the frame width."""
    f = 718.856 * w / 1241.0
    return np.array([[f, 0.0, 0.5 * w], [0.0, f, 0.5 * h], [0.0, 0.0, 1.0]],
                    dtype=np.float32)


def make_sequence(n_frames: int, h: int = 376, w: int = 1241, seed: int = 0,
                  depths=(40.0, 18.0, 9.0), cell: int = 8,
                  rot_deg: float = 1.5, step=(0.35, -0.05, 1.0)):
    """Frames (n_frames, h, w) float32 in [0, 255], K (3, 3) float32 and the
    per-pair ground truth (R (3, 3), t (3,) unit) as float64.

    Frame 0 rows are split into len(depths) horizontal strips, strip s lying
    on the plane Z = depths[s]. Nearer strips are drawn over farther ones;
    pixels no strip reaches take the farthest plane's texture.
    """
    rng = np.random.default_rng(seed)
    K = camera_matrix(h, w).astype(np.float64)
    Kinv = np.linalg.inv(K)
    tex = rng.uniform(0.0, 255.0, (-(-h // cell) + 1, -(-w // cell) + 1))
    axis = rng.normal(size=3) * np.array([0.3, 1.0, 0.2])
    axis /= np.linalg.norm(axis)
    R = rotation_from_axis_angle(axis * np.deg2rad(rot_deg))
    t = np.asarray(step, dtype=np.float64) * (0.9 + 0.2 * rng.uniform())

    bounds = np.linspace(0, h, len(depths) + 1).round().astype(int)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])   # (3, HW)

    def texture(u, v):
        iu = np.clip(np.floor(u / cell).astype(int), 0, tex.shape[1] - 1)
        iv = np.clip(np.floor(v / cell).astype(int), 0, tex.shape[0] - 1)
        return tex[iv, iu]

    frames = []
    A, b = np.eye(3), np.zeros(3)          # X_i = A X_0 + b
    n = np.array([0.0, 0.0, 1.0])
    for _ in range(n_frames):
        img = np.zeros(h * w)
        filled = np.zeros(h * w, dtype=bool)
        order = np.argsort(depths)         # nearest first
        for s in order:
            Hs = K @ (A + np.outer(b, n) / depths[s]) @ Kinv   # frame0 -> i
            src = np.linalg.inv(Hs) @ pix
            with np.errstate(divide="ignore", invalid="ignore"):
                u, v = src[0] / src[2], src[1] / src[2]
            inside = ((src[2] > 0) & (v >= bounds[s]) & (v < bounds[s + 1])
                      & (u >= 0) & (u < w) & ~filled)
            img[inside] = texture(u[inside], v[inside])
            filled |= inside
        far = int(np.argmax(depths))
        Hs = K @ (A + np.outer(b, n) / depths[far]) @ Kinv
        src = np.linalg.inv(Hs) @ pix
        u, v = src[0] / src[2], src[1] / src[2]
        img[~filled] = texture(np.abs(u[~filled]) % w, np.abs(v[~filled]) % h)
        frames.append(img.reshape(h, w).astype(np.float32))
        A, b = R @ A, R @ b + t
    return np.stack(frames), K.astype(np.float32), (R, t / np.linalg.norm(t))


def float_descriptors(seed: int, n1: int, n2: int, pairs: int = 1,
                      dup: bool = False):
    """SIFT-like descriptor sets for the L2 matchers: (pairs, n1, 128) and
    (pairs, n2, 128) float32, nonnegative and of unit norm, the second set
    holding noisy copies of the first, and (pairs, n1), (pairs, n2) bool
    validity masks. dup=True adds exact duplicates on both sides (ties at
    distance 0, which the lowest index must win)."""
    g = np.random.default_rng(seed)
    d1 = g.uniform(size=(pairs, n1, 128)).astype(np.float32) ** 3
    d2 = d1[:, g.integers(0, n1, n2)] + 0.05 * g.uniform(size=(pairs, n2, 128))
    if dup:
        d1[:, n1 // 2:n1 // 2 + 8] = d1[:, :8]
        d2[:, :16] = d1[:, :16]
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
    v1 = g.uniform(size=(pairs, n1)) < 0.9
    v2 = g.uniform(size=(pairs, n2)) < 0.9
    return d1, d2, v1, v2


def rotation_error_deg(R_a, R_b):
    """Geodesic angle in degrees between rotation matrices (..., 3, 3)."""
    R_a = np.asarray(R_a, dtype=np.float64)
    R_b = np.asarray(R_b, dtype=np.float64)
    tr = np.einsum("...ij,...ij->...", R_a, R_b)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


# ---------------------------------------------------------------------------
# Writing a sequence to disk (stdlib zlib + struct; no PIL needed)
# ---------------------------------------------------------------------------

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows, bpp: int) -> bytes:
    """PNG-filter (H, row_bytes) uint8 scanlines, row r with filter type
    r % 5 (None, Sub, Up, Average, Paeth), so a decoder meets all five."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                      # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                                 # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]                    # upper left
    preds = [np.zeros_like(x), a, b, (a + b) // 2, _paeth(a, b, c)]
    out = bytearray()
    for r in range(x.shape[0]):
        f = r % 5
        out.append(f)
        out += ((x[r] - preds[f][r]) & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def write_png(path, img, palette=None) -> None:
    """Write an 8-bit PNG: (H, W) gray, (H, W, 3) RGB, or (H, W) indices
    into `palette` ((N, 3) uint8 RGB, N <= 256)."""
    import struct
    import zlib

    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype}")
    if palette is not None:
        ctype, bpp = 3, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, bpp = 2, 3
    elif img.ndim == 2:
        ctype, bpp = 0, 1
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    body = _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    raw = _filter_rows(img.reshape(h, w * bpp), bpp)
    body += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    body += _png_chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body)


def kitti_poses(R, t, n_frames: int):
    """Camera-to-world poses (n_frames, 4, 4) of a constant per-frame motion
    x_{i+1} = R x_i + t, frame 0 at the identity (the world frame)."""
    step = np.eye(4)
    step[:3, :3] = np.asarray(R, np.float64).T
    step[:3, 3] = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
    poses = [np.eye(4)]
    for _ in range(n_frames - 1):
        poses.append(poses[-1] @ step)
    return np.stack(poses)


def write_kitti_sequence(root, frames, K, R, t):
    """Write a sequence in the KITTI odometry layout under `root`:
    image_0/000000.png ... (8-bit grayscale, frames rounded and clipped),
    poses.txt (the camera-to-world poses of `kitti_poses`, 12 values a line)
    and calib.txt (P0 = [K | 0]). Returns (images dir, poses, calib)."""
    from pathlib import Path

    root = Path(root)
    images = root / "image_0"
    images.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(np.asarray(frames)):
        write_png(images / f"{i:06d}.png",
                  np.clip(np.rint(f), 0, 255).astype(np.uint8))
    poses = kitti_poses(R, t, len(frames))
    np.savetxt(root / "poses.txt", poses[:, :3, :].reshape(len(poses), 12),
               fmt="%.9e")
    P0 = np.concatenate([np.asarray(K, np.float64), np.zeros((3, 1))], 1)
    (root / "calib.txt").write_text(
        "P0: " + " ".join(f"{v:.12e}" for v in P0.reshape(-1)) + "\n")
    return images, root / "poses.txt", root / "calib.txt"


# ---------------------------------------------------------------------------
# A Manhattan scene: a tiled box, the camera inside it
# ---------------------------------------------------------------------------

MANHATTAN_R0 = (0.45, -0.55, 0.35)   # axis-angle: all three VPs finite
MANHATTAN_STEP = (0.02, 0.0, 0.06)   # camera centre's motion a frame
GROUT = 0.1                          # grout line width (world units)
SPECK = 4                            # speck cells per tile side
SAMPLES = 2                          # supersampling per pixel side
# A room whose 1241x376 frames, drawn through the dataset runners' default
# intrinsics (pipeline/calibration.py scaled to that size), pass the default
# VP gates (acc_max >= 8e5, vp2_score >= 8000) on every one of 17 frames in
# both twins: the z-lines dominate (VP1), the x-lines outnumber the y-lines
# (so VP2 is the x one in every frame, and consecutive frames' directions do
# not swap columns), and no specks, whose short edges would crowd out the
# long lines.
GATED_ROOM = dict(spacing=(1.2, 6.0, 1.0), room=(5.0, 2.5, 8.0),
                  dot_half=0.0)


def rot_y(deg: float):
    """Ry(deg): the yaw rotation of the yup convention (float64)."""
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                     [-np.sin(a), 0.0, np.cos(a)]])


def manhattan_sequence(n_frames: int, h: int = 376, w: int = 1241,
                       seed: int = 0, rot_deg: float = 0.25,
                       room=(6.0, 3.0, 8.0), spacing=(1.7, 1.7, 1.7),
                       dot_half: float = 0.1, K=None):
    """Frames of a camera turning inside a tiled box.

    The camera-from-world rotation of frame f is Ry(rot_deg)^f R0 (R0 from
    MANHATTAN_R0) and its centre moves by MANHATTAN_STEP (world units) a
    frame, so every consecutive pair has the relative rotation Ry(rot_deg)
    (x2 = R x1 + t), and the yup ground truth of frame f is yaw f * rot_deg
    with zero pitch and roll. The box spans +-room along the world axes;
    each wall is tiled in random shades, split by dark grout lines of width
    GROUT along the world axes, the lines along axis a `spacing[a]` apart
    (so one family of lines can outnumber another); about half of the
    SPECK x SPECK cells of a tile hold a square of another random shade,
    2 * `dot_half` of a cell wide (corners for ORB; their short edges run
    along the axes too). The frames are drawn anti-aliased by SAMPLES x
    SAMPLES supersampling, through `K` (default `camera_matrix(h, w)`; the
    dataset runners' scaled default intrinsics for a scene that they read
    without a calibration file).

    Returns (frames (n_frames, h, w) float32 in [0, 255], K (3, 3) float32,
    R_rel (3, 3) float64, yaw_deg (n_frames,), centres (n_frames, 3)).
    """
    rng = np.random.default_rng(seed)
    K = np.asarray(camera_matrix(h, w) if K is None else K, np.float64)
    Kinv = np.linalg.inv(K)
    shades = rng.uniform(70.0, 250.0, (3, 97, 89))
    specks = np.where(rng.uniform(size=(3, 113, 109)) < 0.5,
                      rng.uniform(0.0, 255.0, (3, 113, 109)), -1.0)
    S = rot_y(rot_deg)
    R0 = rotation_from_axis_angle(MANHATTAN_R0)
    half = np.asarray(room, np.float64)
    sx, sy, sz = spacing
    step = np.asarray(MANHATTAN_STEP, np.float64)
    centre0 = -0.3 * step * n_frames

    offs = (np.arange(SAMPLES) + 0.5) / SAMPLES - 0.5
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames, yaws, centres = [], [], []
    R = R0
    for f in range(n_frames):
        C = centre0 + f * step
        acc = np.zeros((h, w))
        for oy in offs:
            for ox in offs:
                pix = np.stack([xs + ox, ys + oy, np.ones_like(xs)], -1)
                d = pix @ (R.T @ Kinv).T                # world ray directions
                with np.errstate(divide="ignore"):
                    t = (np.where(d > 0, half, -half) - C) / d
                t = np.where(np.isfinite(t) & (t > 0), t, np.inf)
                axis = np.argmin(t, axis=-1)            # the wall hit first
                hit = C + np.take_along_axis(t, axis[..., None], -1) * d
                # the wall's two in-plane world coordinates
                u = np.where(axis == 0, hit[..., 1], hit[..., 0])
                v = np.where(axis == 2, hit[..., 1], hit[..., 2])
                # lines at u = const run along v's axis, and vice versa
                tu = np.where(axis == 2, sy, sz)
                tv = np.where(axis == 0, sy, sx)
                iu = np.floor(u / tu).astype(np.int64)
                iv = np.floor(v / tv).astype(np.int64)
                shade = shades[axis, iu % 97, iv % 89]
                cu, cv = u * SPECK / tu, v * SPECK / tv
                ju, jv = np.floor(cu).astype(np.int64), \
                    np.floor(cv).astype(np.int64)
                dot = specks[axis, ju % 113, jv % 109]
                inner = ((np.abs(cu - ju - 0.5) < dot_half)
                         & (np.abs(cv - jv - 0.5) < dot_half) & (dot >= 0))
                shade = np.where(inner, dot, shade)
                fu, fv = u / tu - iu, v / tv - iv
                line = (fu < GROUT / tu) | (fv < GROUT / tv)
                acc += np.where(line, 25.0, shade)
        frames.append((acc / len(offs) ** 2).astype(np.float32))
        yaws.append(f * rot_deg)
        centres.append(C)
        R = S @ R
    return (np.stack(frames), K.astype(np.float32), S, np.asarray(yaws),
            np.stack(centres))


def write_dataset(root, frames, yaw_deg, centres, calib_name=None, K=None):
    """Write a sequence in the dataset runners' layout under `root` (their
    `data` directory): images/000000.png ... (8-bit grayscale, rounded and
    clipped) and a ground-truth table `frame x y z roll pitch yaw` with the
    given yaw (degrees), zero pitch and roll and the centres as positions.
    Its name is camera_poses.txt (simulator) or, with `calib_name`,
    camera_poses_zyx.txt beside an .npz holding K under that name (phone:
    calibration_scaled.npz, Salah: calibration.npz). Returns root."""
    from pathlib import Path

    root = Path(root)
    images = root / "images"
    images.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(np.asarray(frames)):
        write_png(images / f"{i:06d}.png",
                  np.clip(np.rint(f), 0, 255).astype(np.uint8))
    rows = ["frame x y z roll pitch yaw"]
    for i, (c, yaw) in enumerate(zip(centres, yaw_deg)):
        rows.append(f"{i} {c[0]:.9f} {c[1]:.9f} {c[2]:.9f} 0.0 0.0 "
                    f"{float(yaw):.9f}")
    gt = "camera_poses.txt" if calib_name is None else "camera_poses_zyx.txt"
    (root / gt).write_text("\n".join(rows) + "\n")
    if calib_name is not None:
        np.savez(root / calib_name, K=np.asarray(K, np.float64))
    return root
