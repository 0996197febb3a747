"""Batched sequence processing over consecutive image pairs (port of
rpe_tpu/pipeline/batch.py).

Pairs are independent (each is re-anchored to the ground-truth orientation
of its first frame), so the sequence becomes a batch axis: frames are
decoded lazily per chunk, every chunk's unique frames go to the device once
(`estimate_sequence_batched` detects each frame once for both of its
pairs), and chunks run with one kept in flight -- chunk c+1 is decoded and
copied to the device while chunk c runs, then chunk c is flushed.

Semantics are the reference's: GT anchoring (R_prev from the GT of each
pair's first frame), world composition R_new = R_prev @ R_rel, Euler out in
the configured convention, the same result dict; a degenerate pair gives
valid=False and the identity instead of aborting the run (strict=True
restores the abort). Checkpoints (jsonl, a config-hash header, `.stale` on
a mismatch, per-record frame checks, a salt) and the inlier-collapse
fallback are the reference's too, and so is the VP (Manhattan) refinement
of `process_sequence`. With a device mesh (parallel/mesh.py), each chunk
is split into per-device blocks of consecutive pairs
(parallel/sharded_estimator.estimate_sequence_sharded); the outputs are
those of the run without a mesh at the shard's size (chunk / devices). On
a card a batch of another size can move a pose in its last digits and so
change a RANSAC winner (ROADMAP.md, Known divergences).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from .. import rng
from ..geometry.rotations import euler_to_rotation, rotation_to_euler
from ..io.image_loader import LazyFrameSource
from ..utils.observability import StageTimer, ThroughputMeter
from .estimator import estimate_pairs_batched, estimate_sequence_batched

FALLBACK_BATCH = 8  # fixed pair batch of the inlier-collapse fallback


def _sequence_blocks(sel1, local, n_dev, last_frame_pos):
    """Per-device consecutive frame blocks for a padded pair chunk.

    sel1: chunk pair-start frame indices (padding repeats the last real
      index). Device d covers pairs [d*local, (d+1)*local): its block is
      local+1 consecutive frame positions starting at its FIRST pair's start
      frame, so every real pair p (a consecutive prefix of the chunk) sits
      at flat slot p computing (sel1[p], sel1[p]+1). Positions are clamped
      to last_frame_pos, so pad slots past the sequence become same-frame
      pairs, which the caller discards.

    Returns (n_dev, local+1) int array of frame positions.
    """
    blocks = np.empty((n_dev, local + 1), dtype=np.int64)
    for d in range(n_dev):
        s = sel1[d * local]
        for j in range(local + 1):
            blocks[d, j] = min(s + j, last_frame_pos)
    return blocks


def _pair_keys(seed, sel, device):
    """Threefry keys PRNGKey(seed + s) for the pairs starting at `sel`: a
    pair's key depends on its index only, not on the chunking."""
    return torch.stack([rng.PRNGKey(seed + int(s)) for s in sel]).to(device)


class BatchProcessor:
    """Sequence-pair trajectory processor (the reference's API).

    Knobs beside the reference's:
      chunk: pairs per dispatch (the last chunk is padded); under a mesh
        rounded down to a multiple of its size (at least one pair per
        device).
      mesh: a 1-D 'pairs' mesh (parallel/mesh.py) to shard each chunk over,
        or None.
      strict: reference-style abort on any failed pair.
    The device is the estimator's (`PoseEstimator.device`), or under a mesh
    its devices, the fallback on the first of them. After a run,
    `meter` holds its ThroughputMeter and `timer` its stage times, printed
    with the throughput: decode (host image decode), stage (pinned
    host-to-device copies), dispatch (the estimator call) and flush
    (waiting for a chunk's outputs and recording them); `process_sequence`
    with VP on adds "vp" (one block of frames). After such a run,
    `vp_frames` holds each frame's (Delta | None, ok, dbg) and `vp_used`
    which pairs took the refined rotation.
    """

    def __init__(self, images_dir, pose_estimator, ground_truth_loader,
                 euler_convention: str = "yup", chunk: int = 8,
                 mesh=None, strict: bool = False, seed: int = 0,
                 checkpoint_path=None, checkpoint_salt: str = ""):
        self.images_dir = Path(images_dir)
        self.pose_estimator = pose_estimator
        self.gt_loader = ground_truth_loader
        self.euler_convention = euler_convention
        self.chunk = chunk
        self.mesh = mesh
        self.strict = strict
        self.seed = seed
        # Per-pair results are appended as jsonl after every chunk; a
        # restarted run skips the pairs already there.
        self.checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        # Extra identity for the checkpoint hash. Callers that remap frame
        # ids to positions 0..N-1 (cli/run_kitti_sequence.py) MUST pass the
        # dataset identity here: positional frame ids match trivially across
        # different --step/--images-dir slices, so only the header hash keeps
        # a run from resuming poses computed on other image pairs.
        self.checkpoint_salt = checkpoint_salt
        self.timer = StageTimer()
        self.meter = None
        self.vp_frames = None
        self.vp_used = None

    def get_image_path(self, frame_idx):
        """{idx:06d}.png path in images_dir."""
        return self.images_dir / f"{frame_idx:06d}.png"

    def _config_hash(self) -> str:
        """Hash of everything that determines per-pair results: estimator
        config, K, seed, convention and salt. Stored in the checkpoint header
        so a checkpoint written under another configuration at the same path
        is never reused."""
        K = np.asarray(self.pose_estimator.K, dtype=np.float64)
        payload = (f"{self.pose_estimator.config!r}|{K.tobytes().hex()}|"
                   f"{self.seed}|{self.euler_convention}|"
                   f"{self.checkpoint_salt}")
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def _estimate_all_pairs(self, frames, imgs):
        """Estimate every consecutive pair; returns per-pair arrays."""
        n_pairs = len(frames) - 1
        mesh = self.mesh
        n_dev = 1 if mesh is None else mesh.size
        dev = self.pose_estimator.device if mesh is None \
            else mesh.devices.flat[0]
        K = torch.as_tensor(np.asarray(self.pose_estimator.K),
                            dtype=torch.float32, device=dev)
        cfg = self.pose_estimator.config
        chunk = min(self.chunk, n_pairs)
        if mesh is not None:
            from ..parallel.mesh import shard_pairs
            from ..parallel.sharded_estimator import \
                estimate_sequence_sharded

            chunk = max(chunk // n_dev, 1) * n_dev
        timer = self.timer = StageTimer()

        R_out = np.zeros((n_pairs, 3, 3), dtype=np.float64)
        t_out = np.zeros((n_pairs, 3), dtype=np.float64)
        valid_out = np.zeros((n_pairs,), dtype=bool)
        nm_out = np.zeros((n_pairs,), dtype=np.int64)
        ni_out = np.zeros((n_pairs,), dtype=np.int64)

        done = self._load_checkpoint(frames, R_out, t_out, valid_out,
                                     nm_out, ni_out)
        meter = ThroughputMeter(n_chips=n_dev)
        meter.start()

        def _to_device(host):
            """Host array -> device tensor; to a card through pinned memory
            without blocking, so the copy overlaps the running chunk."""
            t = torch.from_numpy(np.ascontiguousarray(host))
            if dev.type != "cuda":
                return t.to(dev)
            return t.pin_memory().to(dev, non_blocking=True)

        def _stage(start):
            """Decode one chunk's frames and enqueue their copy to the
            device(s). The padded tail repeats the last frame (same-frame
            pairs, discarded at the flush); under a mesh, device d gets the
            local+1 consecutive frames of its pairs (`_sequence_blocks`)."""
            end = min(start + chunk, n_pairs)
            pad = chunk - (end - start)
            sel1 = list(range(start, end)) + [end - 1] * pad
            if mesh is None:
                with timer.stage("decode"):
                    host = imgs[list(range(start, end + 1)) + [end] * pad]
                with timer.stage("stage"):
                    return start, end, (_to_device(host), K,
                                        _pair_keys(self.seed, sel1, dev))
            local = chunk // n_dev
            with timer.stage("decode"):
                host = imgs[_sequence_blocks(sel1, local, n_dev, n_pairs)]
            with timer.stage("stage"):
                keys = _pair_keys(self.seed, sel1, "cpu")
                fblk, kblk = shard_pairs(mesh, host,
                                         keys.reshape(n_dev, local, 2))
            return start, end, (fblk, K, kblk)

        def _dispatch(arrs):
            """Enqueue one chunk's work; (chunk, ...) outputs."""
            if mesh is None:
                return estimate_sequence_batched(*arrs, cfg=cfg, device=dev)
            out = estimate_sequence_sharded(*arrs, cfg=cfg, mesh=mesh)
            return {k: v.reshape(chunk, *v.shape[2:]) for k, v in out.items()}

        starts = [s for s in range(0, n_pairs, chunk)
                  if not all(i in done
                             for i in range(s, min(s + chunk, n_pairs)))]

        def _flush(entry):
            """Wait for a chunk's outputs and record them, in order."""
            start, end, out = entry
            n = end - start
            with timer.stage("flush"):
                host = {k: out[k][:n].cpu().numpy() for k in
                        ("R", "t", "valid", "num_matches", "num_inliers")}
                R_out[start:end] = host["R"]
                t_out[start:end] = host["t"]
                valid_out[start:end] = host["valid"]
                nm_out[start:end] = host["num_matches"]
                ni_out[start:end] = host["num_inliers"]
                meter.lap(pairs=n)
                self._append_checkpoint(frames, range(start, end), R_out,
                                        t_out, valid_out, nm_out, ni_out)

        # One chunk kept in flight: dispatch chunk c, stage chunk c+1 (decode
        # and pinned copy) while the device runs it, then flush chunk c-1.
        # Results are flushed strictly in order (the checkpoint contract).
        prev = None
        pending = _stage(starts[0]) if starts else None
        for si in range(len(starts)):
            start, end, arrs = pending
            with timer.stage("dispatch"):
                out = _dispatch(arrs)
            pending = _stage(starts[si + 1]) if si + 1 < len(starts) else None
            if prev is not None:
                _flush(prev)
            prev = (start, end, out)
        if prev is not None:
            _flush(prev)

        # Inlier-collapse fallback: pairs the work-cut profile could not
        # hold (invalid, or inliers below the profile's collapse threshold)
        # are re-estimated at the configured stronger profile, in fixed
        # pair batches of the pairs-batched entry point (under a mesh on its
        # first device, as the reference's runs on JAX's default device).
        if (cfg.fallback_profile and cfg.fallback_min_inliers > 0
                and starts):
            bad = np.where((~valid_out)
                           | (ni_out < cfg.fallback_min_inliers))[0]
            if bad.size:
                from ..config import profile_config

                fcfg = profile_config(cfg.fallback_profile)
                fb = FALLBACK_BATCH
                print(f"[INFO] Fallback: re-running {bad.size} collapsed "
                      f"pair(s) at profile {cfg.fallback_profile} "
                      f"(inliers < {cfg.fallback_min_inliers})")
                for s in range(0, bad.size, fb):
                    idxs = bad[s:s + fb]
                    sel = [int(i) for i in idxs]
                    sel += [sel[-1]] * (fb - len(sel))
                    with timer.stage("decode"):
                        h1, h2 = imgs[sel], imgs[[i + 1 for i in sel]]
                    fout = estimate_pairs_batched(
                        _to_device(h1), _to_device(h2), K,
                        _pair_keys(self.seed, sel, dev), cfg=fcfg,
                        device=dev)
                    f = {k: fout[k].cpu().numpy() for k in
                         ("R", "t", "valid", "num_matches", "num_inliers")}
                    for j, i in enumerate(idxs):
                        # adopt only a strictly healthier answer: valid
                        # and more inliers than the collapsed one
                        if f["valid"][j] and f["num_inliers"][j] > ni_out[i]:
                            R_out[i] = f["R"][j]
                            t_out[i] = f["t"][j]
                            valid_out[i] = True
                            nm_out[i] = f["num_matches"][j]
                            ni_out[i] = f["num_inliers"][j]
                self._append_checkpoint(frames, list(bad), R_out, t_out,
                                        valid_out, nm_out, ni_out)
        # a run resumed whole computed nothing: it reports no rate
        meter.stop(pairs=n_pairs if starts else 0)
        self.meter = meter
        # The total rate only: with a chunk in flight, lap c ends at chunk
        # c's flush, after chunk c+1's dispatch, so the laps after the first
        # (the reference's "steady-state" reading) do not time one chunk.
        pps = meter.pairs_per_sec_per_chip()
        if pps > 0:
            print(f"[INFO] Throughput: {pps:.2f} pairs/sec/chip "
                  f"({meter.pairs} pairs, first decode to last flush)")
            timer.print_report()
        return R_out, t_out, valid_out, nm_out

    def _load_checkpoint(self, frames, R_out, t_out, valid_out, nm_out,
                         ni_out):
        """Restore completed pairs from the jsonl checkpoint; returns the set
        of completed pair indices. Entries whose frame does not match are
        ignored (stale checkpoints from a different run)."""
        done = set()
        if self.checkpoint_path is None or not self.checkpoint_path.exists():
            return done
        n_pairs = len(frames) - 1
        lines = self.checkpoint_path.read_text().splitlines()
        # The first record must be a header carrying the config hash of the
        # run that wrote the file; anything else (or a mismatch) means
        # another configuration, so the file is moved aside, never merged.
        want = self._config_hash()
        header_ok = False
        if lines:
            try:
                header_ok = json.loads(lines[0]).get("config_hash") == want
            except json.JSONDecodeError:
                pass
        if not header_ok:
            stale = self.checkpoint_path.with_suffix(
                self.checkpoint_path.suffix + ".stale")
            self.checkpoint_path.replace(stale)
            print(f"[WARN] Checkpoint {self.checkpoint_path} was written "
                  f"with a different config (or has no header); moved the "
                  f"old file to {stale}")
            return done
        for line in lines[1:]:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            i = rec.get("pair", -1)
            if not (0 <= i < n_pairs) or rec.get("frame2") != frames[i + 1]:
                continue
            R_out[i] = np.array(rec["R"]).reshape(3, 3)
            t_out[i] = np.array(rec["t"])
            valid_out[i] = bool(rec["valid"])
            nm_out[i] = int(rec["num_matches"])
            # records without num_inliers must not re-trigger the
            # inlier-collapse fallback on resume
            ni_out[i] = int(rec.get("num_inliers", 10 ** 6))
            done.add(i)
        if done:
            print(f"[INFO] Resumed {len(done)} pairs from checkpoint "
                  f"{self.checkpoint_path}")
        return done

    def _append_checkpoint(self, frames, pair_range, R_out, t_out,
                           valid_out, nm_out, ni_out):
        if self.checkpoint_path is None:
            return
        self.checkpoint_path.parent.mkdir(parents=True, exist_ok=True)
        if not self.checkpoint_path.exists():
            self.checkpoint_path.write_text(
                json.dumps({"config_hash": self._config_hash()}) + "\n")
        with open(self.checkpoint_path, "a") as f:
            for i in pair_range:
                f.write(json.dumps({
                    "pair": int(i),
                    "frame2": int(frames[i + 1]),
                    "R": R_out[i].reshape(-1).tolist(),
                    "t": t_out[i].tolist(),
                    "valid": bool(valid_out[i]),
                    "num_matches": int(nm_out[i]),
                    "num_inliers": int(ni_out[i]),
                }) + "\n")

    def estimate_relative_poses(self, frames, imgs):
        """Raw consecutive-pair relative poses, no GT anchoring.

        Returns (R_rel (N-1,3,3), t_rel (N-1,3) unit directions,
        valid (N-1,) bool, num_matches (N-1,) int) with x2 = R x1 + t.
        """
        return self._estimate_all_pairs(list(frames), imgs)

    def process_sequence(self, frame_indices):
        """The reference's process_sequence: per-pair poses anchored to the
        GT orientation of each pair's first frame.

        Returns dict: frames, roll, pitch, yaw (np arrays), R (list of world
        rotations), t (list of (3,1) directions), valid, num_matches.
        """
        frames = list(frame_indices)
        if len(frames) < 2:
            raise ValueError("Need at least 2 frames to process")

        paths = [str(self.get_image_path(f)) for f in frames]
        imgs = LazyFrameSource(
            paths, to_gray=True,
            cache_frames=max(2 * (self.chunk + 10), 64))

        R_rel, t_rel, valid, num_matches = self._estimate_all_pairs(frames, imgs)
        if self.strict and not valid.all():
            bad = frames[int(np.argmin(valid)) + 1]
            raise RuntimeError(
                f"Pose estimation failed for pair ending at frame {bad}")

        # GT anchor: orientation of each pair's first frame, in float32 as
        # the reference computes it (no 64-bit mode there), composed with
        # the float64 relative rotations, and back to Euler in float32.
        _, rpy1 = self.gt_loader.poses_for_frames(frames[:-1])
        R_prev = euler_to_rotation(
            rpy1[:, 2], rpy1[:, 1], rpy1[:, 0],
            convention=self.euler_convention).numpy()    # (N, 3, 3) float32
        if self.pose_estimator.config.vp.enabled:
            self._refine_with_vps(frames, imgs, R_prev, R_rel, valid)
        R_world = R_prev @ R_rel                           # float64
        yaw, pitch, roll = (a.numpy() for a in rotation_to_euler(
            R_world, convention=self.euler_convention))

        return {
            "frames": frames[1:],
            "roll": roll,
            "pitch": pitch,
            "yaw": yaw,
            "R": [R_world[i] for i in range(R_world.shape[0])],
            "t": [t_rel[i].reshape(3, 1) for i in range(t_rel.shape[0])],
            "valid": valid,
            "num_matches": num_matches,
        }

    def _refine_with_vps(self, frames, imgs, R_prev, R_rel, valid):
        """VP (Manhattan) refinement of R_rel in place, GT-anchored like the
        reference's batch loop (rpe_tpu/pipeline/batch.py:400-465).

        Each frame's VP statistics are computed once, in blocks of 8 frames
        per labeling call (the last block padded by repeating its last
        frame); only the gated LM runs per pair. As in the reference, frame
        f of a block is seeded with its position f in the block (0-7), not
        its frame number, so the sampled voting draws the reference's
        pairs. RPE_VP_DEVICE=1, read at call time, votes with the tensor
        twin on the device as well (one copy back per block); the default is
        the host twin, whose labels and magnitudes come back in one copy per
        block.
        """
        from ..geometry.vp_refine import (
            manhattan_dirs_for_frames,
            manhattan_dirs_for_frames_device,
            optimize_rotation_from_vps,
            vp_cost,
        )

        cfg = self.pose_estimator.config
        dirs_fn = (manhattan_dirs_for_frames_device
                   if os.environ.get("RPE_VP_DEVICE") == "1"
                   else manhattan_dirs_for_frames)
        dev = self.pose_estimator.device
        K = np.asarray(self.pose_estimator.K, dtype=np.float64)
        stats = []
        ch = 8  # frames per labeling call (bounds device memory)
        for s in range(0, len(frames), ch):
            with self.timer.stage("vp"):
                blk = np.asarray(imgs[s:s + ch])
                pad = ch - blk.shape[0]
                if pad:
                    blk = np.concatenate(
                        [blk, np.repeat(blk[-1:], pad, axis=0)])
                got = dirs_fn(blk, K, cfg.vp, device=dev)
            stats.extend(got[:ch - pad] if pad else got)

        def reliable(entry):
            _, ok, dbg = entry
            return (ok and dbg.get("acc_max", 0.0) >= cfg.vp.acc_min
                    and dbg.get("vp2_score", 0.0) >= cfg.vp.vp2_min)

        used = np.zeros(len(frames) - 1, dtype=bool)
        for i in range(len(frames) - 1):
            if not valid[i]:
                continue
            if not (reliable(stats[i]) and reliable(stats[i + 1])):
                continue
            Delta_prev = stats[i][0]
            Delta_new = stats[i + 1][0]
            R_new_init = R_prev[i] @ R_rel[i]
            D_world = R_prev[i].T @ Delta_prev
            cost_init = vp_cost(R_new_init, Delta_new, D_world)
            R_opt = optimize_rotation_from_vps(
                R_new_init, Delta_new, D_world, cfg.vp)
            if (vp_cost(R_opt, Delta_new, D_world)
                    < cost_init - cfg.vp.cost_improve_eps):
                R_rel[i] = R_prev[i].T @ R_opt
                used[i] = True
        self.vp_frames, self.vp_used = stats, used

    def process_at_interval(self, step: int = 15):
        """Frames whose number is a multiple of `step`."""
        frame_indices = self.gt_loader.get_frame_indices(step=step)
        return self.process_sequence(frame_indices)
