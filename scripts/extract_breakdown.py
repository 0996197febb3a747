#!/usr/bin/env python3
"""Where the extraction kernels' time goes on the card, at one chunk's
shapes -- K2 (steered-BRIEF extraction), K12 (its binned twin) and the
patch kernels K8, K9, K10 -- and how another build of their sources
compares.

    python3 scripts/extract_breakdown.py
    python3 scripts/extract_breakdown.py --against DIR   # DIR holds another
                                                         # extract_brief.cu
                                                         # and
                                                         # extract_patches.cu

Needs a CUDA card and nvcc. Inputs, made from seed 0 as chip_smoke.py makes
them: the 9 atlases and blurred atlases (9, 3200, 1280) of
`make_sequence(9, 376, 1241)` and their band tables (9, 100, 72) at the
parity configuration's band 32, cap 72. For each kernel it prints:
  - flushed: mean CUDA-event time of one call with the L2 flushed before
    it (chip_smoke.py's measurement; host time between the events counts
    when the card waits for the launch);
  - queued: mean CUDA-event time per call over 20 calls queued back to
    back, and the host's own time per call in that loop;
  - device: per-kernel device time from torch.profiler over 20 calls
    (the mean over the launches it recorded);
  - the ptxas lines (registers, spills, shared memory) and, where the
    toolkit has cuobjdump, the static SASS instruction count and its most
    frequent opcodes;
  - K2, K12: bits against the plain version on the live slots (agreement
    to six digits), the largest moment difference, parked slots zero;
  - K8-K10: patches identical to the plain version's, the largest moment
    difference, moments equal to K2's on the same tables, parked slots
    zero;
  - the store path's yardstick: the same times for PyTorch filling one
    K9/K10 patch output (249 MB of writes) and copying one into another;
  - the 32-byte sectors a pixel-per-lane reading of the live patches
    requests from L2 (the raw patch over the IC mask's rows, the blurred
    patch whole or within 13 pixels of the centre), counted from the
    tables, and the sectors that hold a pixel some live slot needs (raw
    under its IC mask, blurred at its samples: what device memory must
    deliver at least).
With --against DIR, DIR's extract_brief.cu and extract_patches.cu (built
with the same flags; DIR's extract_brief.cu launcher must take the repo's
arguments, its extract_patches.cu launcher the repo's or the earlier one
with the moment weights) are timed the same way (in turns: DIR, repo,
repo, DIR) and compared with the repo's kernels: whether every output is
identical, live slots whose bits differ, bits that differ, and the
largest moment difference.
"""

import argparse
import collections
import ctypes
import functools
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from kernel_breakdown import build_against, measure, print_ptxas, \
    print_sass  # noqa: E402
from rpe_tpu_torch.config import EstimatorConfig  # noqa: E402
from rpe_tpu_torch.ops import extract as textract  # noqa: E402
from rpe_tpu_torch.ops import kernels  # noqa: E402
from rpe_tpu_torch.ops.atlas import band_tables  # noqa: E402
from rpe_tpu_torch.ops.extract import extract_brief, \
    extract_brief_plain  # noqa: E402
from rpe_tpu_torch.ops.orb import PATCH, PATCH_R, _ic_angle_masks, \
    atlas_keypoints  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402


PATCH_KERNELS = (("K8", "extract_patches"), ("K9", "extract_patches_moments"),
                 ("K10", "extract_patches_t"))


def caller(lib):
    """A callable with extract_brief's signature: the repo's wrapper for the
    repo's library, else the same launch from `lib` (another build of
    extract_brief.cu with the repo's launcher)."""
    if lib is kernels.lib("extract_brief"):
        return extract_brief
    return functools.partial(textract._launch_brief, lib)


def patch_caller(lib, name):
    """A callable with the signature of K8-K10's wrapper `name`: the repo's
    wrapper for the repo's library; for another build of extract_patches.cu
    the same launch through the repo's launcher where the build exports
    its layout check, else through the earlier launcher, which also took
    the moment weights."""
    if lib is kernels.lib("extract_patches"):
        return getattr(textract, name)
    if hasattr(lib, "extract_patches_layout"):
        return functools.partial(textract._launch_patches, lib, name)
    return functools.partial(launch_patches_weights, lib, name)


@functools.lru_cache(maxsize=None)
def _weights_launcher(lib):
    fn = lib.extract_patches_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _moment_weights(dev):
    """mu, mv (961,): the IC mask times u, v, on `dev` once."""
    mask, us, vs = _ic_angle_masks()
    return tuple(torch.from_numpy((mask * w).reshape(-1)).to(dev)
                 for w in (us, vs))


def launch_patches_weights(lib, name, atlas, blurred, tbl_x0, rel_y, band):
    """K8-K10 (`name`) from a build of extract_patches.cu whose launcher
    takes (mode, atlas, blur, tbl_x0, rel_y, mu, mv, raw_out, blur_out,
    m10, m01, F, HA, WP, NB, CAP, band, stream), as the block-per-slot
    source did."""
    f, ha, wp = atlas.shape
    nb, cap = tbl_x0.shape[1:]
    dev = atlas.device
    blur = torch.empty((f, nb * cap, PATCH, PATCH), device=dev)
    if name == "extract_patches":
        raw, m10, m01 = torch.empty_like(blur), None, None
    else:
        raw, m10 = None, torch.empty((f, nb * cap), device=dev)
        m01 = torch.empty_like(m10)
    ptrs = [None if t is None else t.data_ptr() for t in (
        atlas, blurred, tbl_x0, rel_y, *_moment_weights(dev), raw, blur, m10,
        m01)]
    rc = _weights_launcher(lib)(textract._PATCH_MODES[name], *ptrs, f, ha,
                                wp, nb, cap, int(band),
                                kernels.stream_ptr(atlas))
    if rc != 0:
        sys.exit(f"extract_breakdown: {name} failed to launch (cudaError "
                 f"{rc})")
    return (raw, blur) if m10 is None else (blur, m10, m01)


def print_opcodes(tag, so, top=12):
    """The most frequent opcodes of each kernel's SASS (cuobjdump -sass)."""
    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return
    p = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                       text=True)
    for body in p.stdout.split("Function : ")[1:]:
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                body))
        mix = ", ".join(f"{k} {n}" for k, n in ops.most_common(top))
        print(f"opcodes[{tag}] {body.split()[0][:40]}: {mix}", flush=True)


def contract(tag, got, want, live):
    """Bits against the plain version (or another build) on live slots,
    the largest moment difference, parked slots zero."""
    bits_k, m10_k, m01_k = got
    bits_p, m10_p, m01_p = want
    same = all(bool(torch.equal(x, y)) for x, y in zip(got, want))
    eq = bits_k == bits_p
    agree = float(eq[live].float().mean())
    slots = int((~eq.all(-1))[live].sum())
    err = float(torch.maximum((m10_k - m10_p).abs().max(),
                              (m01_k - m01_p).abs().max()))
    parked = bool((bits_k[~live] == 0).all() and (m10_k[~live] == 0).all()
                  and (m01_k[~live] == 0).all())
    print(f"{tag}: outputs identical={same}, bit agreement {agree:.6f} on "
          f"{int(live.sum())} live slots, {slots} slots and "
          f"{int((~eq)[live].sum())} bits differ, max moment difference "
          f"{err:.3e}, parked slots zero={parked}", flush=True)


def patch_contract(tag, got, want, live, k2=None):
    """K8-K10's outputs against the plain version (or another build):
    each output identical, the largest moment difference, moments equal
    to K2's (`k2`: its m10, m01 on the same tables), parked slots zero."""
    same = [bool(torch.equal(x, y)) for x, y in zip(got, want)]
    err = 0.0 if len(got) == 2 else float(max(
        (got[1] - want[1]).abs().max(), (got[2] - want[2]).abs().max()))
    parked = all(bool((t[~live] == 0).all()) for t in got)
    k2_same = "" if k2 is None or len(got) == 2 else (
        f", moments equal to K2's={bool(torch.equal(got[1], k2[0]))}"
        f"/{bool(torch.equal(got[2], k2[1]))}")
    print(f"{tag}: outputs identical {same}, max moment difference "
          f"{err:.3e}{k2_same}, parked slots zero={parked}", flush=True)


def sector_counts(atlas, tbl_x0, rel_y, band, feet):
    """32-byte sectors that two readings of the live patches request from
    L2, a pixel per lane and patch row each -- the blurred rows whole, and
    the blurred pixels within SAMPLE_R = 13 of the centre (csrc/
    extract_brief.cu) -- with the raw rows over the IC mask; and the
    sectors that hold a pixel some live slot needs (`brief_footprints`):
    raw under its IC mask, blurred at its K2 or K12 samples."""
    f, ha, wp = atlas.shape
    dev = atlas.device
    live = rel_y >= 0
    x0 = tbl_x0.long()[live]
    mask = torch.from_numpy(_ic_angle_masks()[0]).to(dev).bool()
    half = (mask.sum(1) - 1) // 2                        # umax per row

    def span(lo, hi):                  # sectors of the columns lo..hi
        return (hi * 4) // 32 - (lo * 4) // 32 + 1

    blur = span(x0, x0 + PATCH - 1) * PATCH
    near = span(x0 + 2, x0 + PATCH - 3) * (PATCH - 4)
    raw = span(x0[:, None] + PATCH_R - half[None],
               x0[:, None] + PATCH_R + half[None]).sum(1)
    n_raw = int(raw.sum())
    n_whole, n_near = int(blur.sum()) + n_raw, int(near.sum()) + n_raw
    need = {k: chip_smoke.union_px(torch, tbl_x0, rel_y, band, ha, wp,
                                   feet[k], group=8)
            for k in ("ic", "k2", "k12")}
    print(f"sectors requested from L2: raw over the mask {n_raw}; with the "
          f"blurred rows whole {n_whole} ({n_whole * 32 / 1e6:.1f} MB), with "
          f"the blurred pixels within 13 of the centre {n_near} "
          f"({n_near * 32 / 1e6:.1f} MB); sectors holding a needed pixel: "
          f"raw {need['ic']}, blurred K2 {need['k2']}, K12 {need['k12']} "
          f"(K2 {(need['ic'] + need['k2']) * 32 / 1e6:.1f} MB, K12 "
          f"{(need['ic'] + need['k12']) * 32 / 1e6:.1f} MB)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="another copy of csrc/ to build, time and compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("extract_breakdown: needs a CUDA card")
    dev = torch.device("cuda")
    full_precision()
    kernels.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    keys = ("extract_brief", "extract_patches")
    for key in keys:
        print_ptxas(key, kernels.PTXAS_LOG.get(key, ""))
        print_sass(key, kernels._lib_path(key))
        print_opcodes(key, kernels._lib_path(key))
    libs = {"repo": {k: kernels.lib(k) for k in keys}}
    if args.against:
        libs["against"] = build_against(args.against, keys,
                                        "extract_breakdown")
        for key in keys:
            print_opcodes(f"against {key}",
                          kernels.BUILD_DIR / "against" / f"lib{key}.so")
    calls = {tag: caller(lib["extract_brief"]) for tag, lib in libs.items()}
    pcalls = {tag: {n: patch_caller(lib["extract_patches"], n)
                    for _, n in PATCH_KERNELS} for tag, lib in libs.items()}
    order = ("against", "repo", "repo", "against") if args.against \
        else ("repo",)

    o = EstimatorConfig().orb
    frames, _, _ = make_sequence(9, 376, 1241, seed=0)
    kp = atlas_keypoints(torch.from_numpy(frames).to(dev), o.nfeatures,
                         o.nlevels, o.scale_factor, o.fast_threshold,
                         o.max_kpts)
    atlas, blurred = kp["atlas"].contiguous(), kp["blurred"].contiguous()
    f, ha, wp = atlas.shape
    tb = band_tables(ha, wp, kp["xy_atlas"], kp["valid"], patch=PATCH,
                     cap=o.extract_cap, band=o.band)
    targs = (atlas, blurred, tb["tbl_x0"], tb["rel_y"], tb["band"])
    live = (tb["rel_y"] >= 0).reshape(f, -1)
    print(f"inputs: atlases {tuple(atlas.shape)}, tables "
          f"{tuple(tb['tbl_x0'].shape)}, {int(live.sum())} live of "
          f"{live.numel()} slots", flush=True)
    _, m10, m01 = extract_brief_plain(*targs)
    sector_counts(atlas, tb["tbl_x0"], tb["rel_y"], tb["band"],
                  chip_smoke.brief_footprints(torch, m10, m01, live))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    for binned, name in ((False, "K2 extract_brief"),
                         (True, "K12 extract_brief_binned")):
        plain = extract_brief_plain(*targs, binned=binned)
        outs = {tag: call(*targs, binned=binned)
                for tag, call in calls.items()}
        for tag, out in outs.items():
            contract(f"{name} [{tag} vs plain]", out, plain, live)
        if "against" in outs:
            contract(f"{name} [repo vs against]", outs["repo"],
                     outs["against"], live)
        for tag in order:
            measure(f"{name} [{tag}]",
                    lambda: calls[tag](*targs, binned=binned), flush)

    k2 = extract_brief(*targs)[1:]
    for kn, name in PATCH_KERNELS:
        plain = getattr(textract, name + "_plain")(*targs)
        outs = {tag: pc[name](*targs) for tag, pc in pcalls.items()}
        for tag, out in outs.items():
            patch_contract(f"{kn} {name} [{tag} vs plain]", out, plain, live,
                           k2)
        if "against" in outs:
            patch_contract(f"{kn} {name} [repo vs against]", outs["repo"],
                           outs["against"], live)
        del plain, outs
        for tag in order:
            measure(f"{kn} {name} [{tag}]",
                    lambda: pcalls[tag][name](*targs), flush)

    # the store path's yardstick: PyTorch filling one K9/K10 patch output
    # (writes only) and copying one into another (reads and writes)
    out = torch.empty((f, live.shape[1], PATCH, PATCH), device=dev)
    src = torch.zeros_like(out)
    print(f"yardstick: one patch output is {out.numel() * 4 / 1e6:.1f} MB",
          flush=True)
    measure("fill of one patch output", lambda: out.fill_(1.0), flush)
    measure("copy of one patch output", lambda: out.copy_(src), flush)


if __name__ == "__main__":
    main()
