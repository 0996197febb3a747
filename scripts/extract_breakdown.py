#!/usr/bin/env python3
"""Where K2's (steered-BRIEF extraction) and K12's (its binned twin) time
goes on the card, at one chunk's shapes, and how another build of their
source compares.

    python3 scripts/extract_breakdown.py
    python3 scripts/extract_breakdown.py --against DIR   # DIR holds another
                                                         # extract_brief.cu

Needs a CUDA card and nvcc. Inputs, made from seed 0 as chip_smoke.py makes
them: the 9 atlases and blurred atlases (9, 3200, 1280) of
`make_sequence(9, 376, 1241)` and their band tables (9, 100, 72) at the
parity configuration's band 32, cap 72. For K2 and K12 it prints:
  - flushed: mean CUDA-event time of one call with the L2 flushed before
    it (chip_smoke.py's measurement; host time between the events counts
    when the card waits for the launch);
  - queued: mean CUDA-event time per call over 20 calls queued back to
    back, and the host's own time per call in that loop;
  - device: per-kernel device time from torch.profiler over 20 calls;
  - the ptxas lines (registers, spills, shared memory) and, where the
    toolkit has cuobjdump, the static SASS instruction count and its most
    frequent opcodes;
  - bits against the plain version on the live slots (agreement to six
    digits), the largest moment difference, parked slots zero;
  - the 32-byte sectors a pixel-per-lane reading of the live patches
    requests from L2 (the raw patch over the IC mask's rows, the blurred
    patch whole or within 13 pixels of the centre), counted from the
    tables, and the sectors that hold a pixel some live slot needs (raw
    under its IC mask, blurred at its samples: what device memory must
    deliver at least).
With --against DIR, DIR's extract_brief.cu (built with the same flags; its
launcher must take the repo's arguments) is timed the same way (in turns:
DIR, repo, repo, DIR) and compared with the repo's kernels: live slots
whose bits differ, bits that differ, and the largest moment difference.
"""

import argparse
import collections
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


def caller(lib):
    """A callable with extract_brief's signature: the repo's wrapper for the
    repo's library, else the same launch from `lib` (another build of
    extract_brief.cu with the repo's launcher)."""
    if lib is kernels.lib("extract_brief"):
        return extract_brief
    return functools.partial(textract._launch_brief, lib)


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
    eq = bits_k == bits_p
    agree = float(eq[live].float().mean())
    slots = int((~eq.all(-1))[live].sum())
    err = float(torch.maximum((m10_k - m10_p).abs().max(),
                              (m01_k - m01_p).abs().max()))
    parked = bool((bits_k[~live] == 0).all() and (m10_k[~live] == 0).all()
                  and (m01_k[~live] == 0).all())
    print(f"{tag}: bit agreement {agree:.6f} on {int(live.sum())} live "
          f"slots, {slots} slots and {int((~eq)[live].sum())} bits differ, "
          f"max moment difference {err:.3e}, parked slots zero={parked}",
          flush=True)


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
    print_ptxas("extract_brief", kernels.PTXAS_LOG.get("extract_brief", ""))
    print_sass("extract_brief", kernels._lib_path("extract_brief"))
    print_opcodes("extract_brief", kernels._lib_path("extract_brief"))
    libs = {"repo": kernels.lib("extract_brief")}
    if args.against:
        libs["against"] = build_against(args.against, ("extract_brief",),
                                        "extract_breakdown")["extract_brief"]
        print_opcodes("against extract_brief",
                      kernels.BUILD_DIR / "against" / "libextract_brief.so")
    calls = {tag: caller(lib) for tag, lib in libs.items()}

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
        order = ("against", "repo", "repo", "against") if args.against \
            else ("repo",)
        for tag in order:
            measure(f"{name} [{tag}]",
                    lambda: calls[tag](*targs, binned=binned), flush)


if __name__ == "__main__":
    main()
