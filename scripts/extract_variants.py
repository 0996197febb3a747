#!/usr/bin/env python3
"""What each step of the warp-per-slot extraction kernels' design buys:
build variants of csrc/extract_brief.cu (K2, K12) and csrc/extract_patches.cu
(K9, K10) that undo one step each, or try one more (text edits of the
repo's source, listed in VARIANTS), and time them against the repo's
kernels on one chunk's shapes, each held to the plain version.

    python3 scripts/extract_variants.py              # every variant
    python3 scripts/extract_variants.py NAME ...     # these variants

Needs a CUDA card and nvcc. Inputs as scripts/extract_breakdown.py: the 9
atlases (9, 3200, 1280) of `make_sequence(9, 376, 1241, seed=0)` and their
(9, 100, 72) band tables. Each variant is compiled with the repo's flags
for its source; for each it prints the ptxas lines, its outputs against
the plain version on the live slots (K2, K12: bit agreement; K9, K10:
patches identical, moments equal to K2's, parked slots zero) and the
queued time per call (CUDA events around 30 launches back to back,
through the launcher directly, so no wrapper host work), three times in
turns (forward, backward, forward).
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from kernel_breakdown import build_parallel  # noqa: E402
from rpe_tpu_torch.config import EstimatorConfig  # noqa: E402
from rpe_tpu_torch.ops import extract as textract  # noqa: E402
from rpe_tpu_torch.ops import kernels  # noqa: E402
from rpe_tpu_torch.ops.atlas import band_tables  # noqa: E402
from rpe_tpu_torch.ops.orb import PATCH, atlas_keypoints  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402

# name -> (library, what the variant changes, [(text in the repo source,
# its replacement)]); "(a step to try)" marks a change the repo does not take
VARIANTS = {
    "full_blur": (
        "extract_brief",
        "the blurred patch copied whole, not only within the sample radius",
        [("if (abs(r - PATCH_R) <= R && au <= R)",
          "if (lane < PATCH)")]),
    "unclamped_samples": (
        "extract_brief",
        "K2's rotated samples not clamped to the copied pixels",
        [("""    const int ix = min(max(__float2int_rn(rx), -R), R);
    const int iy = min(max(__float2int_rn(ry), -R), R);
    return (iy + PATCH_R) * PATCH + ix + PATCH_R;""",
          """    return (__float2int_rn(ry) + PATCH_R) * PATCH + __float2int_rn(rx)
           + PATCH_R;""")]),
    "disc_blur": (
        "extract_brief",
        "(a step to try) the blurred rows copied only over the pixels "
        "whose squares meet the radius-13 disc",
        [("if (abs(r - PATCH_R) <= R && au <= R)",
          "if (au < (int)((0x579abccddeeeeeull >> (4 * abs(r - PATCH_R))) "
          "& 15ull))")]),
    "warps8": (
        "extract_brief",
        "8 slots a block instead of 4",
        [("#define WARPS 4", "#define WARPS 8")]),
    "warps2": (
        "extract_brief",
        "2 slots a block instead of 4",
        [("#define WARPS 4", "#define WARPS 2")]),
    "serial_bin": (
        "extract_brief",
        "K12's bin searched serially by every lane",
        [("""        float d = -INFINITY;
        int bin = lane < NBINS ? lane : 0;
        if (lane < NBINS) d = m10 * bin_cs[lane] + m01 * bin_cs[NBINS + lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float od = __shfl_xor_sync(FULL, d, off);
            const int ob = __shfl_xor_sync(FULL, bin, off);
            if (od > d || (od == d && ob < bin)) {
                d = od;
                bin = ob;
            }
        }
        bin = __shfl_sync(FULL, bin, 0);
""", """        int bin = 0;
        float d = m10 * bin_cs[0] + m01 * bin_cs[NBINS];
        for (int b = 1; b < NBINS; ++b) {
            const float e = m10 * bin_cs[b] + m01 * bin_cs[NBINS + b];
            if (e > d) {
                d = e;
                bin = b;
            }
        }
""")]),
    "streaming_stores": (
        "extract_patches",
        "(a step to try) K9's and K10's runs stored with streaming stores "
        "(st.global.cs: evict first from L2)",
        [("o4[i] = s4[i];", "__stcs(o4 + i, s4[i]);")]),
    "warp_stores": (
        "extract_patches",
        "(a step to try) each warp stores its own slot with 4-byte stores "
        "once its copies land, no block barrier",
        [("""    __syncthreads();
    // the block's run""", """    __syncwarp();
    if (so < nslots)
        for (int i = lane; i < NPIX; i += 32)
            blur_out[(size_t)so * NPIX + i] = sb[i];
    return;
    // the block's run""")]),
    "sync_blur": (
        "extract_patches",
        "K9's and K10's blurred pixels loaded into registers and stored to "
        "shared memory, instead of copied by cp.async",
        [("""                    cp_async4(sb + (TRANSPOSED ? lane * PATCH + r
                                               : r * PATCH + lane), Bl + o);""",
          """                    sb[TRANSPOSED ? lane * PATCH + r
                               : r * PATCH + lane] = __ldg(Bl + o);""")]),
    "patch_regs": (
        "extract_patches",
        "(a step to try) K9 and K10 at 5 blocks an SM (up to 102 registers "
        "a thread) instead of 8 (64)",
        [("__launch_bounds__(WARPS * 32, 32 / WARPS)\npatch_moments_kernel",
          "__launch_bounds__(WARPS * 32, 5)\npatch_moments_kernel")]),
    "patch_warps8": (
        "extract_patches",
        "(a step to try) K9 and K10 with 8 slots a block instead of 4",
        [("#define WARPS 4", "#define WARPS 8")]),
}


LAUNCHERS = {"extract_brief": textract._brief_launcher,
             "extract_patches": textract._patch_launcher}


def variant_source(name, out_dir):
    key, _, edits = VARIANTS[name]
    src = (kernels.CSRC / kernels.SOURCES[key][0]).read_text()
    for old, new in edits:
        if old not in src:
            sys.exit(f"extract_variants: {name}: text not found in the "
                     f"source:\n{old}")
        src = src.replace(old, new)
    path = out_dir / f"{key}_{name}.cu"
    path.write_text(src)
    return path


def build(names):
    """{library: {name: launcher}} for the repo's sources of the variants'
    libraries ("repo") and each variant, compiled in parallel into
    csrc/build/variants/."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = sorted({VARIANTS[n][0] for n in names})
    specs = {f"repo_{k}": (k, kernels.CSRC / kernels.SOURCES[k][0], ())
             for k in keys}
    specs.update({n: (VARIANTS[n][0], variant_source(n, out_dir), ())
                  for n in names})
    built = build_parallel(specs, out_dir, "extract_variants")
    return {k: {"repo": LAUNCHERS[k](built[f"repo_{k}"][0]),
                **{n: LAUNCHERS[k](built[n][0]) for n in names
                   if VARIANTS[n][0] == k}} for k in keys}


def in_turns(label, libs, call, n=30):
    """Queued ms per call of each launcher in `libs`, three times in turns
    (forward, backward, forward)."""
    def queued(fn):
        call(fn)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            call(fn)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    times = {k: [] for k in libs}
    order = list(libs)
    for rep in range(3):
        for k in (order if rep % 2 == 0 else order[::-1]):
            times[k].append(queued(libs[k]))
    for k, v in times.items():
        print(f"{label} {k}: queued ms per call {[round(x, 4) for x in v]}",
              flush=True)


def main():
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"extract_variants: unknown {unknown}; known: "
                 f"{list(VARIANTS)}")
    if not torch.cuda.is_available():
        sys.exit("extract_variants: needs a CUDA card")
    dev = torch.device("cuda")
    libs = build(names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    for n in names:
        print(f"{n}: {VARIANTS[n][1]}", flush=True)
    o = EstimatorConfig().orb
    frames, _, _ = make_sequence(9, 376, 1241, seed=0)
    kp = atlas_keypoints(torch.from_numpy(frames).to(dev), o.nfeatures,
                         o.nlevels, o.scale_factor, o.fast_threshold,
                         o.max_kpts)
    atlas, blurred = kp["atlas"].contiguous(), kp["blurred"].contiguous()
    f, ha, wp = atlas.shape
    tb = band_tables(ha, wp, kp["xy_atlas"], kp["valid"], patch=PATCH,
                     cap=o.extract_cap, band=o.band)
    nb, cap = tb["tbl_x0"].shape[1:]
    live = (tb["rel_y"] >= 0).reshape(f, -1)
    pat, pairs, bin_cs = textract._brief_tables(dev)
    bits = torch.empty((f, nb * cap, 256), dtype=torch.uint8, device=dev)
    m10 = torch.empty((f, nb * cap), dtype=torch.float32, device=dev)
    m01 = torch.empty_like(m10)
    blur = torch.empty((f, nb * cap, PATCH, PATCH), device=dev)
    tabs = (atlas, blurred, tb["tbl_x0"], tb["rel_y"])
    ptrs = {"extract_brief": [t.data_ptr() for t in (
                *tabs, pat, pairs, bin_cs, bits, m10, m01)],
            "extract_patches": [t.data_ptr() for t in tabs] + [None] + [
                t.data_ptr() for t in (blur, m10, m01)]}
    stream = torch.cuda.current_stream().cuda_stream

    def caller(key, mode):
        def call(fn):
            rc = fn(mode, *ptrs[key], f, ha, wp, nb, cap, tb["band"], stream)
            if rc != 0:
                sys.exit(f"extract_variants: launch failed (cudaError {rc})")
        return call

    targs = (*tabs, tb["band"])
    if "extract_brief" in libs:
        for binned, kname in ((False, "K2"), (True, "K12")):
            want = textract.extract_brief_plain(*targs, binned=binned)[0]
            call = caller("extract_brief", int(binned))
            for name, fn in libs["extract_brief"].items():
                bits.fill_(7)
                call(fn)
                torch.cuda.synchronize()
                agree = float((bits == want)[live].float().mean())
                parked = bool((bits[~live] == 0).all())
                print(f"{kname} {name}: bit agreement {agree:.6f} on "
                      f"{int(live.sum())} live slots, parked slots zero="
                      f"{parked}", flush=True)
            in_turns(kname, libs["extract_brief"], call)
    if "extract_patches" in libs:
        _, k10, k01 = textract.extract_brief(*targs)
        for mode, kname, plain in (
                (1, "K9", textract.extract_patches_moments_plain),
                (2, "K10", textract.extract_patches_t_plain)):
            want = plain(*targs)[0]
            call = caller("extract_patches", mode)
            for name, fn in libs["extract_patches"].items():
                for t in (blur, m10, m01):
                    t.fill_(float("nan"))
                call(fn)
                torch.cuda.synchronize()
                parked = all(bool((t[~live] == 0).all())
                             for t in (blur, m10, m01))
                print(f"{kname} {name}: patches identical="
                      f"{bool(torch.equal(blur, want))}, moments equal to "
                      f"K2's={bool(torch.equal(m10, k10))}/"
                      f"{bool(torch.equal(m01, k01))}, parked slots zero="
                      f"{parked}", flush=True)
            del want
            in_turns(kname, libs["extract_patches"], call)


if __name__ == "__main__":
    main()
