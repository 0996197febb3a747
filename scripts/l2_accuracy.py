#!/usr/bin/env python3
"""How close K7 (csrc/match_l2.cu, split-TF32 tensor-core products) comes to
exact distances on the card, beside its plain version.

    python3 scripts/l2_accuracy.py       # needs a CUDA card and nvcc

On seeded SIFT-like unit-norm descriptors with duplicates
(`utils/synthetic.float_descriptors`; the card tests' 2 x 300 x 457 case and
the chunk's 8 x 4096 x 4096), it prints per case: the kernel's best_d
against the float64 distance of the same pair (mean and max), the same for
the plain version, and how many rows and columns pick another index than
the plain version. On the small case it also emulates the kernel's
products and sums (as tests/test_torch_match.py `_tf32_gram` does: per
32-dimension stage the cross products, then hi.hi, each 8-dimension k-step
added to the stage sum) with two roundings of the k-step sums, toward zero
and to nearest, and prints the mean distance from the kernel's best_d to
each: the one that fits is how the tensor cores round.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rpe_tpu_torch.ops import kernels  # noqa: E402
from rpe_tpu_torch.ops.match import mutual_nn_l2, mutual_nn_l2_plain  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision  # noqa: E402
from rpe_tpu_torch.utils.synthetic import float_descriptors  # noqa: E402


def tf32(x, rounded=True):
    """TF32 values held in float32: round to nearest (ties away), or the
    tensor cores' reading of an operand (low 13 bits dropped)."""
    u = x.contiguous().view(torch.int32)
    if rounded:
        u = u + 0x1000
    return (u & -0x2000).view(torch.float32)


def emulated_dot(a, b, toward_zero):
    """The kernel's a.b for (N1, 128) x (N2, 128), its k-step sums rounded
    toward zero or to nearest."""
    a_hi, b_hi = tf32(a), tf32(b)
    prods = [(a_hi, tf32(b - b_hi)), (tf32(a - a_hi), b_hi), (a_hi, b_hi)]
    dot = torch.zeros(a.shape[0], b.shape[0], device=a.device)
    for k0 in range(0, a.shape[1], 32):
        acc = torch.zeros_like(dot)
        for x, y in prods:
            for k in range(k0, k0 + 32, 8):
                t = acc.double() + (tf32(x[:, k:k + 8], False).double()
                                    @ tf32(y[:, k:k + 8], False).double().T)
                r = t.float()
                if toward_zero:
                    r = torch.where(r.double().abs() > t.abs(),
                                    torch.nextafter(r, torch.zeros_like(r)), r)
                acc = r
        dot = dot + acc
    return dot


def main():
    if not torch.cuda.is_available():
        sys.exit("l2_accuracy: needs a CUDA card")
    dev = torch.device("cuda")
    full_precision()
    kernels.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    for seed, p, n1, n2 in ((300 + 7 * 457, 2, 300, 457),
                            (11, 8, 4096, 4096)):
        d1, d2, v1, v2 = float_descriptors(seed, n1, n2, pairs=p, dup=True)
        v2[-1, : n2 // 2] = False
        d1, d2, v1, v2 = (torch.from_numpy(a).to(dev)
                          for a in (d1, d2, v1, v2))
        k = mutual_nn_l2(d1, d2, v1, v2)
        pl = mutual_nn_l2_plain(d1, d2, v1, v2)
        ok = v1 & (pl[0] < 3.0e38)

        def exact(idx):
            b = torch.gather(d2, 1, idx.long()[..., None].expand(-1, -1, 128))
            return ((d1.double() - b.double()) ** 2).sum(-1)

        ek = (k[0].double() - exact(k[1]))[ok]
        ep = (pl[0].double() - exact(pl[1]))[ok]
        line = (f"{p}x{n1}x{n2}: kernel - float64 mean {float(ek.mean()):.3e}"
                f" max |.| {float(ek.abs().max()):.3e}; plain - float64 mean "
                f"{float(ep.mean()):.3e} max |.| {float(ep.abs().max()):.3e};"
                f" index differs from plain on "
                f"{int(((k[1] != pl[1]) & ok).sum())} of {int(ok.sum())} rows,"
                f" {int(((k[2] != pl[2]) & v2).sum())} of {int(v2.sum())} "
                f"columns")
        if n1 * n2 <= 1 << 20:
            fit = []
            for name, tz in (("toward zero", True), ("to nearest", False)):
                diffs = []
                for q in range(p):
                    a, b = d1[q], d2[q]
                    na = (a.double() ** 2).sum(-1).float()
                    nb = (b.double() ** 2).sum(-1).float()
                    D = torch.clamp_min((na[:, None] + nb[None, :])
                                        - 2.0 * emulated_dot(a, b, tz), 0.0)
                    de = torch.gather(D, 1, k[1][q].long()[:, None])[:, 0]
                    diffs.append((k[0][q] - de)[ok[q]])
                fit.append(f"{name} {float(torch.cat(diffs).abs().mean()):.3e}")
            line += "; mean |kernel - emulation| with k-step sums " + \
                ", ".join(fit)
        print(line, flush=True)


if __name__ == "__main__":
    main()
