"""Cross-device metric reductions (port of rpe_tpu/parallel/collectives.py).

The evaluator's summary statistics are the only cross-pair reduction in
the workload. On a mesh each device reduces its own shard to five
partials; the partials meet on the mesh's first device and, when the mesh
carries a process group, are all-reduced across processes as well.
"""

from __future__ import annotations

import torch

from .mesh import pair_pieces


def sharded_error_stats(errors, valid, mesh):
    """Masked mean, std, max, min and count of per-pair errors.

    errors, valid: (B,) arrays, whole or as `shard_pairs` split them over
    'pairs'. Returns a dict of scalar tensors on the mesh's first device.
    Median needs a gather and is computed on the host by the evaluator.
    A shard with no valid entry contributes -inf to the max and +inf to the
    min, as in the reference.
    """
    dev0 = mesh.devices.flat[0]
    parts = []
    for e, v in zip(pair_pieces(mesh, errors), pair_pieces(mesh, valid)):
        vf = v.to(e.dtype)
        parts.append(torch.stack([
            (e * vf).sum(), vf.sum(), (e * e * vf).sum(),
            torch.where(v, e, -torch.inf).max(),
            torch.where(v, e, torch.inf).min()]).to(dev0))
    p = torch.stack(parts)
    sums, mx, mn = p[:, :3].sum(0), p[:, 3].max(), p[:, 4].min()
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.group)
        dist.all_reduce(mn, op=dist.ReduceOp.MIN, group=mesh.group)
    s, n, s2 = sums
    n1 = torch.clamp_min(n, 1.0)
    mean = s / n1
    var = torch.clamp_min(s2 / n1 - mean * mean, 0.0)
    return {"mean": mean, "std": torch.sqrt(var), "max": mx, "min": mn,
            "count": n}
