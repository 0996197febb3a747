"""Device meshes for pair-level data parallelism (port of
rpe_tpu/parallel/mesh.py).

The workload's only cross-device axis is the independent image *pair*
axis: a 1-D mesh ('pairs') shards the sequence-batched estimator by blocks
of consecutive pairs, and the metric reductions go over it
(collectives.py). A second 'hyp' axis shards the RANSAC hypothesis batch of
each pair across devices (sharded_estimator.py).

One process drives every device of its mesh, a single controller as JAX's
`Mesh` with `shard_map` is: a mesh is a grid of torch devices, and the
sharded functions run each device's piece from the calling thread. Across
processes, `group` holds the `torch.distributed` process group over which
the collectives reduce as well (multihost.py).

A mesh may list one device more than once: the tests put four shards on
the one CPU device, and chip_smoke.py two on one card. `pairs_mesh(n)`
itself asks for n distinct cards.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an object array of torch devices (given as an array or
    nested lists of devices or names such as "cpu" and "cuda:1"), one array
    axis per name in `axis_names`; CUDA devices are kept with their index.
    `group`: the process group the collectives also reduce over, or
    None."""
    devices: np.ndarray
    axis_names: tuple
    group: object = None

    def __post_init__(self):
        src = np.asarray(self.devices, dtype=object)
        devs = np.empty(src.shape, dtype=object)
        for i in np.ndindex(src.shape):
            devs[i] = resolve_device(src[i])
        if devs.size == 0 or devs.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {devs.shape} needs one axis "
                             f"name per axis, got {self.axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def size(self) -> int:
        return self.devices.size


def _devices(n_devices, device):
    """The first n cards (device None or a CUDA device), or n entries of
    the CPU (device "cpu"; one when n is None)."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
    elif kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if count == 0 or n > count:
            # the reference's jax.devices()[:n] gives fewer devices than
            # asked; the port refuses (ROADMAP.md, Known divergences)
            raise RuntimeError(f"a mesh of {n} cards needs {n} CUDA "
                               f"devices; {count} visible")
    else:
        raise ValueError(f"meshes are of CUDA cards or the CPU, got {device}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return [torch.device(kind, None if kind == "cpu" else i)
            for i in range(n)]


def pairs_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D mesh over the pair axis: the first n cards (all of them when n
    is None), or n CPU entries with device="cpu"."""
    return Mesh(_devices(n_devices, device), ("pairs",))


def pairs_hyp_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """2-D mesh (pairs, hyp): data parallelism over pairs x sharded RANSAC
    hypotheses, hyp = 2 when n is even and > 1, else 1."""
    devs = _devices(n_devices, device)
    n = len(devs)
    hyp = 2 if n % 2 == 0 and n > 1 else 1
    return Mesh([devs[i:i + hyp] for i in range(0, n, hyp)], ("pairs", "hyp"))


class Placement(NamedTuple):
    """How an array lies on a mesh: its leading axis split over mesh axis
    `axis` in mesh order, piece i on the first device of position i along
    it; or, with `axis` None, a whole copy on every device of the mesh."""
    mesh: Mesh
    axis: str | None


def pair_sharding(mesh: Mesh) -> Placement:
    """Leading-axis placement over 'pairs' for (B, ...) arrays."""
    return Placement(mesh, "pairs")


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def _put(x, dev: torch.device) -> torch.Tensor:
    """x (numpy array or tensor) on `dev`; to a card from pinned host
    memory without blocking, so the copy overlaps work already queued.
    uint32 arrays (threefry keys) widen to int64, the port's key layout."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
        x = torch.from_numpy(x)
    if dev.type == "cuda" and x.device.type == "cpu":
        return x.contiguous().pin_memory().to(dev, non_blocking=True)
    return x.to(dev, non_blocking=True)


def place(x, placement: Placement) -> list:
    """The pieces of x (a (B, ...) numpy array or tensor) as `placement`
    says, each on its device, in mesh order."""
    mesh, axis = placement
    if axis is None:
        return [_put(x, d) for d in mesh.devices.flat]
    k = mesh.axis_names.index(axis)
    rows = np.moveaxis(mesh.devices, k, 0).reshape(mesh.devices.shape[k], -1)
    n = rows.shape[0]
    if x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split "
                         f"over the {n} positions of mesh axis '{axis}'")
    b = x.shape[0] // n
    return [_put(x[i * b:(i + 1) * b], rows[i, 0]) for i in range(n)]


def shard_pairs(mesh: Mesh, *arrays):
    """Each (B, ...) array split over 'pairs': a list of B / n pieces per
    array, piece i copied to the first device of pair position i."""
    s = pair_sharding(mesh)
    return tuple(place(a, s) for a in arrays)


def pair_pieces(mesh: Mesh, x) -> list:
    """x as `shard_pairs` left it (a list of pieces, returned as is) or
    whole (split here)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return place(x, pair_sharding(mesh))
