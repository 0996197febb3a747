"""The geometry layer's batched products and float sums whose order on the
card would otherwise depend on the batch (P2, csrc/fixed_order.cu).

On the card cuBLAS picks a batched GEMM's kernel, and PyTorch a
reduction's split across threads, by the number of outputs, so the same
pair summed its products in another order in a chunk of another size. On
CUDA tensors these helpers launch P2, which gives every output element one
thread that sums k in ascending order (in float64, rounded once); on CPU
tensors they run the plain expressions, `torch.matmul` and `.sum(-1)`,
which are batch-invariant there already.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import kernels


class _BmmArgs(ctypes.Structure):
    """csrc/fixed_order.cu `BmmArgs`."""
    _fields_ = [("sa", ctypes.c_longlong * 4), ("sb", ctypes.c_longlong * 4),
                ("sam", ctypes.c_longlong), ("sak", ctypes.c_longlong),
                ("sbk", ctypes.c_longlong), ("sbn", ctypes.c_longlong),
                ("nb", ctypes.c_longlong * 4), ("m", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("k", ctypes.c_longlong)]


def matmul(a, b):
    """a @ b over broadcast batch dimensions, both at least 2-D float32:
    `torch.matmul` on the CPU, P2 on the card."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    return fixed_order_bmm(a, b)


def row_sum(x):
    """x.sum(-1) of float32 x: the plain sum on the CPU, P2's row-sum mode
    on the card."""
    if x.device.type == "cpu":
        return x.sum(-1)
    return fixed_order_sum(x)


def _batch_dims(shape, *strides):
    """Merge the batch dimensions that are contiguous in every operand and
    drop those of size 1: (sizes, [strides of each operand])."""
    dims = [(n, [s[d] for s in strides]) for d, n in enumerate(shape)
            if n != 1]
    out = []
    for n, st in dims:
        if out and all(p == q * n for p, q in zip(out[-1][1], st)):
            out[-1] = (out[-1][0] * n, st)
        else:
            out.append((n, st))
    return [n for n, _ in out], [[st[i] for _, st in out]
                                 for i in range(len(strides))]


def _check(name, *ts):
    for t in ts:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32, got {t.dtype}")
    if len({t.device for t in ts}) != 1 or ts[0].device.type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")


def bmm_args(batch, m, n, k, sa, sb, sam, sak, sbk, sbn):
    """P2's argument block: the batch dimensions merged (at most four),
    with each operand's strides in elements."""
    sizes, (sa, sb) = _batch_dims(batch, sa, sb)
    if len(sizes) > 4:
        raise ValueError(f"fixed_order_bmm: {len(sizes)} batch dimensions "
                         f"after merging, at most 4")
    pad = 4 - len(sizes)
    return _BmmArgs((0,) * pad + tuple(sa), (0,) * pad + tuple(sb), sam, sak,
                    sbk, sbn, (1,) * pad + tuple(sizes), m, n, k)


def _broadcast_strides(shape, strides, batch):
    """The batch strides of an operand (its own batch dims `shape`,
    `strides`) expanded to `batch`: 0 where it broadcasts."""
    off = len(batch) - len(shape)
    return tuple(0 if i < off or shape[i - off] == 1 else strides[i - off]
                 for i in range(len(batch)))


@functools.lru_cache(maxsize=4096)
def _bmm_plan(a_shape, a_strides, b_shape, b_strides):
    """Output shape and argument block of a @ b for operands of these
    shapes and strides (the geometry's shapes repeat every call)."""
    if len(a_shape) < 2 or len(b_shape) < 2 or a_shape[-1] != b_shape[-2]:
        raise ValueError(f"fixed_order_bmm: shapes {a_shape} @ {b_shape}")
    m, k = a_shape[-2:]
    n = b_shape[-1]
    batch = tuple(torch.broadcast_shapes(a_shape[:-2], b_shape[:-2]))
    g = bmm_args(batch, m, n, k,
                 _broadcast_strides(a_shape[:-2], a_strides[:-2], batch),
                 _broadcast_strides(b_shape[:-2], b_strides[:-2], batch),
                 a_strides[-2], a_strides[-1], b_strides[-2], b_strides[-1])
    return batch + (m, n), g


@functools.lru_cache(maxsize=4096)
def _sum_plan(shape, strides):
    """Output shape and argument block of the row sums of x."""
    if len(shape) < 1:
        raise ValueError("fixed_order_sum: want at least one dimension")
    batch = tuple(shape[:-1])
    return batch, bmm_args(batch, 1, 1, shape[-1], strides[:-1],
                           (0,) * len(batch), 0, strides[-1], 0, 0)


def _launch(a, b, out, g):
    """Launch P2 on argument block g (b None: row sums) into `out`."""
    kernels.launch("fixed_order_bmm", _launcher(kernels.lib("fixed_order")),
                   out, kernels.ptr(a), None if b is None else kernels.ptr(b),
                   kernels.ptr(out), ctypes.addressof(g))
    return out


def fixed_order_bmm(a, b):
    """P2's product mode: a (..., m, k) @ b (..., k, n), batch dimensions
    broadcast as torch.matmul's, any strides; CUDA float32 only."""
    _check("fixed_order_bmm", a, b)
    shape, g = _bmm_plan(tuple(a.shape), a.stride(), tuple(b.shape),
                         b.stride())
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    return _launch(a, b, out, g)


def fixed_order_sum(x):
    """P2's row-sum mode: x (..., k) -> x.sum(-1), any strides; CUDA
    float32 only."""
    _check("fixed_order_sum", x)
    shape, g = _sum_plan(tuple(x.shape), x.stride())
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    return _launch(x, None, out, g)


@functools.lru_cache(maxsize=None)
def _launcher(lib):
    """P2's launcher with its argument types set, once per loaded library,
    after holding the argument block's layout to the source's."""
    if lib.fixed_order_args_size() != ctypes.sizeof(_BmmArgs):
        raise RuntimeError("fixed_order.cu BmmArgs disagrees with "
                           "geometry/_products.py _BmmArgs")
    fn = lib.fixed_order_bmm_launch
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn
