"""The geometry layer's batched products and float sums whose order on the
card would otherwise depend on the batch (P2, csrc/fixed_order.cu).

On the card cuBLAS picks a batched GEMM's kernel, and PyTorch a
reduction's split across threads, by the number of outputs, so the same
pair summed its products in another order in a chunk of another size. On
CUDA tensors these helpers launch P2, which sums every output element over
k in ascending order (in float64, rounded once), one launch for each call
of a helper; on CPU tensors they run the plain expressions, `torch.matmul`
and `.sum(-1)`, which are batch-invariant there already.

`matmuls` takes the products that one function forms from operands that
are ready together -- a @ b, or a chain a @ (a2 @ b) whose inner product
is rounded to float32 as its own launch would round it -- in one launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..ops import kernels

MAX_JOBS = 4                # csrc/fixed_order.cu MAX_JOBS
THREADS = 256               # csrc/fixed_order.cu THREADS: outputs a block
BUFFER = 4096               # csrc/fixed_order.cu BUF: floats a pass stages
SMS = 132                   # the H100's multiprocessors: a few problems
                            # fill it


class _Job(ctypes.Structure):
    """csrc/fixed_order.cu `Job`."""
    _fields_ = [("sa", ctypes.c_longlong * 4), ("sb", ctypes.c_longlong * 4),
                ("s2", ctypes.c_longlong * 4),
                ("sam", ctypes.c_longlong), ("sak", ctypes.c_longlong),
                ("sbk", ctypes.c_longlong), ("sbn", ctypes.c_longlong),
                ("s2k", ctypes.c_longlong), ("s2p", ctypes.c_longlong),
                ("nb", ctypes.c_longlong * 4), ("m", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("k", ctypes.c_longlong),
                ("k2", ctypes.c_longlong), ("problems", ctypes.c_longlong),
                ("ppb", ctypes.c_int), ("kc", ctypes.c_int),
                ("mode", ctypes.c_int), ("blocks", ctypes.c_int)]


class _GroupArgs(ctypes.Structure):
    """csrc/fixed_order.cu `GroupArgs`."""
    _fields_ = [("job", _Job * MAX_JOBS), ("njobs", ctypes.c_int)]


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


def matmuls(*terms):
    """Up to four products at once, each term (a, b) for a @ b or
    (a, a2, b) for the chain a @ (a2 @ b): on the CPU those expressions
    with `torch.matmul`, on the card one launch of P2 for all of them.
    Returns a tuple of the results in the order of the terms."""
    if terms[0][0].device.type == "cpu":
        return tuple(torch.matmul(t[0], t[1]) if len(t) == 2 else
                     torch.matmul(t[0], torch.matmul(t[1], t[2]))
                     for t in terms)
    return fixed_order_group(terms)


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


def _broadcast_strides(shape, strides, batch):
    """The batch strides of an operand (its own batch dims `shape`,
    `strides`) expanded to `batch`: 0 where it broadcasts."""
    off = len(batch) - len(shape)
    return tuple(0 if i < off or shape[i - off] == 1 else strides[i - off]
                 for i in range(len(batch)))


def _job(a_shape, a_strides, b_shape, b_strides, x_shape=None,
         x_strides=None):
    """Output shape and argument block of one job: a @ b, b None for the
    row sums of a, x not None for the chain a @ (x @ b)."""
    if b_shape is None:                                     # row sums
        if len(a_shape) < 1:
            raise ValueError("fixed_order_sum: want at least one dimension")
        batch = tuple(a_shape[:-1])
        sizes, (sa,) = _batch_dims(batch, a_strides[:-1])
        sb = s2 = [0] * len(sizes)
        m, n, k, k2, mode = 1, 1, a_shape[-1], 0, 1
        sam, sak, sbk, sbn, s2k, s2p = 0, a_strides[-1], 0, 0, 0, 0
        shape = batch
    else:
        if len(a_shape) < 2 or len(b_shape) < 2:
            raise ValueError(f"fixed_order_bmm: shapes {a_shape} @ {b_shape}")
        inner = b_shape if x_shape is None else x_shape
        if a_shape[-1] != inner[-2] or (x_shape is not None and (
                len(x_shape) < 2 or x_shape[-1] != b_shape[-2])):
            raise ValueError(f"fixed_order_bmm: shapes {a_shape} @ "
                             f"{(x_shape, b_shape)}")
        m, k = a_shape[-2:]
        n = b_shape[-1]
        dims = [a_shape[:-2], b_shape[:-2]]
        if x_shape is not None:
            dims.append(x_shape[:-2])
        batch = tuple(torch.broadcast_shapes(*dims))
        ops = [(a_shape, a_strides), (b_shape, b_strides)]
        if x_shape is not None:
            ops.append((x_shape, x_strides))
        strides = [_broadcast_strides(s[:-2], st[:-2], batch) for s, st in ops]
        if x_shape is None:
            strides.append((0,) * len(batch))
        sam, sak = a_strides[-2:]
        sbk, sbn = b_strides[-2:]
        rows = batch
        if m * n > THREADS and x_shape is None:
            # more outputs than a block's threads: each row of a is a
            # problem of its own (1 x k @ k x n), the rows the innermost
            # batch dimension (so C keeps its layout)
            rows = batch + (m,)
            strides = [st + (d,) for st, d in zip(strides, (sam, 0, 0))]
            m, sam = 1, 0
        sizes, (sa, sb, s2) = _batch_dims(rows, *strides)
        if x_shape is None:
            k2, mode, s2k, s2p = 0, 0, 0, 0
        else:
            k2, mode = x_shape[-1], 2
            s2k, s2p = x_strides[-2:]
        shape = batch + (a_shape[-2], n)
    if len(sizes) > 4:
        raise ValueError(f"fixed_order: {len(sizes)} batch dimensions after "
                         f"merging, at most 4")
    mn = m * n
    if mn > THREADS:
        raise ValueError(f"fixed_order: {m} x {n} outputs a problem, at most "
                         f"{THREADS}")
    problems = math.prod(sizes)
    if mode == 2:
        per = k * m + k * k2 + k2 * n + k * n
        if per > BUFFER:
            raise ValueError(f"fixed_order chain: {per} floats a problem, at "
                             f"most {BUFFER}")
        ppb = max(1, min(THREADS // mn, BUFFER // per, -(-problems // SMS)))
        kc = k
    else:
        per_row = m + (n if mode == 0 else 0)
        ppb = max(1, min(THREADS // mn, BUFFER // per_row,
                         -(-problems // SMS)))
        kc = max(1, min(k, BUFFER // (ppb * per_row)))
    pad = 4 - len(sizes)
    z = (0,) * pad
    job = _Job(z + tuple(sa), z + tuple(sb), z + tuple(s2), sam, sak, sbk,
               sbn, s2k, s2p, (1,) * pad + tuple(sizes), m, n, k, k2,
               problems, ppb, kc, mode, -(-problems // ppb))
    return shape, job


@functools.lru_cache(maxsize=4096)
def _plan(keys):
    """Output shapes and the argument block of a group whose terms'
    operands (a, b, a2) have these (shape, stride, dtype, device index)
    keys, None for an absent operand (the geometry's shapes repeat every
    call, so each is planned, and its types and devices checked, once)."""
    ops = [k for k in keys if k is not None]
    if any(k[2] != torch.float32 for k in ops):
        raise ValueError(f"fixed_order_group: want float32, got "
                         f"{[k[2] for k in ops]}")
    if len({k[3] for k in ops}) != 1 or ops[0][3] < 0:
        raise ValueError(f"fixed_order_group: tensors must share one CUDA "
                         f"device, got device indices {[k[3] for k in ops]}")
    g = _GroupArgs()
    g.njobs = len(keys) // 3
    shapes = []
    for j in range(g.njobs):
        ka, kb, kx = keys[3 * j:3 * j + 3]
        shape, g.job[j] = _job(*ka[:2], *(kb[:2] if kb else (None, None)),
                               *(kx[:2] if kx else ()))
        shapes.append(shape)
    return tuple(shapes), g


def fixed_order_group(terms):
    """P2 in one launch over up to four terms: (a, b) for a @ b (batch
    dimensions broadcast as torch.matmul's), (a, None) for a.sum(-1), and
    (a, a2, b) for a @ (a2 @ b) with the inner product rounded to float32;
    any strides; CUDA float32 only. Returns the results as a tuple."""
    if not 1 <= len(terms) <= MAX_JOBS:
        raise ValueError(f"fixed_order_group: 1 to {MAX_JOBS} terms, got "
                         f"{len(terms)}")
    # each term as (a, b, a2)
    ops = [x for t in terms for x in ((t[0], t[1], None) if len(t) == 2
                                      else (t[0], t[2], t[1]))]
    shapes, g = _plan(tuple(
        None if x is None else (x.shape, x.stride(), x.dtype, x.get_device())
        for x in ops))
    a = ops[0]
    outs = tuple(torch.empty(s, dtype=torch.float32, device=a.device)
                 for s in shapes)
    ptrs = [None] * (4 * MAX_JOBS)
    for j, c in enumerate(outs):
        x, y, z = ops[3 * j:3 * j + 3]
        ptrs[4 * j:4 * j + 4] = (x.data_ptr(), None if y is None else
                                 y.data_ptr(), None if z is None else
                                 z.data_ptr(), c.data_ptr())
    _launch(a, g, ptrs)
    return outs


def _launch(t, g, ptrs):
    """Launch P2 on argument block g and the jobs' pointers (a, b, a2, c
    for each of four jobs, None where absent) on the device of `t`."""
    kernels.launch("fixed_order_bmm", _launcher(kernels.lib("fixed_order")),
                   t, ctypes.addressof(g), *ptrs)


def fixed_order_bmm(a, b):
    """P2's product mode: a (..., m, k) @ b (..., k, n), batch dimensions
    broadcast as torch.matmul's, any strides; CUDA float32 only."""
    return fixed_order_group(((a, b),))[0]


def fixed_order_sum(x):
    """P2's row-sum mode: x (..., k) -> x.sum(-1), any strides; CUDA
    float32 only."""
    return fixed_order_group(((x, None),))[0]


@functools.lru_cache(maxsize=None)
def _launcher(lib):
    """P2's launcher with its argument types set, once per loaded library,
    after holding the argument block's layout and the tiling limits to the
    source's."""
    if (lib.fixed_order_args_size() != ctypes.sizeof(_GroupArgs)
            or lib.fixed_order_threads() != THREADS
            or lib.fixed_order_buffer() != BUFFER):
        raise RuntimeError("fixed_order.cu GroupArgs or its limits disagree "
                           "with geometry/_products.py")
    fn = lib.fixed_order_group_launch
    fn.argtypes = [ctypes.c_void_p] * (2 + 4 * MAX_JOBS)
    fn.restype = ctypes.c_int
    return fn
