"""Threefry-2x32 counter-based keys, bit-equal to `jax.random`.

RANSAC, the homography rescue and the plane-and-parallax sampler draw their
minimal samples from JAX keys in the reference package
(rpe_tpu/geometry/ransac.py:51, :188, :274; geometry/homography.py:211), and
the VP device twin draws its voting pairs with `jax.random.randint`
(geometry/vp_refine.py:404-408).
Reproducing the generator bit for bit makes per-pair parity possible: one
key gives the same samples in both packages.

Semantics are those of `jax.random` with `jax_threefry_partitionable=True`
(the default since JAX 0.5): the counter of element i of a draw is the
64-bit pair (0, i), and 32-bit draws are `bits1 ^ bits2` of the hash.

A key is an int64 tensor of shape (..., 2) holding two uint32 words; leading
dimensions batch independent keys (the pair axis of the estimator). On the
card the hash is one launch of P8 (csrc/small_solvers.cu), a thread per
output element, where its plain version makes ~176.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .ops import kernels

_MASK = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2) under the
    key (k1, k2). All int64 tensors holding uint32 values, broadcastable;
    returns two int64 tensors of the broadcast shape. CUDA tensors launch
    P8; CPU tensors take `threefry2x32_plain`."""
    if k1.device.type == "cpu":
        return threefry2x32_plain(k1, k2, x1, x2)
    ops = (k1, k2, x1, x2)
    if any(t.dtype != torch.int64 for t in ops):
        raise ValueError(f"threefry2x32: want int64, got "
                         f"{[t.dtype for t in ops]}")
    if len({t.device for t in ops}) != 1:
        raise ValueError(f"threefry2x32: tensors must share one CUDA device, "
                         f"got {[str(t.device) for t in ops]}")
    shape, g = _broadcast_args(tuple((t.shape, t.stride()) for t in ops))
    o1 = torch.empty(shape, dtype=torch.int64, device=k1.device)
    o2 = torch.empty(shape, dtype=torch.int64, device=k1.device)
    if g.total:
        kernels.launch("threefry2x32", _launcher(kernels.lib(
            "small_solvers")), k1, k1.data_ptr(), k2.data_ptr(),
            x1.data_ptr(), x2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
            ctypes.addressof(g))
    return o1, o2


_MAX_DIMS = 6               # csrc/small_solvers.cu MAX_DIMS


class _Broadcast(ctypes.Structure):
    """csrc/small_solvers.cu `Broadcast`."""
    _fields_ = [("size", ctypes.c_longlong * _MAX_DIMS),
                ("stride", (ctypes.c_longlong * _MAX_DIMS) * 4),
                ("total", ctypes.c_longlong), ("ndim", ctypes.c_int)]


@functools.lru_cache(maxsize=1024)
def _broadcast_args(keys):
    """The output shape and P8's argument block for operands of these
    (shape, stride) keys: each operand's strides over the broadcast shape,
    0 where it broadcasts (the draws' shapes repeat every call, so each is
    planned once)."""
    shape = torch.broadcast_shapes(*(k[0] for k in keys))
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"threefry2x32: {len(shape)} dimensions, at most "
                         f"{_MAX_DIMS}")
    g = _Broadcast()
    g.ndim = len(shape)
    g.total = math.prod(shape)
    for d, n in enumerate(shape):
        g.size[d] = n
    for t, (s, st) in enumerate(keys):
        off = len(shape) - len(s)
        for d in range(off, len(shape)):
            g.stride[t][d] = 0 if s[d - off] == 1 else st[d - off]
    return shape, g


@functools.lru_cache(maxsize=None)
def _launcher(lib):
    """P8's launcher with its argument types set, once per loaded library,
    after holding the argument block's layout to the source's."""
    if (lib.small_solvers_broadcast_size() != ctypes.sizeof(_Broadcast)
            or lib.small_solvers_max_dims() != _MAX_DIMS):
        raise RuntimeError("small_solvers.cu Broadcast disagrees with "
                           "rng.py")
    fn = lib.threefry_launch
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    return fn


def threefry2x32_plain(k1, k2, x1, x2):
    """Plain version of P8: `threefry2x32` in eager int64 arithmetic."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int, device=None):
    """`jax.random.PRNGKey(seed)`: (2,) int64. Without 64-bit mode JAX takes
    any integer seed modulo 2^32 (2^31 -> [0, 2^31], -1 -> [0, 2^32 - 1],
    2^32 + 3 -> [0, 3]), and so does the port."""
    return torch.tensor([0, int(seed) % 2 ** 32], dtype=torch.int64,
                        device=device)


def _hash_counts(key, shape):
    """Hash of the counters 0..prod(shape)-1 under each key: (..., *shape)."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key, num: int = 2):
    """`jax.random.split`: (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data: int):
    """`jax.random.fold_in` with a non-negative 32-bit integer."""
    d = torch.full(key.shape[:-1], int(data) & _MASK, dtype=torch.int64,
                   device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape):
    """32-bit draws of the given shape per key: (..., *shape) int64."""
    b1, b2 = _hash_counts(key, tuple(shape))
    return b1 ^ b2


def uniform(key, shape):
    """`jax.random.uniform(key, shape)` in float32 on [0, 1)."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def randint(key, shape, minval, maxval):
    """`jax.random.randint(key, shape, minval, maxval)` for int32 output:
    (..., *shape) int64 holding int32 values. `minval` and `maxval` are
    ints or tensors of the key's leading shape (one bound per key).

    JAX's algorithm (jax/_src/random.py `_randint`): two sets of 32-bit
    draws from the halves of split(key), combined modulo the span with the
    multiplier 2^32 mod span, in uint32 arithmetic; a span <= 0 gives
    minval."""
    shape = tuple(shape)
    lead = key.shape[:-1]

    def bound(v):
        v = torch.as_tensor(v, dtype=torch.int64, device=key.device)
        v = v.clamp(-(2 ** 31), 2 ** 31 - 1)
        return v.reshape(*v.shape, *([1] * len(shape))) if v.dim() else v

    lo, hi = bound(minval), bound(maxval)
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _MASK)
    span = span.expand(*lead, *shape) if span.dim() else span
    # products and sums wrap modulo 2^32 as uint32 does (int64 products
    # wrap modulo 2^64, which keeps the low 32 bits)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((higher % span) * mult) & _MASK) + (lower % span)) & _MASK
    return lo + off % span
