"""Carry state from the reference package into the port.

The system has no learned weights; what crosses over is its configuration,
its PRNG keys and, to hold the back half of the pipeline alone, its
detections. Everything arrives as plain Python or numpy (the port never
imports jax): `dataclasses.asdict(cfg)`, `np.asarray(key)`,
`{k: np.asarray(v) for k, v in det.items()}`.

The static tables (BRIEF pattern, IC masks, resize matrices, 5-point
monomial, flip and hidden-variable tables) are regenerated inside the port;
the tests hold each to the reference's array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import EstimatorConfig

_DET_DTYPES = {"xy": torch.float32, "angle": torch.float32,
               "level": torch.int32, "score": torch.float32,
               "bits": torch.uint8, "desc": torch.float32,
               "valid": torch.bool}


def config_from_dict(d: dict) -> EstimatorConfig:
    """The port's EstimatorConfig from `dataclasses.asdict` of the
    reference's (nested dicts become the nested frozen dataclasses)."""
    kw = {}
    for f in dataclasses.fields(EstimatorConfig):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = EstimatorConfig.__dataclass_fields__[f.name].default
        if dataclasses.is_dataclass(sub) and isinstance(v, dict):
            v = type(sub)(**v)
        kw[f.name] = v
    return EstimatorConfig(**kw)


def keys_from_numpy(k, device="cpu"):
    """(..., 2) uint32 JAX threefry keys -> the port's int64 key tensor."""
    k = np.asarray(k)
    if k.shape[-1] != 2:
        raise ValueError(f"keys must have a trailing axis of 2, got {k.shape}")
    return torch.as_tensor(k.astype(np.uint32).astype(np.int64),
                           device=device)


def detections_from_numpy(det: dict, device="cpu") -> dict:
    """A reference detection dict as numpy -> the port's tensors, keeping
    any leading frame axis: xy, angle, level, score, valid, and ORB's
    uint8 "bits" or SIFT's float32 "desc"."""
    return {k: torch.as_tensor(np.asarray(det[k]), device=device).to(dt)
            for k, dt in _DET_DTYPES.items() if k in det}
