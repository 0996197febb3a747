"""Device and precision policy of the port's entry points.

Entry points take `device=None` and mean the CUDA card by it; without a card
they raise instead of running elsewhere. `device="cpu"` is an explicit
request for the plain PyTorch versions of the kernels (tests, and the CPU
cross-check in chip_smoke.py).

Precision: the reference runs its match -> RANSAC -> pose block under
`jax.default_matmul_precision("highest")` (rpe_tpu/pipeline/estimator.py:136)
because reduced-precision passes quantise extracted pixels and break rotation
orthonormality. `full_precision()` is the port's counterpart: TF32 off for
matmuls and cuDNN, float32 matmul precision "highest". Every entry point of
pipeline/estimator.py calls it before any work.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says so.

    A CUDA device always comes back with its index (`cuda:N`, the current
    device when none is given), so that the per-device caches keyed on it
    (the tables copied to a card once) name a real card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rpe_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def full_precision() -> None:
    """Full-float32 matmuls and convolutions (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
