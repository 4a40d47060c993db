"""Device routing for the kernel wrappers.

The JAX package picks Pallas or XLA from the default backend and an
environment switch (``snark_verifier_tpu/config.py``).  The port decides from
the tensors themselves: a CUDA tensor always takes the hand-written kernel,
a CPU tensor takes the kernel's plain PyTorch version.  There is no switch
that sends CUDA tensors to plain code.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; raises for mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (device,) = devices
        if device.type in ("cuda", "cpu"):
            return device.type == "cuda"
    raise ValueError(f"tensors must all be on one CUDA device or all on the CPU, got {sorted(map(str, devices))}")
