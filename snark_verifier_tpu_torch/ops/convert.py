"""Host interchange between the JAX package's numpy layout and the port's
tensors.

The JAX package holds field elements as ``(..., 16)`` uint32 16-bit limbs
(``ops/limbs.py``, of which the port keeps a copy); the port holds the same
limbs as int64 tensors on a device, because CPU PyTorch lacks add, ``>>``
and ``<`` on uint32.  The values are identical, so conversion is a dtype
change.  Every function takes the target device explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from snark_verifier_tpu_torch.ops.curve import G1
from snark_verifier_tpu_torch.ops.limbs import NLIMB, ints_to_limbs


def limbs_to_tensor(arr, device) -> torch.Tensor:
    """(..., 16) uint32 (or any integer) limb array -> int64 tensor."""
    arr = np.asarray(arr)
    if arr.shape[-1:] != (NLIMB,):
        raise ValueError(f"expected a trailing limb axis of {NLIMB}, got {arr.shape}")
    return torch.as_tensor(arr.astype(np.int64), device=device)


def tensor_to_limbs(t: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> (..., 16) uint32 numpy array (the JAX layout)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def ints_to_tensor(values, device) -> torch.Tensor:
    """Canonical python ints -> (len, 16) int64 limbs (not Montgomery)."""
    return limbs_to_tensor(ints_to_limbs(list(values)), device)


def g1_from_numpy(point, device) -> G1:
    """Any (x, y, z) triple of limb arrays (a JAX G1 included) -> port G1."""
    return G1(*(limbs_to_tensor(np.asarray(c), device) for c in point))


def g1_to_numpy(point: G1):
    """Port G1 -> (x, y, z) uint32 numpy limb arrays."""
    return tuple(tensor_to_limbs(c) for c in point)


def to_torch_params(obj, device):
    """Carry what the JAX side holds as numpy over to the port: limb arrays,
    G1 coordinate triples (``g1_from_affine_ints``), packed proofs and
    instances.  Walks dicts, lists and tuples; a named triple with fields
    x, y, z becomes a port ``G1``; integer arrays become int64 tensors on
    ``device``; anything else is returned as is."""
    if isinstance(obj, tuple) and getattr(obj, "_fields", None) == ("x", "y", "z"):
        return g1_from_numpy(obj, device)
    if isinstance(obj, dict):
        return {k: to_torch_params(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_torch_params(v, device) for v in obj)
    if hasattr(obj, "__array__"):
        arr = np.asarray(obj)
        if np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_:
            return torch.as_tensor(arr if arr.dtype == np.bool_ else arr.astype(np.int64), device=device)
    return obj
