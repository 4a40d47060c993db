"""snark_verifier_tpu_torch — the PyTorch + CUDA port of snark_verifier_tpu.

The port mirrors the JAX package's module paths (``ops/field.py`` here is
the counterpart of ``snark_verifier_tpu/ops/field.py`` there) and imports
nothing of it: the host-side modules it needs (the Loader trait, the native
loader, ``verifier.plonk``, ``pcs.kzg``, the native EVM transcript, ``util``
and ``ops/limbs.py``) are copies at the same relative paths.  What is new is
the device layer: a ``TorchLoader`` over int64 limb tensors, and seven
hand-written CUDA kernels for Hopper (``csrc/``) that replace the Pallas
kernels on the batched verify and decide paths.  The main path's circuit,
deciding key and proofs are a data file (``data/standard_plonk_k8.json``).
Entry points run on the card unless the caller asks for the CPU.

Limb format at every public function: ``(..., 16)`` int64 tensors of 16-bit
limbs, little-endian, Montgomery form with R = 2^256 (MSM scalars are
canonical, transcript bytes big-endian), exactly the JAX package's layout.
"""

__version__ = "0.1.0"
