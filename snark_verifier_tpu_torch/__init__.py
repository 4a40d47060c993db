"""snark_verifier_tpu_torch — the PyTorch + CUDA port of snark_verifier_tpu.

The port mirrors the JAX package's module paths (``ops/field.py`` here is
the counterpart of ``snark_verifier_tpu/ops/field.py`` there) and reuses its
host-side modules that import no JAX: the Loader trait, the native loader,
``verifier.plonk``, ``pcs.kzg``, ``system.halo2`` and ``util``.  What is new
is the device layer: a ``TorchLoader`` over int64 limb tensors, and four
hand-written CUDA kernels for Hopper (``csrc/``) that replace the Pallas
kernels on the batched succinct verify path.

Limb format at every public function: ``(..., 16)`` int64 tensors of 16-bit
limbs, little-endian, Montgomery form with R = 2^256 (MSM scalars are
canonical, transcript bytes big-endian), exactly the JAX package's layout.
"""

__version__ = "0.1.0"
