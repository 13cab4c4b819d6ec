"""DeVIS in PyTorch for NVIDIA Hopper.

The port of the JAX package `devis_tpu`: the same model, parameter names and
public layouts, with a hand-written CUDA kernel in place of each Pallas kernel
on the inference path (`ops/`). Entry points run on the GPU unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.
"""
