"""PyTorch/CUDA port of the executable half of Charon (``src/repro`` is the
JAX reference and stays untouched).

This first slice is the path that serves one dense decoder:
``launch.serve`` -> ``serving.ServingEngine`` -> ``models.Model.prefill`` /
``decode_step``, with attention and RMSNorm going through hand-written Hopper
kernels (``kernels/csrc/*.cu``) whenever the tensors lie on a CUDA device.

The package imports ``torch`` and never ``jax`` nor anything of ``repro``.
"""
__all__ = ["configs", "kernels", "models", "serving", "launch", "convert"]
