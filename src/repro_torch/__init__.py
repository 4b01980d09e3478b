"""PyTorch/CUDA port of Charon (``src/repro`` is the JAX reference and stays
untouched).

Two paths are ported.  The simulator: ``api.SimSpec`` ->
``core.Simulator.run`` -> ``core.Report`` for the dense decoders, ingesting
the port's own torch model (``core.model_ingest``) and, with the profiling
engine, timing operators on the card.  The executable model that serves one
dense decoder: ``launch.serve`` -> ``serving.ServingEngine`` ->
``models.Model.prefill`` / ``decode_step``, with attention and RMSNorm going
through hand-written Hopper kernels (``kernels/csrc/*.cu``) whenever the
tensors lie on a CUDA device.

The package imports ``torch`` and never ``jax`` nor anything of ``repro``.
"""
__version__ = "1.0.0"

__all__ = ["api", "configs", "core", "kernels", "models", "serving", "launch", "convert"]
