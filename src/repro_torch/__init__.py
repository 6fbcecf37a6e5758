"""PyTorch/CUDA port of the Catmull-Rom activation system.

Mirrors ``repro`` (the JAX reference) module for module:
``repro_torch/<sub>/<module>.py`` is the counterpart of
``repro/<sub>/<module>.py`` with the same public names. It imports
torch, numpy and the standard library, never jax or ``repro``. Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
