"""PyTorch / CUDA port of multiplanarunet_tpu (fused multi-view inference
on an NVIDIA H100). Mirrors the JAX package's module paths; the JAX package
stays the reference, and this package imports nothing of it or of jax.
Its version is the JAX package's: a project either package trained opens
in the other without a version warning."""

__version__ = "0.1.0"
