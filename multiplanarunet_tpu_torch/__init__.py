"""PyTorch / CUDA port of multiplanarunet_tpu (fused multi-view inference
on an NVIDIA H100). Mirrors the JAX package's module paths; the JAX package
stays the reference, and this package imports nothing of it or of jax."""
