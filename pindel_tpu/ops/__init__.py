"""Search kernels: NumPy oracle (exact semantics), JAX engines and the
Pallas (Triton) scan kernel for NVIDIA GPUs."""
