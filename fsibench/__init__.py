"""fsibench: the benchmark of pyrmt_tpu_torch on one CUDA card (see
README.md). It imports neither JAX nor the JAX package."""
