"""Hand-written CUDA kernels (sources in ../csrc) and their plain PyTorch
versions. Importing this package builds nothing: a kernel is compiled and
loaded at its first launch on a CUDA tensor."""
