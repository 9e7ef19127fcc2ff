"""Hand-written Hopper (sm_90a) CUDA kernels with their plain PyTorch
versions: ``ops`` dispatches a CPU tensor to ``ref`` and a CUDA tensor to
the kernel built from ``csrc/`` by ``build``."""
