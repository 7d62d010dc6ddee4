"""The fused FSGLD update kernel (CUDA, ``csrc/``), its plain PyTorch
version and the wrappers around it. Nothing is compiled at import."""
