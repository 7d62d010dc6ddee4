"""PyTorch + CUDA port of the FSGLD sampler (``repro`` is the JAX
reference). Entry point: ``repro_torch.api``."""
