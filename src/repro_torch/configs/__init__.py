from repro_torch.configs.base import SamplerConfig  # noqa: F401
