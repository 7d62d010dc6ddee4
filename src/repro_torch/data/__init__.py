from repro_torch.data.synthetic import (  # noqa: F401
    gaussian_shards,
    susy_shards,
    susy_test_set,
    token_shards,
)
