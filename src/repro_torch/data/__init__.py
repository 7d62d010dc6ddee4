from repro_torch.data.synthetic import (  # noqa: F401
    LINREG_SPECS,
    gaussian_shards,
    linreg_datasets,
    make_batch,
    metric_pairs,
    metric_test_pairs,
    split_shards,
    susy_shards,
    susy_test_set,
    token_shards,
)
