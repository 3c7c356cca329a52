from repro_torch.data.synthetic import Dataset, make_dataset  # noqa: F401
from repro_torch.data.partition import partition, PARTITIONERS  # noqa: F401
from repro_torch.data.pipeline import (build_client_shards, train_test_split,  # noqa: F401
                                 label_histogram)
