"""The paper's own experiment grid (§4): models x datasets x distributions."""
from repro_torch.configs.base import FLConfig

PAPER_MODELS = ("cnn", "resnet18", "vgg16", "lstm")
PAPER_DATASETS = ("cifar10", "cifar100", "femnist", "shakespeare",
                  "sentiment140")
PAPER_DISTRIBUTIONS = ("iid", "shards", "unbalanced_dirichlet",
                       "hetero_dirichlet", "lognormal_text")

MODES = {
    "SS": FLConfig(mode="sync", aggregation="fedsgd"),
    "SA": FLConfig(mode="sync", aggregation="fedavg"),
    "AS": FLConfig(mode="semi_async", aggregation="fedsgd"),
    "AA": FLConfig(mode="semi_async", aggregation="fedavg"),
}
