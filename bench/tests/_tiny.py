"""Tiny cells for the CPU tests: each configuration at a narrow width
and each traffic mix at a few hundred images, the rest of a cell as
``BENCHMARK.json`` has it."""
from bench import harness


def manifest() -> dict:
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def cells() -> list:
    return [w["name"] for w in manifest()["workloads"]]


def full_spec(cell: str) -> dict:
    """The cell's spec at its own sizes."""
    m = manifest()
    s = harness.resolve(m, cell)
    s["manifest"] = m
    return s


def spec(cell: str) -> dict:
    s = full_spec(cell)
    cfg = s["config"]
    if cfg["family"] == "resnet18":
        cfg.update(width=4, stages=[[4, 1], [8, 2], [8, 2], [16, 2]])
    else:
        cfg.update(width_mult=0.125, dense=[16, 16])
    s["traffic"].update(n_train=256, n_test=64, clients=6, k=3)
    return s


#: ResNet-18 (arXiv:1512.03385, CIFAR form, width 64), which no cell
#: lists yet (its rate is paced by the host: PERF.md, Open questions).
#: The reference keeps the family, its FLOP count and its BatchNorm state
#: on the wire, so that a later cell needs only its files; these tests
#: hold that path.
RESNET18 = {
    "name": "resnet18-cifar10", "family": "resnet18",
    "image": [32, 32, 3], "n_classes": 10, "width": 64,
    "stages": [[64, 1], [128, 2], [256, 2], [512, 2]],
    "blocks_per_stage": 2, "bn_momentum": 0.9, "bn_eps": 1e-05,
    "init": "he_normal", "params_d": 11173962, "state_floats": 9600,
    "state_leaves": 40, "dtype": "float32",
    "precision": {"cudnn.allow_tf32": False,
                  "cuda.matmul.allow_tf32": False,
                  "cudnn.deterministic": True, "cudnn.benchmark": False},
}


def resnet_spec(mode: str, aggregation: str, wire: str,
                server_lr: float) -> dict:
    """A tiny ResNet-18 cell on the shared mix: a copy of a listed cell's
    spec with the model and the mode swapped."""
    s = spec(cells()[0])
    s["cell"] = {"name": f"resnet18-{mode}-{wire}", "chips": 1}
    s["config"] = dict(RESNET18, width=4,
                       stages=[[4, 1], [8, 2], [8, 2], [16, 2]])
    s["traffic"].update(mode=mode, aggregation=aggregation, wire=wire,
                        server_lr=server_lr)
    return s
