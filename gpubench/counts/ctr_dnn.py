"""CTR-DNN's model FLOPs a sample: the tower only (embedding traffic is
the kernels' metric, not counted here)."""

from counts.mlp import tower_flops


def flops_per_sample(config: dict) -> int:
    s, d = int(config["n_sparse_slots"]), int(config["dense_dim"])
    in_dim = s * (2 + int(config["embedding_dim"])) + d
    return tower_flops([in_dim, *config["model_args"]["hidden"], 1])
