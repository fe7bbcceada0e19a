"""DeepFM's model FLOPs a sample: the deep tower, the FM's first-order
layer, and its second-order term (a sum over S slots of D-wide
embeddings, squared, and the sum of squares: about 4 * S * D forward),
each three times for forward and backward."""

from counts.mlp import tower_flops


def flops_per_sample(config: dict) -> int:
    s, d = int(config["n_sparse_slots"]), int(config["dense_dim"])
    e = int(config["embedding_dim"])
    in_dim = s * (2 + e) + d
    deep = tower_flops([in_dim, *config["model_args"]["hidden"], 1])
    fm1 = tower_flops([in_dim, 1])
    fm2 = 3 * 4 * s * e
    return deep + fm1 + fm2
