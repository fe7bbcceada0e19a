"""FLOPs of a dense layer chain, forward and backward."""


def tower_flops(dims) -> int:
    """A sample's matmul FLOPs through layers ``dims[0] -> ... -> dims[-1]``:
    2 * in * out forward, twice that backward (the input's gradient, which
    reaches the embeddings, and the weight's)."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 3 * 2 * macs
