"""Carry the JAX package's parameters, as numpy arrays, into the port.

The reference keeps its CTR-DNN tower as a list of ``{"w": [in, out],
"b": [out]}`` dicts used as ``x @ w + b``; the port's tower is a list of
``nn.Linear`` whose weight is ``[out, in]``.  These helpers transpose and
name the arrays so that both packages compute the same function from the
same numbers.  They take numpy arrays and import nothing of JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def params_from_jax(tower) -> dict:
    """Reference tower params (sequence of {"w", "b"} numpy arrays) ->
    a CtrDnn state_dict."""
    state = {}
    for i, layer in enumerate(tower):
        w = np.asarray(layer["w"], dtype=np.float32)
        b = np.asarray(layer["b"], dtype=np.float32)
        state[f"tower.{i}.weight"] = torch.from_numpy(np.array(w.T, order="C"))
        state[f"tower.{i}.bias"] = torch.from_numpy(b.copy())
    return state


def params_from_jax_stacked(tower) -> list:
    """The reference's per-position dense state (the multi-chip trainer's
    params, every leaf stacked ``[n, ...]`` over the shard positions) ->
    one CtrDnn state_dict per position, for
    ``MultiChipTrainer.load_dense_state``."""
    n = np.asarray(tower[0]["w"]).shape[0]
    return [params_from_jax([{k: np.asarray(v)[d] for k, v in layer.items()}
                             for layer in tower])
            for d in range(n)]


def table_state_from_jax(values, g2sum) -> dict:
    """The reference's device working set (values [P, W], g2sum [P]) as
    contiguous float32 tensors {"values", "g2sum"} for SparseTable."""
    return {
        "values": torch.from_numpy(np.array(values, np.float32, order="C")),
        "g2sum": torch.from_numpy(np.array(g2sum, np.float32, order="C")),
    }


def hot_block_from_jax(values, g2sum) -> dict:
    """The reference's replicated hot block (values [n, H, W], g2sum
    [n, H], one identical copy per shard position) as contiguous float32
    tensors {"hot_values", "hot_g2sum"} for ShardedSparseTable."""
    state = table_state_from_jax(values, g2sum)
    return {"hot_values": state["values"], "hot_g2sum": state["g2sum"]}


_JAX_TOWER_LEAF = re.compile(r"^\['tower'\]\[(\d+)\]\['([wb])'\]$")


def is_jax_param_file(names) -> bool:
    """True when npz leaf ``names`` are the reference's CtrDnn params as its
    checkpoints save them (jax key paths: ``['tower'][0]['w']``)."""
    names = list(names)
    return bool(names) and all(_JAX_TOWER_LEAF.match(n) for n in names)


def params_from_jax_flat(flat: dict) -> dict:
    """A reference checkpoint's dense leaves {"['tower'][i]['w']": ...} ->
    a CtrDnn state_dict, through ``params_from_jax``."""
    layers: dict = {}
    for name, arr in flat.items():
        m = _JAX_TOWER_LEAF.match(name)
        if m is None:
            raise KeyError(f"not a reference tower leaf: {name!r}")
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = arr
    return params_from_jax([layers[i] for i in sorted(layers)])


def params_to_jax(state: dict) -> dict:
    """A CtrDnn state_dict -> the reference's params {"tower": [{"w": [in,
    out], "b": [out]}, ...]} as numpy arrays (the inverse of
    ``params_from_jax``)."""
    tower = []
    i = 0
    while f"tower.{i}.weight" in state:
        w = state[f"tower.{i}.weight"]
        b = state[f"tower.{i}.bias"]
        w = w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        tower.append({"w": np.array(w.T, np.float32, order="C"),
                      "b": np.array(b, np.float32)})
        i += 1
    return {"tower": tower}
