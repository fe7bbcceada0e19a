"""Carry the JAX package's parameters, as numpy arrays, into the port.

The reference keeps a model's parameters as a pytree: each dense layer a
``{"w": [in, out], "b": [out]}`` dict used as ``x @ w + b``, lists of them
for towers, bare arrays for the rest (CIN kernels, rank_param, DCN's cross
vectors).  The port's layers are ``nn.Linear`` (weight ``[out, in]``) in
submodules named after the reference's keys.  These helpers transpose and
name the arrays so that both packages compute the same function from the
same numbers.  They take numpy arrays and import nothing of JAX.

The mapping is mechanical, so the trees of the retrieval and parallel-axis
models carry across by ``params_from_jax_tree`` too: TwoTower's ``user``
MLP (nn.Linear layers), LongSeqCtrDnn's bare ``qkv`` [emb_dim, 3*H*D] and
its ``tower``, PipelinedCtrDnn's padded ``stages`` ``w`` [P, dmax, A, A]
and ``b`` (bare arrays, ``x @ w`` as in the reference), and
PipelineTrainer's stacked stage arrays (``proj_w`` ... ``head_b``, its
``params`` argument); ``params_to_jax`` maps each back.
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


# a jax key path: ``['tower'][0]['w']``, ``['rank_param']``, ``['cin'][1]``
_JAX_KEY_PATH = re.compile(r"^(\[('[^'\[\]]+'|\d+)\])+$")
_JAX_KEY = re.compile(r"\[(?:'([^']+)'|(\d+))\]")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def params_from_jax_tree(tree) -> dict:
    """A reference model's whole parameter pytree (nested dicts and lists of
    numpy arrays) -> the port's state_dict for the same model.  The port
    names its submodules after the reference's keys, so the mapping is
    mechanical: a ``{"w": [in, out], "b": [out]}`` dict is an nn.Linear
    (``weight`` transposed, ``bias``); a ``{"w", "b"}`` dict of vectors (a
    DCN cross layer) and every bare array (the CIN kernels, rank_param)
    copy as they are; list entries become indexed submodules."""
    state = {}

    def walk(node, name):
        if isinstance(node, dict):
            w = node.get("w")
            if set(node) == {"w", "b"} and np.ndim(w) == 2:
                state[f"{name}weight"] = torch.from_numpy(
                    np.array(np.asarray(w, np.float32).T, order="C"))
                state[f"{name}bias"] = torch.from_numpy(
                    np.array(node["b"], np.float32))
                return
            for k in sorted(node):
                walk(node[k], f"{name}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{name}{i}.")
        else:
            state[name[:-1]] = torch.from_numpy(np.array(node, np.float32))

    walk(tree, "")
    return state


def is_jax_param_file(names) -> bool:
    """True when npz leaf ``names`` are a reference model's params as its
    checkpoints save them (jax key paths: ``['tower'][0]['w']``)."""
    names = list(names)
    return bool(names) and all(_JAX_KEY_PATH.match(n) for n in names)


def _tree_from_key_paths(flat: dict):
    """{jax key path: array} -> the nested dicts and lists it flattens."""
    root: dict = {}
    for name, arr in flat.items():
        keys = [k if k else int(i) for k, i in _JAX_KEY.findall(name)]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in sorted(out)]
        return out

    return listify(root)


def params_from_jax_flat(flat: dict) -> dict:
    """A reference checkpoint's dense leaves {"['tower'][i]['w']": ...} ->
    the port's state_dict, through ``params_from_jax_tree``."""
    for name in flat:
        if not _JAX_KEY_PATH.match(name):
            raise KeyError(f"not a reference parameter leaf: {name!r}")
    return params_from_jax_tree(_tree_from_key_paths(flat))


def params_to_jax(state: dict) -> dict:
    """A port model's state_dict -> the reference's parameter pytree as
    numpy arrays (the inverse of ``params_from_jax_tree``): ``X.weight`` /
    ``X.bias`` of an nn.Linear become ``{"w": [in, out], "b": [out]}``,
    other leaves keep their names, and indexed submodules become lists."""
    flat = {}
    for name, v in state.items():
        parts = name.split(".")
        arr = np.array(_np(v), np.float32)
        if parts[-1] == "weight":
            parts[-1], arr = "w", np.array(arr.T, order="C")
        elif parts[-1] == "bias":
            parts[-1] = "b"
        flat["".join(f"[{p}]" if p.isdigit() else f"[{p!r}]"
                     for p in parts)] = arr
    return _tree_from_key_paths(flat)


def jax_key_paths(tree) -> dict:
    """A nested dict / list of arrays flattened to {jax key path: array},
    the names ``jax.tree_util.keystr`` gives (``['tower'][0]['w']``), as the
    reference's parameter files are keyed."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = np.asarray(node)

    walk(tree, "")
    return out
