"""What decides ``correct``: the program's six training steps of the
check's two passes (read in set-up, harness/world.py ``check_steps``: a
cold pass of three steps, a call each, and a warm pass of three steps in
one call with the cache's hits, the prefetching producer and the next
census staged) against the plain reference (``reference/``) replaying the
same six steps from the same initial state on the same lines, read from
the generated files.

Numbers compared, each against the cell's limit (``checks/<cell>.json``):

  * ``loss1_gap``: the relative gap of the first step's loss;
  * ``grad1_gap``: the worst leaf's gap between the norms of the first
    gradient, as the optimizer got it (the program's: Adam's first moment
    over 1 - beta1 for a dense leaf, the g2sum of step 1's keys for the
    rows' embeddings), over the reference's norm of that leaf or of the
    median leaf, whichever is larger;
  * ``change3_gap``: the median dense leaf's gap, so measured, between
    the norms of each leaf's change after the cold pass's three steps;
  * ``rows6_gap``: that gap of the rows' embeddings' change after the six
    steps, as the host store holds them after the second pass end (the
    sparse update through the warm cache and the write-back);
  * ``counters_gap``: the largest absolute gap of a touched key's show or
    clk increment over both passes, which is exact.

The later steps' losses, the worst leaf's change, the dense leaves'
change after the six steps (``change6``) and Adam's first moment after
the sixth step (``moment6``: the median and the worst leaf's gap between
its norms; the rows: their g2sum's growth) are reported beside them
(``extra``) and not compared: a single ReLU input within rounding of
zero takes either side in two float32 forms of one layer, which moves the
first gradient of the layers below it by up to about 1e-5 and, through
Adam's normalized step, the later losses, changes and moments by up to
about 1e-3, as far as the control moves them (PERF.md, the look).
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the gradient, moment
and change.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import spec, traffic, world
from reference import common as ref_common

NUMBERS = ("loss1_gap", "grad1_gap", "change3_gap", "rows6_gap",
           "counters_gap")
NEGLIGIBLE = 1e-3


def reference_batches(data, config: dict, touched: np.ndarray,
                      device) -> list:
    """The check's batches (world.check_passes), parsed from the chunks'
    files in plain Python, each as (inv [K] into ``touched``, seg [K],
    dense, labels)."""
    b, s = int(config["batch_size"]), int(config["n_sparse_slots"])
    tasks = len(config["label_slots"])
    out = []
    for chunk, first in world.check_passes(len(data.chunks)):
        k, g, d, lab = _lines(data.chunks[chunk].files, first * b,
                              (first + world.CHECK_STEPS) * b, s, tasks)
        for i in range(world.CHECK_STEPS):
            lo = np.searchsorted(g, i * b * s)
            hi = np.searchsorted(g, (i + 1) * b * s)
            keys = k[lo:hi]
            pos = np.searchsorted(touched, keys)
            if not np.array_equal(
                    touched[np.minimum(pos, touched.shape[0] - 1)], keys):
                raise RuntimeError("a reference key is not among the "
                                   "touched keys")
            out.append(tuple(torch.from_numpy(x).to(device) for x in (
                pos.astype(np.int64), g[lo:hi] - i * b * s,
                d[i * b:(i + 1) * b], lab[i * b:(i + 1) * b])))
    return out


def _lines(files: list, lo: int, hi: int, slots: int, tasks: int) -> tuple:
    """Lines ``lo:hi`` of the files read one after another, as
    traffic.parse_lines gives them, the segments numbered from line
    ``lo``."""
    parts, base, got = [], 0, 0
    for path in files:
        with open(path, "rb") as f:
            n = f.read().count(b"\n")
        a, z = max(lo - base, 0), min(hi - base, n)
        if z > a:
            k, g, d, lab = traffic.parse_lines(path, a, z - a, slots, tasks)
            parts.append((k, g + got * slots, d, lab))
            got += z - a
        base += n
        if base >= hi:
            break
    return tuple(np.concatenate(x) for x in zip(*parts))


def run_reference(w, prog: dict, dtype=torch.float32) -> dict:
    """The reference's six steps from the world's initial state, on the
    device, float32 with TF32 off, the dense parameters kept after the
    third."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dev = w.config, w.device
    touched = prog["touched"]
    pos = np.searchsorted(w.keys, touched)
    rows0 = w.rows0[pos]
    e = int(cfg["embedding_dim"])
    co = int(cfg["cvm_offset"])
    return ref_common.train(
        spec.reference_model(cfg["model"]), cfg,
        {k: v.to(dev) for k, v in w.params0.items()},
        torch.from_numpy(rows0[:, :co + e]).to(dev),
        torch.from_numpy(rows0[:, co + e]).to(dev),
        reference_batches(w.data, cfg, touched, dev), dtype,
        keep_params=(world.CHECK_STEPS,))


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's |norm_p - norm_r| / max(norm_r, median norm_r)."""
    kept = [k for k in ref if keep(k)]
    med = float(np.median([ref[k] for k in kept]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept}


def _norms(leaves: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def numbers(w, prog: dict, ref: dict) -> tuple:
    """The compared numbers of one run, and the extra readings beside
    them."""
    cfg = w.config
    e, co = int(cfg["embedding_dim"]), int(cfg["cvm_offset"])
    touched = prog["touched"]
    rows0 = w.rows0[np.searchsorted(w.keys, touched)]
    n_cold = world.CHECK_STEPS
    losses_p = prog["losses"] + [prog["warm_loss"]]
    losses_r = (ref["losses"][:n_cold]
                + [float(np.mean(ref["losses"][n_cold:]))])
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)]
    # first gradients
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    step1 = torch.from_numpy(np.isin(touched, prog["step1_keys"]))
    sg = ref["sparse_grad1"]
    g_ref["rows.embed"] = float(sg[step1.to(sg.device)].double().norm())
    g_prog["rows.embed"] = math.sqrt(e * float(np.sum(prog["g2sum1"],
                                                      dtype=np.float64)))
    med = float(np.median(list(g_ref.values())))
    keep = lambda k: g_ref[k] >= NEGLIGIBLE * med  # noqa: E731
    grad1 = _leaf_gaps(g_prog, g_ref, keep)
    # Adam's first moment after the last step; the rows' g2sum growth
    m_ref, m_prog = _norms(ref["moment"]), _norms(prog["moment"])
    g2_0 = rows0[:, co + e].astype(np.float64)
    m_ref["rows.embed"] = float(np.linalg.norm(
        ref["g2sum"].double().cpu().numpy() - g2_0))
    m_prog["rows.embed"] = float(np.linalg.norm(
        prog["rows"][:, co + e].astype(np.float64) - g2_0))
    moment6 = _leaf_gaps(m_prog, m_ref, keep)
    # the dense leaves' changes after the cold pass's three steps
    p3 = ref["params_at"][n_cold]
    c3_ref, c3_prog = {}, {}
    for k, p0 in w.params0.items():
        p0 = p0.detach().double().cpu()
        c3_ref[k] = float((p3[k].double().cpu() - p0).norm())
        c3_prog[k] = float((prog["params3"][k].double() - p0).norm())
    change3 = _leaf_gaps(c3_prog, c3_ref, keep)
    # changes after the six steps
    c_ref, c_prog = {}, {}
    for k, p0 in w.params0.items():
        p0 = p0.detach().double().cpu()
        c_ref[k] = float((ref["params"][k].double().cpu() - p0).norm())
        c_prog[k] = float((prog["params"][k].double() - p0).norm())
    emb0 = rows0[:, co:co + e].astype(np.float64)
    c_ref["rows.embed"] = float(np.linalg.norm(
        ref["rows"][:, co:].double().cpu().numpy() - emb0))
    c_prog["rows.embed"] = float(np.linalg.norm(
        prog["rows"][:, co:co + e].astype(np.float64) - emb0))
    change6 = _leaf_gaps(c_prog, c_ref, keep)
    inc_ref = ref["rows"][:, :co].double().cpu().numpy() - rows0[:, :co]
    inc_prog = prog["rows"][:, :co].astype(np.float64) - rows0[:, :co]
    nums = {"loss1_gap": loss_gaps[0],
            "grad1_gap": max(grad1.values()),
            "change3_gap": float(np.median(list(change3.values()))),
            "rows6_gap": change6.get("rows.embed", float("nan")),
            "counters_gap": float(np.abs(inc_prog - inc_ref).max())}
    extra = {"loss_gaps": loss_gaps,
             "change3_worst": max(change3.values()),
             "change6_median": float(np.median(list(change6.values()))),
             "change6_worst": max(change6.values()),
             "moment6_median": float(np.median(list(moment6.values()))),
             "moment6_worst": max(moment6.values()),
             "warm_hits": prog["warm_hits"], "warm_steps": prog["warm_steps"],
             "change6_leaves": change6, "grad1_leaves": grad1}
    return nums, extra


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number finite and
    within its limit."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
