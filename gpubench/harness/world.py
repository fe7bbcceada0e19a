"""The program under test, driven as a user drives it: a
``PadBoxSlotDataset`` a chunk, a ``SparseTable`` and a ``Trainer`` of
``paddlebox_tpu_torch`` built from a configuration, and the pass loop
``begin_pass(census) -> train_steps -> end_pass``.

Set-up makes the initial state from the seed (every key's row in the host
store, the dense weights) and runs the check's two passes (``check_steps``)
on the window's own objects: a cold pass of three steps, one
``train_steps`` call each, then a warm pass over a census that overlaps
the first, three steps in one call as the window runs them (the cache's
hits, the prefetching producer, the next census staged).  It reads what
they left (the check's program side), runs one warm-up pass, and hands the
same objects to the window.  The window runs whole pass cycles, the chunks
in turn from where set-up left off, until ``seconds`` have passed,
synchronized at both ends.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np
import torch

from harness import spec

CHECK_STEPS = 3  # steps of each of the check's two passes


def check_passes(n_chunks: int) -> list:
    """(chunk, first batch) of the check's cold and warm pass: the first
    batches of chunk 0, then the next chunk's first batches, or chunk 0's
    next ones where it is the only chunk."""
    second = 1 % n_chunks
    return [(0, 0), (second, CHECK_STEPS if second == 0 else 0)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def feed_config(config: dict):
    """The slot schema of the generated lines: the label slots (the first
    the primary one, the others task labels), the categorical slots, one
    dense slot."""
    from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig

    labels = list(config["label_slots"])
    slots = [SlotConfig(name=n, type="float", is_dense=True, shape=(1,))
             for n in labels]
    slots += [SlotConfig(name=f"cat{i}", type="uint64")
              for i in range(int(config["n_sparse_slots"]))]
    slots.append(SlotConfig(name="dense0", type="float", is_dense=True,
                            shape=(int(config["dense_dim"]),)))
    return DataFeedConfig(slots=slots, batch_size=int(config["batch_size"]),
                          label_slot=labels[0],
                          task_label_slots=tuple(labels[1:]),
                          batch_key_capacity=int(config["batch_key_capacity"]))


def initial_state(config: dict, keys: np.ndarray, seed: int, device) -> tuple:
    """The rows of every key (``[show, clk, embed..., g2sum]`` float32 on the
    host, aligned with the sorted ``keys``) and the dense weights (xavier
    weights, zero biases), drawn on the device from the seed in a few large
    calls.  Both sides of the check start from these."""
    from reference.common import xavier_bound

    init = config["init"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n, e = keys.shape[0], int(config["embedding_dim"])
    u = torch.rand((n, 2 + e), generator=gen, device=device)
    show = torch.floor(u[:, 0] * float(init["max_show"]))
    clk = torch.floor(u[:, 1] * show * 0.5)
    emb = (u[:, 2:] * 2.0 - 1.0) * float(init["row_range"])
    rows = torch.cat([show[:, None], clk[:, None], emb,
                      torch.zeros((n, 1), device=device)], dim=1)
    params = {}
    shapes = spec.reference_model(config["model"]).param_shapes(config)
    for name, shape in shapes.items():
        if len(shape) == 2:
            b = xavier_bound(shape)
            params[name] = (torch.rand(shape, generator=gen, device=device)
                            * 2.0 - 1.0) * b
        else:
            params[name] = torch.zeros(shape, device=device)
    return rows.cpu().numpy(), params


def rows_of(keys: np.ndarray, values: np.ndarray, want: np.ndarray):
    """``values`` of the sorted ``keys`` at each of ``want``, all present."""
    pos = np.minimum(np.searchsorted(keys, want), max(keys.shape[0] - 1, 0))
    if not np.array_equal(keys[pos], want):
        raise RuntimeError("a checked key is missing from the table")
    return values[pos]


class TimedBatches:
    """The batch iterator handed to ``train_steps``: the benchmark's own
    span around each ``next()`` (on the producer thread), summed into
    ``acc`` = [seconds, batches].  ``fault`` is a test's broken batch."""

    def __init__(self, batches, acc: list, fault=None):
        self._it = iter(batches)
        self._acc = acc
        self._fault = fault

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self._it)
        self._acc[0] += time.perf_counter() - t0
        self._acc[1] += 1
        return batch if self._fault is None else self._fault(batch)


class World:
    """The program's objects for one cell and the benchmark's data."""

    def __init__(self, config: dict, data, seed: int, device, faults=()):
        from paddlebox_tpu_torch import models
        from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
        from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
        from paddlebox_tpu_torch.sparse.table import SparseTable
        from paddlebox_tpu_torch.train import Trainer

        self.config, self.data, self.device = config, data, device
        self.faults = set(faults)
        tf32 = bool(config["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        fconf = feed_config(config)
        self.datasets = []
        for chunk in data.chunks:
            ds = PadBoxSlotDataset(fconf)
            ds.set_filelist(chunk.files)
            ds.load_into_memory()
            self.datasets.append(ds)
        self.censuses = [ds.unique_keys() for ds in self.datasets]
        for c, (got, chunk) in enumerate(zip(self.censuses, data.chunks)):
            if not np.array_equal(got, chunk.census):
                raise RuntimeError(f"chunk {c}: the dataset's census differs "
                                   "from the generated keys")
        self.keys = np.unique(np.concatenate(self.censuses))
        self.rows0, self.params0 = initial_state(config, self.keys, seed,
                                                 device)
        tconf = SparseTableConfig(embedding_dim=int(config["embedding_dim"]),
                                  cvm_offset=int(config["cvm_offset"]),
                                  **config["table"])
        self.table = SparseTable(tconf, seed=0, device=device)
        self.table.load_state_dict({"keys": self.keys, "values": self.rows0})
        tr = dict(config["trainer"])
        if "bf16" in self.faults:  # the control: the port's lower precision
            tr["compute_dtype"] = "bfloat16"
        cls = getattr(models, config["program_model"])
        self.model = cls(int(config["n_sparse_slots"]), tconf.row_width,
                         dense_dim=int(config["dense_dim"]),
                         cvm_offset=int(config["cvm_offset"]),
                         device=device, **config.get("model_args", {}))
        self.model.load_state_dict(self.params0)
        self.trainer = Trainer(self.model, tconf, TrainerConfig(**tr),
                               device=device)
        if "frozen_step" in self.faults:
            self._freeze_steps()
        if "cold_hits" in self.faults:
            self._spoil_hits()
        self.batch_acc = [0.0, 0]
        self.next_chunk = 0  # the chunk the next pass trains on

    def _freeze_steps(self) -> None:
        """Fault: every step returns its state unchanged."""
        trainer = self.trainer

        def run_group(table, feeds, *a, **kw):
            k = len(feeds)
            return (torch.zeros(k, device=table.values.device),
                    torch.ones(k, dtype=torch.bool, device=table.values.device))

        trainer._run_group = run_group

    def _spoil_hits(self) -> None:
        """Fault: the cache's hits fill zero rows, a warm cache that hands
        back the wrong rows."""
        table = self.table
        fill = table._cache_plan_and_fill

        def spoiled(cache, plan, buf, n):
            fill(cache, plan, buf, n)
            if plan.n_hits:
                buf[torch.from_numpy(plan.hit_pos).to(buf.device)] = 0.0

        table._cache_plan_and_fill = spoiled

    def _batch_fault(self, batch):
        """Fault: half of the batch left out, the mean over the rest."""
        batch.ins_mask[batch.batch_size // 2:] = 0.0
        return batch

    def batches(self, chunk: int, start: int = 0, stop=None):
        it = self.datasets[chunk].batches()
        if start or stop is not None:
            it = itertools.islice(it, start, stop)
        fault = self._batch_fault if "half_batch" in self.faults else None
        return TimedBatches(it, self.batch_acc, fault)

    # -- the check's program side ----------------------------------------- #
    def check_keys(self) -> list:
        """The keys of each of the check's steps, empties left out."""
        b = int(self.config["batch_size"])
        out = []
        for chunk, first in check_passes(len(self.datasets)):
            ck = self.data.chunks[chunk]
            out += [ck.batch_keys(i * b, (i + 1) * b)
                    for i in range(first, first + CHECK_STEPS)]
        return out

    def check_steps(self) -> dict:
        """The check's two passes on the window's objects.  The cold pass:
        the first CHECK_STEPS steps of chunk 0 on a cache still empty, each
        its own ``train_steps`` call, then its pass end, which admits rows
        to the cache.  The warm pass: ``begin_pass`` on the next census,
        whose keys the cache partly holds, and its CHECK_STEPS steps in one
        ``train_steps`` call with the configured prefetch and the census
        after it staged, then its pass end.

        Reads each cold step's loss and the warm pass's mean loss, the
        first gradient of every dense leaf from Adam's first moment and of
        the rows from their g2sum, the dense parameters after the third
        and the last step, Adam's first moment after the last, and after
        the second pass end the touched rows as the host store holds
        them."""
        table, trainer = self.table, self.trainer
        n = len(self.datasets)
        (c1, f1), (c2, f2) = check_passes(n)
        steps = self.check_keys()
        step1 = np.unique(steps[0])
        touched = np.unique(np.concatenate(steps))
        out = {"losses": [], "touched": touched, "step1_keys": step1,
               "read_s": 0.0}
        table.begin_pass(self.censuses[c1])
        it = self.batches(c1, f1, f1 + CHECK_STEPS)
        for s in range(CHECK_STEPS):
            m = trainer.train_steps(table, itertools.islice(it, 1))
            out["losses"].append(float(m["loss"]))
            if s == 0:
                t0 = time.perf_counter()
                out["grad1"], out["g2sum1"] = self._first_gradients(step1)
                out["read_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        out["params3"] = self._params()
        out["read_s"] += time.perf_counter() - t0
        table.end_pass()
        table.begin_pass(self.censuses[c2])
        out["warm_hits"] = int(table.last_cache_hits)
        m = trainer.train_steps(table, self.batches(c2, f2, f2 + CHECK_STEPS),
                                next_pass_keys=self.censuses[(c2 + 1) % n])
        out["warm_loss"] = float(m["loss"])
        out["warm_steps"] = int(m["steps"])
        t0 = time.perf_counter()
        out["moment"] = self._first_moments()
        out["read_s"] += time.perf_counter() - t0
        table.end_pass()
        t0 = time.perf_counter()
        out["params"] = self._params()
        state = table.delta_state_dict()
        out["rows"] = rows_of(state["keys"], state["values"], touched)
        out["read_s"] += time.perf_counter() - t0
        self.next_chunk = (c2 + 1) % n
        return out

    def _params(self) -> dict:
        return {k: v.detach().float().cpu().clone()
                for k, v in self.model.state_dict().items()}

    def _first_moments(self) -> dict:
        """Each dense leaf's Adam first moment, bias-uncorrected."""
        opt = self.trainer.optimizer
        out = {}
        for name, p in self.model.named_parameters():
            st = opt.state.get(p, {})
            out[name] = (st["exp_avg"].detach().float().cpu().clone()
                         if "exp_avg" in st else torch.zeros(p.shape))
        return out

    def _first_gradients(self, step1: np.ndarray) -> tuple:
        """After one step: each dense leaf's gradient as Adam holds it
        (first moment / (1 - beta1)), and the g2sum of step 1's keys."""
        opt = self.trainer.optimizer
        beta1 = opt.param_groups[0].get("betas", (0.9, 0.999))[0]
        grads = {k: v / (1 - beta1) for k, v in self._first_moments().items()}
        ps = self.table.pass_state_dict()
        return grads, rows_of(ps["keys"], ps["values"], step1)[:, -1]

    # -- the window --------------------------------------------------------- #
    def warm_up(self) -> None:
        """One pass over the next chunk, the census after it staged as in
        the window."""
        n, c = len(self.datasets), self.next_chunk
        self.table.begin_pass(self.censuses[c])
        self.trainer.train_steps(self.table, self.batches(c),
                                 next_pass_keys=self.censuses[(c + 1) % n])
        self.table.end_pass()
        self.next_chunk = (c + 1) % n
        sync(self.device)

    def window(self, seconds: float, trace=None, min_passes: int = 1) -> dict:
        """Whole pass cycles from the next chunk (mod the chunks) until
        ``seconds`` have passed and at least ``min_passes`` ran.  ``trace``
        (harness/trace.py) wraps the passes it profiles; the seconds its
        start and stop take are left out.  Returns the window's counts and
        boundary readings."""
        from paddlebox_tpu_torch.utils.profiler import stage_histogram

        table, trainer, device = self.table, self.trainer, self.device
        n = len(self.datasets)
        hist = stage_histogram()
        stages0 = {s: hist.summary(stage=s) for s in ("plan", "feed", "step")}
        batch0 = list(self.batch_acc)
        w = {"samples": 0.0, "steps": 0, "passes": 0, "boundary_s": 0.0,
             "failed": 0, "pass_info": [], "begins": [], "hits": 0,
             "misses": 0, "pass_seconds": []}
        sync(device)
        t0 = time.perf_counter()
        p, traced = 0, 0.0
        while True:
            c = (self.next_chunk + p) % n
            ctx = (trace.pass_scope(p) if trace is not None
                   else contextlib.nullcontext())
            tp = time.perf_counter()
            with ctx:
                tb = time.perf_counter()
                with torch.profiler.record_function("gpubench.begin_pass"):
                    table.begin_pass(self.censuses[c])
                    sync(device)
                w["boundary_s"] += time.perf_counter() - tb
                w["begins"].append(dict(table.last_begin_breakdown))
                w["hits"] += table.last_cache_hits
                w["misses"] += table.last_cache_misses
                w["pass_info"].append((c, int(table.values.shape[0]),
                                       int(self.censuses[c].shape[0])))
                with torch.profiler.record_function("gpubench.train_steps"):
                    m = trainer.train_steps(
                        table, self.batches(c),
                        next_pass_keys=self.censuses[(c + 1) % n])
                te = time.perf_counter()
                with torch.profiler.record_function("gpubench.end_pass"):
                    table.end_pass()
                    sync(device)
                w["boundary_s"] += time.perf_counter() - te
            w["pass_seconds"].append(time.perf_counter() - tp)
            if trace is not None:
                w["pass_seconds"][-1] -= trace.overhead_s - traced
                traced = trace.overhead_s
            w["samples"] += m["samples"]
            w["steps"] += m["steps"]
            if not np.isfinite(m["loss"]):
                w["failed"] += m["steps"]
            p += 1
            spent = time.perf_counter() - t0 - traced
            if p >= min_passes and spent >= seconds:
                break
        sync(device)
        w["seconds"] = time.perf_counter() - t0 - traced
        w["passes"] = p
        w["stages"] = {}
        for s, before in stages0.items():
            after = hist.summary(stage=s)
            w["stages"][s] = (after["sum"] - before["sum"],
                              after["count"] - before["count"])
        w["batch"] = (self.batch_acc[0] - batch0[0],
                      self.batch_acc[1] - batch0[1])
        return w

    def close(self) -> None:
        self.table.close()
        for ds in self.datasets:
            ds.close()
