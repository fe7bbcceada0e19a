"""The ranking model zoo of the port against the JAX package, on the CPU,
with the reference's parameters carried across by
``weights.params_from_jax_tree``: WideDeep, DeepFM, DCN, XDeepFM,
RankCtrDnn, MMoE and CtrDnn's conv / expand_dim / slot_embed_dims options.

  * logits and every parameter's and the rows' gradients against the JAX
    ``apply`` and ``jax.grad``, at cvm_offset 2 and 3;
  * three passes of the single-chip Trainer against the JAX Trainer at the
    sizes of tests/test_models.py (3 slots, 2 dense, batch 32): loss,
    AUC, per-task AUCs and the table's rows;
  * the conv counter end to end (counter_label_tasks), bit-equal to the
    reference's and to a host count of the task labels;
  * slot_embed_dims' masked columns untouched; scan_steps 4 against single
    steps; a bf16 tower; the reference's errors;
  * dump_params and a reference parameter file keyed by the reference's
    paths; the multi-task metric state saved and continued.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
from paddlebox_tpu.checkpoint import save_pytree as ref_save_pytree
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.dump import dump_params as ref_dump_params
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
import paddlebox_tpu_torch.models as models
from paddlebox_tpu_torch.checkpoint import load_pytree, save_pytree
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train.dump import dump_params
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, B, EMB = 3, 2, 32, 4

# name -> (class name, constructor kwargs, table kwargs, data kind,
# trainer kwargs); data kinds: "plain" synth, "tasks" (one task label),
# "pv" (logkey page-views, PV-merged: rank_offset)
ZOO = {
    "wide_deep": ("WideDeep", dict(hidden=(16,)), {}, "plain", {}),
    "deepfm": ("DeepFM", dict(hidden=(16,)), {}, "plain", {}),
    "dcn": ("DCN", dict(hidden=(16,), n_cross=2), {}, "plain", {}),
    "xdeepfm": ("XDeepFM", dict(hidden=(16,), cin_layers=(8, 8)), {},
                "plain", {}),
    "rank_ctr": ("RankCtrDnn", dict(hidden=(16,), max_rank=3, att_out_dim=8),
                 {}, "pv", {}),
    "mmoe": ("MMoE", dict(n_tasks=2, n_experts=2, expert_hidden=(16,),
                          expert_dim=8, tower_hidden=(8,)), {}, "tasks", {}),
    "ctr_conv": ("CtrDnn", dict(hidden=(16,), layout="conv", cvm_offset=3),
                 dict(cvm_offset=3), "tasks", dict(counter_label_tasks=(1,))),
    "ctr_conv_show_filter": ("CtrDnn", dict(hidden=(16,), layout="conv",
                                            cvm_offset=3, show_filter=True),
                             dict(cvm_offset=3), "plain", {}),
    "ctr_expand": ("CtrDnn", dict(hidden=(16,), expand_dim=3),
                   dict(expand_dim=3), "plain", {}),
    "ctr_slot_dims": ("CtrDnn", dict(hidden=(16,),
                                     slot_embed_dims=((0, 2), (2, 1))),
                      {}, "plain", {}),
}
SIX = ["wide_deep", "deepfm", "dcn", "xdeepfm", "rank_ctr", "mmoe"]


def _pair(name, cvm_offset=None, **over):
    """(reference model, port model, table kwargs) of a zoo entry; the port
    model holds the reference's initial parameters (returned too)."""
    cls, kw, tkw, _, _ = ZOO[name]
    kw, tkw = dict(kw, **over), dict(tkw)
    if cvm_offset is not None:
        kw["cvm_offset"] = tkw["cvm_offset"] = cvm_offset
    width = (tkw.get("cvm_offset", 2) + EMB + tkw.get("expand_dim", 0))
    ref = getattr(ref_models, cls)(S, width, dense_dim=DENSE, **kw)
    port = getattr(models, cls)(S, width, dense_dim=DENSE, device="cpu", **kw)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(7)))
    port.load_state_dict(params_from_jax_tree(params))
    return ref, port, params, tkw


def _rank_offset(rng, n, max_rank=3):
    ro = np.full((n, 2 * max_rank + 1), -1, np.int32)
    ro[:, 0] = rng.choice([-1, 1, 2, 3], size=n)
    for k in range(max_rank):
        present = rng.random(n) < 0.7
        ro[present, 2 * k + 1] = k + 1
        ro[present, 2 * k + 2] = rng.integers(0, n, size=present.sum())
    return ro


def _inputs(rng, width, co):
    K = B * S * 2
    rows = np.zeros((K, width), np.float32)
    n = K - 10
    show = rng.integers(0, 9, size=n)
    rows[:n, 0] = show
    rows[:n, 1] = rng.integers(0, show + 1)
    for c in range(2, co):
        rows[:n, c] = rng.integers(0, rows[:n, 1] + 1)
    rows[:n, co:] = rng.normal(scale=0.5, size=(n, width - co))
    segs = np.full(K, B * S, np.int32)
    segs[:n] = np.sort(rng.integers(0, B * S, size=n))
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    return rows, segs, dense, _rank_offset(rng, B)


# float32 matmul chains summed in another order on the two CPU backends
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,cvm_offset", [
    (n, co) for n in sorted(ZOO) for co in (2, 3)
    if co == 3 or ZOO[n][1].get("layout") != "conv"  # conv needs 3 counters
])
def test_logits_and_grads_match_reference(name, cvm_offset):
    ref, port, params, tkw = _pair(name, cvm_offset)
    width = port.emb_width
    rows, segs, dense, ro = _inputs(np.random.default_rng(3), width,
                                    cvm_offset)
    extra = {"rank_offset": ro} if getattr(ref, "uses_rank_offset", False) else {}
    want = ref.apply(params, jnp.asarray(rows), jnp.asarray(segs),
                     jnp.asarray(dense), B,
                     **{k: jnp.asarray(v) for k, v in extra.items()})
    r = torch.from_numpy(rows).requires_grad_(True)
    got = port(r, torch.from_numpy(segs), torch.from_numpy(dense), B,
               **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert got.shape == want.shape == ((B, 2) if name == "mmoe" else (B,))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    cot = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)

    def loss(p, rw):
        return (ref.apply(p, rw, jnp.asarray(segs), jnp.asarray(dense), B,
                          **{k: jnp.asarray(v) for k, v in extra.items()})
                * cot).sum()

    gp, gr = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(rows))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr), **TOL)
    want_grads = params_from_jax_tree(jax.tree.map(np.asarray, gp))
    named = dict(port.named_parameters())
    assert set(named) == set(want_grads)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   err_msg=k, **TOL)
    if name == "ctr_slot_dims":
        # the masked embedx columns receive exactly zero gradient
        slot = segs % S
        co = cvm_offset
        assert not r.grad[torch.from_numpy(slot == 0), co + 2:].any()
        assert not r.grad[torch.from_numpy(slot == 2), co + 1:].any()
        assert r.grad[torch.from_numpy(slot == 1), co:].abs().sum() > 0


# --------------------------------------------------------------------------- #
# training against the reference Trainer
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def zoo_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo")
    common = dict(n_files=1, ins_per_file=128, n_sparse_slots=S,
                  vocab_per_slot=40, dense_dim=DENSE)
    return {
        "plain": write_synth_files(str(d / "plain"), seed=11, **common),
        "tasks": write_synth_files(str(d / "tasks"), seed=12,
                                   n_task_labels=1, **common),
        "pv": write_synth_files(str(d / "pv"), seed=13, with_logkey=True,
                                max_ads_per_pv=4,
                                cmatch_values=(222, 223, 1),
                                n_task_labels=1, **common),
    }


def _data_kw(kind):
    if kind == "tasks":
        return dict(n_task_labels=1)
    if kind == "pv":
        return dict(n_task_labels=1, parse_logkey=True, enable_pv_merge=True,
                    pv_batch_size=4, rank_offset="rank_offset")
    return {}


def _datasets(files, kind):
    kw = _data_kw(kind)
    out = []
    for ds in (PadBoxSlotDataset(make_synth_config(S, DENSE, B, 16, **kw),
                                 read_threads=1),
               RefDataset(ref_synth_config(S, DENSE, B, 16, **kw),
                          read_threads=1)):
        ds.set_filelist(files[kind])
        ds.load_into_memory()
        if kind == "pv":
            ds.preprocess_instance()
        out.append(ds)
    return out


TKW = dict(embedding_dim=EMB, learning_rate=0.2, initial_range=0.1)
TRKW = dict(dense_lr=1e-2, auc_buckets=1 << 10)


def _worlds(name, **trainer_over):
    """(reference trainer and table, port trainer and table), the port's
    model holding the reference trainer's initial parameters."""
    cls, kw, tkw, _, trkw = ZOO[name]
    trkw = {**TRKW, **trkw, **trainer_over}
    rconf = ref_config.SparseTableConfig(hbm_cache_rows=0,
                                         overlap_pass_boundary=False,
                                         **TKW, **tkw)
    pconf = SparseTableConfig(**TKW, **tkw)
    w = pconf.row_width
    ref_tr = RefTrainer(getattr(ref_models, cls)(S, w, dense_dim=DENSE, **kw),
                        rconf, ref_config.TrainerConfig(**trkw), seed=4)
    model = getattr(models, cls)(S, w, dense_dim=DENSE, device="cpu", **kw)
    model.load_state_dict(params_from_jax_tree(
        jax.tree.map(np.asarray, ref_tr.params)))
    tr = Trainer(model, pconf, TrainerConfig(**trkw), device="cpu")
    return (ref_tr, RefTable(rconf, seed=3),
            tr, SparseTable(pconf, seed=3, device="cpu"))


def _passes(trainer, table, ds, n):
    out = []
    for _ in range(n):
        table.begin_pass(ds.unique_keys())
        out.append(trainer.train_from_dataset(ds, table))
        table.end_pass()
    return out


def _auc_tol(m) -> float:
    """Two bucket crossings' worth of AUC for a pass's metrics."""
    pos = round(m["actual_ctr"] * m["count"])
    return 2.0 / max(pos * (m["count"] - pos), 1)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_three_passes_match_reference_trainer(name, zoo_files, monkeypatch):
    """Per-pass loss at rtol 1e-5; AUC and per-task AUCs within two bucket
    crossings: a prediction that moves by ~1e-7 can cross one of 1024
    bucket edges and move the AUC by 1 / (positives * negatives), 2.4e-4
    at 128 instances a pass; the table's rows at rtol 1e-5 / atol 1e-6
    with the counters exact."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PARSER", "0")
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    ds, ref_ds = _datasets(zoo_files, ZOO[name][3])
    ref_tr, ref_table, tr, table = _worlds(name)
    try:
        rm = _passes(ref_tr, ref_table, ref_ds, 3)
        pm = _passes(tr, table, ds, 3)
        for a, b in zip(pm, rm):
            assert a["steps"] == b["steps"] and a["count"] == b["count"] > 0
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            assert abs(a["auc"] - b["auc"]) <= _auc_tol(b)
            tasks = sorted(k for k in b if k.startswith("task"))
            assert tasks == sorted(k for k in a if k.startswith("task"))
            assert bool(tasks) == (name == "mmoe")
            for k in tasks:
                if k.endswith("/auc"):
                    t = k.split("/")[0]
                    assert abs(a[k] - b[k]) <= _auc_tol(
                        {m: b[f"{t}/{m}"] for m in ("count", "actual_ctr")}), k
                elif k.endswith("/count"):
                    assert a[k] == b[k], k
        if name == "mmoe":
            assert pm[-1]["auc"] == pytest.approx(pm[-1]["task0/auc"],
                                                  abs=1e-12)
        rs, ps = ref_table.state_dict(), table.state_dict()
        np.testing.assert_array_equal(ps["keys"], rs["keys"])
        co = table.conf.cvm_offset
        np.testing.assert_array_equal(ps["values"][:, :co],
                                      rs["values"][:, :co])
        np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5,
                                   atol=1e-6)
        if name == "ctr_expand":
            # the expand tail trained
            assert np.abs(ps["values"][:, -4:-1]).sum() > 0
        if name == "ctr_slot_dims":
            # masked embedx columns never move from their initial values:
            # a zero gradient gives a zero adagrad step
            fresh = SparseTable(table.conf, seed=3, device="cpu")
            fresh.begin_pass(ds.unique_keys())
            fresh.end_pass()
            init = fresh.state_dict()
            fresh.close()
            np.testing.assert_array_equal(init["keys"], ps["keys"])
            slot_of = {}
            for b in ds.batches():
                slot_of.update(zip(b.keys[:b.n_keys].tolist(),
                                   (b.key_segments[:b.n_keys] % S).tolist()))
            slots = np.asarray([slot_of[k] for k in ps["keys"].tolist()])
            moved = ps["values"] != init["values"]
            # slot 0 keeps 2 embedx columns, slot 2 one, slot 1 all of them
            assert not moved[slots == 0, co + 2: co + EMB].any()
            assert not moved[slots == 2, co + 1: co + EMB].any()
            assert moved[slots == 0, co: co + 2].any()
            assert moved[slots == 1, co: co + EMB].any()
    finally:
        ds.close()
        ref_ds.close()
        table.close()


def test_conv_counter_end_to_end(zoo_files, monkeypatch):
    """cvm_offset=3 table + counter_label_tasks=(1,): the third counter of
    every key holds the number of its occurrences whose instance carried
    the task label, exactly, and equals the reference's."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    ds, ref_ds = _datasets(zoo_files, "tasks")
    ref_tr, ref_table, tr, table = _worlds("ctr_conv")
    try:
        _passes(ref_tr, ref_table, ref_ds, 1)
        _passes(tr, table, ds, 1)
        want: dict = {}
        for b in ds.batches():
            n = b.n_keys
            ins = b.key_segments[:n] // S
            for k, t in zip(b.keys[:n], b.task_labels[ins, 1]):
                want[int(k)] = want.get(int(k), 0.0) + float(t)
        ps, rs = table.state_dict(), ref_table.state_dict()
        got = dict(zip(ps["keys"].tolist(), ps["values"][:, 2].tolist()))
        assert got == want and sum(want.values()) > 0
        np.testing.assert_array_equal(ps["values"][:, 2], rs["values"][:, 2])
    finally:
        ds.close()
        ref_ds.close()
        table.close()


@pytest.mark.parametrize("cvm_offset", [3])
@pytest.mark.parametrize("name", SIX + ["ctr_expand", "ctr_slot_dims"])
def test_models_handle_wide_cvm_offset(name, cvm_offset, zoo_files):
    """Every model trains a pass on a cvm_offset 3 table (the default CVM
    still emits 2 counter columns): finite loss, the reference's
    input_dim."""
    ref, port, _, tkw = _pair(name, cvm_offset)
    dim = "deep_in" if name == "deepfm" else "input_dim"
    assert getattr(port, dim) == getattr(ref, dim)
    ds, ref_ds = _datasets(zoo_files, ZOO[name][3])
    ref_ds.close()
    conf = SparseTableConfig(**TKW, **tkw)
    table = SparseTable(conf, seed=0, device="cpu")
    tr = Trainer(port, conf, TrainerConfig(**TRKW), device="cpu")
    (m,) = _passes(tr, table, ds, 1)
    assert np.isfinite(m["loss"]) and m["count"] > 0
    ds.close()
    table.close()


@pytest.mark.parametrize("name", SIX)
def test_scan_steps_match_single_steps(name, zoo_files):
    """scan_steps 4 (the group body, eager on the CPU) against one step at
    a time: bit-equal losses, metrics and table."""
    runs = []
    for k in (1, 4):
        ds, ref_ds = _datasets(zoo_files, ZOO[name][3])
        ref_ds.close()
        _, _, tr, table = _worlds(name, scan_steps=k)
        m = _passes(tr, table, ds, 2)
        runs.append(([(x["loss"], x["auc"], x["grad_norm"]) for x in m],
                     table.state_dict(),
                     {n: p.detach().clone() for n, p in
                      tr.model.named_parameters()}))
        ds.close()
        table.close()
    (m1, s1, p1), (m4, s4, p4) = runs
    assert m1 == m4
    np.testing.assert_array_equal(s1["values"], s4["values"])
    assert all(torch.equal(p1[n], p4[n]) for n in p1)


def test_bf16_tower_close_to_reference(zoo_files, monkeypatch):
    """XDeepFM with a bfloat16 compute dtype (the CIN einsums, the deep
    tower, the linear and head layers): float32 logits within the
    reference's bf16 bound of its own bf16 logits, and a pass within the
    reference's training-parity bounds (AUC 0.03, loss 0.05)."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    ref, port, params, _ = _pair("xdeepfm", compute_dtype="bfloat16")
    rows, segs, dense, _ = _inputs(np.random.default_rng(5), port.emb_width, 2)
    want = ref.apply(params, jnp.asarray(rows), jnp.asarray(segs),
                     jnp.asarray(dense), B)
    got = port(torch.from_numpy(rows), torch.from_numpy(segs),
               torch.from_numpy(dense), B)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=0.02)
    ds, ref_ds = _datasets(zoo_files, "plain")
    ref_tr, ref_table, tr, table = _worlds("xdeepfm",
                                           compute_dtype="bfloat16")
    assert tr.model.compute_dtype is torch.bfloat16
    (rm,) = _passes(ref_tr, ref_table, ref_ds, 1)
    (pm,) = _passes(tr, table, ds, 1)
    assert abs(pm["auc"] - rm["auc"]) < 0.03
    assert abs(pm["loss"] - rm["loss"]) < 0.05
    for p in tr.model.parameters():
        assert p.dtype == torch.float32
    ds.close()
    ref_ds.close()
    table.close()


# --------------------------------------------------------------------------- #
# the reference's errors
# --------------------------------------------------------------------------- #
def _error_case(case, files):
    """Runs one misuse through the port; returns the expected exception
    and message pattern."""
    if case == "expert_mesh":
        # the expert bank's divisibility, as the reference raises it
        from jax.sharding import Mesh as JaxMesh

        from paddlebox_tpu_torch.parallel import make_mesh

        match = "n_experts 6 not divisible by the 'expert' axis size 4"
        with pytest.raises(ValueError, match=match):
            ref_models.MMoE(S, 6, n_experts=6, expert_mesh=JaxMesh(
                np.array(jax.devices()[:4]), ("expert",)))
        with pytest.raises(ValueError, match=match):
            models.MMoE(S, 6, n_experts=6, device="cpu",
                        expert_mesh=make_mesh(4, device="cpu",
                                              axis_name="expert"))
        return
    if case == "counter_len":
        with pytest.raises(ValueError, match="counter_label_tasks has 2"):
            _worlds("ctr_conv", counter_label_tasks=(1, 1))
        return
    kind, name, over, exc, match = {
        "missing_task_labels": ("plain", "mmoe", {}, RuntimeError,
                                "task_label_slots"),
        "rank_offset_without_pv": ("tasks", "rank_ctr", {}, RuntimeError,
                                   "enable_pv_merge"),
        "counter_no_labels": ("plain", "ctr_conv", {}, RuntimeError,
                              "carries no task labels"),
        "counter_out_of_range": ("tasks", "ctr_conv",
                                 dict(counter_label_tasks=(2,)), ValueError,
                                 "out of range"),
    }[case]
    ds, ref_ds = _datasets(files, kind)
    ref_ds.close()
    _, _, tr, table = _worlds(name, **over)
    table.begin_pass(ds.unique_keys())
    with pytest.raises(exc, match=match):
        tr.train_from_dataset(ds, table)
    table.abort_pass()
    ds.close()
    table.close()


@pytest.mark.parametrize("case", [
    "missing_task_labels", "rank_offset_without_pv", "counter_len",
    "counter_no_labels", "counter_out_of_range", "expert_mesh",
])
def test_reference_errors(case, zoo_files):
    _error_case(case, zoo_files)


# --------------------------------------------------------------------------- #
# parameter files and metric state
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", SIX + ["ctr_slot_dims"])
def test_params_keyed_by_reference_paths(name, tmp_path):
    """dump_params writes the reference's leaf names and values for every
    zoo model, and a reference parameter file loads into the port."""
    _, port, params, _ = _pair(name)
    ref_dump_params(str(tmp_path / "ref"), params)
    dump_params(str(tmp_path / "port"), port.state_dict())
    with np.load(str(tmp_path / "ref.dense.npz")) as r, \
            np.load(str(tmp_path / "port.dense.npz")) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    ref_save_pytree(str(tmp_path / "params.npz"), params)
    cls, kw = ZOO[name][:2]
    blank = getattr(models, cls)(S, port.emb_width, dense_dim=DENSE,
                                 device="cpu", seed=99, **kw)
    loaded = load_pytree(str(tmp_path / "params.npz"), blank.state_dict())
    want = port.state_dict()
    assert set(loaded) == set(want)
    for k in want:
        assert torch.equal(loaded[k], want[k]), k


def test_multitask_metric_state_saves_and_continues(zoo_files, tmp_path):
    """last_metric_state carries the task streams: it round-trips through
    save_pytree / load_pytree and continues a pass; a bare AucState is
    refused under a multi-task model."""
    ds, ref_ds = _datasets(zoo_files, "tasks")
    ref_ds.close()
    _, _, tr, table = _worlds("mmoe")
    (m0,) = _passes(tr, table, ds, 1)
    state = tr.last_metric_state
    assert state["task"].pos.shape == (2, TRKW["auc_buckets"])
    save_pytree(str(tmp_path / "m.npz"), state)
    back = load_pytree(str(tmp_path / "m.npz"), state)
    for a, b in zip(back["task"], state["task"]):
        assert torch.equal(a, b)
    table.begin_pass(ds.unique_keys())
    with pytest.raises(ValueError, match="last_metric_state"):
        tr.train_from_dataset(ds, table, auc_state=state["auc"])
    m1 = tr.train_from_dataset(ds, table, auc_state=back)
    table.end_pass()
    assert m1["task1/count"] == 2 * m0["task1/count"]
    ds.close()
    table.close()


@pytest.mark.parametrize("name", ["mmoe", "rank_ctr"])
def test_evaluate_matches_reference(name, zoo_files, monkeypatch):
    """evaluate() after a pass: the model's extra input (rank_offset) from
    the batch, the primary task's predictions of a multi-task model; the
    AUC equals the reference's within two bucket crossings, and the table
    is untouched."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    ds, ref_ds = _datasets(zoo_files, ZOO[name][3])
    ref_tr, ref_table, tr, table = _worlds(name)
    try:
        _passes(ref_tr, ref_table, ref_ds, 1)
        _passes(tr, table, ds, 1)
        ref_table.begin_pass(ref_ds.unique_keys())
        table.begin_pass(ds.unique_keys())
        before = table.pass_state_dict()
        rm = ref_tr.evaluate(ref_ds, ref_table)
        pm = tr.evaluate(ds, table)
        np.testing.assert_array_equal(table.pass_state_dict()["values"],
                                      before["values"])
        ref_table.end_pass()
        table.end_pass()
        assert pm["count"] == rm["count"] > 0
        assert abs(pm["auc"] - rm["auc"]) <= _auc_tol(rm)
        assert not any(k.startswith("task") for k in pm)
    finally:
        ds.close()
        ref_ds.close()
        table.close()


def test_bce_gradient_at_zero_logit_matches_reference():
    """A logit of exactly 0 (a tower whose last hidden layer is all dead
    ReLUs, and a zero output bias: MMoE's small towers at initialization)
    gets the reference's gradient, -label, for either label."""
    from paddlebox_tpu.models.layers import bce_with_logits as ref_bce

    z = torch.zeros(2, requires_grad=True)
    y = torch.tensor([0.0, 1.0])
    models.bce_with_logits(z, y).sum().backward()
    want = jax.grad(lambda a: ref_bce(a, jnp.asarray(y.numpy())).sum())(
        jnp.zeros(2))
    np.testing.assert_array_equal(z.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(z.grad.numpy(), [0.0, -1.0])


def test_zoo_exports():
    for cls in ("WideDeep", "DeepFM", "DCN", "XDeepFM", "RankCtrDnn", "MMoE",
                "CtrDnn"):
        assert cls in models.__all__
    assert models.RankCtrDnn.uses_rank_offset
