"""The port's multi-chip trainer with the realized hybrid placement against
the JAX package: the hot_cold_select twin against the Pallas kernel
(interpret mode); the key codec, the placement planner, the census wire and
plan_group bit-exact on the host side; the collectives and the hybrid
pull/hot update against ``jax.lax`` under ``shard_map`` on the forced CPU
devices; and the whole slice trained by both packages over three passes in
which the hot block realizes.  Within the port: hybrid against hash and
reruns bit-exact, and the multi-chip trainer against the single-chip one.

The port runs its n shard positions in one process on the CPU, where every
kernel wrapper computes its plain twin; tests/test_torch_cuda.py and
chip_smoke.py hold the CUDA kernel against the twin on the card.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.parallel.trainer as ref_ptrainer
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.feed import HostBatch as RefBatch
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models.ctr_dnn import CtrDnn as RefCtrDnn
from paddlebox_tpu.ops.pallas_sparse import pallas_hot_cold_select
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.parallel.census import CensusExchange as RefExchange
from paddlebox_tpu.parallel.mesh import DATA_AXIS
from paddlebox_tpu.sparse.placement import PlacementPlanner as RefPlanner
from paddlebox_tpu.utils import keycodec as ref_keycodec
from paddlebox_tpu.utils.jax_compat import shard_map
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.feed import HostBatch
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ops import sparse_kernels as sk
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    collectives,
    make_mesh,
)
from paddlebox_tpu_torch.parallel import trainer as ptrainer
from paddlebox_tpu_torch.parallel.census import (
    CensusExchange,
    CensusProtocolError,
    InProcessCensusGroup,
    LoopbackTransport,
    legacy_union,
)
from paddlebox_tpu_torch.sparse.placement import PlacementPlanner
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.utils import keycodec
from paddlebox_tpu_torch.weights import hot_block_from_jax, params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, BSZ, VOCAB, PASSES = 3, 2, 16, 60, 3
# the native planner and parser of both packages: off where the port is
# held against the reference's numpy plan, on in the _native cases
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")
# the reference's placement pin (tests/test_placement.py:_train_sharded)
# with the cache off; the cached lifecycle is held in
# tests/test_torch_shardcache.py
TABLE_KW = dict(embedding_dim=4, placement_update_interval=1,
                placement_hot_capacity=64, hbm_cache_rows=0)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# kernel B6: the twin against the Pallas kernel
# --------------------------------------------------------------------------- #
# w10_k13 .. w1_k9: the card kernel's paths (K * W mod 4 = 2 and 3, a
# lone tail at K = 1, W = 1 on the scalar path)
@pytest.mark.parametrize("case", ["ragged", "empty", "all_sink", "all_hot",
                                  "one_row", "w10_k13", "w11_k9", "w3_k1",
                                  "w1_k9"])
def test_hot_cold_select_twin_matches_pallas(case):
    rng = np.random.default_rng(len(case))
    H, W, K = {"ragged": (24, 6, 200), "empty": (24, 6, 0),
               "all_sink": (24, 6, 64), "all_hot": (24, 6, 64),
               "one_row": (1, 10, 40), "w10_k13": (24, 10, 13),
               "w11_k9": (24, 11, 9), "w3_k1": (24, 3, 1),
               "w1_k9": (24, 1, 9)}[case]
    hot = rng.standard_normal((H, W)).astype(np.float32)
    cold = rng.standard_normal((K, W)).astype(np.float32)
    occ = rng.integers(0, H + 1, K).astype(np.int32)
    if case == "all_sink":
        occ[:] = H
    if case == "all_hot":
        occ = rng.integers(0, H, K).astype(np.int32)
    hot_ext = np.concatenate([hot, np.zeros((1, W), np.float32)])
    ref = np.asarray(pallas_hot_cold_select(
        jnp.asarray(hot_ext), jnp.asarray(occ), jnp.asarray(cold),
        interpret=True))
    before = dict(sk.launches)
    got = sk.hot_cold_select(_t(hot), _t(occ), _t(cold)).numpy()
    assert got.shape == (K, W)
    np.testing.assert_array_equal(got, ref)
    assert sk.launches == before  # the CPU path is the twin: no launch


def test_hot_cold_select_checks_its_inputs():
    hot = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        sk.hot_cold_select(hot, torch.zeros(5, dtype=torch.int32),
                           torch.zeros((5, 2)))
    with pytest.raises(ValueError):
        sk.hot_cold_select(hot, torch.zeros(5, dtype=torch.int64),
                           torch.zeros((5, 3)))


# --------------------------------------------------------------------------- #
# host side, bit-exact: key codec, planner, census wire
# --------------------------------------------------------------------------- #
HIGH_KEYS = np.array(
    [0, 1, 127, 128, 2**32, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 2,
     2**64 - 1], np.uint64)


def test_keycodec_bytes_match_reference():
    rng = np.random.default_rng(4)
    keys = np.unique(np.concatenate([
        HIGH_KEYS, rng.integers(0, 2**64 - 1, 500, dtype=np.uint64),
        rng.integers(0, 5000, 500).astype(np.uint64)]))
    for k in (keys, keys[:1], keys[:0], np.repeat(keys[:4], 2)):
        assert keycodec.encode_sorted_u64(k) == ref_keycodec.encode_sorted_u64(k)
        np.testing.assert_array_equal(
            keycodec.decode_sorted_u64(keycodec.encode_sorted_u64(k)), k)
    assert keycodec.encode_varints(keys) == ref_keycodec.encode_varints(keys)
    shuffled = rng.permutation(keys)
    pb, prank = keycodec.encode_u64_with_perm(shuffled)
    rb, rrank = ref_keycodec.encode_u64_with_perm(shuffled)
    assert pb == rb
    np.testing.assert_array_equal(prank, rrank)
    np.testing.assert_array_equal(
        keycodec.decode_u64_with_perm(pb, prank), shuffled)
    # damage is loud, with the reference's reasons
    buf = keycodec.encode_sorted_u64(keys)
    for bad in (buf[:-1], buf + b"\x00", b"\xff" * 11,
                keycodec.encode_varints(np.array([2, 2**64 - 1, 5], np.uint64))):
        with pytest.raises(keycodec.KeyCodecError) as got:
            keycodec.decode_sorted_u64(bad)
        with pytest.raises(ref_keycodec.KeyCodecError) as want:
            ref_keycodec.decode_sorted_u64(bad)
        assert got.value.reason == want.value.reason
    with pytest.raises(keycodec.KeyCodecError):
        keycodec.encode_sorted_u64(keys[::-1])


def _censuses(n_passes=4, seed=5):
    """Zipf-skewed censuses over a shared vocabulary, some keys >= 2^63."""
    rng = np.random.default_rng(seed)
    vocab = np.unique(np.concatenate([
        rng.integers(0, 2**64 - 1, 400, dtype=np.uint64), HIGH_KEYS]))
    out = []
    for _ in range(n_passes):
        idx = (rng.zipf(1.3, 900) - 1) % vocab.shape[0]
        out.append(vocab[idx])
    return out


class _Recorder:
    def __init__(self):
        self.sent = []

    def gather(self, payload):
        self.sent.append(payload)
        return [payload]


@pytest.mark.parametrize("codec", ["varint", "raw"])
def test_planner_and_census_wire_match_reference(codec):
    """Over a 4-pass census sequence: the plans, the wire bytes and the
    global census of the port's exchange equal the reference's."""
    kw = dict(hot_capacity=16, aging=0.8, update_interval=1)
    tp, tr = _Recorder(), _Recorder()
    port = CensusExchange(tp, planner=PlacementPlanner(**kw), codec=codec)
    ref = RefExchange(tr, planner=RefPlanner(**kw), codec=codec)
    n_hot = []
    for census in _censuses():
        np.testing.assert_array_equal(port.exchange(census),
                                      ref.exchange(census))
        pp, rp = port.planner.plan(), ref.planner.plan()
        np.testing.assert_array_equal(pp.hot_keys, rp.hot_keys)
        assert pp.version == rp.version
        assert port.last_wire_bytes == ref.last_wire_bytes
        n_hot.append(pp.n_hot)
    assert tp.sent == tr.sent
    assert n_hot[-1] > 0 and n_hot[0] == 0  # the dictionary came into play


def test_two_rank_exchange_equals_union_and_is_loud():
    censuses = _censuses(n_passes=3)
    halves = [[c[::2], c[1::2]] for c in censuses]
    group = InProcessCensusGroup(2)
    ex = [CensusExchange(group.transport(r),
                         planner=PlacementPlanner(hot_capacity=16,
                                                  update_interval=1))
          for r in range(2)]
    out = [[None] * len(halves) for _ in range(2)]

    def rank(r):
        for p, h in enumerate(halves):
            out[r][p] = ex[r].exchange(h[r])

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p, h in enumerate(halves):
        np.testing.assert_array_equal(out[0][p], legacy_union(h))
        np.testing.assert_array_equal(out[1][p], legacy_union(h))
    # a peer with another dictionary is refused, never mis-decoded
    a = CensusExchange(LoopbackTransport())
    b = CensusExchange(LoopbackTransport(),
                       planner=PlacementPlanner(hot_capacity=4,
                                                update_interval=1))
    for c in censuses[:3]:
        b.exchange(c)
    with pytest.raises(CensusProtocolError):
        a._decode(b._encode(np.unique(censuses[0]), b._known), 1,
                  a._known)
    with pytest.raises(CensusProtocolError):
        a._decode(b"nope", 1, a._known)


# --------------------------------------------------------------------------- #
# plan_group, bit-exact, with hot keys and keys >= 2^63
# --------------------------------------------------------------------------- #
def _batch(keys, n_real, seed):
    rng = np.random.default_rng(seed)
    K = keys.shape[0]
    segs = np.full(K, BSZ * S, np.int32)
    segs[:n_real] = np.sort(rng.integers(0, BSZ * S, n_real)).astype(np.int32)
    arrays = dict(
        keys=keys, key_segments=segs, n_keys=n_real,
        dense=rng.standard_normal((BSZ, DENSE)).astype(np.float32),
        labels=(rng.random(BSZ) < 0.3).astype(np.float32),
        ins_mask=np.ones(BSZ, np.float32), batch_size=BSZ, n_sparse_slots=S,
    )
    return HostBatch(**arrays), RefBatch(**arrays)


def test_plan_group_matches_reference(monkeypatch, native="0"):
    """n = 4, a different batch on every position (one empty), after three
    passes realized a hot block: every plan array equals the reference's."""
    for k in NATIVE_FLAGS:
        monkeypatch.setenv(k, native)
    n = 4
    rng = np.random.default_rng(9)
    vocab = np.unique(np.concatenate([
        rng.integers(0, 2**64 - 1, 300, dtype=np.uint64), HIGH_KEYS]))
    hot_part = vocab[:40]  # in every census: hot from the third pass
    kw = dict(TABLE_KW, placement="loopback", placement_hot_capacity=32)
    port = ShardedSparseTable(SparseTableConfig(**kw), make_mesh(n, "cpu"),
                              seed=1)
    ref = RefShardedTable(ref_config.SparseTableConfig(**kw), ref_make_mesh(n),
                          seed=1)
    for p in range(3):
        census = np.concatenate([hot_part, vocab[40 + 60 * p: 100 + 60 * p]])
        for t in (port, ref):
            t.begin_pass(census)
            if p < 2:
                t.end_pass()
    np.testing.assert_array_equal(port.hot_resident_keys(),
                                  ref.hot_resident_keys())
    assert port.hot_resident_keys().shape[0] == 32
    K = 96
    pb, rb = [], []
    for d in range(n):
        n_real = 0 if d == 2 else 70 - 9 * d
        keys = np.zeros(K, np.uint64)
        # hot keys, cold keys of this census, census misses, repeats
        keys[:n_real] = rng.choice(
            np.concatenate([vocab[:60], vocab[150:200], HIGH_KEYS]), n_real)
        a, b = _batch(keys, n_real, seed=d)
        pb.append(a)
        rb.append(b)
    got, want = port.plan_group(pb), ref.plan_group(rb)
    for name in ("serve_rows", "occ_flat", "serve_map", "serve_uniq",
                 "key_mask", "hot_occ", "hot_lr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.n_missing == want.n_missing > 0
    assert (got.hot_occ < 32).sum() > 0  # hot occurrences routed
    assert port.capacity_bumps == ref.capacity_bumps
    # ownership of keys >= 2^63 follows the uint64 modulus
    for o, sk_ in enumerate(port._shard_keys):
        assert (sk_ % np.uint64(n) == np.uint64(o)).all()
        np.testing.assert_array_equal(sk_, ref._shard_keys[o])
    assert (port._census_index is not None) == (native == "1")
    port.end_pass()
    ref.end_pass()


def test_plan_group_matches_reference_native(monkeypatch):
    """The same with both packages' native planners: census lookups and the
    serve-side dedup in first-seen order, so a slot layout of its own, and
    still every plan array equal."""
    test_plan_group_matches_reference(monkeypatch, native="1")


# --------------------------------------------------------------------------- #
# collectives and the hybrid device functions against jax.lax in shard_map
# --------------------------------------------------------------------------- #
def _shard_mapped(fn, n, n_in):
    mesh = ref_make_mesh(n)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(DATA_AXIS),) * n_in,
                             out_specs=P(DATA_AXIS), axis_names={DATA_AXIS}))


def test_collectives_match_lax():
    n = 4
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, n, 3, 5)).astype(np.float32)
    y = rng.standard_normal((n, 7)).astype(np.float32)
    a2a = _shard_mapped(
        lambda v: jax.lax.all_to_all(v[0], DATA_AXIS, 0, 0)[None], n, 1)
    np.testing.assert_array_equal(collectives.all_to_all(_t(x)).numpy(),
                                  np.asarray(a2a(x)))
    # orientation: position d receives block d of every source
    assert np.array_equal(collectives.all_to_all(_t(x))[2, 1].numpy(), x[1, 2])
    gather = _shard_mapped(
        lambda v: jax.lax.all_gather(v[0], DATA_AXIS)[None], n, 1)
    np.testing.assert_array_equal(collectives.all_gather(_t(y)).numpy(),
                                  np.asarray(gather(y)))
    pmax = _shard_mapped(lambda v: jax.lax.pmax(v[0], DATA_AXIS)[None], n, 1)
    np.testing.assert_array_equal(collectives.pmax(_t(y)).numpy(),
                                  np.asarray(pmax(y)))
    psum = _shard_mapped(lambda v: jax.lax.psum(v[0], DATA_AXIS)[None], n, 1)
    np.testing.assert_allclose(collectives.psum(_t(y)).numpy(),
                               np.asarray(psum(y)), rtol=1e-6)
    fold = ((y[0] + y[1]) + y[2]) + y[3]  # the port's order, exactly
    np.testing.assert_array_equal(collectives.psum(_t(y)).numpy()[3], fold)


def _hybrid_inputs(n=4, cap=64, C=8, K=40, H=12, W=6, seed=0):
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, n * C + 1, (n, K)).astype(np.int32)
    hot_occ = rng.integers(0, H + 1, (n, K)).astype(np.int32)
    occ[hot_occ < H] = n * C  # hot occurrences carry the cold sink
    hot_lr = np.where(rng.random((n, H)) < 0.6, 0.05, 0.0).astype(np.float32)
    return dict(
        values=rng.standard_normal((n, cap, W)).astype(np.float32),
        hot_values=np.repeat(
            rng.standard_normal((1, H, W)).astype(np.float32), n, 0),
        hot_g2sum=np.repeat(rng.random((1, H)).astype(np.float32) * 3, n, 0),
        serve_rows=rng.integers(0, cap, (n, n, C)).astype(np.int32),
        occ_flat=occ, hot_occ=hot_occ, hot_lr=hot_lr,
        row_grads=rng.standard_normal((n, K, W)).astype(np.float32),
        key_mask=(rng.random((n, K)) < 0.9).astype(np.float32),
        key_clicks=(rng.random((n, K)) < 0.3).astype(np.float32),
    )


def test_hybrid_pull_matches_reference():
    """Different plans on every position (n = 4): the pulled rows equal the
    reference's, bit for bit."""
    x = _hybrid_inputs()
    n = x["values"].shape[0]

    def body(values, hot, serve_rows, occ_flat, hot_occ):
        return ref_ptrainer.hybrid_pull(values[0], hot[0], serve_rows[0],
                                        occ_flat[0], hot_occ[0], 0.0, 2)[None]

    names = ("values", "hot_values", "serve_rows", "occ_flat", "hot_occ")
    want = np.asarray(_shard_mapped(body, n, 5)(*(x[k] for k in names)))
    got = ptrainer.hybrid_pull(*(_t(x[k]) for k in names), 0.0, 2)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)


def test_hybrid_hot_update_matches_reference():
    """The hot fold from one shared block state (hot_block_from_jax):
    replicas stay identical, padding slots unchanged, and the result
    agrees with the reference's (the level-1 segment sums may add in
    another order on XLA; 1e-6 bounds that)."""
    x = _hybrid_inputs(seed=1)
    n = x["values"].shape[0]
    conf = ref_config.SparseTableConfig(embedding_dim=4)

    def body(hv, hg, rg, hot_occ, hot_lr, mask, clicks):
        v, g = ref_ptrainer.hybrid_hot_update(
            hv[0], hg[0], rg[0], hot_occ[0], hot_lr[0], mask[0], clicks[0],
            conf)
        return v[None], g[None]

    names = ("hot_values", "hot_g2sum", "row_grads", "hot_occ", "hot_lr",
             "key_mask", "key_clicks")
    mapped = jax.jit(shard_map(
        body, mesh=ref_make_mesh(n), in_specs=(P(DATA_AXIS),) * 7,
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)), axis_names={DATA_AXIS}))
    want_v, want_g = (np.asarray(a) for a in
                      mapped(*(x[k] for k in names)))
    block = hot_block_from_jax(x["hot_values"], x["hot_g2sum"])
    hv, hg = block["hot_values"], block["hot_g2sum"]
    ptrainer.hybrid_hot_update(
        hv, hg, _t(x["row_grads"]), _t(x["hot_occ"]), _t(x["hot_lr"]),
        _t(x["key_mask"]), _t(x["key_clicks"]),
        SparseTableConfig(embedding_dim=4))
    for d in range(1, n):
        assert torch.equal(hv[d], hv[0]) and torch.equal(hg[d], hg[0])
    untouched = ~np.isin(np.arange(12), x["hot_occ"])
    np.testing.assert_array_equal(hv[0].numpy()[untouched],
                                  x["hot_values"][0][untouched])
    np.testing.assert_allclose(hv.numpy(), want_v, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hg.numpy(), want_g, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mc")
    return [write_synth_files(str(d / f"p{p}"), n_files=2, ins_per_file=128,
                              n_sparse_slots=S, vocab_per_slot=VOCAB,
                              dense_dim=DENSE, seed=20 + p)
            for p in range(PASSES)]


def _load(files, ref=False):
    ds = (RefDataset(ref_synth_config(S, DENSE, BSZ, 16), read_threads=2)
          if ref else
          PadBoxSlotDataset(make_synth_config(S, DENSE, BSZ, 16),
                            read_threads=2))
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _drive(table, trainer, pass_files, ref=False):
    """PASSES passes, the AUC streams continued; per pass the metrics, the
    resident hot keys and the plan."""
    auc, out = None, []
    for files in pass_files:
        ds = _load(files, ref)
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table, auc_state=auc,
                                       drop_last=True)
        auc = trainer.last_metric_state
        table.end_pass()
        ds.close()
        plan = table.placement_plan()
        out.append((m, table.hot_resident_keys().copy(),
                    None if plan is None else (plan.version, plan.n_hot)))
    return table.state_dict(), out


@pytest.fixture(scope="module")
def reference_runs(pass_files):
    """The reference's 3-pass hybrid loopback run at n positions (its
    seed-3 tower) and that tower, memoized per n."""
    runs = {}

    def run(n, native="0"):
        if (n, native) not in runs:
            # the reference's numpy planner (the native one dedups in
            # first-seen order) and its Python parser, or both native
            old = {k: os.environ.get(k) for k in NATIVE_FLAGS}
            os.environ.update({k: native for k in NATIVE_FLAGS})
            try:
                mesh = ref_make_mesh(n)
                conf = ref_config.SparseTableConfig(placement="loopback",
                                                    **TABLE_KW)
                tr = RefMultiChipTrainer(
                    RefCtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,)),
                    conf, mesh, ref_config.TrainerConfig(auc_buckets=1 << 10),
                    seed=3)
                tower = [{k: np.asarray(v) for k, v in layer.items()}
                         for layer in tr.dense_state()[0]["tower"]]
                table = RefShardedTable(conf, mesh, seed=5, bucket_slack=8.0)
                runs[n, native] = (_drive(table, tr, pass_files, ref=True),
                                   tower)
                table.close()
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        return runs[n, native]

    return run


def _port_run(pass_files, n, tower, placement="loopback"):
    mesh = make_mesh(n, device="cpu")
    conf = SparseTableConfig(placement=placement, **TABLE_KW)
    model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = MultiChipTrainer(model, conf, mesh, TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    return _drive(table, tr, pass_files)


@pytest.mark.parametrize("n", [2, 4])
def test_slice_matches_reference(pass_files, reference_runs, monkeypatch, n,
                                 native="0"):
    """Three passes of the hybrid loopback path, realized, cache off, from
    the reference's tower, both packages on their numpy planners.
    Host-side state is identical; floats agree at 1e-6 (loss, AUC) and 1e-7
    (table rows): the dense gradients and the segment sums add in another
    order on XLA (~1e-7 a step), and the runs measured 3.6e-7 in loss and
    6e-9 in rows."""
    (ref_state, ref_passes), tower = reference_runs(n, native)
    for k in NATIVE_FLAGS:
        monkeypatch.setenv(k, native)
    state, passes = _port_run(pass_files, n, tower)
    for (m, hot, plan), (rm, rhot, rplan) in zip(passes, ref_passes):
        np.testing.assert_array_equal(hot, rhot)
        assert plan == rplan
        assert abs(m["loss"] - rm["loss"]) < 1e-6, (m["loss"], rm["loss"])
        assert abs(m["auc"] - rm["auc"]) < 1e-6, (m["auc"], rm["auc"])
        assert m["steps"] == rm["steps"] and m["count"] == rm["count"]
        assert m["missing_keys"] == rm["missing_keys"] == 0
    # the hot block realized at the third begin_pass and was routed
    assert passes[1][1].shape[0] == 0 < passes[2][1].shape[0]
    assert passes[2][0]["hot_occurrences"] > 0
    np.testing.assert_array_equal(state["keys"], ref_state["keys"])
    np.testing.assert_array_equal(state["values"][:, :2],
                                  ref_state["values"][:, :2])
    np.testing.assert_allclose(state["values"], ref_state["values"],
                               rtol=0, atol=1e-7)


def test_slice_matches_reference_native(pass_files, reference_runs,
                                        monkeypatch):
    """The same at n = 4 with both packages' native planners and parsers."""
    test_slice_matches_reference(pass_files, reference_runs, monkeypatch, 4,
                                 native="1")


@pytest.fixture(scope="module")
def port_tower(reference_runs):
    return reference_runs(4)[1]


def test_hybrid_against_hash_bitexact(pass_files, port_tower):
    """Placement moves rows, never floats: keys, values, g2sum and every
    pass's loss and AUC equal the hash run's, bit for bit ("hybrid" and
    "loopback" alike)."""
    hash_state, hash_passes = _port_run(pass_files, 4, port_tower, "hash")
    assert all(h.shape[0] == 0 for _, h, _ in hash_passes)
    for placement in ("loopback", "hybrid"):
        state, passes = _port_run(pass_files, 4, port_tower, placement)
        assert passes[-1][1].shape[0] > 0
        np.testing.assert_array_equal(state["keys"], hash_state["keys"])
        np.testing.assert_array_equal(state["values"], hash_state["values"])
        for (m, _, _), (hm, _, _) in zip(passes, hash_passes):
            assert m["loss"] == hm["loss"] and m["auc"] == hm["auc"]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_hybrid_reruns_bitexact(pass_files, port_tower, n):
    a_state, a_passes = _port_run(pass_files, n, port_tower)
    b_state, b_passes = _port_run(pass_files, n, port_tower)
    assert a_passes[-1][1].shape[0] > 0
    np.testing.assert_array_equal(a_state["keys"], b_state["keys"])
    np.testing.assert_array_equal(a_state["values"], b_state["values"])
    assert [p[0]["auc"] for p in a_passes] == [p[0]["auc"] for p in b_passes]


def test_multichip_equals_single_chip(tmp_path):
    """Port of tests/test_multichip.py::test_loss_and_table_match: four
    positions of 16 against one chip on the concatenated batch of 64, at the
    reference's tolerances."""
    files = write_synth_files(str(tmp_path), n_files=2, ins_per_file=128,
                              n_sparse_slots=3, vocab_per_slot=50,
                              dense_dim=2, seed=7)
    tconf = SparseTableConfig(embedding_dim=8, learning_rate=0.05,
                              hbm_cache_rows=0)
    trconf = TrainerConfig(dense_lr=1e-3, auc_buckets=1 << 12)
    results = {}
    for n_pos, bsz in ((1, 64), (4, 16)):
        ds = PadBoxSlotDataset(make_synth_config(3, 2, bsz, 16),
                               read_threads=2)
        ds.set_filelist(files)
        ds.load_into_memory()
        model = CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(32, 16),
                       seed=3, device="cpu")
        if n_pos == 1:
            table = SparseTable(tconf, seed=5, device="cpu")
            tr = Trainer(model, tconf, trconf, device="cpu")
        else:
            mesh = make_mesh(n_pos, device="cpu")
            table = ShardedSparseTable(tconf, mesh, seed=5,
                                       bucket_slack=float(n_pos))
            tr = MultiChipTrainer(model, tconf, mesh, trconf)
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table)
        table.end_pass()
        ds.close()
        results[n_pos] = (m, table.state_dict())
    (m1, s1), (m4, s4) = results[1], results[4]
    assert m1["steps"] == m4["steps"] == 4
    assert abs(m1["loss"] - m4["loss"]) < 2e-4, (m1["loss"], m4["loss"])
    assert abs(m1["auc"] - m4["auc"]) < 5e-3, (m1["auc"], m4["auc"])
    assert m1["count"] == m4["count"] == 256
    np.testing.assert_array_equal(s1["keys"], s4["keys"])
    np.testing.assert_allclose(s1["values"], s4["values"], atol=2e-4)


def test_hot_tier_lifecycle(pass_files, port_tower):
    """Resident hot rows stay on the device across passes: a mid-pass
    snapshot carries them, the write-back leaves them out, and the barrier
    (state_dict) lands them in the store; a restore drops residency."""
    mesh = make_mesh(4, device="cpu")
    conf = SparseTableConfig(placement="loopback", **TABLE_KW)
    model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu")
    model.load_state_dict(params_from_jax(port_tower))
    tr = MultiChipTrainer(model, conf, mesh, TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    _drive(table, tr, pass_files[:2])
    ds = _load(pass_files[2])
    census = ds.unique_keys()
    table.begin_pass(census)
    n_hot = table.hot_resident_keys().shape[0]
    assert n_hot > 0 and table.last_hot_moved_rows == n_hot
    assert table.last_promotion_rows == census.shape[0] - n_hot
    tr.train_from_dataset(ds, table, drop_last=True)
    mid = table.pass_state_dict()
    np.testing.assert_array_equal(mid["keys"], census)
    table.end_pass()
    assert table.last_write_back_rows == census.shape[0] - n_hot
    ds.close()
    state = table.state_dict()  # the barrier writes the hot rows back
    hot_pos = np.searchsorted(state["keys"], table.hot_resident_keys())
    np.testing.assert_array_equal(
        state["values"][hot_pos],
        mid["values"][np.searchsorted(mid["keys"],
                                      table.hot_resident_keys())])
    table.load_state_dict(state)
    assert table.hot_resident_keys().shape[0] == 0
    assert table.hot_values is None


def test_cut_outs_raise():
    mesh = make_mesh(2, device="cpu")
    table = ShardedSparseTable(SparseTableConfig(), mesh)
    with pytest.raises(ValueError):
        TrainerConfig(sync_dense_mode="bogus")
    table.begin_pass(np.arange(1, 30, dtype=np.uint64))
    with pytest.raises(TypeError):
        table.plan_batch(None)
    table.end_pass()
    if not torch.cuda.is_available():  # the card is the default, never a fallback
        with pytest.raises(RuntimeError):
            make_mesh(2)
