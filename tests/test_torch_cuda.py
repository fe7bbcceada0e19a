"""The port's CUDA kernels and its trainer on an NVIDIA GPU.

Every test needs a card and skips without one.  This file imports only
torch and the port, so on a machine without JAX it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py runs the same checks at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.ops import sparse_kernels as sk
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [0, 1, 1000, 131072])
def test_pull_rows_kernel_bit_exact(cuda, k):
    gen = torch.Generator(device=cuda).manual_seed(k)
    values = torch.randn((4096, 11), device=cuda, generator=gen)
    idx = torch.randint(0, 4096, (k,), device=cuda, generator=gen,
                        dtype=torch.int32)
    before = sk.launches["pull_rows"]
    got = sk.pull_rows(values, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, sk.pull_rows_plain(values, idx))
    assert sk.launches["pull_rows"] == before + (1 if k else 0)


def _table(cuda, case, rows, gen):
    """A float32 [rows, W] table of a kernel path case: "w<W>" allocated as
    usual (16-byte aligned), "w<W>_base4" a view that starts 4 bytes into
    its storage."""
    w = int(case[1:].split("_")[0])
    if case.endswith("_base4"):
        flat = torch.randn(rows * w + 1, device=cuda, generator=gen)
        values = flat[1:].view(rows, w)
        assert values.data_ptr() % 8 == 4 and values.is_contiguous()
        return values
    return torch.randn((rows, w), device=cuda, generator=gen)


# w10 and w2: the float2 path (tiles of 204 and 1024 rows); w10_base4, w3,
# w11: the scalar path.  K = 205 leaves a last tile of one row (an odd
# number of float2); 1 000 003 gives each block several tiles, so the
# indices of the next tile load while a tile's rows do
@pytest.mark.parametrize("case", ["w10", "w2", "w10_base4", "w3", "w11"])
@pytest.mark.parametrize("k", [0, 1, 205, 131079, 1000003])
def test_pull_rows_kernel_paths_bit_exact(cuda, case, k):
    gen = torch.Generator(device=cuda).manual_seed(k)
    values = _table(cuda, case, 65536, gen)
    idx = torch.randint(0, 65536, (k,), device=cuda, generator=gen,
                        dtype=torch.int32)
    before = sk.launches["pull_rows"]
    got = sk.pull_rows(values, idx)
    torch.cuda.synchronize()
    assert got.shape == (k, values.shape[1])
    assert torch.equal(got, sk.pull_rows_plain(values, idx))
    assert sk.launches["pull_rows"] == before + (1 if k else 0)


# real duplicates reach the atomics in an order that changes from run to
# run: ~4 hits per row of unit-size terms differ from a sequential sum by
# < 2 * 16 * 2^-24 * 20 ~ 4e-5 (csrc/scatter_add_rows.cu; chip_smoke.py)
DUP_TOL = 1e-4


# W = 10 with 8-byte aligned bases takes the float2 reductions; W = 11,
# W = 3 and a W = 10 view that starts 4 bytes in take the scalar ones
@pytest.mark.parametrize("case", ["w11", "w10", "w3", "w10_base4"])
@pytest.mark.parametrize("u", [0, 7, 40000])
def test_scatter_add_rows_kernel_unique_and_dead_repeats_bit_exact(cuda, u,
                                                                   case):
    """Both reduction paths: unique targets plus zero-delta repeats of the
    dead row are bit-exact with the twin, in place."""
    gen = torch.Generator(device=cuda).manual_seed(u)
    P = 65536
    values = _table(cuda, case, P, gen)
    w = values.shape[1]
    idx = torch.randperm(P - 1, device=cuda, generator=gen)[:u].to(torch.int32)
    delta = torch.randn((u, w), device=cuda, generator=gen)
    idx[: u // 4] = P - 1  # dead-row repeats carry zero deltas
    delta[: u // 4] = 0.0
    want = sk.scatter_add_rows_plain(values.clone(), idx, delta)
    before = sk.launches["scatter_add_rows"]
    got = sk.scatter_add_rows(values, idx, delta)
    torch.cuda.synchronize()
    assert got is values
    assert torch.equal(got, want)
    assert sk.launches["scatter_add_rows"] == before + (1 if u else 0)


@pytest.mark.parametrize("case", ["w11", "w10", "w3", "w10_base4"])
def test_scatter_add_rows_kernel_real_duplicates(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(3)
    values = _table(cuda, case, 1000, gen)
    w = values.shape[1]
    idx = torch.randint(0, 250, (1000,), device=cuda, generator=gen,
                        dtype=torch.int32)
    delta = torch.randn((1000, w), device=cuda, generator=gen)
    want = sk.scatter_add_rows_plain(values.clone(), idx, delta)
    got = sk.scatter_add_rows(values, idx, delta)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=DUP_TOL, atol=DUP_TOL)


def test_wrappers_refuse_mixed_devices(cuda):
    values = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="idx on cpu"):
        sk.pull_rows(values, torch.zeros(2, dtype=torch.int32))


def test_small_pass_on_the_card_launches_the_kernels(cuda, tmp_path):
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    files = write_synth_files(str(tmp_path), n_files=1, ins_per_file=256,
                              n_sparse_slots=4, dense_dim=3, seed=1)
    ds = PadBoxSlotDataset(make_synth_config(4, 3, 64, 16), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=4)
    table = SparseTable(tconf)
    trainer = Trainer(CtrDnn(4, tconf.row_width, dense_dim=3, hidden=(16, 8)),
                      tconf, TrainerConfig())
    sk.reset_launches()
    for _ in range(2):  # the second pass hits what the first admitted
        table.begin_pass(ds.unique_keys())
        assert table.values.is_cuda
        m = trainer.train_from_dataset(ds, table)
        torch.cuda.synchronize()
        table.end_pass()
    assert table.last_cache_hits == ds.unique_keys().shape[0]
    assert sk.launches["pull_rows"] == sk.launches["scatter_add_rows"] == 8
    for name in ("gather_slots", "scatter_rows", "sorted_search"):
        assert sk.launches[name] > 0, name
    assert np.isfinite(m["loss"]) and m["count"] == 256
    ds.close()


@pytest.mark.parametrize("kernel", ["pull_rows", "scatter_add_rows",
                                    "gather_slots", "scatter_rows",
                                    "hot_cold_select", "pull_rows_float2",
                                    "hot_cold_select_float4",
                                    "gather_slots_tile"])
def test_out_of_range_index_fails_the_launch(cuda, kernel):
    """An index outside the table traps the kernel.  The trap poisons the
    CUDA context, so it runs in a child process."""
    import subprocess
    import sys

    call = {
        "pull_rows": "sk.pull_rows(v, i)",
        "scatter_add_rows":
            "sk.scatter_add_rows(v, i, torch.ones(1, 3, device='cuda'))",
        "gather_slots": "sk.gather_slots(v, i)",
        "scatter_rows":
            "sk.scatter_rows(v, i, torch.ones(1, 3, device='cuda'))",
        # slot 9 is past the sink H = 8
        "hot_cold_select":
            "sk.hot_cold_select(v, i + 1, torch.ones(1, 3, device='cuda'))",
        # the vector paths, the bad entry inside a full vector or tile
        "pull_rows_float2": "sk.pull_rows(v4, i4)",
        "hot_cold_select_float4":
            "sk.hot_cold_select(v4, i4 + 1, torch.ones(4, 4, device='cuda'))",
        # 200 rows of 4 floats: slot 8 at row 100, inside the first block's
        # 512 floats and inside a whole 16-byte vector
        "gather_slots_tile": "sk.gather_slots(v4, g)",
    }[kernel]
    code = (
        "import torch\n"
        "from paddlebox_tpu_torch.ops import sparse_kernels as sk\n"
        "v = torch.zeros((8, 3), device='cuda')\n"
        "i = torch.tensor([8], dtype=torch.int32, device='cuda')\n"
        "v4 = torch.zeros((8, 4), device='cuda')\n"
        "i4 = torch.tensor([0, 1, 8, 2], dtype=torch.int32, device='cuda')\n"
        "g = (torch.arange(200, device='cuda') % 8).to(torch.int32)\n"
        "g[100] = 8\n"
        f"{call}\n"
        "torch.cuda.synchronize()\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "Error" in r.stderr


# --------------------------------------------------------------------------- #
# the cache-tier kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [0, 1, 1000, 65536])
def test_gather_slots_kernel_bit_exact_with_negative_slots(cuda, k):
    gen = torch.Generator(device=cuda).manual_seed(k)
    table = torch.randn((65536, 11), device=cuda, generator=gen)
    slots = torch.randint(-1, 65536, (k,), device=cuda, generator=gen,
                          dtype=torch.int32)
    slots[::7] = -1
    before = sk.launches["gather_slots"]
    got = sk.gather_slots(table, slots)
    torch.cuda.synchronize()
    assert torch.equal(got, sk.gather_slots_plain(table, slots))
    assert sk.launches["gather_slots"] == before + (1 if k else 0)


# a block gathers 512 output floats: K = 512 // W - 1, 512 // W and
# 512 // W + 1 rows end before, at or just past the first block's end
# (K * W mod 4 nonzero leaves a ragged tail); K = 100 003 makes blocks walk
# grid-stride; every slot negative.  W 1, 3, 10, 11, 12 and a table based
# 4 bytes in.
@pytest.mark.parametrize("case", ["w1", "w3", "w10", "w11", "w12",
                                  "w11_base4"])
@pytest.mark.parametrize("edge", ["zero", "below", "at", "past", "one",
                                  "grid_stride", "all_miss"])
def test_gather_slots_kernel_edges_bit_exact(cuda, case, edge):
    gen = torch.Generator(device=cuda).manual_seed(len(case) * 7 + len(edge))
    C = 5000
    table = _table(cuda, case, C, gen)
    w = table.shape[1]
    k = {"zero": 0, "below": 512 // w - 1, "at": 512 // w,
         "past": 512 // w + 1, "one": 1, "grid_stride": 100003,
         "all_miss": 4097}[edge]
    slots = torch.randint(-1, C, (k,), device=cuda, generator=gen,
                          dtype=torch.int32)
    if edge == "all_miss":
        slots.fill_(-1)
    elif k:
        slots[-1] = C - 1  # the last slot
    before = sk.launches["gather_slots"]
    got = sk.gather_slots(table, slots)
    torch.cuda.synchronize()
    assert got.shape == (k, w)
    assert torch.equal(got, sk.gather_slots_plain(table, slots))
    assert sk.launches["gather_slots"] == before + (1 if k else 0)


@pytest.mark.parametrize("k", [0, 7, 1000, 65536])
def test_scatter_rows_kernel_last_wins_bit_exact(cuda, k):
    """Duplicates (about 4 occurrences a slot) resolve to the last
    occurrence, negatives store nothing: equal to the twin, every run."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    C = max(k // 4, 1)
    table = torch.randn((C, 11), device=cuda, generator=gen)
    slots = torch.randint(-1, C, (k,), device=cuda, generator=gen,
                          dtype=torch.int32)
    rows = torch.randn((k, 11), device=cuda, generator=gen)
    want = sk.scatter_rows_plain(table.clone(), slots, rows)
    for _ in range(3):
        got = sk.scatter_rows(table.clone(), slots, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _scatter_rows_slots(case, gen, cuda):
    """(table rows, slots) of a scatter_rows stress case."""
    if case == "65536_on_8_slots":  # every block competes for 8 winners
        return 64, torch.randint(0, 8, (65536,), device=cuda, generator=gen,
                                 dtype=torch.int32)
    if case == "straddling_pairs":
        # occurrences 2j - 1 and 2j share a slot, so a pair straddles every
        # 256-occurrence tile (and block) boundary; the first and the last
        # occurrence share one too
        k = 4096
        slots = (torch.arange(k, device=cuda) + 1) // 2
        slots[-1] = slots[0]
        return k, slots.to(torch.int32)
    k = {"one": 1, "ragged": 12345}[case]
    return 4096, torch.randint(-1, 4096, (k,), device=cuda, generator=gen,
                               dtype=torch.int32)


@pytest.mark.parametrize("case", ["65536_on_8_slots", "straddling_pairs",
                                  "one", "ragged"])
def test_scatter_rows_kernel_stress_bit_exact(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(21)
    C, slots = _scatter_rows_slots(case, gen, cuda)
    table = torch.randn((C, 11), device=cuda, generator=gen)
    rows = torch.randn((slots.shape[0], 11), device=cuda, generator=gen)
    want = sk.scatter_rows_plain(table.clone(), slots, rows)
    before = sk.launches["scatter_rows"]
    got = sk.scatter_rows(table, slots, rows)
    torch.cuda.synchronize()
    assert got is table
    assert torch.equal(got, want)
    assert sk.launches["scatter_rows"] == before + 1


def test_scatter_rows_kernel_calls_in_a_row_then_a_larger_table(cuda):
    """Three calls on one table, each naming other slots with duplicates,
    then one on a table four times larger: no winner of an earlier call
    (or scratch sized for the smaller table) may leak into a later one."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    C = 8192
    table = torch.randn((C, 11), device=cuda, generator=gen)
    want = table.clone()
    for k in (20000, 5000, 12345):
        slots = torch.randint(-1, C, (k,), device=cuda, generator=gen,
                              dtype=torch.int32)
        rows = torch.randn((k, 11), device=cuda, generator=gen)
        sk.scatter_rows_plain(want, slots, rows)
        sk.scatter_rows(table, slots, rows)
        torch.cuda.synchronize()
        assert torch.equal(table, want)
    big = torch.randn((4 * C, 11), device=cuda, generator=gen)
    slots = torch.randint(-1, 4 * C, (50000,), device=cuda, generator=gen,
                          dtype=torch.int32)
    rows = torch.randn((50000, 11), device=cuda, generator=gen)
    want = sk.scatter_rows_plain(big.clone(), slots, rows)
    sk.scatter_rows(big, slots, rows)
    torch.cuda.synchronize()
    assert torch.equal(big, want)
    # the store launch clears every tag the elect launch set
    tag = sk._scatter_rows_tags[torch.cuda.current_device()]
    assert tag.shape[0] >= 4 * C and not bool(tag.any())


def test_scatter_rows_kernel_failed_store_launch_drops_its_tags(
        cuda, monkeypatch):
    """A call whose store launch fails after its elect launch ran raises,
    and its tags outbid no later call: the next call on the same slots
    stores its winners.  A stand-in for the C entry point leaves the
    scratch as such a call does (atomicMax of occurrence + 1 for 65 536
    occurrences on 8 slots) and returns the launch error."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    C, dev = 64, torch.cuda.current_device()
    table = torch.randn((C, 11), device=cuda, generator=gen)
    sk.scatter_rows(table.clone(), torch.zeros(1, device=cuda,
                                               dtype=torch.int32),
                    torch.randn((1, 11), device=cuda, generator=gen))
    big = torch.randint(0, 8, (65536,), device=cuda, generator=gen,
                        dtype=torch.int32)

    def elect_then_fail(table_p, slots_p, rows_p, tag_p, k, w, n, stream):
        tag = sk._scatter_rows_tags[dev]
        assert (tag_p, slots_p, k) == (tag.data_ptr(), big.data_ptr(), 65536)
        occ = torch.arange(1, k + 1, device=cuda, dtype=torch.int32)
        tag.scatter_reduce_(0, big.long(), occ, "amax")
        return 719  # cudaErrorLaunchFailure

    sk._c_function("scatter_rows", "pbt_scatter_rows")  # build it first
    with monkeypatch.context() as m:
        m.setitem(sk._fns, "pbt_scatter_rows", elect_then_fail)
        with pytest.raises(RuntimeError, match="scatter_rows kernel launch"):
            sk.scatter_rows(table.clone(), big,
                            torch.randn((65536, 11), device=cuda,
                                        generator=gen))
    assert dev not in sk._scatter_rows_tags
    slots = torch.tensor([3, 0, 7, 3, -1, 5], device=cuda, dtype=torch.int32)
    rows = torch.randn((6, 11), device=cuda, generator=gen)
    want = sk.scatter_rows_plain(table.clone(), slots, rows)
    sk.scatter_rows(table, slots, rows)
    torch.cuda.synchronize()
    assert torch.equal(table, want)


def test_scatter_rows_kernel_graph_replay_on_new_slots(cuda):
    """A call captured in a CUDA graph and replayed on other slots and rows
    (duplicates included) is right at every replay: the tags are zero
    again when a call ends, so no replay sees an earlier one's."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    C, k = 4096, 10000
    table = torch.randn((C, 11), device=cuda, generator=gen)
    slots = torch.randint(-1, C, (k,), device=cuda, generator=gen,
                          dtype=torch.int32)
    rows = torch.randn((k, 11), device=cuda, generator=gen)
    sk.scatter_rows(table.clone(), slots, rows)  # sizes the scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sk.scatter_rows(table, slots, rows)
    for _ in range(3):
        table.copy_(torch.randn((C, 11), device=cuda, generator=gen))
        slots.copy_(torch.randint(-1, C, (k,), device=cuda, generator=gen,
                                  dtype=torch.int32))
        rows.copy_(torch.randn((k, 11), device=cuda, generator=gen))
        want = sk.scatter_rows_plain(table.clone(), slots, rows)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(table, want)


def test_scatter_rows_kernel_graph_replay_after_a_scratch_swap(
        cuda, monkeypatch):
    """A call captured on a table of C rows keeps its scratch's address; a
    later call on 2C rows swaps the scratch for a larger one.  The old one
    stays referenced, so a tensor allocated the size of it afterwards gets
    other memory, and a replay of the capture writes neither into that
    tensor nor a wrong row."""
    monkeypatch.setattr(sk, "_scatter_rows_tags", {})
    monkeypatch.setattr(sk, "_scatter_rows_retired", {})
    gen = torch.Generator(device=cuda).manual_seed(25)
    C, k, dev = 4096, 10000, torch.cuda.current_device()
    table = torch.randn((C, 11), device=cuda, generator=gen)
    slots = torch.randint(-1, C, (k,), device=cuda, generator=gen,
                          dtype=torch.int32)
    rows = torch.randn((k, 11), device=cuda, generator=gen)
    sk.scatter_rows(table.clone(), slots, rows)  # sizes the scratch: C
    torch.cuda.synchronize()
    old_ptr = sk._scatter_rows_tags[dev].data_ptr()
    old_n = sk._scatter_rows_tags[dev].shape[0]
    assert old_n == C
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sk.scatter_rows(table, slots, rows)
    big = torch.randn((2 * C, 11), device=cuda, generator=gen)
    big_slots = torch.randint(-1, 2 * C, (k,), device=cuda, generator=gen,
                              dtype=torch.int32)
    big_rows = torch.randn((k, 11), device=cuda, generator=gen)
    want = sk.scatter_rows_plain(big.clone(), big_slots, big_rows)
    sk.scatter_rows(big, big_slots, big_rows)  # swaps the scratch
    # first allocation after the swap: the freed block, had it been freed
    filler = torch.full((old_n,), 7, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(big, want)
    assert sk._scatter_rows_tags[dev].shape[0] == 2 * C
    assert [t.data_ptr() for t in sk._scatter_rows_retired[dev]] == [old_ptr]
    for _ in range(2):
        table.copy_(torch.randn((C, 11), device=cuda, generator=gen))
        slots.copy_(torch.randint(-1, C, (k,), device=cuda, generator=gen,
                                  dtype=torch.int32))
        rows.copy_(torch.randn((k, 11), device=cuda, generator=gen))
        want = sk.scatter_rows_plain(table.clone(), slots, rows)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(table, want)
        assert bool((filler == 7).all())
    assert not bool(sk._scatter_rows_retired[dev][0].any())


@pytest.mark.parametrize("n", [0, 1, 3, 1000, 65536])
def test_sorted_search_kernel_bit_exact_with_high_and_all_ones_keys(cuda, n):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64,
                                  endpoint=True))
    if n:
        keys[-1] = np.uint64(2**64 - 1)  # the all-ones key, a real one
    m = keys.shape[0]
    cpad = 1 << max(0, (m - 1).bit_length()) if m else 0
    hay = np.full(cpad, 2**64 - 1, np.uint64)
    hay[:m] = keys
    q = np.concatenate([keys[::2], rng.integers(0, 2**64 - 1, size=500,
                                                dtype=np.uint64),
                        np.array([0, 2**63, 2**64 - 1], np.uint64)])
    hay_t = torch.from_numpy(hay.view(np.int64)).to(cuda)
    q_t = torch.from_numpy(q.view(np.int64)).to(cuda)
    for n_real in {m, max(m - 1, 0)}:  # m - 1: the all-ones key is padding
        got = sk.sorted_search(hay_t, n_real, q_t)
        torch.cuda.synchronize()
        assert torch.equal(got, sk.sorted_search_plain(hay_t, n_real, q_t))
        live = keys[:n_real]
        pos = np.searchsorted(live, q)
        pos_c = np.minimum(pos, max(n_real - 1, 0))
        hit = (live[pos_c] == q) if n_real else np.zeros(q.shape[0], bool)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      np.where(hit, pos_c, -1))


# C = 1 and 2 sit wholly in the kernel's shared sample (256 keys), C = 256
# is the sample exactly, 512 leaves one step below it, 4096 to 2^20 up to
# 12 steps in device memory.  "full": C real keys, the last the all-ones
# key; "padded": a quarter of the haystack all-ones padding.  n_real runs
# over 0, 1, m - 1 (the last real key then counts as padding) and m.
@pytest.mark.parametrize("c", [1, 2, 256, 512, 4096, 8192, 65536, 1 << 20])
@pytest.mark.parametrize("fill", ["full", "padded"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_sorted_search_kernel_sample_edges_bit_exact(cuda, c, fill, order):
    rng = np.random.default_rng(c + len(fill) + len(order))
    m = c if fill == "full" else c - c // 4 - 1 if c > 1 else 0
    keys = np.unique(rng.integers(0, 2**64 - 1, size=m + 100,
                                  dtype=np.uint64))
    keys = np.sort(rng.choice(keys, m, replace=False))
    if fill == "full":
        keys[-1] = np.uint64(2**64 - 1)
    hay = np.full(c, 2**64 - 1, np.uint64)
    hay[:m] = keys
    # every key, duplicates of every third, misses, and the extremes
    q = np.concatenate([keys, keys[::3],
                        rng.integers(0, 2**64 - 1, size=3000, dtype=np.uint64),
                        np.array([0, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)])
    q = np.sort(q) if order == "sorted" else rng.permutation(q)
    hay_t = torch.from_numpy(hay.view(np.int64)).to(cuda)
    q_t = torch.from_numpy(q.view(np.int64)).to(cuda)
    assert int((q >= np.uint64(2**63)).sum()) > 0
    for n_real in sorted({0, min(1, m), max(m - 1, 0), m}):
        before = sk.launches["sorted_search"]
        got = sk.sorted_search(hay_t, n_real, q_t)
        torch.cuda.synchronize()
        assert torch.equal(got, sk.sorted_search_plain(hay_t, n_real, q_t))
        assert sk.launches["sorted_search"] == before + 1
        if n_real == m and m:
            assert int((got >= 0).sum()) == int(np.isin(q, keys).sum())


def test_cached_lifecycle_on_the_card_is_bit_exact_with_uncached(cuda):
    """Three overlapping censuses, a deterministic in-pass update, a tiny
    cache (eviction every pass) and the default one: the state_dicts are
    bit-equal to the uncached table's."""
    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.sparse.table import SparseTable

    rng = np.random.default_rng(0)
    censuses = [np.unique(rng.zipf(1.3, size=5000).astype(np.uint64))
                for _ in range(3)]
    states = []
    for rows in (0, 64, 1 << 16):
        t = SparseTable(SparseTableConfig(embedding_dim=8, hbm_cache_rows=rows))
        for pk in censuses:
            t.begin_pass(pk)
            n = pk.shape[0]
            t.values[:n] += 1.0
            t.g2sum[:n] += 0.5
            t.end_pass()
        states.append(t.state_dict())
    for s in states[1:]:
        np.testing.assert_array_equal(s["keys"], states[0]["keys"])
        np.testing.assert_array_equal(s["values"], states[0]["values"])


def _sharded_lifecycle(table, censuses):
    """Passes over ``censuses`` with a deterministic in-pass update of
    every row, cold or resident hot."""
    for pk in censuses:
        table.begin_pass(pk)
        for v, g in ((table.values, table.g2sum),
                     (table.hot_values, table.hot_g2sum)):
            if v is not None:
                v += 1.0
                g += 0.5
        table.end_pass()


def test_sharded_cached_lifecycle_on_the_card_is_bit_exact_with_uncached(cuda):
    """Four shard positions, three overlapping censuses, a deterministic
    in-pass update: with a tiny per-shard cache (eviction every pass) and
    the default one, the state_dicts equal the uncached table's, and the
    caches went through the three cache kernels, not their twins."""
    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.parallel import ShardedSparseTable, make_mesh

    rng = np.random.default_rng(1)
    censuses = [np.unique(rng.zipf(1.3, size=5000).astype(np.uint64))
                for _ in range(3)]
    states = []
    for rows in (0, 256, 1 << 16):
        conf = SparseTableConfig(embedding_dim=8, hbm_cache_rows=rows,
                                 placement="hash")
        t = ShardedSparseTable(conf, make_mesh(4), seed=0)
        sk.reset_launches()
        _sharded_lifecycle(t, censuses)
        if rows:
            for name in ("gather_slots", "scatter_rows", "sorted_search"):
                assert sk.launches[name] > 0, name
            assert t.last_cache_hits > 0
        states.append(t.state_dict())
        t.close()
    for st in states[1:]:
        np.testing.assert_array_equal(st["keys"], states[0]["keys"])
        np.testing.assert_array_equal(st["values"], states[0]["values"])


def test_reshard_on_the_card_is_bit_exact_with_rebuilt(cuda):
    """At the defaults (per-shard caches, hybrid placement), a live
    reshard 4 -> 2 then a pass equals a table rebuilt at 2 shards from
    state_dict then the same pass."""
    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.parallel import ShardedSparseTable, make_mesh

    rng = np.random.default_rng(2)
    censuses = [np.unique(rng.zipf(1.3, size=5000).astype(np.uint64))
                for _ in range(3)]
    conf = SparseTableConfig(embedding_dim=8, placement_update_interval=1,
                             placement_hot_capacity=64)
    live = ShardedSparseTable(conf, make_mesh(4), seed=0)
    _sharded_lifecycle(live, censuses[:2])
    rebuilt = ShardedSparseTable(conf, make_mesh(2), seed=0)
    rebuilt.load_state_dict(live.state_dict())
    assert live.reshard(make_mesh(2)) > 0
    for t in (live, rebuilt):
        _sharded_lifecycle(t, censuses[2:])
    a, b = live.state_dict(), rebuilt.state_dict()
    np.testing.assert_array_equal(a["keys"], b["keys"])
    np.testing.assert_array_equal(a["values"], b["values"])
    live.close()
    rebuilt.close()


# --------------------------------------------------------------------------- #
# the hybrid-placement kernel and the multi-chip path
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["main", "ragged", "empty", "all_sink",
                                  "all_hot", "one_row"])
def test_hot_cold_select_kernel_bit_exact(cuda, case):
    H, W, K = {"main": (4096, 10, 131072), "ragged": (4096, 10, 12345),
               "empty": (4096, 10, 0), "all_sink": (4096, 10, 5000),
               "all_hot": (4096, 10, 5000), "one_row": (1, 10, 5000)}[case]
    gen = torch.Generator(device=cuda).manual_seed(K + H)
    hot = torch.randn((H, W), device=cuda, generator=gen)
    cold = torch.randn((K, W), device=cuda, generator=gen)
    lo, hi = {"all_sink": (H, H + 1), "all_hot": (0, H)}.get(case, (0, H + 1))
    occ = torch.randint(lo, hi, (K,), device=cuda, generator=gen,
                        dtype=torch.int32)
    before = sk.launches["hot_cold_select"]
    got = sk.hot_cold_select(hot, occ, cold)
    torch.cuda.synchronize()
    assert got.shape == (K, W)
    assert torch.equal(got, sk.hot_cold_select_plain(hot, occ, cold))
    assert sk.launches["hot_cold_select"] == before + (1 if K else 0)


# (W, K, occurrences): K * W mod 4 is 2 at (10, 12345), 3 at (11, 1001)
# and (3, 5001); K = 1 at W = 10 leaves a tail of 2 after 2 vectors, at
# W = 3 a tail alone; W = 1 and a cold block based 4 bytes in take the
# scalar path; K = 1 000 001 gives each block several tiles
@pytest.mark.parametrize("case", [
    "w10_k12345", "w11_k1001", "w3_k5001", "w2_k4097", "w10_k1", "w3_k1",
    "w10_k12345_all_hot", "w10_k12345_all_cold", "w1_k5001",
    "w10_k12345_cold_base4", "w10_k1000001",
])
def test_hot_cold_select_kernel_paths_bit_exact(cuda, case):
    parts = case.split("_")
    W, K = int(parts[0][1:]), int(parts[1][1:])
    H = 4096
    gen = torch.Generator(device=cuda).manual_seed(K + W)
    hot = torch.randn((H, W), device=cuda, generator=gen)
    if case.endswith("cold_base4"):
        flat = torch.randn(K * W + 1, device=cuda, generator=gen)
        cold = flat[1:].view(K, W)
        assert cold.data_ptr() % 16 == 4
    else:
        cold = torch.randn((K, W), device=cuda, generator=gen)
    lo, hi = {"hot": (0, H), "cold": (H, H + 1)}.get(parts[-1], (0, H + 1))
    occ = torch.randint(lo, hi, (K,), device=cuda, generator=gen,
                        dtype=torch.int32)
    before = sk.launches["hot_cold_select"]
    got = sk.hot_cold_select(hot, occ, cold)
    torch.cuda.synchronize()
    assert got.shape == (K, W)
    assert torch.equal(got, sk.hot_cold_select_plain(hot, occ, cold))
    assert sk.launches["hot_cold_select"] == before + 1


def test_hybrid_path_on_the_card(cuda, tmp_path):
    """Four positions on the card, three passes: the hot block realizes,
    the pull routes hot occurrences through the kernel once per position
    and step, and the card agrees with the CPU at the slice tolerances."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )

    files = write_synth_files(str(tmp_path), n_files=1, ins_per_file=256,
                              n_sparse_slots=3, vocab_per_slot=60,
                              dense_dim=2, seed=1)
    ds = PadBoxSlotDataset(make_synth_config(3, 2, 16, 16), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=4, placement="loopback",
                              placement_update_interval=1,
                              placement_hot_capacity=64, hbm_cache_rows=0)
    out = {}
    for device in ("cuda", "cpu"):
        mesh = make_mesh(4, device=device)
        tr = MultiChipTrainer(CtrDnn(3, tconf.row_width, dense_dim=2,
                                     hidden=(8,), device=device),
                              tconf, mesh, TrainerConfig(auc_buckets=1 << 10))
        table = ShardedSparseTable(tconf, mesh, seed=5, bucket_slack=8.0)
        sk.reset_launches()
        steps = hot = 0
        for _ in range(3):
            table.begin_pass(ds.unique_keys())
            m = tr.train_from_dataset(ds, table)
            table.end_pass()
            steps += m["steps"]
            hot += m["hot_occurrences"]
        out[device] = (m, table.state_dict(), dict(sk.launches))
        assert table.hot_resident_keys().shape[0] > 0 and hot > 0
    (mg, sg, lg), (mc, sc, lc) = out["cuda"], out["cpu"]
    assert lg["hot_cold_select"] == 4 * steps and lc["hot_cold_select"] == 0
    assert lg["pull_rows"] == lg["scatter_add_rows"] == 4 * steps
    assert abs(mg["loss"] - mc["loss"]) < 1e-4 * abs(mc["loss"])
    np.testing.assert_array_equal(sg["keys"], sc["keys"])
    np.testing.assert_allclose(sg["values"], sc["values"], atol=1e-4)
    ds.close()


def test_staged_feed_is_awaited(cuda):
    """The prefetch producer's copy (pinned memory, its own stream) held
    back behind a long sleep on that stream: the consumer's stream waits
    for it, so a read right after await_feed sees the data."""
    from paddlebox_tpu_torch.train import trainer as trainer_mod

    host = {"a": np.arange(1 << 22, dtype=np.float32),
            "b": np.arange(1000, dtype=np.int32)[::-1].copy()}
    trainer_mod.stage_feed({"c": host["b"]}, cuda)  # makes the copy stream
    side = trainer_mod._copy_streams[cuda]
    assert side != torch.cuda.current_stream(cuda)
    with torch.cuda.stream(side):
        torch.cuda._sleep(1 << 28)  # a few hundred ms on the copy stream
    dev, ready = trainer_mod.stage_feed(host, cuda)
    assert all(t.is_cuda for t in dev.values())
    assert not ready.query()  # the copies wait behind the sleep
    got = {k: (t + 0).cpu()
           for k, t in trainer_mod.await_feed(dev, ready).items()}
    for k, v in host.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k


def test_prefetched_runs_are_bit_equal_to_serial(cuda, tmp_path):
    """Under deterministic algorithms, two cached single-chip passes and
    three hybrid passes on four positions give the same losses, AUCs and
    tables with the prefetch thread (pinned copies on a side stream) as
    with the serial feed, and launch the kernels as often."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    files = write_synth_files(str(tmp_path), n_files=1, ins_per_file=512,
                              n_sparse_slots=4, vocab_per_slot=80,
                              dense_dim=3, seed=2, zipf_a=1.3)
    ds = PadBoxSlotDataset(make_synth_config(4, 3, 32, 16), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()

    def run(positions, prefetch):
        trconf = TrainerConfig(auc_buckets=1 << 10, prefetch_batches=prefetch)
        if positions:
            tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0,
                                      placement_update_interval=1,
                                      placement_hot_capacity=64)
            mesh = make_mesh(positions)
            table = ShardedSparseTable(tconf, mesh, seed=5)
            tr = MultiChipTrainer(CtrDnn(4, tconf.row_width, dense_dim=3,
                                         hidden=(16, 8)), tconf, mesh, trconf)
        else:
            tconf = SparseTableConfig(embedding_dim=4)
            table = SparseTable(tconf, seed=5)
            tr = Trainer(CtrDnn(4, tconf.row_width, dense_dim=3,
                                hidden=(16, 8)), tconf, trconf)
        sk.reset_launches()
        metrics = []
        for p in range(3 if positions else 2):
            ds.local_shuffle(seed=p)
            table.begin_pass(ds.unique_keys())
            metrics.append(tr.train_from_dataset(ds, table))
            table.end_pass()
        torch.cuda.synchronize()
        return metrics, table.state_dict(), dict(sk.launches)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for positions in (0, 4):
            (m0, s0, l0), (m2, s2, l2) = run(positions, 0), run(positions, 2)
            assert l0 == l2 and l0["pull_rows"] > 0
            for a, b in zip(m0, m2):
                assert (a["loss"], a["auc"], a["samples"]) == \
                    (b["loss"], b["auc"], b["samples"])
            if positions:
                assert m2[-1]["hot_occurrences"] > 0
            np.testing.assert_array_equal(s0["keys"], s2["keys"])
            np.testing.assert_array_equal(s0["values"], s2["values"])
    finally:
        torch.use_deterministic_algorithms(False)
        ds.close()


# --------------------------------------------------------------------------- #
# scan_steps as a CUDA graph
# --------------------------------------------------------------------------- #
def _graph_world(tmp_path, scan_steps, model_cls=None, **trkw):
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    files = write_synth_files(str(tmp_path / f"g{scan_steps}"), n_files=1,
                              ins_per_file=640, n_sparse_slots=4,
                              vocab_per_slot=80, dense_dim=3, seed=4)
    ds = PadBoxSlotDataset(make_synth_config(4, 3, 32, 16), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=4)
    table = SparseTable(tconf, seed=5)
    model = (model_cls or CtrDnn)(4, tconf.row_width, dense_dim=3,
                                  hidden=(16, 8))
    tr = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 10,
                                             scan_steps=scan_steps, **trkw))
    return ds, table, tr


def _graph_passes(ds, table, tr, passes=2):
    out = []
    for p in range(passes):
        ds.local_shuffle(seed=p)
        table.begin_pass(ds.unique_keys())
        out.append(tr.train_from_dataset(ds, table,
                                         auc_state=tr.last_metric_state))
        table.end_pass()
    torch.cuda.synchronize()
    return out, table.state_dict()


def test_captured_steps_equal_eager_steps(cuda, tmp_path):
    """20 batches a pass in groups of 4 (an eager warm-up group, then four
    replays, the first right after the capture), two passes: the same
    losses, AUC, grad_norm and table as one eager step at a time, under
    deterministic algorithms; one capture a pass (the table is
    reallocated at each begin_pass)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for k in (1, 4):
            ds, table, tr = _graph_world(tmp_path, k)
            runs[k] = _graph_passes(ds, table, tr) + (tr,)
            table.close()
            ds.close()
    finally:
        torch.use_deterministic_algorithms(False)
    (m1, s1, _), (m4, s4, tr4) = runs[1], runs[4]
    assert tr4.graph_captures == 2 and tr4.graph_replays == 2 * 4
    for a, b in zip(m1, m4):
        assert a["steps"] == b["steps"] == 20
        for key in ("loss", "auc", "count", "grad_norm", "weight_norm"):
            assert a[key] == b[key], key
    np.testing.assert_array_equal(s1["keys"], s4["keys"])
    np.testing.assert_array_equal(s1["values"], s4["values"])


def test_graph_recaptured_after_table_reallocation(cuda, tmp_path):
    """Within a pass the graph replays; a new begin_pass reallocates the
    table's tensors and the next full group after the warm-up recaptures;
    a load_dense_state (new optimizer tensors) drops the graph too."""
    ds, table, tr = _graph_world(tmp_path, 4)
    _graph_passes(ds, table, tr, passes=1)
    assert (tr.graph_captures, tr.graph_replays) == (1, 4)
    old = tr._graph
    _graph_passes(ds, table, tr, passes=1)
    assert (tr.graph_captures, tr.graph_replays) == (2, 8)
    assert tr._graph is not old and tr._graph.values is not old.values
    tr.load_dense_state(*tr.dense_state())
    assert tr._graph is None
    _graph_passes(ds, table, tr, passes=1)
    assert tr.graph_captures == 3
    table.close()
    ds.close()


def test_skip_batch_under_the_graph_drops_only_the_poisoned_batch(cuda,
                                                                   tmp_path):
    """A train.nan-poisoned batch in a replayed group under skip_batch
    leaves the state of the same pass without that batch, deterministic."""
    from paddlebox_tpu_torch.utils import faults

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ds, table, tr = _graph_world(tmp_path, 4, nan_policy="skip_batch")
        batches = list(ds.batches())
        table.begin_pass(ds.unique_keys())
        with faults.fault_plan({"train.nan": "at:13"}):
            ma = tr.train_steps(table, batches)
        table.end_pass()
        sa = table.state_dict()
        table.close()
        ds2, table2, tr2 = _graph_world(tmp_path, 4)
        table2.begin_pass(ds.unique_keys())
        mb = tr2.train_steps(table2, batches[:13] + batches[14:])
        table2.end_pass()
        sb = table2.state_dict()
        table2.close()
        ds.close()
        ds2.close()
    finally:
        torch.use_deterministic_algorithms(False)
    assert tr.graph_replays > 0 and ma["steps"] == mb["steps"] == 19
    assert (ma["loss"], ma["auc"]) == (mb["loss"], mb["auc"])
    np.testing.assert_array_equal(sa["values"], sb["values"])


def _group_world(tmp_path, scan_steps, **trkw):
    """_graph_world on logkey data with a 4-spec metric group."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.metrics import MetricGroup, MetricSpec
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    files = write_synth_files(str(tmp_path / f"mg{scan_steps}"), n_files=1,
                              ins_per_file=640, n_sparse_slots=4,
                              vocab_per_slot=80, dense_dim=3, seed=4,
                              with_logkey=True, cmatch_values=(222, 223, 1))
    ds = PadBoxSlotDataset(make_synth_config(4, 3, 32, 16, parse_logkey=True),
                           read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    group = MetricGroup([MetricSpec("all"), MetricSpec("cm222", (222,)),
                         MetricSpec("rank1", rank_values=(1,)),
                         MetricSpec("none", (999,))], n_buckets=1 << 10)
    tconf = SparseTableConfig(embedding_dim=4)
    table = SparseTable(tconf, seed=5)
    tr = Trainer(CtrDnn(4, tconf.row_width, dense_dim=3, hidden=(16, 8)),
                 tconf, TrainerConfig(auc_buckets=1 << 10,
                                      scan_steps=scan_steps, **trkw),
                 metric_group=group)
    return ds, table, tr


def test_captured_steps_with_a_metric_group_equal_eager(cuda, tmp_path):
    """The group's masks ride the captured graph as one more static feed
    slot: two passes in groups of 4 equal eager steps bit for bit, every
    spec's streams included, under deterministic algorithms."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for k in (1, 4):
            ds, table, tr = _group_world(tmp_path, k)
            runs[k] = _graph_passes(ds, table, tr) + (tr,)
            table.close()
            ds.close()
    finally:
        torch.use_deterministic_algorithms(False)
    (m1, s1, tr1), (m4, s4, tr4) = runs[1], runs[4]
    assert tr4.graph_captures == 2 and tr4.graph_replays == 2 * 4
    for a, b in zip(m1, m4):
        assert a == {**b, "duration_s": a["duration_s"]}
        assert b["all/auc"] == b["auc"] and b["none/count"] == 0
        assert 0 < b["cm222/count"] < b["count"]
    for a, b in zip(tr1.last_metric_state["group"],
                    tr4.last_metric_state["group"]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(s1["values"], s4["values"])


def test_dumped_pass_with_scan_steps_runs_single_steps(cuda, tmp_path):
    """need_dump_field with scan_steps 8: no graph is captured, every step
    dumps its instances, and the dump equals that of scan_steps 1 under
    deterministic algorithms."""
    dumps = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for k in (1, 8):
            path = tmp_path / f"dump{k}"
            ds, table, tr = _group_world(
                tmp_path, k, need_dump_field=True,
                dump_fields_path=str(path), dump_fields=("cmatch", "rank"))
            out, _ = _graph_passes(ds, table, tr, passes=1)
            assert tr.graph_captures == 0 and out[0]["steps"] == 20
            with open(path / "dump-0.txt") as f:
                dumps.append(f.read())
            table.close()
            ds.close()
    finally:
        torch.use_deterministic_algorithms(False)
    assert dumps[0] == dumps[1] and dumps[0].count("\n") == 640


def test_graph_captures_and_kernel_loads_count_as_compiles(cuda, tmp_path):
    """jit.compiles: one train.scan event a CUDA graph capture, and each
    kernel's first load in the process once, whatever runs after."""
    from paddlebox_tpu_torch import telemetry

    ds, table, tr = _graph_world(tmp_path, 4)
    before = telemetry.compiles_by_stage()
    _graph_passes(ds, table, tr)
    after = telemetry.compiles_by_stage()
    assert (after.get("train.scan", 0) - before.get("train.scan", 0)
            == tr.graph_captures == 2)
    assert {"pallas.pull_rows", "pallas.scatter_add"} <= set(after)
    assert all(v == 1 for k, v in after.items() if k.startswith("pallas."))
    table.close()
    ds.close()


def test_profiled_pass_writes_host_and_device_traces(cuda, tmp_path):
    """profile and TrainerConfig.trace_dir on the card: single synchronized
    steps (no capture), a host trace with plan, feed and step under pass,
    and a torch.profiler trace that names the pull_rows and
    scatter_add_rows kernels."""
    import json
    import os

    from paddlebox_tpu_torch import telemetry

    d = tmp_path / "traces"
    ds, table, tr = _graph_world(tmp_path, 4, profile=True, trace_dir=str(d))
    try:
        out, _ = _graph_passes(ds, table, tr, passes=1)
    finally:
        telemetry.disable_tracing()
    assert tr.graph_captures == 0 and out[0]["profile"]["steps"] == 20
    host = json.load(open(d / "host-trace-r0-pass0.json"))
    spans = {(e["name"], e.get("args", {}).get("parent"))
             for e in host["traceEvents"] if e.get("ph") == "X"}
    assert {("pass", None), ("plan", "pass"), ("feed", "pass"),
            ("step", "pass")} <= spans
    (dev,) = [n for n in os.listdir(d) if n.startswith("device-trace-")]
    kernels = {e["name"] for e in json.load(open(d / dev))["traceEvents"]
               if e.get("cat") == "kernel"}
    for name in ("pull_rows", "scatter_add"):
        assert any(name in k for k in kernels), name
    table.close()
    ds.close()


# the model zoo at a small width: name -> (model class, kwargs, table
# kwargs, trainer kwargs); every entry trains on logkey data with one task
# label, RankCtrDnn's PV-merged
ZOO = {
    "wide_deep": ("WideDeep", dict(hidden=(16,)), {}, {}),
    "deepfm": ("DeepFM", dict(hidden=(16,)), {}, {}),
    "dcn": ("DCN", dict(hidden=(16,), n_cross=2), {}, {}),
    "xdeepfm": ("XDeepFM", dict(hidden=(16,), cin_layers=(8, 8)), {}, {}),
    "rank_ctr": ("RankCtrDnn", dict(hidden=(16,), att_out_dim=8), {}, {}),
    "mmoe": ("MMoE", dict(n_tasks=2, n_experts=2, expert_hidden=(16,),
                          expert_dim=8, tower_hidden=(8,)), {}, {}),
    "ctr_conv": ("CtrDnn", dict(hidden=(16,), layout="conv", cvm_offset=3),
                 dict(cvm_offset=3), dict(counter_label_tasks=(1,))),
    "ctr_expand": ("CtrDnn", dict(hidden=(16,), expand_dim=3),
                   dict(expand_dim=3), {}),
    "ctr_slot_dims": ("CtrDnn", dict(hidden=(16,),
                                     slot_embed_dims=((0, 2), (3, 1))), {}, {}),
}


def _zoo_world(tmp_path, name, device, **trkw):
    from paddlebox_tpu_torch import models
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    cls, kw, tkw, zoo_trkw = ZOO[name]
    d = tmp_path / "zoo"
    files = sorted(str(p) for p in d.glob("part-*")) if d.exists() else \
        write_synth_files(str(d), n_files=1, ins_per_file=384,
                          n_sparse_slots=4, vocab_per_slot=60, dense_dim=3,
                          seed=6, with_logkey=True, n_task_labels=1)
    data_kw = dict(parse_logkey=True, n_task_labels=1)
    if name == "rank_ctr":
        data_kw.update(enable_pv_merge=True, pv_batch_size=8,
                       rank_offset="rank_offset")
    ds = PadBoxSlotDataset(make_synth_config(4, 3, 32, 16, **data_kw),
                           read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    if name == "rank_ctr":
        ds.preprocess_instance()
    tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0, **tkw)
    table = SparseTable(tconf, seed=5, device=device)
    model = getattr(models, cls)(4, tconf.row_width, dense_dim=3, seed=2,
                                 device=device, **kw)
    tr = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 10,
                                             **zoo_trkw, **trkw),
                 device=device)
    return ds, table, tr


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_pass_on_the_card_matches_cpu(cuda, tmp_path, name):
    """One pass of each zoo model on the card (the kernels launched) and on
    the CPU (the twins) from the same seeds: losses within 1e-4 relative,
    AUC within 1e-3, dense parameters and table rows within 1e-4."""
    runs = {}
    for device in ("cuda", "cpu"):
        ds, table, tr = _zoo_world(tmp_path, name, device)
        sk.reset_launches()
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table)
        table.end_pass()
        if device == "cuda":
            torch.cuda.synchronize()
            assert sk.launches["pull_rows"] == sk.launches[
                "scatter_add_rows"] == m["steps"] > 0
        runs[device] = (m, table.state_dict(),
                        [p.detach().cpu() for p in tr.model.parameters()])
        table.close()
        ds.close()
    (mg, sg, pg), (mc, sc, pc) = runs["cuda"], runs["cpu"]
    assert np.isfinite(mg["loss"])
    assert mg["loss"] == pytest.approx(mc["loss"], rel=1e-4)
    assert abs(mg["auc"] - mc["auc"]) <= 1e-3
    np.testing.assert_array_equal(sg["keys"], sc["keys"])
    np.testing.assert_allclose(sg["values"], sc["values"], rtol=0, atol=1e-4)
    for a, b in zip(pg, pc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
    if name == "mmoe":
        assert abs(mg["task1/auc"] - mc["task1/auc"]) <= 1e-3


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_captured_steps_equal_eager(cuda, tmp_path, name):
    """Each zoo model's steps captured as a CUDA graph (scan_steps 4: a
    warm-up group, then replays) equal eager steps under deterministic
    algorithms: losses, AUCs, grad_norm, parameters and table."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for k in (1, 4):
            ds, table, tr = _zoo_world(tmp_path, name, "cuda", scan_steps=k)
            table.begin_pass(ds.unique_keys())
            m = tr.train_from_dataset(ds, table)
            table.end_pass()
            torch.cuda.synchronize()
            runs[k] = (m, table.state_dict(), tr)
            table.close()
            ds.close()
    finally:
        torch.use_deterministic_algorithms(False)
    (m1, s1, t1), (m4, s4, t4) = runs[1], runs[4]
    assert t4.graph_captures == 1 and t4.graph_replays >= 1
    for key in m1:
        if key == "loss" or key.endswith("auc") or key == "grad_norm":
            assert m1[key] == m4[key], key
    np.testing.assert_array_equal(s1["values"], s4["values"])
    for a, b in zip(t1.model.parameters(), t4.model.parameters()):
        assert torch.equal(a, b)


# the models on the parallel axes and the retrieval model at a small width:
# name -> (model class, kwargs (a callable of the device for a mesh),
# data: "plain", "seq" or "tasks" (one task label), trainer: "ranking" or
# "retrieval")
AXES = {
    "two_tower": ("TwoTower", lambda d: dict(item_slots=(3,), hidden=(16,)),
                  "plain", "retrieval"),
    "longseq_full": ("LongSeqCtrDnn", lambda d: dict(
        hidden=(16,), max_seq_len=8, n_heads=4, head_dim=4), "seq",
        "ranking"),
    "longseq_ring": ("LongSeqCtrDnn", lambda d: dict(
        hidden=(16,), max_seq_len=8, n_heads=4, head_dim=4,
        seq_mesh=_axis_mesh(4, "seq", d), seq_impl="ring"), "seq",
        "ranking"),
    "longseq_ulysses": ("LongSeqCtrDnn", lambda d: dict(
        hidden=(16,), max_seq_len=8, n_heads=4, head_dim=4,
        seq_mesh=_axis_mesh(4, "seq", d), seq_impl="ulysses"), "seq",
        "ranking"),
    "pipelined_ctr": ("PipelinedCtrDnn", lambda d: dict(
        mesh=_axis_mesh(4, "pipe", d), hidden=(16, 8, 8), microbatches=8),
        "plain", "ranking"),
    "mmoe_expert": ("MMoE", lambda d: dict(
        n_tasks=2, n_experts=4, expert_hidden=(16,), expert_dim=8,
        tower_hidden=(8,), expert_mesh=_axis_mesh(4, "expert", d)),
        "tasks", "ranking"),
}


def _axis_mesh(n, axis, device):
    from paddlebox_tpu_torch.parallel import make_mesh

    return make_mesh(n, device=device, axis_name=axis)


def _axes_world(tmp_path, name, device, **trkw):
    from paddlebox_tpu_torch import models
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.scenarios import RetrievalTrainer
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    cls, kw, data, kind = AXES[name]
    d = tmp_path / data
    files = sorted(str(p) for p in d.glob("part-*")) if d.exists() else \
        write_synth_files(str(d), n_files=1, ins_per_file=256,
                          n_sparse_slots=4, vocab_per_slot=60, dense_dim=3,
                          seed=8, max_keys_per_slot=9 if data == "seq" else 3,
                          n_task_labels=int(data == "tasks"))
    data_kw = {"seq": dict(sequence_slot="slot0", max_seq_len=8),
               "tasks": dict(n_task_labels=1)}.get(data, {})
    ds = PadBoxSlotDataset(make_synth_config(4, 3, 32, 40, **data_kw),
                           read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0)
    table = SparseTable(tconf, seed=5, device=device)
    model = getattr(models, cls)(n_sparse_slots=4, emb_width=tconf.row_width,
                                 dense_dim=3, seed=2, device=device,
                                 **kw(device))
    trainer_cls = RetrievalTrainer if kind == "retrieval" else Trainer
    tr = trainer_cls(model, tconf, TrainerConfig(auc_buckets=1 << 10, **trkw),
                     device=device)
    return ds, table, tr


@pytest.mark.parametrize("name", sorted(AXES))
def test_parallel_axes_pass_on_the_card_matches_cpu(cuda, tmp_path, name):
    """One pass of each model of the parallel axes and of the retrieval
    trainer on the card (the row kernels launched) and on the CPU (the
    twins) from the same seeds, the zoo's card test bounds: losses within
    1e-4 relative, AUC within 1e-3, dense parameters and rows within
    1e-4.  The retrieval loss scales the row gradients by 1/temperature
    (20), so their accumulated squares, the g2sum column, by 400: that
    column within 1e-3 relative there."""
    runs = {}
    for device in ("cuda", "cpu"):
        ds, table, tr = _axes_world(tmp_path, name, device)
        sk.reset_launches()
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table)
        table.end_pass()
        if device == "cuda":
            torch.cuda.synchronize()
            assert sk.launches["pull_rows"] == sk.launches[
                "scatter_add_rows"] == m["steps"] > 0
        runs[device] = (m, table.state_dict(),
                        [p.detach().cpu() for p in tr.model.parameters()])
        table.close()
        ds.close()
    (mg, sg, pg), (mc, sc, pc) = runs["cuda"], runs["cpu"]
    assert np.isfinite(mg["loss"])
    assert mg["loss"] == pytest.approx(mc["loss"], rel=1e-4)
    assert abs(mg["auc"] - mc["auc"]) <= 1e-3
    np.testing.assert_array_equal(sg["keys"], sc["keys"])
    if AXES[name][3] == "retrieval":
        np.testing.assert_allclose(sg["values"][:, -1], sc["values"][:, -1],
                                   rtol=1e-3, atol=1e-4)
        sg, sc = ({"values": s_["values"][:, :-1]} for s_ in (sg, sc))
    np.testing.assert_allclose(sg["values"], sc["values"], rtol=0, atol=1e-4)
    for a, b in zip(pg, pc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["two_tower", "longseq_ring",
                                  "longseq_ulysses", "pipelined_ctr"])
def test_parallel_axes_captured_steps_equal_eager(cuda, tmp_path, name):
    """The retrieval step and the sequence and pipeline models captured as
    a CUDA graph (scan_steps 4) equal eager steps under deterministic
    algorithms: losses, AUC, grad_norm, parameters and table."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for k in (1, 4):
            ds, table, tr = _axes_world(tmp_path, name, "cuda", scan_steps=k)
            table.begin_pass(ds.unique_keys())
            m = tr.train_from_dataset(ds, table)
            table.end_pass()
            torch.cuda.synchronize()
            runs[k] = (m, table.state_dict(), tr)
            table.close()
            ds.close()
    finally:
        torch.use_deterministic_algorithms(False)
    (m1, s1, t1), (m4, s4, t4) = runs[1], runs[4]
    assert t4.graph_captures == 1 and t4.graph_replays >= 1
    for key in ("loss", "auc", "grad_norm"):
        assert m1[key] == m4[key], key
    np.testing.assert_array_equal(s1["values"], s4["values"])
    for a, b in zip(t1.model.parameters(), t4.model.parameters()):
        assert torch.equal(a, b)


def test_pipeline_trainer_and_aux_tables_on_the_card(cuda):
    """A PipelineTrainer step on the card against the CPU (SGD: the
    parameters' difference follows the gradients'), and the aux tables'
    device gathers against the host."""
    from paddlebox_tpu_torch.parallel import PipelineTrainer
    from paddlebox_tpu_torch.parallel.pipeline import init_pipeline_params
    from paddlebox_tpu_torch.sparse.aux_tables import InputTable, ReplicaCache

    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 10)).astype(np.float32)
    y = (x.mean(-1) > 0).astype(np.float32)
    params = init_pipeline_params(10, 32, 2, 4, seed=1, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        tr = PipelineTrainer(_axis_mesh(4, "pipe", device), 10, 32, 2,
                             params=params, optimizer=lambda ps: (
                                 torch.optim.SGD(ps, lr=0.1)))
        out[device] = (tr.train_step(x, y),
                       {k: v.detach().cpu() for k, v in tr.params.items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, v in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    table = InputTable(dim=3, device=cuda)
    table.add_row("a", [1.0, 2.0, 3.0])
    idx = table.lookup_idx(["a", "missing"])
    got = table.rows_device().index_select(
        0, torch.from_numpy(idx).to(cuda))
    assert torch.equal(got.cpu(), torch.from_numpy(
        table.lookup_rows(["a", "missing"])))
    cache = ReplicaCache(np.array([[1.0, 1.0], [2.0, 2.0]]), device=cuda)
    assert cache.values.is_cuda
    assert cache.pull([1, 2, 0, 99]).cpu().tolist() == [
        [1, 1], [2, 2], [0, 0], [0, 0]]


def _serving_world(tmp_path, export_device):
    """A small CtrDnn trained a pass on the CPU, its model moved to
    ``export_device``, and the set it trained on."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    files = write_synth_files(str(tmp_path / "serve"), n_files=1,
                              ins_per_file=200, n_sparse_slots=4,
                              vocab_per_slot=60, dense_dim=3, seed=8)
    conf = make_synth_config(4, 3, 32, 16)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=8, create_threshold=1.0,
                              pull_embedx_scale=0.5)
    table = SparseTable(tconf, seed=5, device="cpu")
    model = CtrDnn(4, tconf.row_width, dense_dim=3, hidden=(32, 16), seed=2,
                   device="cpu")
    tr = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 10),
                 device="cpu")
    table.begin_pass(ds.unique_keys())
    tr.train_from_dataset(ds, table)
    table.end_pass()
    return ds, table, model.to(export_device), conf


@pytest.mark.parametrize("export_device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp8"])
def test_predict_on_the_card_matches_cpu(cuda, tmp_path, export_device,
                                         dtype):
    """An artifact exported on either device serves on the card and on the
    CPU: the card's Predictor resolves every batch with sorted_search and
    gather_slots (one search and one gather a batch, three gathers when
    quantized), and its scores agree with the CPU's within 1e-5 relative
    / 1e-6 absolute (float32 towers, another summation order)."""
    from paddlebox_tpu_torch.inference import Predictor, export_model

    ds, table, model, conf = _serving_world(tmp_path, export_device)
    art = str(tmp_path / "art")
    export_model(model, table, art, batch_size=32, key_capacity=32 * 16,
                 dense_dim=3, embedding_dtype=dtype, feed_conf=conf,
                 batch_buckets=[(8, 128)])
    table.close()
    preds = {d: Predictor.load(art, device=d) for d in ("cuda", "cpu")}
    sk.reset_launches()
    n = 0
    for batch in ds.batches(drop_last=False):
        batch.keys = batch.keys.copy()
        batch.keys[::7] += np.uint64(1 << 63)  # unseen, above 2^63
        got = preds["cuda"].predict(batch)
        want = preds["cpu"].predict(batch)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        n += 1
    torch.cuda.synchronize()
    assert sk.launches["sorted_search"] == n > 0
    assert sk.launches["gather_slots"] == n * (1 if dtype == "fp32" else 3)
    ds.close()


def test_serving_kernels_at_the_serving_shapes(cuda):
    """sorted_search over a 2^21 haystack of 1 570 824 keys (keys at and
    above 2^63, the all-ones key real) with 131 072 queries, a third
    unseen; gather_slots over a [1 570 824, 10] table and over 8-byte
    code rows viewed as float32 [N, 2]: bit-exact against the twins."""
    n, nq = 1_570_824, 131_072
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 2 ** 64 - 2, size=n + 4096,
                                  dtype=np.uint64, endpoint=True))[:n - 1]
    keys = np.append(keys, np.uint64(2 ** 64 - 1))
    c = 1 << (n - 1).bit_length()
    hay = np.full(c, -1, np.int64)
    hay[:keys.shape[0]] = keys.view(np.int64)
    q = rng.choice(keys, nq)
    q[::3] = rng.integers(0, 2 ** 64 - 2, size=q[::3].shape[0],
                          dtype=np.uint64)
    hay_t = torch.from_numpy(hay).to(cuda)
    q_t = torch.from_numpy(q.view(np.int64)).to(cuda)
    slots = sk.sorted_search(hay_t, keys.shape[0], q_t)
    want = sk.sorted_search_plain(hay_t.cpu(), keys.shape[0], q_t.cpu())
    torch.cuda.synchronize()
    assert torch.equal(slots.cpu(), want)
    assert (want < 0).any() and (want >= 0).any()
    gen = torch.Generator(device=cuda).manual_seed(2)
    for width in (10, 2):
        table = torch.randn((keys.shape[0], width), device=cuda,
                            generator=gen)
        got = sk.gather_slots(table, slots)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           sk.gather_slots_plain(table.cpu(), slots.cpu()))


def test_scoring_server_on_the_card(cuda, tmp_path):
    """/score on the card answers the CPU server's scores; the card is the
    server's default device."""
    import http.client
    import json

    from paddlebox_tpu_torch.inference import ScoringServer, export_model

    ds, table, model, conf = _serving_world(tmp_path, "cpu")
    art = str(tmp_path / "art")
    export_model(model, table, art, batch_size=32, key_capacity=32 * 16,
                 dense_dim=3, feed_conf=conf)
    table.close()
    ds.close()
    rng = np.random.default_rng(1)
    lines = []
    for _ in range(50):
        parts = ["1 0"]
        for _s in range(4):
            ks = rng.integers(0, 300, int(rng.integers(1, 4)))
            parts.append(f"{len(ks)} " + " ".join(map(str, ks)))
        parts.append("3 0.1 0.2 0.3")
        lines.append(" ".join(parts))
    body = ("\n".join(lines) + "\n").encode()
    out = {}
    for srv in (ScoringServer(), ScoringServer(device="cpu")):
        srv.register("m", art)
        port = srv.start(port=0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/score", body=body)
            r = conn.getresponse()
            assert r.status == 200
            out[srv.device.type] = json.loads(r.read())["scores"]
            conn.close()
        finally:
            srv.stop()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_collectives_over_a_one_rank_group_on_the_card(cuda, backend):
    """The four data-axis collectives through a 1-rank process group on
    the card (NCCL, and gloo through pinned host copies) equal the
    in-process tensor operations bit for bit, and count their bytes."""
    from paddlebox_tpu_torch.launch import find_free_port
    from paddlebox_tpu_torch.parallel import collectives
    from paddlebox_tpu_torch.parallel import mesh as mesh_mod

    job = mesh_mod.initialize_distributed(
        f"127.0.0.1:{find_free_port()}", 1, 0, backend=backend,
        device="cuda", timeout_s=120.0)
    try:
        assert job.backend == backend
        assert job.host_staged == (backend == "gloo")
        gen = torch.Generator(device=cuda).manual_seed(5)
        x = torch.randn((4, 4, 3, 10), device=cuda, generator=gen)
        y = torch.randn((4, 1000), device=cuda, generator=gen)
        z = torch.randint(-9, 9, (4, 6), device=cuda, generator=gen)
        collectives.reset_stats()
        assert torch.equal(collectives.all_to_all(x, job),
                           collectives.all_to_all(x))
        assert torch.equal(collectives.all_gather(y, job),
                           collectives.all_gather(y))
        assert torch.equal(collectives.psum(y, job), collectives.psum(y))
        assert torch.equal(collectives.pmax(y, job), collectives.pmax(y))
        assert torch.equal(collectives.psum(z, job), collectives.psum(z))
        a, b = collectives.psum_many([y, 2 * y], job)
        assert torch.equal(a, collectives.psum(y)[0])
        assert torch.equal(b, collectives.psum(2 * y)[0])
        st = collectives.stats()
        assert st["all_to_all"]["calls"] == 1
        assert st["all_to_all"]["bytes"] == x.numel() * 4
        assert st["all_gather"]["calls"] == 5
        assert (st["all_gather"]["host_bytes"] > 0) == (backend == "gloo")
    finally:
        mesh_mod.shutdown_distributed()


def _publish_chain(tmp_path, device, n_deltas=2):
    """A small CtrDnn trained on ``device``, published as a base and
    ``n_deltas`` deltas (one pass each, with programs) to a local root:
    (root, table, model, conf)."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.serving_sync import Publisher
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    conf = make_synth_config(4, 3, 32, 16)
    tconf = SparseTableConfig(embedding_dim=8)
    table = SparseTable(tconf, seed=5, device=device)
    model = CtrDnn(4, tconf.row_width, dense_dim=3, hidden=(32, 16), seed=2,
                   device=device)
    tr = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 10),
                 device=device)
    root = str(tmp_path / "publish")
    pub = Publisher(root, staging_dir=str(tmp_path / "stage"))
    for i in range(n_deltas + 1):
        files = write_synth_files(str(tmp_path / f"d{i}"), n_files=1,
                                  ins_per_file=160, n_sparse_slots=4,
                                  vocab_per_slot=80, dense_dim=3,
                                  seed=20 + i)
        ds = PadBoxSlotDataset(conf, read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        table.begin_pass(ds.unique_keys())
        tr.train_from_dataset(ds, table)
        table.end_pass()
        ds.close()
        if i == 0:
            pub.publish_base("p0", model, None, table, batch_size=32,
                             key_capacity=32 * 16, dense_dim=3,
                             feed_conf=conf)
        else:
            pub.publish_delta(f"p{i}", table, model)
    return root, table, model, conf


def test_syncer_on_a_card_server_applies_base_and_deltas(cuda, tmp_path):
    """A Syncer on a card ScoringServer applies a base and two deltas: the
    live Predictor holds the table's rows on the card bit for bit, scores
    as a fresh export does, and each predict after the deltas launches
    sorted_search and gather_slots once."""
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import write_synth_files
    from paddlebox_tpu_torch.inference import (
        Predictor,
        ScoringServer,
        export_model,
    )
    from paddlebox_tpu_torch.serving_sync import Syncer

    root, table, model, conf = _publish_chain(tmp_path, "cpu")
    server = ScoringServer()
    assert server.device.type == "cuda"
    sync = Syncer(root, server, "live", cache_dir=str(tmp_path / "cache"))
    assert sync.poll_once() == 3
    live = server._models["live"].predictor
    assert live.device.type == "cuda" and live.upload_seconds > 0
    assert {"fetch_s", "merge_s", "upload_s", "swap_s"} <= set(
        sync.last_apply)
    state = table.state_dict()
    w = table.conf.row_width
    np.testing.assert_array_equal(live._keys, state["keys"])
    np.testing.assert_array_equal(live._dev[0].cpu().numpy(),
                                  np.asarray(state["values"])[:, :w])
    art = str(tmp_path / "fresh")
    export_model(model, table, art, batch_size=32, key_capacity=32 * 16,
                 dense_dim=3, feed_conf=conf)
    fresh = Predictor.load(art, device="cpu")
    files = write_synth_files(str(tmp_path / "q"), n_files=1,
                              ins_per_file=96, n_sparse_slots=4,
                              vocab_per_slot=100, dense_dim=3, seed=77)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    sk.reset_launches()
    n = 0
    for batch in ds.batches(drop_last=False):
        np.testing.assert_allclose(live.predict(batch), fresh.predict(batch),
                                   rtol=1e-5, atol=1e-6)
        n += 1
    torch.cuda.synchronize()
    assert sk.launches["sorted_search"] == sk.launches["gather_slots"] == n
    ds.close()
    table.close()


def test_with_delta_resolve_is_bit_exact_against_the_twins(cuda):
    """A card Predictor's with_delta (replaced and inserted keys, one
    above 2^63): the new snapshot's resolve of every key, and of unseen
    ones, is bit-exact against sorted_search's and gather_slots' twins."""
    from paddlebox_tpu_torch.inference import Predictor

    rng = np.random.default_rng(4)
    w = 7
    keys = np.unique(rng.integers(1, 2 ** 64 - 1, 3000, dtype=np.uint64))
    meta = {"row_width": w, "cvm_offset": 2, "create_threshold": 0.0,
            "pull_embedx_scale": 1.0, "buckets": []}
    base = Predictor(meta, keys, rng.normal(size=(keys.shape[0], w))
                     .astype(np.float32), "", [], device="cuda")
    dk = np.concatenate([rng.choice(keys, 500, replace=False),
                         rng.integers(1, 2 ** 64 - 1, 700, dtype=np.uint64),
                         np.array([2 ** 63 + 5], np.uint64)])
    dv = rng.normal(size=(dk.shape[0], w)).astype(np.float32)
    new = base.with_delta(dk, dv)
    assert new is not base and new.n_features > base.n_features
    q = np.concatenate([new._keys, rng.integers(1, 2 ** 64 - 1, 400,
                                                dtype=np.uint64)])
    q_t = torch.from_numpy(q.view(np.int64)).to(cuda)
    before = dict(sk.launches)
    slots = sk.sorted_search(new._hay, new._n_real, q_t)
    rows = sk.gather_slots(new._dev[0], slots)
    torch.cuda.synchronize()
    assert sk.launches["sorted_search"] == before["sorted_search"] + 1
    want = sk.sorted_search_plain(new._hay.cpu(), new._n_real, q_t.cpu())
    assert torch.equal(slots.cpu(), want)
    assert torch.equal(rows.cpu(), sk.gather_slots_plain(new._dev[0].cpu(),
                                                         want))
    # the delta's rows are the newest: the last write of each key wins
    last = {int(k): v for k, v in zip(dk, dv)}
    got = rows.cpu().numpy()[: new.n_features]
    for i, k in enumerate(new._keys.tolist()):
        if k in last:
            assert np.array_equal(got[i], last[k])


def test_streaming_window_trains_on_the_card(cuda, tmp_path):
    """A StreamingTrainer on the card: every window launches pull_rows and
    scatter_add_rows, and the windows equal one pass over the same records
    under deterministic algorithms."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.streaming import (
        IterableSource,
        MiniPassScheduler,
        StreamingTrainer,
    )
    from paddlebox_tpu_torch.train import Trainer

    conf = make_synth_config(3, 2, 16, 16)
    files = write_synth_files(str(tmp_path / "d"), n_files=1,
                              ins_per_file=384, n_sparse_slots=3,
                              vocab_per_slot=40, dense_dim=2, seed=17)
    lines = open(files[0]).read().splitlines()

    def world():
        tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=64)
        return (SparseTable(tconf, seed=3, device=cuda),
                Trainer(CtrDnn(3, tconf.row_width, dense_dim=2,
                               hidden=(16, 8), seed=3, device=cuda),
                        tconf, TrainerConfig(auc_buckets=1 << 12),
                        device=cuda))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        table, trainer = world()
        ds = PadBoxSlotDataset(conf, read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table)
        table.end_pass()
        want = table.state_dict()
        table.close()
        ds.close()
        table, trainer = world()
        src = IterableSource(lines).start()
        sched = MiniPassScheduler(src, conf, window_records=128,
                                  window_seconds=0.0).start()
        runner = StreamingTrainer(trainer, table, sched)
        counts = []
        train = runner._train_window

        def counted(window, wd):
            before = dict(sk.launches)
            train(window, wd)
            counts.append({k: sk.launches[k] - before[k]
                           for k in ("pull_rows", "scatter_add_rows")})

        runner._train_window = counted
        summary = runner.run()
        got = table.state_dict()
        table.close()
    finally:
        torch.use_deterministic_algorithms(False)
    assert summary["windows"] == 3
    assert all(c["pull_rows"] == c["scatter_add_rows"] == 8 for c in counts)
    assert np.array_equal(got["keys"], want["keys"])
    assert np.array_equal(got["values"], want["values"])
    assert summary["auc"] == m["auc"]


def test_fleet_of_two_replicas_on_the_card(cuda, tmp_path):
    """``serve --replicas 2`` without --cpu: both replicas serve on the card
    behind the router, whose /score answers the CPU server's scores; a
    SIGTERM to the fleet takes the replicas down with it."""
    import http.client
    import json
    import os
    import signal
    import subprocess
    import sys
    import time

    from paddlebox_tpu_torch.inference import ScoringServer, export_model

    ds, table, model, conf = _serving_world(tmp_path, "cpu")
    art = str(tmp_path / "art")
    export_model(model, table, art, batch_size=32, key_capacity=32 * 16,
                 dense_dim=3, feed_conf=conf)
    table.close()
    ds.close()
    body = b"".join(f"1 0 2 {k} {k + 61} 1 {k + 120} 1 {k + 180} 1 "
                    f"{k + 240} 3 0.1 0.2 0.3\n".encode()
                    for k in range(1, 40))
    cpu = ScoringServer(device="cpu")
    cpu.register("m", art)
    want = cpu.score_lines(body)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.serve", "--artifact",
         f"m={art}", "--replicas", "2", "--router-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
    try:
        port, seen = None, []
        t0 = time.time()
        while port is None and time.time() - t0 < 240:
            line = proc.stdout.readline()
            if not line:
                assert proc.poll() is None, "".join(seen)
                continue
            seen.append(line)
            if "fleet router on http://" in line:
                port = int(line.split(":")[2].split("/")[0])
        assert port, "".join(seen)

        def get(path):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            c.request("GET", path)
            out = json.loads(c.getresponse().read())
            c.close()
            return out

        t0 = time.time()
        while get("/healthz").get("n_serving", 0) < 2:
            assert time.time() - t0 < 240, get("/fleet")
            time.sleep(0.5)
        for _ in range(4):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            c.request("POST", "/score", body=body)
            r = c.getresponse()
            assert r.status == 200
            np.testing.assert_allclose(json.loads(r.read())["scores"], want,
                                       rtol=1e-5, atol=1e-6)
            c.close()
        addrs = [r["addr"] for r in get("/fleet")["replicas"]]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    for a in addrs:
        host, _, p = a.rpartition(":")
        with pytest.raises(OSError):
            c = http.client.HTTPConnection(host, int(p), timeout=5)
            c.request("GET", "/healthz")


def test_multi_scenario_pass_on_the_card_matches_cpu(cuda, tmp_path):
    """A ranker and a two-tower scenario over one table, one interleaved
    pass on the card (the kernels launched once a step) and on the CPU from
    the same seeds: the zoo's card-against-CPU bounds."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn, TwoTower
    from paddlebox_tpu_torch.scenarios import MultiScenarioTrainer, ScenarioSpec
    from paddlebox_tpu_torch.sparse.table import SparseTable

    files = write_synth_files(str(tmp_path / "d"), n_files=1,
                              ins_per_file=256, n_sparse_slots=4,
                              vocab_per_slot=50, dense_dim=3, seed=21)
    runs = {}
    for device in ("cuda", "cpu"):
        tconf = SparseTableConfig(embedding_dim=8)
        specs = [
            ScenarioSpec("rank", CtrDnn(4, tconf.row_width, dense_dim=3,
                                        hidden=(32, 16), seed=1,
                                        device=device),
                         trainer_conf=TrainerConfig(auc_buckets=1 << 10)),
            ScenarioSpec("retr", TwoTower(4, tconf.row_width, item_slots=(3,),
                                          dense_dim=3, hidden=(16,),
                                          temperature=1.0, seed=2,
                                          device=device),
                         kind="retrieval",
                         trainer_conf=TrainerConfig(auc_buckets=1 << 10)),
        ]
        mst = MultiScenarioTrainer(tconf, specs, device=device)
        table = SparseTable(tconf, seed=0, device=device)
        dss = {}
        for n in ("rank", "retr"):
            dss[n] = PadBoxSlotDataset(make_synth_config(4, 3, 32, 16),
                                       read_threads=1)
            dss[n].set_filelist(files)
            dss[n].load_into_memory()
        sk.reset_launches()
        m = mst.train_pass(dss, table)
        if device == "cuda":
            torch.cuda.synchronize()
            steps = sum(r["steps"] for r in m.values())
            assert sk.launches["pull_rows"] == sk.launches[
                "scatter_add_rows"] == steps > 0
        runs[device] = (m, table.state_dict())
        table.close()
        for d in dss.values():
            d.close()
    (mg, sg), (mc, sc) = runs["cuda"], runs["cpu"]
    for n in ("rank", "retr"):
        assert mg[n]["steps"] == mc[n]["steps"]
        assert mg[n]["loss"] == pytest.approx(mc[n]["loss"], rel=1e-4)
        assert abs(mg[n]["auc"] - mc[n]["auc"]) <= 1e-3
    np.testing.assert_array_equal(sg["keys"], sc["keys"])
    np.testing.assert_allclose(sg["values"], sc["values"], rtol=0, atol=1e-4)


def test_reshard_across_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card reshard live 4 -> 2 -> 4 between
    passes (tests/_torch_mp_child.py ``reshard``): under deterministic
    algorithms every pass's metrics, both ranks' dense state and the union
    of their stores equal one process running the same schedule on the
    card."""
    import json
    import os

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.launch import launch
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )

    schedule = (4, 2, 4)
    passes = [write_synth_files(str(tmp_path / f"p{p}"), n_files=2,
                                ins_per_file=64, n_sparse_slots=3,
                                vocab_per_slot=200, dense_dim=2, seed=40 + p)
              for p in range(3)]
    tconf = SparseTableConfig(embedding_dim=8, placement_update_interval=1)
    seed_model = CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(32, 16),
                        seed=4, device="cpu")
    state = {k: v.numpy() for k, v in seed_model.state_dict().items()}
    tower = {}
    for i in range(len(state) // 2):
        tower[f"w{i}"] = state[f"tower.{i}.weight"].T
        tower[f"b{i}"] = state[f"tower.{i}.bias"]
    np.savez(tmp_path / "tower.npz", **tower)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_mesh(4, device=cuda)
        table = ShardedSparseTable(tconf, mesh, seed=5)

        def trainer(m):
            model = CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(32, 16),
                           device=cuda)
            model.load_state_dict(seed_model.state_dict())
            return MultiChipTrainer(model, tconf, m,
                                    TrainerConfig(auc_buckets=1 << 10))

        tr, one, auc = trainer(mesh), [], None
        for files, n in zip(passes, schedule):
            if n != table.n_shards:
                mesh = make_mesh(n, device=cuda)
                table.reshard(mesh)
                dense = tr.dense_state()
                tr = trainer(mesh)
                tr.load_dense_state(*dense)
                auc = None
            ds = PadBoxSlotDataset(make_synth_config(3, 2, 8, 16),
                                   read_threads=1)
            ds.set_filelist(files)
            ds.load_into_memory()
            table.begin_pass(ds.unique_keys())
            m = tr.train_from_dataset(ds, table, auc_state=auc)
            auc = tr.last_metric_state
            table.end_pass()
            ds.close()
            one.append((m["loss"], m["auc"], m["count"], m["steps"]))
        want = table.state_dict()
        table.close()
    finally:
        torch.use_deterministic_algorithms(False)
    out = tmp_path / "out"
    out.mkdir()
    (tmp_path / "spec.json").write_text(json.dumps({
        "passes": passes, "schedule": list(schedule), "device": "cuda",
        "deterministic": True, "tower": str(tmp_path / "tower.npz")}))
    child = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_torch_mp_child.py")
    rc = launch([child, "reshard", str(out), str(tmp_path / "spec.json")],
                nproc=2, positions_per_proc=2, device="cuda",
                backend="gloo", log_dir=str(tmp_path / "logs"),
                job_timeout_s=600.0,
                env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    logs = tmp_path / "logs"
    assert rc == 0, "\n".join((logs / f).read_text()[-3000:]
                              for f in sorted(os.listdir(logs)))
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    for r in ranks:
        got = [(p["loss"], p["auc"], p["count"], p["steps"])
               for p in r["passes"]]
        assert got == one
    zs = [np.load(out / f"rank{r}.npz") for r in (0, 1)]
    keys = np.concatenate([z["keys"] for z in zs])
    vals = np.concatenate([z["values"] for z in zs])
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], want["keys"])
    np.testing.assert_array_equal(vals[order], want["values"])


EXAMPLES_ON_THE_CARD = {
    "train_criteo": ["train_criteo_torch.py", "--lines", "4096", "--passes",
                     "2"],
    "train_ctr_dnn": ["train_ctr_dnn_torch.py", "--days", "2", "--passes",
                      "2", "--ins-per-pass", "2048"],
    "train_ctr_dnn_multichip": ["train_ctr_dnn_torch.py", "--multichip",
                                "--days", "1", "--passes", "2",
                                "--ins-per-pass", "2048"],
    "train_longseq": ["train_longseq_torch.py", "--passes", "2",
                      "--seq-mesh", "4", "--impl", "ulysses"],
    "bench_store": ["bench_store_torch.py", "--max-exp", "6", "--table-pass"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES_ON_THE_CARD))
def test_example_runs_on_the_card(cuda, tmp_path, name):
    """The new examples as a user runs them, on the card (no ``--cpu``)
    at small flags: rc 0, finite losses and AUCs (bench_store: its
    table pass's seconds) and the card named as the device."""
    import math
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script, *args = EXAMPLES_ON_THE_CARD[name]
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", script), *args],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=repo))
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:] + proc.stderr[-3000:]
    if name == "bench_store":
        patterns = [r"on cuda: begin_pass\([\d,]+\)=([\d.]+)s "
                    r"end_pass=([\d.]+)s flush=([\d.]+)s"]
    else:
        assert re.search(r"device cuda|positions on cuda", out), out[-3000:]
        patterns = [r"\bloss=([^\s,;]+)", r"\bauc=([^\s,;]+)"]
    for pat in patterns:
        found = re.findall(pat, out)
        assert found, (pat, out[-3000:])
        for m in found:
            for text in (m if isinstance(m, tuple) else (m,)):
                assert math.isfinite(float(text)), (pat, text)


def test_a_capture_that_cannot_succeed_raises(cuda, tmp_path):
    """A model whose forward reads a value on the host cannot be captured:
    the trainer raises, and no group runs eagerly in its place."""
    from paddlebox_tpu_torch.models import CtrDnn

    class HostReading(CtrDnn):
        def forward(self, *args):
            logits = super().forward(*args)
            if float(logits.sum()) > 1e30:  # a host sync
                return logits * 2
            return logits

    ds, table, tr = _graph_world(tmp_path, 4, model_cls=HostReading)
    table.begin_pass(ds.unique_keys())
    with pytest.raises(RuntimeError):
        tr.train_from_dataset(ds, table)
    assert tr.graph_captures == 0 and tr.graph_replays == 0
    torch.cuda.synchronize()
    table.abort_pass()
    table.close()
    ds.close()
