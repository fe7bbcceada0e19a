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
