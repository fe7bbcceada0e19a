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


@pytest.mark.parametrize("u", [0, 7, 40000])
def test_scatter_add_rows_kernel_unique_and_dead_repeats_bit_exact(cuda, u):
    gen = torch.Generator(device=cuda).manual_seed(u)
    P = 65536
    values = torch.randn((P, 11), device=cuda, generator=gen)
    idx = torch.randperm(P - 1, device=cuda, generator=gen)[:u].to(torch.int32)
    delta = torch.randn((u, 11), device=cuda, generator=gen)
    idx[: u // 4] = P - 1  # dead-row repeats carry zero deltas
    delta[: u // 4] = 0.0
    got = sk.scatter_add_rows(values.clone(), idx, delta)
    want = sk.scatter_add_rows_plain(values.clone(), idx, delta)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_scatter_add_rows_kernel_real_duplicates(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    values = torch.randn((1000, 11), device=cuda, generator=gen)
    idx = torch.randint(0, 250, (1000,), device=cuda, generator=gen,
                        dtype=torch.int32)
    delta = torch.randn((1000, 11), device=cuda, generator=gen)
    got = sk.scatter_add_rows(values.clone(), idx, delta)
    want = sk.scatter_add_rows_plain(values.clone(), idx, delta)
    # atomics land in run-to-run order: ~4 hits per row of unit-size terms
    # differ from a sequential sum by < 2 * 16 * 2^-24 * 20 ~ 4e-5
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


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
                                    "hot_cold_select"])
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
    }[kernel]
    code = (
        "import torch\n"
        "from paddlebox_tpu_torch.ops import sparse_kernels as sk\n"
        "v = torch.zeros((8, 3), device='cuda')\n"
        "i = torch.tensor([8], dtype=torch.int32, device='cuda')\n"
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
