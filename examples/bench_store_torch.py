"""Host-store scale benchmark with the PyTorch port (the counterpart of
examples/bench_store.py): pass-boundary merge cost against store size.

Times the port's bucketed store (sparse/store.py) against the monolithic
merge (concat + argsort of the whole store) from 1e6 up to 10^max-exp
features, plus, with ``--table-pass``, a full ``SparseTable`` begin_pass /
end_pass at the largest size on the card (``--cpu`` for the CPU).  The
table's store is host memory; only the pass's rows go to the device.

    python examples/bench_store_torch.py [--max-exp 8] [--table-pass] [--cpu]
"""

import argparse
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def legacy_merge(store_keys, store_vals, keys, vals):
    """The monolithic merge: in place for found keys, concat +
    argsort-the-world for new ones."""
    pos = np.searchsorted(store_keys, keys)
    pos_c = np.minimum(pos, store_keys.shape[0] - 1)
    found = store_keys[pos_c] == keys
    store_vals[pos_c[found]] = vals[found]
    if (~found).any():
        all_keys = np.concatenate([store_keys, keys[~found]])
        all_vals = np.concatenate([store_vals, vals[~found]])
        order = np.argsort(all_keys, kind="stable")
        return all_keys[order], all_vals[order]
    return store_keys, store_vals


def make_pass(rng, store_keys, n_exist, n_new):
    """A pass working set: n_exist existing keys + n_new unseen keys."""
    idx = rng.integers(0, store_keys.shape[0], size=n_exist)
    exist = store_keys[idx]
    new = rng.integers(2**63, 2**64 - 1, dtype=np.uint64, size=n_new)
    return np.unique(np.concatenate([exist, new]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-exp", type=int, default=8,
                    help="largest store size as 10^exp (default 1e8)")
    ap.add_argument("--pass-keys", type=int, default=2_000_000)
    ap.add_argument("--new-frac", type=float, default=0.05)
    ap.add_argument("--skip-legacy-at", type=int, default=9,
                    help="skip legacy merge timing at/above 10^exp")
    ap.add_argument("--table-pass", action="store_true",
                    help="also run a full SparseTable pass at the largest size")
    ap.add_argument("--cpu", action="store_true",
                    help="run the table pass on the CPU instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    from paddlebox_tpu_torch.sparse.store import BucketStore

    C = 11  # [show, clk, emb8] + g2sum
    rng = np.random.default_rng(0)
    print(f"pass size: {args.pass_keys:,} keys, {args.new_frac:.0%} new; "
          f"row width {C} f32", flush=True)
    print(f"{'store size':>12} | {'bucketed merge':>14} | {'legacy merge':>13} "
          f"| {'lookup':>8} | {'RSS GB':>6}", flush=True)

    biggest_store = None
    for exp in range(6, args.max_exp + 1):
        n = 10 ** exp
        # build the store in one bulk load (construction isn't what we bench)
        keys = np.unique(
            rng.integers(0, 2**63, size=int(n * 1.05), dtype=np.uint64)
        )[:n]
        vals = np.zeros((keys.shape[0], C), dtype=np.float32)
        vals[:, 0] = 1.0
        st = BucketStore(C, n_buckets=256)
        st.load_bulk(keys, vals)

        n_new = int(args.pass_keys * args.new_frac)
        pk = make_pass(rng, keys, args.pass_keys - n_new, n_new)
        pv = np.ones((pk.shape[0], C), dtype=np.float32)

        t0 = time.perf_counter()
        st.update(pk, pv)
        t_bucket = time.perf_counter() - t0

        t0 = time.perf_counter()
        _ = st.lookup(pk)
        t_lookup = time.perf_counter() - t0

        if exp < args.skip_legacy_at:
            lk, lv = keys.copy(), vals.copy()
            t0 = time.perf_counter()
            lk, lv = legacy_merge(lk, lv, pk, pv)
            t_legacy = f"{time.perf_counter() - t0:>11.2f}s"
            del lk, lv
        else:
            t_legacy = "     skipped"

        print(f"{n:>12,} | {t_bucket:>13.2f}s | {t_legacy} "
              f"| {t_lookup:>7.2f}s | {rss_gb():>6.1f}", flush=True)
        if exp == args.max_exp:
            biggest_store = (st, keys)
        else:
            st.close()
            del st, keys, vals

    if args.table_pass and biggest_store is not None:
        import torch

        from paddlebox_tpu_torch.config import SparseTableConfig
        from paddlebox_tpu_torch.sparse.table import SparseTable

        def sync():
            if device == "cuda":
                torch.cuda.synchronize()

        st, keys = biggest_store
        tconf = SparseTableConfig(embedding_dim=8)
        table = SparseTable(tconf, seed=0, device=device)
        table._store.close()
        table._store = st  # adopt the pre-built store
        pk = make_pass(rng, keys, args.pass_keys, int(args.pass_keys * 0.05))
        t0 = time.perf_counter()
        table.begin_pass(pk)
        sync()
        t_begin = time.perf_counter() - t0
        t0 = time.perf_counter()
        table.end_pass()
        sync()
        t_end = time.perf_counter() - t0
        # the overlapped boundary merges into the store after end_pass
        # returns; flush waits for it
        t0 = time.perf_counter()
        table.flush()
        t_flush = time.perf_counter() - t0
        print(f"SparseTable @ {st.n:,} features on {device}: "
              f"begin_pass({pk.shape[0]:,})={t_begin:.2f}s "
              f"end_pass={t_end:.2f}s flush={t_flush:.2f}s "
              f"RSS={rss_gb():.1f}GB", flush=True)
        table.close()


if __name__ == "__main__":
    main()
