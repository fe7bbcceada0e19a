"""Pass-scoped dataset with the BoxPS pass lifecycle (reference:
paddlebox_tpu/data/dataset.py).

    ds.set_filelist(files)
    ds.preload_into_memory()        # parse on background threads while the
                                    # previous pass trains
    ds.wait_preload_done()
    table.begin_pass(ds.unique_keys())
    for batch in ds.batches(): ...
    table.end_pass()
    ds.release_memory()

``load_into_memory`` is the same read on the caller's thread.
``preload_into_disk(dir)`` parses each file into a binary archive
(data/archive.py) and keeps only the key census in memory; ``batches()``
then streams the archives back.  A ``shuffler`` (data/shuffle.py) exchanges
the records among datasets while they load.  ``preprocess_instance``
groups instances into page-views by search_id, after which ``batches()``
emits PV-aligned batches with ``rank_offset``.

Every read is one ``retry_call`` at the site ``data.read``.  The readers
and the preload run on daemon threads (utils/workers.py) that ``close()``
retires and that exit when the dataset is collected.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from collections import deque
from typing import Iterator, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, flags
from paddlebox_tpu_torch.data.archive import read_archive, write_archive
from paddlebox_tpu_torch.data.feed import BatchBuilder, HostBatch
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.data.slot_parser import SlotParser
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.retry import retry_call
from paddlebox_tpu_torch.utils.workers import DaemonPool, SerialWorker

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _DiskSpill:
    """A pass spilled to local disk as binary archives (reference:
    PreLoadIntoDisk, data_set.cc:1577)."""

    paths: list
    unique_keys: np.ndarray
    n_ins: int


class PadBoxSlotDataset:
    def __init__(self, conf: DataFeedConfig, read_threads: Optional[int] = None):
        self.conf = conf
        self.parser = SlotParser(conf)
        self.builder = BatchBuilder(conf)
        self.read_threads = read_threads or flags.dataset_shuffle_thread_num
        self.filelist: list[str] = []
        self.date: Optional[str] = None
        self._block: Optional[RecordBlock] = None
        self._order: Optional[np.ndarray] = None
        self._spill: Optional[_DiskSpill] = None
        self._preload = None  # the Future of an in-flight preload
        self._pool = DaemonPool("dataset-read", self.read_threads)
        self._preload_worker = SerialWorker("dataset-preload")
        self._rng = np.random.default_rng(0)
        # PV grouping (preprocess_instance): PV p is
        # _pv_order[_pv_starts[p]:_pv_starts[p+1]], visited in _pv_perm order
        self._pv_order: Optional[np.ndarray] = None
        self._pv_starts: Optional[np.ndarray] = None
        self._pv_perm: Optional[np.ndarray] = None
        self.shuffler = None  # optional (data/shuffle.py)
        self.spill_peak_inflight = 0

    def set_filelist(self, files: Sequence[str]) -> None:
        self.filelist = list(files)

    def set_date(self, date: str) -> None:
        """The pass date (README's Quick start sets it); recorded, read
        nowhere yet."""
        self.date = date

    # -- load --------------------------------------------------------------- #
    def _parse_with_retry(self, path: str) -> RecordBlock:
        """One file read through utils/retry.py: transient failures (OSError,
        a failed pipe_command, an injected fault) retry; a parse error
        (ValueError) never does."""
        return retry_call(self.parser.parse_file, path, site="data.read")

    def _check_quarantine(self, q0: int, p0: int) -> None:
        """Abort the load when more than quarantine_abort_frac of its lines
        were quarantined."""
        q = self.parser.quarantined_lines - q0
        total = q + (self.parser.parsed_lines - p0)
        limit = self.conf.quarantine_abort_frac
        if q and total and q / total > limit:
            stats.add("data.quarantine_aborts")
            raise RuntimeError(
                f"pass aborted: {q}/{total} input lines ({q / total:.2%}) "
                f"quarantined, over quarantine_abort_frac={limit:.2%}"
            )

    def _parse_all(self) -> RecordBlock:
        """Every file of the list parsed on the reader threads, in list
        order, and merged."""
        if not self.filelist:
            raise RuntimeError("set_filelist before loading")
        q0, p0 = self.parser.quarantined_lines, self.parser.parsed_lines
        futs = [self._pool.submit(self._parse_with_retry, f)
                for f in self.filelist]
        blocks = [f.result() for f in futs]
        self._check_quarantine(q0, p0)
        return RecordBlock.concat(blocks)

    def _read_all(self) -> RecordBlock:
        block = self._parse_all()
        if self.shuffler is not None:
            block = self.shuffler.exchange(block)
        return block

    def _set_block(self, block: RecordBlock) -> None:
        self._block = block
        self._order = np.arange(block.n_ins)
        self._spill = None

    def load_into_memory(self) -> None:
        self._set_block(self._read_all())

    def preload_into_memory(self) -> None:
        """Read on a background thread, overlapping the current pass's
        training (reference: BoxHelper::PreLoadIntoMemory); then
        wait_preload_done."""
        if self._preload is not None:
            raise RuntimeError("preload already in flight")
        self._preload = self._preload_worker.submit(self._read_all)

    # -- disk spill --------------------------------------------------------- #
    def _read_to_disk(self, spill_dir: str) -> _DiskSpill:
        """Parse and archive each input file to ``spill_dir`` as it
        arrives: at most ``read_threads`` parsed blocks are in flight, and
        only the key census stays in memory, so a pass larger than host
        RAM loads (reference: PreLoadIntoDisk).  With a shuffler attached
        the exchange needs the whole block, so the pass parses in memory
        and spills in one chunk per input file."""
        os.makedirs(spill_dir, exist_ok=True)
        if not self.filelist:
            raise RuntimeError("set_filelist before loading")
        paths: list[str] = []

        def spill(block: RecordBlock) -> None:
            out = os.path.join(spill_dir, f"spill-{len(paths):05d}.bin")
            write_archive(out, [block])
            paths.append(out)

        if self.shuffler is not None:
            block = self._read_all()
            chunk = max(-(-block.n_ins // max(len(self.filelist), 1)), 1)
            for lo in range(0, block.n_ins, chunk):
                spill(block.select(np.arange(lo, min(lo + chunk, block.n_ins))))
            return _DiskSpill(paths, np.unique(block.keys), block.n_ins)

        q0, p0 = self.parser.quarantined_lines, self.parser.parsed_lines
        high_water = max(int(self.read_threads), 1)
        inflight: deque = deque()
        key_chunks: list[np.ndarray] = []
        n_ins = 0
        self.spill_peak_inflight = 0

        def drain_one() -> None:
            nonlocal n_ins
            block = inflight.popleft().result()
            spill(block)
            key_chunks.append(np.unique(block.keys))
            n_ins += block.n_ins

        for f in self.filelist:
            inflight.append(self._pool.submit(self._parse_with_retry, f))
            self.spill_peak_inflight = max(self.spill_peak_inflight,
                                           len(inflight))
            if len(inflight) >= high_water:
                drain_one()
        while inflight:
            drain_one()
        self._check_quarantine(q0, p0)
        uniq = (np.unique(np.concatenate(key_chunks)) if key_chunks
                else np.empty(0, dtype=np.uint64))
        return _DiskSpill(paths, uniq, n_ins)

    def preload_into_disk(self, spill_dir: str) -> None:
        """Parse to disk on a background thread (PreLoadIntoDisk): the pass
        waits as archives, and training streams them batch by batch."""
        if self._preload is not None:
            raise RuntimeError("preload already in flight")
        self._preload = self._preload_worker.submit(self._read_to_disk,
                                                    spill_dir)

    def wait_preload_done(self) -> None:
        if self._preload is None:
            raise RuntimeError("no preload in flight")
        fut, self._preload = self._preload, None
        result = fut.result()
        if isinstance(result, _DiskSpill):
            self._spill = result
            self._block = None
            self._order = None
        else:
            self._set_block(result)

    def release_memory(self) -> None:
        """Drop the pass's records, and remove its spill files."""
        self._block = None
        self._order = None
        self.postprocess_instance()
        if self._spill is not None:
            logged = False
            for p in self._spill.paths:
                try:
                    os.remove(p)
                except OSError as e:
                    # a leaked spill file eats local disk across day-scale
                    # runs: count every failure, log the first
                    stats.add("dataset.spill_rm_failed")
                    if not logged:
                        logged = True
                        logger.warning(
                            "failed to remove spill file %s: %s (further "
                            "failures counted to dataset.spill_rm_failed "
                            "only)", p, e,
                        )
            self._spill = None

    def close(self) -> None:
        """Retire the reader and preload threads (a later load starts new
        ones)."""
        self._preload_worker.close()
        self._pool.close()

    def __enter__(self) -> "PadBoxSlotDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- shuffle ------------------------------------------------------------ #
    def local_shuffle(self, seed: Optional[int] = None) -> None:
        """Permute the instances, or in PV mode the page-views (the ads of
        a PV stay together)."""
        if self._block is None:
            raise RuntimeError("load before shuffle")
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        if self.pv_mode:
            self._pv_perm = rng.permutation(self._pv_perm.shape[0])
            return
        self._order = rng.permutation(self._block.n_ins)

    def global_shuffle(self, seed: Optional[int] = None) -> None:
        """The local shuffle: with a shuffler attached the records were
        already routed among the workers while they loaded (reference:
        ShuffleData, data_set.cc:1934-1942)."""
        self.local_shuffle(seed)

    def slots_shuffle(self, slot_names: Sequence[str], seed: int = 0) -> None:
        """Permute the given sparse slots' values across instances, every
        other column fixed (the AUC runner's feature-importance mode;
        reference: SlotsShuffle, box_wrapper.h:1077)."""
        if self._block is None:
            raise RuntimeError("load before slots_shuffle")
        names = [s.name for s in self.conf.sparse_slots()]
        idxs = [names.index(n) for n in slot_names]
        self._block = _shuffle_slots(self._block, idxs,
                                     np.random.default_rng(seed))

    # -- PV merge ----------------------------------------------------------- #
    def preprocess_instance(self) -> None:
        """Group the instances into page-views by search_id (reference:
        BoxPSDataset.preprocess_instance, data_feed.h:756-774; needs
        parse_logkey).  ``batches()`` then emits PV-aligned batches that
        carry ``rank_offset``."""
        if self._block is None:
            raise RuntimeError("load before preprocess_instance")
        if not self.conf.enable_pv_merge:
            raise RuntimeError("enable_pv_merge is off in the config")
        if self._block.search_ids is None:
            raise RuntimeError("PV merge needs parse_logkey (search_ids)")
        sid = self._block.search_ids
        order = np.argsort(sid, kind="stable")
        bounds = np.nonzero(np.diff(sid[order]) != 0)[0] + 1
        self._pv_order = order
        self._pv_starts = np.concatenate(
            [[0], bounds, [order.shape[0]]]).astype(np.int64)
        self._pv_perm = np.arange(self._pv_starts.shape[0] - 1)

    def postprocess_instance(self) -> None:
        """Back to instance mode (reference: postprocess_instance)."""
        self._pv_order = self._pv_starts = self._pv_perm = None

    def pv_state(self) -> tuple:
        """The PV grouping and its shuffle order, for restore_pv_state: a
        caller can drop to instance mode and come back without regrouping
        (which would reset the PV permutation)."""
        return (self._pv_order, self._pv_starts, self._pv_perm)

    def restore_pv_state(self, state: tuple) -> None:
        self._pv_order, self._pv_starts, self._pv_perm = state

    @property
    def pv_mode(self) -> bool:
        return self._pv_order is not None

    def get_pv_data_size(self) -> int:
        return self._pv_starts.shape[0] - 1 if self.pv_mode else 0

    def _pv_batches(self, drop_last: bool) -> Iterator[HostBatch]:
        """Whole PVs packed into batches of at most pv_batch_size PVs and
        batch_size instances (static shapes)."""
        B = self.conf.batch_size
        max_pvs = self.conf.pv_batch_size
        ids: list = []
        bounds = [0]
        count = 0
        for p in self._pv_perm:
            pv = self._pv_order[self._pv_starts[p]:self._pv_starts[p + 1]]
            if pv.shape[0] > B:
                raise ValueError(
                    f"PV of {pv.shape[0]} ads exceeds batch_size {B}"
                )
            if ids and (count + pv.shape[0] > B or len(ids) >= max_pvs):
                yield self.builder.build_pv(
                    self._block, np.concatenate(ids),
                    np.asarray(bounds, dtype=np.int64))
                ids, bounds, count = [], [0], 0
            ids.append(pv)
            count += pv.shape[0]
            bounds.append(count)
        if ids and not (drop_last and count < B):
            yield self.builder.build_pv(self._block, np.concatenate(ids),
                                        np.asarray(bounds, dtype=np.int64))

    # -- the pass's batches ------------------------------------------------- #
    def get_memory_data_size(self) -> int:
        if self._spill is not None:
            return self._spill.n_ins
        return 0 if self._block is None else self._block.n_ins

    def unique_keys(self) -> np.ndarray:
        if self._spill is not None:
            return self._spill.unique_keys
        if self._block is None:
            raise RuntimeError("load before key census")
        return self._block.unique_keys()

    def _disk_batches(self, drop_last: bool) -> Iterator[HostBatch]:
        """Batches streamed from the spill archives, a partial batch's
        remainder carried across archive boundaries."""
        B = self.conf.batch_size
        pending: Optional[RecordBlock] = None
        for path in self._spill.paths:
            for block in read_archive(path):
                pending = (block if pending is None
                           else RecordBlock.concat([pending, block]))
                n_full = pending.n_ins // B
                for i in range(n_full):
                    yield self.builder.build(pending,
                                             np.arange(i * B, (i + 1) * B))
                pending = (pending.select(np.arange(n_full * B, pending.n_ins))
                           if pending.n_ins > n_full * B else None)
        if pending is not None and not drop_last:
            yield self.builder.build(pending, np.arange(pending.n_ins))

    def batches(self, drop_last: bool = False) -> Iterator[HostBatch]:
        if self._spill is not None:
            if self.pv_mode:
                raise RuntimeError(
                    "PV merge needs in-memory data (use preload_into_memory)"
                )
            yield from self._disk_batches(drop_last)
            return
        if self._block is None:
            raise RuntimeError("load before iterating")
        if self.pv_mode:
            yield from self._pv_batches(drop_last)
            return
        B = self.conf.batch_size
        for lo in range(0, self._block.n_ins, B):
            ids = self._order[lo : lo + B]
            if drop_last and ids.shape[0] < B:
                return
            yield self.builder.build(self._block, ids)


def _shuffle_slots(block: RecordBlock, slot_idxs, rng) -> RecordBlock:
    """The chosen slots' (values, length) pairs permuted across instances,
    one permutation per slot in ``slot_idxs`` order, by one vectorized CSR
    gather."""
    s = block.n_sparse_slots
    n = block.n_ins
    lens = np.diff(block.key_offsets).reshape(n, s)
    # each (instance, slot) row reads its own keys, a shuffled slot the
    # permuted instance's
    src_starts = block.key_offsets[:-1].reshape(n, s).copy()
    new_lens = lens.copy()
    for si in slot_idxs:
        perm = rng.permutation(n)
        src_starts[:, si] = src_starts[perm, si]
        new_lens[:, si] = lens[perm, si]
    lens_flat = new_lens.reshape(-1)
    new_offsets = np.zeros(n * s + 1, dtype=np.int64)
    np.cumsum(lens_flat, out=new_offsets[1:])
    within = (np.arange(int(new_offsets[-1]), dtype=np.int64)
              - np.repeat(new_offsets[:-1], lens_flat))
    keys = block.keys[np.repeat(src_starts.reshape(-1), lens_flat) + within]
    return dataclasses.replace(block, keys=keys, key_offsets=new_offsets)


class DatasetFactory:
    _KINDS = {"PadBoxSlotDataset": PadBoxSlotDataset, "BoxPSDataset": PadBoxSlotDataset}

    def create_dataset(self, kind: str, conf: DataFeedConfig, **kw) -> PadBoxSlotDataset:
        if kind not in self._KINDS:
            raise ValueError(f"unknown dataset kind {kind!r}")
        return self._KINDS[kind](conf, **kw)
