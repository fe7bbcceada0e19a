"""Serving-side predictor: loads an export_model artifact and scores batches
(reference: paddlebox_tpu/inference/predictor.py).

The table snapshot lives on the serving device, where the program runs:

  * the sorted keys as int64 bit patterns of the uint64 keys (sorted
    unsigned), padded to a power of two with all-ones sentinels, beside the
    real count ``n_real`` (a real all-ones key sorts last among the real
    keys, and ``n_real`` tells it from the padding);
  * the rows as f32 ``[N, W]``, or, for a quantized artifact, the f32 head
    ``[N, co+1]``, the scales ``[N, 1]`` and the embedx codes, each row's
    bytes padded to a multiple of 4 and viewed as float32 ``[N, ceil(E/4)]``.

The key resolve is two of the sparse kernels (ops/sparse_kernels.py):
``sorted_search(hay, n_real, keys)`` gives each key's position or -1, and
``gather_slots`` reads the rows at those positions, the zero row for -1:
the reference's host ``searchsorted`` plus its ``found`` mask.  A quantized
artifact gathers its head, scales and codes with the same kernel (a missing
key reads zero bytes, which decode to 0 in int8 and in fp8).  Then, as in
the reference, ``pull_embedx_scale`` and the ``create_threshold`` mask
apply (for fp32 rows; the quantized program folds both into its dequant)
and the program for the cheapest fitting shape bucket runs.

Shape flexibility: a batch whose real instance and key counts fit some
exported bucket is padded to that bucket's shapes (padding rows zero,
padding segment ids ``B * S``, which the pooling drops), so the bucket
never changes the scores.

The host keeps a copy of the snapshot for ``with_delta``, which merges a
delta on the host as the reference does and uploads the result as a new
Predictor; a request pins one Predictor, so it never mixes snapshots.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.data.feed import HostBatch
from paddlebox_tpu_torch.inference import quant
from paddlebox_tpu_torch.inference.export import PROGRAM_FORMAT
from paddlebox_tpu_torch.ops import sparse_kernels as sk
from paddlebox_tpu_torch.telemetry.compiles import stage_scope
from paddlebox_tpu_torch.utils.device import resolve_device


class EmbeddingDtypeMismatch(ValueError):
    """A delta's embedding dtype does not match the live artifact's: a merge
    would corrupt the table.  Structured so a syncer's fallback ladder
    catches it and full-reloads instead of applying."""


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def load_program(path: str, device: torch.device):
    """A saved serving program, moved to ``device``, as a callable."""
    from torch.export.passes import move_to_device_pass

    ep = torch.export.load(path)
    return move_to_device_pass(ep, str(device)).module()


def _check_artifact(artifact_dir: str, meta: dict) -> None:
    stablehlo = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(artifact_dir, "*.stablehlo")))
    if meta.get("program_format") != PROGRAM_FORMAT:
        raise ValueError(
            f"{artifact_dir} is not a torch.export artifact (program_format "
            f"{meta.get('program_format')!r}; programs "
            f"{stablehlo or 'none'}): a JAX artifact's serving.stablehlo "
            "cannot be loaded here; re-export it with "
            "paddlebox_tpu_torch.inference.export_model"
        )


class Predictor:
    def __init__(self, meta: dict, keys: np.ndarray,
                 values: Optional[np.ndarray], artifact_dir: str,
                 bucket_files: list, *, head: Optional[np.ndarray] = None,
                 embedx_q: Optional[np.ndarray] = None,
                 scales: Optional[np.ndarray] = None,
                 device="cuda", programs: Optional[dict] = None) -> None:
        """bucket_files: [(batch_size, key_capacity, filename), ...].
        Programs load lazily on first use.  Exactly one storage form is
        given: ``values`` ([n, W] f32) or the quantized triple ``head``
        ([n, co+1] f32), ``embedx_q`` ([n, E] int8, or fp8 as uint8) and
        ``scales`` ([n] f32).  ``keys`` are sorted uint64."""
        self.meta = meta
        self.device = resolve_device(device)
        self._keys = keys
        self._values = values
        self._head = head
        self._q = embedx_q
        self._scales = scales
        self._dir = artifact_dir
        self._buckets = bucket_files
        # filename -> loaded program; with_delta shares it when the
        # programs stay the same
        self._programs: dict = {} if programs is None else programs
        self._upload()

    # -- the device snapshot ------------------------------------------------ #
    def _upload(self) -> None:
        """Build the device snapshot, complete on the device when this
        returns: a predictor built on one thread (a syncer's agent) is
        installed for the request threads right after, and is never seen
        half-uploaded.  ``upload_seconds`` records the time it took."""
        t0 = time.perf_counter()
        dev = self.device
        n = int(self._keys.shape[0])
        c = _next_pow2(max(n, 1))
        hay = np.full(c, -1, np.int64)  # all-ones sentinels
        hay[:n] = np.ascontiguousarray(self._keys, np.uint64).view(np.int64)
        self._hay = torch.from_numpy(hay).to(dev)
        self._n_real = n

        def rows(a: np.ndarray, width: int) -> torch.Tensor:
            # an empty snapshot keeps one zero row, so the kernels always
            # have a table to read (every key misses)
            a = np.ascontiguousarray(a, np.float32).reshape(-1, width)
            if not a.shape[0]:
                a = np.zeros((1, width), np.float32)
            return torch.from_numpy(a).to(dev)

        if self._quantized:
            e = self._q.shape[1]
            self._e4 = -(-e // 4)
            codes = np.zeros((max(n, 1), 4 * self._e4), np.uint8)
            codes[:n, :e] = np.ascontiguousarray(self._q).view(np.uint8)
            self._dev = (rows(self._head, self._head.shape[1]),
                         rows(codes.view(np.float32), self._e4),
                         rows(self._scales, 1))
        else:
            self._dev = (rows(self._values, int(self.meta["row_width"])),)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        self.upload_seconds = time.perf_counter() - t0

    @property
    def n_features(self) -> int:
        """Features in the loaded sparse snapshot."""
        return int(self._keys.shape[0])

    @property
    def bucket_shapes(self) -> list:
        """[(batch_size, key_capacity), ...] of the exported ladder."""
        return [(b, k) for b, k, _ in self._buckets]

    @property
    def embedding_dtype(self) -> str:
        """The dtype serving the embedding payload ("fp32" for legacy
        global-scale artifacts too: those dequantize at load)."""
        return self.meta.get("embedding_dtype", "fp32")

    @property
    def _quantized(self) -> bool:
        return self._values is None

    @property
    def artifact_bytes(self) -> int:
        """In-memory sparse payload bytes (the host copy's, as the
        reference counts them)."""
        n = int(self._keys.nbytes)
        if self._quantized:
            n += int(self._head.nbytes + self._q.nbytes
                     + self._scales.nbytes)
        else:
            n += int(self._values.nbytes)
        return n

    def _program(self, fname: str):
        prog = self._programs.get(fname)
        if prog is None:
            prog = load_program(os.path.join(self._dir, fname), self.device)
            self._programs[fname] = prog
        return prog

    @classmethod
    def load(cls, artifact_dir: str, device="cuda") -> "Predictor":
        with open(os.path.join(artifact_dir, "meta.json")) as f:
            meta = json.load(f)
        _check_artifact(artifact_dir, meta)
        sp = os.path.join(artifact_dir, "sparse")
        key_files = sorted(glob.glob(os.path.join(sp, "keys-*.npy")))
        keys = np.concatenate([np.load(p) for p in key_files])
        edtype = meta.get("embedding_dtype", "fp32")
        order = np.argsort(keys)  # per-process shards -> one sorted table
        keys = keys[order]
        head = embedx_q = scales = values = None
        if edtype != "fp32":
            heads, qs, scs = [], [], []
            for kf in key_files:
                pid = kf[-9:-4]
                heads.append(np.load(os.path.join(sp, f"head-{pid}.npy")))
                qs.append(quant.load_q(
                    np.load(os.path.join(sp, f"embedx_q-{pid}.npy")), edtype))
                scs.append(np.load(os.path.join(sp, f"scales-{pid}.npy")))
            head = np.concatenate(heads)[order]
            embedx_q = np.concatenate(qs)[order]
            scales = np.concatenate(scs)[order]
        elif meta.get("quantized"):
            # legacy per-shard global scale, dequantized to f32 rows here
            shards = []
            for kf in key_files:
                pid = kf[-9:-4]
                h = np.load(os.path.join(sp, f"head-{pid}.npy"))
                q = np.load(os.path.join(sp, f"embedx_q-{pid}.npy"))
                scale = float(np.load(os.path.join(sp, f"scale-{pid}.npy")))
                shards.append(
                    np.concatenate([h, q.astype(np.float32) * scale], axis=1))
            values = (np.concatenate(shards) if shards else np.empty(
                (0, meta["row_width"]), np.float32))[order]
        else:
            val_files = sorted(glob.glob(os.path.join(sp, "values-*.npy")))
            values = np.concatenate([np.load(p) for p in val_files])[order]
        bucket_files = [
            (int(bm["batch_size"]), int(bm["key_capacity"]), bm["file"])
            for bm in meta["buckets"]
        ]
        return cls(meta, keys, values, artifact_dir, bucket_files,
                   head=head, embedx_q=embedx_q, scales=scales,
                   device=device)

    # -- delta hot-apply (build-aside) -------------------------------------- #
    def with_delta(self, keys: np.ndarray, values: np.ndarray = None,
                   program_dir: str = None,
                   bucket_meta: list = None, *,
                   head: np.ndarray = None, embedx_q: np.ndarray = None,
                   scales: np.ndarray = None,
                   embedding_dtype: str = "fp32") -> "Predictor":
        """A NEW Predictor with the delta rows merged in; ``self`` is never
        mutated, so in-flight predict() calls keep their snapshot and the
        caller swaps the result in atomically.

        keys: uint64 delta keys (any order; the last occurrence of a
        duplicate wins).  An fp32 artifact takes ``values`` ([n,
        row_width] f32), a quantized one the triple ``head`` +
        ``embedx_q`` + ``scales`` with the matching ``embedding_dtype``.
        Existing keys are replaced, new keys inserted in sort order.  A
        dtype that does not match the live artifact's raises
        :class:`EmbeddingDtypeMismatch`.

        program_dir/bucket_meta: re-frozen serving programs shipped with
        the delta; otherwise the loaded programs are shared."""
        quant.validate_dtype(embedding_dtype)
        if embedding_dtype != self.embedding_dtype:
            raise EmbeddingDtypeMismatch(
                f"delta rows are {embedding_dtype} but the live artifact "
                f"serves {self.embedding_dtype}: chains cannot mix "
                "embedding dtypes — republish a base"
            )
        dk = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        if self._quantized:
            dvs = self._check_quant_delta(dk, head, embedx_q, scales)
        else:
            dvs = (self._check_fp32_delta(dk, values),)
        order = np.argsort(dk, kind="stable")
        dk = dk[order]
        dvs = [d[order] for d in dvs]
        if dk.shape[0] and np.any(dk[1:] == dk[:-1]):
            # keep the LAST row per duplicate key (newest write wins)
            last = np.ones(dk.shape[0], bool)
            last[:-1] = dk[1:] != dk[:-1]
            dk = dk[last]
            dvs = [d[last] for d in dvs]
        n = self._keys.shape[0]
        if n and dk.shape[0]:
            pos = np.searchsorted(self._keys, dk)
            pos_c = np.minimum(pos, n - 1)
            found = self._keys[pos_c] == dk
        else:
            pos = np.zeros(dk.shape[0], np.int64)
            found = np.zeros(dk.shape[0], bool)
        olds = ((self._head, self._q, self._scales) if self._quantized
                else (self._values,))
        news = []
        for old, dv in zip(olds, dvs):
            new = old.copy()
            if found.any():
                new[pos[found]] = dv[found]
            if (~found).any():
                new = np.insert(new, pos[~found], dv[~found], axis=0)
            news.append(new)
        if (~found).any():
            new_keys = np.insert(self._keys, pos[~found], dk[~found])
        else:
            new_keys = self._keys
        kw = (dict(head=news[0], embedx_q=news[1], scales=news[2])
              if self._quantized else {})
        new_values = None if self._quantized else news[0]
        if program_dir is not None:
            bm = bucket_meta or self.meta.get("buckets") or []
            buckets = [
                (int(b["batch_size"]), int(b["key_capacity"]), b["file"])
                for b in bm
            ] or list(self._buckets)
            return Predictor(self.meta, new_keys, new_values, program_dir,
                             buckets, device=self.device, **kw)
        return Predictor(self.meta, new_keys, new_values, self._dir,
                         list(self._buckets), device=self.device,
                         programs=self._programs, **kw)

    def _check_fp32_delta(self, dk: np.ndarray,
                          values: np.ndarray) -> np.ndarray:
        if values is None:
            raise ValueError("fp32 artifact: with_delta needs `values`")
        dv = np.asarray(values, dtype=np.float32)
        w = int(self.meta["row_width"])
        if dv.ndim != 2 or dv.shape[1] < w:
            raise ValueError(
                f"delta values are {dv.shape}, artifact row_width is {w}"
            )
        dv = dv[:, :w]
        if dk.shape[0] != dv.shape[0]:
            raise ValueError(
                f"delta keys/values disagree: {dk.shape[0]} vs {dv.shape[0]}"
            )
        return dv

    def _check_quant_delta(self, dk: np.ndarray, head, embedx_q, scales):
        if head is None or embedx_q is None or scales is None:
            raise ValueError(
                "quantized artifact: with_delta needs head + embedx_q + "
                "scales"
            )
        co = int(self.meta["cvm_offset"])
        e = int(self.meta["row_width"]) - co - 1
        dh = np.asarray(head, dtype=np.float32)
        dq = np.asarray(embedx_q)
        ds = np.asarray(scales, dtype=np.float32)
        if dh.shape != (dk.shape[0], co + 1) \
                or dq.shape != (dk.shape[0], e) \
                or ds.shape != (dk.shape[0],):
            raise ValueError(
                f"quantized delta shapes disagree with the artifact: head "
                f"{dh.shape} q {dq.shape} scales {ds.shape} for "
                f"{dk.shape[0]} keys (co={co}, embedx={e})"
            )
        if dq.dtype != self._q.dtype:
            raise EmbeddingDtypeMismatch(
                f"delta embedx dtype {dq.dtype} != artifact {self._q.dtype}"
            )
        return dh, dq, ds

    # -- feature resolve (device) ------------------------------------------ #
    def upload_keys(self, batch_keys: np.ndarray, n_keys: int) -> torch.Tensor:
        """The batch's real keys as int64 bit patterns on the device."""
        bk = np.ascontiguousarray(batch_keys[:n_keys], np.uint64)
        return torch.from_numpy(bk.view(np.int64)).to(self.device)

    def resolve(self, q: torch.Tensor, key_capacity: int) -> list:
        """The program's row inputs for the device keys ``q``, padded to
        ``key_capacity``: ``[rows]``, or ``[head, codes, scales]`` for a
        quantized artifact, with zeros where a key is missing."""
        n = q.shape[0]
        slots = torch.full((key_capacity,), -1, dtype=torch.int32,
                           device=self.device)
        if n:
            slots[:n] = sk.sorted_search(self._hay, self._n_real, q)
        m = self.meta
        co = int(m["cvm_offset"])
        if self._quantized:
            head_t, codes_t, scales_t = self._dev
            e = self._q.shape[1]
            codes = sk.gather_slots(codes_t, slots).view(
                torch.uint8)[:, :e]
            if self._q.dtype == np.int8:
                codes = codes.view(torch.int8)
            return [sk.gather_slots(head_t, slots), codes,
                    sk.gather_slots(scales_t, slots)[:, 0]]
        rows = sk.gather_slots(self._dev[0], slots)
        if m["pull_embedx_scale"] != 1.0:
            rows[:, co + 1:] *= m["pull_embedx_scale"]
        if m["create_threshold"] > 0.0:
            visible = (rows[:, 0] >= m["create_threshold"]).to(rows.dtype)
            rows[:, co:] *= visible[:, None]
        return [rows]

    def _pick_bucket(self, b: int, nk: int):
        """Cheapest fitting bucket by padded work (B * K), not first-fit."""
        fits = [(B * K, B, K, f) for B, K, f in self._buckets
                if b <= B and nk <= K]
        if fits:
            _, B, K, fname = min(fits)
            return B, K, self._program(fname)
        raise ValueError(
            f"no exported shape bucket fits a batch with {b} instances / "
            f"{nk} keys: artifact buckets (batch_size, key_capacity) = "
            f"{self.bucket_shapes} — re-export with batch_buckets covering "
            "this shape"
        )

    # -- scoring ------------------------------------------------------------ #
    def prepare(self, batch: HostBatch):
        """Check ``batch`` against the artifact's schema and pick its
        bucket: ``(b, B, K, program, host inputs)``, the host inputs the
        padded (key_segments, dense, extras...) as numpy arrays."""
        m = self.meta
        # feed and artifact schema must agree before any resolve: a batch
        # built under another slot config scores garbage silently
        S = m["n_sparse_slots"]
        if batch.n_sparse_slots != S:
            raise ValueError(
                f"batch was built with {batch.n_sparse_slots} sparse slots "
                f"but the artifact serves {S}: feed config and exported "
                "model disagree — re-export or fix DataFeedConfig.slots"
            )
        if batch.dense.shape[1] != m["dense_dim"]:
            raise ValueError(
                f"batch dense width {batch.dense.shape[1]} != artifact "
                f"dense_dim {m['dense_dim']}: feed config and exported "
                "model disagree"
            )
        b = int(batch.ins_mask.sum())
        if b and not batch.ins_mask[:b].all():
            raise ValueError(
                "batch real instances are not front-packed; cannot re-bucket"
            )
        nk = int(batch.n_keys)
        B, K, program = self._pick_bucket(b, nk)
        # real keys' segment ids ins * S + slot stay valid under bucket B;
        # padding ids land on B * S, which the pooling drops
        segs = np.full(K, B * S, np.int32)
        segs[:nk] = np.asarray(batch.key_segments[:nk], np.int32)
        dense = np.zeros((B, m["dense_dim"]), np.float32)
        dense[:b] = np.asarray(batch.dense[:b], np.float32)
        host = [segs, dense]
        if m.get("rank_offset_cols", 0):
            if batch.rank_offset is None:
                raise ValueError(
                    "artifact serves a rank_offset model: feed PV-merged "
                    "batches (enable_pv_merge + preprocess_instance)"
                )
            ro = np.zeros((B, m["rank_offset_cols"]), np.int32)
            ro_src = np.asarray(batch.rank_offset, np.int32)
            if ro_src.shape[1] != m["rank_offset_cols"]:
                raise ValueError(
                    f"batch rank_offset has {ro_src.shape[1]} columns but "
                    f"the artifact serves {m['rank_offset_cols']}: set "
                    "DataFeedConfig.rank_offset_cols to the exported width"
                )
            ro[:b] = ro_src[:b]
            host.append(ro)
        if m.get("seq_len", 0):
            if batch.seq_pos is None:
                raise ValueError(
                    "artifact serves a sequence model: set "
                    "DataFeedConfig.sequence_slot so batches carry seq_pos"
                )
            T = m["seq_len"]
            src = np.asarray(batch.seq_pos, np.int32)
            if src.shape[1] > T:
                # a wider feed would drop behaviour history at serving time
                raise ValueError(
                    f"batch max_seq_len {src.shape[1]} > artifact seq_len "
                    f"{T}: set DataFeedConfig.max_seq_len to the exported "
                    "length"
                )
            # real positions stay valid under the bucket's key buffer;
            # everything else becomes the bucket's pad marker K, and a
            # narrower feed pads its tail with it
            Ts = src.shape[1]
            sp = np.full((B, T), K, np.int32)
            sp[:b, :Ts] = np.where(src[:b] < nk, src[:b], K)
            host.append(sp)
        return b, B, K, program, host

    def predict(self, batch: HostBatch) -> np.ndarray:
        """Probabilities for the batch's real instances: [b] (primary task)
        or [b, n_tasks].  Any feed shape whose real instance and key counts
        fit an exported bucket is served."""
        b, B, K, program, host = self.prepare(batch)
        q = self.upload_keys(batch.keys, int(batch.n_keys))
        args = self.resolve(q, K) + [
            torch.from_numpy(a).to(self.device) for a in host]
        # each bucket program loads once; the stage scope attributes any
        # kernel build it triggers to serve.predict in jit.compiles
        with stage_scope("serve.predict"), torch.no_grad():
            preds = program(*args)
        return preds[:b].cpu().numpy()

    def predict_dataset(self, dataset) -> Iterator[np.ndarray]:
        """Score every batch of a loaded dataset (drop_last=False)."""
        for batch in dataset.batches(drop_last=False):
            yield self.predict(batch)
