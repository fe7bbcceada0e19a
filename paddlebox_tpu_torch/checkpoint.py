"""Pass-boundary checkpoints: full "base" models and incremental "delta"s
(reference: paddlebox_tpu/checkpoint.py).

  * ``save_base(tag, ...)``: the whole sparse host store, the dense model and
    the optimizer state, atomically (a tmp dir, then a rename), then a
    donefile line.
  * ``save_delta(tag, ...)``: only the sparse rows touched since the last
    save (``SparseTable.pop_delta``) and the small dense state.
  * ``load(...)``: the latest base and every delta after it (or up to a tag).

The sparse half, the meta files, the integrity manifests and the donefile
are the reference's, byte for byte in layout: a checkpoint directory written
by either package loads its sparse half in the other.  The dense half is a
torch ``state_dict`` (the model's, the optimizer's) flattened into an npz by
name (``save_pytree``); ``load_pytree`` rebuilds it against a template.  A
reference checkpoint's CtrDnn params (jax key paths) load through
``weights.params_from_jax``; ``weights.params_to_jax`` maps the port's the
other way.

``IncrementalCheckpointManager`` keeps the sparse history in one
keep-history durable log (sparse/logstore.py): a tag pins a committed
manifest generation, so a delta save writes the delta and a restore reads
one generation.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from paddlebox_tpu_torch import telemetry, weights
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)


class CheckpointCorrupt(RuntimeError):
    """A checkpoint dir failed its integrity manifest (missing, truncated,
    or bit-flipped file).  Load refuses it; AutoCheckpointer.resume walks
    the donefile chain back to the newest tag that still verifies."""


# --------------------------------------------------------------------------- #
# integrity manifests: per-file sha256 + size, written atomically with the
# checkpoint files themselves (same tmp-dir rename), verified at load and
# after publish.  The reference relies on HDFS block checksums for this;
# local disk and `hadoop fs -put` round-trips get no such guarantee.
# --------------------------------------------------------------------------- #
def write_manifest(dirname: str, manifest_name: str,
                   recursive: bool = False) -> None:
    """Hash every regular file in ``dirname`` (except manifests) into
    ``dirname/manifest_name``.  ``recursive`` walks subdirectories too
    (slash-separated relative paths as keys) — serving artifacts keep
    their sparse snapshot under ``sparse/`` and must hash it, while
    checkpoint dirs stay flat and keep the historical behavior."""
    if recursive:
        names = []
        for base, _, fs in os.walk(dirname):
            rel = os.path.relpath(base, dirname)
            for f in fs:
                names.append(f if rel == "." else f"{rel}/{f}".replace(os.sep, "/"))
        names.sort()
    else:
        names = sorted(os.listdir(dirname))
    files = {}
    for name in names:
        if os.path.basename(name).startswith("manifest"):
            continue
        path = os.path.join(dirname, name)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as fh:
            data = fh.read()
        files[name] = {
            "sha256": hashlib.sha256(data).hexdigest(),
            "size": len(data),
        }
    with open(os.path.join(dirname, manifest_name), "w") as fh:
        json.dump({"version": 1, "files": files}, fh)


def verify_checkpoint_dir(dirname: str, fs=None) -> None:
    """Check ``dirname``'s files against its manifest(s); raises
    CheckpointCorrupt on any mismatch.  ``fs`` (an utils.fs-like object)
    lets the caller verify a REMOTE copy through the same code path —
    publish_checkpoint re-reads the uploaded dir this way.

    A dir with no manifest at all (pre-manifest checkpoint) is accepted
    but counted to stats as ``ckpt.unverified`` — fail-open keeps old
    checkpoints loadable."""
    if fs is None:
        from paddlebox_tpu_torch.utils.fs import LocalFS

        fs = LocalFS()
    try:
        names = [os.path.basename(p) for p in fs.ls(dirname)]
    except Exception as e:
        raise CheckpointCorrupt(f"{dirname}: cannot list ({e})") from e
    manifests = [n for n in names if n.startswith("manifest")]
    if not manifests:
        stats.add("ckpt.unverified")
        return
    for mname in manifests:
        try:
            manifest = json.loads(fs.cat(os.path.join(dirname, mname)))
        except (ValueError, OSError) as e:
            raise CheckpointCorrupt(
                f"{dirname}/{mname}: unreadable manifest ({e})"
            ) from e
        for name, want in manifest.get("files", {}).items():
            path = os.path.join(dirname, name)
            try:
                data = fs.cat(path)
            except Exception as e:
                raise CheckpointCorrupt(f"{path}: missing ({e})") from e
            if len(data) != want["size"]:
                raise CheckpointCorrupt(
                    f"{path}: size {len(data)} != manifest {want['size']}"
                )
            if hashlib.sha256(data).hexdigest() != want["sha256"]:
                raise CheckpointCorrupt(f"{path}: sha256 mismatch")
    stats.add("ckpt.verified")


# --------------------------------------------------------------------------- #
# dense state <-> npz: nested dicts, lists, tuples and named tuples of
# tensors (a model's or an optimizer's state_dict, an AucState), one npz
# leaf per tensor or number, named by its path joined with "/"
# --------------------------------------------------------------------------- #
def _flatten(tree: Any, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            _flatten(getattr(tree, f), f"{prefix}{f}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif torch.is_tensor(tree):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    elif isinstance(tree, (np.ndarray, np.generic, bool, int, float)):
        out[prefix[:-1]] = np.asarray(tree)
    # None and strings (optimizer options such as foreach=None) are not
    # saved: a load keeps the template's


def _flatten_paths(tree: Any) -> dict:
    out: dict = {}
    _flatten(tree, "", out)
    return out


def save_pytree(path: str, tree: Any) -> None:
    np.savez(path, **_flatten_paths(tree))


def _subtree(flat: dict, name: str) -> Any:
    """The saved leaves under ``name`` as nested dicts of CPU tensors
    (digit keys become ints, as an optimizer's state keys are)."""
    if name in flat:
        return torch.from_numpy(np.array(flat[name]))
    pre = name + "/"
    heads = dict.fromkeys(k[len(pre):].split("/", 1)[0]
                          for k in flat if k.startswith(pre))
    return {int(h) if h.isdigit() else h: _subtree(flat, pre + h)
            for h in heads}


def _merge(tmpl: Any, flat: dict, prefix: str) -> Any:
    if isinstance(tmpl, dict):
        out = {k: _merge(v, flat, f"{prefix}{k}/") for k, v in tmpl.items()}
        known = {str(k) for k in tmpl}
        # saved entries the template lacks (a fresh optimizer has no state)
        heads = dict.fromkeys(k[len(prefix):].split("/", 1)[0]
                              for k in flat if k.startswith(prefix))
        for h in heads:
            if h not in known:
                out[int(h) if h.isdigit() else h] = _subtree(flat, prefix + h)
        return out
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        return type(tmpl)(*(_merge(getattr(tmpl, f), flat, f"{prefix}{f}/")
                            for f in tmpl._fields))
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_merge(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tmpl))
    name = prefix[:-1]
    if torch.is_tensor(tmpl) or isinstance(tmpl, np.ndarray):
        if name not in flat:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        if isinstance(tmpl, np.ndarray):
            return np.asarray(flat[name], dtype=tmpl.dtype)
        return torch.from_numpy(np.array(flat[name])).to(
            dtype=tmpl.dtype, device=tmpl.device)
    if isinstance(tmpl, (bool, int, float)) and name in flat:
        return type(tmpl)(flat[name].item())
    return tmpl


def load_pytree(path: str, template: Any) -> Any:
    """Rebuild ``template``'s structure from saved leaves, each tensor with
    the template's dtype and device; saved entries the template lacks are
    added as CPU tensors (the optimizer's state, which
    ``Optimizer.load_state_dict`` moves to its parameters).  A reference
    checkpoint's CtrDnn params are mapped by ``weights.params_from_jax``.
    Raises KeyError when a template tensor has no saved leaf."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if weights.is_jax_param_file(flat):
        flat = {k: v.numpy() for k, v in
                weights.params_from_jax_flat(flat).items()}
    return _merge(template, flat, "")


# --------------------------------------------------------------------------- #
# checkpoint manager
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class CheckpointInfo:
    kind: str  # "base" | "delta"
    tag: str
    dirname: str
    meta: dict


class CheckpointManager:
    """Directory layout::

        root/
          base-<tag>/   sparse.npz  dense.npz  opt.npz  meta.json
          delta-<tag>/  ...
          donefile.txt  one json line per completed checkpoint, append-only
                        (the fleet_util donefile analog)
    """

    def __init__(self, root: str, shard: int = 0, n_shards: int = 1):
        self.root = root
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        os.makedirs(root, exist_ok=True)

    # -- write ------------------------------------------------------------- #
    def _sparse_name(self) -> str:
        return f"sparse-{self.shard:05d}.npz" if self.n_shards > 1 else "sparse.npz"

    def _meta_name(self) -> str:
        return f"meta-{self.shard:05d}.json" if self.n_shards > 1 else "meta.json"

    def _manifest_name(self) -> str:
        # shard-unique so concurrent shard saves into one dir never collide
        return (
            f"manifest-{self.shard:05d}.json"
            if self.n_shards > 1
            else "manifest.json"
        )

    def _write(
        self,
        kind: str,
        tag: str,
        sparse_state: dict,
        params: Any = None,
        opt_state: Any = None,
        meta: Optional[dict] = None,
    ) -> str:
        with telemetry.span(f"ckpt.save.{kind}", tag=tag), \
             telemetry.histogram(
                 "ckpt.save_seconds",
                 help="checkpoint write wall time (s) by kind",
             ).time(kind=kind):
            return self._write_timed(kind, tag, sparse_state, params,
                                     opt_state, meta)

    def _write_timed(
        self,
        kind: str,
        tag: str,
        sparse_state: dict,
        params: Any = None,
        opt_state: Any = None,
        meta: Optional[dict] = None,
    ) -> str:
        faults.inject("ckpt.save")
        dirname = os.path.join(self.root, f"{kind}-{tag}")
        tmp = dirname + f".tmp-{os.getpid()}-{self.shard}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(
            os.path.join(tmp, self._sparse_name()),
            keys=sparse_state["keys"],
            values=sparse_state["values"],
        )
        # dense state is replicated: by convention shard 0 owns it
        if params is not None and self.shard == 0:
            save_pytree(os.path.join(tmp, "dense.npz"), params)
        if opt_state is not None and self.shard == 0:
            save_pytree(os.path.join(tmp, "opt.npz"), opt_state)
        full_meta = {
            "kind": kind,
            "tag": tag,
            "time": time.time(),
            "n_sparse_rows": int(np.asarray(sparse_state["keys"]).shape[0]),
            "shard": self.shard,
            "n_shards": self.n_shards,
            **(meta or {}),
        }
        with open(os.path.join(tmp, self._meta_name()), "w") as fh:
            json.dump(full_meta, fh)
        # integrity manifest rides the same atomic rename as the data: a
        # checkpoint dir either has files + matching manifest or neither
        write_manifest(tmp, self._manifest_name())
        if self.n_shards == 1:
            if os.path.exists(dirname):
                # keep the old checkpoint alive until the new one is in
                # place: rename aside, swap in, then drop the old copy.  A
                # crash between the two renames leaves only the .old dir;
                # list_checkpoints() recovers it back to dirname on read.
                old = dirname + ".old"
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.replace(dirname, old)
                os.replace(tmp, dirname)
                shutil.rmtree(old)
            else:
                os.replace(tmp, dirname)
        else:
            # shard files have disjoint names: create-if-absent then move each
            # file atomically, so concurrent shard saves never collide
            os.makedirs(dirname, exist_ok=True)
            for f in os.listdir(tmp):
                os.replace(os.path.join(tmp, f), os.path.join(dirname, f))
            os.rmdir(tmp)
        with open(os.path.join(self.root, "donefile.txt"), "a") as fh:
            fh.write(json.dumps(full_meta) + "\n")
        return dirname

    def save_base(
        self,
        tag: str,
        table,
        params: Any = None,
        opt_state: Any = None,
        meta: Optional[dict] = None,
    ) -> str:
        """Full model (reference SaveBase).  On success resets the table's
        delta tracker — a delta chain restarts from every base."""
        state = table.state_dict()
        meta = {"table_seed": table._seed, **(meta or {})}
        out = self._write("base", tag, state, params, opt_state, meta)
        table.clear_delta()  # only after the write landed
        return out

    def save_delta(
        self,
        tag: str,
        table,
        params: Any = None,
        opt_state: Any = None,
        meta: Optional[dict] = None,
    ) -> str:
        """Rows touched since the previous base/delta (reference SaveDelta)."""
        meta = {"table_seed": table._seed, **(meta or {})}
        state = table.delta_state_dict()
        out = self._write("delta", tag, state, params, opt_state, meta)
        table.clear_delta()  # only after the write landed
        return out

    # -- read -------------------------------------------------------------- #
    def list_checkpoints(self) -> list[CheckpointInfo]:
        """Completed checkpoints in donefile order (this shard's entries)."""
        done = os.path.join(self.root, "donefile.txt")
        if not os.path.exists(done):
            return []
        out = []
        with open(done) as fh:
            for line in fh:
                meta = json.loads(line)
                if meta.get("shard", 0) != self.shard:
                    continue
                dirname = os.path.join(self.root, f"{meta['kind']}-{meta['tag']}")
                if not os.path.isdir(dirname) and os.path.isdir(dirname + ".old"):
                    # crash landed between the overwrite swap's two renames:
                    # the previous copy is intact under .old — restore it
                    os.replace(dirname + ".old", dirname)
                if os.path.isdir(dirname):
                    out.append(CheckpointInfo(meta["kind"], meta["tag"], dirname, meta))
        return out

    def find_valid_tag(self, upto: Optional[str] = None) -> Optional[str]:
        """Newest tag (at or before ``upto``) whose whole restore chain —
        its base and every intervening delta — passes integrity
        verification.  None when no loadable chain exists.  This is the
        fallback walk AutoCheckpointer.resume uses when the newest
        checkpoint is truncated/corrupt: recovery loses at most the passes
        after the last intact tag instead of the whole job."""
        ckpts = self.list_checkpoints()
        if upto is not None:
            keep = []
            for c in ckpts:
                keep.append(c)
                if c.tag == upto:
                    break
            # an upto tag missing from the donefile (its save never
            # completed) just means "newest available": keep everything
            ckpts = keep if any(c.tag == upto for c in keep) else ckpts
        verdict: dict[str, bool] = {}  # dirname -> verified ok

        def ok(c: CheckpointInfo) -> bool:
            v = verdict.get(c.dirname)
            if v is None:
                try:
                    verify_checkpoint_dir(c.dirname)
                    v = True
                except CheckpointCorrupt as e:
                    logger.warning("checkpoint %s corrupt: %s", c.dirname, e)
                    v = False
                verdict[c.dirname] = v
            return v

        for end in range(len(ckpts) - 1, -1, -1):
            sub = ckpts[: end + 1]
            base_i = max(
                (i for i, c in enumerate(sub) if c.kind == "base"),
                default=None,
            )
            if base_i is None:
                continue
            if all(ok(c) for c in sub[base_i:]):
                return sub[-1].tag
        return None

    def load(
        self,
        table,
        params_template: Any = None,
        opt_template: Any = None,
        upto: Optional[str] = None,
    ):
        """Restore the latest base plus all following deltas (optionally
        stopping at tag ``upto``).  Returns (params, opt_state, meta) — None
        for pytrees without a template or file.  Every dir in the restore
        chain is verified against its integrity manifest first (a truncated
        file raises CheckpointCorrupt here, not a cryptic npz error mid-
        restore).  Reference: InitializeGPUAndLoadModel
        (box_wrapper.cc:1329)."""
        with telemetry.span("ckpt.load", upto=upto or ""), \
             telemetry.histogram(
                 "ckpt.load_seconds", help="checkpoint restore wall time (s)"
             ).time():
            return self._load_timed(table, params_template, opt_template,
                                    upto)

    def _load_timed(self, table, params_template=None, opt_template=None,
                    upto: Optional[str] = None):
        faults.inject("ckpt.load")
        ckpts = self.list_checkpoints()
        if upto is not None:
            keep, found = [], False
            for c in ckpts:
                keep.append(c)
                if c.tag == upto:
                    found = True
                    break
            if not found:
                raise FileNotFoundError(f"no checkpoint tagged {upto!r}")
            ckpts = keep
        base_i = max(
            (i for i, c in enumerate(ckpts) if c.kind == "base"), default=None
        )
        if base_i is None:
            raise FileNotFoundError(f"no base checkpoint under {self.root}")
        chain = ckpts[base_i:]
        for c in chain:
            verify_checkpoint_dir(c.dirname)
        sparse_name = self._sparse_name()
        with np.load(os.path.join(chain[0].dirname, sparse_name)) as d:
            table.load_state_dict({"keys": d["keys"], "values": d["values"]})
        for c in chain[1:]:
            if c.kind != "delta":
                continue
            with np.load(os.path.join(c.dirname, sparse_name)) as d:
                table.apply_delta({"keys": d["keys"], "values": d["values"]})
        last = chain[-1]
        # deterministic resume: unseen-feature init depends on the table seed,
        # so a restored table must reproduce the saved one's init stream
        if "table_seed" in last.meta:
            table._seed = int(last.meta["table_seed"])
        params = opt_state = None
        dense_p = os.path.join(last.dirname, "dense.npz")
        if params_template is not None and os.path.exists(dense_p):
            params = load_pytree(dense_p, params_template)
        opt_p = os.path.join(last.dirname, "opt.npz")
        if opt_template is not None and os.path.exists(opt_p):
            opt_state = load_pytree(opt_p, opt_template)
        return params, opt_state, last.meta


# --------------------------------------------------------------------------- #
# incremental checkpoints over the durable log
# --------------------------------------------------------------------------- #
class IncrementalCheckpointManager:
    """Log-structured checkpoints: the whole sparse history lives in ONE
    keep-history :class:`~paddlebox_tpu_torch.sparse.logstore.LogStore`, and each
    checkpoint tag pins a committed manifest *generation* of it plus its
    (small) dense state.  ``save_delta`` appends only the rows touched
    since the last save and commits one generation — write cost is the
    delta, not the table; ``save_base`` rewrites the log compacted (the
    day-boundary reset).  Restore materializes the tag's generation, so
    its cost is the bytes that generation references (compacted base + the
    trailing deltas), never a per-checkpoint full re-export — background
    compaction is what keeps that bounded as the delta chain grows.

    Directory layout::

        root/
          sparse-log/           segments + manifest-<gen>.json + CURRENT
          state-<kind>-<tag>/   dense.npz  opt.npz  meta.json  manifest.json
          donefile.txt          one json line per completed tag, append-only
                                and LAST (the crash-consistency commit point)

    Drop-in for :class:`CheckpointManager` on the single-shard surface
    AutoCheckpointer uses (``save_base`` / ``save_delta`` /
    ``find_valid_tag`` / ``load``); multi-shard tables keep the classic
    manager."""

    def __init__(self, root: str, compact_threshold: int = 8):
        self.root = root
        self.compact_threshold = int(compact_threshold)
        os.makedirs(root, exist_ok=True)
        self._store = None

    # -- the log ------------------------------------------------------------ #
    def _log_root(self) -> str:
        return os.path.join(self.root, "sparse-log")

    def _log(self, n_cols: Optional[int] = None):
        from paddlebox_tpu_torch.sparse.logstore import LogStore

        if self._store is None:
            self._store = LogStore(
                self._log_root(),
                n_cols=n_cols,
                n_buckets=4,
                compact_threshold=self.compact_threshold,
                keep_history=True,  # every tagged generation stays loadable
            )
        return self._store

    # -- write -------------------------------------------------------------- #
    def _state_dir(self, kind: str, tag: str) -> str:
        return os.path.join(self.root, f"state-{kind}-{tag}")

    def _write_state(
        self,
        kind: str,
        tag: str,
        gen: int,
        n_rows: int,
        params: Any,
        opt_state: Any,
        meta: Optional[dict],
    ) -> dict:
        dirname = self._state_dir(kind, tag)
        tmp = dirname + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        if params is not None:
            save_pytree(os.path.join(tmp, "dense.npz"), params)
        if opt_state is not None:
            save_pytree(os.path.join(tmp, "opt.npz"), opt_state)
        full_meta = {
            "kind": kind,
            "tag": tag,
            "gen": int(gen),
            "time": time.time(),
            "n_sparse_rows": int(n_rows),
            **(meta or {}),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(full_meta, fh)
        write_manifest(tmp, "manifest.json")
        if os.path.exists(dirname):
            shutil.rmtree(dirname)
        os.replace(tmp, dirname)
        # donefile LAST: a tag exists only once its log generation AND its
        # dense dir are durably in place
        with open(os.path.join(self.root, "donefile.txt"), "a") as fh:
            fh.write(json.dumps(full_meta) + "\n")
        return full_meta

    def save_base(
        self,
        tag: str,
        table,
        params: Any = None,
        opt_state: Any = None,
        meta: Optional[dict] = None,
    ) -> str:
        """Full snapshot as one compacted rewrite generation."""
        with telemetry.histogram(
            "ckpt.save_seconds", help="checkpoint write wall time (s) by kind"
        ).time(kind="incr-base"):
            state = table.state_dict()
            log = self._log(int(state["values"].shape[1]))
            gen = log.rewrite(state["keys"], state["values"])
            self._write_state(
                "base", tag, gen, state["keys"].shape[0], params, opt_state,
                {"table_seed": table._seed, **(meta or {})},
            )
        table.clear_delta()  # only after the tag is visible
        return self._state_dir("base", tag)

    def save_delta(
        self,
        tag: str,
        table,
        params: Any = None,
        opt_state: Any = None,
        meta: Optional[dict] = None,
    ) -> str:
        """Rows touched since the previous save, as one appended
        generation.  A failure anywhere (the ``ckpt.delta_save`` chaos
        site fires before any mutation) leaves the delta tracker intact:
        the next save retries the same rows — at-least-once, and the log's
        newest-wins merge makes the replay idempotent."""
        faults.inject("ckpt.delta_save")
        with telemetry.histogram(
            "ckpt.save_seconds", help="checkpoint write wall time (s) by kind"
        ).time(kind="incr-delta"):
            state = table.delta_state_dict()
            log = self._log(int(state["values"].shape[1]))
            log.append(state["keys"], state["values"])
            gen = log.commit()
            self._write_state(
                "delta", tag, gen, state["keys"].shape[0], params, opt_state,
                {"table_seed": table._seed, **(meta or {})},
            )
            # bound the NEXT restore: fold over-threshold buckets now, so
            # the chain a future tag references is compacted-base + a few
            # deltas (old segments stay on disk — keep_history — so THIS
            # tag and every older one remain materializable)
            log.compact()
        table.clear_delta()
        return self._state_dir("delta", tag)

    # -- read --------------------------------------------------------------- #
    def entries(self) -> list[dict]:
        """Donefile entries oldest-first; a torn trailing line (crash mid-
        append) is skipped, matching the delivery plane's reader."""
        done = os.path.join(self.root, "donefile.txt")
        if not os.path.exists(done):
            return []
        out = []
        with open(done) as fh:
            for line in fh:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    logger.warning(
                        "donefile %s: skipping torn/unparsable line", done
                    )
        return out

    def _verify_entry(self, e: dict) -> bool:
        dirname = self._state_dir(e["kind"], e["tag"])
        try:
            verify_checkpoint_dir(dirname)
        except CheckpointCorrupt as err:
            logger.warning("checkpoint %s corrupt: %s", dirname, err)
            return False
        try:
            log = self._log()
        except Exception as err:
            logger.warning("checkpoint log unopenable: %s", err)
            return False
        ok, why = log.verify_gen(int(e["gen"]))
        if not ok:
            logger.warning(
                "checkpoint tag %s: log gen %s fails verification: %s",
                e["tag"], e["gen"], why,
            )
        return ok

    def find_valid_tag(self, upto: Optional[str] = None) -> Optional[str]:
        """Newest tag (at or before ``upto``) whose state dir AND pinned
        log generation both verify.  Unlike the classic manager there is
        no chain to walk per tag — a generation is self-contained."""
        ents = self.entries()
        if upto is not None and any(e["tag"] == upto for e in ents):
            while ents and ents[-1]["tag"] != upto:
                ents.pop()
        for e in reversed(ents):
            if self._verify_entry(e):
                return e["tag"]
        return None

    def load(
        self,
        table,
        params_template: Any = None,
        opt_template: Any = None,
        upto: Optional[str] = None,
    ):
        """Restore the newest (or ``upto``) tag: materialize its pinned log
        generation into the table, then its dense state.  Returns
        (params, opt_state, meta)."""
        with telemetry.histogram(
            "ckpt.load_seconds", help="checkpoint restore wall time (s)"
        ).time():
            return self._load_timed(table, params_template, opt_template,
                                    upto)

    def _load_timed(self, table, params_template=None, opt_template=None,
                    upto: Optional[str] = None):
        ents = self.entries()
        if upto is not None:
            keep, found = [], False
            for e in ents:
                keep.append(e)
                if e["tag"] == upto:
                    found = True
                    break
            if not found:
                raise FileNotFoundError(f"no checkpoint tagged {upto!r}")
            ents = keep
        if not ents:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        e = ents[-1]
        dirname = self._state_dir(e["kind"], e["tag"])
        verify_checkpoint_dir(dirname)
        log = self._log()
        ok, why = log.verify_gen(int(e["gen"]))
        if not ok:
            raise CheckpointCorrupt(
                f"tag {e['tag']}: log generation {e['gen']} corrupt: {why}"
            )
        keys, vals = log.materialize_at(int(e["gen"]))
        table.load_state_dict({"keys": keys, "values": vals})
        if "table_seed" in e:
            table._seed = int(e["table_seed"])
        params = opt_state = None
        dense_p = os.path.join(dirname, "dense.npz")
        if params_template is not None and os.path.exists(dense_p):
            params = load_pytree(dense_p, params_template)
        opt_p = os.path.join(dirname, "opt.npz")
        if opt_template is not None and os.path.exists(opt_p):
            opt_state = load_pytree(opt_p, opt_template)
        return params, opt_state, e
