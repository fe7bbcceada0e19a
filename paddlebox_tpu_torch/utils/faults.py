"""Deterministic, seeded fault injection for chaos tests (reference:
paddlebox_tpu/utils/faults.py, the part the port uses).

A ``FaultPlan`` maps site names to a failure spec, and each instrumented
site calls ``inject(site)``: a no-op unless a plan is active and the spec
says this hit fails.

Spec forms (string or FaultSpec):

    "first:N"      fail the first N hits of the site, then succeed
    "at:3,7"       fail exactly hits 3 and 7 (0-based)
    "p:0.05"       fail each hit with probability 0.05, drawn from a
                   per-site stream seeded by (plan seed, site)
    "hang:<sel>"   selected hits HANG instead of raising, until
                   ``release_hangs()`` (a new ``install()``/``clear()``
                   releases implicitly) or until a registered hang
                   interrupt raises: the liveness watchdog registers its
                   abort check, so a simulated freeze ends with the
                   structured DistributedStallError at the frozen site

Activation: ``install(plan)`` / the ``fault_plan`` context manager, or the
environment: ``PADDLEBOX_TORCH_FAULT_PLAN`` holds a ';'-separated spec list
("store.merge=first:1;ckpt.save=p:0.1") and ``PADDLEBOX_TORCH_FAULT_SEED``
the seed.  Site names may end in '*' to match a prefix.  Every injected
fault counts to ``stats`` as ``faults.injected.<site>``, every check as
``faults.checked.<site>``.

A test that arms a ``hang:`` spec releases it in a ``finally``: a hung site
holds its thread (a table's merge worker, say) until released.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import zlib
from typing import Dict, Optional, Union

from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.retry import register_retryable


class FaultInjected(RuntimeError):
    """Raised by an injection site the active plan told to fail."""


# an injected fault is transient by construction: retry_call retries it
register_retryable(FaultInjected)


# the site catalog: a plan naming an unknown non-wildcard site logs a
# warning instead of silently never firing
KNOWN_SITES = {
    # pass-boundary pipeline: the background store merge (sparse/table.py)
    "store.merge",
    # the HBM cache (sparse/table.py, parallel/sharded_table.py): the
    # begin-pass fetch of the cache misses (failure: the full host
    # resolve) and the end-pass admission (failure: the census leaves the
    # cache and the whole working set writes back); both degrade, never
    # corrupt
    "cache.fetch", "cache.admit",
    # live reshard (parallel/sharded_table.py): the migration and the
    # cutover commit; a failure in either aborts back to the old shard map
    "reshard.migrate", "reshard.cutover",
    # durable cold tier (sparse/logstore.py): segment block append, the
    # compaction between its staged merge and its manifest commit, and the
    # manifest commit's CURRENT swing
    "store.segment_write", "store.compact", "store.manifest_commit",
    # checkpoints (checkpoint.py): save, load and the incremental delta
    "ckpt.save", "ckpt.load", "ckpt.delta_save",
    # the filesystem surface of utils/fs.py (LocalFS by operation,
    # HadoopFS by hadoop verb)
    "fs.ls", "fs.exists", "fs.mkdir", "fs.upload", "fs.download", "fs.rm",
    "fs.touch", "fs.cat", "fs.put", "fs.get", "fs.test", "fs.touchz",
    # model publishing (utils/fs.py publish_checkpoint,
    # serving_sync/publisher.py): a failed upload or donefile write leaves
    # nothing visible and the delta tracker intact
    "publish.mkdir", "publish.upload", "publish.donefile", "publish.delta",
    # the serving side's sync agent (serving_sync/syncer.py): the donefile
    # poll (retried), the fetch of an entry (retried) and its apply (a
    # failure takes the full-reload ladder)
    "sync.poll", "sync.fetch", "sync.apply",
    # online training (streaming/): the tail source's poll (a failure is
    # counted and retried next poll; a hang wedges the feed for the
    # watchdog's `feed` stage), the window cut (a failure defers the cut:
    # the records merge into the next window) and the deadline publish (a
    # failure keeps the rows tracked for the next window)
    "stream.tail", "stream.cut", "stream.publish_deadline",
    # one input file's read (data/slot_parser.py parse_file), retried by
    # the dataset through utils/retry.py
    "data.read",
    # the single-chip trainer's feed (train/trainer.py): a fired hit
    # poisons the batch's labels with NaN, so the loss and gradients go
    # non-finite on the device and the configured nan_policy acts
    "train.nan",
    # the distributed plane (parallel/): a hang at "train.step" freezes a
    # step of either trainer (the stall the liveness watchdog must bound),
    # "hostplane.allgather" one KvChannel gather (raise or hang), and
    # "watchdog.heartbeat" one heartbeat publish (a hang there freezes the
    # publisher: the dead-process signature peers must catch)
    "train.step", "hostplane.allgather", "watchdog.heartbeat",
    # one /retrieve query of the scoring server (inference/server.py): a
    # fired hit answers 500, the server survives
    "retrieve.query",
}


def register_site(name: str) -> None:
    """Add a site name to the catalog."""
    KNOWN_SITES.add(name)


def known_sites() -> frozenset:
    return frozenset(KNOWN_SITES)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    fail_first: int = 0  # fail hits 0..fail_first-1
    at: tuple = ()  # fail exactly these hit indices (0-based)
    probability: float = 0.0  # additionally fail each hit with this p
    hang: bool = False  # selected hits hang instead of raising

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        kind, _, arg = text.partition(":")
        if kind == "hang":
            return dataclasses.replace(FaultSpec.parse(arg), hang=True)
        if kind == "first":
            return FaultSpec(fail_first=int(arg))
        if kind == "at":
            return FaultSpec(at=tuple(int(x) for x in arg.split(",") if x))
        if kind == "p":
            return FaultSpec(probability=float(arg))
        raise ValueError(
            f"bad fault spec {text!r} (want [hang:]first:N|at:I,J|p:F)"
        )


class FaultPlan:
    """Site -> FaultSpec map with deterministic per-site hit counting."""

    def __init__(self, sites: Dict[str, Union[str, FaultSpec]], seed: int = 0):
        self.seed = int(seed)
        self.sites: Dict[str, FaultSpec] = {
            name: spec if isinstance(spec, FaultSpec) else FaultSpec.parse(spec)
            for name, spec in sites.items()
        }
        for name in self.sites:
            if not name.endswith("*") and name not in KNOWN_SITES:
                logging.getLogger(__name__).warning(
                    "fault plan names unknown site %r; it fires only if "
                    "some inject() call uses that name", name,
                )
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}

    @staticmethod
    def from_env() -> Optional["FaultPlan"]:
        from paddlebox_tpu_torch.config import flags

        text = flags.fault_plan
        if not text:
            return None
        sites = {}
        for part in text.split(";"):
            part = part.strip()
            if part:
                name, _, spec = part.partition("=")
                sites[name.strip()] = spec.strip()
        return FaultPlan(sites, seed=flags.fault_seed)

    def _spec_for(self, site: str) -> Optional[FaultSpec]:
        spec = self.sites.get(site)
        if spec is not None:
            return spec
        for name, s in self.sites.items():
            if name.endswith("*") and site.startswith(name[:-1]):
                return s
        return None

    def check(self, site: str) -> bool:
        """One hit of ``site``; True = this hit must fail."""
        return self.check_spec(site) is not None

    def check_spec(self, site: str) -> Optional[FaultSpec]:
        """One hit of ``site``; the matching spec when this hit must fail,
        None when it passes."""
        spec = self._spec_for(site)
        if spec is None:
            return None
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            fail = hit < spec.fail_first or hit in spec.at
            if not fail and spec.probability > 0.0:
                rng = self._rngs.get(site)
                if rng is None:
                    rng = random.Random(
                        (self.seed << 32) ^ zlib.crc32(site.encode())
                    )
                    self._rngs[site] = rng
                fail = rng.random() < spec.probability
        return spec if fail else None

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


_active: Optional[FaultPlan] = None
_env_checked = False
_lock = threading.Lock()

# a "hang:" spec waits in _hang until released or interrupted: the hooks
# are how the liveness watchdog reaches into a simulated freeze (its
# registered check raises DistributedStallError on the hung thread)
_hang_release = threading.Event()
_hang_hooks: list = []
_hang_lock = threading.Lock()


def register_hang_interrupt(fn) -> "callable":
    """Register ``fn``, polled by hung sites; ``fn`` raising ends the hang
    with that exception.  Returns the unregister callable."""
    with _hang_lock:
        _hang_hooks.append(fn)

    def unregister() -> None:
        with _hang_lock:
            if fn in _hang_hooks:
                _hang_hooks.remove(fn)

    return unregister


def release_hangs() -> None:
    """Unstick every currently hung site (they return as if they ran) and
    re-arm the latch for future hangs."""
    global _hang_release
    with _hang_lock:
        _hang_release.set()
        _hang_release = threading.Event()


def _hang(site: str) -> None:
    stats.add(f"faults.hung.{site}")
    with _hang_lock:
        release = _hang_release  # the latch armed when the hang began
    while not release.is_set():
        with _hang_lock:
            hooks = list(_hang_hooks)
        for fn in hooks:
            fn()  # may raise (a watchdog abort)
        release.wait(0.05)


def install(plan: Optional[FaultPlan]) -> None:
    """Make ``plan`` the process-wide active plan (None deactivates).
    Sites hung under the previous plan are released."""
    global _active, _env_checked
    with _lock:
        release_hangs()
        _active = plan
        _env_checked = True  # an explicit install outranks the environment


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    global _active, _env_checked
    with _lock:
        if not _env_checked:
            _env_checked = True
            _active = FaultPlan.from_env()
        return _active


def fire(site: str) -> bool:
    """True when the active plan wants this hit of ``site`` to fail, for
    sites whose failure is not an exception."""
    plan = active()
    if plan is None:
        return False
    stats.add(f"faults.checked.{site}")
    if plan.check(site):
        stats.add(f"faults.injected.{site}")
        return True
    return False


def inject(site: str) -> None:
    """Fail this hit of ``site`` per the active plan: raise FaultInjected,
    or, for a "hang:" spec, block until released."""
    plan = active()
    if plan is None:
        return
    stats.add(f"faults.checked.{site}")
    spec = plan.check_spec(site)
    if spec is None:
        return
    stats.add(f"faults.injected.{site}")
    if spec.hang:
        _hang(site)
        return
    raise FaultInjected(f"injected fault at {site}")


class fault_plan:
    """Context manager for tests: installs a plan, restores the prior one
    (which releases any hang the plan left armed)."""

    def __init__(self, sites: Dict[str, Union[str, FaultSpec]], seed: int = 0):
        self.plan = FaultPlan(sites, seed=seed)
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self._prev = active()
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        install(self._prev)
