"""Sparsity-aware placement planner: replicated-hot against hash-sharded
cold (reference: paddlebox_tpu/sparse/placement.py).

A per-pass planner fed by each pass's global census classifies the top-k
keys by aged frequency as *replicated-hot* and everything else as
*hash-sharded cold*, emitted as a :class:`PlacementPlan`.  The sharded
table (parallel/sharded_table.py) uses the hot set twice: as the census
wire's shared dictionary (parallel/census.py: a hot key rides as one bit),
and, with ``SparseTableConfig.placement_realize``, as a replicated
``[H, W+1]`` block on every shard position, so a hot lookup is a local
gather and hot gradients reduce by a fixed-order fold
(parallel/trainer.py).  Hot and cold rows trade places only at pass
boundaries; :func:`hot_churn` names the moves.

Plan churn is hysteresis-bounded: a key must climb above ``enter_freq`` to
become hot, keeps its slot until it decays below ``exit_freq``, and the
plan changes at most once per ``update_interval`` passes.  With the
defaults (aging 0.8, enter 2.0) a key seen in every pass has frequency 1,
1.8, 2.44 at its first three censuses, so it turns hot at the third.

Determinism: ``observe``/``update_plan`` are pure functions of the census
sequence (ties broken by key value), because every rank must compute the
same plan without a collective; the census exchange checks a dictionary
digest and fails loudly on divergence.

Telemetry (the reference's names): ``placement.hot_churn_keys`` and
``placement.plan_updates`` count the moves and the hot-set changes, and
``placement.hot_keys`` gauges the planned hot set.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from paddlebox_tpu_torch import telemetry

_EMPTY_U64 = np.empty(0, dtype=np.uint64)

# frequencies below this are dropped from the tracker at the next
# observe(): bounds tracker memory to ~the recent working set without
# affecting plan decisions (anything this cold is far below exit_freq)
_PRUNE_FREQ = 0.05


def hot_churn(resident: np.ndarray, target: np.ndarray) -> tuple:
    """(promote, demote) between the device-RESIDENT hot set and the
    plan's TARGET hot set, both sorted unique uint64.  promote = keys the
    realizer must fetch into the replicated block; demote = keys it must
    write back to the sharded cold tier.  Counts the total move volume on
    ``placement.hot_churn_keys`` (the ``table.hot_churn`` health rule
    watches it)."""
    resident = np.asarray(resident, dtype=np.uint64)
    target = np.asarray(target, dtype=np.uint64)
    promote = np.setdiff1d(target, resident, assume_unique=True)
    demote = np.setdiff1d(resident, target, assume_unique=True)
    moved = int(promote.shape[0] + demote.shape[0])
    if moved:
        telemetry.counter(
            "placement.hot_churn_keys",
            "hot-set keys promoted or demoted at pass boundaries",
        ).inc(moved)
    return promote, demote


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One placement decision: which keys are replicated-hot.

    hot_keys: sorted unique uint64 — replicated on every shard's wire
    dictionary; everything else stays ``key % n_shards`` cold.
    version: bumps ONLY when the hot set actually changes (hysteresis
    keeps it stable), so consumers can cache derived state per version.
    """

    hot_keys: np.ndarray
    version: int

    @property
    def n_hot(self) -> int:
        return int(self.hot_keys.shape[0])


class PlacementPlanner:
    """LFU-with-aging key-frequency tracker + hysteresis-bounded top-k.

    Same policy family as the HbmCache directory (sparse/engine): every
    observed pass multiplies tracked frequencies by ``aging`` and credits
    this census's keys +1, so a key's frequency is a geometric recency-
    weighted pass count.  The plan takes the top ``hot_capacity`` keys
    with frequency >= ``enter_freq``; a currently-hot key survives while
    its frequency stays >= ``exit_freq`` (incumbents outrank challengers
    at equal frequency — churn needs a strict win).
    """

    def __init__(
        self,
        hot_capacity: int = 4096,
        aging: float = 0.8,
        enter_freq: float = 2.0,
        exit_freq: float = 1.0,
        update_interval: int = 2,
    ):
        if hot_capacity < 0:
            raise ValueError(f"hot_capacity must be >= 0, got {hot_capacity}")
        if not 0.0 < aging < 1.0:
            raise ValueError(f"aging must be in (0, 1), got {aging}")
        if exit_freq > enter_freq:
            raise ValueError(
                f"exit_freq ({exit_freq}) must be <= enter_freq "
                f"({enter_freq}) — hysteresis, not oscillation"
            )
        if update_interval < 1:
            raise ValueError("update_interval must be >= 1")
        self.hot_capacity = int(hot_capacity)
        self.aging = float(aging)
        self.enter_freq = float(enter_freq)
        self.exit_freq = float(exit_freq)
        self.update_interval = int(update_interval)
        # frequency tracker: sorted keys + aligned aged frequencies
        self._keys: np.ndarray = _EMPTY_U64.copy()
        self._freq: np.ndarray = np.empty(0, dtype=np.float64)
        self._plan = PlacementPlan(_EMPTY_U64.copy(), 0)
        self._passes_since_update = 0

    def plan(self) -> PlacementPlan:
        """The current plan (stable across calls until update_plan)."""
        return self._plan

    def frequencies(self, keys: np.ndarray) -> np.ndarray:
        """Tracked frequency of each queried key (0.0 when unseen): the
        reshard migration orders its rows hottest first by it."""
        q = np.asarray(keys, dtype=np.uint64)
        out = np.zeros(q.shape[0], dtype=np.float64)
        if self._keys.shape[0] and q.shape[0]:
            pos_c = np.minimum(np.searchsorted(self._keys, q),
                               self._keys.shape[0] - 1)
            found = self._keys[pos_c] == q
            out[found] = self._freq[pos_c[found]]
        return out

    def evidence(self) -> tuple:
        """(keys, freq) copy of the whole tracker, carried across a
        reshard cutover so the rebuilt planner starts warm."""
        return self._keys.copy(), self._freq.copy()

    # -- frequency feeding ------------------------------------------------ #
    def seed(self, keys: np.ndarray, freq: np.ndarray) -> None:
        """Merge external frequency evidence (an HbmCache's LFU directory,
        or a carried tracker); a key tracked on both sides keeps the
        larger frequency."""
        k = np.asarray(keys, dtype=np.uint64)
        f = np.asarray(freq, dtype=np.float64)
        if k.shape[0] != f.shape[0]:
            raise ValueError("seed keys/freq length mismatch")
        if not k.shape[0]:
            return
        order = np.argsort(k, kind="stable")
        k, f = k[order], f[order]
        # collapse duplicate seed keys (max wins)
        uk, start = np.unique(k, return_index=True)
        fmax = np.maximum.reduceat(f, start)
        merged_keys = np.concatenate([self._keys, uk])
        merged_freq = np.concatenate([self._freq, fmax])
        order = np.argsort(merged_keys, kind="stable")
        mk, mf = merged_keys[order], merged_freq[order]
        out_k, start = np.unique(mk, return_index=True)
        self._keys, self._freq = out_k, np.maximum.reduceat(mf, start)

    def observe(self, census: np.ndarray) -> None:
        """One pass observed: age every tracked frequency, credit this
        census's keys +1, admit unseen keys at 1.0, prune the frozen-cold
        tail.  ``census`` must be the GLOBAL census (every process feeds
        the same sequence -> every process tracks the same state)."""
        pk = np.unique(np.asarray(census, dtype=np.uint64))
        self._passes_since_update += 1
        freq = self._freq * self.aging
        keys = self._keys
        if keys.shape[0] and pk.shape[0]:
            pos = np.searchsorted(keys, pk)
            pos_c = np.minimum(pos, keys.shape[0] - 1)
            hit = keys[pos_c] == pk
            freq[pos_c[hit]] += 1.0
            new = pk[~hit]
        else:
            new = pk
        if new.shape[0]:
            keys = np.concatenate([keys, new])
            freq = np.concatenate(
                [freq, np.ones(new.shape[0], dtype=np.float64)]
            )
            order = np.argsort(keys, kind="stable")
            keys, freq = keys[order], freq[order]
        keep = freq >= _PRUNE_FREQ
        # never prune a currently-hot key: exit decisions belong to the
        # hysteresis in update_plan, not the memory bound
        if self._plan.n_hot and not keep.all():
            hot_pos = np.searchsorted(keys, self._plan.hot_keys)
            hot_pos = hot_pos[hot_pos < keys.shape[0]]
            keep[hot_pos[keys[hot_pos]
                         == self._plan.hot_keys[: hot_pos.shape[0]]]] = True
        self._keys, self._freq = keys[keep], freq[keep]

    # -- planning --------------------------------------------------------- #
    def update_plan(self) -> PlacementPlan:
        """Recompute the hot set if the hysteresis interval has elapsed;
        returns the (possibly unchanged) current plan.  Deterministic in
        the observed census sequence: ties break by ascending key."""
        if self.hot_capacity == 0:
            return self._plan
        if (
            self._plan.version > 0
            and self._passes_since_update < self.update_interval
        ):
            return self._plan
        keys, freq = self._keys, self._freq
        cur = self._plan.hot_keys
        is_hot = np.zeros(keys.shape[0], dtype=bool)
        if cur.shape[0] and keys.shape[0]:
            pos = np.searchsorted(keys, cur)
            pos_c = np.minimum(pos, keys.shape[0] - 1)
            is_hot[pos_c[keys[pos_c] == cur]] = True
        # incumbents survive at exit_freq; challengers need enter_freq
        eligible = np.where(is_hot, freq >= self.exit_freq,
                            freq >= self.enter_freq)
        cand = np.flatnonzero(eligible)
        if cand.shape[0] > self.hot_capacity:
            # rank: higher freq first, incumbents before challengers at a
            # tie, then ascending key — all total orders, so deterministic
            order = np.lexsort(
                (keys[cand], ~is_hot[cand], -freq[cand])
            )
            cand = cand[order[: self.hot_capacity]]
        hot = np.sort(keys[cand])
        if not np.array_equal(hot, cur):
            self._plan = PlacementPlan(hot, self._plan.version + 1)
            telemetry.counter(
                "placement.plan_updates",
                "placement-plan hot-set changes (hysteresis-bounded)",
            ).inc()
        elif self._plan.version == 0:
            # first decision, even if empty: consumers can distinguish
            # "no plan yet" from "planned, nothing hot"
            self._plan = PlacementPlan(hot, 1)
        self._passes_since_update = 0
        telemetry.gauge(
            "placement.hot_keys",
            "keys currently classified replicated-hot by the planner",
        ).set(float(self._plan.n_hot))
        return self._plan
