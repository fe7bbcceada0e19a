"""One vocabulary for both packages: every metric and span name the port
records is a row of ARCHITECTURE.md's Observability and Distributed tracing
catalogs, read with the reference's own scanner (tools/pbox_analyze), and
the port's health rules are the reference's.  A name only the port
records must stand in PORT_ONLY below, with why; README.md's port section
lists them too.
"""

import fnmatch
import os
import sys

import pytest

from paddlebox_tpu.telemetry import health as ref_health
from paddlebox_tpu_torch.telemetry import health
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.pbox_analyze import catalog, rules_drift  # noqa: E402

ROOTS = ("paddlebox_tpu_torch",)

# port-only metric names, each with why the reference has no such name
PORT_ONLY = {
    # the single-chip step group's CUDA graph: captured once a table on
    # the card; the reference's lax.scan has no capture to count
    "trainer.graph_captures": "CUDA graph captures of the step group",
    "trainer.graph_replays": "CUDA graph replays of the step group",
    # the prefetch producer's groups handed to the step (the reference's
    # producer counts none)
    "trainer.prefetched_feeds": "feed groups the prefetch thread produced",
}


def _scan(call_re, name_filter) -> dict:
    return catalog.scan_literal_calls(call_re, roots=ROOTS,
                                      name_filter=name_filter)


def _covered(name: str, patterns) -> bool:
    concrete = name.replace("*", "ANY")
    return any(fnmatch.fnmatchcase(concrete, p) for p in patterns)


def _metric_names() -> dict:
    return _scan(rules_drift._METRIC_CALL_RE,
                 lambda name: any(c.isalpha() for c in name))


def _span_names() -> dict:
    return _scan(rules_drift._SPAN_CALL_RE, rules_drift._span_name_filter)


def test_every_port_metric_name_is_in_the_reference_catalog():
    pats = rules_drift.metric_catalog_patterns()
    found = _metric_names()
    missing = {n: w for n, w in found.items()
               if not _covered(n, pats) and n not in PORT_ONLY}
    assert not missing, f"metric names outside the catalog: {missing}"


def test_every_port_span_name_is_in_the_reference_catalog():
    pats = rules_drift.span_catalog_patterns()
    found = _span_names()
    missing = {n: w for n, w in found.items() if not _covered(n, pats)}
    assert not missing, f"span names outside the catalog: {missing}"
    assert {"pass", "reshard.migrate", "reshard.cutover", "ckpt.load",
            "ckpt.save.*", "shuffle.exchange"} <= set(found)


@pytest.mark.parametrize("name", sorted(PORT_ONLY))
def test_port_only_names_are_used_and_absent_from_the_catalog(name):
    assert name in _metric_names()
    assert not _covered(name, rules_drift.metric_catalog_patterns())
    readme = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    assert f"`{name}`" in readme


def test_the_slice_records_the_reference_names():
    """The names this slice ports: the table's, the log's, the
    checkpoints', placement's, the census's, the reshard's, the
    trainers' and the plane's own."""
    found = set(_metric_names())
    assert {
        "cache.miss_fetch_seconds", "store.merge_seconds",
        "pass.promote_seconds", "cache.hit_rate", "cache.fetch_fallbacks",
        "pass.host_row_bytes_in", "cache.admit_fallbacks",
        "pass.host_row_bytes_out", "cache.evicted_rows",
        "pass.boundary_gap_seconds", "store.log_commit_seconds",
        "store.compact_seconds", "store.log_compactions",
        "store.log_live_segments", "ckpt.save_seconds", "ckpt.load_seconds",
        "placement.hot_churn_keys", "placement.plan_updates",
        "placement.hot_keys", "placement.hot_resident_rows",
        "placement.hot_row_host_bytes", "census.cold_keys",
        "hostplane.gather_bytes", "reshard.migrated_rows", "reshard.aborts",
        "reshard.seconds", "shuffle.exchange_seconds", "train.grad_norm",
        "train.weight_norm", "jit.compiles", "jit.compile_seconds",
        "health.alerts", "health.windows", "trace.dropped_spans",
        "flight.dumps",
    } <= found


def test_health_rule_names_equal_the_reference():
    assert health.rule_names() == ref_health.rule_names()
    assert set(health.rule_names()) == set(rules_drift.health_rule_names())
