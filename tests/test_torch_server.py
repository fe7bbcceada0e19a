"""The port's scoring server, admission gate and trace context against the
JAX package's, on the CPU (reference oracles: tests/test_server.py,
tests/test_microbatch.py).

One CtrDnn (3 slots, 2 dense, batch 16, tower 8) trains a pass in the JAX
package; the port's model and table take its parameters and state, and
both packages export it with its feed schema.  Checked:

  * ``/score`` answers the JAX server's scores on the same lines (rtol
    1e-5, atol 1e-6), key-dense requests split instead of clipping, one
    instance past the key capacity serves clipped and says so;
  * micro-batched requests under concurrency answer exactly their
    one-at-a-time scores;
  * ``AdmissionGate`` decides as the reference's on one seeded arrival
    sequence (admit, shed and its reason, retry estimate);
  * 413 and 400 bodies, graceful drain, hot swap under load;
  * ``traceparent`` parse and format parity, trace IDs on spans, on the
    flight ring and on the response;
  * ``python -m paddlebox_tpu_torch.serve --cpu`` serves, and refuses the
    fleet flags and a sync root that delivers no model in time.
"""

import copy
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.inference import ScoringServer as RefServer
from paddlebox_tpu.inference import export_model as ref_export_model
from paddlebox_tpu.inference.admission import AdmissionGate as RefGate
from paddlebox_tpu.inference.admission import ShedRequest as RefShed
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.telemetry import context as ref_context
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch import serve, telemetry
from paddlebox_tpu_torch.config import (
    DataFeedConfig,
    ScenarioServingConfig,
    SlotConfig,
    SparseTableConfig,
)
from paddlebox_tpu_torch.data.feed import BatchBuilder
from paddlebox_tpu_torch.data.slot_parser import SlotParser
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.inference import Predictor, ScoringServer, export_model
from paddlebox_tpu_torch.inference.admission import AdmissionGate, ShedRequest
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.telemetry import context, flight
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, DENSE, B, EMB, VOCAB = 3, 2, 16, 4, 40
KCAP = B * 8
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """{"conf", "ref", "port", "port_b"}: the JAX artifact, the port's, and
    a second port artifact of another tower (the hot-swap target)."""
    root = tmp_path_factory.mktemp("server")
    files = write_synth_files(str(root / "d"), n_files=1, ins_per_file=64,
                              n_sparse_slots=S, vocab_per_slot=VOCAB,
                              dense_dim=DENSE, seed=1)
    rconf = ref_synth_config(S, DENSE, B, 8)
    ds = RefDataset(rconf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    rtc = ref_config.SparseTableConfig(embedding_dim=EMB)
    ref_model = RefCtrDnn(S, rtc.row_width, dense_dim=DENSE, hidden=(8,))
    ref_tr = RefTrainer(ref_model, rtc,
                        ref_config.TrainerConfig(auc_buckets=1 << 10), seed=1)
    ref_table = RefTable(rtc, seed=1)
    ref_table.begin_pass(ds.unique_keys())
    ref_tr.train_from_dataset(ds, ref_table)
    ref_table.end_pass()
    ds.close()
    params = jax.tree.map(np.array, ref_tr.params)
    kw = dict(batch_size=B, key_capacity=KCAP, dense_dim=DENSE)
    ref_export_model(ref_model, params, ref_table, str(root / "ref"),
                     feed_conf=rconf, **kw)
    conf = make_synth_config(S, DENSE, B, 8)
    tc = SparseTableConfig(embedding_dim=EMB)
    model = CtrDnn(S, tc.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu")
    model.load_state_dict(params_from_jax_tree(params))
    table = SparseTable(tc, device="cpu")
    table.load_state_dict(ref_table.state_dict())
    export_model(model, table, str(root / "port"), feed_conf=conf, **kw)
    other = copy.deepcopy(model)
    with torch.no_grad():
        other.tower[0].weight.mul_(-1.5)
    export_model(other, table, str(root / "port_b"), feed_conf=conf, **kw)
    table.close()
    return {"conf": conf, "ref": str(root / "ref"),
            "port": str(root / "port"), "port_b": str(root / "port_b")}


def _lines(n, seed=5, max_keys=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = ["1 0"]
        for _s in range(S):
            ks = rng.integers(0, VOCAB + 10, int(rng.integers(1, max_keys)))
            parts.append(f"{len(ks)} " + " ".join(map(str, ks)))
        parts.append(f"{DENSE} " + " ".join(
            f"{v:.3f}" for v in rng.random(DENSE)))
        out.append(" ".join(parts))
    return ("\n".join(out) + "\n").encode()


def _post(port, body, path="/score", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        return r.status, (json.loads(data) if data else {}), dict(
            (k.lower(), v) for k, v in r.getheaders())
    finally:
        conn.close()


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _cpu_server(**kw):
    return ScoringServer(device="cpu", **kw)


# --------------------------------------------------------------------------- #
# scores against the JAX server
# --------------------------------------------------------------------------- #
def test_score_equals_the_reference_server(arts):
    ref = RefServer(max_batch=1)
    ref.register("m", arts["ref"])
    srv = _cpu_server(max_batch=1)
    srv.register("m", arts["port"])
    srv.register("b", arts["port_b"])
    ref_port, port = ref.start(port=0), srv.start(port=0)
    try:
        body = _lines(37)  # three chunks of the feed batch, unseen keys
        st_r, want, _ = _post(ref_port, body)
        st, got, hdr = _post(port, body)
        assert st == st_r == 200 and len(got["scores"]) == 37
        np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
        assert "x-pbox-trace-id" in hdr
        st, named, _ = _post(port, body, "/score/m")
        assert named["scores"] == got["scores"]
        st, other, _ = _post(port, body, "/score/b")
        assert other["scores"] != got["scores"]
        st, h = _get(port, "/healthz")
        assert st == 200 and h["ok"] and h["models"]["m"]["requests"] == 2
        assert h["models"]["m"]["embedding_dtype"] == "fp32"
        st, m = _get(port, "/models")
        assert set(m["models"]) == {"m", "b"} and m["default"] == "m"
        for path, code in (("/score/nope", 404), ("/nope", 404)):
            assert _post(port, _lines(1), path)[0] == code
        assert _post(port, b"not a slot line\n")[0] == 400
        st, text = 0, ""
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            st, text = r.status, r.read().decode()
        assert st == 200 and "server_requests" in text
    finally:
        srv.stop()
        ref.stop()


def test_key_dense_split_and_clipped_count(arts):
    """A key-dense request splits recursively (scores equal each instance
    alone, and the JAX server's); one instance past the key capacity
    serves clipped and is counted."""
    srv = _cpu_server(max_batch=1)
    srv.register("kd", arts["port"])
    ref = RefServer(max_batch=1)
    ref.register("kd", arts["ref"])
    rng = np.random.default_rng(11)
    out = []
    for _ in range(16):
        parts = ["1 0"]
        for _s in range(S):
            ks = rng.integers(0, VOCAB, 16)
            parts.append(f"{len(ks)} " + " ".join(map(str, ks)))
        parts.append(f"{DENSE} " + " ".join(
            f"{v:.3f}" for v in rng.random(DENSE)))
        out.append(" ".join(parts))
    body = ("\n".join(out) + "\n").encode()
    got = srv.score_lines(body)
    want = []
    for line in out:
        want.extend(srv.score_lines((line + "\n").encode()))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, ref.score_lines(body), **TOL)
    b = BatchBuilder(arts["conf"])
    b.build(SlotParser(arts["conf"]).parse_lines(out), np.arange(16))
    assert b.dropped_keys > 0  # one batch would have clipped

    parts = ["1 0"]
    for _s in range(S):
        ks = rng.integers(0, VOCAB, KCAP // S + 8)
        parts.append(f"{len(ks)} " + " ".join(map(str, ks)))
    parts.append(f"{DENSE} 0.1 0.2")
    fat = (" ".join(parts) + "\n").encode()
    detail = srv.score_lines_detail(fat)
    assert len(detail["scores"]) == 1 and detail["clipped_instances"] == 1
    np.testing.assert_allclose(detail["scores"], ref.score_lines(fat), **TOL)
    assert srv.score_lines_detail(_lines(2))["clipped_instances"] == 0
    port = srv.start(port=0)
    try:
        st, res, _ = _post(port, fat)
        assert st == 200 and res["clipped_instances"] == 1
        st, res, _ = _post(port, _lines(2))
        assert "clipped_instances" not in res
    finally:
        srv.stop()


def test_coalesced_equals_single(arts):
    """Concurrent requests coalesced into shared device calls answer
    exactly their one-at-a-time scores, in FIFO attribution."""
    srv = _cpu_server(max_batch=8, batch_linger_ms=20)
    srv.register("m", arts["port"])
    sizes = [1, 3, 7, 2, 5, 4, 1, 6, 3, 2, 8, 5]
    bodies = [_lines(n, seed=100 + i) for i, n in enumerate(sizes)]
    want = [srv.score_lines(b, "m") for b in bodies]
    hist = telemetry.histogram("serve.batch_size")
    port = srv.start(port=0)
    try:
        got, errors = [None] * len(bodies), []

        def post(i):
            try:
                st, out, _ = _post(port, bodies[i])
                assert st == 200, (st, out)
                got[i] = out["scores"]
            except Exception as e:  # surfaced below
                errors.append((i, repr(e)))

        for _round in range(2):
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            assert got == want
        assert (hist.summary() or {}).get("max", 0) > 1
    finally:
        srv.stop()


# --------------------------------------------------------------------------- #
# admission
# --------------------------------------------------------------------------- #
def _gate_trace(gate_cls, shed_cls, seed):
    """Outcomes of one seeded arrival sequence through a gate: with
    max_queue 0 no arrival waits, so the run is deterministic."""
    rng = np.random.default_rng(seed)
    gate = gate_cls(max_concurrency=3, max_queue=0,
                    default_deadline_s=0.08, initial_service_s=0.03)
    out, active = [], 0
    for _ in range(400):
        if active and rng.random() < 0.45:
            gate.release(float(rng.uniform(0.0, 0.1)))
            active -= 1
            out.append(("release", round(gate.service_estimate_s(), 12)))
            continue
        dl = [None, 0.0, 0.01, 0.05, 0.2][int(rng.integers(0, 5))]
        try:
            gate.admit(dl)
            active += 1
            out.append(("admit", dl))
        except shed_cls as shed:
            out.append(("shed", dl, shed.reason,
                        round(shed.retry_after_s, 12),
                        shed.retry_after_header))
        out.append(("wait", round(gate.estimated_wait_s(), 12),
                    gate.queue_depth(), gate.active()))
    return out


def test_admission_gate_decides_as_the_reference():
    got = _gate_trace(AdmissionGate, ShedRequest, 7)
    assert got == _gate_trace(RefGate, RefShed, 7)
    kinds = {e[2] for e in got if e[0] == "shed"}
    assert kinds == {"queue_full", "deadline"}
    # a queued admit waits FIFO and sheds on its deadline in the queue
    gate = AdmissionGate(max_concurrency=1, max_queue=2,
                         initial_service_s=0.01)
    gate.admit()
    with pytest.raises(ShedRequest) as ei:
        gate.admit(0.05)
    assert ei.value.reason == "deadline" and gate.queue_depth() == 0
    threading.Timer(0.05, gate.release, args=(0.01,)).start()
    gate.admit(None)  # waits for the release, then holds the slot
    gate.release()


def test_serving_policy_config():
    p = ScenarioServingConfig("m", embedding_dtype="int8", deadline_ms=20.0,
                              batch_linger_ms=0.5)
    assert ScenarioServingConfig.from_dict(
        dict(p.to_dict(), unknown=1)) == p
    assert p.to_dict() == ref_config.ScenarioServingConfig(
        "m", embedding_dtype="int8", deadline_ms=20.0,
        batch_linger_ms=0.5).to_dict()
    for bad in (dict(embedding_dtype="bf16"), dict(batch_linger_ms=-1),
                dict(deadline_ms=-1), dict(max_staleness_s=0)):
        with pytest.raises(ValueError):
            ScenarioServingConfig("m", **bad)
    srv = _cpu_server()
    srv.set_serving_policy("m", p)
    assert srv._policy_deadline_s("m") == 0.02
    assert srv._policy_linger_s("m") == 0.0005
    assert srv.serving_policy("other") is None


# --------------------------------------------------------------------------- #
# hardening: bodies, drain, hot swap
# --------------------------------------------------------------------------- #
class _StubPredictor:
    meta = {"n_tasks": 1, "row_width": 4}
    bucket_shapes = [(8, 64)]
    n_features = 1


def _stub_server(max_body_bytes=None):
    conf = DataFeedConfig(
        slots=(SlotConfig("click", type="float", is_dense=True),
               SlotConfig("s0")),
        batch_size=8,
    )
    srv = _cpu_server(max_body_bytes=max_body_bytes, max_batch=1)
    srv.register_predictor("stub", _StubPredictor(), conf)
    srv.score_lines = lambda text, name=None: [
        0.5 for ln in text.decode().splitlines() if ln.strip()
    ]
    return srv


def _raw_post(port, headers, body=b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.putrequest("POST", "/score", skip_host=False)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_413_and_400_bodies():
    srv = _stub_server(max_body_bytes=64)
    port = srv.start(port=0)
    big = telemetry.counter("server.oversized_body")
    bad = telemetry.counter("server.bad_content_length")
    b0, c0 = big.value(), bad.value()
    try:
        st, out = _raw_post(port, {"Content-Length": "100000"})
        assert st == 413 and "max_body_bytes" in out["error"]
        assert big.value() == b0 + 1
        st, out = _raw_post(port, {"Content-Length": "4"}, b"x\ny\n")
        assert st == 200 and len(out["scores"]) == 2
        for hdr in ({}, {"Content-Length": "-5"},
                    {"Content-Length": "banana"}):
            st, out = _raw_post(port, hdr)
            assert st == 400 and "Content-Length" in out["error"]
        assert bad.value() == c0 + 3
        srv.set_degraded("sync:live", "behind")
        st, h = _get(port, "/healthz")
        assert st == 200 and h["degraded"] and h["queue_depth"] == 0
        srv.clear_degraded("sync:live")
    finally:
        srv.stop()


class _DummyHttpd:
    def __init__(self):
        self.shut = self.closed = False

    def shutdown(self):
        self.shut = True

    def server_close(self):
        self.closed = True


def test_graceful_drain():
    srv = _cpu_server()
    srv._httpd = httpd = _DummyHttpd()
    assert srv._begin_request()
    threading.Timer(0.15, srv._end_request).start()
    t0 = time.monotonic()
    srv.stop(drain_timeout_s=5.0)
    assert 0.1 < time.monotonic() - t0 < 2.0  # waited for the request
    assert httpd.shut and httpd.closed
    srv.stop()  # idempotent
    # a request that never finishes: the deadline is counted, the close
    # proceeds, and draining refuses new requests meanwhile
    srv._httpd = httpd = _DummyHttpd()
    assert srv._begin_request()
    base = stats.get("server.drain_timeout")
    with srv._inflight_cv:
        srv._draining = True
    assert not srv._begin_request()
    with srv._inflight_cv:
        srv._draining = False
    srv.stop(drain_timeout_s=0.2)
    assert stats.get("server.drain_timeout") == base + 1
    assert httpd.shut and httpd.closed
    srv._end_request()
    # a started server's listener thread is a daemon that stop() retires
    live = _stub_server()
    live.start(port=0)
    thread = live._thread
    assert thread.daemon and thread.is_alive()
    live.stop()
    assert not thread.is_alive()


def test_hot_swap_under_load(arts):
    """swap_model and re-register while requests are in flight: every
    answer is the old model's or the new one's, never a mix."""
    pred_a = Predictor.load(arts["port"], device="cpu")
    pred_b = Predictor.load(arts["port_b"], device="cpu")
    srv = _cpu_server()
    srv.register("m", arts["port"])
    body = _lines(40)  # three chunks: each request pins one predictor
    want_a = srv.score_lines(body, "m")
    srv.swap_model("m", pred_b)
    want_b = srv.score_lines(body, "m")
    assert want_a != want_b
    bad, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            got = srv.score_lines(body, "m")
            if got != want_a and got != want_b:
                bad.append(got)

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for i in range(20):
            srv.swap_model("m", pred_a if i % 2 == 0 else pred_b)
            time.sleep(0.005)
        srv.register("m", arts["port_b"])  # re-register: a hot replace
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not bad
    assert srv._models["m"].requests > 2  # history carried over
    with pytest.raises(KeyError):
        srv.swap_model("nope", pred_a)


# --------------------------------------------------------------------------- #
# trace context
# --------------------------------------------------------------------------- #
TRACEPARENTS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e47zz-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "", None,
]


@pytest.mark.parametrize("value", TRACEPARENTS)
def test_traceparent_parse_and_format_parity(value):
    got, want = context.parse_traceparent(value), \
        ref_context.parse_traceparent(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.parent_span_id) == (
            want.trace_id, want.parent_span_id)
        assert len(got.span_id) == 16 and got.span_id != got.parent_span_id
        tp = got.to_traceparent()
        assert tp == f"00-{got.trace_id}-{got.span_id}-01"
        assert context.parse_traceparent(tp).parent_span_id == got.span_id
        assert context.from_headers(
            {context.TRACEPARENT_HEADER: value}).trace_id == got.trace_id


def test_spans_carry_the_trace_context():
    root = context.new_root()
    assert len(root.trace_id) == 32 and root.parent_span_id is None
    assert context.trace_fields() == {}
    tracer = telemetry.enable_tracing()
    tracer.drain()
    ring = flight.reset_for_tests()
    try:
        with context.activate(root):
            assert context.trace_fields() == {"trace_id": root.trace_id,
                                              "span_id": root.span_id}
            with telemetry.span("outer"):
                inner_ctx = context.current()
                with telemetry.span("inner"):
                    pass
            telemetry.instant("mark")
        assert context.current() is None
        evs = {e["name"]: e for e in tracer.drain()}
        outer, inner = evs["outer"]["args"], evs["inner"]["args"]
        assert outer["trace_id"] == inner["trace_id"] == root.trace_id
        assert outer["parent_span_id"] == root.span_id
        assert inner["parent_span_id"] == outer["span_id"] == \
            inner_ctx.span_id
        assert evs["mark"]["args"]["span_id"] == root.span_id
        recs = {r["name"]: r for r in ring.snapshot()}
        assert recs["inner"]["span_id"] == inner["span_id"]
        assert recs["inner"]["parent_span_id"] == outer["span_id"]
        assert recs["mark"]["trace_id"] == root.trace_id
    finally:
        telemetry.disable_tracing()
        flight.reset_for_tests()


def test_request_continues_the_callers_trace():
    srv = _stub_server()
    port = srv.start(port=0)
    tp = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    ring = flight.reset_for_tests()
    try:
        st, _, hdr = _post(port, b"x\n", headers={"traceparent": tp})
        assert st == 200
        assert hdr["x-pbox-trace-id"] == "4bf92f3577b34da6a3ce929d0e0e4736"
        # the span covers the reply's write, so it lands in the ring just
        # after the client reads the reply: wait for it, at most 5 s
        deadline = time.monotonic() + 5.0
        req = []
        while not req and time.monotonic() < deadline:
            req = [r for r in ring.snapshot()
                   if r["name"] == "server.request"]
            if not req:
                time.sleep(0.01)
        assert req and req[0]["trace_id"] == hdr["x-pbox-trace-id"]
        assert req[0]["parent_span_id"] != "00f067aa0ba902b7"  # a child
        st, _, hdr2 = _post(port, b"x\n")  # no header: a fresh trace
        assert len(hdr2["x-pbox-trace-id"]) == 32
        assert hdr2["x-pbox-trace-id"] != hdr["x-pbox-trace-id"]
    finally:
        srv.stop()
        flight.reset_for_tests()


# --------------------------------------------------------------------------- #
# the serve command
# --------------------------------------------------------------------------- #
def test_serve_cli_on_the_cpu(arts):
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.serve", "--artifact",
         f"m={arts['port']}", "--artifact", arts["port_b"], "--port", "0",
         "--cpu", "--max-batch", "4", "--serving-policy",
         "m:deadline_ms=500,batch_linger_ms=1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
    )
    try:
        port, seen = None, []
        t0 = time.time()
        while time.time() - t0 < 120:
            line = proc.stdout.readline()
            if not line:
                assert proc.poll() is None, "".join(seen)
                time.sleep(0.2)
                continue
            seen.append(line)
            if "serving on http://" in line:
                port = int(line.split(":")[2].split("/")[0])
                break
        assert port, "".join(seen)
        assert "device cpu" in seen[-1]
        st, out, _ = _post(port, _lines(3), "/score/m")
        assert st == 200 and len(out["scores"]) == 3
        st, m = _get(port, "/models")
        assert set(m["models"]) == {"m", "port_b"} and m["default"] == "m"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@pytest.mark.parametrize("argv", [
    # a sync root that delivers no model in time, with no artifact to
    # serve meanwhile
    ["--sync-root", "/nonexistent", "--sync-timeout", "0.2"],
    # fleet mode (ported) still needs a model before it spawns a replica
    ["--replicas", "2"],
    ["--replicas", "2", "--autoscale"],
])
def test_serve_refuses_the_fleet_and_sync_flags(arts, argv, capsys):
    argv = [arts["port"] if a == "ART" else a for a in argv]
    with pytest.raises(SystemExit) as ei:
        serve.main(["--cpu", *argv])
    assert ei.value.code != 0
    err = capsys.readouterr().err
    if "--sync-root" in argv:
        assert "no model appeared under /nonexistent" in err
    else:
        assert "pass at least one --artifact or a --sync-root" in err


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        ScoringServer()
    with pytest.raises(SystemExit):
        serve.main([])  # no artifact
