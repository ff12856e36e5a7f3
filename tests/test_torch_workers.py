"""The port's worker layer (device="cpu"): the frame protocol, typed death of
process and remote workers, bounded respawn, replica hedging and failover,
and admission.  A subset of ``tests/test_workers.py`` and
``tests/test_replicas.py``, run against ``repro_torch.cluster``; the frame
protocol is also held byte for byte against the reference's.
"""
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.cluster.workers import proto as ref_proto
from repro_torch.cluster import ClusterService, Overloaded, WorkerDied
from repro_torch.cluster.partition import split_doc_ranges
from repro_torch.cluster.workers import ProcessWorker, RemoteWorker, shard_doc_stats
from repro_torch.cluster.workers.proto import (
    MAX_FRAME_BYTES,
    ProtocolError,
    dump_array,
    load_array,
    read_frame,
    write_frame,
)
from repro_torch.cluster.workers.replica import ReplicaSet
from repro_torch.cluster.workers.server import _ids_payload
from repro_torch.core import KeywordSearchEngine
from repro_torch.core.engine import QueryStats
from repro_torch.data import QUERIES, generate_discogs_tree

ROOT = Path(__file__).resolve().parent.parent
N_RELEASES = 12


@pytest.fixture(scope="module")
def corpus():
    return generate_discogs_tree(n_releases=N_RELEASES, seed=11)


@pytest.fixture(scope="module")
def engine(corpus):
    return KeywordSearchEngine(corpus, device="cpu")


@pytest.fixture(scope="module")
def artifact(engine, tmp_path_factory):
    """A single-shard artifact (the whole corpus as shard 0)."""
    path = str(tmp_path_factory.mktemp("worker") / "shard")
    engine.save(path)
    return path


@pytest.fixture(scope="module")
def spec(corpus):
    return split_doc_ranges(corpus, 1)[0]


# --------------------------------------------------------------------------- #
# Frame protocol
# --------------------------------------------------------------------------- #


def _frames(proto) -> bytes:
    buf = io.BytesIO()
    proto.write_frame(buf, {"id": 3, "op": "submit", "ok": True},
                      proto.dump_array(np.arange(17, dtype=np.int64)))
    proto.write_frame(buf, {"id": 4, "op": "doc_stats", "ok": True, "full": np.int64(7)},
                      proto.dump_array(np.array([2, 0, 5], dtype=np.int64)))
    proto.write_frame(buf, {"id": 5, "op": "drain", "ok": True})
    return buf.getvalue()


def test_proto_bytes_equal_reference():
    """Same header JSON, same .npy payloads, same cap: byte for byte."""
    assert _frames(ref_proto) == _frames(sys.modules[write_frame.__module__])
    assert MAX_FRAME_BYTES == ref_proto.MAX_FRAME_BYTES
    # each side reads what the other wrote
    stream = io.BytesIO(_frames(ref_proto))
    h, p = read_frame(stream)
    assert h["id"] == 3 and load_array(p).tolist() == list(range(17))
    h, p = ref_proto.read_frame(io.BytesIO(_frames(sys.modules[write_frame.__module__])))
    assert h["op"] == "submit" and ref_proto.load_array(p).dtype == np.int64


def test_proto_truncated_at_every_boundary():
    buf = io.BytesIO()
    write_frame(buf, {"id": 9, "op": "submit", "ok": True},
                dump_array(np.arange(5, dtype=np.int64)))
    raw = buf.getvalue()
    for cut in range(len(raw)):
        h, p = read_frame(io.BytesIO(raw[:cut]))
        assert h is None and p == b"", f"cut at byte {cut}"
    h, p = read_frame(io.BytesIO(raw))
    assert h["id"] == 9 and len(p) == h["payload_len"]


@pytest.mark.parametrize("n", [MAX_FRAME_BYTES + 1, 0xFFFFFFFF])
def test_proto_oversized_header_len_raises(n):
    raw = struct.pack(">I", n) + b"garbage-after-a-corrupt-length"
    with pytest.raises(ProtocolError):
        read_frame(io.BytesIO(raw))


@pytest.mark.parametrize("n", [MAX_FRAME_BYTES + 1, -1])
def test_proto_lying_payload_len_raises(n):
    hdr = json.dumps({"id": 0, "op": "x", "payload_len": n}).encode()
    with pytest.raises(ProtocolError):
        read_frame(io.BytesIO(struct.pack(">I", len(hdr)) + hdr))


@pytest.mark.parametrize("hdr", [b"ab{cd", b"[1, 2]", b'"str"'])
def test_proto_non_json_header_raises(hdr):
    with pytest.raises(ProtocolError):
        read_frame(io.BytesIO(struct.pack(">I", len(hdr)) + hdr))


def test_proto_payload_len_undercutting_npy_fails_decode():
    payload = dump_array(np.arange(100, dtype=np.int64))
    hdr = json.dumps({"id": 0, "op": "submit", "ok": True, "payload_len": 8}).encode()
    h, p = read_frame(io.BytesIO(struct.pack(">I", len(hdr)) + hdr + payload))
    assert h["payload_len"] == 8 and len(p) == 8
    with pytest.raises(ValueError):
        load_array(p)


def test_reply_payload_is_int64_numpy_only():
    """Result ids cross the wire as numpy int64; a tensor or another dtype
    fails the request instead of changing the bytes."""
    ids = np.array([0, 5, 9], dtype=np.int64)
    assert _ids_payload(ids) == ref_proto.dump_array(ids)
    for bad in (torch.tensor([0, 5, 9]), ids.astype(np.int32), ids.tolist()):
        with pytest.raises(TypeError, match="int64"):
            _ids_payload(bad)


def test_subproc_imports_nothing_heavy_before_main():
    """The worker entrypoint moves stdout off its RPC pipe before torch (or
    anything that may print) loads: importing it loads no torch."""
    code = (
        "import sys, repro_torch.cluster.workers.subproc\n"
        "assert 'torch' not in sys.modules, sorted(sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=60)
    assert proc.returncode == 0, proc.stderr


# --------------------------------------------------------------------------- #
# Typed death: process and remote workers
# --------------------------------------------------------------------------- #


def test_process_worker_kill_fails_fast_typed(artifact, spec):
    pw = ProcessWorker(spec, artifact, batch_window_ms=60_000.0, device="cpu")
    try:
        assert pw.wait_ready(300.0)
        fut = pw.submit(QUERIES["Q1"][1], "slca")  # parked in the window
        pw._proc.kill()
        with pytest.raises(WorkerDied) as exc_info:
            fut.result(timeout=60)
        assert exc_info.value.shard == spec.index
        deadline = time.time() + 30
        while pw._dead is None and time.time() < deadline:
            time.sleep(0.05)
        with pytest.raises(WorkerDied):
            pw.submit(QUERIES["Q1"][1], "slca")
    finally:
        pw.close()


def test_pool_respawns_killed_worker(corpus, engine):
    """Kill mid-query through the router: the caller gets WorkerDied, the
    pool respawns the shard (bounded) and the next query runs there."""
    kws = QUERIES["Q1"][1]
    want = engine.query(kws, backend="scalar")
    with ClusterService.from_tree(corpus, 1, transport="process", backends="fused",
                                  batch_window_ms=2_000.0, device="cpu") as svc:
        first = svc.pool.workers[0]
        fut = svc.submit(kws, "slca")
        first._proc.kill()
        with pytest.raises(WorkerDied):
            fut.result(timeout=120)
        deadline = time.time() + 300
        while svc.pool.workers[0] is first and time.time() < deadline:
            time.sleep(0.1)
        assert svc.pool.workers[0] is not first, "pool did not respawn"
        np.testing.assert_array_equal(svc.query(kws, "slca"), want)
        snap = svc.stats().summary()
        assert snap["worker_respawns"] == 1
        assert snap["queue_depth_per_shard"] == [0]


def test_remote_kill_server_fails_typed_no_hang(corpus):
    q1, q2 = QUERIES["Q1"][1], QUERIES["Q2"][1]  # distinct: two live gathers
    with ClusterService.from_tree(corpus, 1, transport="remote", backends="chained",
                                  batch_window_ms=60_000.0, device="cpu") as svc:
        futs = [svc.submit(q1, "slca"), svc.submit(q2, "slca")]
        svc._owned_servers[0].kill()
        for fut in futs:
            with pytest.raises(WorkerDied):
                fut.result(timeout=120)
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                svc.submit(q1, "slca").result(timeout=60)
            except WorkerDied:
                break
            except Exception:
                time.sleep(0.2)  # a reconnect attempt raced us; retry
        else:
            pytest.fail("submits after server death never surfaced WorkerDied")


def test_remote_connect_refused_raises_workerdied(spec):
    with pytest.raises(WorkerDied):
        RemoteWorker(spec, "127.0.0.1:1", connect_timeout=5.0)


def test_remote_corrupt_stream_dies_typed(spec):
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def bad_server():
        conn, _ = srv.accept()
        conn.sendall(struct.pack(">I", 0xFFFFFFFF) + b"junk")
        conn.close()

    threading.Thread(target=bad_server, daemon=True).start()
    rw = RemoteWorker(spec, f"127.0.0.1:{port}")
    try:
        assert not rw.wait_ready(30.0)
        assert isinstance(rw._dead, WorkerDied)
        assert "ProtocolError" in rw._dead.detail
        with pytest.raises(WorkerDied):
            rw.submit(QUERIES["Q1"][1], "slca")
    finally:
        rw.close()
        srv.close()


def test_shard_doc_stats_counts(corpus, engine):
    doc_roots = np.where(corpus.parent == 0)[0].astype(np.int64)
    vinyl, release = corpus.vocab.get("vinyl"), corpus.vocab.get("release")
    docs_k, full = shard_doc_stats(engine.base.containment, doc_roots, [release])
    assert docs_k[0] == N_RELEASES and full == N_RELEASES
    docs_k, full = shard_doc_stats(engine.base.containment, doc_roots, [release, vinyl])
    assert docs_k[0] == N_RELEASES and full == docs_k[1]


# --------------------------------------------------------------------------- #
# Replicas: hedged dispatch and failover at 2 replicas
# --------------------------------------------------------------------------- #


class FakeWorker:
    """Scriptable replica: ``delay=None`` parks forever, ``fail=`` fails."""

    def __init__(self, slot, on_death, delay=0.0, fail=None):
        self.slot, self.on_death, self.delay, self.fail = slot, on_death, delay, fail
        self.calls = 0
        self.pending: list[Future] = []

    def submit(self, keywords, semantics):
        self.calls += 1
        fut: Future = Future()
        self.pending.append(fut)

        def finish():
            if fut.cancelled():
                return
            if self.fail is not None:
                fut.set_exception(self.fail)
            else:
                fut.set_result((self.slot, tuple(keywords)))

        if self.delay == 0:
            finish()
        elif self.delay is not None:
            t = threading.Timer(self.delay, finish)
            t.daemon = True
            t.start()
        return fut

    def doc_stats(self, kw_ids):
        return self.submit([str(k) for k in kw_ids], "stats")

    def stats(self):
        return QueryStats(data={"queries": self.calls})

    def drain(self, timeout=30.0):
        pass

    def close(self, timeout=30.0):
        pass

    def die(self):
        self.on_death(self)


def make_set(spec, behaviours, **kw):
    built: list[FakeWorker] = []

    def factory(slot, on_death):
        built.append(FakeWorker(slot, on_death, **behaviours[slot % len(behaviours)]))
        return built[-1]

    return ReplicaSet(spec, factory, len(behaviours), **kw), built


def test_hedge_fires_on_stalled_replica_and_cancels_loser(spec):
    rs, built = make_set(spec, [{"delay": None}, {"delay": 0.0}], hedge_ms=20.0)
    try:
        slot, kws = rs.submit(["vinyl"], "slca").result(timeout=10)
        assert slot == 1 and kws == ("vinyl",)
        s = rs.stats().data
        assert s["hedges_fired"] == 1 and s["hedge_wins"] == 1 and s["failovers"] == 0
        assert built[0].pending[0].cancelled()
    finally:
        rs.close()


def test_failed_attempt_rolls_to_next_replica(spec):
    rs, _ = make_set(spec, [{"fail": WorkerDied(0, "shot")}, {"delay": 0.0}],
                     hedge_ms=10_000.0)
    try:
        slot, _ = rs.submit(["x"], "slca").result(timeout=10)
        assert slot == 1
        s = rs.stats().data
        assert s["failovers"] == 1 and s["hedge_wins"] == 0
    finally:
        rs.close()


def test_all_replicas_failing_surfaces_typed(spec):
    rs, _ = make_set(spec, [{"fail": WorkerDied(0, "a")}, {"fail": WorkerDied(0, "b")}],
                     hedge_ms=10_000.0)
    try:
        with pytest.raises(WorkerDied):
            rs.submit(["x"], "slca").result(timeout=10)
    finally:
        rs.close()


def test_replica_death_marks_slot_and_respawns(spec):
    rs, built = make_set(spec, [{"delay": 0.0}, {"delay": 0.0}],
                         hedge_ms=10_000.0, respawn_backoff=0.01)
    try:
        built[0].die()
        deadline = time.time() + 10
        while rs.stats().data.get("replica_respawns", 0) < 1:
            assert time.time() < deadline, rs.stats().data
            time.sleep(0.02)
        s = rs.stats().data
        assert s["replica_deaths"] == 1 and s["replicas_live"] == 2
        assert rs.replicas[0] is not built[0]
    finally:
        rs.close()


def test_process_replicas_kill_and_stall(corpus, engine):
    """2 replicas of one shard: SIGKILL one mid-stream (no client error, the
    slot respawns), then SIGSTOP one (the hedge bounds the stall)."""
    kws = QUERIES["Q1"][1]  # in every document: every query reaches the shard
    want = engine.query(kws, backend="scalar")
    with ClusterService.from_tree(corpus, 1, transport="process", replicas=2,
                                  hedge_ms=25.0, backends="torch",
                                  batch_window_ms=0.5, device="cpu") as svc:
        assert svc.pool.locality == ["replicas"]
        rs = svc.pool.workers[0]
        for i in range(12):
            if i == 4:
                os.kill(rs.replicas[0]._proc.pid, signal.SIGKILL)
            np.testing.assert_array_equal(svc.query(kws, timeout=60), want)
        deadline = time.time() + 120
        while svc.stats().data.get("replica_respawns", 0) < 1:
            assert time.time() < deadline, svc.stats().data
            time.sleep(0.25)
        pid = rs.replicas[0]._proc.pid
        os.kill(pid, signal.SIGSTOP)
        try:
            for _ in range(6):
                t0 = time.perf_counter()
                np.testing.assert_array_equal(svc.query(kws, timeout=60), want)
                assert time.perf_counter() - t0 < 5.0
        finally:
            os.kill(pid, signal.SIGCONT)
        # stats only once the stalled replica runs again (its stats RPC waits)
        assert svc.stats().data["hedge_wins"] >= 1


# --------------------------------------------------------------------------- #
# Admission
# --------------------------------------------------------------------------- #


def test_admission_sheds_typed_and_recovers(corpus, engine):
    q, other = QUERIES["Q1"][1], QUERIES["Q2"][1]  # both reach both shards
    svc = ClusterService.from_tree(corpus, 2, max_queue_per_shard=1, max_batch=64,
                                   batch_window_ms=60_000.0, device="cpu")
    try:
        first = svc.submit(q, "slca")
        with pytest.raises(Overloaded) as exc_info:  # a different query sheds
            svc.submit(other, "slca")
        assert exc_info.value.limit == 1 and 0 <= exc_info.value.shard < 2
        joined = svc.submit(q, "slca")  # the identical one coalesces
        snap = svc.stats().summary()
        assert snap["shed"] == 1 and snap["admitted"] == 1 and snap["coalesced"] == 1
    finally:
        svc.close()  # drains the parked window; the admitted query completes
    want = engine.query(q, backend="scalar")
    np.testing.assert_array_equal(first.result(timeout=120), want)
    np.testing.assert_array_equal(joined.result(timeout=120), want)
    assert svc.stats().summary()["queue_depth_per_shard"] == [0, 0]
