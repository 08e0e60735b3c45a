"""The port's workload flight recorder, replay and critical-path analysis
(``transmogrifai_tpu_torch/workload.py``) held against the JAX package's
``workload.py`` on the CPU.

Each case drives both packages through the same calls and compares what
they return: the shards both recorders write (every line but the
header's ``epochUnixS`` anchor), their merges (equal documents but the
arrival clocks, ``tS`` within 20 ms: each recorder anchors its own
clock), the tallies, ``summarize_workload``,
``analyze_trace`` and ``diff_analyses`` on the same traces, and both
packages' ``replay_workload`` driving one live port server. The server
records through the port's ``serve_http`` (accepted, refused and failed
requests), and the command line's ``workload merge | replay`` and
``trace analyze`` print what the JAX command line prints."""
import http.client
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from transmogrifai_tpu import telemetry as jtelemetry
from transmogrifai_tpu import workload as jworkload
from transmogrifai_tpu_torch import telemetry, workload
from transmogrifai_tpu_torch.server import ModelServer, serve_http

from _torch_server_data import BUCKET_CAP, tenant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jworkload, jtelemetry), "port": (workload, telemetry)}


@pytest.fixture(autouse=True)
def _clean():
    for wl, tel in PKGS.values():
        wl.stop_recorder()
        wl.reset_workload_stats()
        tel.disable()
        tel.reset()
    yield
    for wl, tel in PKGS.values():
        wl.stop_recorder()
        wl.reset_workload_stats()
        tel.disable()
        tel.reset()


#: one request's calls to ``record_request`` by the router and the worker
#: (offsets in seconds on the package's trace epoch)
def _calls(case):
    big = [{"x": float(i), "pad": "y" * 64} for i in range(1200)]
    out = []
    for i in range(8):
        t = 0.2 * i
        recs = big if (case == "digested" and i == 3) else \
            [{"x": float(i), "k": "a"}, {"x": float(-i), "k": None}]
        outs = [{"p": 0.25 * i}, {"p": 1.0}]
        tid = f"trace{i:02d}"
        router = dict(model="churn", rows=len(recs), trace_id=tid,
                      t_arrival=t, phases={"e2e": 0.004 + 0.001 * i},
                      outcome={"status": 200, "ok": True},
                      route={"worker": i % 2, "attempts": 1,
                             "failovers": 0})
        worker = dict(model="churn", rows=len(recs), trace_id=tid,
                      t_arrival=t + 0.05,
                      outcome={"status": 200, "ok": True},
                      phases={"e2e": 0.003, "queueWait": 0.001})
        if case in ("spliced", "rotated", "payloads-off"):
            worker["payload_json"] = json.dumps({"records": recs}).encode()
            worker["response_json"] = json.dumps(
                {"outputs": outs, "phases": {"deviceDispatch": 0.002}})
        else:
            worker["records"] = recs
            worker["outputs"] = outs
        out.append(("router", router))
        out.append(("worker", worker))
    # a worker-only request with no trace id, and a failed one
    out.append(("worker", dict(model="fraud", rows=1, t_arrival=2.0,
                               records=[{"x": 9.0}])))
    out.append(("worker", dict(model="fraud", rows=2, t_arrival=2.5,
                               outcome={"status": 429, "ok": False,
                                        "error": "ServerBusy"},
                               phases={"e2e": 0.0001})))
    return out


def _record(pkg, case, d):
    wl, tel = PKGS[pkg]
    kw = dict(payloads=case != "payloads-off",
              max_mb=0.001 if case == "rotated" else 64.0)
    recs = {role: wl.WorkloadRecorder(d, role=role, **kw)
            for role in ("router", "worker")}
    for role, call in _calls(case) * (20 if case == "rotated" else 1):
        call = dict(call)
        call["t_arrival"] = tel._EPOCH + call["t_arrival"]
        wl._RECORDER = recs[role]          # the process recorder's slot
        assert wl.record_request(**call)
    wl._RECORDER = None
    for r in recs.values():
        r.close()
    return recs


def _shard_lines(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        lines = [json.loads(ln) for ln in open(os.path.join(d, fn), "rb")]
        for ln in lines:
            if ln.get("kind") == "header":
                ln.pop("epochUnixS")
        out[fn] = lines
    return out


def _no_clocks(doc):
    doc = json.loads(json.dumps(doc))
    doc.pop("baseEpochUnixS", None)
    ts = [r.pop("tS") for r in doc.get("records", ())]
    return doc, ts


@pytest.mark.parametrize("case", ["spliced", "objects", "digested",
                                  "payloads-off", "rotated"])
def test_recorder_shards_and_merge_equal_the_jax_packages(case, tmp_path):
    """The JAX recorder's shard format (header, spliced or serialized
    bodies, digests over ``PAYLOAD_CAP_BYTES``, size rotation) and its
    merge (clock alignment, the router's and the worker's records of one
    trace combined): equal lines, equal merged documents but the
    clocks, equal tallies."""
    docs, tallies = {}, {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        _record(pkg, case, d)
        wl = PKGS[pkg][0]
        docs[pkg] = (_shard_lines(d), wl.merge_workload_shards(d))
        tallies[pkg] = wl.workload_stats()
    (jlines, jdoc), (plines, pdoc) = docs["jax"], docs["port"]
    assert plines == jlines
    (jd, jts), (pd, pts) = _no_clocks(jdoc), _no_clocks(pdoc)
    assert pd == jd
    assert pts == pytest.approx(jts, abs=0.02)
    assert tallies["port"] == tallies["jax"]
    if case == "rotated":
        assert len(plines) > 2 and tallies["port"]["rotations"] > 0
    if case == "digested":
        assert tallies["port"]["payloads_digested"] == 1
    combined = [r for r in pd["records"] if r.get("traceId")]
    assert combined and all(r["sources"] == ["router", "worker"]
                            for r in combined)


def _write_shard(path, role, pid, epoch, records, torn_tail=None):
    with open(path, "wb") as fh:
        fh.write(json.dumps({"kind": "header", "version": 1,
                             "role": role, "pid": pid, "segment": 0,
                             "epochUnixS": epoch}).encode() + b"\n")
        for r in records:
            fh.write(json.dumps({"kind": "request", **r},
                                separators=(",", ":")).encode() + b"\n")
        if torn_tail is not None:
            fh.write(torn_tail)


def test_torn_tails_and_unreadable_shards_merge_as_the_jax_package(
        tmp_path):
    """A torn last line is skipped and counted, a shard without a
    readable header is reported in ``mergeErrors``, and no shard at all
    raises: the JAX merge's document and tallies, exactly."""
    d = str(tmp_path / "wl")
    os.makedirs(d)
    _write_shard(os.path.join(d, "shard-router-1.workload.jsonl"),
                 "router", 1, 1000.0, [
                     {"tOffsetS": 4.0, "model": "m", "rows": 2,
                      "traceId": "tt", "outcome": {"status": 200,
                                                   "ok": True},
                      "phases": {"e2e": 0.006},
                      "route": {"worker": 0, "failovers": 0}}],
                 torn_tail=b'{"kind":"request","model":"m","ro')
    _write_shard(os.path.join(d, "shard-worker-2.workload.jsonl"),
                 "worker", 2, 900.0, [
                     {"tOffsetS": 90.0, "model": "m", "rows": 1},
                     {"tOffsetS": 104.1, "model": "m", "rows": 2,
                      "traceId": "tt", "payload": [{"x": 1.0}, {"x": 2.0}],
                      "outputs": [{"p": 0.1}, {"p": 0.9}],
                      "phases": {"e2e": 0.005, "queueWait": 0.001}}])
    with open(os.path.join(d, "shard-worker-3.workload.jsonl"), "wb") as fh:
        fh.write(b"not json at all\n")
    jdoc = jworkload.merge_workload_shards(d)
    pdoc = workload.merge_workload_shards(d)
    assert pdoc == jdoc
    assert pdoc["tornRecordsSkipped"] == 1 and len(pdoc["mergeErrors"]) == 1
    assert workload.workload_stats() == jworkload.workload_stats()
    for wl in (jworkload, workload):
        with pytest.raises(ValueError, match="no workload shards"):
            wl.merge_workload_shards(str(tmp_path / "empty"))


def test_summaries_equal_the_jax_packages(tmp_path):
    """``summarize_workload`` (per-model counts, failures and phase
    percentiles) and ``_max_numeric_delta`` (replay's parity measure) on
    the same inputs."""
    _record("port", "objects", str(tmp_path / "wl"))
    doc = workload.merge_workload_shards(str(tmp_path / "wl"))
    doc["records"].append({"tS": 0.9, "model": "m", "rows": 3,
                           "outcome": {"ok": False},
                           "phases": {"e2e": 0.5, "scatter": 0.1}})
    assert workload.summarize_workload(doc) == \
        jworkload.summarize_workload(doc)
    pairs = [([{"p": 0.1}], [{"p": 0.1 + 2e-5}]), ({"a": [1, 2]},
             {"a": [1, 2, 3]}), ({"a": True}, {"a": 1}),
             ({"a": "x"}, {"b": "x"}), ([1.0, None], [1.0, None])]
    for a, b in pairs:
        assert workload._max_numeric_delta(a, b) == \
            jworkload._max_numeric_delta(a, b)


def test_the_queue_drops_and_counts_and_never_blocks(tmp_path):
    """A full bounded queue drops the record and counts it: the JAX
    recorder's tallies and ``drop_rate`` for the same calls."""
    for pkg in PKGS:
        wl = PKGS[pkg][0]
        rec = wl.WorkloadRecorder(str(tmp_path / pkg), role="worker",
                                  queue_depth=1)
        rec._queue.put(None)               # stop the writer out of band
        rec._thread.join(timeout=10)
        assert rec.record({"kind": "request", "model": "m", "rows": 1})
        t0 = time.perf_counter()
        assert not rec.record({"kind": "request", "model": "m", "rows": 1})
        assert time.perf_counter() - t0 < 0.5
        rec._closed = True
    assert workload.workload_stats() == jworkload.workload_stats()
    assert workload.workload_stats()["drop_rate"] == 0.5


def _span(name, trace, sid, t0_us, dur_us, parent=None, links=()):
    return {"ph": "X", "name": name, "ts": t0_us, "dur": dur_us,
            "args": {"trace_id": trace, "span_id": sid,
                     "parent_span_id": parent, "links": list(links)}}


def _synthetic_trace():
    """Router → worker → dispatch across processes, a batch span that
    links a member of another trace, a same-trace child link, and a
    trace with no request root."""
    return {"traceEvents": [
        _span("fleet:route", "T0", "f0", 0, 12_000),
        _span("server:request", "T0", "w0", 1_000, 10_000, parent="f0"),
        _span("server:dispatch", "T0", "d0", 4_000, 5_000, parent="w0",
              links=["w0"]),
        _span("server:request", "T1", "r1", 0, 10_000),
        _span("score:prepare", "T1", "c1", 1_000, 2_000, parent="r1"),
        _span("server:dispatch", "T2", "b1", 4_000, 4_000, links=["r1"]),
        _span("server:request", "T3", "r3", 0, 8_000),
        _span("server:dispatch", "T3", "b3", 2_000, 6_000, parent="r3",
              links=["r3"]),
        {"ph": "M", "name": "process_name", "args": {"name": "x"}},
    ]}


def _served_trace(tenants, tmp_path):
    """A trace shard the port's server wrote for a few traced requests."""
    telemetry.enable()
    srv = ModelServer(device="cpu", bucket_cap=BUCKET_CAP,
                      batch_deadline_s=0.005)
    srv.register("A", model_dir=tenants["A"]["model_dir"],
                 bank_dir=tenants["A"]["export_dir"])
    httpd = serve_http(srv, port=0)
    try:
        for i in range(6):
            tid, sid = telemetry.mint_trace()
            _post(httpd.server_address[1], "A",
                  tenants["A"]["records"][i:i + 3],
                  {telemetry.TRACE_HEADER:
                   telemetry.format_traceparent(tid, sid)})
    finally:
        srv.shutdown(drain=True)
        httpd.shutdown()
    d = tmp_path / "traces"
    telemetry.write_trace_shard(str(d))
    telemetry.disable()
    return str(d)


@pytest.mark.parametrize("source", ["synthetic", "served-shards",
                                    "served-merged"])
def test_analyze_trace_and_diff_equal_the_jax_packages(source, tenants,
                                                       tmp_path):
    """``analyze_trace`` (self-time with link donations, coverage, the
    slowest requests' critical paths) from a document, a shard directory
    and a merged file, and ``diff_analyses`` of it against a baseline
    with one phase slower: the JAX package's results."""
    if source == "synthetic":
        src = _synthetic_trace()
    else:
        src = _served_trace(tenants, tmp_path)
        if source == "served-merged":
            out = str(tmp_path / "merged.json")
            telemetry.write_merged_trace(src, out)
            src = out
    a = workload.analyze_trace(src, top_k=3)
    assert a == jworkload.analyze_trace(src, top_k=3)
    assert a["requests"] >= 3
    base = json.loads(json.dumps(a))
    name = next(iter(base["phases"]))
    base["phases"][name]["p99Ms"] = a["phases"][name]["p99Ms"] / 3
    base["phases"]["gone"] = {"p99Ms": 1.0}
    for cur, b in ((a, base), (base, a), (a, a)):
        assert workload.diff_analyses(cur, b, abs_floor_ms=0.0) == \
            jworkload.diff_analyses(cur, b, abs_floor_ms=0.0)


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    return {"A": tenant(11, str(tmp_path_factory.mktemp("modelA")),
                        str(tmp_path_factory.mktemp("exportA")))}


def _post(port, name, records, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", f"/v1/models/{name}:score",
                     json.dumps({"records": records}),
                     {"Content-Type": "application/json",
                      **(headers or {})})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


@pytest.fixture(scope="module")
def live(tenants, tmp_path_factory):
    """A port server on the CPU behind ``serve_http``; its traffic
    recorded through the port's recorder into a merged workload."""
    srv = ModelServer(device="cpu", bucket_cap=BUCKET_CAP,
                      batch_deadline_s=0.002)
    srv.register("A", model_dir=tenants["A"]["model_dir"],
                 bank_dir=tenants["A"]["export_dir"])
    httpd = serve_http(srv, port=0)
    port = httpd.server_address[1]
    wdir = str(tmp_path_factory.mktemp("workload"))
    recs = tenants["A"]["records"]
    workload.start_recorder(wdir, role="worker")
    try:
        for i in range(12):
            assert _post(port, "A", recs[i:i + 1 + i % 4])[0] == 200
            time.sleep(0.01)
        big = [dict(recs[0], pad="z" * 200)] * 400    # over the cap
        assert _post(port, "A", big)[0] == 200
        assert _post(port, "nobody", recs[:2])[0] == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", "/v1/models/A:score", b"{not json",
                         {"Content-Type": "application/json"})
            assert conn.getresponse().status == 400
        finally:
            conn.close()
    finally:
        workload.stop_recorder()
    doc = workload.merge_workload_shards(wdir)
    yield {"port": port, "doc": doc, "dir": wdir, "server": srv}
    srv.shutdown(drain=True)
    httpd.shutdown()


def test_the_server_records_accepted_and_refused_requests(live):
    """The port's ``serve_http`` records what the JAX front end records:
    one record a ``:score`` request, spliced payload and outputs under
    the cap, a digest over it, the 404 and 400 with their outcomes, and
    phases with ``e2e``."""
    recs = live["doc"]["records"]
    assert len(recs) == 15
    ok = [r for r in recs if r["outcome"]["ok"]]
    assert len(ok) == 13
    assert all("e2e" in r["phases"] and "deviceDispatch" in r["phases"]
               for r in ok)
    assert sum("payload" in r and "outputs" in r for r in ok) == 12
    digested = [r for r in ok if "payloadDigest" in r]
    assert len(digested) == 1 and digested[0]["payloadDigest"]["rows"] \
        == 400
    bad = {r["outcome"]["status"]: r for r in recs if not r["outcome"]["ok"]}
    assert set(bad) == {404, 400}
    assert bad[404]["outcome"]["error"] == "ModelNotFound"
    assert bad[400]["outcome"]["error"] == "JSONDecodeError"
    assert set(workload.workload_stats()) == set(jworkload.workload_stats())


def _replay_fields(res):
    res = json.loads(json.dumps(res))
    for k in ("durationS", "client", "lateSends"):
        res.pop(k)
    for m in res["models"].values():
        m.pop("phases")
    return res


@pytest.mark.parametrize("cut", [{}, {"max_requests": 5},
                                 {"duration_s": 0.05}])
def test_replay_equals_the_jax_replay_with_parity(live, cut):
    """Both packages' ``replay_workload`` drive the same live server
    with the same merged workload: the same requests sent, skipped
    (digested, failed) and truncated, every parity check passing at
    delta 0."""
    url = f"http://127.0.0.1:{live['port']}"
    doc = live["doc"]
    p = workload.replay_workload(doc, url, speed=4.0, **cut)
    j = jworkload.replay_workload(doc, url, speed=4.0, **cut)
    assert _replay_fields(p) == _replay_fields(j)
    assert p["failed"] == 0 and p["parityFailures"] == 0
    assert p["parityMaxAbsDelta"] == 0.0
    assert p["parityChecked"] == p["sent"] >= 1
    assert p["skippedNoPayload"] == 1        # the digested one
    for wl in (workload, jworkload):
        with pytest.raises(ValueError):
            wl.replay_workload(doc, url, speed=0.0)


def _cli_out(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_the_workload_and_trace_analyze_commands_print_as_the_jax_ones(
        live, tenants, tmp_path, capsys):
    """``workload merge`` (and ``--strict`` over an unreadable shard),
    ``workload replay`` against the live server, and ``trace analyze``
    with a ``--baseline`` that passes and one that fails: the same exit
    codes and output as the JAX command line."""
    from transmogrifai_tpu import cli as jcli
    from transmogrifai_tpu_torch import cli as pcli
    wdir = live["dir"]
    merged = str(tmp_path / "merged.workload.json")
    url = f"http://127.0.0.1:{live['port']}"
    runs = [["workload", "merge", wdir, "-o", merged],
            ["workload", "replay", merged, "--url", url, "--speed", "8",
             "--max-requests", "4"]]
    for argv in runs:
        j = _cli_out(jcli.main, argv, capsys)
        p = _cli_out(pcli.main, argv, capsys)
        assert p[0] == j[0] == 0, (p, j)
        if argv[1] == "merge":
            assert p == j
        else:
            assert "4/13 request(s)" in p[1] and \
                "parity: 4 checked, 0 failure(s)" in p[1]
    bad = os.path.join(wdir, "shard-worker-9.workload.jsonl")
    with open(bad, "w") as fh:
        fh.write("garbage\n")
    try:
        argv = ["workload", "merge", wdir, "-o", merged, "--strict"]
        assert _cli_out(pcli.main, argv, capsys) == \
            _cli_out(jcli.main, argv, capsys)
        assert _cli_out(pcli.main, argv, capsys)[0] == 1
    finally:
        os.remove(bad)
    traces = tmp_path / "synthetic"
    traces.mkdir()
    trace = str(traces / "merged.json")
    with open(trace, "w") as fh:
        json.dump(_synthetic_trace(), fh)
    analysis = str(tmp_path / "analysis.json")
    argv = ["trace", "analyze", trace, "-o", analysis, "--top-k", "2"]
    assert _cli_out(pcli.main, argv, capsys) == \
        _cli_out(jcli.main, argv, capsys)
    assert _cli_out(pcli.main, argv + ["--baseline", analysis],
                    capsys)[0] == 0
    slower = json.load(open(analysis))
    for ph in slower["phases"].values():
        ph["p99Ms"] /= 4
    baseline = str(tmp_path / "baseline.json")
    with open(baseline, "w") as fh:
        json.dump(slower, fh)
    argv += ["--baseline", baseline]
    p, j = _cli_out(pcli.main, argv, capsys), _cli_out(jcli.main, argv,
                                                        capsys)
    assert p == j and p[0] == 1 and "regression(s)" in p[2]


def test_sigkill_mid_write_tears_one_line_and_merge_survives(tmp_path):
    """A fresh interpreter recording through the port is SIGKILLed in the
    middle of a line: the good lines merge, the torn tail is counted, and
    ``workload merge`` exits 0 (as in the JAX package)."""
    d = str(tmp_path / "wl")
    child = textwrap.dedent("""
        import os, signal, sys, time
        from transmogrifai_tpu_torch import workload
        rec = workload.start_recorder(sys.argv[1], role="worker")
        for i in range(5):
            workload.record_request("m", 1, records=[{"x": float(i)}],
                                    trace_id=f"t{i}")
        for _ in range(200):
            if workload.workload_stats()["records_written"] == 5:
                break
            time.sleep(0.05)
        else:
            sys.exit(3)
        with open(rec.shard_path, "ab") as fh:
            fh.write(b'{"kind":"request","model":"m","ro')
            fh.flush()
            os.kill(os.getpid(), signal.SIGKILL)
    """)
    proc = subprocess.run([sys.executable, "-c", child, d], cwd=ROOT,
                          capture_output=True, timeout=240)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    merged = workload.merge_workload_shards(d)
    assert merged["requests"] == 5 and merged["tornRecordsSkipped"] == 1
    from transmogrifai_tpu_torch.cli import run_workload
    assert run_workload("merge", d) == 0
