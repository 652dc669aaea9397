"""The port's tools (`fleetsim`, `data/convert.py`, the `incident` and
`analyze` CLIs) against the reference's.

- One builtin fleetsim scenario (`straggler_wave`: 64 workers, 600
  virtual seconds, the autoscaler; ~3-4 s of wall each) with its seed
  gives the same event-log digest, journal accounting and replay from
  `elasticdl_tpu.fleetsim` and `elasticdl_tpu_torch.fleetsim`, both with
  `EDL_EMB_TIER_DEVICE=0` (host-mode stores, as the reference's are off a
  TPU). The digest hashes virtual offsets and events, no package name.
  The port's soak records a cycle-free lock order whose every edge is in
  the port's static EDL102 graph (runtime within static).
- `convert_url("synthetic://criteo?...")` from both packages writes
  byte-equal `.rio` shards, and the port's reader reads back the records
  the synthetic reader made.
- A flight bundle per role (master, worker-0) and their traces, written
  by the port's own `observability/flight` and `tracing`, give the same
  `--json` report from both packages' `incident` and `analyze`, and
  `incident --strict` exits 0.
"""

import contextlib
import io
import json
import os
import tempfile

ENV_HOST_STORES = {"EDL_EMB_TIER_DEVICE": "0"}
SCENARIO = "straggler_wave"


@contextlib.contextmanager
def environ(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def soak(fleetsim, sim, workdir):
    sc = fleetsim.load_scenario(fleetsim.builtin_scenario_path(SCENARIO))
    return sim.run_scenario(sc, workdir)


def case_fleetsim_digest_and_lock_order(tmp):
    import elasticdl_tpu_torch
    from elasticdl_tpu import fleetsim as ref_fleetsim
    from elasticdl_tpu.fleetsim import sim as ref_sim
    from elasticdl_tpu_torch import fleetsim as port_fleetsim
    from elasticdl_tpu_torch.analysis.concurrency import build_lock_graph
    from elasticdl_tpu_torch.analysis.core import (
        ModuleContext, ProjectContext, iter_python_files,
    )
    from elasticdl_tpu_torch.fleetsim import sim as port_sim

    with environ(**ENV_HOST_STORES):
        want = soak(ref_fleetsim, ref_sim, os.path.join(tmp, "ref"))
        got = soak(port_fleetsim, port_sim, os.path.join(tmp, "port"))
    assert got["event_log_digest"] == want["event_log_digest"]
    assert got["event_log_entries"] == want["event_log_entries"] > 0
    for key in ("tasks", "acked_training_reports", "lost_acked_leases",
                "autoscale", "replay"):
        assert got[key] == want[key], key
    assert got["replay"]["identical"] and got["lost_acked_leases"] == 0

    assert got["lock_order"]["violations"] == 0
    runtime = {tuple(e) for e in got["lock_order"]["edges"]}
    assert any(b.startswith("journal.") for _, b in runtime), runtime
    pkg = os.path.dirname(elasticdl_tpu_torch.__file__)
    contexts = []
    for abs_path, rel in iter_python_files([pkg]):
        with open(abs_path, encoding="utf-8") as f:
            contexts.append(ModuleContext(abs_path, f.read(), rel))
    graph = build_lock_graph(ProjectContext(contexts))
    static = {(e["from"], e["to"]) for e in graph["edges"]}
    assert runtime <= static, sorted(runtime - static)


def case_convert_writes_the_reference_shards(tmp):
    from elasticdl_tpu.data import convert as ref_convert
    from elasticdl_tpu_torch.data import convert as port_convert
    from elasticdl_tpu_torch.data.reader import create_data_reader

    url = "synthetic://criteo?n=1500&shards=3"
    want = ref_convert.convert_url(url, os.path.join(tmp, "ref"), 400)
    got = port_convert.convert_url(url, os.path.join(tmp, "port"), 400)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        [f"part-{i:05d}.rio" for i in range(4)]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a

    def records(reader):
        return [r for shard in reader.create_shards()
                for r in reader.read_records(*shard)]

    back = records(create_data_reader(os.path.join(tmp, "port")))
    made = records(create_data_reader(url))
    assert len(made) == 1500 and back == made


def write_port_evidence(root):
    """Two roles' flight bundles and traces from the port's recorder and
    tracer: a rescale trace (settle, handoff, compile), a worker's
    reconnect and a crash on one timeline."""
    from elasticdl_tpu_torch.observability import flight, tracing

    tracer = tracing.get_tracer()
    trace_id = tracing.new_trace_id()
    for role, parts in (("master", ("settle", "handoff")),
                        ("worker-0", ("compile",))):
        rec = flight.FlightRecorder(role=role)
        rec.configure(dir=os.path.join(root, "flight"), role=role,
                      job="tools-test")
        path = os.path.join(root, "trace", role, "trace.jsonl")
        with tracer.scoped(path=path, role=role, world_version=3):
            rec.attach_tracing()
            try:
                with tracer.span("rescale", trace_id=trace_id, role=role):
                    for name in parts:
                        with tracer.span(f"rescale.{name}", role=role):
                            pass
                tracer.event("worker.reconnect" if role != "master"
                             else "master.crash", role=role)
            finally:
                rec.detach_tracing()
        rec.record("log", "step", msg=f"{role} evidence written")
        assert rec.dump("test") is not None


def run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def case_incident_and_analyze_agree(tmp):
    from elasticdl_tpu.observability import analyze as ref_analyze
    from elasticdl_tpu.observability import incident as ref_incident
    from elasticdl_tpu_torch.observability import analyze as port_analyze
    from elasticdl_tpu_torch.observability import incident as port_incident

    write_port_evidence(tmp)
    for argv in ([tmp, "--json"], [os.path.join(tmp, "flight"), "--json"]):
        rc_ref, want = run_cli(ref_incident.main, argv)
        rc_port, got = run_cli(port_incident.main, argv)
        assert rc_port == rc_ref == 0
        report = json.loads(got)
        assert report == json.loads(want)
        assert {b["role"] for b in report["bundles"]} == {"master", "worker-0"}
        names = [e["name"] for e in report["timeline"]]
        assert "master.crash" in names and "worker.reconnect" in names
    assert run_cli(port_incident.main, [tmp, "--strict"])[0] == 0

    argv = [os.path.join(tmp, "trace"), "--json", "--strict"]
    rc_ref, want = run_cli(ref_analyze.main, argv)
    rc_port, got = run_cli(port_analyze.main, argv)
    assert rc_port == rc_ref == 0
    report = json.loads(got)
    assert report == json.loads(want)
    assert report["records"] > 0


def test_port_tools_match_the_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, case in (("fleetsim", case_fleetsim_digest_and_lock_order),
                           ("convert", case_convert_writes_the_reference_shards),
                           ("incident", case_incident_and_analyze_agree)):
            os.makedirs(os.path.join(tmp, name))
            case(os.path.join(tmp, name))
