"""The closed-loop autoscaler over the port's control plane, against the
reference's: the twins of the tests of `tests/test_autoscaler.py` that
touch code the port owns.

The policy (`master/autoscaler.py`) is a copy that
`tests/test_torch_copies.py` holds to the reference's text, so its own
tests need no twin. What is the port's: the process manager it acts on,
the servicer whose heartbeat carries the evict bit, the membership and
health records it reads, and the journal that replays its decisions.
Each case runs one scenario twice, over the reference's modules and over
the port's, and asserts the reference test's assertions on both and that
the two outcomes are equal:

- `ProcessManagerTarget` over a real (not started) `ProcessManager`
  (reference 489, 514, 539, 553): a plain worker's eviction arms the
  servicer's drain handshake and marks the slot evicted and
  never-relaunch; a plain training fleet's `grow` suppresses as
  `unsupported` before any budget is spent (and an evaluation fleet's is
  supported); a plain `shrink` evicts the newest alive worker through the
  same handshake; a cohort's `evict` is a drain-first `remove_worker`
  (world 4 -> 3) and its `grow` an `add_worker`;
- `ProcessManager.all_failed` skips a policy-evicted slot (562);
- the servicer's evict bit rides the heartbeat, sticks until the worker
  dies and is pruned then (605);
- a straggler onset through `ClusterHealth` drives an `evict` of that
  worker (375);
- applied and suppressed decisions are journaled, replay identically,
  and a successor inherits the cooldown (271).
"""

import json
import time
import types
from dataclasses import asdict


def modules(root):
    """The modules a scenario uses, from `root` ("elasticdl_tpu" or
    "elasticdl_tpu_torch")."""
    import importlib

    names = {
        "autoscaler": "master.autoscaler", "journal": "master.journal",
        "pm": "master.process_manager", "servicer": "master.servicer",
        "membership": "master.membership",
        "dispatcher": "master.task_dispatcher", "health": "observability.health",
        "config": "common.config", "constants": "common.constants",
        "pb": "proto.elasticdl_tpu_pb2",
    }
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}") for k, v in names.items()})


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class FakeProc:
    def __init__(self, code=None):
        self.code = code

    def poll(self):
        return self.code


class FakeTarget:
    def __init__(self, world=4):
        self.world, self.calls = world, []

    def world_size(self):
        return self.world

    def evict(self, worker_id, worker_name=""):
        self.calls.append(("evict", worker_id))
        self.world -= 1
        return True


def make(m, clock, target=None, journal=None, **kw):
    kw.setdefault("cooldown_s", 60.0)
    kw.setdefault("hold_s", 0.0)
    kw.setdefault("action_budget", 4)
    kw.setdefault("cost_model", m.autoscaler.CostModel(
        rescale_cost_s=1.0, horizon_s=300.0))
    a = m.autoscaler.Autoscaler(journal=journal, clock=clock, **kw)
    if target is not None:
        a.bind_target(target)
    return a


def straggler_info(wid=3, p50=0.050, med=0.005):
    return {"worker_id": wid, "worker_name": f"w{wid}", "score": 12.0,
            "step_time_p50_s": p50, "median_step_time_s": med}


def manager(m, tmp, job_type=None, num_workers=3, num_processes=1, procs=()):
    """A real, not started ProcessManager with `procs` ids holding live
    fake processes."""
    kw = {"job_type": job_type} if job_type else {}
    cfg = m.config.JobConfig(model_def="m.f", num_workers=num_workers,
                             num_processes=num_processes, **kw)
    mgr = m.pm.ProcessManager(cfg, membership_signal_path="")
    for wid in procs:
        mgr._procs[wid] = m.pm._WorkerProc(worker_id=wid, proc=FakeProc())
    return mgr


def control_plane(m, names):
    """A dispatcher, membership and servicer, with `names` registered."""
    dispatcher = m.dispatcher.TaskDispatcher(
        training_shards=[("s", 0, 64)], records_per_task=64, shuffle=False)
    membership = m.membership.Membership(heartbeat_timeout_s=60.0)
    servicer = m.servicer.MasterServicer(dispatcher, membership)
    membership.add_death_callback(servicer.clear_evict)
    ids = [membership.register(n).worker_id for n in names]
    return servicer, membership, ids


def decision(snap):
    """A decision record without its clock readings."""
    last = dict(snap["last_decision"] or {})
    for k in ("ts", "t", "trace_id"):
        last.pop(k, None)
    return last


# ---------------------------------------------------------------- cases


def scenario_targets(m, tmp):
    out = {}
    # 489: the plain worker's eviction is the drain handshake
    servicer, membership, ids = control_plane(m, ["w0", "w1", "w2"])
    mgr = manager(m, tmp, procs=ids)
    t = m.autoscaler.ProcessManagerTarget(mgr, servicer=servicer,
                                          membership=membership)
    assert t.evict(2, "worker-2") is True
    wp = mgr._procs[2]
    out["evict"] = (servicer.evict_pending(2), wp.evicted, wp.no_relaunch,
                    [servicer.evict_pending(w) for w in (0, 1)])
    assert out["evict"] == (True, True, True, [False, False])
    # an exited worker cannot be evicted twice
    wp.proc.code = 75
    assert mgr.evict_worker(2) is False
    # 539: a plain shrink evicts the newest alive worker
    servicer, membership, ids = control_plane(m, ["w0", "w1", "w2"])
    mgr = manager(m, tmp, procs=ids)
    t = m.autoscaler.ProcessManagerTarget(mgr, servicer=servicer,
                                          membership=membership)
    assert t.supports("shrink") is True and t.shrink() is True
    out["shrink"] = ([w for w in ids if servicer.evict_pending(w)],
                     [w for w in ids if mgr._procs[w].evicted])
    assert out["shrink"] == ([2], [2])
    # 514: growing a plain training fleet suppresses before the budget
    JobType = m.constants.JobType
    servicer, membership, ids = control_plane(m, ["w0"])
    mgr = manager(m, tmp, job_type=JobType.TRAINING_WITH_EVALUATION,
                  num_workers=1, procs=ids)
    t = m.autoscaler.ProcessManagerTarget(mgr, membership=membership)
    assert t.supports("grow") is False and t.supports("evict") is True
    a = make(m, Clock(), t)
    a._on_alert({"rule": "dispatcher_backlog_per_worker", "value": 100.0,
                 "threshold": 64.0})
    assert a.evaluate() is None
    snap = a.snapshot()
    assert snap["last_decision"]["suppress_reason"] == "unsupported"
    assert snap["actions_applied"] == 0
    assert snap["budget_remaining"] == a.action_budget
    out["grow"] = decision(snap)
    mgr.cfg.job_type = JobType.EVALUATION_ONLY
    assert t.supports("grow") is True
    # 553: a cohort's eviction is the drain-first resize
    mgr = manager(m, tmp, num_workers=1, num_processes=4)
    t = m.autoscaler.ProcessManagerTarget(mgr, servicer=servicer)
    assert t.world_size() == 4
    assert t.evict(0, "cohort#p2") is True
    sizes = [t.world_size()]
    assert t.grow() is True
    sizes.append(t.world_size())
    out["cohort"] = sizes
    assert sizes == [3, 4]
    return out


def scenario_all_failed(m, tmp):
    PodStatus = m.constants.PodStatus
    mgr = manager(m, tmp, num_workers=2)
    mgr._procs[0] = m.pm._WorkerProc(worker_id=0, proc=FakeProc(75),
                                     status=PodStatus.DELETED, evicted=True)
    mgr._procs[1] = m.pm._WorkerProc(worker_id=1, proc=FakeProc(75),
                                     status=PodStatus.FAILED)
    got = [mgr.all_failed()]
    mgr._procs[1].status = PodStatus.SUCCEEDED
    got.append(mgr.all_failed())
    mgr._procs[1].status = PodStatus.FAILED
    mgr._procs[2] = m.pm._WorkerProc(worker_id=2, proc=FakeProc(),
                                     status=PodStatus.RUNNING)
    got.append(mgr.all_failed())
    assert got == [True, False, False]
    return got


def scenario_evict_bit(m, tmp):
    pb = m.pb
    servicer, membership, (wid,) = control_plane(m, ["w0"])
    bits = [servicer.Heartbeat(pb.HeartbeatRequest(worker_id=wid), None).evict]
    servicer.request_evict(wid)
    for _ in range(2):    # sticky: a dropped response must not lose it
        bits.append(servicer.Heartbeat(
            pb.HeartbeatRequest(worker_id=wid), None).evict)
    membership.mark_dead(wid, reason="evicted")
    bits.append(servicer.evict_pending(wid))
    assert bits == [False, True, True, False]
    return bits


def scenario_straggler_drives_evict(m, tmp):
    now = time.time()

    class Stub:
        def health_snapshot(self):
            return [{"worker_id": w, "name": f"w{w}", "step_p50_ms": p,
                     "updated_at": now}
                    for w, p in ((0, 5.0), (1, 5.0), (2, 60.0))]

    health = m.health.ClusterHealth(Stub(), min_workers=3)
    target = FakeTarget(world=3)
    a = make(m, Clock(), target).subscribe(health=health)
    health.update(now)
    d = a.evaluate()
    assert d is not None and d["kind"] == "evict" and d["worker_id"] == 2
    assert target.calls == [("evict", 2)]
    return {k: d[k] for k in ("kind", "worker_id", "gain_s", "cost_s")}


def scenario_journal_replay(m, tmp):
    clock = Clock()
    journal = m.journal.ControlPlaneJournal(str(tmp))
    a = make(m, clock, FakeTarget(world=4), journal=journal, cooldown_s=500.0)
    a._on_straggler(straggler_info(wid=7))
    assert a.evaluate() is not None
    clock.advance(5)
    a._on_straggler(straggler_info(wid=8))
    assert a.evaluate() is None
    for _ in range(5):    # suppressions are edge-triggered
        a.evaluate()
    journal.close()
    with open(journal.path, encoding="utf-8") as f:
        lines = f.readlines()
    auto = [r for r in map(json.loads, lines) if r.get("t") == "autoscale"]
    assert [r["decision"] for r in auto] == ["applied", "suppressed"]
    assert auto[0]["kind"] == "evict" and auto[0]["worker_id"] == 7
    assert auto[1]["suppress_reason"] == "cooldown"
    ra, rb = (m.journal.replay_lines(lines).autoscale for _ in range(2))
    assert asdict(ra) == asdict(rb) and ra.by_kind == {"evict": 1}
    # the successor inherits the cooldown and does not re-fire
    successor = m.journal.ControlPlaneJournal(str(tmp))
    target = FakeTarget(world=4)
    restored = make(m, clock, target, journal=successor, cooldown_s=500.0)
    restored._on_straggler(straggler_info(wid=9))
    assert restored.evaluate() is None and target.calls == []
    clock.advance(1000)
    assert restored.evaluate() is not None
    successor.close()
    return [{k: r[k] for k in ("decision", "kind", "worker_id",
                               "suppress_reason") if k in r} for r in auto]


SCENARIOS = (scenario_targets, scenario_all_failed, scenario_evict_bit,
             scenario_straggler_drives_evict, scenario_journal_replay)


def test_autoscaler_over_the_port_against_the_reference(tmp_path):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    ref, port = modules("elasticdl_tpu"), modules("elasticdl_tpu_torch")
    for scenario in SCENARIOS:
        name = scenario.__name__
        want = scenario(ref, tmp_path / "ref" / name)
        got = scenario(port, tmp_path / "port" / name)
        assert got == want, (name, got, want)
