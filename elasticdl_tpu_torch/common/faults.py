"""Seeded, deterministic fault injection for the elastic control plane.

The paper's elasticity claims (lease recovery, membership reaping, cohort
re-formation, checkpoint restore) are only as good as the fault schedules
they are tested under (ElasWave, arxiv 2510.00606; the multi-tenant
elastic-DL study, arxiv 1909.11985). This module lets tests and operators
*produce* those schedules on demand, reproducibly: a schedule spec plus a
seed fully determines, for every named injection point, exactly which hits
fire which faults.

Schedule spec (env `EDL_FAULTS`, seed `EDL_FAULTS_SEED`):

    site:action[@key=val[,key=val...]][;site:action@...]

    EDL_FAULTS="rpc.get_task:drop@p=0.05;ckpt.save:crash@at=3"

Sites threaded through the stack (exact-match, or a `prefix.*` wildcard):

    rpc.<method>        before each MasterStub RPC send (proto/service.py);
                        <method> is the snake_case RPC name, e.g.
                        rpc.get_task, rpc.report_task_result, rpc.heartbeat
    rpc.<method>.recv   after the server processed the call, before the
                        response reaches the caller (lost-response shape —
                        the hard case for non-idempotent RPCs)
    worker.heartbeat    each worker heartbeat-loop iteration (worker.py)
    worker.train_step.<id>
                        inside each train step's timed region (worker.py),
                        suffixed with the worker id so a schedule can slow
                        EXACTLY one worker — `worker.train_step.1:delay@
                        ms=40` makes worker 1 a deterministic straggler
                        (the cluster-health scorer's test harness); the
                        `worker.train_step.*` wildcard hits every worker
    worker.report_task  before each task-result report (worker.py)
    ckpt.save           before each checkpoint save (training/checkpoint.py)
    ckpt.save.commit    after the (async) save is initiated, before the
                        caller regains control — `crash` here dies with the
                        write in flight, probing orbax's rename-commit
                        atomicity
    ckpt.restore        before each checkpoint restore attempt
    proc.spawn          before each worker-process spawn
                        (master/process_manager.py); `drop` spawns a process
                        that exits 1 immediately instead of suppressing the
                        spawn (exercising the relaunch path)
    master_crash        each Master.wait poll iteration (master/main.py) —
                        the kill-the-master chaos site. `crash` os._exit's
                        the master process (the true SIGKILL shape when the
                        master runs in its own process); `drop` raises
                        FaultInjected out of wait() — the catchable
                        in-process flavor that client/local.py's
                        --master_restarts recovery path consumes: the master
                        is crashed abruptly and rebuilt on the same port,
                        replaying the control-plane journal
                        (master/journal.py) under a bumped generation
    emb.pull / emb.push / emb.fetch_shard / emb.fetch_delta /
    emb.watermark       REQUEST-side embedding data-plane sites, fired
                        before the owner serves (embedding/transport.py
                        LocalTransport and embedding/data_plane.py
                        GrpcTransport fire identical sites, so one chaos
                        schedule drives either transport)
    emb.pull.recv / emb.push.recv / emb.fetch_shard.recv /
    emb.fetch_delta.recv
                        RESPONSE-side twins, fired after the owner
                        applied/served but before the caller sees the
                        reply — `drop` here is the lost-ack shape: the
                        push LANDED, the caller re-sends under the same
                        seq, and the store's exactly-once fence must
                        absorb the duplicate (pinned over both
                        transports)
    metrics_scrape      each /metrics//healthz HTTP request
                        (observability/http.py). Scraping is strictly
                        best-effort, so the terminal actions are remapped
                        at the site: `drop` aborts the connection with no
                        response; `crash` kills the ENDPOINT (the HTTP
                        server shuts down — NOT the process; training must
                        never die, or even stall, because a scraper did)

Actions:

    drop            raise FaultInjected at the injection point
    delay           sleep `ms` milliseconds (default 100), then continue
    crash           flush the fault trace and os._exit(`code`) (default 1) —
                    the hard-kill shape; nothing downstream runs

Triggers (combinable; a rule fires only when every given trigger agrees):

    p=<float>       fire each hit with this probability, drawn from a
                    per-rule RNG seeded by (seed, site, action) — the same
                    seed + spec reproduces the same decision sequence
    at=<n>          fire exactly on the n-th hit of the site (1-based);
                    `step=` is an accepted alias
    every=<k>       fire every k-th hit
    max=<m>         stop firing after m injections from this rule

With `EDL_FAULTS` unset (the default) every `fire()` call is a two-load
no-op; nothing in this module touches the hot path.

`EDL_FAULTS_TRACE=<path>` appends one line per injected fault
("site:action#hit") at process exit (and before a `crash` exits), so
cross-run determinism is assertable from outside the process.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from dataclasses import dataclass, field
from random import Random
from typing import Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import default_logger

logger = default_logger(__name__)

FAULTS_ENV = "EDL_FAULTS"
SEED_ENV = "EDL_FAULTS_SEED"
TRACE_ENV = "EDL_FAULTS_TRACE"

ACTIONS = ("drop", "delay", "crash")

#: pre-crash hooks: called (with the firing site) immediately before a
#: `crash` action's os._exit — which skips atexit, so this is the ONLY
#: chance for a black box (the flight recorder) to hit disk. Process-
#: lifetime: reset()/uninstall() leave them installed. A raising hook is
#: swallowed; the crash must proceed (that is the injected contract).
_CRASH_HOOKS: List = []


def add_crash_hook(fn) -> None:
    """Register `fn(site)` to run before a `crash` action kills the
    process (observability/flight.py wires its bundle dump here)."""
    if fn not in _CRASH_HOOKS:
        _CRASH_HOOKS.append(fn)


def remove_crash_hook(fn) -> None:
    if fn in _CRASH_HOOKS:
        _CRASH_HOOKS.remove(fn)


def _run_crash_hooks(site: str) -> None:
    for hook in list(_CRASH_HOOKS):
        try:
            hook(site)
        except Exception:
            # the simulated kill must happen regardless:
            # edl-lint: disable=EDL303
            logger.exception("pre-crash hook %r failed (ignored)", hook)

# trigger aliases accepted in specs (issue/operator shorthand)
_PARAM_ALIASES = {"step": "at"}
_KNOWN_PARAMS = {"p", "at", "every", "max", "ms", "code"}


class FaultInjected(Exception):
    """Raised at an injection point whose rule decided `drop`."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at {site} (hit {hit})")
        self.site = site
        self.hit = hit


@dataclass
class FaultRule:
    """One `site:action@params` entry of a schedule.

    RNG streams and fire counters are kept PER CONCRETE MATCHED SITE (not
    per rule): a wildcard rule like `rpc.*:drop@p=0.5` would otherwise
    interleave one shared RNG across whichever sites happen to hit first —
    thread scheduling would change the decision sequence and break the
    same-seed reproducibility contract. `max=` likewise caps fires per
    matched site.
    """

    site: str
    action: str
    params: Dict[str, float]
    seed: int = 0
    _rngs: Dict[str, Random] = field(
        repr=False, compare=False, default_factory=dict)
    _fires: Dict[str, int] = field(compare=False, default_factory=dict)

    def matches(self, site: str) -> bool:
        if self.site.endswith(".*"):
            return site.startswith(self.site[:-1]) or site == self.site[:-2]
        return site == self.site

    def decide(self, site: str, hit: int) -> bool:
        """Pure function of (per-site rule state, hit number): fire?

        The per-site RNG is only consumed when a `p` trigger exists and
        the deterministic triggers already agree, so the decision stream
        for a given (seed, site, action) never depends on other rules or
        other sites.
        """
        fires = self._fires.get(site, 0)
        if "max" in self.params and fires >= int(self.params["max"]):
            return False
        if "at" in self.params and hit != int(self.params["at"]):
            return False
        if "every" in self.params and hit % int(self.params["every"]) != 0:
            return False
        if "p" in self.params:
            rng = self._rngs.get(site)
            if rng is None:
                # a string seed makes Random deterministic across processes
                rng = Random(f"{self.seed}:{site}:{self.action}")
                self._rngs[site] = rng
            if rng.random() >= self.params["p"]:
                return False
        self._fires[site] = fires + 1
        return True


@dataclass(frozen=True)
class Fired:
    """A rule firing at a concrete site, with the hit number captured
    under the injector lock (reading the counter later would race)."""

    rule: FaultRule
    site: str
    hit: int

    @property
    def action(self) -> str:
        return self.rule.action

    @property
    def params(self) -> Dict[str, float]:
        return self.rule.params


def parse_spec(spec: str, seed: int = 0) -> List[FaultRule]:
    """Parse an `EDL_FAULTS` schedule into rules (raises ValueError loudly —
    a silently-ignored typo'd schedule would report a vacuous green soak)."""
    rules: List[FaultRule] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, _, paramstr = entry.partition("@")
        site, sep, action = head.rpartition(":")
        if not sep or not site:
            raise ValueError(
                f"malformed fault entry {entry!r}: want site:action[@k=v,...]"
            )
        site, action = site.strip(), action.strip()
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} in {entry!r}; "
                f"choose from {ACTIONS}"
            )
        params: Dict[str, float] = {}
        for kv in filter(None, (s.strip() for s in paramstr.split(","))):
            if "=" not in kv:
                raise ValueError(f"malformed fault param {kv!r} in {entry!r}")
            k, v = kv.split("=", 1)
            k = _PARAM_ALIASES.get(k.strip(), k.strip())
            if k not in _KNOWN_PARAMS:
                raise ValueError(
                    f"unknown fault param {k!r} in {entry!r}; "
                    f"known: {sorted(_KNOWN_PARAMS)}"
                )
            val = float(v)
            # range-check at parse time — a typo'd trigger must fail HERE,
            # loudly, not crash at the injection site (every=0 ->
            # ZeroDivisionError masquerading as a network failure) or
            # silently never fire (p=0, at=0: a vacuous green soak)
            if k == "p" and not 0.0 < val <= 1.0:
                raise ValueError(f"p must be in (0, 1], got {v!r} in {entry!r}")
            if k in ("at", "every", "max") and val < 1:
                raise ValueError(f"{k} must be >= 1, got {v!r} in {entry!r}")
            if k in ("at", "every", "max") and val != int(val):
                # decide() would int()-truncate silently — the same
                # reinterpreted-typo class the checks above reject
                raise ValueError(
                    f"{k} must be an integer, got {v!r} in {entry!r}"
                )
            if k == "ms" and val < 0:
                raise ValueError(f"ms must be >= 0, got {v!r} in {entry!r}")
            params[k] = val
        rules.append(
            FaultRule(site=site, action=action, params=params, seed=seed)
        )
    return rules


class FaultInjector:
    """Holds a parsed schedule and per-site hit counters; thread-safe."""

    def __init__(
        self,
        rules: List[FaultRule],
        seed: int = 0,
        trace_path: Optional[str] = None,
    ):
        self.rules = rules
        self.seed = seed
        # appended under the lock (check); read lock-free by flush_trace
        # (atexit / pre-crash: single-threaded by then) and by tests after
        # the run — a deliberate publication point, not a race
        self.trace: List[str] = []
        self._trace_path = trace_path
        self._hits: Dict[str, int] = {}      # guarded_by: _lock
        self._lock = threading.Lock()
        self._trace_flushed = False
        if trace_path:
            atexit.register(self.flush_trace)

    @classmethod
    def from_spec(
        cls, spec: str, seed: int = 0, trace_path: Optional[str] = None
    ) -> "FaultInjector":
        return cls(parse_spec(spec, seed), seed=seed, trace_path=trace_path)

    # ------------------------------------------------------------------ #

    def check(self, site: str) -> Optional[Fired]:
        """Count a hit at `site` and return the firing, if any.

        Extension point for call sites needing custom handling of terminal
        actions; everything in-tree goes through fire().
        """
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for rule in self.rules:
                if rule.matches(site) and rule.decide(site, hit):
                    self.trace.append(f"{site}:{rule.action}#{hit}")
                    logger.warning(
                        "FAULT INJECTED: %s -> %s (hit %d)",
                        site, rule.action, hit,
                    )
                    return Fired(rule=rule, site=site, hit=hit)
        return None

    def fire(self, site: str) -> None:
        """Inject at `site`: no-op, sleep, raise, or kill the process."""
        fired = self.check(site)
        if fired is None:
            return
        if fired.action == "delay":
            # the injected stall IS the fault being simulated — callers
            # holding locks across fire() is exactly the stall-under-lock
            # behavior chaos legs exist to exercise:
            # edl-lint: disable=EDL103
            time.sleep(fired.params.get("ms", 100.0) / 1000.0)
        elif fired.action == "drop":
            raise FaultInjected(site, fired.hit)
        elif fired.action == "crash":
            # black-box dumps first (os._exit skips atexit and excepthook:
            # the flight recorder would otherwise die with its evidence)
            _run_crash_hooks(site)
            self.flush_trace()
            os._exit(int(fired.params.get("code", 1)))

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def flush_trace(self) -> None:
        """Append the trace to `trace_path` once (idempotent; also runs via
        atexit, and explicitly before a `crash` action's os._exit, which
        would skip atexit handlers)."""
        if not self._trace_path or self._trace_flushed:
            return
        self._trace_flushed = True
        try:
            # last-gasp evidence dump on the atexit / pre-os._exit crash
            # path — the process is dying, nothing queues behind it:
            # edl-lint: disable=EDL103
            with open(self._trace_path, "a") as f:
                for line in self.trace:
                    f.write(line + "\n")
        except OSError:
            logger.exception("fault trace flush to %s failed", self._trace_path)


# ---------------------------------------------------------------------- #
# module-level singleton (lazily initialized from the environment)

_injector: Optional[FaultInjector] = None
_initialized = False
_init_lock = threading.Lock()


def get_injector() -> Optional[FaultInjector]:
    global _injector, _initialized
    if not _initialized:
        with _init_lock:
            if not _initialized:
                spec = os.environ.get(FAULTS_ENV, "")
                if spec:
                    _injector = FaultInjector.from_spec(
                        spec,
                        seed=int(os.environ.get(SEED_ENV, "0") or 0),
                        trace_path=os.environ.get(TRACE_ENV) or None,
                    )
                    logger.warning(
                        "fault injection ACTIVE: %d rule(s) from %s (seed %s)",
                        len(_injector.rules), FAULTS_ENV, _injector.seed,
                    )
                _initialized = True
    return _injector


def install(
    spec: str, seed: int = 0, trace_path: Optional[str] = None
) -> FaultInjector:
    """Install a schedule programmatically (tests); replaces any active one."""
    global _injector, _initialized
    with _init_lock:
        _injector = FaultInjector.from_spec(spec, seed, trace_path)
        _initialized = True
    return _injector


def uninstall() -> None:
    """Disable injection for this process (does not re-read the env)."""
    global _injector, _initialized
    with _init_lock:
        _injector = None
        _initialized = True


def reset() -> None:
    """Forget everything; the next fire() re-reads the environment."""
    global _injector, _initialized
    with _init_lock:
        _injector = None
        _initialized = False


def fire(site: str) -> None:
    """The injection point. A cheap no-op when no schedule is active."""
    inj = _injector if _initialized else get_injector()
    if inj is not None:
        inj.fire(site)


def check(site: str) -> Optional[Fired]:
    """Like fire(), but returns the firing for call-site-custom handling
    instead of acting (still counts the hit and records the trace).
    `delay` rules are slept here so custom sites only need to branch on
    terminal actions."""
    inj = _injector if _initialized else get_injector()
    if inj is None:
        return None
    fired = inj.check(site)
    if fired is not None and fired.action == "delay":
        time.sleep(fired.params.get("ms", 100.0) / 1000.0)
    return fired
