"""Protocol-faithful fleet simulator (ISSUE 16; ROADMAP 6).

Thousands of scripted per-worker lifecycles — register → heartbeat /
member-beats → lease batches → report → die/rejoin, with honest stats
payloads — driven against the REAL master control plane: real journal
with group-commit, real membership, real dispatcher, real alert engine,
real autoscaler behind a simulator-backed scale target. Scenarios are
data, not code (scenario.py): a seeded, replayable JSON schedule over
compressed virtual time, interpreted by a deterministic single-threaded
scheduler (sim.py).

Entry points: ``python -m elasticdl_tpu_torch.fleetsim <scenario.json>`` and
``bench.py fleet_soak``. See docs/soak.md.
"""

from elasticdl_tpu_torch.fleetsim.scenario import (  # noqa: F401
    Scenario, load_scenario, builtin_scenario_path, builtin_scenarios,
)
from elasticdl_tpu_torch.fleetsim.sim import FleetSim, SimRpcError  # noqa: F401
