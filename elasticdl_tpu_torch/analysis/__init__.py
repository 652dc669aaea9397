"""edl-lint: project-specific static analysis for the elastic control plane.

Three rule families, each encoding a hazard class this codebase has been
bitten by (or is structurally exposed to — see ISSUE 2 / PAPERS.md:
ElasWave 2510.00606 and the multi-tenant elastic-GPU study 1909.11985 both
attribute elastic-training incidents to unchecked concurrency and
recompilation):

- lock discipline (EDL1xx): `# guarded_by: _lock` attribute annotations,
  verified so every access happens under `with self._lock` or in a method
  annotated as holding it (EDL101); plus the whole-program half built on
  the project call graph (`callgraph.py` / `concurrency.py`) — static
  lock-order inversion over interprocedurally-propagated held sets
  (EDL102, `--lock-graph` emits the acquisition graph), blocking calls
  under a lock with may-block propagation (EDL103), and guarded mutable
  state escaping its critical section as a live reference (EDL104);
- torch hazards (EDL2xx, `torch_rules.py`): host syncs in dispatch
  loops and data-dependent shapes anywhere, compile and capture churn,
  tensors escaping a captured graph, unordered iteration;
- RPC / control-plane hygiene (EDL3xx): bare stubs bypassing
  RetryingMasterStub, deadline-less RPCs, silent exception swallows,
  unjittered retry sleeps.

Run `python -m elasticdl_tpu_torch.analysis` (text or --json output; suppress a
single finding with `# edl-lint: disable=RULE`, tolerate legacy debt via
the checked-in baseline). The runtime half — the lock-order recorder used
by the chaos tests — lives in `lockorder.py`.
"""

from elasticdl_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    ModuleContext,
    ProjectContext,
    ProjectRule,
    Rule,
    all_rules,
    load_baseline,
    prune_baseline,
    run_analysis,
)
from elasticdl_tpu_torch.analysis.lockorder import (  # noqa: F401
    LockOrderRecorder,
    LockOrderViolation,
)
