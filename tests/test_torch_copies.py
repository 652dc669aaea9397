"""The modules the port copies from the reference are the reference's text.

The port keeps its own copies of the jax-free modules it needs (it
imports nothing of `elasticdl_tpu`). A copy is the reference file with
two mechanical substitutions and nothing else changed:

- in import lines, the package `elasticdl_tpu` becomes
  `elasticdl_tpu_torch`;
- the string literal "elasticdl_tpu", the name of the package's root
  logger (`common/log_utils.py`, `observability/flight.py`), becomes
  "elasticdl_tpu_torch", so the port's loggers, which are named after
  its modules, sit under the root that `default_logger` configures.

Non-Python files (the proto, the C++ parser sources) are byte copies.
`master/process_manager.py` is ported by one more substitution, its spawn
target (`elasticdl_tpu.worker.main` becomes `elasticdl_tpu_torch.worker.
main`); its resize probe's import of the checkpoint manager is an import
line. `embedding/tier.py` is ported by the named substitutions of
`TIER_SUBSTITUTIONS`: the runtime's and the session's `device=`, and the
session's `_grad_fn`, a cached callable over torch autograd. The tools
(`analysis/`, `fleetsim/`, the `analyze` and `incident` CLIs) name the
port's module where their texts say what to run; edl-lint takes its
EDL2xx family from `torch_rules.py`, reads the port's own baseline, and
its path-scoped rules name the port's files. Every file is compared
exactly after the substitutions.
"""

import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "elasticdl_tpu", REPO / "elasticdl_tpu_torch"

COPIED = (
    "version.py", "api/callbacks.py",
    "common/config.py", "common/constants.py", "common/faults.py",
    "common/log_utils.py", "common/membership_signal.py",
    "common/model_utils.py", "common/net.py",
    "proto/__init__.py", "proto/elasticdl_tpu.proto",
    "proto/elasticdl_tpu_pb2.py", "proto/gen_pb2.py", "proto/service.py",
    "observability/__init__.py", "observability/alerts.py",
    "observability/flight.py", "observability/goodput.py",
    "observability/health.py", "observability/hooks.py",
    "observability/http.py", "observability/profile.py",
    "observability/registry.py", "observability/reqtrace.py",
    "observability/timeseries.py", "observability/tracing.py",
    "data/__init__.py", "data/parsing.py", "data/reader.py",
    "data/recordio.py", "data/native/CMakeLists.txt",
    "data/native/batch_parse.cc", "data/native/recordio.cc",
    "worker/__init__.py", "worker/task_data_service.py",
    "master/__init__.py", "master/evaluation_service.py",
    "master/journal.py", "master/membership.py", "master/poll_phases.py",
    "master/servicer.py", "master/summary_service.py",
    "master/task_dispatcher.py",
    "master/layout_controller.py", "master/autoscaler.py",
    "master/k8s_instance_manager.py",
    "embedding/__init__.py", "embedding/cache.py",
    "embedding/data_plane.py", "embedding/reshard.py",
    "embedding/sharding.py", "embedding/shm.py", "embedding/sketch.py",
    "embedding/transport.py",
    # the tooling (ROADMAP items 26 and 30)
    "data/convert.py", "fleetsim/scenario.py",
    "fleetsim/scenarios/master_failover.json",
    "fleetsim/scenarios/noisy_signal.json",
    "fleetsim/scenarios/popularity_flip.json",
    "fleetsim/scenarios/rack_failure.json",
    "fleetsim/scenarios/rolling_restart.json",
    "fleetsim/scenarios/slow_joiner_herd.json",
    "fleetsim/scenarios/straggler_wave.json",
    "analysis/callgraph.py", "analysis/concurrency.py",
    "analysis/lockorder.py", "analysis/locks.py", "analysis/rpc_rules.py",
)
# embedding/tier.py: the reference's text but for the device the runtime
# builds its store on, the session's device, and `_grad_fn`
TIER_SUBSTITUTIONS = (
    # the runtime's store is built on the worker's device
    ("""                 pipeline_depth: int = 0, bind_servicer=None):
        from elasticdl_tpu_torch.embedding.store import EmbeddingShardStore
""", """                 pipeline_depth: int = 0, bind_servicer=None,
                 device=None):
        from elasticdl_tpu_torch.embedding.store import EmbeddingShardStore
"""),
    ("""        self.store = EmbeddingShardStore(worker_id)
""", """        self.store = EmbeddingShardStore(worker_id, device=device)
"""),
    # the session's gradient function runs on its device (the card
    # unless named)
    ("""                 tables: Dict[str, str], compile_cache=None,
                 pipeline_depth: int = 0):
        self.client = client
        self.tables = dict(tables)
""", """                 tables: Dict[str, str], compile_cache=None,
                 pipeline_depth: int = 0, device=None):
        from elasticdl_tpu_torch.common import runtime

        self.client = client
        self.tables = dict(tables)
        self.device = runtime.resolve_device(device)
"""),
    # _grad_fn: a cached callable over torch autograd in place of
    # jax.jit(jax.value_and_grad(loss_fn))
    ("""    def _grad_fn(self, loss_fn, vectors, batch):
        import jax

        key = (
            "emb_tier_step", id(loss_fn),
            tuple(sorted(
                (k, np.asarray(v).shape) for k, v in vectors.items())),
            tuple(sorted(
                (k, np.asarray(v).shape) for k, v in batch.items()
                if hasattr(v, "shape") or isinstance(v, np.ndarray))),
        )

        def build():
            return jax.jit(jax.value_and_grad(loss_fn, argnums=0))

        return self._cache.get_or_build(key, build)""",
     """    def _grad_fn(self, loss_fn, vectors, batch):
        import torch

        key = (
            "emb_tier_step", id(loss_fn), str(self.device),
            tuple(sorted(
                (k, np.asarray(v).shape) for k, v in vectors.items())),
            tuple(sorted(
                (k, np.asarray(v).shape) for k, v in batch.items()
                if hasattr(v, "shape") or isinstance(v, np.ndarray))),
        )

        def build():
            device = self.device

            def put(v):
                if isinstance(v, dict):
                    return {k: put(x) for k, x in v.items()}
                if isinstance(v, np.ndarray) or hasattr(v, "shape"):
                    return torch.as_tensor(np.asarray(v)).to(device)
                return v

            def value_and_grad(vectors, inverses, batch):
                # the pulled rows become leaf tensors on the device; the
                # loss's backward hands back their (duplicate-summed)
                # gradients, which go back to host numpy for the push
                leaves = {
                    k: torch.as_tensor(np.asarray(v, np.float32)).to(
                        device).requires_grad_(True)
                    for k, v in vectors.items()
                }
                loss = loss_fn(leaves, put(inverses), put(batch))
                loss.backward()
                return loss.detach(), {
                    k: (v.grad.cpu().numpy() if v.grad is not None
                        else np.zeros(v.shape, np.float32))
                    for k, v in leaves.items()
                }

            return value_and_grad

        return self._cache.get_or_build(key, build)"""),
)
# ported modules whose text is the reference's after further named
# substitutions
SUBSTITUTED = {
    "master/process_manager.py": (
        ('"elasticdl_tpu.worker.main"', '"elasticdl_tpu_torch.worker.main"'),
    ),
    "embedding/tier.py": TIER_SUBSTITUTIONS,
    # the tools' texts name the module a user runs
    "observability/analyzer.py": (
        ("CLI: ``python -m elasticdl_tpu.observability.analyze",
         "CLI: ``python -m elasticdl_tpu_torch.observability.analyze"),
    ),
    "observability/analyze.py": (
        ("    python -m elasticdl_tpu.observability.analyze <path>",
         "    python -m elasticdl_tpu_torch.observability.analyze <path>"),
        ('prog="python -m elasticdl_tpu.observability.analyze"',
         'prog="python -m elasticdl_tpu_torch.observability.analyze"'),
    ),
    "observability/incident.py": (
        ("    python -m elasticdl_tpu.observability.incident <path>",
         "    python -m elasticdl_tpu_torch.observability.incident <path>"),
        ('prog="python -m elasticdl_tpu.observability.incident"',
         'prog="python -m elasticdl_tpu_torch.observability.incident"'),
    ),
    "fleetsim/__init__.py": (
        ("``python -m elasticdl_tpu.fleetsim <scenario.json>``",
         "``python -m elasticdl_tpu_torch.fleetsim <scenario.json>``"),
    ),
    "fleetsim/__main__.py": (
        ("    python -m elasticdl_tpu.fleetsim <scenario.json",
         "    python -m elasticdl_tpu_torch.fleetsim <scenario.json"),
        ('prog="python -m elasticdl_tpu.fleetsim"',
         'prog="python -m elasticdl_tpu_torch.fleetsim"'),
    ),
    # the layout scenario's stores keep the port's default device (the
    # card; host mode under EDL_EMB_TIER_DEVICE=0): no text changes there
    "fleetsim/sim.py": (
        ("`python -m elasticdl_tpu.observability.incident <dir> --strict`",
         "`python -m elasticdl_tpu_torch.observability.incident <dir> "
         "--strict`"),
    ),
    # edl-lint: the EDL2xx family is torch_rules.py's (the twins of the
    # reference's jax_rules.py), the CLI lints the port against the port's
    # own baseline, and the path-scoped rules (EDL407, EDL502) name the
    # port's modules
    "analysis/__init__.py": (
        ("- JAX hazards (EDL2xx): host syncs in dispatch loops, jit cache "
         "churn,\n  tracer leaks, unordered iteration feeding pytrees;",
         "- torch hazards (EDL2xx, `torch_rules.py`): host syncs in "
         "dispatch\n  loops and data-dependent shapes anywhere, compile and "
         "capture churn,\n  tensors escaping a captured graph, unordered "
         "iteration;"),
        ("Run `python -m elasticdl_tpu.analysis`",
         "Run `python -m elasticdl_tpu_torch.analysis`"),
    ),
    "analysis/__main__.py": (
        ('"""`python -m elasticdl_tpu.analysis`',
         '"""`python -m elasticdl_tpu_torch.analysis`'),
        ("target is the installed `elasticdl_tpu` package directory; the "
         "default\nbaseline is `.edl-lint-baseline.json` next",
         "target is the installed `elasticdl_tpu_torch` package directory; "
         "the\ndefault baseline is `.edl-lint-baseline-torch.json` next"),
        ('BASELINE_NAME = ".edl-lint-baseline.json"',
         'BASELINE_NAME = ".edl-lint-baseline-torch.json"'),
        ("os.path.abspath(elasticdl_tpu.__file__)",
         "os.path.abspath(elasticdl_tpu_torch.__file__)"),
        ('prog="python -m elasticdl_tpu.analysis"',
         'prog="python -m elasticdl_tpu_torch.analysis"'),
        ('"(default: the elasticdl_tpu package)"',
         '"(default: the elasticdl_tpu_torch package)"'),
    ),
    "analysis/core.py": (
        ("        jax_rules,\n", "        torch_rules,\n"),
    ),
    "analysis/observability_rules.py": (
        ("from elasticdl_tpu_torch.analysis.jax_rules import (",
         "from elasticdl_tpu_torch.analysis.torch_rules import ("),
        ('    "elasticdl_tpu/embedding/data_plane.py",\n'
         '    "elasticdl_tpu/embedding/tier.py",\n'
         '    "elasticdl_tpu/embedding/shm.py",\n'
         '    "elasticdl_tpu/embedding/transport.py",\n',
         '    "elasticdl_tpu_torch/embedding/data_plane.py",\n'
         '    "elasticdl_tpu_torch/embedding/tier.py",\n'
         '    "elasticdl_tpu_torch/embedding/shm.py",\n'
         '    "elasticdl_tpu_torch/embedding/transport.py",\n'),
    ),
    "analysis/elasticity_rules.py": (
        ("    inside `elasticdl_tpu/fleetsim/`. The fleet",
         "    inside `elasticdl_tpu_torch/fleetsim/`. The fleet"),
        ('_FLEETSIM_PREFIX = "elasticdl_tpu/fleetsim/"',
         '_FLEETSIM_PREFIX = "elasticdl_tpu_torch/fleetsim/"'),
        ('"time.sleep() inside elasticdl_tpu/fleetsim/ burns "',
         '"time.sleep() inside elasticdl_tpu_torch/fleetsim/ burns "'),
    ),
}

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)elasticdl_tpu(?=[.\s])", re.M)


def as_copied(text: str) -> str:
    text = _IMPORT.sub(r"\1elasticdl_tpu_torch", text)
    return text.replace('"elasticdl_tpu"', '"elasticdl_tpu_torch"')


def case_copies_equal_the_reference():
    assert len(COPIED) == len(set(COPIED))
    for rel in COPIED:
        ref, port = REF / rel, PORT / rel
        if rel.endswith(".py"):
            assert port.read_text() == as_copied(ref.read_text()), rel
        else:
            assert port.read_bytes() == ref.read_bytes(), rel


def case_substituted_modules_differ_only_as_named():
    for rel, subs in SUBSTITUTED.items():
        want = as_copied((REF / rel).read_text())
        for old, new in subs:
            assert want.count(old) == 1, (rel, old)
            want = want.replace(old, new)
        assert (PORT / rel).read_text() == want, rel


def case_no_copied_module_names_the_reference_in_an_import():
    for rel in COPIED + tuple(SUBSTITUTED):
        if rel.endswith(".py"):
            text = (PORT / rel).read_text()
            assert not re.search(
                r"^\s*(from|import)\s+elasticdl_tpu[.\s]", text, re.M), rel


def test_copies_match_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    case_copies_equal_the_reference()
    case_substituted_modules_differ_only_as_named()
    case_no_copied_module_names_the_reference_in_an_import()
