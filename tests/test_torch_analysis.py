"""The port's edl-lint (`elasticdl_tpu_torch.analysis`) against the
reference's (`elasticdl_tpu.analysis`).

- Every rule id the two packages share unchanged (all but EDL201, 202,
  203 and 205, whose twins live in `torch_rules.py`) gives the same
  findings (rule, path, line, message) from both engines over the same
  sources: every fixture snippet of the reference's own rule tests
  (`tests/test_analysis_rules.py`, `tests/test_concurrency_analysis.py`),
  at plain and at path-scoped file names, and the reference's
  `elasticdl_tpu/master/` directory. The path-scoped rules (EDL407,
  EDL502) name the port's modules, so the port sees a file under
  `elasticdl_tpu_torch/` where the reference sees it under
  `elasticdl_tpu/`.
- The twins fire on their torch forms (`.item()`, `.cpu()`, `.tolist()`,
  `torch.cuda.synchronize()`, `torch.nonzero` anywhere, `torch.compile`
  and CUDA-graph captures in a loop or a rescale path, a tensor stored
  from a compiled function) and stay quiet when suppressed or outside
  their scope; each JAX fixture of the reference's EDL2xx tests, written
  in torch, fires on the same lines as the original does.
- `python -m elasticdl_tpu_torch.analysis` exits 0 over the port's tree
  against the port's own (empty) baseline.
- The port's static EDL102 lock graph over its master is acyclic.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

from elasticdl_tpu.analysis import core as ref_core
from elasticdl_tpu_torch.analysis import core as port_core

REPO = Path(__file__).resolve().parent.parent
TWINNED = {"EDL201", "EDL202", "EDL203", "EDL205"}
FIXTURE_FILES = ("test_analysis_rules.py", "test_concurrency_analysis.py")
#: file names a snippet is linted under: the path-scoped rules (EDL301's
#: service module, EDL407's data plane, EDL501/503's policy modules,
#: EDL502's simulator) look at the path
REL_PATHS = ("fixture.py", "elasticdl_tpu/fleetsim/fixture.py",
             "elasticdl_tpu/embedding/data_plane.py",
             "elasticdl_tpu/proto/service.py",
             "elasticdl_tpu/master/autoscaler.py",
             "elasticdl_tpu/training/compile_cache.py")


def as_port(text):
    return text.replace("elasticdl_tpu/", "elasticdl_tpu_torch/")


def as_ref(text):
    return text.replace("elasticdl_tpu_torch/", "elasticdl_tpu/")


def reference_fixtures():
    """Each source the reference's rule tests lint: every string literal
    that parses as a module, and every {path: source} dict of them."""
    out = []
    for name in FIXTURE_FILES:
        tree = ast.parse((REPO / "tests" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Dict) and node.keys and all(
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and k.value.endswith(".py")
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                    for k, v in zip(node.keys, node.values)):
                out.append({k.value: textwrap.dedent(v.value)
                            for k, v in zip(node.keys, node.values)})
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str) and "\n" in node.value):
                src = textwrap.dedent(node.value)
                try:
                    ast.parse(src)
                except SyntaxError:
                    continue
                if re.search(r"^\s*(def|class|import|from|with|for)\s",
                             src, re.M):
                    out.append({"fixture.py": src})
    return out


def findings(core, sources, keep=None):
    """The unsuppressed findings of every rule of `core`'s engine (only
    the ids in `keep`, if given) over {rel_path: source}, as (rule, path,
    line, message) tuples."""
    contexts = [core.ModuleContext(p, s, p) for p, s in sources.items()]
    rules = [r for r in core.all_rules() if keep is None or r.id in keep]
    out = set()
    for rule in rules:
        if isinstance(rule, core.ProjectRule):
            project = core.ProjectContext(contexts)
            got = [f for f in rule.check_project(project)
                   if not project.suppressed(f)]
        else:
            got = [f for ctx in contexts for f in rule.check(ctx)
                   if not ctx.suppressed(f)]
        out |= {(f.rule, f.path, f.line, f.message) for f in got}
    return out


def shared_ids():
    ref = {r.id for r in ref_core.all_rules()}
    port = {r.id for r in port_core.all_rules()}
    assert port == ref, port ^ ref
    return ref - TWINNED


def case_shared_rules_agree_on_the_reference_fixtures(fixtures):
    keep = shared_ids()
    fired = set()
    for sources in fixtures:
        for rel in REL_PATHS:
            placed = {(rel if p == "fixture.py" else p): s
                      for p, s in sources.items()}
            want = findings(ref_core, placed, keep)
            got = findings(port_core, {as_port(p): s
                                       for p, s in placed.items()}, keep)
            got = {(r, as_ref(p), line, as_ref(m)) for r, p, line, m in got}
            assert got == want, (rel, sorted(got ^ want))
            fired |= {f[0] for f in want}
    # the fixtures exercise the shared families, path-scoped ones too
    assert {"EDL101", "EDL102", "EDL103", "EDL104", "EDL204", "EDL206",
            "EDL301", "EDL303", "EDL407", "EDL502"} <= fired, fired


def case_shared_rules_agree_on_the_reference_master():
    keep = shared_ids()
    path = str(REPO / "elasticdl_tpu" / "master")
    want = ref_core.run_analysis([path], select=keep)
    got = port_core.run_analysis([path], select=keep)
    assert [(f.rule, f.path, f.line, f.message) for f in got.findings] == \
        [(f.rule, f.path, f.line, f.message) for f in want.findings]
    assert not want.errors and not got.errors


# ------------------------------------------------------------------ #
# the twins


def port_twins(src, rel="fixture.py"):
    return sorted((f[0], f[2]) for f in findings(
        port_core, {rel: textwrap.dedent(src)}, TWINNED))


TORCH_SYNCS = """
    import numpy as np
    import torch

    def run(trainer, state, batches):
        for batch in batches:
            state, logs = trainer.train_step(state, batch)
            a = logs["loss"].item()
            b = logs["loss"].cpu()
            c = logs["loss"].tolist()
            d = logs["loss"].detach().numpy()
            torch.cuda.synchronize()
            e = torch.nonzero(batch["mask"])
            f = batch["mask"].nonzero()
            g = float(logs["loss"])
            h = np.asarray(logs["loss"])
            ok = logs["loss"].detach()   # stays on the card
        return state

    def route(mine):
        return torch.nonzero(mine)[:, 0]   # a sync wherever it runs

    def cold(xs):
        return [x.cpu().item() for x in xs]   # no dispatch in this loop
"""

TORCH_SYNCS_SUPPRESSED = """
    import torch

    def run(trainer, state, batches):
        for batch in batches:
            state, logs = trainer.train_step(state, batch)
            # the sync IS the measurement: edl-lint: disable=EDL201
            loss = logs["loss"].item()
        return state

    def route(mine):
        return torch.unique(mine)   # edl-lint: disable=host-sync-in-hot-loop
"""

TORCH_CHURN = """
    import torch
    from elasticdl_tpu_torch.ops import native

    def per_batch(model, batches):
        for b in batches:
            step = torch.compile(model)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step(b)
            torch.jit.script(model)
            native.build(["place_sorted_grads"])
        return step

    def immediate(model, x):
        return torch.compile(model)(x)

    _compiled = None

    def cached(model, x):
        global _compiled
        if _compiled is None:
            _compiled = torch.compile(model)
        return _compiled(x)
"""

TORCH_RESCALE = """
    import torch

    def rescale_in_place(model, state):
        step = torch.compile(model)
        return step(state)

    def _reform_cohort(model, cache, key, state):
        graph = torch.cuda.CUDAGraph()
        step = cache.get_or_build(key, lambda: torch.compile(model))
        return step(state), graph

    def steady(model):
        return torch.compile(model)   # not a rescale path: out of scope
"""

TORCH_LEAK = """
    import torch

    class T:
        @torch.compile
        def step(self, x):
            self.last = x
            return x * 2

    def make(model):
        hits = None

        def leaky(x):
            nonlocal hits
            hits = x
            return x

        def pure(x):
            return x * 2

        return torch.jit.trace(leaky, (model,)), torch.compile(pure)
"""


def case_twins_fire_on_torch_forms():
    assert port_twins(TORCH_SYNCS) == [("EDL201", n) for n in (
        8, 9, 10, 11, 12, 13, 14, 15, 16, 21)]
    assert port_twins(TORCH_SYNCS_SUPPRESSED) == []
    assert port_twins(TORCH_CHURN) == [("EDL202", n) for n in (
        7, 8, 9, 11, 12, 16)]
    assert port_twins(TORCH_RESCALE) == [("EDL205", 5), ("EDL205", 9)]
    # the program cache's own module builds what it caches
    assert port_twins(
        TORCH_RESCALE, "elasticdl_tpu_torch/training/compile_cache.py") == []
    assert port_twins(TORCH_LEAK) == [("EDL203", 7), ("EDL203", 15)]


def as_torch(src):
    """A JAX fixture in torch: jit is torch.compile, device_get is .cpu()."""
    src = re.sub(r"jax\.device_get\(([^()]*)\)", r"(\1).cpu()", src)
    return (src.replace("import jax\n", "import torch\n")
            .replace("jax.jit", "torch.compile"))


def case_reference_jax_fixtures_fire_in_torch(fixtures):
    compared = 0
    for sources in fixtures:
        if len(sources) != 1 or "jax" not in sources["fixture.py"]:
            continue
        src = sources["fixture.py"]
        want = sorted((f[0], f[2]) for f in findings(
            ref_core, {"fixture.py": src}, TWINNED))
        assert port_twins(as_torch(src)) == want, src
        compared += bool(want)
    assert compared >= 5, compared


def case_explain_and_suppression_by_slug(capsys):
    from elasticdl_tpu_torch.analysis import __main__ as cli

    assert cli.main(["--explain", "EDL203"]) == 0
    assert "CUDA graph" in capsys.readouterr().out
    assert cli.main(["--explain", "EDL999"]) == 2
    capsys.readouterr()


# ------------------------------------------------------------------ #
# the port's tree


def case_port_lock_graph_is_acyclic():
    from elasticdl_tpu_torch.analysis.concurrency import build_lock_graph

    contexts = []
    master = REPO / "elasticdl_tpu_torch" / "master"
    for abs_path, rel in port_core.iter_python_files([str(master)]):
        with open(abs_path, encoding="utf-8") as f:
            contexts.append(port_core.ModuleContext(abs_path, f.read(), rel))
    graph = build_lock_graph(port_core.ProjectContext(contexts))
    assert graph["nodes"] and graph["edges"], graph
    assert graph["cycles"] == [], graph["cycles"]


def test_port_lint_matches_the_reference(capsys):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file). The CLI over the port's tree
    (~20 s) runs in a process of its own meanwhile."""
    baseline = json.loads((REPO / ".edl-lint-baseline-torch.json").read_text())
    assert baseline["entries"] == []
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    cli = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.analysis"], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        fixtures = reference_fixtures()
        case_shared_rules_agree_on_the_reference_fixtures(fixtures)
        case_shared_rules_agree_on_the_reference_master()
        case_twins_fire_on_torch_forms()
        case_reference_jax_fixtures_fire_in_torch(fixtures)
        case_explain_and_suppression_by_slug(capsys)
        case_port_lock_graph_is_acyclic()
        out, _ = cli.communicate(timeout=240)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    assert cli.returncode == 0, out
    assert "edl-lint: 0 new finding(s), 0 baselined, 0 error(s)" in out, out
