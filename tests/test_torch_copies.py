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
line. Every file is compared exactly after the substitutions.
"""

import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "elasticdl_tpu", REPO / "elasticdl_tpu_torch"

COPIED = (
    "version.py",
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
)
# ported modules whose text is the reference's after further named
# substitutions
SUBSTITUTED = {
    "master/process_manager.py": (
        ('"elasticdl_tpu.worker.main"', '"elasticdl_tpu_torch.worker.main"'),
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
