"""The port's copy of the model-zoo loader resolves the zoo contract as
the reference's does: overrides by bare or dotted name, optional and
required functions, malformed model_def."""

import types

import pytest

from elasticdl_tpu.common import model_utils as jmu
from elasticdl_tpu_torch.common import model_utils as tmu


def _module():
    m = types.ModuleType("zoo_probe")
    m.loss = lambda labels, outputs: 0
    m.other_loss = lambda labels, outputs: 1
    return m


def case_get_module_attr_matches(name, override, required):
    m = _module()
    assert tmu.get_module_attr(m, name, override, required) is \
        jmu.get_module_attr(m, name, override, required)


def case_get_module_attr_raises_alike(name, override, required):
    m = _module()
    with pytest.raises(ValueError):
        jmu.get_module_attr(m, name, override, required)
    with pytest.raises(ValueError):
        tmu.get_module_attr(m, name, override, required)


def case_load_module_rejects_malformed_model_def(tmp_path, dotted):
    with pytest.raises(ValueError):
        tmu.load_module(str(tmp_path), dotted)


def test_model_utils_match_the_reference(tmp_path):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for args in (("loss", "", True), ("loss", "other_loss", True),
                 ("loss", "os.path.join", True), ("dataset_fn", "", False)):
        case_get_module_attr_matches(*args)
    for args in (("optimizer", "", True), ("dataset_fn", "missing", False)):
        case_get_module_attr_raises_alike(*args)
    for dotted in ("", "custom_model"):
        case_load_module_rejects_malformed_model_def(tmp_path, dotted)
