"""The port's device-side preprocessing against the reference, on the CPU.

Ids must be bit-equal: one wrong id silently trains another row. Dense
features agree within 1e-6 (log1p in two libraries).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.api import feature_spec as jfs
from elasticdl_tpu.api import preprocessing as jpp
from elasticdl_tpu_torch.api import feature_spec as tfs
from elasticdl_tpu_torch.api import preprocessing as tpp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_deepfm(zoo_root):
    """Import `deepfm.deepfm` from one zoo root. Both zoos name their
    module `deepfm.deepfm`, so the import runs with that root first on
    sys.path and any cached `deepfm` modules set aside, then restored."""
    import importlib

    names = [k for k in sys.modules if k == "deepfm" or k.startswith("deepfm.")]
    saved = {k: sys.modules.pop(k) for k in names}
    path = list(sys.path)
    try:
        sys.path.insert(0, zoo_root)
        return importlib.import_module("deepfm.deepfm")
    finally:
        for k in [k for k in sys.modules
                  if k == "deepfm" or k.startswith("deepfm.")]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _edge_ids():
    r = np.random.RandomState(0)
    edges = np.array([0, 1, -1, -2, 2**31 - 1, -(2**31), 2**30, 12345,
                      -12345, 0x7FFF0000, 65535, 65536], np.int32)
    return np.concatenate([edges, r.randint(-(2**31), 2**31 - 1, 4096,
                                            dtype=np.int64).astype(np.int32)])


def case_hash_bucket_bit_equal(num_bins):
    ids = _edge_ids()
    want = np.asarray(jpp.hash_bucket(jnp.asarray(ids), num_bins))
    got = tpp.hash_bucket(torch.from_numpy(ids), num_bins).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def case_hash_bucket_accepts_int64_input():
    ids = _edge_ids()
    want = np.asarray(jpp.hash_bucket(jnp.asarray(ids), 1000))
    got = tpp.hash_bucket(torch.from_numpy(ids.astype(np.int64)), 1000)
    np.testing.assert_array_equal(got.numpy(), want)


def case_bucketize_and_normalize_match():
    r = np.random.RandomState(1)
    v = (r.randn(257) * 3).astype(np.float32)
    bounds = [-2.0, -0.5, 0.0, 0.5, 2.0]
    v[:5] = bounds          # values on a boundary go right, as searchsorted
    np.testing.assert_array_equal(
        tpp.bucketize(torch.from_numpy(v), bounds).numpy(),
        np.asarray(jpp.bucketize(jnp.asarray(v), bounds)))
    np.testing.assert_allclose(
        tpp.normalize(torch.from_numpy(v), 0.25, 1.5).numpy(),
        np.asarray(jpp.normalize(jnp.asarray(v), 0.25, 1.5)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tpp.log_normalize(torch.from_numpy(v)).numpy(),
        np.asarray(jpp.log_normalize(jnp.asarray(v))), rtol=1e-6, atol=1e-6)


def _criteo_cols(b, seed):
    r = np.random.RandomState(seed)
    dense = (r.rand(b, 13) * 50 - 5).astype(np.float32)   # negatives clamp
    cat = r.randint(-(2**31), 2**31 - 1, (b, 26), dtype=np.int64)
    return dense, cat.astype(np.int32)


def case_deepfm_feature_spec_device_transform_matches():
    jzoo = load_deepfm(os.path.join(REPO, "model_zoo"))
    tzoo = load_deepfm(os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"))
    jspec, tspec = jzoo.feature_spec(1000), tzoo.feature_spec(1000)
    assert tspec.total_vocab == jspec.total_vocab == 26_000
    assert tspec.offsets == jspec.offsets
    dense, cat = _criteo_cols(512, 3)
    want = jspec.device_transform(
        {"dense": jnp.asarray(dense), "cat": jnp.asarray(cat)})
    got = tspec.device_transform(
        {"dense": torch.from_numpy(dense), "cat": torch.from_numpy(cat)})
    assert got["cat"].dtype == torch.int32
    np.testing.assert_array_equal(got["cat"].numpy(), np.asarray(want["cat"]))
    np.testing.assert_allclose(got["dense"].numpy(),
                               np.asarray(want["dense"]), rtol=0, atol=1e-6)


def case_standardized_numeric_and_named_columns_match():
    feats_j = [jfs.numeric("a", standardize=(1.5, 0.3)),
               jfs.hashed("h", 97), jfs.hashed("g", 5, source=("packed", 1))]
    feats_t = [tfs.numeric("a", standardize=(1.5, 0.3)),
               tfs.hashed("h", 97), tfs.hashed("g", 5, source=("packed", 1))]
    r = np.random.RandomState(4)
    cols = {"a": r.randn(64).astype(np.float32),
            "h": r.randint(-1000, 1000, 64).astype(np.int32),
            "packed": r.randint(0, 50, (64, 3)).astype(np.int32)}
    want = jfs.FeatureSpec(feats_j).device_transform(
        {k: jnp.asarray(v) for k, v in cols.items()})
    got = tfs.FeatureSpec(feats_t).device_transform(
        {k: torch.from_numpy(v) for k, v in cols.items()})
    np.testing.assert_array_equal(got["cat"].numpy(), np.asarray(want["cat"]))
    np.testing.assert_allclose(got["dense"].numpy(), np.asarray(want["dense"]),
                               rtol=1e-6, atol=1e-6)


def case_feature_spec_rejects_what_is_not_ported():
    with pytest.raises(ValueError, match="log1p"):
        tfs.numeric("x", standardize=(0.0, 1.0), log1p=True)
    with pytest.raises(ValueError, match="duplicate"):
        tfs.FeatureSpec([tfs.numeric("x"), tfs.hashed("x", 3)])
    with pytest.raises(TypeError, match="ported"):
        tfs.FeatureSpec([jfs.bucketized("b", [0.0])])
    spec = tfs.FeatureSpec([tfs.hashed("s", 10, strings=True)])
    with pytest.raises(ValueError, match="host_transform"):
        spec.device_transform({"other": torch.zeros(2, dtype=torch.int32)})


def test_preprocessing_against_the_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for num_bins in (1, 7, 1000, 100_000, 2**31 - 1):
        case_hash_bucket_bit_equal(num_bins)
    case_hash_bucket_accepts_int64_input()
    case_bucketize_and_normalize_match()
    case_deepfm_feature_spec_device_transform_matches()
    case_standardized_numeric_and_named_columns_match()
    case_feature_spec_rejects_what_is_not_ported()
