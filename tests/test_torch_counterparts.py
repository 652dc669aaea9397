"""The port's public surface against the reference's, and the last
functions ported against theirs.

- Surface (`ast` only; neither package is imported): every public
  top-level function, class and method of every module under
  `elasticdl_tpu/` has a counterpart of the same name under the same
  path in `elasticdl_tpu_torch/` (a top-level binding; a method, or a
  name bound in the class's body), or an entry in NOT_PORTED with its
  reason. An entry names a module, a name in it, or `Class.*` for the
  methods of a class the port keeps as a stub. A name in neither place
  fails, and so does an entry whose name the reference no longer has or
  the port now has.
- `training.metrics.merge_states`, `api.preprocessing.multi_hot` and
  `training.compile_cache.CompileCache.contains` against the reference's
  on numpy inputs made from a seed, exactly: states with array and
  scalar leaves; id bags with padding ids, out-of-range ids, duplicates,
  weights and leading batch dims.
"""

import ast
import functools
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "elasticdl_tpu", "elasticdl_tpu_torch"
QUEUE3 = "ROADMAP.md queue 3, 'Differences of design'"

# reference names with no counterpart under the same path in the port
NOT_PORTED = {
    "common/jax_compat.py":
        "shims over JAX versions; the port imports no JAX",
    "analysis/jax_rules.py":
        "the JAX lint rules; their torch twins are analysis/torch_rules.py",
    "ops/pallas_attention.py":
        "the Pallas flash kernels: ops/flash_attention.py and "
        "csrc/flash_attention*.cu (K2-K4, K2'-K4')",
    "ops/pallas_scatter.py":
        "the Pallas placement kernel: ops/placement.py and "
        "csrc/place_sorted_grads.cu (K1)",
    "common/runtime.py:configure_jax_runtime":
        "JAX's flags; the port's is runtime.configure_torch_runtime",
    "parallel/mesh.py:abstract_batch":
        "ShapeDtypeStructs for XLA's AOT compiles; the port captures only "
        "over a state this process holds (item 19)",
    "parallel/mesh.py:abstract_batch_stack":
        "ShapeDtypeStructs for XLA's AOT compiles; the port captures only "
        "over a state this process holds (item 19)",
    "parallel/mesh.py:batch_key_spec":
        "a PartitionSpec per batch key; the port cuts by the model's "
        "partition in parallel.mesh.shard_batch",
    "parallel/mesh.py:batch_sharding":
        "a NamedSharding; the port's ranks take their block in "
        "parallel.mesh.shard_batch",
    "parallel/mesh.py:model_axis":
        "names the axis for PartitionSpecs (the reference calls it "
        "nowhere); the port's layers read Mesh.axis_size(MeshAxis.MODEL)",
    "parallel/mesh.py:prune_spec":
        "prunes a PartitionSpec; parallel.mesh.shard_batch skips the axes "
        "a mesh lacks",
    "parallel/mesh.py:replicated":
        "a NamedSharding; an unsharded tensor is whole on every rank",
    "parallel/mesh.py:shard_batch_stack":
        "the port's is training.trainer.stack_batches",
    "parallel/mesh.py:table_sharding":
        "a NamedSharding; the port's tables take their rows in "
        "Embedding.shard (parallel.mesh.table_rows)",
    "parallel/pipeline.py:stage_partition_specs":
        "PartitionSpecs of the stacked stages; the port's is "
        "PipelinedBlocks.shard",
    "parallel/elastic.py:CohortContext.global_mesh":
        "a jax Mesh over jax.devices(); the port's is "
        "parallel.mesh.build_job_mesh",
    "parallel/elastic.py:make_global_batch":
        "jax.make_array_from_callback; every port rank holds the whole "
        "batch and the trainer cuts its block (parallel.mesh.shard_batch)",
    "parallel/elastic.py:make_global_batch_stack":
        "as make_global_batch, for a stacked group (trainer.stack_batches)",
    "parallel/elastic.py:LiveStateHandoff":
        f"the in-place rescale's handoff, item 32: {QUEUE3}",
    "parallel/elastic.py:neighbor_world_sizes":
        f"the speculative compiler's candidates, item 19: {QUEUE3}",
    "ops/embedding.py:ambient_axes":
        "reads jax.set_mesh's mesh; the port passes its mesh explicitly",
    "ops/embedding.py:table_partition_axes":
        "axes from jax.set_mesh's mesh; a port table is split over every "
        "axis of the mesh it is given (Embedding.shard)",
    "ops/moe.py:expert_partition_names":
        "the port's is ops.moe.expert_range",
    "training/trainer.py:Trainer.abstract_train_state":
        "ShapeDtypeStructs for AOT compiles for a world this process cannot "
        "run; a CUDA graph is captured over a state this process holds, "
        f"item 19: {QUEUE3}",
    "training/compile_cache.py:SpeculativeCompiler.*":
        f"item 19, whose class the port keeps as a stub that raises: "
        f"{QUEUE3}",
}


def _public(node) -> bool:
    return (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not node.name.startswith("_"))


def reference_names(path):
    """{public top-level name: its public methods (None for a function)}."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if _public(node):
            out[node.name] = (
                {n.name for n in node.body if _public(n)
                 and not isinstance(n, ast.ClassDef)}
                if isinstance(node, ast.ClassDef) else None)
    return out


def _bound(body):
    names = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def port_names(path):
    """(top-level bindings, {class: names bound in its body})."""
    tree = ast.parse(open(path).read())
    return _bound(tree.body), {n.name: _bound(n.body) for n in tree.body
                               if isinstance(n, ast.ClassDef)}


@functools.lru_cache(maxsize=1)
def surface():
    """(every reference name as "path", "path:Name" or
    "path:Class.method", with whether the port has it)."""
    out = {}
    root = os.path.join(REPO, REF)
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(f for f in files if f.endswith(".py")):
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            names = reference_names(os.path.join(dirpath, f))
            port = os.path.join(REPO, PORT, rel)
            if not names:
                continue
            top, classes = (port_names(port) if os.path.exists(port)
                            else (set(), {}))
            out[rel] = bool(top)
            for name, methods in names.items():
                out[f"{rel}:{name}"] = name in top
                for m in methods or ():
                    out[f"{rel}:{name}.{m}"] = m in classes.get(name, ())
    return out


def _listed(key):
    """The NOT_PORTED entry that covers `key`, or None."""
    rel, _, name = key.partition(":")
    cls = name.split(".")[0]
    for entry in (key, f"{rel}:{cls}", f"{rel}:{cls}.*", rel):
        if entry in NOT_PORTED and (entry != f"{rel}:{cls}.*" or
                                    "." in name):
            return entry
    return None


# ---------------------------------------------------------------- cases


def case_surface_has_counterparts():
    names = surface()
    missing = [k for k, have in names.items()
               if ":" in k and not have and _listed(k) is None]
    assert not missing, f"no counterpart in the port and no reason: {missing}"
    for entry, reason in NOT_PORTED.items():
        assert reason, entry
        key = entry[:-2] if entry.endswith(".*") else entry
        assert key in names, f"NOT_PORTED names {entry}, which the " \
                             "reference no longer has"
        covered = [k for k in names
                   if _listed(k) == entry and (":" in k or k == entry)]
        assert not all(names[k] for k in covered), \
            f"the port now has {entry}: take it out of NOT_PORTED"


def case_a_new_name_fails():
    names = dict(surface())
    names["training/trainer.py:Trainer.new_knob"] = False
    names["ops/moe.py:new_router"] = False
    assert [k for k, have in names.items() if ":" in k and not have
            and _listed(k) is None] == ["training/trainer.py:Trainer.new_knob",
                                        "ops/moe.py:new_router"]


def case_merge_states_matches():
    from elasticdl_tpu.training import metrics as jm
    from elasticdl_tpu_torch.training import metrics as tm

    r = np.random.RandomState(0)
    a = {"auc": r.rand(2, 200).astype(np.float32),
         "_loss": r.rand(2).astype(np.float32),
         "mean": np.float32(r.rand()), "count": 3.0}
    b = {"auc": r.rand(2, 200).astype(np.float32),
         "_loss": r.rand(2).astype(np.float32),
         "mean": np.float32(r.rand()), "count": np.float64(2.0),
         "only_b": np.ones(3, np.float32)}
    want, got = jm.merge_states(a, b), tm.merge_states(a, b)
    assert set(got) == set(want) == set(a)
    for k in want:
        assert type(got[k]) is type(want[k]), k     # numpy, as the sum
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def case_multi_hot_matches():
    import jax.numpy as jnp
    import torch

    from elasticdl_tpu.api import preprocessing as jpp
    from elasticdl_tpu_torch.api import preprocessing as tpp

    r = np.random.RandomState(1)
    n = 37
    for shape in ((16, 9), (2, 3, 9), (5, 1), (4, 0)):
        ids = r.randint(-3, n + 3, shape).astype(np.int32)
        ids.flat[::7] = -1                      # padding slots
        if ids.size:
            ids.flat[1] = 2**31 - 1             # far out of range
            ids.flat[-1] = ids.flat[0]          # a duplicate
        weights = r.randn(*shape).astype(np.float32)
        for w in (None, weights):
            want = np.asarray(jpp.multi_hot(
                jnp.asarray(ids), n, None if w is None else jnp.asarray(w)))
            got = tpp.multi_hot(torch.from_numpy(ids), n,
                                None if w is None else torch.from_numpy(w))
            assert got.dtype == torch.float32
            assert tuple(got.shape) == want.shape == shape[:-1] + (n,)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{shape} {w is None}")


def case_compile_cache_contains_matches():
    from elasticdl_tpu.training import compile_cache as jcc
    from elasticdl_tpu_torch.training import compile_cache as tcc

    for cache in (jcc.CompileCache(), tcc.CompileCache()):
        cache.get_or_build(("a", 1), lambda: "built")
        assert cache.contains(("a", 1)) and not cache.contains(("b", 1))
        assert cache.stats()["hits"] == 0 and cache.stats()["misses"] == 1


def test_port_surface_and_counterparts():
    """The cases in turn: one collected test keeps the xdist loadfile
    schedule of the reference's test files as it was."""
    case_surface_has_counterparts()
    case_a_new_name_fails()
    case_merge_states_matches()
    case_multi_hot_matches()
    case_compile_cache_contains_matches()
