"""The trainer's step programs: on the card, each step captured as a CUDA
graph and replayed.

Port-only, the counterpart of what `jax.jit` does for the reference's
steps (`elasticdl_tpu/training/trainer.py`: `_ensure`, `_dispatch`,
`_aot_compile`). A `Program` is one step kind's body (a function of the
trainer, the state and the step's device inputs); the trainer resolves
it through its `CompileCache` under the reference's program key. Called
with a state and a batch signature (`compile_cache.aval_signature` of the
inputs) it has not seen, it builds a `Graph` for them:

- on the card, when the trainer captures (`Trainer.capture_reason` is
  None), a `CapturedGraph`, by PyTorch's whole-network recipe: the inputs
  copied into static tensors, `WARMUP_ITERS` warm-up runs of the body on
  a side stream (the optimizer's slots, cuBLAS's workspace on that
  stream, the kernels' first build and launch set-up), the state put
  back as it was (`StateCopy`), then the capture on that stream into the
  graph's private memory pool. The state's generator is registered with
  the graph, so each replay draws the next masks as the eager step would.
  A call then copies its inputs into the static tensors and replays once;
- otherwise (the CPU, and the configurations the trainer leaves eager) an
  `EagerGraph`, which runs the body itself: on the CPU that is the plain
  versions of the kernels.

A captured graph reads the memory of the state it was captured over: the
parameters, their gradients (allocated in its pool), the optimizer's
slots and tensor learning rate, the buffers and the generator. So nothing
may replace those tensors: the trainer, `StateCopy` and the checkpoint
manager write into them in place. A graph is bound to its state and its
model, a program looks its graphs up by both, and a graph whose state is
gone is dropped with its pool.

The kernels' counters (`ops.placement.launches`,
`ops.flash_attention.launches`) count the launches of the steps, eager
or replayed: a wrapper counts where it launches, which a replay does not
run, so each replay adds the launches its capture recorded. The capture
itself launches nothing, so what the wrappers counted while capturing is
taken back; the warm-up's launches are moved to `warmup_launches`, by
kernel, so that a step's count is the same captured or eager and the
warm-ups are still told.
"""

from __future__ import annotations

import copy
import threading
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple

import torch

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.data.prefetch import tree_map
from elasticdl_tpu_torch.ops import flash_attention, placement
from elasticdl_tpu_torch.training import compile_cache

logger = default_logger(__name__)

#: warm-up runs of the body before a capture: one does every lazy
#: initialization the steps make
WARMUP_ITERS = 1

# the kernels' launches made by capture warm-ups in this process, by
# kernel (not in the kernels' own counters); guarded by _warmup_lock
warmup_launches: Counter = Counter()
_warmup_lock = threading.Lock()


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch count so far, by kernel."""
    return {placement.KERNEL: placement.launches, **flash_attention.launches}


def _add_launches(counts: Dict[str, int], sign: int = 1) -> None:
    for name, n in counts.items():
        if name == placement.KERNEL:
            with placement.launches_lock:
                placement.launches += sign * n
        else:
            flash_attention.launches[name] += sign * n


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def batch_signature(args: Any) -> Tuple:
    """The (shape, dtype, device) signature of a step's inputs."""
    return compile_cache.aval_signature(args)


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of nested dicts, lists and tuples, dicts in key
    order (as `batch_signature` reads them)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class StateCopy:
    """What a train step changes in a `TrainState`, copied, so that
    `restore` puts the state back bit for bit and in place: the
    parameters, their gradients, the buffers, the optimizer's slots and
    hyperparameters, the step and the generator's state. Every tensor the
    state held keeps its storage (a captured graph reads it)."""

    @torch.no_grad()
    def __init__(self, state):
        self.params = {n: p.detach().clone() for n, p in state.params.items()}
        self.grads = {n: p.grad for n, p in state.params.items()}
        self.buffers = {n: b.clone() for n, b in state.buffers.items()}
        opt = state.optimizer
        self.slots = {p: copy.deepcopy(s) for p, s in opt.state.items()}
        self.groups = [{k: copy.deepcopy(v) for k, v in g.items()
                        if k != "params"} for g in opt.param_groups]
        self.step = state.step
        self.generator = state.generator.get_state()

    @torch.no_grad()
    def restore(self, state, new_slots: str = "drop") -> None:
        """Put `state` back. Slots the optimizer made since the copy are
        dropped (`new_slots="drop"`: the optimizer is as it was) or
        zeroed in place (`"zero"`: what Adam, AdamW and SGD make on their
        first step, so a graph captured next holds them)."""
        for n, p in state.params.items():
            p.copy_(self.params[n])
            p.grad = self.grads[n]
        for n, b in state.buffers.items():
            b.copy_(self.buffers[n])
        opt = state.optimizer
        for p in [p for p in opt.state if p not in self.slots]:
            if new_slots == "drop":
                del opt.state[p]
                continue
            for v in opt.state[p].values():
                if isinstance(v, torch.Tensor):
                    v.zero_()
        for p, slots in self.slots.items():
            _write_in_place(opt.state[p], slots)
            for k in [k for k in opt.state[p] if k not in slots]:
                del opt.state[p][k]
        for group, saved in zip(opt.param_groups, self.groups):
            _write_in_place(group, saved)
        state.step = self.step
        state.generator.set_state(self.generator)


def _write_in_place(live: Dict[str, Any], saved: Dict[str, Any]) -> None:
    """`live.update(saved)`, copying a saved tensor into the live tensor
    of its shape rather than replacing it."""
    for k, v in saved.items():
        cur = live.get(k)
        if (isinstance(cur, torch.Tensor) and isinstance(v, torch.Tensor)
                and v.shape == cur.shape):
            cur.copy_(v)
        else:
            live[k] = v


class Graph:
    """One step kind's program for one state, model and batch signature."""

    def __init__(self, program: "Program", trainer, state, sig: Tuple):
        self.program = program
        self.sig = sig
        self._state = weakref.ref(state)
        self._model = weakref.ref(trainer.model)

    def bound_to(self, trainer, state) -> bool:
        return self._state() is state and self._model() is trainer.model

    def check(self, trainer, state, sig: Tuple) -> None:
        if not self.bound_to(trainer, state):
            raise ValueError(f"the {self.program.kind} program was "
                             "captured over another state or model")
        if sig != self.sig:
            raise ValueError(f"the {self.program.kind} program was "
                             f"captured for inputs {self.sig}, got {sig}")

    def __call__(self, trainer, state, args, sig: Tuple):
        raise NotImplementedError


class EagerGraph(Graph):
    """The body itself, run at each call: the CPU's program, and the
    program of a configuration the trainer leaves eager."""

    def __call__(self, trainer, state, args, sig: Tuple):
        self.check(trainer, state, sig)
        return self.program.body(trainer, state, args)


class CapturedGraph(Graph):
    """A `torch.cuda.CUDAGraph` of the body over static inputs. Its
    fields say what the capture cost: `capture_s` (warm-up excluded),
    `warmup_s`, `pool_bytes` (the device memory the graph's private pool
    reserved while capturing), `launches` (the hand-written kernels'
    launches a replay makes, by kernel) and `replays`."""

    def __init__(self, program: "Program", trainer, state, args,
                 sig: Tuple):
        super().__init__(program, trainer, state, sig)
        device = trainer.device
        self.static_args = tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, args)
        self._static = _tensors(self.static_args)
        side = torch.cuda.Stream(device)
        t0 = time.perf_counter()
        before = launch_counts()
        saved = StateCopy(state)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERS):
                    program.body(trainer, state, self.static_args)
        finally:
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            saved.restore(state, new_slots="zero")
            del saved
        warm = _delta(launch_counts(), before)
        _add_launches(warm, -1)
        with _warmup_lock:
            warmup_launches.update(warm)
        self.warmup_s = time.perf_counter() - t0
        before = launch_counts()

        self.graph = torch.cuda.CUDAGraph()
        if state.generator.device.type == "cuda":
            self.graph.register_generator_state(state.generator)
        torch.cuda.synchronize(device)
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            # thread_local: the prefetcher's thread may allocate and copy
            # on its own stream while this one captures
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = program.body(trainer, state, self.static_args)
            except Exception as e:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the failed capture's own error is the one to raise
                raise RuntimeError(
                    f"capturing the {program.kind} step failed: {e}") from e
            self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.static_out = out
        # the wrappers counted the launches they recorded; the capture ran
        # none of them, and each replay runs them all
        self.launches = _delta(launch_counts(), before)
        _add_launches(self.launches, -1)
        self.replays = 0

    def __call__(self, trainer, state, args, sig: Tuple):
        self.check(trainer, state, sig)
        for static, x in zip(self._static, _tensors(args)):
            if static is not x:
                static.copy_(x)
        self.graph.replay()
        self.replays += 1
        _add_launches(self.launches)
        if not self.program.clone_outputs:
            return self.static_out
        return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, self.static_out)


class Program:
    """One step kind's body and the graphs built from it, by state,
    model and batch signature: what the trainer's cache holds for a step
    kind, as the reference's holds a jitted callable.

    `body(trainer, state, args)` runs one step on `args`, the step's
    device inputs, and returns its device outputs. `clone_outputs`: a
    replay returns copies of the graph's static outputs (which the next
    replay overwrites) rather than the outputs themselves; an eval step's
    are consumed before the next replay and are not copied."""

    def __init__(self, kind: str, body: Callable, clone_outputs: bool = True):
        self.kind = kind
        self.body = body
        self.clone_outputs = clone_outputs
        self._graphs: Dict[Tuple, Graph] = {}
        self._lock = threading.Lock()

    def capture(self, trainer, state, args, sig: Tuple) -> Graph:
        """A new graph of this program for `state` and `args` (whose
        `batch_signature` is `sig`): captured on the card when the trainer
        captures, else the eager body."""
        if trainer.capture_reason is not None:
            return EagerGraph(self, trainer, state, sig)
        graph = CapturedGraph(self, trainer, state, args, sig)
        logger.info(
            "captured the %s step as a CUDA graph for %s: %.3f s (warm-up "
            "%.3f s), pool %d bytes, %s hand-written kernel launches a "
            "replay", self.kind, sig, graph.capture_s, graph.warmup_s,
            graph.pool_bytes, dict(graph.launches))
        return graph

    def graph_for(self, trainer, state, args, sig: Tuple) -> Graph:
        """The graph of this program for `state` and `sig`, built on the
        first call."""
        key = (id(trainer.model), id(state), sig)
        with self._lock:
            graph = self._graphs.get(key)
        if graph is not None and graph.bound_to(trainer, state):
            return graph
        graph = self.capture(trainer, state, args, sig)
        with self._lock:
            self._graphs[key] = graph
        weakref.finalize(state, self._drop, key)
        return graph

    def _drop(self, key: Tuple) -> None:
        with self._lock:
            self._graphs.pop(key, None)

    def graphs(self) -> List[Graph]:
        with self._lock:
            return list(self._graphs.values())

    def __call__(self, trainer, state, args):
        sig = batch_signature(args)
        return self.graph_for(trainer, state, args, sig)(
            trainer, state, args, sig)
