"""Checkpointing of the port's TrainState.

Counterpart of `elasticdl_tpu/training/checkpoint.py` (`CheckpointManager`):
versioned checkpoints every `--checkpoint_steps`, keep
`--keep_checkpoint_max`, restore on restart. The reference writes orbax
checkpoints; the port has a format of its own, and reading an orbax
checkpoint is out of scope (a reference state crosses over through
`convert.train_state_from_flax` instead). One step is one directory:

  <dir>/<step>/state.pt     torch.save of {"format", "step", "params"
                            (name -> tensor), "buffers" (name -> tensor:
                            BatchNorm's running averages), "optimizer"
                            (the optimizer's state_dict, a schedule's
                            count included), "generator" (RNG state)}
  <dir>/embedding_geometry.json   the vocab-padding rule of the build that
                            wrote the newest steps (ops/embedding.py)

Hardening, as in the reference:

- A save is atomic: the state is written into a hidden temporary
  directory, the file and the directory are fsynced, and the directory is
  renamed into place, so a crash mid-save never leaves a step that
  `latest_step()` shows. The write runs on a background thread after the
  state has been copied to host memory (the counterpart of orbax's async
  save); `wait()` blocks until it is durable.
- `restore()` with no explicit step walks BACK past a newest step that is
  corrupt or partially written, restoring the newest step that loads and
  warning about every step skipped.
- A restore whose parameter shapes disagree with the model raises a
  `CheckpointGeometryError` that names the vocab-padding rule the
  checkpoint was written under, instead of walking back.
- Fault-injection sites `ckpt.save`, `ckpt.save.commit` and `ckpt.restore`
  (common/faults.py) sit in front of both operations.

Under a mesh (a cohort's TrainState carries one), checkpoints are
collective. `save` is joined by every rank: each split leaf's parts (a
sharded table's row ranges; the experts of an MoE layer, the stages of a
pipeline and Megatron's column and row splits, each along its dimension:
`TrainState.row_shards`), and those of its Adam slots, are gathered to
the mesh's leader, which writes the one-process format above; the other
ranks write nothing. `restore` reads the step on every rank, which keeps
its own part of each leaf. So a cohort's checkpoint restores at any
world size and mesh and in a plain worker, and the other way round. `save_overlapped` is the cohort's
preemption drain: the gather, the write handed to the background writer,
`overlap_fn` run meanwhile, then a wait for durability.

The embedding tier's shards are not state leaves: they live in their
owners' stores (`embedding/store.py`) and ride the same directory as
per-shard files, `<dir>/emb/<table>-shard<id>.npz`, in the reference's
format (`save_embedding_tier`, `restore_embedding_tier`).

The live handoff of the in-place rescale (`restore_or_handoff`) raises:
a port process drives one card, and a cohort re-forms through the
instance manager and a checkpoint (ROADMAP item 32, under "Differences of
design").
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry
from elasticdl_tpu_torch.parallel import mesh as mesh_lib

logger = default_logger(__name__)

_reg = default_registry()
_CKPT_SAVES = _reg.counter(
    "edl_ckpt_saves_total", "checkpoint saves initiated")
_CKPT_RESTORES = _reg.counter(
    "edl_ckpt_restores_total", "successful checkpoint restores")
_CKPT_WALKBACKS = _reg.counter(
    "edl_ckpt_restore_walkbacks_total",
    "corrupt/partial steps skipped during restore")
_CKPT_SAVE_S = _reg.histogram(
    "edl_ckpt_save_seconds", "save initiation wall time (async part excl.)")

GEOMETRY_FILE = "embedding_geometry.json"
STATE_FILE = "state.pt"
FORMAT = "elasticdl-tpu-torch-ckpt-v1"


class CheckpointGeometryError(RuntimeError):
    """A checkpoint cannot restore into this model because the embedding
    vocab-padding geometry changed between write and restore."""


def _current_geometry() -> Optional[dict]:
    from elasticdl_tpu_torch.ops import embedding as emb_ops

    return emb_ops.geometry_descriptor()


def _host_copy(tree: Any) -> Any:
    """A host-memory snapshot of a state_dict-like tree: tensors copied to
    the CPU, everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _slots(state: Any) -> Dict[int, str]:
    """The optimizer's slot index of each parameter name."""
    return {i: name for i, name in enumerate(state.params)}


def _whole_payload(state: Any) -> Optional[Dict[str, Any]]:
    """The one-process payload of `state` in host memory: under a mesh,
    each sharded table and its optimizer slots gathered whole to the
    mesh's leader (collective; None on every other rank)."""
    params = {k: p.detach() for k, p in state.params.items()}
    optimizer = state.optimizer.state_dict()
    mesh = state.mesh
    if mesh is not None:
        names = _slots(state)
        for name, rows in state.row_shards.items():
            params[name] = mesh_lib.gather_rows(mesh, params[name], rows)
        # state_dict() shares the slot dicts with the live optimizer:
        # gathered slots go into new ones
        optimizer["state"] = {
            i: {key: (mesh_lib.gather_rows(mesh, value,
                                           state.row_shards[names[i]])
                      if names[i] in state.row_shards and value.dim()
                      else value)
                for key, value in slot.items()}
            for i, slot in optimizer["state"].items()}
        if not mesh.is_leader:
            return None
    return {
        "format": FORMAT,
        "step": int(state.model_version),
        "params": _host_copy(params),
        # replicated: every rank holds the same buffers
        "buffers": _host_copy({k: b.detach()
                               for k, b in state.buffers.items()}),
        "optimizer": _host_copy(optimizer),
        "generator": state.generator.get_state(),
    }


def _part(value, rows):
    """This rank's part of a whole leaf (or of its optimizer slot)."""
    if rows is None or value.dim() <= rows.dim or \
            value.shape[rows.dim] != rows.rows:
        return value
    return value.narrow(rows.dim, rows.start, rows.size)


def _local_payload(state: Any, payload: Dict[str, Any]) -> Dict[str, Any]:
    """A one-process payload cut to this rank's part of each split leaf
    and of its optimizer slots."""
    if not state.row_shards:
        return payload
    names = _slots(state)
    params = dict(payload["params"])
    for name, rows in state.row_shards.items():
        params[name] = _part(params[name], rows)
    optimizer = dict(payload["optimizer"])
    optimizer["state"] = {}
    for i, slot in payload["optimizer"]["state"].items():
        rows = state.row_shards.get(names[i])
        optimizer["state"][i] = {key: _part(value, rows)
                                 for key, value in slot.items()}
    return {**payload, "params": params, "optimizer": optimizer}


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = int(keep)
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self.last_restored_step: Optional[int] = None

    # ------------------------------------------------------------------ #
    # geometry metadata

    def _geometry_path(self) -> str:
        return os.path.join(self._dir, GEOMETRY_FILE)

    def _record_geometry(self) -> None:
        """Write the embedding padding rule beside the checkpoints,
        refreshing a stale sidecar. Best-effort: a failed sidecar write must
        not fail the save that carries the actual training state."""
        geo = _current_geometry()
        stored = self.stored_geometry()
        if stored == geo:
            return
        if stored is not None:
            logger.warning(
                "embedding geometry sidecar is stale (%s); rewriting as %s "
                "— steps saved from here on carry the current geometry",
                stored, geo,
            )
        path = self._geometry_path()
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(geo, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            logger.exception("embedding geometry sidecar write failed")

    def stored_geometry(self) -> Optional[dict]:
        try:
            with open(self._geometry_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _raise_geometry_error(self, step: int, err: BaseException) -> None:
        """Turn a shape mismatch into an error naming the alignment to
        rebuild with."""
        stored = self.stored_geometry()
        current = _current_geometry()
        if stored is not None and stored != current:
            align = stored.get("vocab_align", 256)
            raise CheckpointGeometryError(
                f"checkpoint step {step} in {self._dir} was written under "
                f"embedding geometry {stored} but this build pads with "
                f"{current}. Rebuild the model with the checkpoint's "
                f"alignment — padded_vocab(v, align={align}) — or re-export "
                "the model under the new geometry."
            ) from err
        if stored is None:
            raise CheckpointGeometryError(
                f"checkpoint step {step} in {self._dir} does not match the "
                "model's parameter shapes and records no geometry metadata. "
                f"Original error: {err}"
            ) from err
        raise CheckpointGeometryError(
            f"checkpoint step {step} in {self._dir} does not match the "
            f"model's parameter shapes: {err}. The recorded padding rule "
            f"({stored}) matches this build, so this checkpoint belongs to "
            "a different model."
        ) from err

    # ------------------------------------------------------------------ #
    # saving

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def save(self, state: Any, step: Optional[int] = None, wait: bool = False) -> int:
        """Snapshot `state` to host memory and write it as step `step`
        (default: its model version) on the background writer. A step
        that is already on disk is kept as it is: a model version names
        one state. Under a mesh every rank calls it; the leader writes."""
        step = int(state.model_version if step is None else step)
        with tracing.span("ckpt.save", step=step, wait=wait) as sp:
            t0 = time.perf_counter()
            faults.fire("ckpt.save")
            self.wait()          # one write in flight at a time
            # under a mesh every rank joins the gather; only the leader
            # looks at the directory, which a follower may see before the
            # leader's last write has landed
            payload = (_whole_payload(state)
                       if state.mesh is not None else None)
            if state.mesh is None or state.mesh.is_leader:
                self._record_geometry()
                if os.path.isdir(self._step_dir(step)):
                    logger.info("checkpoint step %d already saved", step)
                else:
                    payload = payload or _whole_payload(state)
                    payload["step"] = step
                    self._writer = threading.Thread(
                        target=self._write, args=(step, payload),
                        name=f"edl-ckpt-save-{step}", daemon=True)
                    self._writer.start()
            if wait:
                self.wait()
            _CKPT_SAVES.inc()
            _CKPT_SAVE_S.observe(time.perf_counter() - t0)
            sp.set(dir=self._dir)
        logger.info("checkpoint step %d -> %s", step, self._dir)
        return step

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        tmp = os.path.join(self._dir, f".tmp-{step}-{os.getpid()}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            # chaos hook: a crash here dies with the step unpublished
            faults.fire("ckpt.save.commit")
            os.replace(tmp, self._step_dir(step))
            _fsync_dir(self._dir)
            self._gc()
        except Exception as e:   # the writer thread's boundary: wait() raises it
            self._write_error = e
            shutil.rmtree(tmp, ignore_errors=True)

    def _gc(self) -> None:
        if self._keep <= 0:
            return
        for old in self.all_steps()[:-self._keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def save_overlapped(self, state: Any, overlap_fn, step: Optional[int] = None) -> int:
        """The drain's final save: the snapshot (the gather, under a mesh)
        and the write handed to the background writer, `overlap_fn()` run
        while it writes, then a wait until the step is durable. Returns
        the step."""
        step = self.save(state, step=step)
        try:
            overlap_fn()
        finally:
            self.wait()
        return step

    def restore_or_handoff(self, abstract_state: Any, handoff, new_mesh,
                           step: Optional[int] = None) -> Optional[Any]:
        raise NotImplementedError(
            "restore_or_handoff (the in-place rescale's live state handoff) "
            "is not ported: a port process drives one card, and a cohort "
            "re-forms through the instance manager and a checkpoint "
            "(ROADMAP item 32, under 'Differences of design')")

    # ------------------------------------------------------------------ #
    # reading

    def latest_step(self, refresh: bool = False) -> Optional[int]:
        """The newest durable step. The port reads the directory on every
        call, so `refresh` (which the reference needs to see steps written
        by other processes) changes nothing."""
        del refresh
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isfile(
                os.path.join(self._dir, n, STATE_FILE)))

    def restore(self, state: Any, step: Optional[int] = None) -> Optional[Any]:
        """Restore into the live `state` (its params, optimizer slots,
        generator and step are overwritten in place) and return it, or
        None when there is no checkpoint.

        With an explicit `step`, that step is tried alone. Otherwise steps
        are tried newest-first: a corrupt or partial newest step is skipped
        with a loud warning and the previous one restored. Shape
        mismatches are not walked past (every step shares the model's
        geometry): they raise CheckpointGeometryError."""
        with tracing.span("ckpt.restore", step=step) as restore_span:
            return self._restore_traced(state, step, restore_span)

    def _restore_traced(self, state, step, restore_span):
        faults.fire("ckpt.restore")
        self.wait()
        candidates = [step] if step is not None else sorted(
            self.all_steps(), reverse=True)
        if not candidates:
            restore_span.set(outcome="no_checkpoint")
            return None
        last_err: Optional[BaseException] = None
        for i, cand in enumerate(candidates):
            try:
                payload = torch.load(
                    os.path.join(self._step_dir(cand), STATE_FILE),
                    map_location="cpu", weights_only=True)
                if payload.get("format") != FORMAT:
                    raise ValueError(f"unknown format {payload.get('format')!r}")
            except Exception as e:  # noqa: BLE001 — corrupt/partial: walk back
                last_err = e
                _CKPT_WALKBACKS.inc()
                remaining = len(candidates) - i - 1
                logger.warning(
                    "checkpoint step %d in %s failed to restore (%s: %s); "
                    "%s", cand, self._dir, type(e).__name__, e,
                    f"falling back to step {candidates[i + 1]}"
                    if remaining else "no older step left",
                )
                continue
            self._check_shapes(cand, state, payload["params"],
                               payload.get("buffers", {}))
            self._apply(state, _local_payload(state, payload))
            if i > 0:
                logger.warning(
                    "restored FALLBACK checkpoint step %d (skipped %d newer "
                    "corrupt/partial step(s): %s)", cand, i, candidates[:i])
            else:
                logger.info("restored checkpoint step %d from %s",
                            cand, self._dir)
            self.last_restored_step = cand
            _CKPT_RESTORES.inc()
            restore_span.set(restored_step=cand, walked_back=i)
            return state
        raise RuntimeError(
            f"every checkpoint step in {self._dir} failed to restore "
            f"(tried {candidates})"
        ) from last_err

    def _check_shapes(self, step: int, state, saved: Dict[str, Any],
                      saved_buffers: Dict[str, Any]) -> None:
        want = {k: tuple(p.shape) for k, p in state.params.items()}
        for k, rows in state.row_shards.items():
            shape = list(want[k])
            shape[rows.dim] = rows.rows
            want[k] = tuple(shape)
        want.update({k: tuple(b.shape) for k, b in state.buffers.items()})
        have = {k: tuple(t.shape) for k, t in saved.items()}
        have.update({k: tuple(t.shape) for k, t in saved_buffers.items()})
        problems = [
            f"{k}: model wants {want[k]}, checkpoint holds {have[k]}"
            for k in sorted(set(want) & set(have)) if want[k] != have[k]]
        problems += [f"{k}: missing from checkpoint"
                     for k in sorted(set(want) - set(have))]
        problems += [f"{k}: not a parameter of the model"
                     for k in sorted(set(have) - set(want))]
        if problems:
            self._raise_geometry_error(step, ValueError("; ".join(problems)))

    @staticmethod
    def _apply(state, payload: Dict[str, Any]) -> None:
        with torch.no_grad():
            for name, p in state.params.items():
                p.copy_(payload["params"][name])
            for name, b in state.buffers.items():
                b.copy_(payload["buffers"][name])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.generator.set_state(payload["generator"])
        state.step = int(payload["step"])

    # ------------------------------------------------------------------ #
    # embedding tier shards (embedding/store.py): one atomic file a shard,
    # rows and exactly-once watermarks, beside the steps

    def save_embedding_tier(self, store, tables=None) -> int:
        """Persist every tier shard resident in `store` into
        `<dir>/emb/`; returns shards written."""
        with tracing.span("ckpt.embedding_tier_save") as sp:
            n = store.save(self._dir, tables)
            sp.set(shards=n)
        return n

    def restore_embedding_tier(self, store) -> int:
        """Install any checkpointed shard the store's current map assigns
        here but that is not yet resident; returns shards restored."""
        with tracing.span("ckpt.embedding_tier_restore") as sp:
            n = store.restore_missing(self._dir)
            sp.set(shards=n)
        return n

    @property
    def directory(self) -> str:
        return self._dir

    def wait(self) -> None:
        """Block until the in-flight save is durable; re-raise its error."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._write_error = self._write_error, None
        if err is not None:
            raise RuntimeError(f"checkpoint write failed: {err}") from err

    def delete(self, step: int) -> None:
        """Discard a saved step (drain checkpoints whose retirement report
        the master rejected must not be restored)."""
        try:
            self.wait()
            shutil.rmtree(self._step_dir(step))
            logger.info("deleted checkpoint step %d", step)
        except Exception:
            logger.exception("failed to delete checkpoint step %d", step)

    def close(self) -> None:
        self.wait()
