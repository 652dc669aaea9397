#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing one JSON line; any failure raises and exits
non-zero (no phase's error is caught):

1. env     torch/CUDA versions, `nvcc --version`, the card's name and
           power limit (also printed raw, as nvidia-smi gives them).
2. build   compile every kernel of the path from `elasticdl_tpu_torch/csrc`.
3. kernel  K1 (`place_sorted_grads`) against its plain version on the card
           over the DeepFM shape (uniform hashed ids, D=17 and 16), a
           stream with 30% of its slots on one id, one with out-of-range
           and negative sentinels, and an empty one. Each entry is held to
           1e-6 + 1e-5 x the sum of the magnitudes of its terms: only the
           summation order differs. Times with CUDA events (median of 21
           groups of 10 launches, after warm-up), beside the bound and the
           `index_add_` yardstick.
4. parity  a small DeepFM (field_vocab=1000, hidden=32,32, float32
           compute) on the card and on the CPU from the same weights:
           loss rtol 1e-5, every gradient rtol 1e-5 with atol 1e-6 of its
           largest value. This checks K1 inside autograd.
5. train   the main path at DeepFM's full width (2,605,056 x 17 table,
           hidden 400,400, bf16 tower, batch 8192): JobConfig -> ModelSpec
           -> Trainer (device defaulted, so the GPU) -> init_state ->
           train_step x STEPS on one repeated batch -> eval_step ->
           predict_step. Losses must be finite and fall, and K1 must have
           launched once per train step.
6. profile torch.profiler over three more full-width steps: the device's
           busy share, kernels launched per step, the top kernels.
Then the `kernels` line, the nvidia-smi line, and last the `ok` line.

It exits non-zero without a result where CUDA is unavailable, and where
the port's package is absent.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
STEPS = 20
BATCH = 8192
FIELD_VOCAB = 100_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, groups=21, per_group=10, warmup=3):
    """Median over `groups` of the mean time of `per_group` back-to-back
    calls, from CUDA events (the host queues ahead, so launch overhead
    overlaps the device's work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return statistics.median(times)


def criteo_batch(seed, b=BATCH):
    """Synthetic Criteo batch, as bench.py's DeepFM leg makes them."""
    r = np.random.RandomState(seed)
    return {
        "features": {
            "dense": r.rand(b, 13).astype(np.float32),
            "cat": r.randint(0, 1 << 30, (b, 26)).astype(np.int32),
        },
        "labels": r.randint(0, 2, (b,)).astype(np.int32),
    }


def k1_streams(dev):
    """(name, sorted ids, rows, num_rows) at the DeepFM backward's shape:
    N = 8192 x 26 ids of the full-width table, hashed as the model hashes
    them."""
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm
    from elasticdl_tpu_torch.ops import embedding as emb

    spec = deepfm.feature_spec(FIELD_VOCAB)
    num_rows = emb.padded_vocab(spec.total_vocab)
    cat = torch.from_numpy(criteo_batch(7)["features"]["cat"]).to(dev)
    ids = spec.device_transform(
        {"dense": torch.zeros((BATCH, 13), device=dev), "cat": cat}
    )["cat"].reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = ids.numel()

    def rows(d):
        return torch.randn((n, d), generator=gen, device=dev)

    skewed = ids.clone()
    skewed[torch.randperm(n, generator=gen, device=dev)[: (3 * n) // 10]] = 12345
    oob = ids.clone()
    oob[::7] = emb.OOB_ID
    oob[1::11] = -1
    oob[2::13] = num_rows
    out = []
    for name, i, d in (("deepfm_uniform_d17", ids, 17),
                       ("deepfm_uniform_d16", ids, 16),
                       ("skewed_30pct_one_id", skewed, 17),
                       ("oob_and_negative_sentinels", oob, 17)):
        out.append((name, torch.sort(i, stable=True)[0].contiguous(),
                    rows(d), num_rows))
    out.append(("empty", torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0, 17), device=dev), num_rows))
    return out


def phase_kernel(dev):
    from elasticdl_tpu_torch.ops import placement

    report, worst_abs, worst_rel = {}, 0.0, 0.0
    timed = None
    for name, ids, rows, num_rows in k1_streams(dev):
        got = placement.place_sorted_grads(ids, rows, num_rows)
        torch.cuda.synchronize()
        want = placement.place_sorted_grads_plain(ids, rows, num_rows)
        mag = placement.place_sorted_grads_plain(ids, rows.abs(), num_rows)
        err = (got - want).abs()
        ok = bool((err <= 1e-6 + 1e-5 * mag).all())
        max_abs = float(err.max()) if err.numel() else 0.0
        max_rel = float((err / mag.clamp_min(1e-30)).max()) if err.numel() else 0.0
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        entry = {"n": ids.numel(), "d": rows.shape[1], "num_rows": num_rows,
                 "max_abs_err": max_abs, "max_rel_err": max_rel, "ok": ok}
        if ids.numel():
            entry["ms"] = time_ms(
                lambda: placement.place_sorted_grads(ids, rows, num_rows))
        report[name] = entry
        if not ok:
            emit("kernel", streams=report)
            raise AssertionError(f"K1 disagrees with its plain version on {name}")
        if name == "deepfm_uniform_d17":
            timed = (ids, rows, num_rows)

    ids, rows, num_rows = timed
    n, d = rows.shape
    ids64 = ids.to(torch.int64)
    plain_ms = time_ms(
        lambda: placement.place_sorted_grads_plain(ids, rows, num_rows))
    library_ms = time_ms(
        lambda: torch.zeros((num_rows, d), device=dev).index_add_(0, ids64, rows))
    bytes_moved = n * 4 + n * d * 4 + num_rows * d * 4
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, n * d / F32_FLOPS) * 1e3
    emit("kernel", streams=report, bytes=bytes_moved, bound_ms=bound_ms,
         plain_ms=plain_ms, library_ms=library_ms)
    return {
        "ms": report["deepfm_uniform_d17"]["ms"], "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms,
        "max_abs_err": worst_abs, "max_rel_err": worst_rel,
    }


def load_spec(params, dtype=None):
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec

    argv = ["--model_zoo", ZOO, "--model_def", "deepfm.deepfm.custom_model",
            "--model_params", params]
    if dtype:
        argv += ["--compute_dtype", dtype]
    return ModelSpec.from_config(JobConfig.from_argv(argv))


def phase_parity():
    from elasticdl_tpu_torch.training.trainer import Trainer

    batch = criteo_batch(11, b=1024)
    results, weights = [], None
    for dev in ("cpu", "cuda"):
        tr = Trainer(load_spec("field_vocab=1000;hidden=32,32", "float32"),
                     device=dev)
        state = tr.init_state(batch)
        if weights is None:
            weights = {k: v.detach().clone()
                       for k, v in tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        loss, grads = tr.compute_grads(state, batch)
        results.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
    worst = 0.0
    for k, want in cpu_grads.items():
        got = gpu_grads[k]
        atol = 1e-6 * float(want.abs().max())
        err = (got - want).abs()
        worst = max(worst, float((err / (atol + 1e-5 * want.abs())).max()))
        if not bool((err <= atol + 1e-5 * want.abs()).all()):
            raise AssertionError(f"gradient of {k} differs between cuda and cpu")
    if abs(gpu_loss - cpu_loss) > 1e-5 * abs(cpu_loss):
        raise AssertionError(f"loss {gpu_loss} on cuda vs {cpu_loss} on cpu")
    emit("parity", loss_cuda=gpu_loss, loss_cpu=cpu_loss,
         params=len(cpu_grads), worst_grad_err_over_tol=worst)


def phase_train():
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.trainer import Trainer

    spec = load_spec(f"field_vocab={FIELD_VOCAB};hidden=400,400")
    trainer = Trainer(spec)                 # device defaulted: the GPU
    if trainer.device.type != "cuda":
        raise AssertionError(f"Trainer defaulted to {trainer.device}")
    batch = criteo_batch(100)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(batch)
    table = state.params["fm_embedding.table"]

    placement.launches = 0
    losses = []
    state, logs = trainer.train_step(state, batch)      # warm-up step
    losses.append(logs["loss"])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS - 1):
        state, logs = trainer.train_step(state, batch)
        losses.append(logs["loss"])
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / (STEPS - 1)
    metric_states = trainer.eval_step(state, batch,
                                      trainer.new_metric_states())
    preds = trainer.predict_step(state, batch)
    torch.cuda.synchronize()
    launches = placement.launches

    losses = [float(x) for x in losses]
    results = trainer.metric_results(metric_states)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if launches != STEPS:
        raise AssertionError(f"K1 launched {launches} times in {STEPS} steps")
    if tuple(preds.shape) != (BATCH,) or not bool(torch.isfinite(preds).all()):
        raise AssertionError(f"predictions {tuple(preds.shape)} not finite")
    emit("train", table=list(table.shape), batch=BATCH, steps=STEPS,
         losses=losses, step_ms=step_ms,
         host_step_ms=host_s * 1e3 / (STEPS - 1),
         samples_per_s=BATCH / (step_ms / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         k1_launches=launches, eval=results,
         predict_shape=list(preds.shape))
    phase_profile(trainer, state, batch, step_ms)
    return launches


def phase_profile(trainer, state, batch, step_ms, steps=3):
    """Where a full-width step's time goes: torch.profiler over `steps`
    train steps (after the counted run), device activity summed by name.
    Prints device ms per step, the device's busy share of the unprofiled
    step (`step_ms`), kernels launched per step, and the activities that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    device_ms = sum(us for us, _ in by_name.values()) / 1e3 / steps
    kernels = sum(n for name, (_, n) in by_name.items()
                  if not name.startswith(("Memcpy", "Memset"))) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", steps=steps,
         profiled_wall_ms_per_step=wall_ms / steps,
         device_ms_per_step=device_ms if by_name else "not measured",
         device_busy_share=device_ms / step_ms if by_name
         else "not measured",
         kernels_per_step=kernels,
         top=[{"ms_per_step": us / 1e3 / steps, "per_step": n / steps,
               "name": name[:100]} for name, (us, n) in top])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from elasticdl_tpu_torch.ops import native, placement

    dev = torch.device("cuda")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         nvcc=run([native.nvcc(), "--version"]).splitlines()[-1])

    t0 = time.perf_counter()
    built = native.build([placement.KERNEL])
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"path": os.path.relpath(v["path"], REPO),
                      "ptxas": [ln for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in built.items()})

    k1 = phase_kernel(dev)
    phase_parity()
    launches = phase_train()

    print(json.dumps({"kernels": [{
        "name": placement.KERNEL,
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/place_sorted_grads.cu",
        "replaces": "elasticdl_tpu/ops/pallas_scatter.py:150",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "max_rel_err": k1["max_rel_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k1["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
