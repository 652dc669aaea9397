#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Three main paths: the DeepFM job (master, worker, data, checkpoint,
eval, export) and its train step (kernel K1: its zero pass and its
placement pass), and the transformer LM train step (flash-attention
kernels: for its bfloat16 D 64 attention the Hopper kernels K2', K3', K4'
and the delta pass, which runs once a backward; K2, K3 and K4 for every
other input, such as the float32 LM). Phases, each printing one JSON line;
any failure raises and exits non-zero (no phase's error is caught):

1. env     torch/CUDA versions, `nvcc --version`, the card's name and
           power limit (also printed raw, as nvidia-smi gives them).
2. build   compile every kernel of both paths from
           `elasticdl_tpu_torch/csrc` (one nvcc per source, all at once),
           with ptxas's registers and spills for each kernel, the dynamic
           shared memory each Hopper kernel's launch asks for, and the
           HGMMA (wgmma) instructions in each kernel's SASS (`cuobjdump
           --dump-sass`): K2', K3' and K4' must have some.
3. kernel  K1 (`place_sorted_grads`) against its plain version on the card
           over the DeepFM shape (uniform hashed ids, D=17 and 16), a
           stream with 30% of its slots on one id, one with all of them on
           one id, one with out-of-range and negative sentinels, and an
           empty one. Each entry is held to 1e-6 + 1e-5 x the sum of the
           magnitudes of its terms (only the summation order differs), and
           a second call must give the same bits. Every stream's time with
           CUDA events (median of 21 groups of 10 calls, after warm-up)
           and its device time from torch.profiler, beside the bound, the
           plain version and the `index_add_` yardstick.
4. parity  a small DeepFM (field_vocab=1000, hidden=32,32, float32
           compute) on the card and on the CPU from the same weights:
           loss rtol 1e-5, every gradient rtol 1e-5 with atol 1e-6 of its
           largest value. This checks K1 inside autograd.
5. train   the main path at DeepFM's full width (2,605,056 x 17 table,
           hidden 400,400, bf16 tower, batch 8192): JobConfig -> ModelSpec
           -> Trainer (device defaulted, so the GPU) -> init_state ->
           train_step x STEPS on one repeated batch -> eval_step ->
           predict_step. Losses must be finite and fall, and K1's two
           kernels must have launched once each per train step.
6. profile torch.profiler over three more full-width steps: the device's
           busy share, kernels launched per step, the top kernels.
7. attn_kernel  the flash kernels against their plain versions on the
           card, each case through the routing wrappers (the forward, then
           the whole backward `flash_bwd`), which must take the Hopper
           kernels for bf16 at D 64 and 128 (K4' at D 64 only; one delta
           pass a backward) and K2-K4 elsewhere: at the LM's full shape (B8
           T1024 H8, causal) in bf16 at D 64 and 128 and in float32 at
           D 64; on small float32 cases at D 16 and their bf16 twins at
           D 64 (offsets (32,0), (16,0), (64,32); not causal with Tq 32,
           Tk 96 (bf16: Tq 100, Tk 230, tails); a fully masked geometry,
           q_offset 0 and kv_offset 1024, where out and every gradient
           must be 0 and finite; lse with a random g_lse). A second
           backward must give the same bits. Every bf16 case on the Hopper
           route also holds the delta pass to (dout . out).sum(-1) -
           g_lse. Tolerances: float32 out, lse and delta 2e-5, gradients
           5e-5 with atol 5e-5 of the largest value (the reference's own
           for its kernel); bf16 rtol 2**-7 (one bf16 ulp: both sides
           compute in float32 from the same inputs and round once) with
           atol 1e-2 of the output's rms. Times at the bf16 full shape
           (D 64) beside the bound and the scaled_dot_product_attention
           (flash backend) yardstick, with K2, K3 and K4 timed on the same
           bf16 inputs through their launchers, the Hopper kernels' device
           times from torch.profiler, and the whole backward against
           SDPA's backward in turns over 7 rounds.
8. lm_parity  a small LM (vocab 64, 2 layers, dim 64, 4 heads, float32,
           T 32) on the card and on the CPU from the same weights: loss
           rtol 5e-5, every gradient rtol 5e-5 with atol 5e-5 of its
           largest value (the k biases, 0 in exact arithmetic, within 1e-6
           of the largest gradient entry of 0). This float32 LM is the
           main path that launches K2, K3 and K4 (D 16).
9. lm_train  the LM at the width bench.py benchmarks it (vocab 8192, 4
           layers, dim 512, 8 heads, bf16, 8 x 1024 random tokens): 20
           train steps (one warm-up), eval_step, predict_step. Losses must
           be finite and fall; K2', K3', K4' and the delta pass must each
           launch 4 times (one per layer) in every train step and K2-K4
           never, and K2' 4 times in each of eval and predict. Then its
           profile, as in 6.
10. job   the job path in one process, at DeepFM's full width
           (field_vocab=100000, hidden 400,400, minibatch 8192): the
           port's Master and its Worker (on a thread, device defaulted:
           the card) run `synthetic://criteo?n=65536&shards=4` in 4
           training tasks of 2 steps (16384 records a task), an eval job
           at epoch end over 16384 records, checkpoints every 4 steps
           (2 kept), the final SAVE_MODEL and the export. Asserts 4
           finished tasks and none failed, a finite eval AUC and loss,
           K1 launched exactly 2 x the worker's 8 train steps (its count
           set to 0 just before the job), checkpoint steps 4 and 8 with
           the newest restoring a fresh state to the final one exactly,
           and the export loading on the card and predicting as the final
           state does (atol 1e-6 on float32 logits). Prints samples/s
           over the train steps, the host ms a step, the per-step ms the
           reader and parser (data_wait) and the prefetcher (h2d) took,
           and which parser ran, beside the card's name and power limit.
11. job_cli  the same job at a smaller depth (16384 records in 2 tasks)
           through the CLI, `python -m elasticdl_tpu_torch.client.main
           train`: run_local -> ProcessManager -> one
           `elasticdl_tpu_torch.worker.main` subprocess on the card, with
           an explicit environment (no cohort variables, no device
           request). Asserts exit 0, a checkpoint step on disk, an export
           that loads and predicts finite values on the card, and a
           worker log that names a cuda device; prints the log's tail if
           any check fails.
Then the `kernels` line (K1's `launches` are the job's), the nvidia-smi
line, and last the `ok` line.

It exits non-zero without a result where CUDA is unavailable, and where
the port's package is absent.
"""

import ctypes
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
BF16_FLOPS = 989e12              # H100 SXM dense bf16
# the LM as bench.py's transformer_lm leg runs it (bench.py:4398-4407)
LM_PARAMS = "vocab=8192;num_layers=4;dim=512;heads=8;max_len=1024"
LM_LAYERS, LM_BATCH, LM_T, LM_VOCAB = 4, 8, 1024, 8192
LM_SMALL = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64"
# the job phases: Criteo records per training task, and the variables a
# polluted environment can carry that would make a spawned worker a member
# of a cohort that never forms
JOB_TASK = 16384
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR")


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
    one_id = torch.full_like(ids, 12345)
    oob = ids.clone()
    oob[::7] = emb.OOB_ID
    oob[1::11] = -1
    oob[2::13] = num_rows
    out = []
    for name, i, d in (("deepfm_uniform_d17", ids, 17),
                       ("deepfm_uniform_d16", ids, 16),
                       ("skewed_30pct_one_id", skewed, 17),
                       ("one_id_100pct", one_id, 17),
                       ("oob_and_negative_sentinels", oob, 17)):
        out.append((name, torch.sort(i, stable=True)[0].contiguous(),
                    rows(d), num_rows))
    out.append(("empty", torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0, 17), device=dev), num_rows))
    return out


def device_ms(fn, names, calls=20):
    """{name: device ms a call} of each kernel whose symbol contains one of
    `names`, from torch.profiler over `calls` calls of `fn` after one
    warm-up; "not measured" where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {name: 0.0 for name in names}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.name:
                us[name] += e.time_range.elapsed_us()
    return {name: (t / 1e3 / calls if t else "not measured")
            for name, t in us.items()}


K1_SYMBOLS = ("place_zero_kernel", "place_sorted_grads_kernel")


def phase_kernel(dev):
    from elasticdl_tpu_torch.ops import placement

    report, worst_abs, worst_rel = {}, 0.0, 0.0
    for name, ids, rows, num_rows in k1_streams(dev):
        got = placement.place_sorted_grads(ids, rows, num_rows)
        again = placement.place_sorted_grads(ids, rows, num_rows)
        torch.cuda.synchronize()
        want = placement.place_sorted_grads_plain(ids, rows, num_rows)
        mag = placement.place_sorted_grads_plain(ids, rows.abs(), num_rows)
        err = (got - want).abs()
        same = bool(torch.equal(got, again))
        ok = bool((err <= 1e-6 + 1e-5 * mag).all()) and same
        max_abs = float(err.max()) if err.numel() else 0.0
        max_rel = float((err / mag.clamp_min(1e-30)).max()) if err.numel() else 0.0
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        n, d = rows.shape
        entry = {"n": n, "d": d, "num_rows": num_rows,
                 "max_abs_err": max_abs, "max_rel_err": max_rel,
                 "bit_identical_rerun": same, "ok": ok}
        if n:
            ids64 = ids.to(torch.int64)
            entry["ms"] = time_ms(
                lambda: placement.place_sorted_grads(ids, rows, num_rows))
            entry["device_ms"] = device_ms(
                lambda: placement.place_sorted_grads(ids, rows, num_rows),
                K1_SYMBOLS)
            # index_add_ takes in-range ids only (it asserts on the rest)
            if bool(((ids >= 0) & (ids < num_rows)).all()):
                entry["library_ms"] = time_ms(
                    lambda: torch.zeros((num_rows, d), device=dev)
                    .index_add_(0, ids64, rows))
            entry["plain_ms"] = time_ms(
                lambda: placement.place_sorted_grads_plain(ids, rows,
                                                           num_rows),
                groups=5, per_group=3)
            bytes_moved = n * 4 + n * d * 4 + num_rows * d * 4
            entry["bound_ms"] = max(bytes_moved / HBM_BYTES_PER_S,
                                    n * d / F32_FLOPS) * 1e3
        report[name] = entry
        if not ok:
            emit("kernel", streams=report)
            raise AssertionError(f"K1 disagrees with its plain version (or "
                                 f"with itself) on {name}")
    emit("kernel", streams=report, passes_a_call=placement.PASSES)
    timed = report["deepfm_uniform_d17"]
    return {
        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "library_ms": timed["library_ms"], "bound_ms": timed["bound_ms"],
        "device_ms": timed["device_ms"],
        "skewed_ms": report["skewed_30pct_one_id"]["ms"],
        "max_abs_err": worst_abs, "max_rel_err": worst_rel,
    }


def load_spec(params, dtype=None, model_def="deepfm.deepfm.custom_model"):
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec

    argv = ["--model_zoo", ZOO, "--model_def", model_def,
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
    if launches != placement.PASSES * STEPS:
        raise AssertionError(f"K1 launched {launches} kernels in {STEPS} "
                             f"steps, want {placement.PASSES} a step")
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


PALLAS = "elasticdl_tpu/ops/pallas_attention.py"
CSRC = "elasticdl_tpu_torch/csrc"
# name: (source, the TPU kernel's pallas_call it replaces)
ATTN_KERNELS = {
    "flash_fwd": (f"{CSRC}/flash_attention.cu", f"{PALLAS}:256"),
    "flash_fwd_sm90": (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:256"),
    "flash_bwd_dq": (f"{CSRC}/flash_attention.cu", f"{PALLAS}:404"),
    "flash_bwd_dq_sm90": (f"{CSRC}/flash_attention_sm90.cu",
                          f"{PALLAS}:404"),
    "flash_bwd_dkv": (f"{CSRC}/flash_attention.cu", f"{PALLAS}:433"),
    "flash_bwd_dkv_sm90": (f"{CSRC}/flash_attention_sm90.cu",
                           f"{PALLAS}:433"),
    # the delta fold of both backward kernels (pallas_attention.py:302-307)
    "flash_bwd_delta_sm90": (f"{CSRC}/flash_attention_sm90.cu",
                             f"{PALLAS}:404"),
}


def short_name(mangled):
    """A kernel's entry name with its template arguments, from the mangled
    symbol."""
    k = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(\w+?)Li(\d+)E",
                  mangled)
    if k:
        dtype = "bf16" if "bfloat16" in k.group(2) else "f32"
        return f"{k.group(1)}<{dtype},G={k.group(3)}>"
    k = re.search(
        r"(flash_(?:fwd|bwd_dq|bwd_dkv|bwd_delta)_sm90_kernel)ILi(\d+)E",
        mangled)
    if k:
        return f"{k.group(1)}<D={k.group(2)}>"
    for name in K1_SYMBOLS:
        if name in mangled:
            return name
    return mangled


def ptxas_summary(log):
    """{kernel: "N registers, spills, shared memory ..."} from nvcc's
    -Xptxas -v log, with each entry function's mangled name shortened to
    its kernel and template arguments."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = short_name(m.group(1))
        elif name and ("registers" in ln or "spill" in ln):
            text = ln.split("ptxas info    :")[-1].strip()
            out[name] = (out[name] + "; " + text) if name in out else text
    return out


def hgmma_counts(path):
    """{kernel: HGMMA instructions in its SASS} of a built library."""
    from elasticdl_tpu_torch.ops import native

    cuobjdump = os.path.join(os.path.dirname(native.nvcc()), "cuobjdump")
    sass = run([cuobjdump, "--dump-sass", path])
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = short_name(m.group(1))
            counts[name] = 0
        elif name and "HGMMA" in ln:
            counts[name] += 1
    return counts


def attn_inputs(dev, b, tq, tk, h, d, dtype, seed):
    """q, k, v, dout (B, T, H, D) in `dtype` and a g_lse (B, H, Tq)
    float32, drawn on the card from `seed`."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rand(b, tq, h, d), rand(b, tk, h, d), rand(b, tk, h, d),
            rand(b, tq, h, d),
            torch.randn((b, h, tq), generator=g, device=dev))


def over_tol(got, want, rtol, atol_of_max=0.0, atol_of_rms=0.0):
    """(max abs error, largest error / its tolerance), where the tolerance
    is atol_of_max x max|want| + atol_of_rms x rms(want) + rtol x |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol = atol_of_max * float(want.abs().max())
    if atol_of_rms:                     # rms of -1e30 entries is inf
        atol += atol_of_rms * float(want.square().mean().sqrt())
    tol = atol + rtol * want.abs()
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max())


def attn_bound(b, t, h, d, itemsize, kernel):
    """(bound ms, "operations" or "bytes") of one causal call at the full
    shape: FLOPs 4, 6 or 8 x B.H.T^2.D / 2 (forward, dQ, dK/dV; 14 for
    the whole backward) at the bf16 peak, bytes of each input read once
    and each output written once. K3' and K4' read delta where K3 and K4
    read O; the delta pass does 2 B.T.H.D FLOPs on float32 (the CUDA
    cores' peak)."""
    act = b * t * h * d * itemsize
    rows = b * h * t * 4
    flops, moved, peak = {
        "flash_fwd": (4, 3 * act + act + rows, BF16_FLOPS),  # q k v -> out lse
        "flash_bwd_dq": (6, 5 * act + rows + act, BF16_FLOPS),  # +o do lse
        "flash_bwd_dkv": (8, 5 * act + rows + 2 * act, BF16_FLOPS),
        "flash_bwd_dq_sm90": (6, 4 * act + 2 * rows + act, BF16_FLOPS),
        "flash_bwd_dkv_sm90": (8, 4 * act + 2 * rows + 2 * act, BF16_FLOPS),
        # q k v o do lse -> dq dk dv
        "flash_bwd": (14, 5 * act + rows + 3 * act, BF16_FLOPS),
        "flash_bwd_delta_sm90": (0, 2 * act + rows, F32_FLOPS),
    }[kernel.replace("flash_fwd_sm90", "flash_fwd")]
    flops = (flops * b * h * t * t * d / 2 if flops
             else 2 * b * t * h * d)
    by_ops, by_bytes = flops / peak, moved / HBM_BYTES_PER_S
    return max(by_ops, by_bytes) * 1e3, (
        "operations" if by_ops >= by_bytes else "bytes")


def ran(before, after):
    """The flash kernels launched between two snapshots of the counters."""
    return sorted(n for n in after if after[n] > before[n])


def phase_attn_kernel(dev):
    """The flash kernels against their plain versions through the routing
    wrappers, which must take the route `_sm90` names; returns the cases'
    report and each kernel's worst (max abs error, share of tolerance)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    full = (LM_BATCH, LM_T, LM_T, 8, 64, bf16)
    small, twin = (2, 32, 32, 2, 16, f32), (2, 32, 32, 2, 64, bf16)
    cases = [  # name, (B, Tq, Tk, H, D, dtype), causal, q_off, kv_off, g_lse
        ("full_b8_t1024_h8_d64_bf16_causal", full, True, 0, 0, False),
        ("full_b8_t1024_h8_d128_bf16_causal", full[:4] + (128, bf16), True,
         0, 0, False),
        ("full_b8_t1024_h8_d64_f32_causal", full[:5] + (f32,), True, 0, 0,
         False),
        ("f32_offsets_32_0", small, True, 32, 0, False),
        ("f32_offsets_16_0", small, True, 16, 0, False),
        ("f32_offsets_64_32", small, True, 64, 32, False),
        ("f32_not_causal_tq32_tk96", (2, 32, 96, 2, 16, f32), False, 0, 0,
         False),
        ("f32_fully_masked_kv_offset_1024", small, True, 0, 1024, False),
        ("f32_lse_with_g_lse", (2, 64, 64, 2, 16, f32), True, 0, 0, True),
        ("bf16_offsets_32_0", twin, True, 32, 0, False),
        ("bf16_offsets_16_0", twin, True, 16, 0, False),
        ("bf16_offsets_64_32", twin, True, 64, 32, False),
        ("bf16_not_causal_tq100_tk230", (2, 100, 230, 2, 64, bf16), False, 0,
         0, False),
        ("bf16_fully_masked_kv_offset_1024", twin, True, 0, 1024, False),
        ("bf16_lse_with_g_lse", (2, 64, 64, 2, 64, bf16), True, 0, 0, True),
    ]
    worst = {name: [0.0, 0.0] for name in ATTN_KERNELS}
    report = {}
    bf16_tol = (2 ** -7, 0.0, 1e-2)     # rtol, atol of max, of rms
    for seed, (name, shape, causal, q_off, kv_off, with_glse) in \
            enumerate(cases):
        b, tq, tk, h, d, dtype = shape
        q, k, v, dout, glse = attn_inputs(dev, b, tq, tk, h, d, dtype, seed)
        glse = glse if with_glse else None
        args = (causal, q_off, kv_off)
        before = dict(fa.launches)
        out, lse = fa.flash_fwd(q, k, v, *args)
        fwd = ran(before, fa.launches)
        before = dict(fa.launches)
        dq, dk, dv = fa.flash_bwd(q, k, v, out, dout, lse, glse, *args)
        bwd = {n: fa.launches[n] - before[n] for n in before
               if fa.launches[n] > before[n]}
        again = fa.flash_bwd(q, k, v, out, dout, lse, glse, *args)
        torch.cuda.synchronize()
        hopper_fwd = fa._sm90(dtype, d)
        hopper_dq = fa._sm90(dtype, d, fa.BWD_DQ_SM90)
        hopper_dkv = fa._sm90(dtype, d, fa.BWD_DKV_SM90)
        want_bwd = {fa.BWD_DQ_SM90 if hopper_dq else fa.BWD_DQ: 1,
                    fa.BWD_DKV_SM90 if hopper_dkv else fa.BWD_DKV: 1}
        if hopper_dq or hopper_dkv:
            want_bwd[fa.BWD_DELTA_SM90] = 1
        want_route = ([fa.FWD_SM90] if hopper_fwd else [fa.FWD], want_bwd)
        if (fwd, bwd) != want_route:
            raise AssertionError(f"{name}: launched {fwd} and {bwd}, the "
                                 f"route wants {want_route}")
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, *args)
        want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse, glse, *args)
        want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse,
                                                  glse, *args)
        is_f32 = dtype == f32
        out_tol = (2e-5, 2e-5) if is_f32 else bf16_tol
        grad_tol = (5e-5, 5e-5) if is_f32 else bf16_tol
        checks = {
            fwd[0]: [over_tol(out, want_out, *out_tol),
                     over_tol(lse, want_lse, 2e-5, 2e-5)],
            (fa.BWD_DQ_SM90 if hopper_dq else fa.BWD_DQ):
                [over_tol(dq, want_dq, *grad_tol)],
            (fa.BWD_DKV_SM90 if hopper_dkv else fa.BWD_DKV):
                [over_tol(dk, want_dk, *grad_tol),
                 over_tol(dv, want_dv, *grad_tol)],
        }
        if hopper_dq:
            delta = fa.flash_bwd_delta(out, dout, glse)
            checks[fa.BWD_DELTA_SM90] = [over_tol(
                delta, fa.flash_bwd_delta_plain(out, dout, glse), 2e-5, 2e-5)]
        entry = {"shape": [b, tq, tk, h, d], "dtype": str(dtype)[6:],
                 "causal": causal, "q_offset": q_off, "kv_offset": kv_off,
                 "g_lse": with_glse, "route": fwd + sorted(bwd),
                 "bwd_bit_identical_rerun": same}
        ok = same
        for kernel, results in checks.items():
            err = max(r[0] for r in results)
            ratio = max(r[1] for r in results)
            worst[kernel] = [max(worst[kernel][0], err),
                             max(worst[kernel][1], ratio)]
            entry[kernel] = {"max_abs_err": err, "err_over_tol": ratio}
            ok = ok and ratio <= 1.0
        if kv_off >= tq + q_off:            # every row fully masked
            zero = all(bool((x == 0).all()) and bool(torch.isfinite(x).all())
                       for x in (out, dq, dk, dv))
            entry["all_zero_and_finite"] = zero
            ok = ok and zero and bool((lse <= -1e29).all())
        entry["ok"] = ok
        report[name] = entry
        if not ok:
            emit("attn_kernel", cases=report)
            raise AssertionError(f"the flash kernels disagree with the plain "
                                 f"versions on {name}")
    return report, worst


def attn_times(dev, report, worst):
    """Every flash kernel at the bf16 full shape (D 64): K2' and K2, K3'
    and K4' (alone, and each with the delta pass) and K3 and K4 on the same
    inputs, through their launchers; K2, K3 and K4 are held to the plain
    versions there too, and K3' to itself over two runs. Device times of
    the Hopper kernels from the profiler beside the CUDA-event times, and
    the whole backward against SDPA's in turns."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h, d = LM_BATCH, LM_T, 8, 64
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, torch.bfloat16, 0)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_bwd_delta(out, dout)
    want_out, _ = fa.flash_fwd_plain(q, k, v)
    want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse)
    bf16_tol = (2 ** -7, 0.0, 1e-2)
    old_out, _ = fa.launch_fwd(q, k, v, True, 0, 0, False)
    old_dq = fa.launch_bwd_dq(q, k, v, out, dout, lse, None, True, 0, 0,
                              False)
    old_dk, old_dv = fa.launch_bwd_dkv(q, k, v, out, dout, lse, None, True,
                                       0, 0, False)
    new_dq = [fa.launch_dq_sm90(q, k, v, dout, lse, delta, True, 0, 0)
              for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(*new_dq):
        raise AssertionError("K3' differs between two runs at the full shape")
    for kernel, results in (
            (fa.FWD, [over_tol(old_out, want_out, *bf16_tol)]),
            (fa.BWD_DQ, [over_tol(old_dq, want_dq, *bf16_tol)]),
            (fa.BWD_DQ_SM90, [over_tol(new_dq[0], want_dq, *bf16_tol)]),
            (fa.BWD_DKV, [over_tol(old_dk, want_dk, *bf16_tol),
                          over_tol(old_dv, want_dv, *bf16_tol)])):
        err, ratio = max(r[0] for r in results), max(r[1] for r in results)
        if ratio > 1.0:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at the bf16 full shape ({ratio})")
        worst[kernel] = [max(worst[kernel][0], err),
                         max(worst[kernel][1], ratio)]
    plain_fwd = lambda: fa.flash_fwd_plain(q, k, v)
    plain_dq = lambda: fa.flash_bwd_dq_plain(q, k, v, out, dout, lse)
    plain_dkv = lambda: fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse)
    calls = {   # kernel: (its launch, its plain version)
        fa.FWD_SM90: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, True),
                      plain_fwd),
        fa.FWD: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, False),
                 plain_fwd),
        fa.BWD_DQ_SM90: (lambda: fa.launch_dq_sm90(q, k, v, dout, lse, delta,
                                                   True, 0, 0), plain_dq),
        fa.BWD_DQ: (lambda: fa.launch_bwd_dq(q, k, v, out, dout, lse, None,
                                             True, 0, 0, False), plain_dq),
        fa.BWD_DKV_SM90: (lambda: fa.launch_dkv_sm90(q, k, v, dout, lse,
                                                     delta, True, 0, 0),
                          plain_dkv),
        fa.BWD_DELTA_SM90: (lambda: fa.flash_bwd_delta(out, dout),
                            lambda: fa.flash_bwd_delta_plain(out, dout)),
        fa.BWD_DKV: (lambda: fa.launch_bwd_dkv(q, k, v, out, dout, lse, None,
                                               True, 0, 0, False),
                     plain_dkv),
    }
    lib_fwd = sdpa_fwd_ms(q, k, v)
    bwd = whole_backward(q, k, v, out, dout, lse)
    result = {}
    for kernel, (run_kernel, run_plain) in calls.items():
        bound_ms, bound_by = attn_bound(b, t, h, d, q.element_size(), kernel)
        fwd = kernel in (fa.FWD, fa.FWD_SM90)
        result[kernel] = {
            "max_abs_err": worst[kernel][0],
            "err_over_tol": worst[kernel][1],
            "ms": time_ms(run_kernel),
            "plain_ms": time_ms(run_plain, groups=5, per_group=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (None if kernel == fa.BWD_DELTA_SM90
                           else lib_fwd if fwd else bwd["sdpa_ms"]),
            "library": (None if kernel == fa.BWD_DELTA_SM90 else
                        "scaled_dot_product_attention forward, flash backend"
                        if fwd else
                        "scaled_dot_product_attention backward (dq, dk and "
                        "dv in one call), flash backend"),
        }
    for kernel in (fa.FWD_SM90, fa.BWD_DQ_SM90, fa.BWD_DKV_SM90,
                   fa.BWD_DELTA_SM90):
        symbol = f"{kernel}_kernel"
        result[kernel]["device_ms"] = device_ms(calls[kernel][0],
                                                (symbol,))[symbol]
    for kernel, launch in ((fa.BWD_DQ_SM90, fa.launch_bwd_dq),
                           (fa.BWD_DKV_SM90, fa.launch_bwd_dkv)):
        result[kernel]["ms_with_delta_pass"] = time_ms(
            lambda: launch(q, k, v, out, dout, lse, None, True, 0, 0, True))
    faster = {
        "k2_prime_under_k2": result[fa.FWD_SM90]["ms"] < result[fa.FWD]["ms"],
        "k3_prime_under_k3":
            result[fa.BWD_DQ_SM90]["ms_with_delta_pass"]
            < result[fa.BWD_DQ]["ms"],
        "k4_prime_with_delta_under_k4":
            result[fa.BWD_DKV_SM90]["ms_with_delta_pass"]
            < result[fa.BWD_DKV]["ms"],
        "whole_backward_under_sdpa": bwd["ms"] < bwd["sdpa_ms"],
    }
    emit("attn_kernel", cases=report, timed_shape=[b, t, h, d],
         timed_dtype="bfloat16", kernels=result, whole_backward=bwd,
         faster=faster)
    return result


def whole_backward(q, k, v, out, dout, lse, rounds=7):
    """The port's whole backward (`flash_bwd`: the delta pass, K3' and K4')
    against SDPA's backward (flash backend, the same dq, dk and dv; the
    port never calls it) on the same inputs, alternating the two over `rounds` rounds: each one's
    median and spread (ms), its device time from the profiler, and the
    bound of the whole backward."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    b, t, h, d = q.shape
    ours = lambda: fa.flash_bwd(q, k, v, out, dout, lse)
    qg, kg, vg = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = sdpa(qg, kg, vg, is_causal=True)
        theirs = lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                             retain_graph=True)
        times = {"ours": [], "sdpa": []}
        for _ in range(rounds):
            for name, fn in (("ours", ours), ("sdpa", theirs),
                             ("sdpa", theirs), ("ours", ours)):
                times[name].append(time_ms(fn, groups=5))
    ours_dev = device_ms(ours, ("flash_bwd_delta_sm90_kernel",
                                "flash_bwd_dq_sm90_kernel",
                                "flash_bwd_dkv_sm90_kernel"))
    bound_ms, bound_by = attn_bound(b, t, h, d, q.element_size(),
                                    "flash_bwd")
    return {
        "ms": statistics.median(times["ours"]),
        "ms_spread": [min(times["ours"]), max(times["ours"])],
        "sdpa_ms": statistics.median(times["sdpa"]),
        "sdpa_ms_spread": [min(times["sdpa"]), max(times["sdpa"])],
        "rounds": rounds, "device_ms": ours_dev,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def sdpa_fwd_ms(q, k, v):
    """ms of scaled_dot_product_attention's forward (flash backend,
    causal) on the same inputs, in its (B, H, T, D) layout: the library
    yardstick. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))


def lm_batch(seed, b=LM_BATCH, t=LM_T, vocab=LM_VOCAB):
    """Random tokens as bench.py's transformer_lm leg makes them (labels
    are the tokens themselves), all rows real."""
    r = np.random.RandomState(seed)
    toks = r.randint(0, vocab, (b, t)).astype(np.int32)
    return {"features": toks, "labels": toks,
            "mask": np.ones((b,), np.float32)}


def reset_launches():
    from elasticdl_tpu_torch.ops import flash_attention as fa

    for name in fa.launches:
        fa.launches[name] = 0


def phase_lm_parity():
    """The float32 LM on the card against the CPU; returns the flash
    kernels' launches in its card step (K2, K3 and K4: float32 takes the
    CUDA-core kernels)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.trainer import Trainer

    r = np.random.RandomState(21)
    toks = r.randint(0, 64, (8, 33)).astype(np.int32)
    mask = np.ones((8,), np.float32)
    mask[[2, 5]] = 0.0
    batch = {"features": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    results, weights = [], None
    for dev in ("cpu", "cuda"):
        tr = Trainer(load_spec(LM_SMALL, "float32",
                               "transformer.transformer_lm.custom_model"),
                     device=dev)
        state = tr.init_state(batch)
        if weights is None:
            weights = {n: t.detach().clone()
                       for n, t in tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        reset_launches()
        loss, grads = tr.compute_grads(state, batch)
        results.append((float(loss), {n: g.cpu() for n, g in grads.items()}))
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    layers = 2                          # LM_SMALL's num_layers
    if launches != {**{n: 0 for n in launches}, fa.FWD: layers,
                    fa.BWD_DQ: layers, fa.BWD_DKV: layers}:
        raise AssertionError(f"flash launches in the float32 LM's step: "
                             f"{launches}")
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
    largest = max(float(g.abs().max()) for g in cpu_grads.values())
    worst = 0.0
    for name, want in cpu_grads.items():
        got = gpu_grads[name]
        if name.endswith(".k.bias"):       # 0 in exact arithmetic
            if max(float(got.abs().max()), float(want.abs().max())) \
                    > 1e-6 * largest:
                raise AssertionError(f"{name} is not ~0 on both devices")
            continue
        _, ratio = over_tol(got, want, 5e-5, 5e-5)
        worst = max(worst, ratio)
        if ratio > 1.0:
            raise AssertionError(f"gradient of {name} differs between cuda "
                                 f"and cpu ({ratio} of its tolerance)")
    if abs(gpu_loss - cpu_loss) > 5e-5 * abs(cpu_loss):
        raise AssertionError(
            f"LM loss {gpu_loss} on cuda vs {cpu_loss} on cpu")
    emit("lm_parity", loss_cuda=gpu_loss, loss_cpu=cpu_loss,
         params=len(cpu_grads), worst_grad_err_over_tol=worst,
         launches=launches)
    return launches


def phase_lm_train():
    """The LM's train step at full width; returns each flash kernel's
    launches over the train, eval and predict steps."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.trainer import Trainer

    spec = load_spec(LM_PARAMS,
                     model_def="transformer.transformer_lm.custom_model")
    trainer = Trainer(spec)                 # device defaulted: the GPU
    if trainer.device.type != "cuda":
        raise AssertionError(f"Trainer defaulted to {trainer.device}")
    batch = lm_batch(100)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(batch)

    reset_launches()
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
    train = dict(fa.launches)
    reset_launches()
    metric_states = trainer.eval_step(state, batch,
                                      trainer.new_metric_states())
    torch.cuda.synchronize()
    evaluate = dict(fa.launches)
    reset_launches()
    preds = trainer.predict_step(state, batch)
    torch.cuda.synchronize()
    predict = dict(fa.launches)

    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"LM losses not finite and falling: {losses}")
    per_step = LM_LAYERS * STEPS
    none = {name: 0 for name in fa.launches}
    if train != {**none, fa.FWD_SM90: per_step, fa.BWD_DQ_SM90: per_step,
                 fa.BWD_DKV_SM90: per_step, fa.BWD_DELTA_SM90: per_step}:
        raise AssertionError(f"flash launches in {STEPS} train steps of "
                             f"{LM_LAYERS} layers: {train}")
    for what, counts in (("eval", evaluate), ("predict", predict)):
        if counts != {**none, fa.FWD_SM90: LM_LAYERS}:
            raise AssertionError(f"flash launches in {what}: {counts}")
    want_shape = (LM_BATCH, LM_T, LM_VOCAB)
    if tuple(preds.shape) != want_shape or not bool(
            torch.isfinite(preds).all()):
        raise AssertionError(f"predictions {tuple(preds.shape)} not finite")
    emit("lm_train", params=LM_PARAMS, batch=[LM_BATCH, LM_T],
         compute_dtype="bfloat16", steps=STEPS, losses=losses,
         step_ms=step_ms, host_step_ms=host_s * 1e3 / (STEPS - 1),
         tokens_per_s=LM_BATCH * LM_T / (step_ms / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches={"train": train, "eval": evaluate, "predict": predict},
         eval=trainer.metric_results(metric_states),
         predict_shape=list(preds.shape))
    phase_profile(trainer, state, batch, step_ms)
    return {name: train[name] + evaluate[name] + predict[name]
            for name in train}


def job_argv(out, n, shards):
    """The DeepFM job at full width: `n` synthetic Criteo records in
    `shards` shards and tasks of JOB_TASK records, eval at epoch end over
    16384 records, interval checkpoints every 4 steps (2 kept), SAVE_MODEL
    and the export under `out`."""
    return [
        "--model_zoo", ZOO, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", f"field_vocab={FIELD_VOCAB};hidden=400,400",
        "--minibatch_size", str(BATCH),
        "--training_data", f"synthetic://criteo?n={n}&shards={shards}",
        "--records_per_task", str(JOB_TASK),
        "--validation_data", "synthetic://criteo?n=16384&shards=2",
        "--checkpoint_dir", os.path.join(out, "ckpt"),
        "--checkpoint_steps", "4", "--keep_checkpoint_max", "2",
        "--output", os.path.join(out, "export"),
        "--worker_heartbeat_s", "2",
    ]


def export_matches(out, want_fn, batch):
    """`load_model` on the card from the export under `out`; returns the
    largest difference of its float32 outputs on `batch` from `want_fn`'s
    (or the outputs themselves when want_fn is None)."""
    from elasticdl_tpu_torch.training.export import load_model

    model, _ = load_model(os.path.join(out, "export"), ZOO, device="cuda")
    with torch.no_grad():
        got = model({k: torch.from_numpy(v).cuda()
                     for k, v in batch["features"].items()}, training=False)
    if got.dtype != torch.float32 or tuple(got.shape) != (len(batch["labels"]),):
        raise AssertionError(f"export predicts {got.dtype} {tuple(got.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("export predicts non-finite values")
    if want_fn is None:
        return got
    return float((got - want_fn(batch)).abs().max())


def states_equal(a, b):
    """Params, optimizer slots and step of two TrainStates, exactly."""
    if a.step != b.step or list(a.params) != list(b.params):
        return False
    if not all(torch.equal(a.params[k], b.params[k]) for k in a.params):
        return False
    sa, sb = (s.optimizer.state_dict()["state"] for s in (a, b))
    return sa.keys() == sb.keys() and all(
        sa[i].keys() == sb[i].keys()
        and all(torch.equal(sa[i][k].cpu(), sb[i][k].cpu()) for k in sa[i])
        for i in sa)


def phase_job(smi):
    """The job path in one process: the port's Master and its Worker (on
    a thread, device defaulted: the card) run the DeepFM job at full
    width; returns K1's launches in it."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.data import parsing
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.observability import profile
    from elasticdl_tpu_torch.observability.registry import default_registry
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer
    from elasticdl_tpu_torch.worker.worker import Worker

    with tempfile.TemporaryDirectory() as out:
        cfg = JobConfig.from_argv(job_argv(out, 4 * JOB_TASK, 4) + [
            "--master_addr", f"localhost:{free_port()}"])
        master = Master(cfg)
        master.start()
        worker = Worker(cfg)                # device defaulted: the GPU
        if worker.device.type != "cuda":
            raise AssertionError(f"Worker defaulted to {worker.device}")
        reg = default_registry()
        before = reg.snapshot()
        profile.get_profiler().reset()
        rc = []
        thread = threading.Thread(target=lambda: rc.append(worker.run()),
                                  name="job-worker", daemon=True)
        placement.launches = 0
        t0 = time.perf_counter()
        thread.start()
        try:
            finished = master.wait(poll_s=0.2, timeout_s=600)
            counts = master.dispatcher.counts()
            results = master.evaluation.latest_results()
        finally:
            master.shutdown(grace_s=1)
            thread.join(300)
        wall_s = time.perf_counter() - t0
        launches = placement.launches
        after = reg.snapshot()
        phases = profile.get_profiler().snapshot(update_memory=False)

        steps = worker._global_step
        if not finished or rc != [0] or thread.is_alive():
            raise AssertionError(f"job did not finish cleanly: finished "
                                 f"{finished}, worker exit {rc}")
        if counts["finished_training"] != 4 or counts["failed_permanently"]:
            raise AssertionError(f"dispatcher counts {counts}")
        if not all(np.isfinite(results.get(k, np.nan))
                   for k in ("auc", "loss")):
            raise AssertionError(f"eval results {results}")
        if steps != 8 or launches != placement.PASSES * steps:
            raise AssertionError(f"K1 launched {launches} kernels in {steps} "
                                 f"train steps, want {placement.PASSES} a "
                                 "step over 8 steps")
        final = worker._state
        mngr = CheckpointManager(cfg.checkpoint_dir)
        if mngr.all_steps() != [4, 8]:
            raise AssertionError(f"checkpoint steps {mngr.all_steps()}")
        fresh = Trainer(ModelSpec.from_config(cfg)).init_state(None)
        if states_equal(fresh, final):
            raise AssertionError("a fresh state already equals the final one")
        if mngr.restore(fresh) is not fresh or not states_equal(fresh, final):
            raise AssertionError("newest checkpoint does not restore the "
                                 "final state")
        del fresh
        batch = criteo_batch(7)
        export_err = export_matches(
            out, lambda b: worker._trainer.predict_step(final, b), batch)
        if export_err > 1e-6:
            raise AssertionError(f"export predicts {export_err} off the "
                                 "final state")

    def delta(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    step_s = delta("edl_train_step_seconds_sum")
    records = delta("edl_train_records_total")
    lib = parsing._load()
    emit("job", card=smi, params=f"field_vocab={FIELD_VOCAB};hidden=400,400",
         batch=BATCH, tasks=counts["finished_training"], train_steps=steps,
         records=records, counts=counts, eval=results, wall_s=wall_s,
         samples_per_s=records / step_s,
         host_ms_per_step=step_s * 1e3 / steps,
         data_wait_ms_per_step=phases.get("phase_data_wait_ms", 0.0),
         h2d_ms_per_step=phases.get("phase_h2d_ms", 0.0),
         compute_ms_per_step=phases.get("phase_compute_ms", 0.0),
         parser=("native " + os.path.relpath(lib._name, REPO)) if lib
         else "python", k1_launches=launches, checkpoint_steps=[4, 8],
         export_max_abs_err=export_err)
    return launches


def phase_job_cli(smi):
    """The same job at a smaller depth through the CLI: `python -m
    elasticdl_tpu_torch.client.main train` -> run_local -> ProcessManager
    -> one `elasticdl_tpu_torch.worker.main` subprocess on the card."""
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as out:
        argv = job_argv(out, JOB_TASK, 2) + ["--master_addr", "localhost:0"]
        # an explicit environment: no cohort variables, no device request
        env = {k: v for k, v in os.environ.items()
               if k not in COHORT_ENV + ("EDL_TORCH_DEVICE",)}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO, env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.client.main",
             "train", *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=600)
        finally:
            # the launcher and the worker it spawned share the session
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall_s = time.perf_counter() - t0
        problems = []
        if proc.returncode != 0:
            problems.append(f"exit {proc.returncode}")
        steps = CheckpointManager(os.path.join(out, "ckpt")).all_steps()
        if not steps:
            problems.append("no checkpoint step on disk")
        device = re.search(r"registered as worker 0 .* on (\S+)", log)
        if not device or not device.group(1).startswith("cuda"):
            problems.append("the worker's log names no cuda device")
        try:
            export_matches(out, None, criteo_batch(8))
        except Exception as e:     # reported with the log below
            problems.append(f"export does not load: {e!r}")
        if problems:
            print(log[-8000:], file=sys.stderr, flush=True)
            raise AssertionError("job_cli: " + "; ".join(problems))
    emit("job_cli", card=smi, exit=proc.returncode, wall_s=wall_s,
         checkpoint_steps=steps, device=device.group(1),
         finished=re.findall(r"job finished: (.*)", log)[-1:])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import native, placement

    dev = torch.device("cuda")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         nvcc=run([native.nvcc(), "--version"]).splitlines()[-1])

    t0 = time.perf_counter()
    built = native.build([placement.KERNEL, fa.LIBRARY, fa.LIBRARY_SM90])
    seconds = time.perf_counter() - t0
    hgmma = hgmma_counts(built[fa.LIBRARY_SM90]["path"])
    sm90 = ctypes.CDLL(built[fa.LIBRARY_SM90]["path"])
    hopper = ((0, "flash_fwd_sm90_kernel", 64),
              (0, "flash_fwd_sm90_kernel", 128),
              (1, "flash_bwd_dkv_sm90_kernel", 64),
              (2, "flash_bwd_dq_sm90_kernel", 64),
              (2, "flash_bwd_dq_sm90_kernel", 128))
    shared = {f"{name}<D={d}>": sm90.flash_sm90_shared_bytes(which, d)
              for which, name, d in hopper}
    emit("build", seconds=seconds,
         kernels={k: {"path": os.path.relpath(v["path"], REPO),
                      "seconds": v["seconds"],
                      "ptxas": ptxas_summary(v["log"])}
                  for k, v in built.items()},
         hgmma=hgmma, dynamic_shared_bytes=shared)
    for kernel in shared:
        if not hgmma.get(kernel):
            raise AssertionError(f"{kernel} has no HGMMA instruction")

    k1 = phase_kernel(dev)
    report, worst = phase_attn_kernel(dev)
    attn = attn_times(dev, report, worst)
    phase_parity()
    f32_lm_launches = phase_lm_parity()
    launches = phase_train()
    lm_launches = phase_lm_train()
    job_launches = phase_job(smi)
    phase_job_cli(smi)

    f32_lm = (fa.FWD, fa.BWD_DQ, fa.BWD_DKV)
    print(json.dumps({"kernels": [{
        "name": placement.KERNEL,
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/place_sorted_grads.cu",
        "replaces": "elasticdl_tpu/ops/pallas_scatter.py:150",
        # two kernels a call: the zero pass and the placement pass; the
        # job path's count (the slice's main path), and the train step's
        "launches": job_launches,
        "launches_in": "job",
        "train_launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "max_rel_err": k1["max_rel_err"],
        "ms": k1["ms"],
        "device_ms": k1["device_ms"],
        "skewed_30pct_one_id_ms": k1["skewed_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k1["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": ATTN_KERNELS[name][0],
        "replaces": ATTN_KERNELS[name][1],
        # K2-K4 serve the float32 LM (lm_parity); the Hopper kernels the
        # bf16 LM's train, eval and predict steps (lm_train)
        "launches": (f32_lm_launches[name] if name in f32_lm
                     else lm_launches[name]),
        "launches_in": "lm_parity" if name in f32_lm else "lm_train",
        **attn[name],
    } for name in (fa.FWD, fa.FWD_SM90, fa.BWD_DQ, fa.BWD_DQ_SM90,
                   fa.BWD_DKV, fa.BWD_DKV_SM90, fa.BWD_DELTA_SM90)]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
