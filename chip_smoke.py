#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Two main paths: the DeepFM train step (kernel K1) and the transformer LM
train step (flash-attention kernels K2-K4). Phases, each printing one JSON
line; any failure raises and exits non-zero (no phase's error is caught):

1. env     torch/CUDA versions, `nvcc --version`, the card's name and
           power limit (also printed raw, as nvidia-smi gives them).
2. build   compile every kernel of both paths from
           `elasticdl_tpu_torch/csrc` (one nvcc per source, all at once),
           with ptxas's registers and spills for each kernel.
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
7. attn_kernel  K2 (flash forward), K3 (dQ) and K4 (dK, dV) against their
           plain versions on the card: at the LM's full shape (B8 T1024 H8
           D64, causal; out, lse, then the backward) in bf16 and in
           float32, and on small float32 cases (offsets (32,0), (16,0),
           (64,32); not causal with Tq 32, Tk 96; a fully masked
           geometry, q_offset 0 and kv_offset 1024, where out and every
           gradient must be 0 and finite; lse with a random g_lse).
           Tolerances: float32 out and lse 2e-5, gradients 5e-5 with atol
           5e-5 of the largest value (the reference's own for its
           kernel); bf16 rtol 2**-7 (one bf16 ulp: both sides compute in
           float32 from the same inputs and round once) with atol 1e-2
           of the output's rms. Times at the bf16 full shape beside the
           bound and the scaled_dot_product_attention (flash backend)
           yardstick.
8. lm_parity  a small LM (vocab 64, 2 layers, dim 64, 4 heads, float32,
           T 32) on the card and on the CPU from the same weights: loss
           rtol 5e-5, every gradient rtol 5e-5 with atol 5e-5 of its
           largest value (the k biases, 0 in exact arithmetic, within 1e-6
           of the largest gradient entry of 0).
9. lm_train  the LM at the width bench.py benchmarks it (vocab 8192, 4
           layers, dim 512, 8 heads, bf16, 8 x 1024 random tokens): 20
           train steps (one warm-up), eval_step, predict_step. Losses must
           be finite and fall; K2, K3 and K4 must each launch 4 times (one
           per layer) in every train step, and K2 4 times in each of eval
           and predict. Then its profile, as in 6.
Then the `kernels` line, the nvidia-smi line, and last the `ok` line.

It exits non-zero without a result where CUDA is unavailable, and where
the port's package is absent.
"""

import json
import os
import re
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
BF16_FLOPS = 989e12              # H100 SXM dense bf16
# the LM as bench.py's transformer_lm leg runs it (bench.py:4398-4407)
LM_PARAMS = "vocab=8192;num_layers=4;dim=512;heads=8;max_len=1024"
LM_LAYERS, LM_BATCH, LM_T, LM_VOCAB = 4, 8, 1024, 8192
LM_SMALL = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64"


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


ATTN_REPLACES = {
    "flash_fwd": "elasticdl_tpu/ops/pallas_attention.py:256",
    "flash_bwd_dq": "elasticdl_tpu/ops/pallas_attention.py:404",
    "flash_bwd_dkv": "elasticdl_tpu/ops/pallas_attention.py:433",
}


def ptxas_summary(log):
    """{kernel: "N registers, spills ..."} from nvcc's -Xptxas -v log,
    with each entry function's mangled name shortened to its kernel and
    template arguments."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            k = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(\w+?)"
                          r"Li(\d+)E", name)
            if k:
                dtype = "bf16" if "bfloat16" in k.group(2) else "f32"
                name = f"{k.group(1)}<{dtype},G={k.group(3)}>"
            elif "place_sorted_grads_kernel" in name:
                name = "place_sorted_grads_kernel"
        elif name and ("registers" in ln or "spill" in ln):
            text = ln.split("ptxas info    :")[-1].strip()
            out[name] = (out[name] + "; " + text) if name in out else text
    return out


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
    atol = (atol_of_max * float(want.abs().max())
            + atol_of_rms * float(want.square().mean().sqrt()))
    tol = atol + rtol * want.abs()
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max())


def attn_bound(b, t, h, d, itemsize, kernel):
    """(bound ms, "operations" or "bytes") of one causal call at the full
    shape: FLOPs 4, 6 or 8 x B.H.T^2.D / 2 (K2, K3, K4) at the bf16 peak,
    bytes of each input read once and each output written once."""
    act = b * t * h * d * itemsize
    rows = b * h * t * 4
    flops, moved = {
        "flash_fwd": (4, 3 * act + act + rows),       # q k v -> out, lse
        "flash_bwd_dq": (6, 5 * act + rows + act),    # q k v o do lse -> dq
        "flash_bwd_dkv": (8, 5 * act + rows + 2 * act),  # ... -> dk, dv
    }[kernel]
    flops = flops * b * h * t * t * d / 2
    by_ops, by_bytes = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
    return max(by_ops, by_bytes) * 1e3, (
        "operations" if by_ops >= by_bytes else "bytes")


def phase_attn_kernel(dev):
    """K2-K4 against their plain versions; times at the full shape."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    full = (LM_BATCH, LM_T, LM_T, 8, 64, bf16)
    cases = [  # name, (B, Tq, Tk, H, D, dtype), causal, q_off, kv_off, g_lse
        ("full_b8_t1024_h8_d64_bf16_causal", full, True, 0, 0, False),
        ("full_b8_t1024_h8_d64_f32_causal", full[:5] + (f32,), True, 0, 0,
         False),
        ("f32_offsets_32_0", (2, 32, 32, 2, 16, f32), True, 32, 0, False),
        ("f32_offsets_16_0", (2, 32, 32, 2, 16, f32), True, 16, 0, False),
        ("f32_offsets_64_32", (2, 32, 32, 2, 16, f32), True, 64, 32, False),
        ("f32_not_causal_tq32_tk96", (2, 32, 96, 2, 16, f32), False, 0, 0,
         False),
        ("f32_fully_masked_kv_offset_1024", (2, 32, 32, 2, 16, f32), True, 0,
         1024, False),
        ("f32_lse_with_g_lse", (2, 64, 64, 2, 16, f32), True, 0, 0, True),
    ]
    worst = {fa.FWD: [0.0, 0.0], fa.BWD_DQ: [0.0, 0.0], fa.BWD_DKV: [0.0, 0.0]}
    report = {}
    for seed, (name, shape, causal, q_off, kv_off, with_glse) in \
            enumerate(cases):
        b, tq, tk, h, d, dtype = shape
        q, k, v, dout, glse = attn_inputs(dev, b, tq, tk, h, d, dtype, seed)
        glse = glse if with_glse else None
        args = (causal, q_off, kv_off)
        out, lse = fa.flash_fwd(q, k, v, *args)
        dq = fa.flash_bwd_dq(q, k, v, out, dout, lse, glse, *args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, out, dout, lse, glse, *args)
        torch.cuda.synchronize()
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, *args)
        want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse, glse, *args)
        want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse,
                                                  glse, *args)
        is_f32 = dtype == f32
        bf16_tol = (2 ** -7, 0.0, 1e-2)     # rtol, atol of max, of rms
        out_tol = (2e-5, 2e-5) if is_f32 else bf16_tol
        grad_tol = (5e-5, 5e-5) if is_f32 else bf16_tol
        checks = {
            fa.FWD: [over_tol(out, want_out, *out_tol),
                     over_tol(lse, want_lse, 2e-5, 2e-5)],
            fa.BWD_DQ: [over_tol(dq, want_dq, *grad_tol)],
            fa.BWD_DKV: [over_tol(dk, want_dk, *grad_tol),
                         over_tol(dv, want_dv, *grad_tol)],
        }
        entry = {"shape": [b, tq, tk, h, d], "dtype": str(dtype)[6:],
                 "causal": causal, "q_offset": q_off, "kv_offset": kv_off,
                 "g_lse": with_glse}
        ok = True
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
            raise AssertionError(f"K2-K4 disagree with the plain versions on "
                                 f"{name}")

    # times at the full shape
    b, t, _, h, d, dtype = full
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, dtype, 0)
    out, lse = fa.flash_fwd(q, k, v)
    calls = {
        fa.FWD: (lambda: fa.flash_fwd(q, k, v),
                 lambda: fa.flash_fwd_plain(q, k, v)),
        fa.BWD_DQ: (lambda: fa.flash_bwd_dq(q, k, v, out, dout, lse),
                    lambda: fa.flash_bwd_dq_plain(q, k, v, out, dout, lse)),
        fa.BWD_DKV: (lambda: fa.flash_bwd_dkv(q, k, v, out, dout, lse),
                     lambda: fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse)),
    }
    lib_fwd, lib_bwd = sdpa_ms(q, k, v, dout)
    result = {}
    for kernel, (run_kernel, run_plain) in calls.items():
        bound_ms, bound_by = attn_bound(b, t, h, d, q.element_size(), kernel)
        result[kernel] = {
            "max_abs_err": worst[kernel][0],
            "err_over_tol": worst[kernel][1],
            "ms": time_ms(run_kernel),
            "plain_ms": time_ms(run_plain, groups=5, per_group=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd if kernel == fa.FWD else lib_bwd,
            "library": ("scaled_dot_product_attention forward, flash backend"
                        if kernel == fa.FWD else
                        "scaled_dot_product_attention backward (dq, dk and "
                        "dv in one call), flash backend"),
        }
    emit("attn_kernel", cases=report, timed_shape=[b, t, h, d],
         timed_dtype="bfloat16", kernels=result)
    return result


def sdpa_ms(q, k, v, dout):
    """Forward and backward ms of scaled_dot_product_attention (flash
    backend, causal) on the same inputs, in its (B, H, T, D) layout: the
    library yardstick. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        o = sdpa(qg, kg, vg, is_causal=True)
        bwd = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                                  retain_graph=True))
    return fwd, bwd


def lm_batch(seed, b=LM_BATCH, t=LM_T, vocab=LM_VOCAB):
    """Random tokens as bench.py's transformer_lm leg makes them (labels
    are the tokens themselves), all rows real."""
    r = np.random.RandomState(seed)
    toks = r.randint(0, vocab, (b, t)).astype(np.int32)
    return {"features": toks, "labels": toks,
            "mask": np.ones((b,), np.float32)}


def phase_lm_parity():
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
        loss, grads = tr.compute_grads(state, batch)
        results.append((float(loss), {n: g.cpu() for n, g in grads.items()}))
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
         params=len(cpu_grads), worst_grad_err_over_tol=worst)


def phase_lm_train():
    """The LM's train step at full width; returns each flash kernel's
    launches over the train, eval and predict steps."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.trainer import Trainer

    def reset():
        for name in fa.launches:
            fa.launches[name] = 0

    spec = load_spec(LM_PARAMS,
                     model_def="transformer.transformer_lm.custom_model")
    trainer = Trainer(spec)                 # device defaulted: the GPU
    if trainer.device.type != "cuda":
        raise AssertionError(f"Trainer defaulted to {trainer.device}")
    batch = lm_batch(100)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(batch)

    reset()
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
    reset()
    metric_states = trainer.eval_step(state, batch,
                                      trainer.new_metric_states())
    torch.cuda.synchronize()
    evaluate = dict(fa.launches)
    reset()
    preds = trainer.predict_step(state, batch)
    torch.cuda.synchronize()
    predict = dict(fa.launches)

    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"LM losses not finite and falling: {losses}")
    per_step = LM_LAYERS * STEPS
    if train != {fa.FWD: per_step, fa.BWD_DQ: per_step,
                 fa.BWD_DKV: per_step}:
        raise AssertionError(f"flash launches in {STEPS} train steps of "
                             f"{LM_LAYERS} layers: {train}")
    for what, counts in (("eval", evaluate), ("predict", predict)):
        if counts != {fa.FWD: LM_LAYERS, fa.BWD_DQ: 0, fa.BWD_DKV: 0}:
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
    built = native.build([placement.KERNEL, fa.LIBRARY])
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"path": os.path.relpath(v["path"], REPO),
                      "seconds": v["seconds"],
                      "ptxas": ptxas_summary(v["log"])}
                  for k, v in built.items()})

    k1 = phase_kernel(dev)
    attn = phase_attn_kernel(dev)
    phase_parity()
    phase_lm_parity()
    launches = phase_train()
    lm_launches = phase_lm_train()

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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/flash_attention.cu",
        "replaces": ATTN_REPLACES[name],
        "launches": lm_launches[name],
        **attn[name],
    } for name in (fa.FWD, fa.BWD_DQ, fa.BWD_DKV)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
