#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Two main paths: the DeepFM train step (kernel K1) and the transformer LM
train step (flash-attention kernels: for its bfloat16 D 64 attention the
Hopper kernels K2', K4' and the delta pass, with K3; K2 and K4 for every
other input, such as the float32 LM). Phases, each printing one JSON line;
any failure raises and exits non-zero (no phase's error is caught):

1. env     torch/CUDA versions, `nvcc --version`, the card's name and
           power limit (also printed raw, as nvidia-smi gives them).
2. build   compile every kernel of both paths from
           `elasticdl_tpu_torch/csrc` (one nvcc per source, all at once),
           with ptxas's registers and spills for each kernel, the dynamic
           shared memory each Hopper kernel's launch asks for, and the
           HGMMA (wgmma) instructions in each kernel's SASS (`cuobjdump
           --dump-sass`): K2' and K4' must have some.
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
7. attn_kernel  the flash kernels against their plain versions on the
           card, each case through the routing wrappers, which must take
           the Hopper kernels for bf16 at D 64 and 128 (K4' at D 64 only)
           and K2-K4 elsewhere: at the LM's full shape (B8 T1024 H8,
           causal; out, lse, then the backward) in bf16 at D 64 and 128
           and in float32 at D 64; on small float32 cases at D 16 and
           their bf16 twins at D 64 (offsets (32,0), (16,0), (64,32); not
           causal with Tq 32, Tk 96 (bf16: Tq 100, Tk 230, tails); a fully
           masked geometry, q_offset 0 and kv_offset 1024, where out and
           every gradient must be 0 and finite; lse with a random g_lse).
           Every bf16 case on the Hopper route also holds the delta pass
           to (dout . out).sum(-1) - g_lse. Tolerances: float32 out, lse
           and delta 2e-5, gradients 5e-5 with atol 5e-5 of the largest
           value (the reference's own for its kernel); bf16 rtol 2**-7
           (one bf16 ulp: both sides compute in float32 from the same
           inputs and round once) with atol 1e-2 of the output's rms.
           Times at the bf16 full shape (D 64) beside the bound and the
           scaled_dot_product_attention (flash backend) yardstick, with
           K2 and K4 timed on the same bf16 inputs through their launchers.
8. lm_parity  a small LM (vocab 64, 2 layers, dim 64, 4 heads, float32,
           T 32) on the card and on the CPU from the same weights: loss
           rtol 5e-5, every gradient rtol 5e-5 with atol 5e-5 of its
           largest value (the k biases, 0 in exact arithmetic, within 1e-6
           of the largest gradient entry of 0). This float32 LM is the
           main path that launches K2 and K4 (D 16).
9. lm_train  the LM at the width bench.py benchmarks it (vocab 8192, 4
           layers, dim 512, 8 heads, bf16, 8 x 1024 random tokens): 20
           train steps (one warm-up), eval_step, predict_step. Losses must
           be finite and fall; K2', K3, K4' and the delta pass must each
           launch 4 times (one per layer) in every train step and K2 and
           K4 never, and K2' 4 times in each of eval and predict. Then its
           profile, as in 6.
Then the `kernels` line, the nvidia-smi line, and last the `ok` line.

It exits non-zero without a result where CUDA is unavailable, and where
the port's package is absent.
"""

import ctypes
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


PALLAS = "elasticdl_tpu/ops/pallas_attention.py"
CSRC = "elasticdl_tpu_torch/csrc"
# name: (source, the TPU kernel's pallas_call it replaces)
ATTN_KERNELS = {
    "flash_fwd": (f"{CSRC}/flash_attention.cu", f"{PALLAS}:256"),
    "flash_fwd_sm90": (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:256"),
    "flash_bwd_dq": (f"{CSRC}/flash_attention.cu", f"{PALLAS}:404"),
    "flash_bwd_dkv": (f"{CSRC}/flash_attention.cu", f"{PALLAS}:433"),
    "flash_bwd_dkv_sm90": (f"{CSRC}/flash_attention_sm90.cu",
                           f"{PALLAS}:433"),
    "flash_bwd_delta_sm90": (f"{CSRC}/flash_attention_sm90.cu",
                             f"{PALLAS}:433"),
}


def short_name(mangled):
    """A kernel's entry name with its template arguments, from the mangled
    symbol."""
    k = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(\w+?)Li(\d+)E",
                  mangled)
    if k:
        dtype = "bf16" if "bfloat16" in k.group(2) else "f32"
        return f"{k.group(1)}<{dtype},G={k.group(3)}>"
    k = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_delta)_sm90_kernel)ILi(\d+)E",
                  mangled)
    if k:
        return f"{k.group(1)}<D={k.group(2)}>"
    if "place_sorted_grads_kernel" in mangled:
        return "place_sorted_grads_kernel"
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
    shape: FLOPs 4, 6 or 8 x B.H.T^2.D / 2 (forward, dQ, dK/dV) at the
    bf16 peak, bytes of each input read once and each output written once.
    K4' reads delta where K4 reads O; the delta pass does 2 B.T.H.D FLOPs
    on float32 (the CUDA cores' peak)."""
    act = b * t * h * d * itemsize
    rows = b * h * t * 4
    flops, moved, peak = {
        "flash_fwd": (4, 3 * act + act + rows, BF16_FLOPS),  # q k v -> out lse
        "flash_bwd_dq": (6, 5 * act + rows + act, BF16_FLOPS),  # +o do lse
        "flash_bwd_dkv": (8, 5 * act + rows + 2 * act, BF16_FLOPS),
        "flash_bwd_dkv_sm90": (8, 4 * act + 2 * rows + 2 * act, BF16_FLOPS),
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
        dq = fa.flash_bwd_dq(q, k, v, out, dout, lse, glse, *args)
        before = dict(fa.launches)
        dk, dv = fa.flash_bwd_dkv(q, k, v, out, dout, lse, glse, *args)
        dkv = ran(before, fa.launches)
        torch.cuda.synchronize()
        hopper_fwd = fa._sm90(dtype, d)
        hopper_dkv = fa._sm90(dtype, d, fa.BWD_DKV_SM90)
        want_route = ([fa.FWD_SM90] if hopper_fwd else [fa.FWD],
                      sorted([fa.BWD_DELTA_SM90, fa.BWD_DKV_SM90])
                      if hopper_dkv else [fa.BWD_DKV])
        if (fwd, dkv) != want_route:
            raise AssertionError(f"{name}: launched {fwd} and {dkv}, the "
                                 f"route wants {want_route}")
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
            fa.BWD_DQ: [over_tol(dq, want_dq, *grad_tol)],
            (fa.BWD_DKV_SM90 if hopper_dkv else fa.BWD_DKV):
                [over_tol(dk, want_dk, *grad_tol),
                 over_tol(dv, want_dv, *grad_tol)],
        }
        if hopper_dkv:
            delta = fa.flash_bwd_delta(out, dout, glse)
            checks[fa.BWD_DELTA_SM90] = [over_tol(
                delta, fa.flash_bwd_delta_plain(out, dout, glse), 2e-5, 2e-5)]
        entry = {"shape": [b, tq, tk, h, d], "dtype": str(dtype)[6:],
                 "causal": causal, "q_offset": q_off, "kv_offset": kv_off,
                 "g_lse": with_glse, "route": fwd + dkv}
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
            raise AssertionError(f"the flash kernels disagree with the plain "
                                 f"versions on {name}")
    return report, worst


def attn_times(dev, report, worst):
    """Every flash kernel at the bf16 full shape (D 64): K2' and K2, K4'
    (alone, and with the delta pass) and K4 on the same inputs, through
    their launchers; K2 and K4 are held to the plain versions there too."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h, d = LM_BATCH, LM_T, 8, 64
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, torch.bfloat16, 0)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_bwd_delta(out, dout)
    want_out, _ = fa.flash_fwd_plain(q, k, v)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse)
    bf16_tol = (2 ** -7, 0.0, 1e-2)
    old_out, _ = fa.launch_fwd(q, k, v, True, 0, 0, False)
    old_dk, old_dv = fa.launch_bwd_dkv(q, k, v, out, dout, lse, None, True,
                                       0, 0, False)
    for kernel, results in (
            (fa.FWD, [over_tol(old_out, want_out, *bf16_tol)]),
            (fa.BWD_DKV, [over_tol(old_dk, want_dk, *bf16_tol),
                          over_tol(old_dv, want_dv, *bf16_tol)])):
        err, ratio = max(r[0] for r in results), max(r[1] for r in results)
        if ratio > 1.0:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at the bf16 full shape ({ratio})")
        worst[kernel] = [max(worst[kernel][0], err),
                         max(worst[kernel][1], ratio)]
    plain_fwd = lambda: fa.flash_fwd_plain(q, k, v)
    plain_dkv = lambda: fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse)
    calls = {   # kernel: (its launch, its plain version)
        fa.FWD_SM90: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, True),
                      plain_fwd),
        fa.FWD: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, False),
                 plain_fwd),
        fa.BWD_DQ: (lambda: fa.flash_bwd_dq(q, k, v, out, dout, lse),
                    lambda: fa.flash_bwd_dq_plain(q, k, v, out, dout, lse)),
        fa.BWD_DKV_SM90: (lambda: fa.launch_dkv_sm90(q, k, v, dout, lse,
                                                     delta, True, 0, 0),
                          plain_dkv),
        fa.BWD_DELTA_SM90: (lambda: fa.flash_bwd_delta(out, dout),
                            lambda: fa.flash_bwd_delta_plain(out, dout)),
        fa.BWD_DKV: (lambda: fa.launch_bwd_dkv(q, k, v, out, dout, lse, None,
                                               True, 0, 0, False),
                     plain_dkv),
    }
    lib_fwd, lib_bwd = sdpa_ms(q, k, v, dout)
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
                           else lib_fwd if fwd else lib_bwd),
            "library": (None if kernel == fa.BWD_DELTA_SM90 else
                        "scaled_dot_product_attention forward, flash backend"
                        if fwd else
                        "scaled_dot_product_attention backward (dq, dk and "
                        "dv in one call), flash backend"),
        }
    result[fa.BWD_DKV_SM90]["ms_with_delta_pass"] = time_ms(
        lambda: fa.launch_bwd_dkv(q, k, v, out, dout, lse, None, True, 0, 0,
                                  True))
    faster = {
        "k2_prime_under_k2": result[fa.FWD_SM90]["ms"] < result[fa.FWD]["ms"],
        "k4_prime_with_delta_under_k4":
            result[fa.BWD_DKV_SM90]["ms_with_delta_pass"]
            < result[fa.BWD_DKV]["ms"],
    }
    emit("attn_kernel", cases=report, timed_shape=[b, t, h, d],
         timed_dtype="bfloat16", kernels=result, faster=faster)
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
    if train != {**none, fa.FWD_SM90: per_step, fa.BWD_DQ: per_step,
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
    shared = {f"{name}<D={d}>": sm90.flash_sm90_shared_bytes(which, d)
              for which, name, d in ((0, "flash_fwd_sm90_kernel", 64),
                                     (0, "flash_fwd_sm90_kernel", 128),
                                     (1, "flash_bwd_dkv_sm90_kernel", 64))}
    emit("build", seconds=seconds,
         kernels={k: {"path": os.path.relpath(v["path"], REPO),
                      "seconds": v["seconds"],
                      "ptxas": ptxas_summary(v["log"])}
                  for k, v in built.items()},
         hgmma=hgmma, dynamic_shared_bytes=shared)
    for kernel in ("flash_fwd_sm90_kernel<D=64>",
                   "flash_fwd_sm90_kernel<D=128>",
                   "flash_bwd_dkv_sm90_kernel<D=64>"):
        if not hgmma.get(kernel):
            raise AssertionError(f"{kernel} has no HGMMA instruction")

    k1 = phase_kernel(dev)
    report, worst = phase_attn_kernel(dev)
    attn = attn_times(dev, report, worst)
    phase_parity()
    f32_lm_launches = phase_lm_parity()
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
        "source": ATTN_KERNELS[name][0],
        "replaces": ATTN_KERNELS[name][1],
        # K2 and K4 serve the float32 LM (lm_parity); the others the bf16
        # LM's train, eval and predict steps (lm_train)
        "launches": (f32_lm_launches[name] if name in (fa.FWD, fa.BWD_DKV)
                     else lm_launches[name]),
        "launches_in": ("lm_parity" if name in (fa.FWD, fa.BWD_DKV)
                        else "lm_train"),
        **attn[name],
    } for name in (fa.FWD, fa.FWD_SM90, fa.BWD_DQ, fa.BWD_DKV,
                   fa.BWD_DKV_SM90, fa.BWD_DELTA_SM90)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
