#!/usr/bin/env python3
"""Block layouts of the Hopper flash kernels K2', K3', K4', K2-tf32,
K3-tf32 and K4-tf32 on one card.

    python3 sm90_layouts.py        # from the repository root, one CUDA card

Builds `elasticdl_tpu_torch/csrc/flash_attention_sm90.cu` as it is and
variants of it made by text substitution (`VARIANTS`: the layouts the
source does not keep), one nvcc each, all started together. Each build
is loaded in turn, the source's own first and last, and K2', K3' and K4'
run at B8 T1024 H8 causal bf16 at D 16, 32 and 64 on the same inputs,
and K2-tf32, K3-tf32 and K4-tf32 there in float32: each launch held to
its plain version (`chip_smoke.KERNEL_TOL`; K2-tf32's out and lse to
2e-5, K3-tf32's and K4-tf32's gradients to 5e-5), its device time from
torch.profiler (`chip_smoke.device_ms`). Prints one JSON line a build:
ptxas's registers and spills of each Hopper kernel at D 16 and 32 and of
the TF32 kernels at D 16, 32 and 64, and the times; then the card's name
and power limit. A layout that spills is not one to keep.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FWD_BLOCKS = "static constexpr int kMinBlocks = kD < 64 ? 2 : 1;"
DKV_SHAPE = ("using DkvShape =\n    BlockShape<(kD == 32 || kD == 64 ? 2 : 1), "
             "(kD == 16 ? 3 : 1)>;")
DQ_SHAPE = "using DqShape = BlockShape<(kD < 64 ? 1 : 2), (kD < 64 ? 3 : 1)>;"
DKV_TF32_SHAPE = "using DkvTf32Shape = Tf32Shape<1, (kD == 16 ? 2 : 1)>;"
DQ_TF32_SHAPE = "using DqTf32Shape = Tf32Shape<2, 1>;"


def shape(old, consumers, blocks):
    name, kind = old.split()[1], old.split()[3].split("<")[0]
    return [(old, f"using {name} = {kind}<({consumers}), ({blocks})>;")]


def dkv(consumers, blocks):
    return shape(DKV_SHAPE, consumers, blocks)


def dq(consumers, blocks):
    return shape(DQ_SHAPE, consumers, blocks)


# name: [(text of the source, its replacement)]
VARIANTS = {
    # K2' at D 16 and 32 with one block a SM (168 registers)
    "k2_one_block": [(FWD_BLOCKS, "static constexpr int kMinBlocks = 1;")],
    # K4' at D 16 and 32 in D 64's shape: two warpgroups, one block
    "k4_two_warpgroups": dkv("kD == 128 ? 1 : 2", "1"),
    # K4' at D 16 and 32: two warpgroups, two blocks (96 registers)
    "k4_two_warpgroups_two_blocks": dkv("kD == 128 ? 1 : 2",
                                        "kD < 64 ? 2 : 1"),
    # K4' at D 16 and 32: one warpgroup, three blocks (128 registers)
    "k4_one_warpgroup_three_blocks": dkv("kD == 64 ? 2 : 1",
                                         "kD < 64 ? 3 : 1"),
    # K3' at D 16 and 32 in D 64's shape: two warpgroups, one block
    "k3_two_warpgroups": dq("2", "1"),
    # K3' at D 16 and 32: two warpgroups, two blocks (96 registers)
    "k3_two_warpgroups_two_blocks": dq("2", "kD < 64 ? 2 : 1"),
    # K3' at D 16 and 32: one warpgroup, four blocks (96 registers)
    "k3_one_warpgroup_four_blocks": dq("kD < 64 ? 1 : 2",
                                       "kD < 64 ? 4 : 1"),
    # K2-tf32 with all eight k8 steps of P.V in one commit group at D 64
    # too (p's hi and lo fragments, 64 registers, live at once)
    "k2_tf32_one_pv_group": [
        ("static constexpr int kPvSteps = kD == 64 ? 4 : 8;",
         "static constexpr int kPvSteps = 8;")],
    # K3-tf32 with one consumer warpgroup (256 threads), two blocks a SM at
    # D 16 and 32
    "k3_tf32_one_warpgroup": shape(DQ_TF32_SHAPE, 1, "kD < 64 ? 2 : 1"),
    # K4-tf32 in two blocks a SM at D 32 too (128 registers)
    "k4_tf32_two_blocks": shape(DKV_TF32_SHAPE, 1, "kD < 64 ? 2 : 1"),
    # K4-tf32 with two consumer warpgroups at D 16 and 32 (D 64's K and V
    # would not fit)
    "k4_tf32_two_warpgroups": shape(DKV_TF32_SHAPE, "kD == 64 ? 1 : 2", "1"),
    # a ring of four stages for K2', K3' and K4' (K2-tf32 keeps its own
    # two: four do not fit its shared memory at D 64)
    "four_stages": [("constexpr int kStages = 2;",
                     "constexpr int kStages = 4;")],
}


def build_all(names):
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import native

    src_path = native.CSRC / f"{fa.LIBRARY_SM90}.cu"
    source = src_path.read_text()
    out_dir = native.BUILD_DIR / "layouts"
    out_dir.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in the source "
                                     "once")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        started[name] = (lib, subprocess.Popen(
            [native.nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    own = native.build([fa.LIBRARY_SM90])[fa.LIBRARY_SM90]
    built = {"source": (own["path"], own["log"])}
    for name, (lib, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        built[name] = (str(lib), log)
    return built


def measure(name, path, log):
    import chip_smoke as cs
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import native

    lib = ctypes.CDLL(path)
    lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.edl_cuda_error_string.restype = ctypes.c_char_p
    native._loaded[fa.LIBRARY_SM90] = lib
    ptxas = {k: v for k, v in cs.ptxas_summary(log).items()
             if "tf32" in k or (
                 ("fwd_sm90" in k or "dkv_sm90" in k or "dq_sm90" in k)
                 and ("D=16" in k or "D=32" in k))}
    times = {}
    b, t, h = cs.LM_BATCH, cs.LM_T, 8
    for d in (16, 32, 64):
        q, k, v, dout, _ = cs.attn_inputs("cuda", b, t, t, h, d,
                                          torch.bfloat16, 0)
        fwd = lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD_SM90)
        out, lse = fwd()
        delta = fa.flash_bwd_delta(out, dout)
        bwd = lambda: fa.launch_dkv_sm90(q, k, v, dout, lse, delta, True, 0,
                                         0)
        dq = lambda: fa.launch_dq_sm90(q, k, v, dout, lse, delta, True, 0, 0)
        want_out, _ = fa.flash_fwd_plain(q, k, v)
        want = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse)
        want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse)
        ratio = max(cs.over_tol(got, w, *cs.KERNEL_TOL)[1]
                    for got, w in zip((out, *bwd(), dq()),
                                      (want_out, *want, want_dq)))
        if ratio > 1.0:
            raise AssertionError(f"{name} at D {d}: {ratio} of the "
                                 "tolerance")
        times[f"d{d}"] = {
            "k2_prime_device_ms":
                cs.device_ms(fwd, ("flash_fwd_sm90_kernel",))[
                    "flash_fwd_sm90_kernel"],
            "k4_prime_device_ms":
                cs.device_ms(bwd, ("flash_bwd_dkv_sm90_kernel",))[
                    "flash_bwd_dkv_sm90_kernel"],
            "k3_prime_device_ms":
                cs.device_ms(dq, ("flash_bwd_dq_sm90_kernel",))[
                    "flash_bwd_dq_sm90_kernel"],
            "err_over_tol": ratio}
        q, k, v, _, _ = cs.attn_inputs("cuda", b, t, t, h, d, torch.float32,
                                       0)
        tf32 = lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD_TF32)
        ratio = max(cs.over_tol(got, w, 2e-5, 2e-5)[1]
                    for got, w in zip(tf32(), fa.flash_fwd_plain(q, k, v)))
        if ratio > 1.0:
            raise AssertionError(f"{name}: K2-tf32 at D {d}: {ratio} of "
                                 "the tolerance")
        symbol = "flash_fwd_tf32_sm90_kernel"
        times[f"d{d}"].update({
            "k2_tf32_device_ms": cs.device_ms(tf32, (symbol,))[symbol],
            "k2_tf32_err_over_tol": ratio})
        dout = torch.randn_like(q)
        out, lse = tf32()
        delta = fa.flash_bwd_delta(out, dout)
        dkv = lambda: fa.launch_dkv_sm90(q, k, v, dout, lse, delta, True, 0,
                                         0, fa.BWD_DKV_TF32)
        dq = lambda: fa.launch_dq_sm90(q, k, v, dout, lse, delta, True, 0, 0,
                                       fa.BWD_DQ_TF32)
        want = (*fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse),
                fa.flash_bwd_dq_plain(q, k, v, out, dout, lse))
        ratio = max(cs.over_tol(got, w, 5e-5, 5e-5)[1]
                    for got, w in zip((*dkv(), dq()), want))
        if ratio > 1.0:
            raise AssertionError(f"{name}: K3-tf32 or K4-tf32 at D {d}: "
                                 f"{ratio} of the tolerance")
        times[f"d{d}"]["tf32_backward_err_over_tol"] = ratio
        for key, fn, symbol in (
                ("k4_tf32_device_ms", dkv, "flash_bwd_dkv_tf32_sm90_kernel"),
                ("k3_tf32_device_ms", dq, "flash_bwd_dq_tf32_sm90_kernel")):
            times[f"d{d}"][key] = cs.device_ms(fn, (symbol,))[symbol]
    print(json.dumps({"layout": name, "ptxas": ptxas, "times": times}),
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("sm90_layouts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    built = build_all(list(VARIANTS))
    order = ["source", *VARIANTS, "source"]
    for name in order:
        measure(name, *built[name])
    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
