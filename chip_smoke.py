#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

The main paths: the DeepFM job (master, worker, data, checkpoint, eval,
export) and its train step (kernel K1: its zero pass and its placement
pass), the embedding tier's device-mode pushes, session and resharding
(K1 on every push), the other five zoo models (xDeepFM and Wide & Deep through K1;
the MNIST CNN, ResNet-20 and ResNet-50 through library convolutions
and BatchNorm) as steps and, for ResNet-20 and Wide & Deep, as jobs, the transformer LM's train step and its job, its Switch-MoE
configuration as a step and a job and its pipelined one as a step, its
sequence-parallel ring and Ulysses schedules and its steps on a `seq`
mesh, those schedules over tensor-parallel head groups and the MoE's
routing over (data, seq) blocks (flash-attention
kernels: for its bfloat16 attention at D 64, and at D 128, 16 and 32 in
the LMs with 128-, 16- and 32-wide heads, the Hopper kernels K2', K3',
K4' and the delta pass, which runs once a backward; for the float32
LMs at D 16, 32, 64 and 128 their 3xTF32 twins on the tensor cores,
K2-tf32, K3-tf32 and K4-tf32, and the float32 delta pass; K2, K3 and K4
for every other input), the trainer's knobs (remat,
gradient accumulation, grouped steps) over both, and the elastic control
loop over the DeepFM job (the autoscaler's decisions and its drain-first
eviction, zoo callbacks, the hybrid multi-slice mesh), and the DeepFM job
through the Kubernetes path (the master's pod manager and a relaunched
worker pod) beside a `zoo init` template's train step, and the port's
tooling (edl-lint, the fleet soak, the `.rio` converter, the trace and
incident CLIs) with the DeepFM job over converted shards, and the
serving export of DeepFM and the LM (`torch.export`; the LM's program
launches K2'). Phases, each printing
one JSON line; any failure raises and exits non-zero (no phase's error is
caught):

1. env     torch/CUDA versions, `nvcc --version`, the card's name and
           power limit (also printed raw, as nvidia-smi gives them).
2. build   compile every kernel of both paths from
           `elasticdl_tpu_torch/csrc` (one nvcc per source, all at once),
           with ptxas's registers and spills for each kernel, the dynamic
           shared memory each Hopper kernel's launch asks for, and the
           HGMMA (wgmma) instructions in each kernel's SASS (`cuobjdump
           --dump-sass`): K2', K3' and K4' and K2-tf32, K3-tf32 and
           K4-tf32 at D 16, 32, 64 and 128 must have some; K4' at D
           128, K2', K3' and K4' at D 16 and 32 and every K2-tf32,
           K3-tf32 and K4-tf32 must
           spill nothing; the delta pass must be built at D 16, 32, 64
           and 128 in bf16 and in float32.
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
           largest value. This checks K1 inside autograd. Then the card's
           optimizer update (`update`): that DeepFM (capturable Adam),
           the small float32 LM of 8 (capturable AdamW) and ResNet-20
           (fused SGD, momentum 0.9, nesterov), each two captured train
           steps on the card against two on the CPU in the plain flavour
           from the same weights and batch, the second after a
           `set_learning_rate` on both: losses within the gradient
           checks' loss bound (1e-5, the LM's 5e-5), parameters and the
           optimizer's slots rtol 1e-4 with atol 1e-5, the LM's k biases
           (gradient 0 in exact arithmetic) within the two steps' rates
           of 0 on both.
5. train   the main path at DeepFM's full width (2,605,056 x 17 table,
           hidden 400,400, bf16 tower, batch 8192): JobConfig -> ModelSpec
           -> Trainer (device defaulted, so the GPU) -> init_state ->
           train_step x STEPS on one repeated batch -> eval_step ->
           predict_step. Losses must be finite and fall, and K1's two
           kernels must have launched once each per train step. Then
           its `step_cost` line (see below).
6. profile torch.profiler over three more full-width steps: the device's
           busy share, kernels launched per step, the top kernels.
7. attn_kernel  the flash kernels against their plain versions on the
           card, each case through the routing wrappers (the forward, then
           the whole backward `flash_bwd`), which must take the Hopper
           kernels K2', K3' and K4' for bf16 at D 16, 32, 64 and 128 and
           K2-tf32, K3-tf32 and K4-tf32 for float32 at the same D (one
           delta pass a backward, no K2-K4), and K2-K4 elsewhere: at the
           LM's full shape (B8 T1024 H8, causal) in bf16 at D 16, 32, 64
           and 128 and in float32 at D 64; on small
           float32 cases at D 16 and
           their bf16 twins at D 64 (offsets (32,0), (16,0), (64,32); not
           causal with Tq 32, Tk 96 (bf16: Tq 100, Tk 230, tails); a fully
           masked geometry, q_offset 0 and kv_offset 1024, where out and
           every gradient must be 0 and finite; lse with a random g_lse),
           and bf16 twins at D 128, 16 and 32 of the offsets (64,32), the
           tails, the fully masked geometry and g_lse. A second backward
           must give
           the same bits. Every case on a route with the delta pass also
           holds it to (dout . out).sum(-1) - g_lse. Tolerances:
           float32 out, lse and delta 2e-5, gradients 5e-5 with atol 5e-5
           of the largest value (the reference's own for its kernel); bf16
           rtol 2**-7 (one bf16 ulp: both sides compute in float32 from
           the same inputs and round once) with atol 1e-2 of the output's
           rms. Times at the bf16 full shape (D 64) beside the bound and
           the scaled_dot_product_attention yardstick, with K2, K3 and K4
           timed on the same bf16 inputs through their launchers, the
           Hopper kernels' device times from torch.profiler, and the whole
           backward against SDPA's backward in turns over 7 rounds. At
           bf16 D 128 the same for K4' (alone and with the delta pass, its
           device time, a bit-identical rerun) beside K4 through its
           launcher and the whole backward against SDPA's, and for K2'
           and K3' (held to their plain versions and reruns; ms, device
           ms, plain ms, bound) beside SDPA's flash forward and whole
           backward. At bf16 D 16
           (the zoo LM's default head dim) and 32 the same for K2', K3'
           and K4' (each held to its plain version and rerun
           bit-identical; ms, device ms, plain ms, bound; K3' and K4' also
           with the delta pass) beside K2, K3 and K4 through their
           launchers (K3 held to the plain version there too), SDPA's
           device time and the whole backward (the delta pass, K3', K4')
           against SDPA's. K2, K3 and K4 also through their launchers on
           float32 at D 16, 32, 64 and 128 and bf16 at D 16
           and 32, each against its plain version's time and SDPA's
           forward or backward on the same inputs. SDPA's backend is
           pinned and named: flash for bf16, memory-efficient for
           float32 (flash takes no float32). Float32 at D 16, 32, 64 and
           128 takes K2-tf32, K3-tf32, K4-tf32 and the float32 delta
           pass: its cases (the small float32 ones at D 16; a full
           float32 case at D 16 and 64; D 32 with a tail, offsets and
           g_lse, D 64 with offsets and fully masked; at D 128 the bf16
           D 128 cases' float32 twins and lm_parity's shape) hold out,
           lse and delta to 2e-5 and gradients to 5e-5, reruns
           bit-identical (forward and backward, every case), fully masked
           rows 0 (gradients too) with lse <= -1e29. At float32 B8 T1024
           H8 D 16, 32, 64 and 128 K2-tf32 is held to its plain version
           and to a rerun, beside K2 through its launcher (held too) and
           SDPA's memory-efficient forward, and K3-tf32 and K4-tf32 the
           same (alone and with the delta pass) beside K3 and K4 through
           their launchers (held too, with their device times) and SDPA's
           memory-efficient backward; the float32 delta pass held to its
           plain version; at D 64 and 128 the whole backward against
           SDPA's in turns: ms, device ms, plain ms and the bound
           (float32 products counted as three TF32 products at the TF32
           peak, `attn_bound`). K2, K3 and K4 serve no LM's route any
           more; their float32 D 128 times are the yardstick beside
           K2-tf32, K3-tf32 and K4-tf32. Each timing line carries the
           card's name and power limit.
8. lm_parity  a small LM (vocab 64, 2 layers, dim 64, float32, T 32) at
           D 16 (4 heads), 32 (2 heads) and, dim 256, 128 (2 heads), on
           the card and on the CPU from the same weights: loss rtol 5e-5,
           every gradient rtol 5e-5 with atol 5e-5 of its largest value
           (the k biases, 0 in exact arithmetic, within 1e-6 of the
           largest gradient entry of 0). These float32 LMs are the main
           path that launches K2-tf32, K3-tf32, K4-tf32 and the delta pass
           (D 16, 32), each twice a step; at D 128 they launch the same
           four, as `lm_train_f32_d128` does.
9. lm_train  the LM at the width bench.py benchmarks it (vocab 8192, 4
           layers, dim 512, 8 heads, bf16, 8 x 1024 random tokens): 20
           train steps (one warm-up), eval_step, predict_step. Losses must
           be finite and fall; K2', K3', K4' and the delta pass must each
           launch 4 times (one per layer) in every train step and K2-K4
           never, and K2' 4 times in each of eval and predict. Then its
           `step_cost` line and its profile, as in 6.
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
           samples/s and host ms a step past the first task (its
           warm-up), and which parser ran, beside the card's name and
           power limit.
11. job_cli  the same job at a smaller depth (16384 records in 2 tasks)
           through the CLI, `python -m elasticdl_tpu_torch.client.main
           train`: run_local -> ProcessManager -> one
           `elasticdl_tpu_torch.worker.main` subprocess on the card, with
           an explicit environment (no cohort variables, no device
           request). Asserts exit 0, a checkpoint step on disk, an export
           that loads and predicts finite values on the card, and a
           worker log that names a cuda device; prints the log's tail if
           any check fails.
12. knobs  the LM at 9's width: one train step from one cloned state for
           each of base, `remat_policy=dots`, `remat_policy=nothing`,
           `grad_accum=2` and `grad_accum=2` with `dots` (after a warm-up
           step). Each reports its loss, largest parameter difference
           from base, peak device memory, flash launches, the first
           step's ms and the ms of each of 3 steps after it.
           Remat's loss and parameters must equal the step without it
           bit for bit; accumulation 2's loss within rel 1e-4 of base's,
           its gradients within 5e-2 of each one's norm and its
           parameters within 2 x lr of base's (see `phase_knobs`); the
           peaks of `nothing` and of accumulation 2 below base's; K2' 4,
           8, 8, 8 and 16 launches, K3', K4' and the delta pass 4, 4, 4,
           8 and 8.
13. grouped  DeepFM at 5's width over 8 distinct batches: 8 train_steps,
           then from a cloned state 2 `train_many` groups of 4; equal
           losses and parameters bit for bit, K1 launched 16 times in
           each; host ms a step of each path, first in the checked run
           and then in 8-step runs in turns (steps, groups, groups,
           steps).
14. lm_job  the bf16 LM of 9 through the job path in one process:
           `synthetic://lm` with 256 records of 1024 tokens in 4 tasks of
           8 steps, `--steps_per_dispatch 4`, eval at epoch end over 64
           records, and a `--profile_dir` window of 4 steps from step 8.
           Asserts 4 finished tasks and none failed, a finite token
           accuracy in [0, 1], the last group's mean loss below the
           first's, K2', K3', K4' and the delta pass launched 4 times a
           train step and K2' also 4 times an eval step, and a trace that
           names `flash_fwd_sm90_kernel`. Prints the wall time, host ms a
           group and a step, and data_wait and h2d a step.
15. manual_shards (runs right after `kernel`)  the manual embedding
           schedule's per-rank compute at DeepFM's full width (the
           2,605,056 x 17 float32 table, one batch of 8192 x 26 hashed
           ids), each simulated rank of N = 2 and 4 in this one process:
           `embedding.shard_part` (the owned rows, zeros elsewhere) and
           `embedding.shard_part_grad` (K1 on the shard; the ids the shard
           does not own go out of range and K1 drops them). The parts must
           sum to the one-device lookup bit for bit; each shard's gradient
           must match its plain version within K1's bound of phase 3 and
           again bit for bit; the shards' gradients concatenated must match
           the one-device K1 gradient within that bound; K1 must launch 2
           kernels a shard. Prints K1's ms (CUDA events), device ms
           (profiler) and its plain version's ms a shard beside the
           one-device stream's and beside the shard's byte bound
           (`k1_bound_ms`: the whole stream's ids read once, the owned
           ids' rows read once, the shard's rows written once).
16. cohort_job (runs last)  a one-member NCCL cohort through the job
           path at 10's shape: the port's Master in this process and its
           ProcessManager spawning `elasticdl_tpu_torch.worker.main` with
           EDL_PROCESS_ID=0 and EDL_NUM_PROCESSES=1 in its environment and
           a free `--coordinator_addr`, in two runs. The measured run has
           8 tasks, interval checkpoints and no profiler (as 10 has none);
           once its first checkpoint is durable the member is SIGKILLed,
           and the manager relaunches it and it resumes. Asserts 8
           finished tasks and none failed, a world line naming nccl on
           cuda:0 for each process, the resume line, K1's launches (the
           count each process logs with its task lines: 2 a logged train
           step), and the export predicting as the newest checkpoint's
           state does (atol 1e-6). Prints samples/s, host ms a step,
           data_wait and h2d a step and the wall beside the `job` phase's,
           and samples/s and host ms a step past each process's first task
           (its warm-up) beside `job`'s past its first: the cohort
           machinery's cost on one card. The traced run (one task, a
           `--profile_dir` window over its first 2 steps) must finish and
           leave a trace that names both K1 kernels.
17. zoo_kernel (runs right after `kernel`)  K1 against its plain version
           on the streams of the two new recsys models, as `kernel` holds
           it (the same tolerance, a bit-identical rerun, ms, device ms,
           bound, plain and `index_add_` times): xDeepFM's 4096 x 26 ids
           (uniform raw values hashed into 26 fields of 100k, d 17) and
           Wide & Deep's 4096 x 9 ids from the synthetic census rows
           hashed by the port's spec (d 9, a table of 512 rows).
18. zoo_train (after `knobs`)  the five zoo models at their reference
           bench widths (bench.py:4335-4375), bf16, on one repeated batch:
           MNIST CNN batch 1024, ResNet-20 batch 512, ResNet-50 at
           224x224 with 1000 classes and batch 32 (its warm-up cut to 4
           steps), Wide & Deep batch 4096 (synthetic census rows) and
           xDeepFM batch 4096 (field_vocab 100000, hidden 400,400, CIN
           128,128, embedding 16): ZOO_STEPS train steps (the first a
           warm-up), eval and predict. Asserts finite falling losses, K1
           launched 2 a step in the two recsys models and never in the
           CNNs, the first BatchNorm's running averages one hand update
           (0.9 ra + 0.1 x the step's batch statistics, bit for bit) past
           the first step, finite predictions, and ResNet-50's remat step
           equal to its plain step bit for bit under deterministic cuDNN.
           Prints step ms (CUDA events), host ms a step, samples/s and peak
           memory a model, and the ResNets' profiles, as in 6; then each
           model's `step_cost` line.
19. zoo_job (after `job_cli`)  ResNet-20 on `synthetic://cifar10` (batch
           512) and Wide & Deep on `synthetic://census` (batch 4096)
           through the job path in one process, as `job` runs it: 4 tasks
           of 2 steps, eval at epoch end, checkpoints at steps 4 and 8,
           SAVE_MODEL and the export. Asserts the tasks, a finite eval
           metric, K1's launches (2 a step of Wide & Deep, none in
           ResNet-20), the newest checkpoint restoring the final state
           exactly (params, BatchNorm's buffers, optimizer slots) and the
           export on the card predicting as the state does (atol 1e-6).
           Prints samples/s, host ms, data_wait and h2d a step, the wall
           and the eval metrics.
20. tier (after `zoo_job`, before `cohort_job`)  the elastic embedding
           tier at the reference bench leg's configuration
           (bench.py:1371-1387: one table `users`, 262,144 x 32 float32,
           seed 3; 8 shards; batches of 4096 x 16 ids zipf(1.3) % vocab
           from RandomState(7); 8 steps after a warm-up). Serving, as
           bench.py's `_et_serving_loops`: the single-host lane (1 shard,
           no dedupe, a push per occurrence) in host mode, the sharded
           deduped lane on 8 device-mode stores on the card over
           LocalTransport, and the same lane in host mode, each with
           rows/s and pull and push p50/p99; the device lane's final
           shards must equal the host lane's bit for bit (deduped pushes
           send sorted unique ids, one term a row), and K1 must launch 2
           kernels a shard pushed. K1 on one shard's push of that lane
           and at the flagship geometry (a tier table of DeepFM's
           2,605,056 x 17, 8 shards, one deduped batch of 8192 x 26 hashed
           ids as `kernel` draws them), held as `kernel` holds K1, with
           ms, device ms, bound, plain ms, `index_add_` on the in-range
           ids, and the whole push's device work (`rows + scale x delta`)
           beside its bound. Then `EmbeddingTierSession.step` with a
           TierEmbedding (sum) logistic loss, 8 steps at lr 0.1: finite
           losses, the shards within rtol 1e-5 and atol 1e-6 of the
           largest row of a dense float32 replay on the card, K1 in each
           step's backward and each push. Last the kill-worker reshard
           under the port's Master (`--embedding_shards 8`, gRPC) with
           three device-mode WorkerTierRuntimes, at the bench's reshard
           table (65,536 x 16, seed 5; 1024 x 8 ids from RandomState(11)):
           the map commits at version 2 without the victim, every shard
           bit-exact, a re-sent acknowledged push dedupes, no new
           CompileCache miss in the recovery; prints its wall. Then the
           whole script's wall on a line of its own (`wall`).
21. moe_train (after `lm_train`)  the Switch-MoE LM (`moe_experts=8`,
           capacity factor 1.25, aux weight 0.01) at 9's width and batch:
           a warm-up step, STEPS timed train steps, eval and predict.
           Asserts finite falling losses, K2', K3', K4' and the delta pass
           4 times a train step (K2' also 4 times in each of eval and
           predict), finite aux losses and a dropped share in [0, 1).
           Prints step ms, host ms, tokens/s, peak memory, the first and
           last loss, each block's aux, the share of tokens dropped, and
           the profile. Then one MoE layer at this width (8192 tokens,
           capacity 1280) by the index route and by the dense plain route
           (`ops/moe.py`): outputs, aux and the expert kernels' gradients
           equal bit for bit, the other gradients within rtol 1e-6 with
           atol 1e-6 of the largest; each route's fwd + bwd ms and
           FLOPs (`training.step_cost`), the dense route's extra the
           one-hot products' 10 N E Cap C exactly. Then its `step_cost`
           line.
22. pp_train (after `moe_train`)  the pipelined LM (`pp_axis=pp`, 4
           microbatches) with no pp axis, the sequential fold of its 4
           stacked stages, as 21 runs the MoE LM (the same launches).
           Then `tp_axis=model` with no mesh against the plain LM: one
           step from one seed, loss and parameters bit for bit.
23. moe_job (after `lm_job`)  the MoE LM of 21 through the job path as
           14 runs the LM (no profiler window), with checkpoints every 16
           steps (steps 16 and 32 kept): 4 tasks, a token accuracy in [0,
           1], K2', K3', K4' and the delta pass 4 times a train step and
           K2' 4 times an eval step, and the newest checkpoint restoring
           the final state exactly (router, experts, `moe_aux`). Prints
           the wall, host ms and tokens/s a step, data_wait and h2d.
24. ring_attn (after `attn_kernel`)  the sequence-parallel ring of
           `ops/attention.py` in one process at the LM's attention width
           (B 8, T 1024, H 8, D 64, bf16, causal), over 4 virtual ranks of
           256 columns (`ring_attention_local`: the same schedule and
           merge as the sharded ring, with a rotation that hands each
           virtual rank the blocks it would receive), forward and backward
           with a random cotangent; then Ulysses over 4 virtual ranks
           (2 heads each over the whole sequence, `ulysses_local`). The
           ring must launch K2' 16 times (4 x 4 block pairs, the wholly
           masked ones included) and K3', K4' and the delta pass 16 times
           each in the backward,
           at nonzero offsets and with the merge's live lse cotangent;
           Ulysses 4 of each. Each launch is held against its plain
           version on the same inputs (`phase_attn_kernel`'s bf16
           tolerance; the wholly masked blocks 0 with lse NEG_BIG), and
           the schedule's output and gradients against itself with the
           plain versions and against one unsplit `full_attention`
           (RING_OUT_TOL, RING_GRAD_TOL, which say why: the gradients
           are bf16 sums of 4 partials), with each error's share of its
           tolerance; then timed fwd + bwd beside the unsplit call (CUDA
           events).
25. seq_train (after `lm_train`)  the LM at 9's width on a one-rank NCCL
           world with the mesh {data 1, seq 1}: 3 train steps equal the
           same steps with no mesh bit for bit (the fallback at a seq
           size of 1), with `lm_train`'s launches; then the LM with each
           block's attention as the in-process ring of 24 over 4 blocks, 3
           train steps: finite, falling, the first loss within rel 1e-2 of
           the unsplit one's, K2', K3', K4' and the delta pass 16 times a
           layer and step.
26. autoscale_job (after `cohort_job`)  the closed-loop autoscaler over
           the DeepFM job at 10's width (6 tasks of 2 steps, no eval),
           with one plain training worker (the reference's config refuses
           two, which would train independent replicas, and a card takes
           one cohort rank): the first submission is wired as
           `client/local.run_local` wires it, with `--autoscale
           --straggler_quorum 2`, hold, cooldown and rescale cost of 1 s
           and the reference's `fleet_data_wait_dominant` rule (value
           mode, threshold 0.5); the job's data wait reaches the policy,
           whose `shrink` must be suppressed `world_at_min` and journaled,
           with nothing applied. After the first finished task the
           policy's target evicts the worker: it must drain (the
           heartbeat evict bit, an in-flight task's remainder requeued, no
           `worker_died` waste), exit 75 and be retired, not relaunched.
           The job is resubmitted through `run_local` over the same
           checkpoint directory and must finish every task once across
           the two; K1 must launch twice a logged train step in the
           evicted and in the resumed worker. Prints every decision with
           its kind and reason, the signal's onset and its decision, the
           evict-to-retired time, and each worker's host ms and data_wait
           a step and K1 launches.
27. callbacks_job  zoo callbacks over the DeepFM job at 10's width in one
           process: a zoo module written to a temp directory, the port's
           DeepFM with `ReduceLROnPlateau` (1e-3 halved once to 5e-4 on a
           certain plateau of the eval AUC) and `EarlyStopping` (three
           evals without an improvement), 8 training tasks of 2 steps and
           an eval job of one batch every 2 steps. The pushed 5e-4 must be
           in every param group of the worker's Adam on the card and in
           the checkpoint's optimizer state, EarlyStopping must stop
           training (the dispatcher's stop line names its reason) before
           the data runs out, none failed, and K1 must launch twice a
           train step.
28. hybrid_mesh  `--dcn_mesh_shape data=1` on a one-rank NCCL world:
           DeepFM at 5's width, 3 train steps on the mesh `build_job_mesh`
           builds from it and 3 on the flat mesh, from one seed: losses
           and parameters equal bit for bit, K1 twice a step in each.
29. seq_mix (after `seq_train`)  sequence parallelism beside tensor and
           expert parallelism in one process, at `ring_attn`'s shape cut
           into 2 head groups of 4 heads (a `model` axis of 2 ranks, each
           holding its column split's heads): the ring over 4 virtual
           ranks on each group, held as `ring_attn` holds it (each launch
           against its plain version, the joined output and gradients
           against one unsplit call; 2 x 16 launches of K2', K3', K4' and
           the delta pass), and Ulysses over 2 virtual ranks on each group
           (2 x 2); the LM of 9 with each block's attention the ring over
           head groups, 3 train steps as 25 holds them (2 x 16 launches a
           layer and step); and one MoE layer at the MoE LM's width (8192
           tokens, 8 experts) routed over 2 x 2 (data, seq) blocks
           (`ops.moe.blocks_local`: each block's `route` given the counts
           a mesh's gathers would bring) at capacity factors 1.25
           (capacity 1280) and 0.5 (capacity 512, where tokens drop and
           the arrival order decides which): each block's experts, slots,
           keep and capacity equal to the global route's bit for bit, its
           aux within rel 1e-6, its index route's output rows the global
           layer's bit for bit where the block's gates are, and within
           MOE_OUT_TOL elsewhere (the router's float32 product runs per
           block, and cuBLAS picks its kernel by the rows, so the last
           bits of a gate can differ).
30. k8s_job (after `job_cli`)  the DeepFM job at `job_cli`'s depth (2
           tasks of one step at batch 8192, eval at epoch end, a checkpoint
           every step, SAVE_MODEL, the export) through the Kubernetes
           path: the master started with the command, args and env of the
           master pod `client/k8s.render_job_manifests` renders for
           `--instance_manager k8s`, its real `KubectlApi` in front of a
           stand-in kubectl (`STANDIN_KUBECTL`: a pod is a local process;
           apply, the JSON watch stream of phase changes, delete with
           SIGTERM and a 30 s grace). The master's pod manager creates one
           training worker pod on the card; once the first checkpoint is
           durable its process is SIGKILLed, the manager must see it
           Failed, recover its lease and create the next generation,
           which resumes from the checkpoint. Asserts the master's exit 0,
           the pods created exactly `...-worker-0-g0` then `-g1`, a cuda
           device in each worker's log, K1's launches in both pods (2 a
           logged train step), the newest checkpoint at the job's last
           step, every training task finished once and none failed (the
           master's job-end line), and the export loading and predicting
           finite values on the card. Prints the wall, the relaunch's
           seconds from the Failed phase to the new pod's registration and
           to its first finished task, and each pod's device, steps and K1
           launches.
31. zoo_init (after `k8s_job`)  `zoo init` into a temporary directory
           through the CLI, then one train step of the template's model
           (a 2-unit Dense, Adam at 1e-3) on the card at batch 8192
           through the port's ModelSpec and Trainer: a finite loss and a
           largest parameter step in (0, 2e-3].
32. tools (after `zoo_init`)  the port's tooling beside the job path:
           `data/convert.convert_url` writes `synthetic://criteo` as 4
           `.rio` shards of JOB_TASK records (the `job` phase's count and
           layout); K1 on the first batch of them (read back by the
           port's reader, parsed by DeepFM's dataset_fn, hashed as the
           model hashes) against its plain version, as `kernel` holds it;
           the DeepFM job at `job`'s shape over the shards through the
           CLI (a subprocess worker on the card, `--trace_dir`, each
           process's flight bundle at exit), which must end with exit 0
           and 4 task lines over 8 steps and K1 launched twice a step;
           then `python -m elasticdl_tpu_torch.observability.analyze
           --strict` over the job's trace and `incident --strict` over
           its flight bundles (master and worker-0), both exit 0.
           Started first and running on the host meanwhile: edl-lint over
           the port's tree (`python -m elasticdl_tpu_torch.analysis`:
           exit 0, no finding) and the fleet soak TOOLS_SCENARIO with its
           artifacts (`python -m elasticdl_tpu_torch.fleetsim`: exit 0,
           replay identical, no lost lease, its incident check 0). Prints
           the job's data_wait and h2d a step beside `job`'s synthetic
           figures, K1's error and times on the shards' stream, each
           tool's wall, and the soak's digest.
33. serve_export (after `job`)  the serving export on the card: `job`'s
           DeepFM export (the 2,605,056 x 17 table, bf16 DNN 400,400) and
           the bf16 LM of 9 (random weights from a seed, exported as a
           worker exports), each through `export_saved_model`
           (`torch.export` on cuda:0, the batch symbolic; example batch
           8192 and 8 x 1024) and `load_saved_model`. The program's
           outputs at the full batch and at 3 rows must equal the eager
           `load_model` model's on the same rows within 1e-6 (DeepFM;
           `export_matches`' bound) or 1e-6 of the largest logit (the LM),
           bit for bit expected; the exported LM's forward must launch K2'
           exactly once a layer (4) and no K2 from its 4 `edl::flash_fwd`
           nodes, and DeepFM's nothing (K1 runs only in a backward). A
           fresh process that imports only `training.export` loads the
           LM's `.pt2` on the card and serves the 8 rows bit-equal to this
           process, with its own 4 K2' launches. Prints each export's
           seconds, load seconds and `.pt2` bytes, and the served and
           eager forward's ms (CUDA events, median after warm-up) at both
           batches.
The `step_cost` lines (in `train`, `lm_train`, `moe_train` and, one a
model, `zoo_train`): `Trainer.train_step_cost` of the phase's own
trainer, state and batch, after the phase has read its launch counts:
FLOPs (the products: matmuls, convolutions, attention) and bytes
accessed (each op's operands and results once, an upper bound), the
phase's step ms and the model-FLOP share `mfu` = flops / (step s x the
named peak, BF16_FLOPS for the bf16 models), the cost call's wall and
the kernels its step launched (it runs one step and puts the state
back, which must then be bit-equal). A CPU trainer of the same model,
width and batch counts the same FLOPs, or the run fails.
Every phase line carries `phase_wall_s`, the seconds since its phase
began, and the `wall` line the list of each phase's wall in the order
they ran.
34. lm_train_d128 (after `lm_train`)  the LM at 9's width with 4 heads of
           128 (`LM_D128_PARAMS`, bf16, 8 x 1024 random tokens): 6 train
           steps (one warm-up), eval and predict, no profile and no step
           cost. Losses must be finite and fall; K2', K3', K4' (its D 128
           layout) and the delta pass must each launch 4 times in every
           train step and K2-K4 never, and K2' 4 times in each of eval and
           predict.
35. lm_train_d16, lm_train_d32 (after `lm_train_d128`)  the LM at 9's
           width with 32 heads of 16 (`LM_D16_PARAMS`; D 16 is the head
           dim of the zoo LM's default configuration) and with 16 heads of
           32 (`LM_D32_PARAMS`), bf16, 8 x 1024 random tokens: 6 train
           steps (one warm-up), eval and predict, as 34. Losses must be
           finite and fall; K2', K3', K4' (at the narrow D) and the delta
           pass must each launch 4 times in every train step and K2, K3
           and K4 never, and K2' 4 times in each of eval and predict.
36. lm_train_f32 (after `lm_train`)  the LM at 9's width (D 64) in
           float32 on 9's batch: 6 train steps (one warm-up), eval and
           predict, as 34. Losses must be finite and fall; K2-tf32,
           K3-tf32, K4-tf32 and the delta pass must each launch 4 times in
           every train step, K2-tf32 4 times in each of eval and predict,
           and K2-K4, K2', K3' and K4' never. Step ms, host ms, tokens/s,
           peak memory; then its profile, as in 6.
37. lm_train_f32_d128 (after `lm_train_d128`)  the LM at 34's width (4
           heads of 128, `LM_D128_PARAMS`) in float32 on 9's batch: 6
           train steps (one warm-up), eval and predict, as 36. Losses
           must be finite and fall; K2-tf32, K3-tf32, K4-tf32 and the
           delta pass must each launch 4 times in every train step,
           K2-tf32 4 times in each of eval and predict, and K2-K4, K2',
           K3' and K4' never. Step ms, host ms, tokens/s, peak memory;
           then its profile, as in 6.
38. graph_step (after `lm_parity`)  the trainer's captured path
           (`training/step_graph.py`): DeepFM at 5's width, the bf16 LM
           at 9's and the float32 LM at 36's, each with a trainer that
           captures its steps as CUDA
           graphs and an eager twin from the same weights and seed: 10
           train steps each way (the captured trainer's first call
           captures, every call replays), then a `train_many` group of 4
           (one graph of the 4 steps) against 4 eager steps. Losses,
           parameters and Adam's slots must be equal bit for bit, the
           train step's graph replayed 10 times and the group's once,
           and torch.profiler over one replay must name K1's two kernels
           (DeepFM), K2', K3', K4' and the delta pass (the bf16 LM) or
           K2-tf32, K3-tf32, K4-tf32 and the delta pass (the float32
           LM), each as many times as the launches the capture recorded
           and each replay credits to the kernel's counter (K1's zero and
           placement passes together equal its count, PASSES a call).
           Prints host ms a step (the call's own time, no wait) and
           wall ms a step eager and replayed, one step's device ms and
           kernels each way and the busy share, the capture's and the
           warm-up's seconds, each graph's pool bytes and its kernels'
           launches a replay. The other phases' trainers capture too, where the
           trainer's rule says so (`Trainer.capture_reason`, on their
           lines as `steps`); the kernels' counters count a replay's
           launches and leave the capture warm-ups' out
           (`step_graph.warmup_launches`, each kernel's on the `kernels`
           line as `warmup_launches`).
Then the `kernels` line (K1's `launches` are the job's, with the
`grouped`, `cohort_job`, `manual_shards`, `tier`, `autoscale_job`,
`callbacks_job`, `hybrid_mesh`, `k8s_job` and `tools` phases' beside
them; the Hopper kernels' are `lm_train`'s, with `lm_job`'s,
`moe_train`'s, `pp_train`'s, `moe_job`'s, `ring_attn`'s,
`seq_train`'s and `seq_mix`'s beside them, and K2''s `serve_export`'s;
K4' at D 128 is an entry of its own, `lm_train_d128`'s launches, and so
are K2', K3' and K4' at D 16 and 32, `lm_train_d16`'s and
`lm_train_d32`'s, and K2' and K3' at D 128, `lm_train_d128`'s; K2-tf32,
K3-tf32 and K4-tf32 at each D are entries of their own, `lm_parity`'s at
D 16 and 32, `lm_train_f32`'s at D 64 and `lm_train_f32_d128`'s at D 128;
K2-K4 report float32 at D 128 first, with float32 at D 16, 32 and 64 and
bf16 at D 16, 32 and 64 (and K4 at 128) beside, their launches from
`lm_train_f32_d128` (0: no LM's route takes them), `lm_parity`'s
beside; the delta pass also its launches in `lm_train_d16`,
`lm_train_d32`, `lm_train_f32`, `lm_train_f32_d128` and `lm_parity`, and
its float32 times), the nvidia-smi line, and last the `ok` line.

It exits non-zero without a result where CUDA is unavailable, and where
the port's package is absent.
"""

import ast
import ctypes
import gc
import glob
import json
import logging
import math
import os
import re
import shutil
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
TF32_FLOPS = 495e12              # H100 SXM dense TF32 (tensor cores)
# the LM as bench.py's transformer_lm leg runs it (bench.py:4398-4407)
LM_PARAMS = "vocab=8192;num_layers=4;dim=512;heads=8;max_len=1024"
LM_LAYERS, LM_BATCH, LM_T, LM_VOCAB, LM_DIM = 4, 8, 1024, 8192, 512
LM_SMALL = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64"
# the small float32 LM at D 16 (LM_SMALL), 32 and 128 (K2-tf32, K3-tf32,
# K4-tf32 each): `lm_parity`'s configurations
LM_PARITY = {16: LM_SMALL,
             32: "vocab=64;num_layers=2;dim=64;heads=2;max_len=64",
             128: "vocab=64;num_layers=2;dim=256;heads=2;max_len=64"}
# the job phases: Criteo records per training task, and the variables a
# polluted environment can carry that would make a spawned worker a member
# of a cohort that never forms
JOB_TASK = 16384
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR")


# the running phase's start (`timed`) and each finished phase's wall, in
# the order they ran: every line carries its phase's seconds so far, the
# `wall` line the list
PHASE_T0 = [time.perf_counter()]
PHASE_WALLS = []


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "phase_wall_s": time.perf_counter() - PHASE_T0[0]}),
          flush=True)


def timed(name, fn, *args):
    """Run the phase `fn(*args)`, noting its wall under `name`."""
    PHASE_T0[0] = time.perf_counter()
    out = fn(*args)
    PHASE_WALLS.append([name, time.perf_counter() - PHASE_T0[0]])
    return out


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


def device_ms(fn, names, calls=20, tries=3):
    """{name: device ms a call} of each kernel whose symbol contains one of
    `names` (the name "" matches all the call's device work), from
    torch.profiler over `calls` calls of `fn` after one warm-up; "not
    measured" where the profiler saw no device time. Every call launches
    the same kernels, so a name's count of kernels that is no multiple of
    `calls` means the trace lost some: the calls are traced again, at most
    `tries` times in all, and then the name is "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {name: 0.0 for name in names}
        seen = {name: 0 for name in names}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for name in names:
                if name in e.name:
                    us[name] += e.time_range.elapsed_us()
                    seen[name] += 1
        whole = {name: seen[name] % calls == 0 for name in names}
        if all(whole.values()):
            break
    return {name: (t / 1e3 / calls if t and whole[name] else "not measured")
            for name, t in us.items()}


K1_SYMBOLS = ("place_zero_kernel", "place_sorted_grads_kernel")


def k1_bound_ms(n, in_range, num_rows, d):
    """K1's bound over a stream of `n` ids, `in_range` of them inside the
    table of `num_rows` rows of width `d`: every id read once, the row of
    each in-range id read once (K1 reads no row of an out-of-range id)
    and added once, the table written once."""
    bytes_moved = n * 4 + in_range * d * 4 + num_rows * d * 4
    return max(bytes_moved / HBM_BYTES_PER_S, in_range * d / F32_FLOPS) * 1e3


def k1_stream(ids, rows, num_rows, dev):
    """K1 against its plain version on one sorted stream: each entry held
    to 1e-6 + 1e-5 x the sum of the magnitudes of its terms, a second
    call giving the same bits; its times beside the bound, the plain
    version and the `index_add_` yardstick. Returns the stream's entry
    (`ok` false where it disagrees)."""
    from elasticdl_tpu_torch.ops import placement

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
            lambda: placement.place_sorted_grads_plain(ids, rows, num_rows),
            groups=5, per_group=3)
        entry["bound_ms"] = k1_bound_ms(
            n, int(((ids >= 0) & (ids < num_rows)).sum()), num_rows, d)
    return entry


def phase_kernel(dev):
    from elasticdl_tpu_torch.ops import placement

    report, worst_abs, worst_rel = {}, 0.0, 0.0
    for name, ids, rows, num_rows in k1_streams(dev):
        entry = report[name] = k1_stream(ids, rows, num_rows, dev)
        worst_abs = max(worst_abs, entry["max_abs_err"])
        worst_rel = max(worst_rel, entry["max_rel_err"])
        if not entry["ok"]:
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
    lm = lm_batch(21, b=8, t=32, vocab=64)
    update = {
        "deepfm_adam": update_parity(
            "field_vocab=1000;hidden=32,32", batch, 5e-4, 1e-5),
        "lm_adamw": update_parity(LM_SMALL, lm, 1e-4, 5e-5, LM_DEF),
        "resnet20_sgd": update_parity(
            "depth=20", {"features": np.random.RandomState(6).rand(
                16, 32, 32, 3).astype(np.float32),
                "labels": np.arange(16, dtype=np.int32) % 10},
            0.05, 1e-5, "cifar10.resnet.custom_model")}
    emit("parity", loss_cuda=gpu_loss, loss_cpu=cpu_loss,
         params=len(cpu_grads), worst_grad_err_over_tol=worst,
         update=update)


def update_parity(params, batch, lr2, loss_rtol,
                  model_def="deepfm.deepfm.custom_model"):
    """The card's optimizer update against the CPU's plain one (the
    `update` of phase 4): two train steps of `model_def` in float32 on
    the card, captured, over the zoo optimizer's card flavour, and two on
    the CPU in the plain flavour, from the same weights and batch, the
    second after `set_learning_rate(lr2)` on both. Losses within
    `loss_rtol`; parameters and slots rtol 1e-4, atol 1e-5; k biases
    within the two rates of 0. Returns the fields to emit."""
    from elasticdl_tpu_torch.training import lr_modulation, step_graph
    from elasticdl_tpu_torch.training.trainer import Trainer

    runs, weights = [], None
    for dev in ("cpu", "cuda"):
        tr = Trainer(load_spec(params, "float32", model_def), device=dev)
        state = tr.init_state(batch)
        if weights is None:
            weights = {k: v.detach().clone()
                       for k, v in tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        lr1 = lr_modulation.get_learning_rate(state.optimizer)
        losses = []
        for i in range(2):
            if i:
                tr.set_learning_rate(state, lr2)
            state, logs = tr.train_step(state, batch)
            losses.append(float(logs["loss"]))
        runs.append((tr, state, losses))
    (_, cs, cpu_losses), (card, gs, card_losses) = runs
    graphs = [g for g in card._train_step.graphs() if g.bound_to(card, gs)]
    if (card.capture_reason is not None or len(graphs) != 1
            or not isinstance(graphs[0], step_graph.CapturedGraph)
            or graphs[0].replays != 2):
        raise AssertionError(f"{model_def}: the card's steps were not two "
                             f"replays of one graph ({card.capture_reason})")
    flavour = {k: v for k, v in gs.optimizer.defaults.items()
               if k in ("capturable", "fused") and v}
    if not flavour or not isinstance(gs.optimizer.param_groups[0]["lr"],
                                     torch.Tensor):
        raise AssertionError(f"{model_def}: the card's optimizer is not its "
                             f"card flavour: {gs.optimizer.defaults}")
    for got, want in zip(card_losses, cpu_losses):
        if abs(got - want) > loss_rtol * abs(want):
            raise AssertionError(f"{model_def}: losses {card_losses} on the "
                                 f"card vs {cpu_losses} on the cpu")
    worst, slots_held = 0.0, 0
    for n, p in cs.params.items():
        q = gs.params[n]
        if n.endswith(".k.bias"):
            if max(float(p.detach().abs().max()),
                   float(q.detach().abs().max())) > lr1 + lr2:
                raise AssertionError(f"{n} moved past the learning rate")
            continue
        pairs = [(n, q, p)] + [
            (f"{n} {k}", gs.optimizer.state[q][k], v)
            for k, v in cs.optimizer.state[p].items()]
        if cs.optimizer.state[p].keys() != gs.optimizer.state[q].keys():
            raise AssertionError(f"{n}: slots {list(gs.optimizer.state[q])} "
                                 f"on the card, "
                                 f"{list(cs.optimizer.state[p])} on the cpu")
        slots_held += len(pairs) - 1
        for what, got, want in pairs:
            got, want = got.detach().cpu().double(), want.detach().double()
            ratio = float(((got - want).abs()
                           / (1e-5 + 1e-4 * want.abs())).max())
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise AssertionError(f"{model_def}: {what} differs between "
                                     f"the card and the cpu ({ratio} of its "
                                     "tolerance)")
    return dict(flavour=flavour, lr=[lr1, lr2], losses_cuda=card_losses,
                losses_cpu=cpu_losses, slots_held=slots_held,
                worst_err_over_tol=worst)


def phase_train(smi):
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.trainer import Trainer

    params = f"field_vocab={FIELD_VOCAB};hidden=400,400"
    spec = load_spec(params)
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
         step_mode=step_mode(trainer),
         losses=losses, step_ms=step_ms,
         host_step_ms=host_s * 1e3 / (STEPS - 1),
         samples_per_s=BATCH / (step_ms / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         k1_launches=launches, eval=results,
         predict_shape=list(preds.shape))
    step_cost("deepfm", trainer, state, batch, step_ms,
              lambda: load_spec(params), smi, batch_size=BATCH)
    phase_profile(trainer, state, batch, step_ms)
    return launches


def phase_profile(trainer, state, batch, step_ms, steps=3, **labels):
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
    emit("profile", **labels, steps=steps,
         profiled_wall_ms_per_step=wall_ms / steps,
         device_ms_per_step=device_ms if by_name else "not measured",
         device_busy_share=device_ms / step_ms if by_name
         else "not measured",
         kernels_per_step=kernels,
         top=[{"ms_per_step": us / 1e3 / steps, "per_step": n / steps,
               "name": name[:100]} for name, (us, n) in top])


def kernel_counts():
    """Every kernel's launch count: K1's and each flash kernel's."""
    from elasticdl_tpu_torch.training import step_graph

    return step_graph.launch_counts()


def step_mode(trainer):
    """How `trainer` runs its steps: "captured" (CUDA graphs) or why it
    runs them eagerly (`Trainer.capture_reason`)."""
    reason = trainer.capture_reason
    return "captured" if reason is None else f"eager: {reason}"


def state_tensors(state):
    """What a train step changes in a TrainState, by name: parameters,
    buffers, the optimizer's tensor slots and the generator's state."""
    out = {f"param:{n}": p.detach() for n, p in state.params.items()}
    out.update({f"buffer:{n}": b for n, b in state.buffers.items()})
    for n, p in state.params.items():
        for k, v in state.optimizer.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                out[f"slot:{n}.{k}"] = v
    out["generator"] = state.generator.get_state()
    return out


def step_cost(model, trainer, state, batch, step_ms, cpu_spec, smi,
              **fields):
    """`Trainer.train_step_cost` of a phase's own trainer, state and batch
    on the card, after the phase has read its launch counts, beside a CPU
    trainer's cost of the same model, width and batch (`cpu_spec()` makes
    its spec). Emits a `step_cost` line: FLOPs (products only), bytes
    accessed, the phase's step ms, the model-FLOP share `mfu` = flops /
    (step s x BF16_FLOPS: every model the phases train computes in bf16),
    the cost call's wall and the CPU's, and the kernels the cost call's
    step launched (`cost_launches`: it runs one step on the state and
    puts the state back). Fails unless the card's FLOPs
    equal the CPU's (the hand-written kernels count by formula at their
    dispatcher ops, so the count does not depend on the device) and the
    state is bit-equal after the call."""
    from elasticdl_tpu_torch.training.trainer import Trainer

    before = {k: v.clone() for k, v in state_tensors(state).items()}
    step, counts = state.step, kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cost = trainer.train_step_cost(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: n - counts[k] for k, n in kernel_counts().items()
                if n != counts[k]}
    after = state_tensors(state)
    changed = sorted(set(before) ^ set(after)) + [
        k for k in before if k in after and not torch.equal(before[k],
                                                            after[k])]
    del before, after
    t0 = time.perf_counter()
    cpu = Trainer(cpu_spec(), device="cpu")
    cpu_cost = cpu.train_step_cost(cpu.init_state(batch), batch)
    cpu_wall = time.perf_counter() - t0
    del cpu
    emit("step_cost", model=model, card=smi, flops=cost["flops"],
         bytes_accessed=cost["bytes accessed"], step_ms=step_ms,
         mfu=cost["flops"] / (step_ms / 1e3 * BF16_FLOPS),
         peak="BF16_FLOPS", peak_flops=BF16_FLOPS, cost_wall_s=wall,
         cpu_flops=cpu_cost["flops"],
         cpu_bytes_accessed=cpu_cost["bytes accessed"],
         cpu_cost_wall_s=cpu_wall, cost_launches=launched, **fields)
    if cpu_cost["flops"] != cost["flops"]:
        raise AssertionError(f"{model}: {cost['flops']} FLOPs on the card, "
                             f"{cpu_cost['flops']} on the CPU")
    if changed or state.step != step:
        raise AssertionError(f"{model}: the cost call changed the state: "
                             f"{changed[:8]}, step {step} -> {state.step}")
    return cost


PALLAS = "elasticdl_tpu/ops/pallas_attention.py"
CSRC = "elasticdl_tpu_torch/csrc"
DKV128 = "flash_bwd_dkv_sm90<D=128>"
# K2', K4' and K3' at the narrow head dims, entries of their own
FWD16, FWD32 = "flash_fwd_sm90<D=16>", "flash_fwd_sm90<D=32>"
DKV16, DKV32 = "flash_bwd_dkv_sm90<D=16>", "flash_bwd_dkv_sm90<D=32>"
DQ16, DQ32 = "flash_bwd_dq_sm90<D=16>", "flash_bwd_dq_sm90<D=32>"
NARROW = {16: (FWD16, DKV16, DQ16), 32: (FWD32, DKV32, DQ32)}
# K2' and K3' at D 128, entries of their own
FWD128, DQ128 = "flash_fwd_sm90<D=128>", "flash_bwd_dq_sm90<D=128>"
# K2-tf32, K3-tf32 and K4-tf32 (float32, 3xTF32 products) at each head
# dim they take
TF32 = {d: f"flash_fwd_tf32_sm90<D={d}>" for d in (16, 32, 64, 128)}
DQ_TF32 = {d: f"flash_bwd_dq_tf32_sm90<D={d}>" for d in TF32}
DKV_TF32 = {d: f"flash_bwd_dkv_tf32_sm90<D={d}>" for d in TF32}
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
    # K4' at D 128: the same wrapper and source, one consumer warpgroup a
    # block; K2' and K3' at D 128, their N 128 products
    DKV128: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:433"),
    FWD128: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:256"),
    DQ128: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:404"),
    # K2' and K4' at D 16 and 32: the same wrappers and source, 32- and
    # 64-byte swizzled rows, N 16 and 32 products into O, dK and dV
    FWD16: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:256"),
    FWD32: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:256"),
    DKV16: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:433"),
    DKV32: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:433"),
    # K3' at D 16 and 32: one consumer warpgroup a block, N 16 and 32
    # products into dQ
    DQ16: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:404"),
    DQ32: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:404"),
    # the delta fold of both backward kernels (pallas_attention.py:302-307)
    "flash_bwd_delta_sm90": (f"{CSRC}/flash_attention_sm90.cu",
                             f"{PALLAS}:404"),
    # K2-tf32: the float32 forward on the tensor cores, an entry a head dim
    **{name: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:256")
       for name in TF32.values()},
    # K3-tf32 and K4-tf32: the float32 backward on the tensor cores
    **{name: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:404")
       for name in DQ_TF32.values()},
    **{name: (f"{CSRC}/flash_attention_sm90.cu", f"{PALLAS}:433")
       for name in DKV_TF32.values()},
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
        r"(flash_(?:fwd|fwd_tf32|bwd_dq|bwd_dq_tf32|bwd_dkv|bwd_dkv_tf32|"
        r"bwd_delta)_sm90_kernel)ILi(\d+)E(f?)",
        mangled)
    if k:   # the delta pass's float32 instantiation carries its type
        return f"{k.group(1)}<D={k.group(2)}{',f32' if k.group(3) else ''}>"
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
    and each output written once. For float32 inputs each product counts
    as three TF32 products (hi.hi + hi.lo + lo.hi of a 3xTF32 split) at
    the TF32 peak: the least tensor work that holds float32's contract
    (one TF32 product errs by ~2^-11), and below the CUDA cores' float32
    FMAs at F32_FLOPS, which a tensor-core kernel can beat. K3', K4',
    K3-tf32 and K4-tf32 read delta where K3 and K4 read O; the delta pass
    does 2 B.T.H.D FLOPs on float32 (the CUDA cores' peak)."""
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
    }[re.sub(r"^flash_fwd_sm90$", "flash_fwd", kernel.replace("_tf32", ""))]
    if itemsize == 4 and flops:
        flops, peak = 3 * flops, TF32_FLOPS
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
    wrappers, which must take the kernels `route` names; returns the
    cases' report and each kernel's worst (max abs error, share of
    tolerance)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    full = (LM_BATCH, LM_T, LM_T, 8, 64, bf16)
    small, twin = (2, 32, 32, 2, 16, f32), (2, 32, 32, 2, 64, bf16)
    twin128 = twin[:4] + (128, bf16)
    cases = [  # name, (B, Tq, Tk, H, D, dtype), causal, q_off, kv_off, g_lse
        ("full_b8_t1024_h8_d64_bf16_causal", full, True, 0, 0, False),
        ("full_b8_t1024_h8_d128_bf16_causal", full[:4] + (128, bf16), True,
         0, 0, False),
        ("full_b8_t1024_h8_d64_f32_causal", full[:5] + (f32,), True, 0, 0,
         False),
        ("full_b8_t1024_h8_d16_bf16_causal", full[:4] + (16, bf16), True,
         0, 0, False),
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
        ("bf16_d128_offsets_64_32", twin128, True, 64, 32, False),
        ("bf16_d128_not_causal_tq100_tk230", (2, 100, 230, 2, 128, bf16),
         False, 0, 0, False),
        ("bf16_d128_fully_masked_kv_offset_1024", twin128, True, 0, 1024,
         False),
        ("bf16_d128_lse_with_g_lse", (2, 64, 64, 2, 128, bf16), True, 0, 0,
         True),
        ("full_b8_t1024_h8_d32_bf16_causal", full[:4] + (32, bf16), True,
         0, 0, False),
        # K2-tf32 at the float32 LM's width (D 16), and at D 32 and 64
        # with tails and offsets
        ("full_b8_t1024_h8_d16_f32_causal", full[:4] + (16, f32), True, 0,
         0, False),
        ("f32_d32_tq200_tk230_offsets_37_5", (2, 200, 230, 3, 32, f32), True,
         37, 5, False),
        ("f32_d32_not_causal_tq100_tk230", (2, 100, 230, 2, 32, f32), False,
         0, 0, True),
        ("f32_d64_offsets_64_32", small[:4] + (64, f32), True, 64, 32,
         False),
        ("f32_d64_fully_masked_kv_offset_1024", small[:4] + (64, f32), True,
         0, 1024, False),
        # float32 D 128 (K2-tf32; the delta pass, K3-tf32 and K4-tf32):
        # the bf16 D 128 cases' twins and lm_parity's shape (B8 T32 H2)
        ("f32_d128_offsets_64_32", twin128[:4] + (128, f32), True, 64, 32,
         False),
        ("f32_d128_not_causal_tq100_tk230", (2, 100, 230, 2, 128, f32),
         False, 0, 0, False),
        ("f32_d128_fully_masked_kv_offset_1024", twin128[:4] + (128, f32),
         True, 0, 1024, False),
        ("f32_d128_lse_with_g_lse", (2, 64, 64, 2, 128, f32), True, 0, 0,
         True),
        ("f32_d128_lm_parity_b8_t32_h2", (8, 32, 32, 2, 128, f32), True, 0,
         0, False),
    ]
    for d in (16, 32):       # the D 128 cases' twins at the narrow widths
        cases += [
            (f"bf16_d{d}_offsets_64_32", twin[:4] + (d, bf16), True, 64, 32,
             False),
            (f"bf16_d{d}_not_causal_tq100_tk230", (2, 100, 230, 2, d, bf16),
             False, 0, 0, False),
            (f"bf16_d{d}_fully_masked_kv_offset_1024", twin[:4] + (d, bf16),
             True, 0, 1024, False),
            (f"bf16_d{d}_lse_with_g_lse", (2, 64, 64, 2, d, bf16), True, 0,
             0, True)]
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
        out2, lse2 = fa.flash_fwd(q, k, v, *args)
        before = dict(fa.launches)
        dq, dk, dv = fa.flash_bwd(q, k, v, out, dout, lse, glse, *args)
        bwd = {n: fa.launches[n] - before[n] for n in before
               if fa.launches[n] > before[n]}
        again = fa.flash_bwd(q, k, v, out, dout, lse, glse, *args)
        torch.cuda.synchronize()
        # bf16 takes K2', K3' and K4' at D 16, 32, 64 and 128, float32
        # K2-tf32, K3-tf32 and K4-tf32 there, each backward with one delta
        # pass
        fwd_kernel, bwd_kernels = fa.route(dtype, d)
        dq_kernel, dkv_kernel = bwd_kernels[:2]
        hopper = fwd_kernel == fa.FWD_SM90
        want_route = ([fwd_kernel], {n: 1 for n in bwd_kernels})
        if (fwd, bwd) != want_route:
            raise AssertionError(f"{name}: launched {fwd} and {bwd}, the "
                                 f"route wants {want_route}")
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        fwd_same = torch.equal(out, out2) and torch.equal(lse, lse2)
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, *args)
        want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse, glse, *args)
        want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse,
                                                  glse, *args)
        is_f32 = dtype == f32
        out_tol = (2e-5, 2e-5) if is_f32 else bf16_tol
        grad_tol = (5e-5, 5e-5) if is_f32 else bf16_tol
        # each kernel's entry on the `kernels` line: K2', K3' and K4' at
        # D 16, 32 and 128 and K2-tf32, K3-tf32 and K4-tf32 at each D
        # have entries of their own
        fwd_entry, dq_entry, dkv = fwd_kernel, dq_kernel, dkv_kernel
        if hopper and d in NARROW:
            fwd_entry, dkv, dq_entry = NARROW[d]
        elif hopper and d == 128:
            fwd_entry, dq_entry, dkv = FWD128, DQ128, DKV128
        elif fwd_kernel == fa.FWD_TF32:
            fwd_entry, dq_entry, dkv = TF32[d], DQ_TF32[d], DKV_TF32[d]
        checks = {
            fwd_entry: [over_tol(out, want_out, *out_tol),
                        over_tol(lse, want_lse, 2e-5, 2e-5)],
            dq_entry: [over_tol(dq, want_dq, *grad_tol)],
            dkv: [over_tol(dk, want_dk, *grad_tol),
                  over_tol(dv, want_dv, *grad_tol)],
        }
        if fa.BWD_DELTA_SM90 in bwd_kernels:
            delta = fa.flash_bwd_delta(out, dout, glse)
            checks[fa.BWD_DELTA_SM90] = [over_tol(
                delta, fa.flash_bwd_delta_plain(out, dout, glse), 2e-5, 2e-5)]
        entry = {"shape": [b, tq, tk, h, d], "dtype": str(dtype)[6:],
                 "causal": causal, "q_offset": q_off, "kv_offset": kv_off,
                 "g_lse": with_glse, "route": fwd + sorted(bwd),
                 "fwd_bit_identical_rerun": fwd_same,
                 "bwd_bit_identical_rerun": same}
        ok = same and fwd_same
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


def attn_times(dev, report, worst, smi):
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
    old_out, _ = fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD)
    old_dq = fa.launch_bwd_dq(q, k, v, out, dout, lse, None, True, 0, 0,
                              fa.BWD_DQ)
    old_dk, old_dv = fa.launch_bwd_dkv(q, k, v, out, dout, lse, None, True,
                                       0, 0, fa.BWD_DKV)
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
        fa.FWD_SM90: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD_SM90),
                      plain_fwd),
        fa.FWD: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD),
                 plain_fwd),
        fa.BWD_DQ_SM90: (lambda: fa.launch_dq_sm90(q, k, v, dout, lse, delta,
                                                   True, 0, 0), plain_dq),
        fa.BWD_DQ: (lambda: fa.launch_bwd_dq(q, k, v, out, dout, lse, None,
                                             True, 0, 0, fa.BWD_DQ),
                    plain_dq),
        fa.BWD_DKV_SM90: (lambda: fa.launch_dkv_sm90(q, k, v, dout, lse,
                                                     delta, True, 0, 0),
                          plain_dkv),
        fa.BWD_DELTA_SM90: (lambda: fa.flash_bwd_delta(out, dout),
                            lambda: fa.flash_bwd_delta_plain(out, dout)),
        fa.BWD_DKV: (lambda: fa.launch_bwd_dkv(q, k, v, out, dout, lse, None,
                                               True, 0, 0, fa.BWD_DKV),
                     plain_dkv),
    }
    lib_fwd, _, lib_fwd_dev, _ = sdpa_ms(q, k, v, dout)
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
            "library_device_ms": (None if kernel == fa.BWD_DELTA_SM90
                                  else lib_fwd_dev if fwd
                                  else bwd["sdpa_device_ms"]),
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
            lambda: launch(q, k, v, out, dout, lse, None, True, 0, 0,
                           kernel))
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
    for kernel in result:
        result[kernel]["timed_on"] = f"bfloat16 B{b} T{t} H{h} D{d} causal"
    served = {f"{str(dtype)[6:]}_d{dim}": served_times(dev, dtype, dim)
              for dtype, dim in ((torch.float32, 64), (torch.bfloat16, 16),
                                 (torch.bfloat16, 32), (torch.float32, 16),
                                 (torch.float32, 32), (torch.float32, 128))}
    d128, k4_d128, d128_fwd_dq = d128_times(dev, worst)
    narrow = {}
    for dim in NARROW:
        narrow.update(narrow_times(dev, worst, dim,
                                   served[f"bfloat16_d{dim}"]))
    tf32 = {TF32[dim]: tf32_times(dev, worst, dim, served[f"float32_d{dim}"])
            for dim in TF32}
    tf32_bwd = {dim: tf32_bwd_times(dev, worst, dim,
                                    served[f"float32_d{dim}"])
                for dim in TF32}
    emit("attn_kernel", card=smi, cases=report, timed_shape=[b, t, h, d],
         timed_dtype="bfloat16", kernels=result, whole_backward=bwd,
         faster=faster, served=served, d128=d128, k4_d128=k4_d128,
         narrow=narrow, tf32=tf32, tf32_backward=tf32_bwd)
    # K2-K4 report first float32 at D 128 (the yardstick beside K2-tf32,
    # K3-tf32 and K4-tf32: no route takes K2-K4 on the LMs' inputs); their
    # float32 and bf16 times at the other widths (the tensor-core kernels
    # take those) beside
    for kernel in (fa.FWD, fa.BWD_DQ, fa.BWD_DKV):
        on_bf16_d64 = result[kernel]
        result[kernel] = {
            **served["float32_d128"][kernel],
            "max_abs_err": worst[kernel][0],
            "err_over_tol": worst[kernel][1],
            "on_float32_d64": served["float32_d64"][kernel],
            "on_float32_d16": served["float32_d16"][kernel],
            "on_float32_d32": served["float32_d32"][kernel],
            "on_bfloat16_d16": served["bfloat16_d16"][kernel],
            "on_bfloat16_d32": served["bfloat16_d32"][kernel],
            "on_bfloat16_d64": {k: on_bf16_d64[k] for k in (
                "ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms")},
        }
    result[fa.BWD_DKV]["on_bfloat16_d128"] = k4_d128
    result[DKV128] = d128
    result.update(d128_fwd_dq)
    result.update(narrow)
    result.update(tf32)
    for dim, entries in tf32_bwd.items():
        result[fa.BWD_DELTA_SM90][f"on_float32_d{dim}"] = entries.pop(
            fa.BWD_DELTA_SM90)
        result.update(entries)
    # the max error of the delta pass over every input it took, bf16 and
    # float32
    result[fa.BWD_DELTA_SM90].update(
        max_abs_err=worst[fa.BWD_DELTA_SM90][0],
        err_over_tol=worst[fa.BWD_DELTA_SM90][1])
    return result


def tf32_times(dev, worst, d, served):
    """K2-tf32 at D `d` (float32 B8 T1024 H8, causal): held to its plain
    version (out and lse 2e-5) and to itself over two runs; its ms (CUDA
    events), device ms (profiler), plain ms and bound beside K2 through
    its launcher on the same inputs (held to the plain version too; its
    ms from `served`, `served_times`) and SDPA's memory-efficient forward
    (its ms and device ms from `served`)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h = LM_BATCH, LM_T, 8
    q, k, v, _, _ = attn_inputs(dev, b, t, t, h, d, torch.float32, 0)
    name = TF32[d]
    run_kernel = lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD_TF32)
    run_plain = lambda: fa.flash_fwd_plain(q, k, v)
    got, again = run_kernel(), run_kernel()
    old = fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{name} differs between two runs")
    want = run_plain()
    for kernel, outs in ((name, got), (fa.FWD, old)):
        results = [over_tol(g, w, 2e-5, 2e-5) for g, w in zip(outs, want)]
        err, ratio = max(r[0] for r in results), max(r[1] for r in results)
        if ratio > 1.0:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at float32 D {d} ({ratio})")
        worst[kernel] = [max(worst[kernel][0], err),
                         max(worst[kernel][1], ratio)]
    bound_ms, bound_by = attn_bound(b, t, h, d, 4, fa.FWD_TF32)
    symbol = f"{fa.FWD_TF32}_kernel"
    entry = {
        "timed_on": f"float32 B{b} T{t} H{h} D{d} causal",
        "max_abs_err": worst[name][0], "err_over_tol": worst[name][1],
        "ms": time_ms(run_kernel),
        "device_ms": device_ms(run_kernel, (symbol,))[symbol],
        "plain_ms": time_ms(run_plain, groups=5, per_group=3),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": served[fa.FWD]["library_ms"],
        "library_device_ms": served[fa.FWD]["library_device_ms"],
        "library": served[fa.FWD]["library"],
        "k2_ms": served[fa.FWD]["ms"],
        "k2_device_ms": device_ms(lambda: fa.launch_fwd(
            q, k, v, True, 0, 0, fa.FWD), ("flash_fwd_kernel",))[
                "flash_fwd_kernel"],
    }
    entry["faster"] = {
        "k2_tf32_under_k2": entry["ms"] < entry["k2_ms"],
        "k2_tf32_device_under_sdpa_device":
            isinstance(entry["device_ms"], float)
            and isinstance(entry["library_device_ms"], float)
            and entry["device_ms"] < entry["library_device_ms"]}
    return entry


def tf32_bwd_times(dev, worst, d, served):
    """K3-tf32 and K4-tf32 at D `d` (float32 B8 T1024 H8, causal): each
    held to its plain version (gradients 5e-5 with atol
    5e-5 of the largest value) and to itself over two runs; its ms (CUDA
    events, alone and with the delta pass), device ms (profiler), plain
    ms and bound beside K3 or K4 through its launcher on the same inputs
    (held to the plain version too; its ms from `served`,
    `served_times`, and its device ms) and SDPA's memory-efficient
    backward (dq, dk and dv in one call; its ms and device ms from
    `served`); the float32 delta pass held to its plain version (2e-5),
    its ms, device ms, plain ms and bound; at D 64 and 128 the whole
    backward (`flash_bwd`: the delta pass, K3-tf32 and K4-tf32) against
    SDPA's. Returns {entry name: its fields}, the delta pass's
    under BWD_DELTA_SM90."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h = LM_BATCH, LM_T, 8
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, torch.float32, 0)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_bwd_delta(out, dout)
    args = (True, 0, 0)
    # entry: (its launch, its plain version, its kernel, the CUDA-core
    # kernel it replaces here and that kernel's launch, the launcher that
    # runs the delta pass first)
    calls = {
        DQ_TF32[d]: (
            lambda: (fa.launch_dq_sm90(q, k, v, dout, lse, delta, *args,
                                       fa.BWD_DQ_TF32),),
            lambda: (fa.flash_bwd_dq_plain(q, k, v, out, dout, lse),),
            fa.BWD_DQ_TF32, fa.BWD_DQ,
            lambda: (fa.launch_bwd_dq(q, k, v, out, dout, lse, None, *args,
                                      fa.BWD_DQ),),
            fa.launch_bwd_dq),
        DKV_TF32[d]: (
            lambda: fa.launch_dkv_sm90(q, k, v, dout, lse, delta, *args,
                                       fa.BWD_DKV_TF32),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse),
            fa.BWD_DKV_TF32, fa.BWD_DKV,
            lambda: fa.launch_bwd_dkv(q, k, v, out, dout, lse, None, *args,
                                      fa.BWD_DKV),
            fa.launch_bwd_dkv)}
    result = {}
    for name, (run_kernel, run_plain, kernel, old, run_old,
               launch) in calls.items():
        got, again, was = run_kernel(), run_kernel(), run_old()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name} differs between two runs")
        want = run_plain()
        for entry_name, outs in ((name, got), (old, was)):
            results = [over_tol(g, w, 5e-5, 5e-5) for g, w in zip(outs, want)]
            err, ratio = max(r[0] for r in results), max(r[1] for r in results)
            if ratio > 1.0:
                raise AssertionError(f"{entry_name} disagrees with its plain "
                                     f"version at float32 D {d} ({ratio})")
            worst[entry_name] = [max(worst[entry_name][0], err),
                                 max(worst[entry_name][1], ratio)]
        was_key = {fa.BWD_DQ: "k3", fa.BWD_DKV: "k4"}[old]
        bound_ms, bound_by = attn_bound(b, t, h, d, 4, kernel)
        symbol, old_symbol = f"{kernel}_kernel", f"{old}_kernel"
        entry = result[name] = {
            "timed_on": f"float32 B{b} T{t} H{h} D{d} causal",
            "max_abs_err": worst[name][0], "err_over_tol": worst[name][1],
            "ms": time_ms(run_kernel),
            "device_ms": device_ms(run_kernel, (symbol,))[symbol],
            "ms_with_delta_pass": time_ms(lambda: launch(
                q, k, v, out, dout, lse, None, *args, kernel)),
            "plain_ms": time_ms(run_plain, groups=5, per_group=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": served[old]["library_ms"],
            "library_device_ms": served[old]["library_device_ms"],
            "library": served[old]["library"],
            f"{was_key}_ms": served[old]["ms"],
            f"{was_key}_device_ms": device_ms(run_old, (old_symbol,))[
                old_symbol],
        }
        entry["faster"] = {
            f"{was_key}_tf32_under_{was_key}": entry["ms"] < entry[
                f"{was_key}_ms"],
            f"{was_key}_tf32_device_under_sdpa_device":
                isinstance(entry["device_ms"], float)
                and isinstance(entry["library_device_ms"], float)
                and entry["device_ms"] < entry["library_device_ms"]}
    run_delta = lambda: fa.flash_bwd_delta(out, dout)
    run_plain = lambda: fa.flash_bwd_delta_plain(out, dout)
    err, ratio = over_tol(run_delta(), run_plain(), 2e-5, 2e-5)
    if ratio > 1.0:
        raise AssertionError(f"the float32 delta pass disagrees with its "
                             f"plain version at D {d} ({ratio})")
    worst[fa.BWD_DELTA_SM90] = [max(worst[fa.BWD_DELTA_SM90][0], err),
                                max(worst[fa.BWD_DELTA_SM90][1], ratio)]
    bound_ms, bound_by = attn_bound(b, t, h, d, 4, fa.BWD_DELTA_SM90)
    symbol = f"{fa.BWD_DELTA_SM90}_kernel"
    result[fa.BWD_DELTA_SM90] = {
        "timed_on": f"float32 B{b} T{t} H{h} D{d}", "max_abs_err": err,
        "err_over_tol": ratio, "ms": time_ms(run_delta),
        "device_ms": device_ms(run_delta, (symbol,))[symbol],
        "plain_ms": time_ms(run_plain, groups=5, per_group=3),
        "bound_ms": bound_ms, "bound_by": bound_by}
    if d in (64, 128):  # the float32 LMs' widths: the whole backward
        result[DKV_TF32[d]]["whole_backward"] = whole_backward(
            q, k, v, out, dout, lse)
    return result


def narrow_times(dev, worst, d, served):
    """K2', K4' and K3' at D `d` (16 or 32; bf16 B8 T1024 H8, causal): each
    held to its plain version and to itself over two runs; its ms (CUDA
    events; K3' and K4' also with the delta pass), device ms (profiler),
    plain ms and bound beside K2, K4 or K3 through its launcher on the same
    inputs (`served`, from `served_times`; K3 also held to the plain
    version here) and SDPA's device time (flash); and the whole backward
    (the delta pass, K3' and K4') against SDPA's in turns. Returns {entry
    name: its fields}."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h = LM_BATCH, LM_T, 8
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, torch.bfloat16, 0)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_bwd_delta(out, dout)
    fwd_name, dkv_name, dq_name = NARROW[d]
    plain_dq = lambda: fa.flash_bwd_dq_plain(q, k, v, out, dout, lse)
    # entry: (its launch, its plain version, its kernel, the CUDA-core
    # kernel it replaces here)
    calls = {
        fwd_name: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD_SM90),
                   lambda: fa.flash_fwd_plain(q, k, v), fa.FWD_SM90,
                   fa.FWD),
        dkv_name: (lambda: fa.launch_dkv_sm90(q, k, v, dout, lse, delta,
                                              True, 0, 0),
                   lambda: fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse),
                   fa.BWD_DKV_SM90, fa.BWD_DKV),
        dq_name: (lambda: (fa.launch_dq_sm90(q, k, v, dout, lse, delta,
                                             True, 0, 0),),
                  lambda: (plain_dq(),), fa.BWD_DQ_SM90, fa.BWD_DQ),
    }
    # K3, which K3' replaces here, on the same inputs
    old_dq = fa.launch_bwd_dq(q, k, v, out, dout, lse, None, True, 0, 0,
                              fa.BWD_DQ)
    err, ratio = over_tol(old_dq, plain_dq(), *KERNEL_TOL)
    if ratio > 1.0:
        raise AssertionError(f"{fa.BWD_DQ} disagrees with its plain version "
                             f"at bf16 D {d} ({ratio})")
    worst[fa.BWD_DQ] = [max(worst[fa.BWD_DQ][0], err),
                        max(worst[fa.BWD_DQ][1], ratio)]
    bwd = whole_backward(q, k, v, out, dout, lse)
    result = {}
    for name, (run_kernel, run_plain, kernel, old) in calls.items():
        got, again = run_kernel(), run_kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name} differs between two runs")
        want = run_plain()
        results = [over_tol(g, w, *KERNEL_TOL) for g, w in zip(got, want)]
        if name == fwd_name:            # lse: float32 on both sides
            results[1] = over_tol(got[1], want[1], 2e-5, 2e-5)
        err, ratio = max(r[0] for r in results), max(r[1] for r in results)
        if ratio > 1.0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at bf16 D {d} ({ratio})")
        worst[name] = [max(worst[name][0], err), max(worst[name][1], ratio)]
        fwd = name == fwd_name
        # the CUDA-core kernel it replaces
        was = {fa.FWD: "k2", fa.BWD_DKV: "k4", fa.BWD_DQ: "k3"}[old]
        bound_ms, bound_by = attn_bound(b, t, h, d, 2, kernel)
        symbol = f"{kernel}_kernel"
        entry = result[name] = {
            "timed_on": f"bfloat16 B{b} T{t} H{h} D{d} causal",
            "max_abs_err": worst[name][0], "err_over_tol": worst[name][1],
            "ms": time_ms(run_kernel),
            "device_ms": device_ms(run_kernel, (symbol,))[symbol],
            "plain_ms": time_ms(run_plain, groups=5, per_group=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": served[old]["library_ms"] if fwd
            else bwd["sdpa_ms"],
            "library_device_ms": served[old]["library_device_ms"] if fwd
            else bwd["sdpa_device_ms"],
            "library": served[old]["library"],
            f"{was}_ms": served[old]["ms"],
        }
        entry["faster"] = {f"{was}_prime_under_{was}":
                           entry["ms"] < served[old]["ms"]}
        if not fwd:
            launch = fa.launch_bwd_dq if old == fa.BWD_DQ else \
                fa.launch_bwd_dkv
            entry["ms_with_delta_pass"] = time_ms(lambda: launch(
                q, k, v, out, dout, lse, None, True, 0, 0, kernel))
            entry["whole_backward"] = bwd
            entry["faster"]["whole_backward_under_sdpa"] = \
                bwd["ms"] < bwd["sdpa_ms"]
    return result


def served_times(dev, dtype, d):
    """K2, K3 and K4 at B8 T1024 H8 `d` causal in `dtype`, through their
    launchers whichever kernels `route` gives these inputs (the callers
    that compare a Hopper kernel with K2-K4 hold them to their plain
    versions): each one's ms, its plain version's, the bound and SDPA's
    forward or backward on the same inputs."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h = LM_BATCH, LM_T, 8
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, dtype, 0)
    out, lse = fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD)
    calls = {   # kernel: (its launch, its plain version)
        fa.FWD: (lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD),
                 lambda: fa.flash_fwd_plain(q, k, v)),
        fa.BWD_DQ: (lambda: fa.launch_bwd_dq(q, k, v, out, dout, lse, None,
                                             True, 0, 0, fa.BWD_DQ),
                    lambda: fa.flash_bwd_dq_plain(q, k, v, out, dout, lse)),
        fa.BWD_DKV: (lambda: fa.launch_bwd_dkv(q, k, v, out, dout, lse, None,
                                               True, 0, 0, fa.BWD_DKV),
                     lambda: fa.flash_bwd_dkv_plain(q, k, v, out, dout,
                                                    lse)),
    }
    lib_fwd, lib_bwd, lib_fwd_dev, lib_bwd_dev = sdpa_ms(q, k, v, dout)
    backend = sdpa_backend(dtype)[1]
    result = {}
    for kernel, (run_kernel, run_plain) in calls.items():
        bound_ms, bound_by = attn_bound(b, t, h, d, q.element_size(), kernel)
        fwd = kernel == fa.FWD
        result[kernel] = {
            "timed_on": f"{str(dtype)[6:]} B{b} T{t} H{h} D{d} causal",
            "ms": time_ms(run_kernel),
            "plain_ms": time_ms(run_plain, groups=5, per_group=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd if fwd else lib_bwd,
            "library_device_ms": lib_fwd_dev if fwd else lib_bwd_dev,
            "library": (f"scaled_dot_product_attention forward, {backend} "
                        "backend" if fwd else
                        "scaled_dot_product_attention backward (dq, dk and "
                        f"dv in one call), {backend} backend"),
        }
    return result


def d128_times(dev, worst):
    """K4' at D 128 (bf16 B8 T1024 H8, causal): held to its plain version
    and to itself over two runs, its ms (CUDA events, alone and with the
    delta pass), device ms (profiler), plain ms and bound beside SDPA's
    backward (flash) on the same inputs, and the whole backward against
    SDPA's in turns; K4 on the same inputs through its launcher, held to
    the plain version too; and K2' and K3' on the same inputs the same
    way (K3' also with the delta pass) beside SDPA's flash forward and
    whole backward. Returns (K4''s entry, K4's, {K2''s and K3''s entry
    names: their fields})."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h, d = LM_BATCH, LM_T, 8, 128
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, torch.bfloat16, 0)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_bwd_delta(out, dout)
    new = lambda: fa.launch_dkv_sm90(q, k, v, dout, lse, delta, True, 0, 0)
    old = lambda: fa.launch_bwd_dkv(q, k, v, out, dout, lse, None, True, 0,
                                    0, fa.BWD_DKV)
    plain = lambda: fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse)
    (dk, dv), (dk2, dv2), (old_dk, old_dv) = new(), new(), old()
    torch.cuda.synchronize()
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError("K4' at D 128 differs between two runs")
    want_dk, want_dv = plain()
    errs = {}
    for kernel, (gk, gv) in ((DKV128, (dk, dv)), (fa.BWD_DKV,
                                                  (old_dk, old_dv))):
        results = [over_tol(gk, want_dk, *KERNEL_TOL),
                   over_tol(gv, want_dv, *KERNEL_TOL)]
        err, ratio = max(r[0] for r in results), max(r[1] for r in results)
        if ratio > 1.0:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at bf16 D 128 ({ratio})")
        errs[kernel] = (err, ratio)
    worst[DKV128] = [max(worst[DKV128][0], errs[DKV128][0]),
                     max(worst[DKV128][1], errs[DKV128][1])]
    bwd = whole_backward(q, k, v, out, dout, lse)
    bound_ms, bound_by = attn_bound(b, t, h, d, 2, fa.BWD_DKV_SM90)
    k4_bound_ms, k4_bound_by = attn_bound(b, t, h, d, 2, fa.BWD_DKV)
    symbol = f"{fa.BWD_DKV_SM90}_kernel"
    entry = {
        "timed_on": f"bfloat16 B{b} T{t} H{h} D{d} causal",
        "max_abs_err": worst[DKV128][0], "err_over_tol": worst[DKV128][1],
        "ms": time_ms(new),
        "device_ms": device_ms(new, (symbol,))[symbol],
        "ms_with_delta_pass": time_ms(lambda: fa.launch_bwd_dkv(
            q, k, v, out, dout, lse, None, True, 0, 0, fa.BWD_DKV_SM90)),
        "plain_ms": time_ms(plain, groups=5, per_group=3),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": bwd["sdpa_ms"],
        "library_device_ms": bwd["sdpa_device_ms"],
        "library": "scaled_dot_product_attention backward (dq, dk and dv "
                   f"in one call), {bwd['sdpa_backend']} backend",
        "whole_backward": bwd,
    }
    k4 = {"timed_on": entry["timed_on"], "max_abs_err": errs[fa.BWD_DKV][0],
          "err_over_tol": errs[fa.BWD_DKV][1], "ms": time_ms(old),
          "bound_ms": k4_bound_ms, "bound_by": k4_bound_by,
          "library_ms": bwd["sdpa_ms"],
          "library_device_ms": bwd["sdpa_device_ms"],
          "library": entry["library"]}
    entry["faster"] = {
        "k4_prime_under_k4": entry["ms"] < k4["ms"],
        "k4_prime_with_delta_under_k4": entry["ms_with_delta_pass"]
        < k4["ms"],
        "whole_backward_under_sdpa": bwd["ms"] < bwd["sdpa_ms"]}
    lib_fwd, _, lib_fwd_dev, _ = sdpa_ms(q, k, v, dout)
    fwd_dq = {}
    for name, kernel, run_kernel, run_plain in (
            (FWD128, fa.FWD_SM90,
             lambda: fa.launch_fwd(q, k, v, True, 0, 0, fa.FWD_SM90),
             lambda: fa.flash_fwd_plain(q, k, v)),
            (DQ128, fa.BWD_DQ_SM90,
             lambda: (fa.launch_dq_sm90(q, k, v, dout, lse, delta, True, 0,
                                        0),),
             lambda: (fa.flash_bwd_dq_plain(q, k, v, out, dout, lse),))):
        got, again = run_kernel(), run_kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name} differs between two runs")
        want = run_plain()
        results = [over_tol(g, w, *KERNEL_TOL) for g, w in zip(got, want)]
        fwd = name == FWD128
        if fwd:                         # lse: float32 on both sides
            results[1] = over_tol(got[1], want[1], 2e-5, 2e-5)
        err, ratio = max(r[0] for r in results), max(r[1] for r in results)
        if ratio > 1.0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at bf16 D 128 ({ratio})")
        worst[name] = [max(worst[name][0], err), max(worst[name][1], ratio)]
        bound_ms, bound_by = attn_bound(b, t, h, d, 2, kernel)
        symbol = f"{kernel}_kernel"
        fwd_dq[name] = {
            "timed_on": entry["timed_on"],
            "max_abs_err": worst[name][0], "err_over_tol": worst[name][1],
            "ms": time_ms(run_kernel),
            "device_ms": device_ms(run_kernel, (symbol,))[symbol],
            "plain_ms": time_ms(run_plain, groups=5, per_group=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd if fwd else bwd["sdpa_ms"],
            "library_device_ms": lib_fwd_dev if fwd
            else bwd["sdpa_device_ms"],
            "library": "scaled_dot_product_attention forward, flash backend"
            if fwd else entry["library"],
        }
        if not fwd:
            fwd_dq[name]["ms_with_delta_pass"] = time_ms(
                lambda: fa.launch_bwd_dq(q, k, v, out, dout, lse, None, True,
                                         0, 0, fa.BWD_DQ_SM90))
    return entry, k4, fwd_dq


def sdpa_backend(dtype):
    """The backend SDPA is pinned to as the yardstick, by dtype, and its
    name: flash for bf16, memory-efficient for float32 (flash takes no
    float32)."""
    from torch.nn.attention import SDPBackend

    if dtype == torch.float32:
        return SDPBackend.EFFICIENT_ATTENTION, "memory-efficient"
    return SDPBackend.FLASH_ATTENTION, "flash"


def whole_backward(q, k, v, out, dout, lse, rounds=7):
    """The port's whole backward (`flash_bwd`, the kernels `route` names:
    the delta pass, then K3' and K4' or K3-tf32 and K4-tf32) against
    SDPA's backward (`sdpa_backend`, the same dq, dk and
    dv; the port never calls it) on the same inputs, alternating the two over
    `rounds` rounds: each one's median and spread (ms), its device time
    from the profiler, and the bound of the whole backward."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from torch.nn.attention import sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    b, t, h, d = q.shape
    ours = lambda: fa.flash_bwd(q, k, v, out, dout, lse)
    qg, kg, vg = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    backend, backend_name = sdpa_backend(q.dtype)
    with sdpa_kernel(backend):
        o = sdpa(qg, kg, vg, is_causal=True)
        theirs = lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                             retain_graph=True)
        times = {"ours": [], "sdpa": []}
        for _ in range(rounds):
            for name, fn in (("ours", ours), ("sdpa", theirs),
                             ("sdpa", theirs), ("ours", ours)):
                times[name].append(time_ms(fn, groups=5))
        # the autograd call is host-bound on a shared host (on an H100 at
        # B8 T1024 H8 D64 its events read 0.18 to 0.60 ms within one run);
        # its device time is not
        sdpa_dev = device_ms(theirs, ("",))[""]
    ours_dev = device_ms(ours, tuple(f"{n}_kernel"
                                     for n in fa.route(q.dtype, d)[1]))
    bound_ms, bound_by = attn_bound(b, t, h, d, q.element_size(),
                                    "flash_bwd")
    return {
        "ms": statistics.median(times["ours"]),
        "ms_spread": [min(times["ours"]), max(times["ours"])],
        "sdpa_ms": statistics.median(times["sdpa"]),
        "sdpa_ms_spread": [min(times["sdpa"]), max(times["sdpa"])],
        "sdpa_backend": backend_name, "sdpa_device_ms": sdpa_dev,
        "rounds": rounds, "device_ms": ours_dev,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def sdpa_ms(q, k, v, dout):
    """(forward ms, backward ms, forward device ms, backward device ms) of
    scaled_dot_product_attention (causal, `sdpa_backend`) on the same
    inputs, in its (B, H, T, D) layout: the library yardstick; the
    backward computes dq, dk and dv in one call. The port never calls
    it."""
    from torch.nn.attention import sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    with sdpa_kernel(sdpa_backend(q.dtype)[0]):
        run_fwd = lambda: sdpa(qt, kt, vt, is_causal=True)
        o = run_fwd()
        run_bwd = lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                              retain_graph=True)
        return (time_ms(run_fwd), time_ms(run_bwd),
                device_ms(run_fwd, ("",))[""], device_ms(run_bwd, ("",))[""])


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
    """The small float32 LM on the card against the CPU at each head dim
    of LM_PARITY; returns {D: the flash kernels' launches in its card
    step} (K2-tf32, K3-tf32, K4-tf32 and the delta pass at each D)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.trainer import Trainer

    r = np.random.RandomState(21)
    toks = r.randint(0, 64, (8, 33)).astype(np.int32)
    mask = np.ones((8,), np.float32)
    mask[[2, 5]] = 0.0
    batch = {"features": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    layers = 2                          # LM_PARITY's num_layers
    report, by_dim = {}, {}
    for d, params in LM_PARITY.items():
        results, weights = [], None
        for dev in ("cpu", "cuda"):
            tr = Trainer(load_spec(params, "float32", LM_DEF), device=dev)
            state = tr.init_state(batch)
            if weights is None:
                weights = {n: t.detach().clone()
                           for n, t in tr.model.state_dict().items()}
            tr.model.load_state_dict(weights)
            reset_launches()
            loss, grads = tr.compute_grads(state, batch)
            results.append((float(loss),
                            {n: g.cpu() for n, g in grads.items()}))
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        fwd, bwd = fa.route(torch.float32, d)
        if launches != {**{n: 0 for n in launches}, fwd: layers,
                        **{n: layers for n in bwd}}:
            raise AssertionError(f"flash launches in the float32 LM's step "
                                 f"at D {d}: {launches}")
        (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
        largest = max(float(g.abs().max()) for g in cpu_grads.values())
        worst = 0.0
        for name, want in cpu_grads.items():
            got = gpu_grads[name]
            if name.endswith(".k.bias"):       # 0 in exact arithmetic
                if max(float(got.abs().max()), float(want.abs().max())) \
                        > 1e-6 * largest:
                    raise AssertionError(f"{name} is not ~0 on both devices "
                                         f"at D {d}")
                continue
            _, ratio = over_tol(got, want, 5e-5, 5e-5)
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise AssertionError(f"gradient of {name} differs between "
                                     f"cuda and cpu at D {d} ({ratio} of "
                                     f"its tolerance)")
        if abs(gpu_loss - cpu_loss) > 5e-5 * abs(cpu_loss):
            raise AssertionError(f"LM loss {gpu_loss} on cuda vs {cpu_loss} "
                                 f"on cpu at D {d}")
        report[f"d{d}"] = dict(
            params=params, loss_cuda=gpu_loss, loss_cpu=cpu_loss,
            params_count=len(cpu_grads), worst_grad_err_over_tol=worst,
            launches={n: c for n, c in launches.items() if c})
        by_dim[d] = launches
    emit("lm_parity", **report)
    return by_dim


def phase_lm_train(smi):
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
         step_mode=step_mode(trainer),
         compute_dtype="bfloat16", steps=STEPS, losses=losses,
         step_ms=step_ms, host_step_ms=host_s * 1e3 / (STEPS - 1),
         tokens_per_s=LM_BATCH * LM_T / (step_ms / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches={"train": train, "eval": evaluate, "predict": predict},
         eval=trainer.metric_results(metric_states),
         predict_shape=list(preds.shape))
    step_cost("lm", trainer, state, batch, step_ms,
              lambda: load_spec(LM_PARAMS, model_def=LM_DEF), smi,
              batch_size=[LM_BATCH, LM_T])
    phase_profile(trainer, state, batch, step_ms)
    return {name: train[name] + evaluate[name] + predict[name]
            for name in train}


# ---------------------------------------------------------------- seq


RING_BLOCKS = 4
# a schedule's output and gradients (rtol, atol of max, atol of rms),
# against unsplit attention and against itself with the plain versions,
# from where each side rounds to bf16 (2**-9 relative, half an ulp) or
# differs by the kernels' own bf16 tolerance (one ulp) a call:
# - out: the n partials, each rounded by K2', merge in float32 with
#   weights summing to 1, then round once: at most 2**-9 x (max|partial|
#   + 2 max|out|) <= 3 x 2**-9 x max|out|, or 2**-7 x max|out| for
#   partials one ulp apart;
# - a gradient of k or v (or of q, over the n kv blocks) is the bf16 sum
#   of n bf16 partials: n roundings of the partials and n - 1 of the sum,
#   and the unsplit call's one, at most 2n x 2**-9 x max = 2**-6 x max
#   for n = 4 (partials no larger than the whole gradient's largest).
# Each kernel call itself is held to `phase_attn_kernel`'s bf16
# tolerance against its plain version on the same inputs (KERNEL_TOL).
RING_OUT_TOL = (2 ** -8, 2 ** -7, 0.0)
RING_GRAD_TOL = (2 ** -8, 2 ** -6, 0.0)
KERNEL_TOL = (2 ** -7, 0.0, 1e-2)


class plain_flash:
    """Within it, `_FlashAttention` runs the flash kernels' plain versions
    on the card (the same inputs, no launch), so a schedule built on it
    can be held against itself with the kernels."""

    def __enter__(self):
        from elasticdl_tpu_torch.ops import flash_attention as fa

        self.saved = fa.flash_fwd, fa.flash_bwd
        fa.flash_fwd = fa.flash_fwd_plain

        def bwd(q, k, v, out, dout, lse, g_lse=None, causal=True,
                q_offset=0, kv_offset=0):
            args = (q, k, v, out, dout, lse, g_lse, causal, q_offset,
                    kv_offset)
            return (fa.flash_bwd_dq_plain(*args),
                    *fa.flash_bwd_dkv_plain(*args))

        fa.flash_bwd = bwd
        return self

    def __exit__(self, *exc):
        from elasticdl_tpu_torch.ops import flash_attention as fa

        fa.flash_fwd, fa.flash_bwd = self.saved


class recorded_flash:
    """Within it, every forward and backward that `_FlashAttention` runs
    is recorded with its inputs and results (`fwd`, `bwd`: lists of
    (args, results)), so each launch can be held against its plain
    version on the same inputs."""

    def __enter__(self):
        from elasticdl_tpu_torch.ops import flash_attention as fa

        self.saved = fa.flash_fwd, fa.flash_bwd
        self.fwd, self.bwd = [], []
        real_fwd, real_bwd = self.saved

        def fwd(*args):
            out = real_fwd(*args)
            self.fwd.append((args, out))
            return out

        def bwd(*args):
            out = real_bwd(*args)
            self.bwd.append((args, out))
            return out

        fa.flash_fwd, fa.flash_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        from elasticdl_tpu_torch.ops import flash_attention as fa

        fa.flash_fwd, fa.flash_bwd = self.saved


@torch.no_grad()
def per_call_checks(rec):
    """Each recorded launch against its plain version on the same inputs
    (KERNEL_TOL; lse 2e-5): {kernel: [max abs error, share of tolerance]},
    the (q_offset, kv_offset) pairs, the wholly masked calls (out 0, lse
    NEG_BIG, gradients 0: R1) and the backward calls with a nonzero lse
    cotangent."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    worst = {}

    def note(kernel, results):
        err = max(r[0] for r in results)
        ratio = max(r[1] for r in results)
        old = worst.get(kernel, [0.0, 0.0])
        worst[kernel] = [max(old[0], err), max(old[1], ratio)]

    offsets, masked, live = set(), 0, 0
    for (q, k, v, causal, q_off, kv_off), (out, lse) in rec.fwd:
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, causal, q_off,
                                                kv_off)
        note(fa.FWD_SM90, [over_tol(out, want_out, *KERNEL_TOL),
                           over_tol(lse, want_lse, 2e-5, 2e-5)])
        offsets.add((q_off, kv_off))
        if causal and kv_off >= q_off + q.shape[1]:
            masked += 1
            if not (bool((out == 0).all()) and bool((lse <= -1e29).all())):
                raise AssertionError(f"a wholly masked block ({q_off}, "
                                     f"{kv_off}) is not 0 with lse NEG_BIG")
    for args, (dq, dk, dv) in rec.bwd:
        q, k, v, out, dout, lse, g_lse, causal, q_off, kv_off = args
        want_dq = fa.flash_bwd_dq_plain(*args)
        want_dk, want_dv = fa.flash_bwd_dkv_plain(*args)
        note(fa.BWD_DQ_SM90, [over_tol(dq, want_dq, *KERNEL_TOL)])
        note(fa.BWD_DKV_SM90, [over_tol(dk, want_dk, *KERNEL_TOL),
                               over_tol(dv, want_dv, *KERNEL_TOL)])
        note(fa.BWD_DELTA_SM90, [over_tol(
            fa.flash_bwd_delta(out, dout, g_lse),
            fa.flash_bwd_delta_plain(out, dout, g_lse), 2e-5, 2e-5)])
        live += int(g_lse is not None and bool((g_lse != 0).any()))
        if causal and kv_off >= q_off + q.shape[1]:
            if not all(bool((x == 0).all()) for x in (dq, dk, dv)):
                raise AssertionError("a wholly masked block's gradients "
                                     "are not 0")
    return {"kernels": worst, "offsets": sorted(offsets),
            "wholly_masked_calls": masked, "bwd_calls_with_live_g_lse": live}


def ulysses_local(q, k, v, n, causal=True):
    """Ulysses over n virtual ranks in this process: after its all-to-all,
    virtual rank r holds the whole sequence for heads [r H/n, (r+1) H/n),
    so each runs `full_attention` over those heads, and the second
    all-to-all joins the results along H."""
    from elasticdl_tpu_torch.ops import attention

    per = q.shape[2] // n
    return torch.cat([attention.full_attention(
        q[:, :, r * per:(r + 1) * per], k[:, :, r * per:(r + 1) * per],
        v[:, :, r * per:(r + 1) * per], causal=causal)
        for r in range(n)], dim=2)


def attn_fwd_bwd(fn, q, k, v, dout):
    """(out, (dq, dk, dv)) of `fn(q, k, v)` with the cotangent `dout`."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dout)


def schedule_checks(name, fn, q, k, v, dout, want_fwd, want_bwd):
    """One schedule (`fn(q, k, v)`, causal) on the card: its launches in
    the forward and in the backward, held to `want_fwd` and `want_bwd`;
    each launch against its plain version on the same inputs
    (`per_call_checks`); its output and gradients against the same
    schedule with the plain versions and against unsplit
    `full_attention` (RING_OUT_TOL, RING_GRAD_TOL); and its fwd + bwd ms
    beside the unsplit call's, with CUDA events."""
    from elasticdl_tpu_torch.ops import attention
    from elasticdl_tpu_torch.ops import flash_attention as fa

    reset_launches()
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    with recorded_flash() as rec:
        out = fn(*leaves)
        torch.cuda.synchronize()
        fwd = {n: c for n, c in fa.launches.items() if c}
        reset_launches()
        grads = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        bwd = {n: c for n, c in fa.launches.items() if c}
    if (fwd, bwd) != (want_fwd, want_bwd):
        raise AssertionError(f"{name}: launched {fwd} forward and {bwd} "
                             f"backward, want {want_fwd} and {want_bwd}")
    calls = per_call_checks(rec)
    del rec
    got = [out.detach()] + list(grads)
    with plain_flash():
        p_out, p_grads = attn_fwd_bwd(fn, q, k, v, dout)
    u_out, u_grads = attn_fwd_bwd(attention.full_attention, q, k, v, dout)
    names = ("out", "dq", "dk", "dv")

    def against(want):
        return {n: over_tol(g, w, *(RING_OUT_TOL if n == "out"
                                    else RING_GRAD_TOL))
                for n, g, w in zip(names, got, want)}

    against_plain = against([p_out] + list(p_grads))
    against_unsplit = against([u_out] + list(u_grads))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    worst = max(r[1] for r in (*against_plain.values(),
                               *against_unsplit.values(),
                               *calls["kernels"].values()))
    if not finite or worst > 1.0:
        emit(name, per_call=calls, against_plain=against_plain,
             against_unsplit=against_unsplit, finite=finite)
        raise AssertionError(f"{name} disagrees ({worst} of a tolerance)")
    ms = time_ms(lambda: attn_fwd_bwd(fn, q, k, v, dout), groups=7,
                 per_group=3, warmup=1)
    unsplit_ms = time_ms(lambda: attn_fwd_bwd(attention.full_attention, q,
                                              k, v, dout),
                         groups=7, per_group=3, warmup=1)
    return {"launches_fwd": fwd, "launches_bwd": bwd, "per_call": calls,
            "against_plain": against_plain,
            "against_unsplit": against_unsplit,
            "fwd_bwd_ms": ms, "unsplit_fwd_bwd_ms": unsplit_ms}


def phase_ring_attn(dev, smi):
    """The ring schedule of `ops/attention.py` in one process at the LM's
    attention width (B 8, T 1024, H 8, D 64, bf16, causal) over
    RING_BLOCKS virtual ranks of 256 columns (`ring_attention_local`: the
    rotation hands each virtual rank the blocks it would receive), and
    Ulysses over as many (`ulysses_local`: 2 heads each over the whole
    sequence), forward and backward with a random cotangent. The
    ring launches K2' once a (q block, kv block) pair, the wholly masked
    pairs included (n x n), and K3', K4' and the delta pass as often in
    the backward, at nonzero offsets and with the merge's live lse
    cotangent; Ulysses once a virtual rank each. Returns the Hopper
    kernels' launches."""
    from elasticdl_tpu_torch.ops import attention
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h, d, n = LM_BATCH, LM_T, 8, 64, RING_BLOCKS
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, torch.bfloat16, 41)
    pairs, bwd = n * n, (fa.BWD_DQ_SM90, fa.BWD_DKV_SM90, fa.BWD_DELTA_SM90)
    ring = schedule_checks(
        "ring_attn", lambda q, k, v: attention.ring_attention_local(
            q, k, v, n, causal=True), q, k, v, dout,
        {fa.FWD_SM90: pairs}, {name: pairs for name in bwd})
    ulysses = schedule_checks(
        "ring_attn", lambda q, k, v: ulysses_local(q, k, v, n), q, k, v,
        dout,
        {fa.FWD_SM90: n}, {name: n for name in bwd})
    emit("ring_attn", card=smi, shape=[b, t, h, d], dtype="bfloat16",
         causal=True, blocks=n, block_len=t // n,
         tolerance={"per_call": list(KERNEL_TOL),
                    "out": list(RING_OUT_TOL),
                    "grads": list(RING_GRAD_TOL),
                    "form": "rtol, atol of max, atol of rms"},
         ring=ring, ulysses=ulysses)
    launches = {name: 0 for name in fa.launches}
    for run in (ring, ulysses):
        for counts in (run["launches_fwd"], run["launches_bwd"]):
            for name, c in counts.items():
                launches[name] += c
    return launches


SEQ_STEPS = 3


def seq_lm_steps(mesh=None, attention=None):
    """SEQ_STEPS train steps of the LM at `lm_train`'s width from seed 5,
    on `mesh`, with each block's attention replaced by `attention(q, k,
    v, causal)` where given: (losses, params, the flash launches, host
    ms a step past the first)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.trainer import Trainer

    batches = [lm_batch(300 + i) for i in range(SEQ_STEPS)]
    tr = Trainer(load_spec(LM_PARAMS, model_def=LM_DEF), seed=5, mesh=mesh)
    lm = sys.modules[type(tr.model).__module__]
    real = lm.sequence_parallel_attention
    if attention is not None:
        lm.sequence_parallel_attention = (
            lambda q, k, v, causal=True, **_: attention(q, k, v, causal))
    try:
        state = tr.init_state(None)
        reset_launches()
        losses, times = [], []
        for bt in batches:
            t0 = time.perf_counter()
            losses.append(tr.train_step(state, bt)[1]["loss"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.mean(times[1:])      # past the first step
    finally:
        lm.sequence_parallel_attention = real
    return ([float(x) for x in losses], {
        k: p.detach().clone() for k, p in state.params.items()},
        dict(fa.launches), ms)


def ring_lm_checks(name, losses, launches, plain_losses, pairs):
    """A ring LM's steps: finite and falling, the first loss within rel
    1e-2 of the unsplit step's, and K2', K3', K4' and the delta pass
    launched `pairs` times a layer and step."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    want = {k: 0 for k in fa.launches}
    for k in (fa.FWD_SM90, fa.BWD_DQ_SM90, fa.BWD_DKV_SM90,
              fa.BWD_DELTA_SM90):
        want[k] = pairs * LM_LAYERS * SEQ_STEPS
    if (launches != want or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]
            or abs(losses[0] - plain_losses[0])
            > 1e-2 * abs(plain_losses[0])):
        raise AssertionError(f"{name}: losses {losses} against "
                             f"{plain_losses}, launches {launches}")
    return abs(losses[0] - plain_losses[0]) / abs(plain_losses[0])


def phase_seq_train(smi):
    """The LM at `lm_train`'s width on a `seq` mesh of one card: a
    one-rank NCCL world (as `cohort_job`'s member forms it) with the mesh
    {data 1, seq 1}, 3 train steps, which must equal the same 3 steps with
    no mesh bit for bit (losses and parameters: the reference's fallback
    at a seq size of 1), with K2', K3', K4' and the delta pass launched
    as in `lm_train`. Then the same LM with each block's attention run as
    the in-process ring over RING_BLOCKS blocks: 3 train steps, finite
    and falling, the first loss within rel 1e-2 of the unsplit step's,
    and the Hopper kernels launched n x n times a layer and step (the
    ring's offsets and its live lse cotangent inside a train step).
    Returns the kernels' launches of the mesh run and the ring run, and
    the unsplit steps' losses."""
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.ops import attention
    from elasticdl_tpu_torch.parallel import elastic
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    steps, n = SEQ_STEPS, RING_BLOCKS
    plain_losses, plain_params, plain_launches, plain_ms = seq_lm_steps()
    ctx = elastic.CohortContext(f"localhost:{free_port()}", 1, 0,
                                device=torch.device("cuda:0"))
    ctx.initialize(timeout_s=60)
    try:
        mesh = mesh_lib.build_mesh({"data": 1, "seq": 1})
        losses, params, launches, ms = seq_lm_steps(mesh)
    finally:
        ctx.shutdown()
    if losses != plain_losses or params.keys() != plain_params.keys() or \
            not all(torch.equal(params[k], plain_params[k]) for k in params):
        raise AssertionError(f"the {{data 1, seq 1}} steps {losses} differ "
                             f"from the steps with no mesh {plain_losses}")
    if launches != hopper_launches(steps) or launches != plain_launches:
        raise AssertionError(f"flash launches on the seq mesh {launches}")
    ring_losses, _, ring_launches, ring_ms = seq_lm_steps(
        attention=lambda q, k, v, causal: attention.ring_attention_local(
            q, k, v, n, causal))
    rel = ring_lm_checks("the ring LM", ring_losses, ring_launches,
                         plain_losses, n * n)
    emit("seq_train", card=smi, params=LM_PARAMS, batch=[LM_BATCH, LM_T],
         compute_dtype="bfloat16", mesh={"data": 1, "seq": 1},
         backend=ctx.backend, steps=steps, losses=losses,
         bit_equal_to_no_mesh=True, host_ms_per_step=ms,
         no_mesh_host_ms_per_step=plain_ms,
         launches={k: v for k, v in launches.items() if v},
         ring={"blocks": n, "losses": ring_losses,
               "first_loss_rel_diff": rel,
               "host_ms_per_step": ring_ms,
               "launches": {k: v for k, v in ring_launches.items() if v}})
    return {k: launches[k] + ring_launches[k] for k in launches}, plain_losses


TP_GROUPS = 2            # the head groups of a model axis of 2 ranks
MOE_BLOCKS = (2, 2)      # the (data, seq) blocks the MoE routes over
MOE_DROP_CAPACITY = 0.5  # a capacity factor at which tokens drop


def head_groups(fn, groups=TP_GROUPS):
    """`fn(q, k, v, *args)` run on each of `groups` contiguous head groups
    of (B, T, H, D) q, k, v, as each rank of a `model` axis of that size
    runs it on the H / groups heads its column split holds, the outputs
    joined along H."""
    def split(q, k, v, *args):
        per = q.shape[2] // groups
        return torch.cat([fn(*(x[:, :, g * per:(g + 1) * per].contiguous()
                               for x in (q, k, v)), *args)
                          for g in range(groups)], dim=2)
    return split


# a block's MoE output rows against the whole batch's layer (rtol, atol of
# max): the router's float32 product runs per block, and cuBLAS picks its
# kernel by the rows (2048 against 8192), so the logits and the gates can
# differ in their last bits; each output row is its expert row times its
# gate, one float32 rounding apart (the rows whose gates agree must be
# equal bit for bit)
MOE_OUT_TOL = (1e-6, 1e-6)


def moe_block_routes():
    """One MoE layer at the MoE LM's width (8 x 1024 tokens, C 512, 8
    experts) routed over MOE_BLOCKS (data, seq) blocks in this process
    (`ops.moe.blocks_local`: each block's `route` gets the counts and the
    probability sums a mesh's gathers would bring), at capacity factors
    MOE_CAPACITY and MOE_DROP_CAPACITY: each block's chosen experts,
    slots, keep and capacity must equal the global route's bit for bit
    and its aux be within rel 1e-6; its index route's output rows must
    equal the global layer's bit for bit where the block's gates do, and
    within MOE_OUT_TOL elsewhere. Returns the report a capacity factor,
    with the ms of the global layer's forward and of the blocks'
    forwards, and the checks that failed."""
    from elasticdl_tpu_torch.api.layers import MoE
    from elasticdl_tpu_torch.common import runtime
    from elasticdl_tpu_torch.ops import moe as moe_ops

    runtime.configure_torch_runtime()
    dev = runtime.resolve_device(None)       # the card
    c, (data, seq) = LM_DIM, MOE_BLOCKS
    gen = torch.Generator(device=dev).manual_seed(7)
    layer = MoE(c, MOE_EXPERTS, 4 * c, residual=False).to(dev)
    layer.reset_parameters(gen)
    x = torch.randn((LM_BATCH, LM_T, c), device=dev, generator=gen)
    flat = x.reshape(-1, c)
    weights = [layer.router, layer.w1, layer.b1, layer.w2, layer.b2]
    rows, cols = LM_BATCH // data, LM_T // seq
    order = torch.arange(LM_BATCH * LM_T, device=dev).view(LM_BATCH, LM_T)
    report, bad = {}, []
    with torch.no_grad():
        for cf in (MOE_CAPACITY, MOE_DROP_CAPACITY):
            whole = moe_ops.route(flat, layer.router, cf)
            out, _ = moe_ops.switch_moe(flat, *weights, capacity_factor=cf)
            blocks = moe_ops.blocks_local(x, layer.router, data, seq)
            aux_rel, out_ratio, gates_equal, checks = 0.0, 0.0, 0, {}
            for i, (xb, blk) in enumerate(blocks):
                d, s = divmod(i, seq)
                sel = order[d * rows:(d + 1) * rows,
                            s * cols:(s + 1) * cols].reshape(-1)
                r = moe_ops.route(xb, layer.router, cf, blk)
                ob, _ = moe_ops.switch_moe(xb, *weights, capacity_factor=cf,
                                           blocks=blk)
                same = r.gate == whole.gate[sel]
                got = {"cap": r.cap == whole.cap,
                       "idx": torch.equal(r.idx, whole.idx[sel]),
                       "pos": torch.equal(r.pos, whole.pos[sel]),
                       "keep": torch.equal(r.keep, whole.keep[sel]),
                       "out_where_gates_agree": torch.equal(
                           ob[same], out[sel][same]),
                       "out": torch.equal(ob, out[sel]),
                       "router_logits": torch.equal(
                           xb @ layer.router, (flat @ layer.router)[sel])}
                for k, ok in got.items():
                    checks[k] = checks.get(k, True) and ok
                gates_equal += int(same.sum())
                out_ratio = max(out_ratio,
                                over_tol(ob, out[sel], *MOE_OUT_TOL)[1])
                aux_rel = max(aux_rel, abs(float(r.aux) - float(whole.aux))
                              / abs(float(whole.aux)))
            block_ms = time_ms(lambda: [moe_ops.switch_moe(
                xb, *weights, capacity_factor=cf, blocks=blk)
                for xb, blk in blocks], groups=7, per_group=3, warmup=1)
            whole_ms = time_ms(lambda: moe_ops.switch_moe(
                flat, *weights, capacity_factor=cf), groups=7, per_group=3,
                warmup=1)
            report[str(cf)] = dict(
                capacity=whole.cap, dropped=int((~whole.keep).sum()),
                aux=float(whole.aux), aux_rel_diff=aux_rel,
                bit_equal=checks, gates_bit_equal=gates_equal,
                out_share_of_tolerance=out_ratio,
                blocks_fwd_ms=block_ms, whole_fwd_ms=whole_ms)
            bad += [f"{cf} {k}" for k, ok in checks.items()
                    if not ok and k not in ("router_logits", "out")]
            if aux_rel > 1e-6 or out_ratio > 1.0:
                bad.append(f"{cf} aux {aux_rel}, out {out_ratio}")
    return report, bad


def phase_seq_mix(dev, smi, plain_losses):
    """Sequence parallelism beside tensor and expert parallelism at the
    LM's width, in one process (one card holds one rank): the ring over
    RING_BLOCKS virtual ranks and Ulysses over 2 run on each of TP_GROUPS
    head groups of 4 heads (B 8, T 1024, D 64, bf16, causal), as each
    rank of a {seq, model} mesh runs them on its heads, each launch held
    to its plain version and the joined schedule to one unsplit call
    (`schedule_checks`); the ring over head groups as each block's
    attention inside 3 LM train steps; and the MoE's routing over (data,
    seq) blocks (`moe_block_routes`). Returns the Hopper kernels'
    launches."""
    from elasticdl_tpu_torch.ops import attention
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, t, h, d, n, g = LM_BATCH, LM_T, 8, 64, RING_BLOCKS, TP_GROUPS
    q, k, v, dout, _ = attn_inputs(dev, b, t, t, h, d, torch.bfloat16, 43)
    bwd = (fa.BWD_DQ_SM90, fa.BWD_DKV_SM90, fa.BWD_DELTA_SM90)
    ring_fn = head_groups(lambda q, k, v: attention.ring_attention_local(
        q, k, v, n, causal=True))
    pairs = g * n * n
    ring = schedule_checks("seq_mix", ring_fn, q, k, v, dout,
                           {fa.FWD_SM90: pairs},
                           {name: pairs for name in bwd})
    ulysses = schedule_checks(
        "seq_mix", head_groups(lambda q, k, v: ulysses_local(q, k, v, 2)),
        q, k, v, dout, {fa.FWD_SM90: 2 * g}, {name: 2 * g for name in bwd})
    losses, _, train_launches, ms = seq_lm_steps(attention=head_groups(
        lambda q, k, v, causal: attention.ring_attention_local(
            q, k, v, n, causal)))
    rel = ring_lm_checks("the ring LM over head groups", losses,
                         train_launches, plain_losses, g * n * n)
    routes, bad = moe_block_routes()
    emit("seq_mix", card=smi, shape=[b, t, h, d], dtype="bfloat16",
         causal=True, head_groups=g, blocks=n,
         tolerance={"per_call": list(KERNEL_TOL),
                    "out": list(RING_OUT_TOL),
                    "grads": list(RING_GRAD_TOL),
                    "form": "rtol, atol of max, atol of rms"},
         ring=ring, ulysses=ulysses,
         train={"params": LM_PARAMS, "steps": SEQ_STEPS, "losses": losses,
                "unsplit_losses": plain_losses,
                "first_loss_rel_diff": rel, "host_ms_per_step": ms,
                "launches": {k: v for k, v in train_launches.items() if v}},
         moe_routes={"tokens": LM_BATCH * LM_T, "experts": MOE_EXPERTS,
                     "blocks": list(MOE_BLOCKS), "out_tolerance": {
                         "rtol, atol of max": list(MOE_OUT_TOL)},
                     "by_capacity": routes})
    if bad:
        raise AssertionError(f"the MoE's block routes differ from the "
                             f"global route: {bad}")
    launches = {name: train_launches[name] for name in fa.launches}
    for run in (ring, ulysses):
        for counts in (run["launches_fwd"], run["launches_bwd"]):
            for name, c in counts.items():
                launches[name] += c
    return launches


# ---------------------------------------------------------------- knobs


def _variant_trainer(weights, **knobs):
    """A full-width bf16 LM trainer on the card with `knobs`, its params
    loaded from `weights` (one cloned state for every variant)."""
    from elasticdl_tpu_torch.training.trainer import Trainer

    trainer = Trainer(load_spec(LM_PARAMS,
                                model_def="transformer.transformer_lm."
                                "custom_model"), **knobs)
    state = trainer.init_state(None)
    if weights is not None:
        trainer.model.load_state_dict(weights)
    return trainer, state


# the variants of the `knobs` phase: (name, Trainer knobs, K2' launches a
# layer, K3' / K4' / delta launches a layer)
KNOB_VARIANTS = (
    ("base", {}, 1, 1),
    ("remat_dots", {"remat_policy": "dots"}, 2, 1),
    ("remat_nothing", {"remat_policy": "nothing"}, 2, 1),
    ("accum2", {"grad_accum": 2}, 2, 2),
    ("accum2_dots", {"grad_accum": 2, "remat_policy": "dots"}, 4, 2),
)
LM_LR = 3e-4                    # the zoo's AdamW learning rate
KNOB_TIMED_STEPS = 3
# the most of the entries that accum2's first step may move more than 1e-6
# apart from base's; a step over one of its two micro-batches alone must
# move more (the phase measures both)
KNOB_PARAM_SHARE = 0.02


def phase_knobs():
    """One train step of the full-width bf16 LM under each of the
    trainer's HBM knobs, from one cloned state. Remat runs the same
    kernels on the same inputs, so its parameters must equal base's bit
    for bit; accumulation 2 sums two micro-batches' float32 gradients, so
    its loss is held to rel 1e-4 and each gradient's error norm to 5e-2 of
    its norm (bf16 products round differently at half the batch; the k
    biases, 0 in exact arithmetic, excepted), and its parameters within
    2 x lr + 1e-6 of base's: a first AdamW step moves every entry by
    ~lr x sign(g), so a gradient near 0 can flip. That bound holds for
    any gradient, so the share of entries moved apart is held too: at
    most KNOB_PARAM_SHARE, which a step over one micro-batch alone must
    exceed. The peaks of
    `remat_nothing` and `accum2` must fall below base's."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    batch = lm_batch(300)
    # warm-up on a throwaway trainer: cuBLAS handles, the kernels' first
    # launches and the allocator's pools are not a variant's cost
    trainer, state = _variant_trainer(None)
    weights = {n: t.detach().to("cpu", copy=True)
               for n, t in trainer.model.state_dict().items()}
    trainer.train_step(state, batch)
    # what a step that lost one of accum2's micro-batches would give: the
    # step over micro-batch 0 alone, for the share check below
    trainer, state = _variant_trainer(weights)
    trainer.train_step(state, {k: v[0::2] for k, v in batch.items()})
    lost = {n: p.detach().to("cpu", copy=True)
            for n, p in state.params.items()}
    del trainer, state
    gc.collect()
    torch.cuda.synchronize()

    report, params, grads = {}, {}, {}
    for name, knobs, fwd, bwd in KNOB_VARIANTS:
        trainer, state = _variant_trainer(weights, **knobs)
        mode = step_mode(trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state, logs = trainer.train_step(state, batch)
        loss = float(logs["loss"])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        launches = dict(fa.launches)
        # kept on the host, so that no variant's peak holds another's
        params[name] = {n: p.detach().to("cpu", copy=True)
                        for n, p in state.params.items()}
        grads[name] = {n: p.grad.detach().to("cpu", copy=True)
                       for n, p in state.params.items()}
        # the step's time past its first call (Adam's slots, new blocks)
        t0 = time.perf_counter()
        for _ in range(KNOB_TIMED_STEPS):
            state, logs = trainer.train_step(state, batch)
            float(logs["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3 / KNOB_TIMED_STEPS
        del trainer, state, logs
        gc.collect()
        want = {**{k: 0 for k in launches},
                fa.FWD_SM90: fwd * LM_LAYERS,
                fa.BWD_DQ_SM90: bwd * LM_LAYERS,
                fa.BWD_DKV_SM90: bwd * LM_LAYERS,
                fa.BWD_DELTA_SM90: bwd * LM_LAYERS}
        if launches != want:
            raise AssertionError(f"knobs {name}: flash launches {launches}, "
                                 f"want {want}")
        report[name] = {"knobs": knobs, "loss": loss, "step_mode": mode,
                        "first_step_ms": first_ms, "step_ms": step_ms,
                        "peak_mem_gib": peak / 2**30,
                        "launches": {k: v for k, v in launches.items() if v}}
    base = params["base"]
    for name in report:
        report[name]["max_param_diff"] = max(
            float((params[name][n] - base[n]).abs().max()) for n in base)
    # remat recomputes with the same kernels on the same inputs: the same
    # bits as the step without it
    for name, against in (("remat_dots", "base"), ("remat_nothing", "base"),
                          ("accum2_dots", "accum2")):
        differ = [n for n in base
                  if not torch.equal(params[name][n], params[against][n])]
        if differ or report[name]["loss"] != report[against]["loss"]:
            raise AssertionError(f"{name}: loss or params {differ[:4]} "
                                 f"differ from {against}'s")
    accum, want = report["accum2"], report["base"]
    if abs(accum["loss"] - want["loss"]) > 1e-4 * abs(want["loss"]):
        raise AssertionError(f"accum2 loss {accum['loss']} vs base "
                             f"{want['loss']}")
    worst = 0.0
    for n, g in grads["base"].items():
        if n.endswith(".k.bias"):
            continue
        ratio = float((grads["accum2"][n] - g).norm() / g.norm())
        worst = max(worst, ratio)
        if ratio > 5e-2:
            raise AssertionError(f"accum2 gradient of {n} is {ratio} of its "
                                 "norm off base's")
    accum["worst_grad_err_over_norm"] = worst
    if accum["max_param_diff"] > 2 * LM_LR + 1e-6:
        raise AssertionError(f"accum2 params {accum['max_param_diff']} off "
                             f"base's, over 2 x lr")
    # A first AdamW step moves each entry by about lr x sign(gradient)
    # whatever the gradient's size, so the bound above holds for any
    # gradient; the entries that moved apart are those whose gradient
    # changed sign (or fell near Adam's eps). Rounding flips few signs,
    # a wrong accumulation (a lost or doubled micro-batch) many.
    def moved_share(got):
        return sum(int(((got[n] - base[n]).abs() > 1e-6).sum())
                   for n in base) / sum(p.numel() for p in base.values())

    share, lost_share = moved_share(params["accum2"]), moved_share(lost)
    accum["params_over_1e-6_share"] = share
    accum["lost_micro_batch_share"] = lost_share
    if not share <= KNOB_PARAM_SHARE < lost_share:
        raise AssertionError(
            f"accum2 moved {share} of the entries apart from base's, and "
            f"a step over one micro-batch {lost_share}: the bound "
            f"{KNOB_PARAM_SHARE} must lie between them")
    for name in ("remat_nothing", "accum2"):
        if not report[name]["peak_mem_gib"] < want["peak_mem_gib"]:
            raise AssertionError(
                f"{name} peak {report[name]['peak_mem_gib']} GiB not below "
                f"base's {want['peak_mem_gib']}")
    emit("knobs", params=LM_PARAMS, batch=[LM_BATCH, LM_T],
         compute_dtype="bfloat16", variants=report)


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
    """Params, buffers, optimizer slots and groups (a schedule's count)
    and step of two TrainStates, exactly."""
    if a.step != b.step or list(a.params) != list(b.params):
        return False
    if not all(torch.equal(a.params[k], b.params[k]) for k in a.params):
        return False
    if a.buffers.keys() != b.buffers.keys() or not all(
            torch.equal(a.buffers[k], b.buffers[k]) for k in a.buffers):
        return False
    ga, gb = (s.optimizer.state_dict()["param_groups"] for s in (a, b))
    if ga != gb:
        return False
    sa, sb = (s.optimizer.state_dict()["state"] for s in (a, b))
    return sa.keys() == sb.keys() and all(
        sa[i].keys() == sb[i].keys()
        and all(torch.equal(sa[i][k].cpu(), sb[i][k].cpu()) for k in sa[i])
        for i in sa)


def phase_job(smi, serving):
    """The job path in one process: the port's Master and its Worker (on
    a thread, device defaulted: the card) run the DeepFM job at full
    width; returns K1's launches in it. Its export is copied to
    `<serving>/export` for `serve_export`."""
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
        # each training task's (steps, records, seconds in steps), as the
        # cohort's task lines give them
        tasks = []
        run_task = worker._run_training_task

        def recorded(task):
            stats = run_task(task)
            tasks.append((int(stats["loss_count"]),
                          int(stats["records_done"]),
                          float(stats["step_time_sum"])))
            return stats

        worker._run_training_task = recorded
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
        shutil.copytree(os.path.join(out, "export"),
                        os.path.join(serving, "export"))

    def delta(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    step_s = delta("edl_train_step_seconds_sum")
    records = delta("edl_train_records_total")
    lib = parsing._load()
    metrics = {"tasks": counts["finished_training"], "wall_s": wall_s,
               "samples_per_s": records / step_s,
               "host_ms_per_step": step_s * 1e3 / steps,
               "data_wait_ms_per_step": phases.get("phase_data_wait_ms", 0.0),
               "h2d_ms_per_step": phases.get("phase_h2d_ms", 0.0),
               "past_first_task": steady_state([tasks])}
    emit("job", card=smi, params=f"field_vocab={FIELD_VOCAB};hidden=400,400",
         batch=BATCH, train_steps=steps,
         records=records, counts=counts, eval=results, **metrics,
         compute_ms_per_step=phases.get("phase_compute_ms", 0.0),
         parser=("native " + os.path.relpath(lib._name, REPO)) if lib
         else "python", k1_launches=launches, checkpoint_steps=[4, 8],
         export_max_abs_err=export_err)
    return launches, metrics


# ---------------------------------------------------------------- serve_export

SERVE_SMALL = 3          # rows of the small serving batch
SERVE_FRESH = r"""
import json, sys
import numpy as np, torch
from elasticdl_tpu_torch.training import export
serve = export.load_saved_model(sys.argv[1])
with torch.no_grad():
    out = serve(torch.from_numpy(np.load(sys.argv[2])).cuda())
np.save(sys.argv[3], out.cpu().numpy())
print(json.dumps(sys.modules["elasticdl_tpu_torch.ops.flash_attention"]
                 .launches))
"""


def serve_rows(features, rows):
    """The first `rows` rows of numpy features (a dict or an array), on
    the card."""
    if isinstance(features, dict):
        return {k: torch.from_numpy(v[:rows]).cuda()
                for k, v in features.items()}
    return torch.from_numpy(features[:rows]).cuda()


def serve_fresh_process(path, tokens, tmp):
    """Load the program under `path` in a new process that imports only
    `training.export`, serve `tokens` on the card there: (its outputs,
    its flash launches)."""
    np.save(os.path.join(tmp, "tokens.npy"), tokens)
    out = os.path.join(tmp, "served.npy")
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_FRESH, path,
         os.path.join(tmp, "tokens.npy"), out],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"a fresh process could not serve {path}: "
                             f"exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return np.load(out), json.loads(proc.stdout.strip().splitlines()[-1])


def serve_one(name, export_dir, features, tol):
    """Export one model (`export_saved_model` on the card, the example
    batch `features`), load it, and hold its outputs to the eager
    `load_model` model's, at the full batch and at SERVE_SMALL rows; time
    both. Returns (the report, the program's directory, the exported
    forward's flash launches at the full batch, its outputs)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training import export

    t0 = time.perf_counter()
    path = export.export_saved_model(export_dir, ZOO, features)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = export.load_saved_model(path)
    load_s = time.perf_counter() - t0
    model, _ = export.load_model(export_dir, ZOO)
    report = {"export_s": export_s, "load_s": load_s,
              "pt2_bytes": os.path.getsize(
                  os.path.join(path, export.SAVED_MODEL_FILE)),
              "flash_fwd_nodes": sum(
                  n.target is torch.ops.edl.flash_fwd.default
                  for n in serve.graph.nodes)}
    launches = None
    full = len(next(iter(features.values())) if isinstance(features, dict)
               else features)
    for rows in (full, SERVE_SMALL):
        x = serve_rows(features, rows)
        with torch.no_grad():
            want = model(x, training=False)
            torch.cuda.synchronize()
            reset_launches()
            placement.launches = 0
            got = serve(x)
            torch.cuda.synchronize()
            if launches is None:
                launches, outputs = dict(fa.launches), got
            if placement.launches:
                raise AssertionError(f"{name}'s served forward launched K1")
            err = float((got.float() - want.float()).abs().max())
            if (got.shape != want.shape or got.dtype != want.dtype
                    or not bool(torch.isfinite(got).all())
                    or err > tol(want)):
                raise AssertionError(
                    f"{name} served {got.dtype} {tuple(got.shape)} at "
                    f"{rows} rows, {err} off the eager {want.dtype} "
                    f"{tuple(want.shape)}")
            report[f"rows_{rows}"] = {
                "shape": list(got.shape), "max_abs_err": err,
                "bit_equal": bool(torch.equal(got, want)),
                "served_ms": time_ms(lambda: serve(x)),
                "eager_ms": time_ms(lambda: model(x, training=False))}
    return report, path, launches, outputs


def phase_serve_export(smi, serving):
    """The serving export on the card: DeepFM from the `job` phase's
    export (`<serving>/export`) and the bf16 LM at `lm_train`'s width from
    a seed, each through `export_saved_model` (torch.export on cuda:0) and
    `load_saved_model`; the LM's program must launch K2' once a layer and
    no K2, and load and serve in a fresh process. Returns the exported LM
    forward's flash launches."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training import export
    from elasticdl_tpu_torch.training.trainer import Trainer

    spec = load_spec(LM_PARAMS, model_def=LM_DEF)
    trainer = Trainer(spec)                 # device defaulted: the GPU
    tokens = lm_batch(300)
    state = trainer.init_state(tokens)
    lm_dir = export.export_model(
        state, os.path.join(serving, "lm"), model_def=LM_DEF,
        model_params=spec.model_params, module_name=spec.module_name)
    del trainer, state
    report = {}
    report["deepfm"], _, deepfm_launches, _ = serve_one(
        "DeepFM", os.path.join(serving, "export"),
        criteo_batch(17)["features"], lambda want: 1e-6)
    if any(deepfm_launches.values()):
        raise AssertionError(f"the exported DeepFM launched {deepfm_launches}")
    report["lm"], path, launches, outputs = serve_one(
        "the LM", lm_dir, tokens["features"],
        lambda want: 1e-6 * float(want.abs().max()))
    none = {name: 0 for name in fa.launches}
    if launches != {**none, fa.FWD_SM90: LM_LAYERS} or \
            report["lm"]["flash_fwd_nodes"] != LM_LAYERS:
        raise AssertionError(
            f"the exported LM's forward launched {launches} from "
            f"{report['lm']['flash_fwd_nodes']} edl::flash_fwd nodes, want "
            f"{LM_LAYERS} K2' and no K2")
    fresh, fresh_launches = serve_fresh_process(path, tokens["features"],
                                                serving)
    if not np.array_equal(fresh, outputs.cpu().numpy()) or \
            fresh_launches != {**none, fa.FWD_SM90: LM_LAYERS}:
        raise AssertionError(
            f"a fresh process served {fresh_launches} launches and logits "
            f"{float(np.abs(fresh - outputs.cpu().numpy()).max())} off")
    report["lm"]["fresh_process"] = {"launches": fresh_launches,
                                     "bit_equal": True}
    emit("serve_export", card=smi,
         deepfm={"params": f"field_vocab={FIELD_VOCAB};hidden=400,400",
                 "batch": BATCH, **report["deepfm"]},
         lm={"params": LM_PARAMS, "batch": [LM_BATCH, LM_T],
             "compute_dtype": "bfloat16", **report["lm"]},
         launches=launches)
    return launches


# ---------------------------------------------------------------- grouped


def phase_grouped():
    """DeepFM at full width over 8 distinct batches: 8 train_steps, then
    from a cloned state 2 train_many groups of 4. The parameters must be
    equal bit for bit (the same kernels on the same batches) and K1 must
    launch twice a step in each path. Then host ms a step of each path
    over 8 more steps in turns (steps, groups, groups, steps), each step
    ending in its readback (a step's loss, a group's losses) as the
    worker reads them, the host-to-device copy of the batches included.
    Returns K1's launches in the grouped run."""
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.trainer import Trainer, stack_batches

    batches = []
    for i in range(8):
        b = criteo_batch(200 + i)
        b["mask"] = np.ones((BATCH,), np.float32)
        batches.append(b)

    def run(trainer, state, grouped):
        """8 steps; (state, losses, host ms a step, K1 launches)."""
        torch.cuda.synchronize()
        placement.launches = 0
        losses = []
        t0 = time.perf_counter()
        if grouped:
            for g in range(2):
                state, logs = trainer.train_many(
                    state, stack_batches(batches[4 * g:4 * g + 4],
                                         trainer.device))
                losses += logs["loss"].tolist()
        else:
            for b in batches:
                state, logs = trainer.train_step(state, b)
                losses.append(float(logs["loss"]))
        host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        return state, losses, host_ms, placement.launches

    paths, weights = {}, None
    for grouped in (False, True):
        trainer = Trainer(load_spec(f"field_vocab={FIELD_VOCAB};"
                                    "hidden=400,400"))
        state = trainer.init_state(None)
        if weights is None:
            weights = {n: t.detach().clone()
                       for n, t in trainer.model.state_dict().items()}
        trainer.model.load_state_dict(weights)
        paths[grouped] = (trainer, state)
    checked = {g: run(*paths[g], g) for g in (False, True)}
    (single, single_losses, _, single_k1), \
        (group, group_losses, _, group_k1) = checked[False], checked[True]
    if single_k1 != group_k1 or group_k1 != placement.PASSES * 8:
        raise AssertionError(f"K1 launched {single_k1} (steps) and "
                             f"{group_k1} (groups) kernels in 8 steps")
    if single_losses != group_losses or (single.step, group.step) != (8, 8):
        raise AssertionError(f"losses {single_losses} vs {group_losses}")
    differ = [n for n in single.params
              if not torch.equal(single.params[n], group.params[n])]
    if differ:
        raise AssertionError(f"train_many params differ from train_step's: "
                             f"{differ}")
    states = {False: single, True: group}
    timed = {False: [], True: []}
    for g in (False, True, True, False):
        states[g], _, ms, _ = run(paths[g][0], states[g], g)
        timed[g].append(ms)
    emit("grouped", params=f"field_vocab={FIELD_VOCAB};hidden=400,400",
         batch=BATCH, steps=8, group=4, losses=group_losses,
         step_mode=step_mode(paths[True][0]),
         first_host_ms_per_step={"train_step": checked[False][2],
                                 "train_many": checked[True][2]},
         host_ms_per_step={"train_step": timed[False],
                           "train_many": timed[True]},
         k1_launches={"train_step": single_k1, "train_many": group_k1})
    del paths, states, single, group
    gc.collect()
    return group_k1


# ------------------------------------------------------------- graph_step

GRAPH_STEPS, GRAPH_GROUP = 10, 4
# each model's hand-written kernels, by a part of their symbols, that a
# replay of its train step must launch
GRAPH_KERNELS = {
    "deepfm": K1_SYMBOLS,
    "lm": ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
           "flash_bwd_dkv_sm90_kernel", "flash_bwd_delta_sm90_kernel"),
    "lm_f32": ("flash_fwd_tf32_sm90_kernel", "flash_bwd_dq_tf32_sm90_kernel",
               "flash_bwd_dkv_tf32_sm90_kernel",
               "flash_bwd_delta_sm90_kernel"),
}


def graph_of(program, trainer, state):
    """The captured graph `program` holds for `trainer` and `state`."""
    from elasticdl_tpu_torch.training import step_graph

    graphs = [g for g in program.graphs() if g.bound_to(trainer, state)
              and isinstance(g, step_graph.CapturedGraph)]
    if len(graphs) != 1:
        raise AssertionError(f"{len(graphs)} captured {program.kind} graphs "
                             "for one state")
    return graphs[0]


def step_kernels(step, names, tries=3):
    """torch.profiler over one call of `step`: (the device kernels it
    ran, their device ms summed, how many of each of `names` are among
    them), traced again, at most `tries` times in all, while one of
    `names` is missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        kernels = [e.name for e in events
                   if not e.name.startswith(("Memcpy", "Memset"))]
        device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        found = {n: sum(n in k for k in kernels) for n in names}
        if all(found.values()):
            break
    return len(kernels), device_ms, found


def graph_run(name, spec_fn, batch, smi):
    """`spec_fn()`'s model on the card: a trainer whose steps are captured
    and an eager twin (the same seed, its weights loaded), GRAPH_STEPS
    train steps each from the same state, then a `train_many` group of
    GRAPH_GROUP against as many eager steps. Returns the fields to emit."""
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.trainer import Trainer, stack_batches

    graph = Trainer(spec_fn())                  # device defaulted: the GPU
    if graph.capture_reason is not None:
        raise AssertionError(f"{name}: the trainer does not capture: "
                             f"{graph.capture_reason}")
    eager = Trainer(spec_fn())
    gs, es = graph.init_state(None), eager.init_state(None)
    eager.model.load_state_dict(graph.model.state_dict())
    args = graph._device_args(batch)
    stacked = stack_batches([batch] * GRAPH_GROUP, graph.device)

    def host_loop(step, n):
        """n calls of `step`: host ms a call (no wait between calls), and
        wall ms a call up to the device's last."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = 0.0
        out = []
        for _ in range(n):
            t1 = time.perf_counter()
            out.append(step())
            host += time.perf_counter() - t1
        torch.cuda.synchronize()
        return out, host * 1e3 / n, (time.perf_counter() - t0) * 1e3 / n

    def eager_step():
        loss = eager._train_body(es, args)
        es.step += 1
        return loss

    t0 = time.perf_counter()
    first = graph.train_step(gs, args)[1]["loss"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    step_graph_ = graph_of(graph._train_step, graph, gs)
    replayed, replay_host, replay_wall = host_loop(
        lambda: graph.train_step(gs, args)[1]["loss"], GRAPH_STEPS - 1)
    eager_losses, eager_host, eager_wall = host_loop(eager_step,
                                                     GRAPH_STEPS)
    losses = [first] + replayed
    if step_graph_.replays != GRAPH_STEPS:
        raise AssertionError(f"{name}: {step_graph_.replays} replays in "
                             f"{GRAPH_STEPS} train steps")
    group = graph.train_many(gs, stacked)[1]["loss"]
    group_graph = graph_of(graph._train_many, graph, gs)
    group_eager = torch.stack([eager_step() for _ in range(GRAPH_GROUP)])
    torch.cuda.synchronize()
    if group_graph.replays != 1:
        raise AssertionError(f"{name}: {group_graph.replays} replays for "
                             "one train_many group")
    loss_equal = (torch.equal(torch.stack(losses), torch.stack(eager_losses))
                  and torch.equal(group, group_eager))
    differ = [n for n in gs.params
              if not torch.equal(gs.params[n], es.params[n])]
    slots_differ = [
        n for n, p in gs.params.items()
        for k, v in gs.optimizer.state[p].items()
        if isinstance(v, torch.Tensor)
        and not torch.equal(v, es.optimizer.state[es.params[n]][k])]
    if not loss_equal or differ or slots_differ:
        raise AssertionError(
            f"{name}: captured steps differ from the eager body: losses "
            f"{[float(x) for x in losses]} vs "
            f"{[float(x) for x in eager_losses]}, params {differ[:4]}, "
            f"slots {slots_differ[:4]}")
    replays = {"train_step": step_graph_.replays,
               "train_many": group_graph.replays}
    kernels, replay_device, found = step_kernels(
        lambda: graph.train_step(gs, args), GRAPH_KERNELS[name])
    # what the profiler saw in one replay, by counter: K1's two passes
    # together are its count (PASSES a call), a flash kernel's symbol is
    # its counter's name and "_kernel"
    profiled = ({placement.KERNEL: sum(found.values())} if name == "deepfm"
                else {n[:-len("_kernel")]: c for n, c in found.items()})
    if profiled != step_graph_.launches:
        raise AssertionError(f"{name}: one replay ran {found} in "
                             f"torch.profiler, and its capture credits "
                             f"{step_graph_.launches} a replay")
    eager_kernels, eager_device, _ = step_kernels(eager_step, ())
    return dict(
        card=smi, steps=GRAPH_STEPS, group=GRAPH_GROUP,
        losses=[float(x) for x in losses],
        group_losses=[float(x) for x in group], bit_equal=True,
        first_call_s=first_s,
        capture_s={"train_step": step_graph_.capture_s,
                   "train_many": group_graph.capture_s},
        warmup_s={"train_step": step_graph_.warmup_s,
                  "train_many": group_graph.warmup_s},
        pool_bytes={"train_step": step_graph_.pool_bytes,
                    "train_many": group_graph.pool_bytes},
        host_ms_per_step={"eager": eager_host, "replay": replay_host},
        wall_ms_per_step={"eager": eager_wall, "replay": replay_wall},
        device_ms_per_step={"eager": eager_device, "replay": replay_device},
        device_busy_share={"eager": eager_device / eager_wall,
                           "replay": replay_device / replay_wall},
        kernels_per_step={"eager": eager_kernels, "replay": kernels},
        replays=replays,
        launches_per_replay={"train_step": step_graph_.launches,
                             "train_many": group_graph.launches},
        replay_named=found)


def phase_graph_step(smi):
    """The trainer's captured path on the card (`training/step_graph.py`):
    DeepFM at `train`'s width, the bf16 LM at `lm_train`'s and the
    float32 LM at `lm_train_f32`'s, each
    GRAPH_STEPS captured train steps against as many eager bodies from
    the same state and a `train_many` group against GRAPH_GROUP eager
    steps: losses, parameters and Adam's slots equal bit for bit, one
    replay a step and one a group, and K1 (DeepFM), K2', K3', K4' and
    the delta pass (the bf16 LM) or K2-tf32, K3-tf32, K4-tf32 and the
    delta pass (the float32 LM) among a replay's kernels in
    torch.profiler. Prints host and wall ms a step eager and replayed,
    the device ms and kernels of one step each way (torch.profiler) and
    the device's busy share (device ms over wall ms), the capture's and
    the warm-up's seconds, and each graph's pool bytes. Returns the
    kernels' launches over the phase (replays credited, warm-ups not)."""
    from elasticdl_tpu_torch.ops import placement

    placement.launches = 0
    reset_launches()
    deepfm = graph_run(
        "deepfm", lambda: load_spec(f"field_vocab={FIELD_VOCAB};"
                                    "hidden=400,400"),
        {**criteo_batch(400), "mask": np.ones((BATCH,), np.float32)}, smi)
    gc.collect()
    lm = graph_run("lm", lambda: load_spec(LM_PARAMS, model_def=LM_DEF),
                   lm_batch(400), smi)
    gc.collect()
    lm_f32 = graph_run(
        "lm_f32", lambda: load_spec(LM_PARAMS, "float32", model_def=LM_DEF),
        lm_batch(401), smi)
    gc.collect()
    counts = kernel_counts()
    emit("graph_step", deepfm=deepfm, lm=lm, lm_f32=lm_f32,
         launches={k: v for k, v in counts.items() if v})
    return counts


# ---------------------------------------------------------------- lm_job

LM_JOB_STEPS, LM_JOB_EVAL_STEPS, LM_JOB_GROUP = 32, 8, 4


def lm_job_argv(out):
    """The full-width bf16 LM through the job path: 256 synthetic-lm
    records of 1024 tokens in 4 tasks of 64 (8 steps of 8 each), groups of
    4 steps, eval at epoch end over 64 records, and a profiler window of
    4 steps from step 8."""
    return [
        "--model_zoo", ZOO,
        "--model_def", "transformer.transformer_lm.custom_model",
        "--model_params", LM_PARAMS, "--minibatch_size", str(LM_BATCH),
        "--training_data",
        f"synthetic://lm?n=256&shards=4&vocab={LM_VOCAB}&seq_len={LM_T}",
        "--records_per_task", "64",
        "--validation_data",
        f"synthetic://lm?n=64&shards=1&vocab={LM_VOCAB}&seq_len={LM_T}",
        "--steps_per_dispatch", str(LM_JOB_GROUP),
        "--profile_dir", os.path.join(out, "profile"),
        "--profile_start_step", "8", "--profile_steps", "4",
        "--worker_heartbeat_s", "2",
    ]


def phase_lm_job(smi):
    """The bf16 LM's job in one process: the port's Master and its Worker
    (on a thread, device defaulted: the card). Returns the flash kernels'
    launches in it."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.observability import profile
    from elasticdl_tpu_torch.observability.registry import default_registry
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.trainer import Trainer
    from elasticdl_tpu_torch.worker.worker import Worker

    group_losses = []
    train_many = Trainer.train_many

    def recorded(self, state, stacked):
        state, logs = train_many(self, state, stacked)
        group_losses.append(logs["loss"])
        return state, logs

    with tempfile.TemporaryDirectory() as out:
        cfg = JobConfig.from_argv(lm_job_argv(out) + [
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
                                  name="lm-job-worker", daemon=True)
        reset_launches()
        Trainer.train_many = recorded
        t0 = time.perf_counter()
        thread.start()
        try:
            finished = master.wait(poll_s=0.2, timeout_s=600)
            counts = master.dispatcher.counts()
            results = master.evaluation.latest_results()
        finally:
            master.shutdown(grace_s=1)
            thread.join(300)
            Trainer.train_many = train_many
        wall_s = time.perf_counter() - t0
        launches = dict(fa.launches)
        after = reg.snapshot()
        phases = profile.get_profiler().snapshot(update_memory=False)
        traces = os.listdir(cfg.profile_dir)
        names = set()
        for trace in traces:
            with open(os.path.join(cfg.profile_dir, trace)) as f:
                events = json.load(f).get("traceEvents", [])
            names |= {e.get("name", "") for e in events
                      if e.get("cat") == "kernel"}

    steps = worker._global_step
    if not finished or rc != [0] or thread.is_alive():
        raise AssertionError(f"LM job did not finish cleanly: finished "
                             f"{finished}, worker exit {rc}")
    if counts["finished_training"] != 4 or counts["failed_permanently"]:
        raise AssertionError(f"dispatcher counts {counts}")
    acc = results.get("token_accuracy", np.nan)
    if not (np.isfinite(acc) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"eval results {results}")
    means = [float(x.mean()) for x in group_losses]
    if (steps != LM_JOB_STEPS or len(means) != LM_JOB_STEPS // LM_JOB_GROUP
            or not all(np.isfinite(means)) or not means[-1] < means[0]):
        raise AssertionError(f"{steps} train steps; group mean losses "
                             f"{means} not finite and falling")
    per_train = {fa.BWD_DQ_SM90: LM_LAYERS, fa.BWD_DKV_SM90: LM_LAYERS,
                 fa.BWD_DELTA_SM90: LM_LAYERS}
    want = {**{k: 0 for k in launches},
            **{k: v * LM_JOB_STEPS for k, v in per_train.items()},
            fa.FWD_SM90: LM_LAYERS * (LM_JOB_STEPS + LM_JOB_EVAL_STEPS)}
    if launches != want:
        raise AssertionError(f"flash launches in the LM job {launches}, "
                             f"want {want}")
    kernel = "flash_fwd_sm90_kernel"
    if len(traces) != 1 or not any(kernel in n for n in names):
        raise AssertionError(f"profiler traces {traces} name no {kernel} "
                             f"among {len(names)} device kernels")

    def delta(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    # grouped mode observes group seconds / group size once a group
    step_s = delta("edl_train_step_seconds_sum")
    groups = delta("edl_train_step_seconds_count")
    emit("lm_job", card=smi, params=LM_PARAMS, compute_dtype="bfloat16",
         batch=[LM_BATCH, LM_T], steps_per_dispatch=LM_JOB_GROUP,
         tasks=counts["finished_training"], train_steps=steps,
         counts=counts, eval=results, group_mean_losses=means,
         wall_s=wall_s, host_ms_per_step=step_s * 1e3 / groups,
         host_ms_per_group=step_s * 1e3 / groups * LM_JOB_GROUP,
         tokens_per_s=LM_BATCH * LM_T * groups / step_s,
         data_wait_ms_per_step=phases.get("phase_data_wait_ms", 0.0),
         h2d_ms_per_step=phases.get("phase_h2d_ms", 0.0),
         compute_ms_per_step=phases.get("phase_compute_ms", 0.0),
         launches={k: v for k, v in launches.items() if v},
         trace=traces[0], trace_kernels=len(names))
    return launches


# ---------------------------------------------------------------- MoE, GPipe


LM_DEF = "transformer.transformer_lm.custom_model"
MOE_EXPERTS, MOE_CAPACITY = 8, 1.25       # the layer's default capacity
MOE_PARAMS = f"{LM_PARAMS};moe_experts={MOE_EXPERTS}"
PP_PARAMS = f"{LM_PARAMS};pp_axis=pp;pp_microbatches=4;seq_parallel=none"
# the LM's width with 4 heads of 128 (K4' at D 128), as public decoder LMs
# shape their heads; train steps in all, the first a warm-up
LM_D128_PARAMS = "vocab=8192;num_layers=4;dim=512;heads=4;max_len=1024"
LM_D128_STEPS = 6
# the same width with 32 heads of 16, the head dim of the zoo LM's default
# configuration (dim 128, 8 heads), and with 16 heads of 32 (K2', K3' and
# K4' at D 16 and 32)
LM_D16_PARAMS = "vocab=8192;num_layers=4;dim=512;heads=32;max_len=1024"
LM_D32_PARAMS = "vocab=8192;num_layers=4;dim=512;heads=16;max_len=1024"
LM_NARROW_STEPS = 6
LM_F32_STEPS = 5


def hopper_launches(steps, evals=0, d=64, dtype=torch.bfloat16):
    """The flash kernels' launches over `steps` LM train steps and `evals`
    forward-only steps in `dtype` at head dim `d`, by the kernels `route`
    names: one of each a layer a step (on the bf16 Hopper route the delta
    pass once a backward, read by K3' and K4')."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    want = {name: 0 for name in fa.launches}
    fwd, bwd = fa.route(dtype, d)
    for name in bwd:
        want[name] = LM_LAYERS * steps
    want[fwd] = LM_LAYERS * (steps + evals)
    return want


def head_dim(params):
    """D of an LM's `model_params`: dim / heads."""
    fields = dict(kv.split("=") for kv in params.split(";"))
    return int(fields["dim"]) // int(fields["heads"])


def routing_stats(trainer, state, batch):
    """(each block's aux loss, the share of tokens dropped) of an eval
    forward over `batch`, from the routing `ops.moe.route` returns."""
    from elasticdl_tpu_torch.ops import moe as moe_ops

    seen, real = [], moe_ops.route

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        seen.append((float(r.aux), float((~r.keep).float().mean())))
        return r

    moe_ops.route = spy
    try:
        trainer.predict_step(state, batch)
    finally:
        moe_ops.route = real
    return [a for a, _ in seen], float(np.mean([d for _, d in seen]))


def lm_variant_train(params, name, smi, steps=STEPS, dtype="bfloat16"):
    """The LM variant `params` in `dtype` at `lm_train`'s width and batch:
    a warm-up step, then `steps` timed train steps, eval and predict;
    returns (trainer, state, the fields to emit, its flash launches)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.trainer import Trainer

    trainer = Trainer(load_spec(params, dtype, model_def=LM_DEF))  # card
    if trainer.device.type != "cuda":
        raise AssertionError(f"Trainer defaulted to {trainer.device}")
    batch = lm_batch(100)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(batch)
    reset_launches()
    losses = []
    state, logs = trainer.train_step(state, batch)          # warm-up step
    losses.append(logs["loss"])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, logs = trainer.train_step(state, batch)
        losses.append(logs["loss"])
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / steps
    train = dict(fa.launches)
    reset_launches()
    metric_states = trainer.eval_step(state, batch,
                                      trainer.new_metric_states())
    preds = trainer.predict_step(state, batch)
    torch.cuda.synchronize()
    forward = dict(fa.launches)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} losses not finite and falling: "
                             f"{losses}")
    d, kind = head_dim(params), getattr(torch, dtype)
    if train != hopper_launches(steps + 1, d=d, dtype=kind) or \
            forward != hopper_launches(0, evals=2, d=d, dtype=kind):
        raise AssertionError(f"{name}: flash launches {train} in {steps + 1}"
                             f" train steps, {forward} in eval and predict")
    if tuple(preds.shape) != (LM_BATCH, LM_T, LM_VOCAB) or not bool(
            torch.isfinite(preds).all()):
        raise AssertionError(f"{name} predictions {tuple(preds.shape)} "
                             "not finite")
    fields = dict(
        card=smi, params=params, batch=[LM_BATCH, LM_T],
        step_mode=step_mode(trainer),
        compute_dtype=dtype, steps=steps, losses=losses,
        first_loss=losses[0], last_loss=losses[-1], step_ms=step_ms,
        host_step_ms=host_s * 1e3 / steps,
        tokens_per_s=LM_BATCH * LM_T / (step_ms / 1e3),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches_per_step={k: v / (steps + 1) for k, v in train.items()
                           if v},
        eval=trainer.metric_results(metric_states))
    launches = {k: train[k] + forward[k] for k in train}
    return trainer, state, batch, fields, launches


def moe_layer_routes(smi):
    """One MoE layer at the LM's width (8192 tokens, C 512, H 2048, 8
    experts, capacity 1280) on the card, forward and backward by the index
    route (`switch_moe`) and by the dense plain route
    (`switch_moe_plain`): outputs, aux and the expert kernels' gradients
    equal bit for bit, the other gradients (sums in another order) within
    rtol 1e-6 with atol 1e-6 of each one's largest value; the time of
    each (CUDA events, fwd + bwd) beside the dense route's one-hot FLOPs,
    and each route's fwd + bwd FLOPs as `training.step_cost` counts them,
    whose difference must be the dense dispatch's 10 N E Cap C."""
    from elasticdl_tpu_torch.api.layers import MoE
    from elasticdl_tpu_torch.common import runtime
    from elasticdl_tpu_torch.ops import moe as moe_ops
    from elasticdl_tpu_torch.training import step_cost as cost_lib

    runtime.configure_torch_runtime()
    dev = runtime.resolve_device(None)       # the card
    n, c = LM_BATCH * LM_T, LM_DIM
    gen = torch.Generator(device=dev).manual_seed(5)
    layer = MoE(c, MOE_EXPERTS, 4 * c, residual=False).to(dev)
    layer.reset_parameters(gen)
    x = torch.randn((n, c), device=dev, generator=gen)
    g = torch.randn((n, c), device=dev, generator=gen)
    weights = [layer.router, layer.w1, layer.b1, layer.w2, layer.b2]
    leaves = [x.requires_grad_()] + weights

    def fwd_bwd(fn):
        out, aux = fn(x, *weights, capacity_factor=MOE_CAPACITY)
        return out, aux, torch.autograd.grad((out * g).sum() + aux, leaves)

    (o1, a1, g1), (o2, a2, g2) = (fwd_bwd(moe_ops.switch_moe),
                                  fwd_bwd(moe_ops.switch_moe_plain))
    if not (torch.equal(o1, o2) and torch.equal(a1, a2)):
        raise AssertionError("index and dense MoE routes differ")
    worst = 0.0
    for name, p, q in zip(("x", "router", "w1", "b1", "w2", "b2"), g1, g2):
        if name in ("w1", "b1", "w2"):
            if not torch.equal(p, q):
                raise AssertionError(f"{name} gradients differ by route")
            continue
        _, ratio = over_tol(p, q, 1e-6, 1e-6)
        worst = max(worst, ratio)
        if ratio > 1.0:
            raise AssertionError(f"{name} gradients differ by route "
                                 f"({ratio} of the tolerance)")
    cap = max(1, int(MOE_CAPACITY * n / MOE_EXPERTS))
    # the dense route's one-hot products, which the reference's step
    # computes and the index route does not: the dispatch and the combine
    # forward, dx, d(combine) and dy backward, 2 N E Cap C each
    counted = {}
    for route, fn in (("index", moe_ops.switch_moe),
                      ("dense", moe_ops.switch_moe_plain)):
        with cost_lib.StepCost() as cost:
            fwd_bwd(fn)
        counted[route] = cost.flops
    gap = counted["dense"] - counted["index"]
    if gap != 5 * 2 * n * MOE_EXPERTS * cap * c:
        raise AssertionError(f"the dense route counts {gap} FLOPs more than "
                             f"the index route")
    index_ms = time_ms(lambda: fwd_bwd(moe_ops.switch_moe), groups=7,
                       per_group=3, warmup=1)
    dense_ms = time_ms(lambda: fwd_bwd(moe_ops.switch_moe_plain), groups=7,
                       per_group=3, warmup=1)
    onehot_flops = 2 * n * MOE_EXPERTS * cap * c
    ffn_flops = 3 * 2 * 2 * MOE_EXPERTS * cap * c * 4 * c   # fwd + bwd
    return dict(tokens=n, experts=MOE_EXPERTS, capacity=cap,
                index_fwd_bwd_ms=index_ms, dense_fwd_bwd_ms=dense_ms,
                dense_over_index=dense_ms / index_ms,
                index_fwd_bwd_flops=counted["index"],
                dense_fwd_bwd_flops=counted["dense"],
                dense_dispatch_flops=gap,
                expert_ffn_gflop=ffn_flops / 1e9,
                one_hot_product_gflop=onehot_flops / 1e9,
                ffn_bound_ms=ffn_flops / F32_FLOPS * 1e3,
                worst_grad_err_over_tol=worst, card=smi)


def phase_lm_train_d128(smi):
    """The LM at `lm_train`'s width with 128-wide heads (LM_D128_PARAMS):
    a warm-up step and LM_D128_STEPS - 1 timed train steps, eval and
    predict, as `lm_variant_train` holds them: finite falling losses, K2',
    K3', K4' (at D 128) and the delta pass 4 times a train step and K2-K4
    never. Returns the flash kernels' launches."""
    _, _, _, fields, launches = lm_variant_train(
        LM_D128_PARAMS, "lm_train_d128", smi, steps=LM_D128_STEPS - 1)
    emit("lm_train_d128", **fields, head_dim=LM_DIM // 4)
    return launches


def phase_lm_train_f32(smi):
    """The LM at `lm_train`'s full width (LM_PARAMS: D 64) in float32 on
    `lm_train`'s batch: a warm-up step and LM_F32_STEPS timed train steps,
    eval and predict, as `lm_variant_train` holds them: finite falling
    losses; K2-tf32, K3-tf32, K4-tf32 and the delta pass 4 times a train
    step, K2-tf32 4 times in each of eval and predict, and K2-K4, K2', K3'
    and K4' never. Then its profile, as in `profile`. Returns the flash
    kernels' launches."""
    trainer, state, batch, fields, launches = lm_variant_train(
        LM_PARAMS, "lm_train_f32", smi, steps=LM_F32_STEPS, dtype="float32")
    emit("lm_train_f32", **fields, head_dim=head_dim(LM_PARAMS))
    phase_profile(trainer, state, batch, fields["step_ms"], model="lm_f32")
    return launches


def phase_lm_train_f32_d128(smi):
    """The LM at `lm_train`'s width with 128-wide heads (LM_D128_PARAMS)
    in float32 on `lm_train`'s batch: a warm-up step and LM_F32_STEPS
    timed train steps, eval and predict, as `lm_variant_train` holds
    them: finite falling losses; K2-tf32, K3-tf32, K4-tf32 and the delta
    pass 4 times a train step, K2-tf32 4 times in each of eval and
    predict, and K2-K4, K2', K3' and K4' never. Then its profile, as in
    `profile`. Returns the flash kernels' launches."""
    trainer, state, batch, fields, launches = lm_variant_train(
        LM_D128_PARAMS, "lm_train_f32_d128", smi, steps=LM_F32_STEPS,
        dtype="float32")
    emit("lm_train_f32_d128", **fields, head_dim=head_dim(LM_D128_PARAMS))
    phase_profile(trainer, state, batch, fields["step_ms"],
                  model="lm_f32_d128")
    return launches


def phase_lm_train_narrow(smi, params):
    """The LM at `lm_train`'s width with 16- or 32-wide heads (`params`,
    LM_D16_PARAMS or LM_D32_PARAMS): a warm-up step and LM_NARROW_STEPS - 1
    timed train steps, eval and predict, as `lm_variant_train` holds them:
    finite falling losses; K2', K3', K4' (at the narrow D) and the delta
    pass 4 times a train step, K2' 4 times in each of eval and predict,
    and K2, K3 and K4 never. Returns the flash kernels' launches."""
    d = head_dim(params)
    _, _, _, fields, launches = lm_variant_train(
        params, f"lm_train_d{d}", smi, steps=LM_NARROW_STEPS - 1)
    emit(f"lm_train_d{d}", **fields, head_dim=d)
    return launches


def phase_moe_train(smi):
    """The Switch-MoE LM (8 experts a block, capacity factor 1.25, aux
    weight 0.01) at `lm_train`'s width; then one MoE layer by both
    routes. Returns the flash kernels' launches."""
    trainer, state, batch, fields, launches = lm_variant_train(
        MOE_PARAMS, "moe_train", smi)
    aux, dropped = routing_stats(trainer, state, batch)
    buffers = [float(state.buffers[f"block_{i}.moe.moe_aux"])
               for i in range(LM_LAYERS)]
    if not (len(aux) == LM_LAYERS and all(np.isfinite(aux + buffers))
            and 0.0 <= dropped < 1.0):
        raise AssertionError(f"routing: aux {aux}, buffers {buffers}, "
                             f"dropped {dropped}")
    emit("moe_train", **fields, experts=MOE_EXPERTS,
         capacity_factor=MOE_CAPACITY,
         aux_loss_weight=trainer.spec.aux_loss_weight,
         aux_last_step=buffers, aux_eval=aux, dropped_share=dropped,
         layer_routes=moe_layer_routes(smi))
    # the experts' FFN runs in float32; the peak is the model's bf16
    step_cost("moe_lm", trainer, state, batch, fields["step_ms"],
              lambda: load_spec(MOE_PARAMS, model_def=LM_DEF), smi,
              batch_size=[LM_BATCH, LM_T])
    phase_profile(trainer, state, batch, fields["step_ms"], model="moe_lm")
    return launches


def phase_pp_train(smi):
    """The pipelined LM (`pp_axis=pp`, 4 microbatches) with no pp axis:
    the sequential fold of 4 stacked stages, at `lm_train`'s width. Then
    `tp_axis=model` with no mesh against the plain LM: one step from the
    same weights, loss and parameters bit for bit. Returns the flash
    kernels' launches."""
    from elasticdl_tpu_torch.training.trainer import Trainer

    trainer, state, batch, fields, launches = lm_variant_train(
        PP_PARAMS, "pp_train", smi)
    emit("pp_train", **fields, stages=LM_LAYERS, microbatches=4)
    phase_profile(trainer, state, batch, fields["step_ms"], model="pp_lm")
    del trainer, state
    gc.collect()
    steps = []
    for params in (LM_PARAMS, f"{LM_PARAMS};tp_axis=model"):
        tr = Trainer(load_spec(params, model_def=LM_DEF), seed=3)
        st = tr.init_state(batch)
        loss = float(tr.train_step(st, batch)[1]["loss"])
        steps.append((loss, {k: p.detach().clone()
                             for k, p in st.params.items()}))
    (l0, p0), (l1, p1) = steps
    if l0 != l1 or p0.keys() != p1.keys() or not all(
            torch.equal(p0[k], p1[k]) for k in p0):
        raise AssertionError(f"tp_axis without a mesh: loss {l1} against "
                             f"{l0}, or its parameters differ")
    emit("tp_no_mesh", card=smi, loss=l1, params=len(p1),
         bit_equal_to_plain=True)
    return launches


def phase_moe_job(smi):
    """The MoE LM through the job path in one process, as `lm_job` runs
    it (no profiler window), with interval checkpoints every 16 steps;
    the newest restores the final state exactly (the router, the experts
    and the `moe_aux` buffers included). Returns the flash launches."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.observability import profile
    from elasticdl_tpu_torch.observability.registry import default_registry
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer
    from elasticdl_tpu_torch.worker.worker import Worker

    with tempfile.TemporaryDirectory() as out:
        argv = lm_job_argv(out)
        cut = argv.index("--profile_dir")
        argv = argv[:cut] + argv[cut + 6:]
        argv[argv.index("--model_params") + 1] = MOE_PARAMS
        cfg = JobConfig.from_argv(argv + [
            "--checkpoint_dir", os.path.join(out, "ckpt"),
            "--checkpoint_steps", "16", "--keep_checkpoint_max", "2",
            "--master_addr", f"localhost:{free_port()}"])
        master = Master(cfg)
        master.start()
        worker = Worker(cfg)                # device defaulted: the GPU
        reg = default_registry()
        before = reg.snapshot()
        profile.get_profiler().reset()
        rc = []
        thread = threading.Thread(target=lambda: rc.append(worker.run()),
                                  name="moe-job-worker", daemon=True)
        reset_launches()
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
        launches = dict(fa.launches)
        after = reg.snapshot()
        phases = profile.get_profiler().snapshot(update_memory=False)
        steps = worker._global_step
        if not finished or rc != [0] or thread.is_alive():
            raise AssertionError(f"MoE job did not finish cleanly: finished"
                                 f" {finished}, worker exit {rc}")
        if counts["finished_training"] != 4 or counts["failed_permanently"]:
            raise AssertionError(f"dispatcher counts {counts}")
        acc = results.get("token_accuracy", np.nan)
        if steps != LM_JOB_STEPS or not (np.isfinite(acc)
                                         and 0.0 <= acc <= 1.0):
            raise AssertionError(f"{steps} steps, eval results {results}")
        if launches != hopper_launches(LM_JOB_STEPS, LM_JOB_EVAL_STEPS):
            raise AssertionError(f"flash launches in the MoE job {launches}")
        final = worker._state
        mngr = CheckpointManager(cfg.checkpoint_dir)
        if mngr.all_steps() != [16, 32]:
            raise AssertionError(f"checkpoint steps {mngr.all_steps()}")
        fresh = Trainer(ModelSpec.from_config(cfg)).init_state(None)
        if states_equal(fresh, final):
            raise AssertionError("a fresh state already equals the final one")
        if mngr.restore(fresh) is not fresh or not states_equal(fresh, final):
            raise AssertionError("newest checkpoint does not restore the "
                                 "final MoE state")
        aux = [float(fresh.buffers[f"block_{i}.moe.moe_aux"])
               for i in range(LM_LAYERS)]
        del fresh

    def delta(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    step_s = delta("edl_train_step_seconds_sum")
    groups = delta("edl_train_step_seconds_count")
    emit("moe_job", card=smi, params=MOE_PARAMS, compute_dtype="bfloat16",
         batch=[LM_BATCH, LM_T], steps_per_dispatch=LM_JOB_GROUP,
         tasks=counts["finished_training"], train_steps=steps,
         counts=counts, eval=results, token_accuracy=acc, wall_s=wall_s,
         host_ms_per_step=step_s * 1e3 / groups,
         tokens_per_s=LM_BATCH * LM_T * groups / step_s,
         data_wait_ms_per_step=phases.get("phase_data_wait_ms", 0.0),
         h2d_ms_per_step=phases.get("phase_h2d_ms", 0.0),
         compute_ms_per_step=phases.get("phase_compute_ms", 0.0),
         checkpoint_steps=[16, 32], restored_exactly=True,
         restored_moe_aux=aux,
         launches={k: v for k, v in launches.items() if v})
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


# ---------------------------------------------------------------- kubernetes

# a stand-in kubectl for one host, in front of the master's real
# KubectlApi: pods are local processes, their state files beside it
STANDIN_KUBECTL = r'''#!{python}
"""A stand-in kubectl for one host: a pod is a local process.

    kubectl -n NS apply -f -       start the pod manifest on stdin (YAML)
    kubectl -n NS get pods -l SEL --watch --output-watch-events -o json
    kubectl -n NS delete pod NAME [--ignore-not-found] [--wait=false]

A pod runs its container's command and args with the manifest's env; an
argument `<job>-master:<port>` becomes `127.0.0.1:<port>` (the cluster's
DNS) and the command `python` this interpreter (the image's). Its state
lives beside this file, in pods/: <name>.yaml (the manifest), .pid (the
container's process group), .sup (its supervisor), .log (its output),
.phases (one line a change, "<unix time> <phase>", Pending -> Running ->
Succeeded or Failed by exit code, DELETED last) and .deleting (the time
a delete came); `applied` lists the pods in the order they were applied.
A delete sends SIGTERM to the pod's process group and SIGKILL after
GRACE_S, Kubernetes' default grace period. The watch streams one JSON
document a change, {"type", "object": {"metadata", "status": {"phase"}}},
after an ADDED for each live pod, and exits when its parent does."""
import contextlib
import fcntl
import json
import os
import re
import signal
import subprocess
import sys
import time

import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
PODS = os.path.join(HERE, "pods")
GRACE_S = 30.0
SERVICE = re.compile(r"^[a-z0-9.-]+-master:(\d+)$")
TERMINAL = ("Succeeded", "Failed")


def path(name, ext):
    return os.path.join(PODS, name + ext)


@contextlib.contextmanager
def locked(name):
    with open(path(name, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def phases(name):
    """[[time, phase]] of pod `name`, whole lines only (a watch reads
    while a supervisor appends)."""
    try:
        with open(path(name, ".phases")) as f:
            return [line.split() for line in f
                    if line.endswith("\n") and len(line.split()) == 2]
    except FileNotFoundError:
        return []


def record(name, phase):
    with open(path(name, ".phases"), "a") as f:
        f.write(f"{time.time():.6f} {phase}\n")


def read_int(name, ext):
    try:
        with open(path(name, ext)) as f:
            return int(f.read())
    except (FileNotFoundError, ValueError):
        return None


def apply():
    manifest = yaml.safe_load(sys.stdin.read())
    name = manifest["metadata"]["name"]
    os.makedirs(PODS, exist_ok=True)
    with locked(name):
        seen = phases(name)
        if seen and seen[-1][1] != "DELETED":
            print(f"pod/{name} unchanged")
            return 0
        for ext in (".phases", ".pid", ".sup", ".deleting"):
            with contextlib.suppress(FileNotFoundError):
                os.remove(path(name, ext))
        with open(path(name, ".yaml.tmp"), "w") as f:
            yaml.safe_dump(manifest, f)
        os.replace(path(name, ".yaml.tmp"), path(name, ".yaml"))
        with open(os.path.join(HERE, "applied"), "a") as f:
            f.write(name + "\n")
        record(name, "Pending")
    sup = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "_run", name],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)
    with open(path(name, ".sup"), "w") as f:
        f.write(str(sup.pid))
    print(f"pod/{name} created")
    return 0


def deleting_since(name):
    try:
        with open(path(name, ".deleting")) as f:
            return float(f.read())
    except (FileNotFoundError, ValueError):
        return None


def run(name):
    """The pod's supervisor: start its container, record its phases."""
    with open(path(name, ".yaml")) as f:
        container = yaml.safe_load(f)["spec"]["containers"][0]
    command = list(container["command"])
    if command[0] == "python":
        command[0] = sys.executable
    argv = command + [SERVICE.sub(r"127.0.0.1:\1", a)
                      for a in container.get("args", [])]
    env = dict(os.environ)
    env.update({e["name"]: e["value"] for e in container.get("env", [])})
    with locked(name):
        if deleting_since(name) is not None:
            record(name, "DELETED")
            return 0
        with open(path(name, ".log"), "w") as log:
            proc = subprocess.Popen(argv, env=env, stdin=subprocess.DEVNULL,
                                    stdout=log, stderr=subprocess.STDOUT,
                                    start_new_session=True)
        with open(path(name, ".pid"), "w") as f:
            f.write(str(proc.pid))
        record(name, "Running")
    termed = False
    while proc.poll() is None:
        since = deleting_since(name)
        if since is not None:
            sig = (signal.SIGKILL if time.time() - since > GRACE_S
                   else None if termed else signal.SIGTERM)
            if sig is not None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, sig)
                termed = True
        time.sleep(0.1)
    with locked(name):
        if deleting_since(name) is not None:
            record(name, "DELETED")
        else:
            record(name, "Succeeded" if proc.returncode == 0 else "Failed")
    return 0


def delete(name):
    with locked(name):
        seen = phases(name)
        if not seen or seen[-1][1] == "DELETED":
            return 0      # --ignore-not-found
        with open(path(name, ".deleting"), "w") as f:
            f.write(f"{time.time():.6f}")
        if seen[-1][1] in TERMINAL:
            record(name, "DELETED")   # nothing runs: gone now
        # else the supervisor signals the container and records DELETED
    print(f'pod "{name}" deleted')
    return 0


def watch(selector):
    want = dict(kv.split("=", 1) for kv in selector.split(",") if kv)
    parent = os.getppid()
    emitted, labels, first = {}, {}, True
    while os.getppid() == parent:
        names = sorted(f[:-5] for f in (os.listdir(PODS) if os.path.isdir(
            PODS) else []) if f.endswith(".yaml"))
        for name in names:
            if name not in labels:
                with open(path(name, ".yaml")) as f:
                    labels[name] = yaml.safe_load(f)["metadata"].get(
                        "labels", {})
            if any(labels[name].get(k) != v for k, v in want.items()):
                continue
            seen = [p for _, p in phases(name)]
            done = emitted.get(name, 0)
            if done > len(seen):
                done = 0           # the name was applied again
            if first and name not in emitted:
                # the initial list: live pods as ADDED, at their phase
                if seen and seen[-1] != "DELETED":
                    docs = [("ADDED", seen[-1])]
                else:
                    docs = []
                done = len(seen)
            else:
                docs = []
                for i in range(done, len(seen)):
                    if seen[i] == "DELETED":
                        last = [p for p in seen[:i] if p != "DELETED"]
                        docs.append(("DELETED", last[-1] if last else "Unknown"))
                    else:
                        docs.append(("ADDED" if i == 0 else "MODIFIED", seen[i]))
                done = len(seen)
            emitted[name] = done
            for kind, phase in docs:
                try:
                    sys.stdout.write(json.dumps({"type": kind, "object": {
                        "metadata": {"name": name, "labels": labels[name]},
                        "status": {"phase": phase}}}) + "\n")
                    sys.stdout.flush()
                except BrokenPipeError:
                    return 0
        first = False
        time.sleep(0.1)
    return 0


def main(args):
    if args[:1] == ["_run"]:
        return run(args[1])
    if args[:1] == ["-n"]:
        args = args[2:]            # one namespace here
    if args[:3] == ["apply", "-f", "-"]:
        return apply()
    if args[:2] == ["get", "pods"] and "--watch" in args:
        return watch(args[args.index("-l") + 1])
    if args[:2] == ["delete", "pod"]:
        return delete(args[2])
    print(f"stand-in kubectl: unsupported {args}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
'''
K8S_JOB = "k8s-smoke"


def pod_phases(pods, name):
    """[(unix time, phase)] of pod `name` from the stand-in's state."""
    try:
        with open(os.path.join(pods, name + ".phases")) as f:
            return [(float(t), p) for t, p in
                    (line.split() for line in f if line.strip())]
    except FileNotFoundError:
        return []


def state_text(*path):
    """A file of the stand-in's state, or "" before it exists."""
    try:
        with open(os.path.join(*path), errors="replace") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def end_pods(pods, timeout_s=60.0):
    """Wait until every pod of the stand-in has ended (a deleted one gets
    its grace period), then kill what is left of them and their
    supervisors."""
    names = sorted(f[:-5] for f in os.listdir(pods) if f.endswith(".yaml"))
    deadline = time.time() + timeout_s
    while time.time() < deadline and not all(
            pod_phases(pods, n) and pod_phases(pods, n)[-1][1] in (
                "Succeeded", "Failed", "DELETED") for n in names):
        time.sleep(0.2)
    for name in names:
        # the container's process group, then its supervisor
        for ext, kill in ((".pid", os.killpg), (".sup", os.kill)):
            pid = state_text(pods, name + ext).strip()
            if pid:
                try:
                    kill(int(pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass


def phase_k8s_job(smi):
    """The DeepFM job through the Kubernetes path: the master started as
    its rendered pod would start (`render_job_manifests`, `--instance_manager
    k8s`), its real `KubectlApi` talking to the stand-in kubectl above,
    one training worker pod on the card, a checkpoint every task. Once a
    checkpoint is durable the worker pod's process is SIGKILLed: the
    manager must see it Failed, recover its lease and create the next
    generation, which resumes and finishes the job. Returns K1's launches
    over both pods."""
    from elasticdl_tpu_torch.client.k8s import render_job_manifests
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as out:
        kube = os.path.join(out, "kube")
        pods = os.path.join(kube, "pods")
        os.makedirs(pods)
        kubectl = os.path.join(kube, "kubectl")
        with open(kubectl, "w") as f:
            f.write(STANDIN_KUBECTL.replace("{python}", sys.executable, 1))
        os.chmod(kubectl, 0o755)
        # job_cli's depth: JOB_TASK records in 2 tasks of one step
        tasks, last_step = 2, JOB_TASK // BATCH
        cfg = JobConfig.from_argv(job_argv(out, JOB_TASK, tasks) + [
            "--job_name", K8S_JOB, "--image_name", "elasticdl-tpu-torch:smoke",
            "--instance_manager", "k8s", "--checkpoint_steps", "1",
            "--master_addr", f"localhost:{free_port()}"])
        manifests = render_job_manifests(cfg)
        kinds = [(m["kind"], m["metadata"]["name"]) for m in manifests]
        if kinds != [("Pod", f"{K8S_JOB}-master"),
                     ("Service", f"{K8S_JOB}-master")]:
            raise AssertionError(f"k8s_job: manifests {kinds}")
        master = manifests[0]["spec"]["containers"][0]
        command = list(master["command"])
        if command[0] == "python":
            command[0] = sys.executable
        # the master pod's environment; the image's is this machine's,
        # without the variables a polluted environment can carry
        env = {k: v for k, v in os.environ.items()
               if k not in COHORT_ENV + ("EDL_TORCH_DEVICE",)}
        env.update({e["name"]: e["value"] for e in master["env"]})
        env["PATH"] = os.pathsep.join(p for p in (kube, env.get("PATH")) if p)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO, env.get("PYTHONPATH")) if p)
        g0, g1 = (f"{K8S_JOB}-worker-0-g{g}" for g in (0, 1))
        mngr = CheckpointManager(cfg.checkpoint_dir)
        killed_at = g1_registered = g1_first_task = None
        master_log = os.path.join(out, "master.log")
        t0 = time.perf_counter()
        with open(master_log, "w") as log:
            proc = subprocess.Popen(
                command + master["args"], cwd=REPO, env=env,
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            while (proc.poll() is None
                   and time.perf_counter() - t0 < 600):
                if killed_at is None and mngr.latest_step() is not None:
                    pid = state_text(pods, g0 + ".pid").strip()
                    if pid:
                        os.kill(int(pid), signal.SIGKILL)
                        killed_at = mngr.latest_step()
                if killed_at is not None and g1_first_task is None:
                    text = state_text(pods, g1 + ".log")
                    if g1_registered is None and "registered as worker" in text:
                        g1_registered = time.time()
                    if TASK_LINE.search(text):
                        g1_first_task = time.time()
                time.sleep(0.1)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            end_pods(pods)
        wall_s = time.perf_counter() - t0
        with open(master_log, errors="replace") as f:
            log = f.read()
        applied = state_text(kube, "applied").split()
        problems = []
        if proc.returncode != 0:
            problems.append(f"master exit {proc.returncode}")
        if applied != [g0, g1]:
            problems.append(f"pods created {applied}")
        if killed_at is None:
            problems.append("no checkpoint to kill the worker pod after")
        failed = [t for t, p in pod_phases(pods, g0) if p == "Failed"]
        if not failed or f"pod {g0} Failed; relaunch 1/" not in log:
            problems.append(f"{g0}'s phases {pod_phases(pods, g0)}")
        devices, launches, steps = {}, {}, {}
        for name in applied:
            text = state_text(pods, name + ".log")
            device = re.search(r"registered as worker 0 .* on (\S+)", text)
            devices[name] = device.group(1) if device else None
            lines = TASK_LINE.findall(text)
            steps[name] = sum(int(x[0]) for x in lines)
            launches[name] = int(lines[-1][5]) if lines else 0
        if not all((d or "").startswith("cuda") for d in devices.values()):
            problems.append(f"devices {devices}")
        if not all(steps.values()) or any(
                launches[n] != placement.PASSES * steps[n] for n in launches):
            problems.append(f"K1 launched {launches} in {steps} train steps")
        saved = mngr.all_steps()
        if not saved or max(saved) != last_step:
            problems.append(f"checkpoint steps {saved}, the job's last "
                            f"{last_step}")
        finished = re.findall(r"job finished: (\{.*?\}) mean_loss", log)
        counts = ast.literal_eval(finished[-1]) if finished else {}
        if counts.get("finished_training") != tasks or counts.get(
                "failed_permanently"):
            problems.append(f"counts {counts}")
        try:
            export_matches(out, None, criteo_batch(8))
        except Exception as e:     # reported with the logs below
            problems.append(f"export does not load: {e!r}")
        if problems:
            for name in applied:
                print(f"--- {name}", state_text(pods, name + ".log")[-4000:],
                      file=sys.stderr, flush=True)
            print("--- master", log[-6000:], file=sys.stderr, flush=True)
            raise AssertionError("k8s_job: " + "; ".join(problems))
    emit("k8s_job", card=smi, wall_s=wall_s, pods=applied,
         killed_after_step=killed_at, checkpoint_steps=saved,
         relaunch_s={"failed_to_registered": g1_registered - failed[0],
                     "failed_to_first_task_done": g1_first_task - failed[0]},
         devices=devices, train_steps=steps, k1_launches=launches,
         counts=counts)
    return sum(launches.values())


def phase_zoo_init(smi):
    """`zoo init` into a temporary directory, then one train step of the
    template's model on the card through the port's ModelSpec."""
    from elasticdl_tpu_torch.client import main as client_main
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory() as zoo_dir:
        rc = client_main.main(["zoo", "init", "--model_zoo", zoo_dir])
        files = sorted(os.listdir(zoo_dir))
        try:
            spec = ModelSpec.from_config(JobConfig.from_argv([
                "--model_zoo", zoo_dir, "--model_def",
                "my_model.custom_model"]))
        finally:
            sys.modules.pop("my_model", None)
        trainer = Trainer(spec)
        state = trainer.init_state(None)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        r = np.random.RandomState(0)
        batch = {"features": r.randn(BATCH, 8).astype(np.float32),
                 "labels": r.randint(0, 2, (BATCH,)).astype(np.int32)}
        state, logs = trainer.train_step(state, batch)
        loss = float(logs["loss"])
        moved = max(float((state.params[k].detach() - before[k]).abs().max())
                    for k in before)
    device = str(trainer.device)
    if (rc != 0 or files != ["Dockerfile", "my_model.py"]
            or not device.startswith("cuda") or not math.isfinite(loss)
            or not 0 < moved <= 2e-3):
        raise AssertionError(f"zoo_init: rc {rc}, files {files}, device "
                             f"{device}, loss {loss}, moved {moved}")
    emit("zoo_init", card=smi, files=files, device=device, batch=BATCH,
         loss=loss, largest_param_step=moved)


# ---------------------------------------------------------------- tools

# the fleet soak the phase runs: 64 workers, 600 virtual seconds, the
# autoscaler on a straggler wave (no embedding layout, so no store)
TOOLS_SCENARIO = "straggler_wave"


def tool_env():
    """The environment of a tool or job subprocess: this checkout on the
    path, no cohort variables, no device request but WORKER_ENV's."""
    env = {k: v for k, v in os.environ.items()
           if k not in COHORT_ENV + ("EDL_TORCH_DEVICE",)}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.update(WORKER_ENV)
    return env


def start_tool(argv, out_path):
    """Start `python -m <argv>` from the checkout, its stdout into
    `out_path` (stderr too unless JSON comes on stdout); returns (proc,
    its stdout file, the thread that waits for it and notes its wall)."""
    out = open(out_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=REPO, env=tool_env(), stdout=out,
        stderr=subprocess.DEVNULL if "--json" in argv else subprocess.STDOUT,
        text=True, start_new_session=True)
    wall = []
    waiter = threading.Thread(
        target=lambda: (proc.wait(), wall.append(time.perf_counter() - t0)),
        daemon=True)
    waiter.start()
    return proc, out, waiter, wall


def end_tool(name, started, timeout_s=300):
    """Wait for a tool started by `start_tool`: (wall s, its stdout). A
    tool that does not end in time is killed, and one that exits non-zero
    fails."""
    proc, out, waiter, wall = started
    waiter.join(timeout_s)
    out.close()
    if waiter.is_alive():
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError(f"tools: {name} did not end in {timeout_s} s")
    wall_s = wall[0]
    with open(out.name, errors="replace") as f:
        text = f.read()
    if proc.returncode != 0:
        print(text[-8000:], file=sys.stderr, flush=True)
        raise AssertionError(f"tools: {name} exited {proc.returncode}")
    return wall_s, text


def rio_k1_stream(rio_dir, dev):
    """K1 on the stream of the first .rio batch: BATCH records read back by
    the port's reader, parsed by DeepFM's dataset_fn and hashed as the
    model hashes them, sorted; held as `kernel` holds K1."""
    from elasticdl_tpu_torch.data.reader import create_data_reader
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm
    from elasticdl_tpu_torch.ops import embedding as emb

    reader = create_data_reader(rio_dir)
    shard = reader.create_shards()[0]
    records = list(reader.read_records(shard[0], shard[1],
                                       min(shard[2], shard[1] + BATCH)))
    features, _ = deepfm.dataset_fn("training", reader.metadata)(records)
    spec = deepfm.feature_spec(FIELD_VOCAB)
    ids = spec.device_transform(
        {"dense": torch.from_numpy(features["dense"]).to(dev),
         "cat": torch.from_numpy(features["cat"]).to(dev)})["cat"].reshape(-1)
    rows = torch.randn((ids.numel(), 17), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    return k1_stream(torch.sort(ids, stable=True)[0].contiguous(), rows,
                     emb.padded_vocab(spec.total_vocab), dev)


def phase_tools(dev, smi, job):
    """The port's tooling beside the job path: `.rio` shards written by
    `data/convert.convert_url` at the `job` phase's record count and
    layout, the DeepFM job over them through the CLI (a subprocess worker
    on the card, K1 in every step's backward), K1 on the shards' stream
    against its plain version, `analyze` over the job's trace and
    `incident --strict` over its flight bundles, and, started first and
    running meanwhile on the host, edl-lint over the port's tree and one
    fleetsim scenario. Returns K1's launches in the job."""
    from elasticdl_tpu_torch.data.convert import convert_url
    from elasticdl_tpu_torch.ops import placement

    with tempfile.TemporaryDirectory() as out:
        lint = start_tool(["elasticdl_tpu_torch.analysis"],
                          os.path.join(out, "lint.txt"))
        soak = start_tool(["elasticdl_tpu_torch.fleetsim", TOOLS_SCENARIO,
                           "--json", "--artifacts",
                           os.path.join(out, "soak")],
                          os.path.join(out, "soak.json"))

        rio_dir = os.path.join(out, "rio")
        n = 4 * JOB_TASK
        t0 = time.perf_counter()
        shards = convert_url(f"synthetic://criteo?n={n}&shards=4", rio_dir,
                             records_per_shard=JOB_TASK)
        convert_s = time.perf_counter() - t0
        rio_bytes = sum(os.path.getsize(p) for p in shards)
        if len(shards) != 4:
            raise AssertionError(f"convert wrote {len(shards)} shards")
        k1 = rio_k1_stream(rio_dir, dev)
        if not k1["ok"]:
            emit("tools", card=smi, rio_k1=k1)
            raise AssertionError("K1 disagrees with its plain version (or "
                                 "with itself) on the .rio stream")

        argv = job_argv(out, n, 4)
        argv[argv.index("--training_data") + 1] = rio_dir
        argv += ["--master_addr", "localhost:0",
                 "--trace_dir", os.path.join(out, "trace")]
        env = tool_env()
        # both processes leave their flight bundle at a clean exit
        env["EDL_FLIGHT_DUMP_ON_EXIT"] = "1"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.client.main",
             "train", *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        job_s = time.perf_counter() - t0
        tasks = TASK_LINE.findall(log)
        steps = sum(int(t[0]) for t in tasks)
        # a task line carries the process's launches so far
        launches = int(tasks[-1][5]) if tasks else 0
        device = re.search(r"registered as worker 0 .* on (\S+)", log)
        problems = []
        if proc.returncode != 0:
            problems.append(f"exit {proc.returncode}")
        if len(tasks) != 4 or steps != 8:
            problems.append(f"{len(tasks)} task lines over {steps} steps")
        if launches != placement.PASSES * steps:
            problems.append(f"K1 launched {launches} kernels in {steps} "
                            "steps")
        if not device or not device.group(1).startswith(
                WORKER_ENV.get("EDL_TORCH_DEVICE", "cuda")):
            problems.append("the worker's log names no cuda device")
        if problems:
            print(log[-8000:], file=sys.stderr, flush=True)
            raise AssertionError("tools: " + "; ".join(problems))
        per_step = [(int(t[0]), float(t[3]), float(t[4])) for t in tasks]

        def mean_ms(i, rows):
            return sum(r[0] * r[i] for r in rows) / sum(r[0] for r in rows)

        t0 = time.perf_counter()
        analyze = subprocess.run(
            [sys.executable, "-m", "elasticdl_tpu_torch.observability.analyze",
             os.path.join(out, "trace"), "--json", "--strict"], cwd=REPO,
            env=tool_env(), capture_output=True, text=True, timeout=300)
        analyze_s = time.perf_counter() - t0
        flight_dir = os.path.join(out, "ckpt", "flight")
        t0 = time.perf_counter()
        incident = subprocess.run(
            [sys.executable, "-m",
             "elasticdl_tpu_torch.observability.incident", flight_dir,
             "--strict", "--json"], cwd=REPO, env=tool_env(),
            capture_output=True, text=True, timeout=300)
        incident_s = time.perf_counter() - t0
        for name, done in (("analyze", analyze), ("incident", incident)):
            if done.returncode != 0:
                print(done.stdout[-4000:], done.stderr[-4000:],
                      file=sys.stderr, flush=True)
                raise AssertionError(f"tools: {name} exited "
                                     f"{done.returncode}")
        trace = json.loads(analyze.stdout)
        report = json.loads(incident.stdout)
        roles = sorted(b["role"] for b in report["bundles"])
        if "master" not in roles or "worker-0" not in roles:
            raise AssertionError(f"tools: flight bundles of {roles}")

        # exit 0: no finding of the lint; the soak's replay identical, no
        # acknowledged lease lost and its incident check clean
        lint_s, _ = end_tool("edl-lint", lint)
        soak_s, soak_out = end_tool("fleetsim", soak)
        soak_result = json.loads(soak_out)
    emit("tools", card=smi, records=n, rio_shards=len(shards),
         rio_bytes=rio_bytes, convert_s=convert_s,
         job={"exit": proc.returncode, "wall_s": job_s, "tasks": len(tasks),
              "steps": steps, "device": device.group(1),
              "k1_launches": launches,
              "data_wait_ms_per_step": mean_ms(1, per_step),
              "h2d_ms_per_step": mean_ms(2, per_step),
              "data_wait_ms_per_step_past_first_task": mean_ms(
                  1, per_step[1:]),
              "h2d_ms_per_step_past_first_task": mean_ms(2, per_step[1:])},
         synthetic_job={k: job[k] for k in ("data_wait_ms_per_step",
                                            "h2d_ms_per_step")},
         rio_k1={k: k1[k] for k in ("n", "max_abs_err", "max_rel_err",
                                    "bit_identical_rerun", "ms", "plain_ms",
                                    "bound_ms", "library_ms")},
         analyze={"exit": analyze.returncode, "wall_s": analyze_s,
                  "files": len(trace["files"]), "records": trace["records"]},
         incident={"exit": incident.returncode, "wall_s": incident_s,
                   "bundles": roles,
                   "timeline_entries": len(report["timeline"])},
         lint={"exit": 0, "wall_s": lint_s, "findings": 0},
         fleetsim={"exit": 0, "wall_s": soak_s, "scenario": TOOLS_SCENARIO,
                   "workers": soak_result["workers_total"],
                   "event_log_digest": soak_result["event_log_digest"],
                   "incident_strict_rc": soak_result["incident_strict_rc"]})
    return launches, k1


# ---------------------------------------------------------------- manual


MANUAL_SHARDS = (2, 4)


def phase_manual_shards(dev, smi):
    """The manual schedule's per-rank compute at DeepFM's full width, each
    simulated rank of N in MANUAL_SHARDS on the card in this one process:
    its forward part (`embedding.shard_part`) and its backward, K1 on the
    shard (`embedding.shard_part_grad`). Returns K1's launches in the
    shards' backward passes (one a shard)."""
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm
    from elasticdl_tpu_torch.ops import embedding as emb
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    spec = deepfm.feature_spec(FIELD_VOCAB)
    num_rows, d = emb.padded_vocab(spec.total_vocab), 17
    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.rand((num_rows, d), generator=gen, device=dev) * 0.05
    cat = torch.from_numpy(criteo_batch(9, BATCH)["features"]["cat"]).to(dev)
    ids = spec.device_transform(
        {"dense": torch.zeros((BATCH, 13), device=dev), "cat": cat}
    )["cat"].to(torch.int32)                                  # (8192, 26)
    ct = torch.randn(tuple(ids.shape) + (d,), generator=gen, device=dev)
    whole = emb.embedding_lookup(table, ids)
    full_ids, full_rows = emb.sorted_stream(ids, ct)
    full = placement.place_sorted_grads(full_ids, full_rows, num_rows)
    full_mag = placement.place_sorted_grads_plain(full_ids, full_rows.abs(),
                                                  num_rows)
    n = full_ids.numel()
    placement.launches = 0
    grads = {}
    for count in MANUAL_SHARDS:
        for r in range(count):
            rows = mesh_lib.shard_rows(r, count, num_rows)
            grads[count, r] = emb.shard_part_grad(ids, ct, rows.start,
                                                  rows.size)
    torch.cuda.synchronize()
    launches = placement.launches

    report = {}
    for count in MANUAL_SHARDS:
        parts, shards = [], []
        for r in range(count):
            rows = mesh_lib.shard_rows(r, count, num_rows)
            parts.append(emb.shard_part(table[rows.start:rows.stop], ids,
                                        rows.start))
            local, owned = emb.shard_ids(ids, rows.start, rows.size)
            sid, srows = emb.sorted_stream(local, ct)
            got = grads[count, r]
            again = placement.place_sorted_grads(sid, srows, rows.size)
            want = placement.place_sorted_grads_plain(sid, srows, rows.size)
            mag = placement.place_sorted_grads_plain(sid, srows.abs(),
                                                     rows.size)
            err = (got - want).abs()
            ok = (bool((err <= 1e-6 + 1e-5 * mag).all())
                  and bool(torch.equal(got, again)))
            shards.append({
                "rows": [rows.start, rows.stop], "owned_ids": int(owned.sum()),
                "max_abs_err": float(err.max()), "ok": ok,
                "ms": time_ms(lambda: placement.place_sorted_grads(
                    sid, srows, rows.size)),
                "device_ms": device_ms(lambda: placement.place_sorted_grads(
                    sid, srows, rows.size), K1_SYMBOLS),
                "plain_ms": time_ms(
                    lambda: placement.place_sorted_grads_plain(
                        sid, srows, rows.size), groups=5, per_group=3),
                "bound_ms": k1_bound_ms(n, int(owned.sum()), rows.size,
                                        d)})
            if not ok:
                emit("manual_shards", shards=shards)
                raise AssertionError(f"K1 on shard {r} of {count} disagrees "
                                     "with its plain version (or itself)")
        total = torch.stack(parts).sum(0)
        forward_equal = bool(torch.equal(total, whole))
        cat_err = (torch.cat([grads[count, r] for r in range(count)])
                   - full).abs()
        if not forward_equal or not bool(
                (cat_err <= 1e-6 + 1e-5 * full_mag).all()):
            raise AssertionError(
                f"{count} shards: forward bit-equal {forward_equal}, "
                f"gradient off the one-device K1 by {float(cat_err.max())}")
        report[count] = {"shards": shards,
                         "max_abs_err_vs_one_device": float(cat_err.max())}
    if launches != placement.PASSES * sum(MANUAL_SHARDS):
        raise AssertionError(f"K1 launched {launches} kernels over "
                             f"{sum(MANUAL_SHARDS)} shards, want "
                             f"{placement.PASSES} a shard")
    one = {"ms": time_ms(lambda: placement.place_sorted_grads(
               full_ids, full_rows, num_rows)),
           "device_ms": device_ms(lambda: placement.place_sorted_grads(
               full_ids, full_rows, num_rows), K1_SYMBOLS),
           "bound_ms": k1_bound_ms(n, n, num_rows, d)}
    emit("manual_shards", card=smi, table=[num_rows, d], ids=[BATCH, 26],
         one_device=one, shards=report, k1_launches=launches,
         forward_bit_equal=True)
    return launches


# ---------------------------------------------------------------- tier


# the reference bench leg's configuration (bench.py:1371-1387): one table
# `users` of 262,144 x 32 float32 (seed 3) on 8 shards and 8 owners,
# batches of 4096 x 16 ids drawn zipf(1.3) % vocab from RandomState(7),
# TIER_STEPS steps after a warm-up; its reshard scenario's table and ids
# (bench.py:1812-1843)
TIER_VOCAB, TIER_DIM, TIER_SHARDS = 262_144, 32, 8
TIER_BATCH, TIER_LEN, TIER_STEPS, TIER_ZIPF = 4096, 16, 8, 1.3
TIER_LR = 0.1
# the session's shards against the dense replay (see phase_tier)
TIER_RTOL, TIER_ATOL_OF_MAX = 1e-5, 1e-6


def tier_view(spec, num_shards, owners):
    from elasticdl_tpu_torch.embedding import sharding

    return sharding.ShardMapView(
        version=1, num_shards=num_shards, tables=(spec,),
        owners=tuple(sharding.assign_round_robin(num_shards, owners)))


def tier_lane(spec, num_shards, owners, device, dedupe):
    """A client over `owners` stores (device mode on `device`, host mode
    for device=False) of one table, over LocalTransport."""
    from elasticdl_tpu_torch.embedding import store, tier, transport

    view = tier_view(spec, num_shards, owners)
    tr = transport.LocalTransport()
    for o in owners:
        st = store.EmbeddingShardStore(o, device=device)
        st.attach(view)
        tr.register(st)
    client = tier.EmbeddingTierClient(lambda: view, tr, client_id="smoke",
                                      dedupe=dedupe)
    return view, tr, client


def tier_table(spec, view, tr):
    """The dense (vocab, dim) table assembled from its shards (shard s
    holds ids s, s + S, ...)."""
    out = np.zeros((spec.vocab, spec.dim), np.float32)
    for s in range(view.num_shards):
        rows = tr.store_of(view.owners[s]).extract_shard(spec.name, s)["rows"]
        out[np.arange(s, spec.vocab, view.num_shards)] = rows
    return out


def quantile_ms(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3


def tier_serving(spec, ids):
    """The serving lanes, as bench.py's `_et_serving_loops` runs them: the
    single-host lane (1 shard, no dedupe, a push per occurrence) in host
    mode, and the sharded deduped lane in device mode on the card and in
    host mode. Returns the report, the device lane's final table, K1's
    launches in its pushes and the shard pushes it made, and shard 0's
    first push (local ids as sent, rows) for the kernel measurement."""
    from elasticdl_tpu_torch.embedding import tier as tier_lib
    from elasticdl_tpu_torch.ops import placement

    report, tables = {}, {}
    first_push = {}
    for name, shards, owners, device, dedupe in (
            ("single_host", 1, [0], False, False),
            ("sharded_device", TIER_SHARDS, list(range(TIER_SHARDS)),
             True, True),
            ("sharded_host", TIER_SHARDS, list(range(TIER_SHARDS)),
             False, True)):
        view, tr, client = tier_lane(spec, shards, owners, device, dedupe)
        pulls, pushes, shard_pushes = [], [], 0
        launches_before = placement.launches
        for step in range(TIER_STEPS + 1):      # step 0: the warm-up
            if step == 1:
                pulls.clear()
                pushes.clear()
            t = time.perf_counter()
            if dedupe:
                rows, _, uniq = client.pull_unique("users", ids)
            else:
                vec = client.pull("users", ids)
            pulls.append(time.perf_counter() - t)
            t = time.perf_counter()
            if dedupe:
                g = rows * np.float32(0.1)      # per-unique-row gradients
                client.push("users", uniq, g, scale=-0.01)
                real = uniq[uniq >= 0]
                shard_pushes += len(np.unique(real % shards))
                if step == 0 and device:
                    sel = real % shards == 0
                    local = (real[sel] // shards).astype(np.int32)
                    n = tier_lib.pad_pow2(local.size)
                    pid = np.full((n,), -1, np.int32)
                    pid[: local.size] = local
                    prow = np.zeros((n, spec.dim), np.float32)
                    prow[: local.size] = g[uniq >= 0][sel]
                    first_push["ids"], first_push["rows"] = pid, prow
            else:
                g = vec.reshape(-1, spec.dim) * np.float32(0.1)
                client.push("users", ids, g, scale=-0.01)
            pushes.append(time.perf_counter() - t)
        wall = sum(pulls) + sum(pushes)
        report[name] = {
            "mode": "device" if device else "host",
            "rows_per_s": ids.size * TIER_STEPS / wall,
            "pull_p50_ms": quantile_ms(pulls, 0.5),
            "pull_p99_ms": quantile_ms(pulls, 0.99),
            "push_p50_ms": quantile_ms(pushes, 0.5),
            "push_p99_ms": quantile_ms(pushes, 0.99)}
        if device:
            torch.cuda.synchronize()
            launches = placement.launches - launches_before
            report[name].update(k1_launches=launches,
                                shard_pushes=shard_pushes)
            device_launches, device_pushes = launches, shard_pushes
        if name != "single_host":
            tables[name] = tier_table(spec, view, tr)
        client.close()
    report["sharded_bit_equal_device_vs_host"] = bool(np.array_equal(
        tables["sharded_device"], tables["sharded_host"]))
    return report, device_launches, device_pushes, first_push


def k1_on_push(ids_np, rows_np, num_rows, dev):
    """K1 on one shard's push as the store runs it (`scatter_add_dense`:
    the pow2 padding's -1 sentinels go out of range, the stream is sorted,
    K1 places it): held to its plain version as `kernel` holds it, a
    bit-identical rerun, ms, device ms and bound; `index_add_` on the
    in-range ids only; and the whole push's device work (`rows + scale *
    delta`, out of place) with its bound."""
    from elasticdl_tpu_torch.ops import embedding as emb

    ids = torch.from_numpy(ids_np).to(dev)
    rows = torch.from_numpy(rows_np).to(dev)
    in_range = (ids >= 0) & (ids < num_rows)
    safe = torch.where(in_range, ids, emb.OOB_ID)
    sid, srows = emb.sorted_stream(safe, torch.where(in_range[:, None],
                                                     rows, 0))
    entry = k1_stream(sid, srows, num_rows, dev)
    n, d = rows.shape
    kept = int(in_range.sum())
    ids64 = ids[in_range].to(torch.int64)
    kept_rows = rows[in_range]
    entry["in_range_ids"] = kept
    entry["library_ms"] = time_ms(
        lambda: torch.zeros((num_rows, d), device=dev).index_add_(
            0, ids64, kept_rows))
    tab = torch.rand((num_rows, d), device=dev)
    scale = torch.tensor(-0.01, device=dev)

    def push():
        return tab + scale * emb.scatter_add_dense(ids, rows, num_rows)

    entry["push_ms"] = time_ms(push)
    # the whole push: K1's bytes, then one more read of the shard and of
    # the delta and one more write (an out-of-place update, fused)
    entry["push_bound_ms"] = (
        entry["bound_ms"] + 3 * num_rows * d * 4 / HBM_BYTES_PER_S * 1e3)
    return entry


def flagship_push(dev):
    """Shard 0's push of one deduped batch of 8192 x 26 hashed DeepFM ids
    (drawn as the `kernel` phase draws them) into a tier table of DeepFM's
    geometry (`tier_table_spec`, 2,605,056 x 17) on 8 shards: (local ids
    padded as the client pads them, rows, shard rows)."""
    from elasticdl_tpu_torch.api.layers import tier_table_spec
    from elasticdl_tpu_torch.embedding import sharding
    from elasticdl_tpu_torch.embedding import tier as tier_lib
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm

    fspec = deepfm.feature_spec(FIELD_VOCAB)
    spec = tier_table_spec("deepfm", fspec.total_vocab, 17)
    cat = torch.from_numpy(criteo_batch(7)["features"]["cat"])
    hashed = fspec.device_transform(
        {"dense": torch.zeros((BATCH, 13)), "cat": cat})["cat"].numpy()
    uniq = np.unique(hashed.reshape(-1))
    local = (uniq[uniq % TIER_SHARDS == 0] // TIER_SHARDS).astype(np.int32)
    n = tier_lib.pad_pow2(local.size)
    ids = np.full((n,), -1, np.int32)
    ids[: local.size] = local
    rows = np.random.RandomState(1).randn(n, 17).astype(np.float32)
    return ids, rows, sharding.shard_row_count(spec.vocab, TIER_SHARDS), spec


def tier_session(spec, ids, labels, dev):
    """EmbeddingTierSession.step with a TierEmbedding (sum) logistic loss
    (the logit is the pooled vector's mean, labels from the batch's seed)
    over the deduped batch, TIER_STEPS steps at TIER_LR on the 8 device
    shards, against a dense float32 replay of the same updates on the
    card. Returns the report and K1's launches a step."""
    from torch.nn import functional as F

    from elasticdl_tpu_torch.api.layers import TierEmbedding
    from elasticdl_tpu_torch.embedding import tier as tier_lib
    from elasticdl_tpu_torch.ops import placement

    view, tr, client = tier_lane(spec, TIER_SHARDS, list(range(TIER_SHARDS)),
                                 True, True)
    dense = torch.from_numpy(tier_table(spec, view, tr)).to(dev)
    session = tier_lib.EmbeddingTierSession(client, {"users": "ids"})
    layer = TierEmbedding(spec.dim, "sum")
    batch = {"ids": ids, "y": labels}

    def loss_fn(vectors, inverses, b):
        pooled = layer(vectors["users"], b["ids"], inverse=inverses["users"])
        return F.binary_cross_entropy_with_logits(pooled.mean(-1), b["y"])

    real = ids.reshape(-1)
    shards_pushed = len(np.unique(np.unique(real) % TIER_SHARDS))
    tid, ty = torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)
    losses, dense_losses, per_step, step_ms = [], [], [], []
    for _ in range(TIER_STEPS):
        before = placement.launches
        t = time.perf_counter()
        loss, _ = session.step(loss_fn, batch, lr=TIER_LR)
        step_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        per_step.append(placement.launches - before)
        losses.append(loss)
        # the dense replay: the same loss over the whole table's rows
        table = dense.clone().requires_grad_(True)
        dl = F.binary_cross_entropy_with_logits(
            table[tid].sum(1).mean(-1), ty)
        (g,) = torch.autograd.grad(dl, table)
        dense_losses.append(float(dl.detach()))
        with torch.no_grad():
            dense = dense + torch.tensor(-TIER_LR, device=dev) * g
    got = tier_table(spec, view, tr)
    want = dense.cpu().numpy()
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    ok = bool((err <= TIER_RTOL * np.abs(want)
               + TIER_ATOL_OF_MAX * scale).all())
    want_launches = placement.PASSES * (1 + shards_pushed)
    report = {
        "losses": losses, "dense_losses": dense_losses,
        "max_abs_err": float(err.max()),
        "max_err_over_largest_row": float(err.max()) / scale,
        "tolerance": {"rtol": TIER_RTOL, "atol_of_max": TIER_ATOL_OF_MAX},
        "k1_launches_per_step": per_step,
        "want_k1_launches_per_step": want_launches,
        "host_ms_per_step": step_ms, "within_tolerance": ok}
    client.close()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"tier session losses not finite: {losses}")
    if not ok:
        raise AssertionError(f"tier session off its dense replay: {report}")
    if per_step != [want_launches] * TIER_STEPS:
        raise AssertionError(f"K1 launched {per_step} kernels a session "
                             f"step, want {want_launches} (backward + "
                             f"{shards_pushed} shard pushes)")
    return report, per_step


def tier_reshard(spec, ids):
    """The kill-worker resharding under the port's Master with
    `--embedding_shards 8` behind gRPC and three WorkerTierRuntimes in
    device mode on the card: push, drain the victim, deregister it, mark
    it dead, and run the survivors' `on_world_change`. Returns the
    report and K1's launches (its pushes)."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.embedding import tier as tier_lib
    from elasticdl_tpu_torch.embedding.transport import LocalTransport
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.proto.service import MasterStub, make_channel
    from elasticdl_tpu_torch.training import compile_cache as cc

    with tempfile.TemporaryDirectory() as out:
        cfg = JobConfig.from_argv([
            "--model_zoo", ZOO, "--model_def", "deepfm.deepfm.custom_model",
            "--embedding_shards", str(TIER_SHARDS),
            "--checkpoint_dir", os.path.join(out, "ckpt"),
            "--master_addr", f"localhost:{free_port()}"])
        master = Master(cfg)
        master.embedding.register_table(spec)
        master.start()
        channel = make_channel(cfg.master_addr)
        stub = MasterStub(channel)
        runtimes = {}
        launches = placement.launches
        try:
            wids = [stub.RegisterWorker(pb.RegisterWorkerRequest(
                worker_name=f"tier-{i}")).worker_id for i in range(3)]
            shared = LocalTransport()
            for w in wids:
                runtimes[w] = tier_lib.WorkerTierRuntime(
                    stub, w, checkpoint_dir=cfg.checkpoint_dir,
                    transport=shared)
            view = runtimes[wids[0]].client.view
            client = runtimes[wids[0]].client
            uniq = np.unique(ids)
            for i in range(2):               # every shard's programs built
                client.pull_unique("users", ids)
                g = np.random.RandomState(100 + i).rand(
                    len(uniq), spec.dim).astype(np.float32)
                client.push("users", uniq, g, scale=-0.01)
            before = tier_table(spec, view, shared)
            misses = cc.global_cache().stats()["misses"]
            victim = wids[-1]
            moved = [s for s, o in enumerate(view.owners) if o == victim]
            last_seq = shared.store_of(victim).extract_shard(
                "users", moved[0])["applied"][client.client_id]
            t0 = time.perf_counter()
            runtimes[victim].drain()
            shared.deregister(victim)
            master.membership.mark_dead(victim, reason="chip_smoke kill")
            for w in wids[:-1]:
                runtimes[w].on_world_change()
            recovery_s = time.perf_counter() - t0
            final = master.embedding.view()
            bit_exact = bool(np.array_equal(tier_table(spec, final, shared),
                                            before))
            dedupes = shared.push(
                final.owners[moved[0]], "users", moved[0],
                np.array([0], np.int32), np.ones((1, spec.dim), np.float32),
                client_id=client.client_id, seq=last_seq,
                map_version=final.version) is False
            client.pull_unique("users", ids)
            client.push("users", uniq, np.ones((len(uniq), spec.dim),
                                               np.float32), scale=-0.01)
            new_misses = cc.global_cache().stats()["misses"] - misses
            torch.cuda.synchronize()
            report = {
                "owners": 3, "shards": TIER_SHARDS, "shards_moved": len(moved),
                "map_version": final.version,
                "victim_gone": victim not in set(final.owners),
                "resharding": final.resharding, "bit_exact": bit_exact,
                "resent_push_dedupes": dedupes,
                "new_cache_misses_in_recovery": new_misses,
                "recovery_s": recovery_s,
                "stores_on": str(runtimes[wids[0]].store.device)}
        finally:
            for rt in runtimes.values():
                rt.close()
            channel.close()
            master.shutdown(grace_s=0.1)
    if not (report["map_version"] == 2 and report["victim_gone"]
            and not report["resharding"] and bit_exact and dedupes
            and new_misses == 0):
        raise AssertionError(f"tier reshard: {report}")
    return report, placement.launches - launches


def phase_tier(dev, smi):
    """The embedding tier on the card (see the module docstring, 20).
    Returns K1's launches on the tier's paths and its entries on the two
    pushes."""
    from elasticdl_tpu_torch.embedding import sharding
    from elasticdl_tpu_torch.ops import placement

    started = time.perf_counter()
    spec = sharding.TableSpec("users", vocab=TIER_VOCAB, dim=TIER_DIM, seed=3)
    r = np.random.RandomState(7)
    ids = (r.zipf(TIER_ZIPF, (TIER_BATCH, TIER_LEN)) % TIER_VOCAB).astype(
        np.int64)
    labels = r.randint(0, 2, (TIER_BATCH,)).astype(np.float32)

    placement.launches = 0
    serving, serve_launches, shard_pushes, first = tier_serving(spec, ids)
    if not serving["sharded_bit_equal_device_vs_host"]:
        raise AssertionError("device-mode shards differ from host mode")
    if serve_launches != placement.PASSES * shard_pushes:
        raise AssertionError(f"K1 launched {serve_launches} kernels over "
                             f"{shard_pushes} shard pushes, want "
                             f"{placement.PASSES} a push")
    session, session_launches = tier_session(spec, ids, labels, dev)
    rspec = sharding.TableSpec("users", vocab=65536, dim=16, seed=5)
    rids = (np.random.RandomState(11).zipf(TIER_ZIPF, (1024, 8))
            % 65536).astype(np.int64)
    reshard_report, reshard_launches = tier_reshard(rspec, rids)
    launches = placement.launches

    # K1 on one shard's push (not counted: launches for the comparison)
    pushes = {"bench_shard0": k1_on_push(
        first["ids"], first["rows"],
        sharding.shard_row_count(TIER_VOCAB, TIER_SHARDS), dev)}
    fids, frows, frows_n, _ = flagship_push(dev)
    pushes["deepfm_flagship_shard0"] = k1_on_push(fids, frows, frows_n, dev)
    for name, e in pushes.items():
        if not e["ok"]:
            emit("tier", k1_pushes=pushes)
            raise AssertionError(f"K1 on the tier push {name} disagrees "
                                 "with its plain version (or itself)")
    emit("tier", card=smi, table=[TIER_VOCAB, TIER_DIM],
         batch=[TIER_BATCH, TIER_LEN], shards=TIER_SHARDS, steps=TIER_STEPS,
         serving=serving, k1_pushes=pushes, session=session,
         reshard=reshard_report,
         k1_launches={"serving": serve_launches,
                      "session": sum(session_launches),
                      "reshard": reshard_launches, "total": launches},
         seconds=time.perf_counter() - started)
    return launches, pushes


# ---------------------------------------------------------------- cohort


# the world a one-member cohort on the card forms
COHORT_WORLD = ("nccl", "cuda:0")
# one line a training task, from a plain worker ("task N: ...") or a
# cohort member ("cohort task N: ...")
TASK_LINE = re.compile(
    r"task \d+: (\d+) steps, (\d+) records, ([0-9.]+) s in steps, "
    r"data_wait ([0-9.]+) ms and h2d ([0-9.]+) ms a step, "
    r"place_sorted_grads launches (\d+)")
# training tasks of the measured cohort job: past each process's first
# task, several tasks of steady state on either side of the kill
COHORT_TASKS = 8


def steady_state(processes):
    """Samples/s and host ms a step over the training tasks past each
    process's first (its warm-up). `processes` holds each process's
    (steps, records, seconds in steps) a task, in order."""
    tasks = [t for p in processes for t in p[1:]]
    steps = sum(t[0] for t in tasks)
    if not steps:
        return "not measured"
    seconds = sum(t[2] for t in tasks)
    return {"tasks": len(tasks), "steps": steps,
            "samples_per_s": sum(t[1] for t in tasks) / seconds,
            "host_ms_per_step": seconds * 1e3 / steps}


def cohort_run(out, tasks, extra=(), kill=False):
    """A one-member NCCL cohort job of `tasks` training tasks at the `job`
    phase's shape: the port's Master in this process, its ProcessManager
    spawning `elasticdl_tpu_torch.worker.main` with EDL_PROCESS_ID=0 and
    EDL_NUM_PROCESSES=1 (a cohort of one is still a cohort). With `kill`,
    the member is SIGKILLed once the first interval checkpoint is durable,
    and the manager relaunches it. Returns the config and a dict of the
    run: finished, counts, eval, wall_s, killed_at, and the members' logs
    split at each world line (one entry a process)."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.master.process_manager import ProcessManager
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

    cfg = JobConfig.from_argv(job_argv(out, tasks * JOB_TASK, tasks) + [
        "--master_addr", f"localhost:{free_port()}",
        "--coordinator_addr", f"localhost:{free_port()}", *extra])
    master = Master(cfg)
    manager = ProcessManager(
        cfg, membership=master.membership,
        extra_env={"EDL_PROCESS_ID": "0", "EDL_NUM_PROCESSES": "1",
                   "PYTHONPATH": os.pathsep.join(
                       p for p in (REPO, os.environ.get("PYTHONPATH"))
                       if p)},
        log_dir=os.path.join(out, "logs"),
        job_finished_fn=master.dispatcher.finished)
    mngr = CheckpointManager(cfg.checkpoint_dir)
    killed_at = None
    t0 = time.perf_counter()
    master.start()
    manager.start_workers()
    try:
        while (not master.dispatcher.finished()
               and time.perf_counter() - t0 < 600):
            master.membership.reap()
            master.dispatcher.poke()
            if kill and killed_at is None and mngr.latest_step() is not None:
                manager._procs[0].proc.kill()
                killed_at = mngr.latest_step()
            time.sleep(0.2)
        run = {"finished": master.dispatcher.finished(),
               "counts": master.dispatcher.counts(),
               "eval": master.evaluation.latest_results()}
    finally:
        master.shutdown(grace_s=1)
        manager.stop()
    run["wall_s"] = time.perf_counter() - t0
    run["killed_at"] = killed_at
    run["log"] = "\n".join(open(f, errors="replace").read() for f in sorted(
        glob.glob(os.path.join(out, "logs", "*.log"))))
    run["processes"] = re.split(r"distributed world v\d+ up",
                                run["log"])[1:]
    return cfg, run


def cohort_problems(run, tasks):
    """What a cohort run's dispatcher counts and world lines get wrong."""
    problems = []
    counts = run["counts"]
    if not run["finished"] or counts["finished_training"] != tasks or counts[
            "failed_permanently"]:
        problems.append(f"finished {run['finished']}, counts {counts}")
    worlds = re.findall(r"distributed world v\d+ up: process 0/1, 1 "
                        r"global devices \(backend (\w+), device (\S+)\)",
                        run["log"])
    if (len(worlds) != len(run["processes"])
            or any(w != COHORT_WORLD for w in worlds)):
        problems.append(f"world lines {worlds}")
    return problems, worlds


def phase_cohort_job(smi, job):
    """A one-member NCCL cohort through the job path at the `job` phase's
    shape, in two runs. The measured run (COHORT_TASKS tasks, no profiler,
    as `job` has none) is SIGKILLed once its first interval checkpoint is
    durable, relaunched by the manager, and resumes; the member logs its
    task lines (steps, records, time, data wait, K1's launches in its
    process). A short traced run (one task, a `--profile_dir` window over
    its first 2 steps) must name both K1 kernels. Returns K1's launches
    over both processes of the measured run."""
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    # the member's environment: the manager's variables and nothing a
    # polluted environment carries
    for k in COHORT_ENV + ("EDL_TORCH_DEVICE",):
        os.environ.pop(k, None)
    with tempfile.TemporaryDirectory() as out:
        cfg, run = cohort_run(out, COHORT_TASKS, kill=True)
        problems, worlds = cohort_problems(run, COHORT_TASKS)
        if run["killed_at"] is None:
            problems.append("no checkpoint to kill the member after")
        if len(worlds) < 2:
            problems.append("no relaunch")
        resumed = re.findall(r"cohort resumed from checkpoint at step (\d+)",
                             run["log"])
        if not resumed:
            problems.append("no resume line")
        # K1's launches: each process counts from 0; its last task line
        # holds its count, 2 a train step
        launches, processes = 0, []
        for generation in run["processes"]:
            lines = TASK_LINE.findall(generation)
            if lines:
                launches += int(lines[-1][5])
                processes.append(lines)
        tasks = [x for p in processes for x in p]
        steps = sum(int(x[0]) for x in tasks)
        if not steps or launches != placement.PASSES * steps:
            problems.append(f"K1 launched {launches} kernels in {steps} "
                            "logged train steps")
        export_err = None
        if run["finished"]:
            trainer = Trainer(ModelSpec.from_config(cfg))
            final = trainer.init_state(None)
            CheckpointManager(cfg.checkpoint_dir).restore(final)
            export_err = export_matches(
                out, lambda b: trainer.predict_step(final, b), criteo_batch(7))
            if export_err > 1e-6:
                problems.append(f"export predicts {export_err} off the "
                                "newest checkpoint")
        if problems:
            print(run["log"][-8000:], file=sys.stderr, flush=True)
            raise AssertionError("cohort_job: " + "; ".join(problems))
    with tempfile.TemporaryDirectory() as out:
        profile_dir = os.path.join(out, "profile")
        _, traced = cohort_run(out, 1, extra=(
            "--profile_dir", profile_dir, "--profile_start_step", "0",
            "--profile_steps", "2"))
        problems, _ = cohort_problems(traced, 1)
        traces = (os.listdir(profile_dir) if os.path.isdir(profile_dir)
                  else [])
        names = set()
        for trace in traces:
            with open(os.path.join(profile_dir, trace)) as f:
                names |= {e.get("name", "") for e in json.load(f).get(
                    "traceEvents", []) if e.get("cat") == "kernel"}
        if not all(any(k in n for n in names) for k in K1_SYMBOLS):
            problems.append(f"traces {traces} name no {K1_SYMBOLS}")
        if problems:
            print(traced["log"][-8000:], file=sys.stderr, flush=True)
            raise AssertionError("cohort_job traced run: "
                                 + "; ".join(problems))

    def per_step(i):
        return sum(float(x[i]) * int(x[0]) for x in tasks) / steps

    step_s = sum(float(x[2]) for x in tasks)
    records = sum(int(x[1]) for x in tasks)
    cohort = {"tasks": COHORT_TASKS, "wall_s": run["wall_s"],
              "samples_per_s": records / step_s,
              "host_ms_per_step": step_s * 1e3 / steps,
              "data_wait_ms_per_step": per_step(3),
              "h2d_ms_per_step": per_step(4),
              "past_first_task": steady_state(
                  [[(int(x[0]), int(x[1]), float(x[2])) for x in p]
                   for p in processes])}
    emit("cohort_job", card=smi, worlds=worlds,
         killed_after_step=run["killed_at"],
         resumed_at=[int(x) for x in resumed], counts=run["counts"],
         eval=run["eval"], train_steps=steps, records=records,
         k1_launches=launches, export_max_abs_err=export_err,
         traced_run={"wall_s": traced["wall_s"], "trace": traces},
         cohort=cohort, job={k: job[k] for k in cohort})
    return launches


# ---------------------------------------------------------------- elastic control

# the autoscaled job: tasks of JOB_TASK records (2 steps at BATCH)
AUTOSCALE_TASKS = 6
# the callbacks job: training tasks of JOB_TASK records and eval jobs of
# one batch, an eval job every 2 steps
CALLBACKS_TASKS = 8
# a subprocess worker's environment beyond the launcher's (empty: the
# worker defaults to the card)
WORKER_ENV = {}


class LogLines(logging.Handler):
    """The messages logged under the port's root logger while installed."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("elasticdl_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("elasticdl_tpu_torch").removeHandler(self)


def autoscale_argv(out, rules):
    """The DeepFM job at full width (AUTOSCALE_TASKS tasks, no eval, no
    export) with the closed-loop autoscaler on: a 2-worker straggler
    quorum, hold and cooldown of 1 s, a rescale cost of 1 s, a fleet
    sample a second, and `rules` as the alert rule set. Heartbeats every
    3 s: an evicted worker stops beating while it drains, and the master
    declares it dead after 3 beats, so they must cover the step in flight
    (2.5-3.7 s of data wait here; with 1 s beats a drain was billed as a
    death)."""
    return [
        "--model_zoo", ZOO, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", f"field_vocab={FIELD_VOCAB};hidden=400,400",
        "--minibatch_size", str(BATCH),
        "--training_data",
        f"synthetic://criteo?n={AUTOSCALE_TASKS * JOB_TASK}"
        f"&shards={AUTOSCALE_TASKS}",
        "--records_per_task", str(JOB_TASK),
        "--checkpoint_dir", os.path.join(out, "ckpt"),
        "--checkpoint_steps", "2", "--worker_heartbeat_s", "3",
        "--autoscale", "true", "--straggler_quorum", "2",
        "--autoscale_hold_s", "1", "--autoscale_cooldown_s", "1",
        "--autoscale_rescale_cost_s", "1", "--timeseries_interval_s", "1",
        "--alert_rules", rules,
    ]


def task_lines(log_dir):
    """Each worker log's task lines under `log_dir`, by file name."""
    return {os.path.basename(f): TASK_LINE.findall(open(f, errors="replace")
                                                   .read())
            for f in sorted(glob.glob(os.path.join(log_dir, "*.log")))}


def phase_autoscale_job(smi):
    """The closed-loop autoscaler on the card, over the DeepFM job at full
    width: a plain training fleet holds one worker (the reference's
    `JobConfig.validate` refuses two plain training workers, which would
    train independent replicas, and a card takes one cohort rank), so the
    policy acts on this fleet only within its bounds. The first
    submission, wired as `client/local.run_local` wires it (the master,
    its ProcessManager, a `ProcessManagerTarget` bound to the master's
    autoscaler): the job's own data-wait signal (the reference's
    `fleet_data_wait_dominant` rule, value mode, threshold 0.5, 10 s
    window) reaches the policy, whose `shrink` is suppressed at the world's
    minimum and journaled. After the first finished task the target the
    policy drives evicts the worker (`evict(0)`: the servicer's heartbeat
    evict bit, the manager's never-relaunch mark): the worker drains
    through its preempt path (drain checkpoint, an in-flight task's
    remainder requeued), exits EX_TEMPFAIL and its slot is retired, not
    relaunched,
    with no `worker_died` waste. The job is then resubmitted through
    `run_local` over the same checkpoint directory: the new master
    replays the journal, a new worker resumes from the drain checkpoint,
    and every task finishes once across the two. Returns K1's launches in
    the two workers (their task lines)."""
    from elasticdl_tpu_torch.client.local import run_local
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.constants import PodStatus
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.autoscaler import ProcessManagerTarget
    from elasticdl_tpu_torch.master.journal import replay_lines
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.master.process_manager import ProcessManager
    from elasticdl_tpu_torch.observability import timeseries
    from elasticdl_tpu_torch.ops import placement

    for k in COHORT_ENV + ("EDL_TORCH_DEVICE",):
        os.environ.pop(k, None)
    # the master's time series ring is per process: the earlier phases'
    # masters left their samples in it, and the policy must decide on this
    # job's
    timeseries.reset_for_tests()
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p), **WORKER_ENV}
    with tempfile.TemporaryDirectory() as out, LogLines() as lines:
        rules = os.path.join(out, "rules.json")
        with open(rules, "w") as f:
            json.dump([{"name": "fleet_data_wait_dominant",
                        "series": "edl_fleet_data_wait_frac",
                        "threshold": 0.5, "mode": "value",
                        "window_s": 10.0}], f)
        cfg = JobConfig.from_argv(autoscale_argv(out, rules) + [
            "--master_addr", f"localhost:{free_port()}"])
        master = Master(cfg)
        manager = ProcessManager(
            cfg, membership=master.membership, extra_env=env,
            log_dir=os.path.join(out, "logs1"),
            job_finished_fn=master.dispatcher.finished,
            checkpoint_request_fn=lambda: master.servicer.request_checkpoint(0),
            journal=master.journal)
        target = ProcessManagerTarget(manager, servicer=master.servicer,
                                      membership=master.membership)
        master.autoscaler.bind_target(target)
        seen = {}
        t0 = time.perf_counter()

        def until_evicted():
            """The wait poll's hook: note when the signal and the decision
            first show, evict once a task has finished and the policy has
            decided, and end the wait once the slot is retired."""
            now = time.perf_counter() - t0
            if master.alerts.active():
                seen.setdefault("signal_s", now)
            if master.autoscaler.snapshot()["last_decision"]:
                seen.setdefault("decision_s", now)
            if ("evict_s" not in seen and "decision_s" in seen
                    and master.dispatcher.counts()["finished_training"]):
                seen["finished_at_evict"] = master.dispatcher.counts()[
                    "finished_training"]
                seen["evicted"] = target.evict(0, "worker-0")
                seen["evict_s"] = now
            if manager.statuses().get(0) == PodStatus.DELETED:
                seen.setdefault("retired_s", now)
                return True
            return now > 600

        master.start()
        manager.start_workers()
        try:
            master.wait(poll_s=0.2, abort_fn=until_evicted)
            first_s = time.perf_counter() - t0
            first = {"counts": master.dispatcher.counts(),
                     "wasted": master.dispatcher.wasted_work(),
                     "statuses": manager.statuses(),
                     "autoscale": master.autoscaler.snapshot()}
        finally:
            master.shutdown(grace_s=1)
            manager.stop()
        if "retired_s" not in seen:
            print("\n".join(lines.messages[-200:]), file=sys.stderr,
                  flush=True)
            raise AssertionError(f"autoscale_job: the worker was not evicted "
                                 f"and retired: {seen}, {first}")
        with open(master.journal.path, encoding="utf-8") as f:
            decisions = [r for r in map(json.loads, f)
                         if r.get("t") == "autoscale"]
        t1 = time.perf_counter()
        rc = run_local(cfg.replace(master_addr="localhost:0"), extra_env=env,
                       log_dir=os.path.join(out, "logs2"), timeout_s=600)
        resumed_s = time.perf_counter() - t1
        with open(master.journal.path + ".completed", encoding="utf-8") as f:
            replayed = replay_lines(f.readlines())
        evicted_lines = task_lines(os.path.join(out, "logs1"))
        resumed_lines = task_lines(os.path.join(out, "logs2"))
        logs = {d: open(f, errors="replace").read() for d in ("logs1", "logs2")
                for f in glob.glob(os.path.join(out, d, "worker-0.log"))}
    problems = []
    if not seen.get("evicted") or first["statuses"] != {0: PodStatus.DELETED}:
        problems.append(f"eviction {seen}, statuses {first['statuses']}")
    if not any(m.startswith("worker 0 eviction complete (exit code 75)")
               for m in lines.messages):
        problems.append("no eviction-complete line with exit code 75")
    if any("relaunch" in m and "worker 0" in m for m in lines.messages):
        problems.append("the evicted worker was relaunched")
    if "worker_died" in first["wasted"].get("by_reason", {}):
        problems.append(f"worker_died waste {first['wasted']}")
    if "master evicted this worker" not in str(logs):
        problems.append("the worker's log has no eviction line")
    shrink = [d for d in decisions if d.get("kind") == "shrink"]
    if (not shrink or shrink[0].get("suppress_reason") != "world_at_min"
            or any(d.get("decision") == "applied" for d in decisions)):
        problems.append(f"decisions {decisions}")
    counts = replayed.dispatcher
    if (rc != 0 or counts.finished_training != AUTOSCALE_TASKS
            or counts.failed_permanently):
        problems.append(f"resubmission exit {rc}, finished "
                        f"{counts.finished_training}, failed "
                        f"{counts.failed_permanently}")
    workers = []
    for name, per in (("evicted", evicted_lines), ("resumed", resumed_lines)):
        tasks = per.get("worker-0.log", [])
        steps = sum(int(x[0]) for x in tasks)
        launches = int(tasks[-1][5]) if tasks else 0
        if not steps or launches != placement.PASSES * steps:
            problems.append(f"{name} worker: K1 launched {launches} kernels "
                            f"in {steps} logged train steps")
        seconds = sum(float(x[2]) for x in tasks)
        workers.append({
            "worker": name, "tasks": len(tasks), "train_steps": steps,
            "k1_launches": launches,
            "host_ms_per_step": seconds * 1e3 / steps if steps else None,
            "data_wait_ms_per_step": (sum(float(x[3]) * int(x[0])
                                          for x in tasks) / steps
                                      if steps else None),
            "past_first_task": steady_state([[
                (int(x[0]), int(x[1]), float(x[2])) for x in tasks
                if int(x[0])]])})
    if problems:
        print("\n".join(lines.messages[-200:]), file=sys.stderr, flush=True)
        raise AssertionError("autoscale_job: " + "; ".join(problems))
    emit("autoscale_job", card=smi, tasks=AUTOSCALE_TASKS,
         decisions=[{k: d.get(k) for k in (
             "decision", "kind", "suppress_reason", "reason", "worker_id",
             "gain_s", "cost_s", "world") if k in d} for d in decisions],
         signal_onset_s=seen.get("signal_s"),
         signal_to_decision_s=seen["decision_s"] - seen["signal_s"],
         finished_at_evict=seen["finished_at_evict"],
         evict_to_retired_s=seen["retired_s"] - seen["evict_s"],
         first_submission_wall_s=first_s,
         drain_waste=first["wasted"].get("by_reason", {}),
         resubmitted={"exit": rc, "wall_s": resumed_s,
                      "finished_training": counts.finished_training,
                      "failed_permanently": counts.failed_permanently},
         workers=workers)
    return sum(w["k1_launches"] for w in workers)


# the zoo module of the callbacks job: the port's DeepFM, its learning
# rate halved once on a plateau of the eval AUC (no eval can improve it by
# 1, so the plateau is certain; the floor makes the one halving the last)
# and training stopped after three more evals without an improvement
CALLBACKS_ZOO = """
from elasticdl_tpu_torch.api.callbacks import EarlyStopping, ReduceLROnPlateau
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm import *  # noqa: F403


def callbacks():
    return [ReduceLROnPlateau(initial_lr=1e-3, monitor="auc", patience=1,
                              min_delta=1.0, min_lr=5e-4),
            EarlyStopping(monitor="auc", patience=3, min_delta=1.0)]
"""
CALLBACKS_LR = 5e-4


def phase_callbacks_job(smi):
    """Zoo callbacks on the card: the DeepFM job at full width in one
    process (the port's Master and its Worker on a thread, device
    defaulted), through a zoo module written to a temp directory whose
    `callbacks()` returns `ReduceLROnPlateau` and `EarlyStopping` on the
    eval AUC (CALLBACKS_ZOO), CALLBACKS_TASKS training tasks of 2 steps
    and an eval job of one batch every 2 steps. The second eval's plateau
    pushes CALLBACKS_LR through the heartbeat; it must land in every
    param group of the worker's Adam on the card, and the same LR must be
    in the checkpoint's optimizer state. The fourth eval stops training
    through `EarlyStopping` (the dispatcher's stop line names its reason),
    so fewer tasks finish than the data holds, none failed. K1 must launch
    twice a train step. Returns K1's launches."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.worker.worker import Worker

    with tempfile.TemporaryDirectory() as out, LogLines() as lines:
        os.makedirs(os.path.join(out, "zoo", "deepfm_callbacks"))
        open(os.path.join(out, "zoo", "deepfm_callbacks", "__init__.py"),
             "w").close()
        with open(os.path.join(out, "zoo", "deepfm_callbacks",
                               "model.py"), "w") as f:
            f.write(CALLBACKS_ZOO)
        cfg = JobConfig.from_argv([
            "--model_zoo", os.path.join(out, "zoo"),
            "--model_def", "deepfm_callbacks.model.custom_model",
            "--model_params", f"field_vocab={FIELD_VOCAB};hidden=400,400",
            "--minibatch_size", str(BATCH),
            "--training_data",
            f"synthetic://criteo?n={CALLBACKS_TASKS * JOB_TASK}"
            f"&shards={CALLBACKS_TASKS}",
            "--records_per_task", str(JOB_TASK),
            "--validation_data", f"synthetic://criteo?n={BATCH}&shards=1",
            "--evaluation_steps", "2",
            "--checkpoint_dir", os.path.join(out, "ckpt"),
            "--checkpoint_steps", "1000",
            "--master_addr", f"localhost:{free_port()}",
            "--worker_heartbeat_s", "0.5"])
        master = Master(cfg)
        master.start()
        worker = Worker(cfg)                # device defaulted: the GPU
        if worker.device.type != "cuda":
            raise AssertionError(f"Worker defaulted to {worker.device}")
        rc = []
        thread = threading.Thread(target=lambda: rc.append(worker.run()),
                                  name="callbacks-worker", daemon=True)
        placement.launches = 0
        t0 = time.perf_counter()
        thread.start()
        try:
            finished = master.wait(poll_s=0.2, timeout_s=600)
            counts = master.dispatcher.counts()
            results = master.evaluation.latest_results()
            plateau, early = master.callbacks
        finally:
            master.shutdown(grace_s=1)
            thread.join(300)
        wall_s = time.perf_counter() - t0
        launches = placement.launches
        steps = worker._global_step
        groups = worker._state.optimizer.param_groups
        slots = worker._state.optimizer.state.values()
        from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

        mngr = CheckpointManager(cfg.checkpoint_dir)
        saved = torch.load(os.path.join(cfg.checkpoint_dir,
                                        str(mngr.latest_step()), "state.pt"),
                           map_location="cpu", weights_only=False)
    stops = [m for m in lines.messages
             if m.startswith("training stop requested")]
    evals = [m for m in lines.messages if "ReduceLROnPlateau" in m]
    saved_lrs = [g.get("lr") for g in saved["optimizer"]["param_groups"]]
    problems = []
    if not finished or rc != [0] or thread.is_alive():
        problems.append(f"finished {finished}, worker exit {rc}")
    if plateau.lr != CALLBACKS_LR or not early.stopped:
        problems.append(f"plateau lr {plateau.lr}, stopped {early.stopped}")
    if [g["lr"] for g in groups] != [CALLBACKS_LR] * len(groups):
        problems.append(f"param groups' lr {[g['lr'] for g in groups]}")
    if saved_lrs != [CALLBACKS_LR] * len(saved_lrs):
        problems.append(f"checkpoint's lr {saved_lrs}")
    if not all(s["exp_avg"].device.type == "cuda" for s in slots):
        problems.append("Adam's moments are not on the card")
    if len(stops) != 1 or "auc did not improve" not in stops[0]:
        problems.append(f"stop lines {stops}")
    if not (0 < counts["finished_training"] < CALLBACKS_TASKS) or counts[
            "failed_permanently"]:
        problems.append(f"dispatcher counts {counts}")
    if not steps or launches != placement.PASSES * steps:
        problems.append(f"K1 launched {launches} kernels in {steps} train "
                        "steps")
    if problems:
        print("\n".join(lines.messages[-200:]), file=sys.stderr, flush=True)
        raise AssertionError("callbacks_job: " + "; ".join(problems))
    emit("callbacks_job", card=smi, wall_s=wall_s, counts=counts,
         eval=results, train_steps=steps, k1_launches=launches,
         pushed_lr=plateau.lr,
         param_group_lrs=[float(g["lr"]) for g in groups],
         checkpoint_lrs=[float(lr) for lr in saved_lrs], plateau=evals,
         stop=stops[0])
    return launches


def phase_hybrid_mesh(smi):
    """`--dcn_mesh_shape` on the card: DeepFM at full width on a one-rank
    NCCL world (as `cohort_job`'s member forms it), its mesh built by
    `build_job_mesh` from `--dcn_mesh_shape data=1` (the hybrid layout of
    one slice of one rank) and from no DCN shape (flat); 3 train steps on
    each from one seed must be equal bit for bit (losses and parameters),
    with K1 launched twice a step. Returns K1's launches."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.parallel import elastic
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.training.trainer import Trainer

    steps = 3
    batches = [criteo_batch(400 + i) for i in range(steps)]
    ctx = elastic.CohortContext(f"localhost:{free_port()}", 1, 0,
                                device=torch.device("cuda:0"))
    ctx.initialize(timeout_s=60)
    runs, launches = {}, 0
    try:
        for name, dcn in (("hybrid", "data=1"), ("flat", "")):
            mesh = mesh_lib.build_job_mesh(JobConfig(
                model_zoo=ZOO, model_def="deepfm.deepfm.custom_model",
                dcn_mesh_shape=dcn))
            tr = Trainer(load_spec(f"field_vocab={FIELD_VOCAB};"
                                   "hidden=400,400"), seed=7, mesh=mesh)
            state = tr.init_state(None)
            placement.launches = 0
            losses = [float(tr.train_step(state, b)[1]["loss"])
                      for b in batches]
            launches += placement.launches
            if placement.launches != placement.PASSES * steps:
                raise AssertionError(f"{name}: K1 launched "
                                     f"{placement.launches} kernels in "
                                     f"{steps} steps")
            runs[name] = (dict(mesh.shape), losses, {
                k: p.detach().clone() for k, p in state.params.items()})
            del tr, state
    finally:
        ctx.shutdown()
    (hshape, hlosses, hparams), (fshape, flosses, fparams) = (
        runs["hybrid"], runs["flat"])
    if hlosses != flosses or hparams.keys() != fparams.keys() or not all(
            torch.equal(hparams[k], fparams[k]) for k in hparams):
        raise AssertionError(f"the hybrid mesh's steps {hlosses} differ from "
                             f"the flat mesh's {flosses}")
    emit("hybrid_mesh", card=smi, backend=ctx.backend,
         dcn_mesh_shape="data=1", mesh=hshape, flat_mesh=fshape,
         steps=steps, losses=hlosses, bit_equal_to_flat=True,
         k1_launches=launches)
    return launches


# ---------------------------------------------------------------- the zoo

# the five models at their reference bench widths (bench.py:4335-4375),
# bf16 compute: (name, model_def, model_params, batch, recsys)
ZOO_MODELS = (
    ("mnist", "mnist.mnist_cnn.custom_model", "", 1024, False),
    ("resnet20", "cifar10.resnet.custom_model", "depth=20", 512, False),
    # the warm-up cut from 500 steps to 4, so the phase's steps train at
    # a learning rate that moves the loss (the first still at 0)
    ("resnet50", "resnet50.resnet50.custom_model",
     "num_classes=1000;warmup_steps=4", 32, False),
    ("wide_deep", "census.wide_deep.custom_model", "", 4096, True),
    ("xdeepfm", "deepfm.xdeepfm.custom_model",
     f"field_vocab={FIELD_VOCAB};hidden=400,400;cin_sizes=128,128;"
     "embedding_dim=16", 4096, True),
)
ZOO_STEPS = 12
ZOO_BATCH = 4096


def census_features(n, seed=0):
    """`n` synthetic census rows (the reader's `census` kind) through the
    port's Wide & Deep parser: the features, hashed by its spec, and the
    labels."""
    from elasticdl_tpu_torch.data import parsing
    from elasticdl_tpu_torch.data.reader import SyntheticDataReader
    from elasticdl_tpu_torch.model_zoo.census import wide_deep

    reader = SyntheticDataReader(kind="census", num_records=n, seed=seed)
    records = list(reader.read_records("synthetic-census-0", 0, n))
    return parsing.as_batch_parser(wide_deep.dataset_fn("training", None))(
        records)


def zoo_batch(name, b, seed=0):
    r = np.random.RandomState(seed)
    if name == "mnist":
        feats, classes = r.rand(b, 28, 28, 1).astype(np.float32), 10
    elif name == "resnet20":
        feats, classes = r.rand(b, 32, 32, 3).astype(np.float32), 10
    elif name == "resnet50":
        feats, classes = r.rand(b, 224, 224, 3).astype(np.float32), 1000
    elif name == "wide_deep":
        feats, labels = census_features(b, seed)
        return {"features": feats, "labels": labels}
    else:
        return criteo_batch(seed, b)
    return {"features": feats,
            "labels": r.randint(0, classes, (b,)).astype(np.int32)}


def phase_zoo_kernel(dev):
    """K1 on the streams of the two new recsys models: xDeepFM's 4096 x 26
    ids (uniform raw values hashed into 26 fields of 100k, d 17) and Wide
    & Deep's 4096 x 9 ids from the synthetic census rows hashed by the
    port's spec (a table of a few hundred rows, d 9: nearly every segment
    is hot)."""
    from elasticdl_tpu_torch.model_zoo.census import wide_deep
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm
    from elasticdl_tpu_torch.ops import embedding as emb

    spec = deepfm.feature_spec(FIELD_VOCAB)
    cat = torch.from_numpy(criteo_batch(8, ZOO_BATCH)["features"]["cat"])
    xdeepfm_ids = spec.device_transform(
        {"dense": torch.zeros((ZOO_BATCH, 13)), "cat": cat})["cat"]
    census_ids = torch.from_numpy(census_features(ZOO_BATCH)[0]["cat"])
    gen = torch.Generator(device=dev).manual_seed(1)
    report = {}
    for name, ids, d, rows in (
            ("xdeepfm_d17", xdeepfm_ids, 17,
             emb.padded_vocab(spec.total_vocab)),
            ("wide_deep_d9", census_ids, 9,
             emb.padded_vocab(wide_deep.TOTAL_VOCAB))):
        ids = torch.sort(ids.reshape(-1).to(dev, torch.int32),
                         stable=True)[0].contiguous()
        cot = torch.randn((ids.numel(), d), generator=gen, device=dev)
        entry = report[name] = k1_stream(ids, cot, rows, dev)
        entry["distinct_ids"] = int(torch.unique(ids).numel())
        if not entry["ok"]:
            emit("zoo_kernel", streams=report)
            raise AssertionError(f"K1 disagrees with its plain version (or "
                                 f"with itself) on {name}")
    emit("zoo_kernel", streams=report)
    return report


def bn_hand_update(model, batch, step):
    """One train step's update of the model's first BatchNorm against a
    hand update from that step's batch statistics (a forward hook reads
    them): ra' = 0.9 ra + 0.1 batch, applied once. Returns the largest
    difference (0.0 when exact)."""
    from elasticdl_tpu_torch.api.layers import BatchNorm

    bn = next(m for m in model.modules() if isinstance(m, BatchNorm))
    seen = []
    hook = bn.register_forward_hook(lambda m, i, o: seen.append(m.pending))
    before = (bn.mean.clone(), bn.var.clone())
    try:
        step(batch)
    finally:
        hook.remove()
    if not seen:
        raise AssertionError("the BatchNorm hook saw no training forward")
    mean, var = seen[0]
    want = (0.9 * before[0] + (1 - 0.9) * mean,
            0.9 * before[1] + (1 - 0.9) * var)
    return max(float((bn.mean - want[0]).abs().max()),
               float((bn.var - want[1]).abs().max()))


def clone_state(state, trainer):
    """A second trainer's state from `state`: params, buffers, optimizer."""
    import copy

    other = trainer.init_state(None)
    with torch.no_grad():
        for k, p in other.params.items():
            p.copy_(state.params[k])
        for k, b in other.buffers.items():
            b.copy_(state.buffers[k])
    other.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    other.step = state.step
    return other


def remat_equal(spec_fn, state, batch):
    """ResNet-50: one step with remat and one without from one cloned
    state, under deterministic cuDNN: params and buffers bit for bit."""
    from elasticdl_tpu_torch.training.trainer import Trainer

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        out = []
        for knobs in ({}, {"remat": True}):
            trainer = Trainer(spec_fn(), **knobs)
            s = clone_state(state, trainer)
            s, logs = trainer.train_step(s, batch)
            torch.cuda.synchronize()
            out.append((float(logs["loss"]),
                        {k: p.detach().clone() for k, p in s.params.items()},
                        {k: b.clone() for k, b in s.buffers.items()}))
            del trainer, s
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, p0, b0), (l1, p1, b1) = out
    diff = max([float((p0[k] - p1[k]).abs().max()) for k in p0]
               + [float((b0[k] - b1[k]).abs().max()) for k in b0])
    return {"loss_equal": l0 == l1, "max_abs_diff": diff,
            "bit_equal": l0 == l1 and diff == 0.0}


def phase_zoo_train(smi):
    """Each zoo model at its bench width on one repeated batch: ZOO_STEPS
    train steps (the first a warm-up), then eval and predict. Returns K1's
    launches a model."""
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.trainer import Trainer

    launches, report = {}, {}
    for name, model_def, params, b, recsys in ZOO_MODELS:
        def spec_fn():
            return load_spec(params, "bfloat16", model_def=model_def)

        trainer = Trainer(spec_fn())
        batch = zoo_batch(name, b)
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init_state(None)
        placement.launches = 0
        bn_err = None
        losses = []
        if state.buffers:
            bn_err = bn_hand_update(
                trainer.model, batch,
                lambda x: losses.append(trainer.train_step(state, x)[1]["loss"]))
        else:
            losses.append(trainer.train_step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(ZOO_STEPS - 1):
            losses.append(trainer.train_step(state, batch)[1]["loss"])
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        n = launches[name] = placement.launches
        step_ms = start.elapsed_time(end) / (ZOO_STEPS - 1)
        if name in ("resnet20", "resnet50"):
            phase_profile(trainer, state, batch, step_ms, model=name)
        metric_states = trainer.eval_step(state, batch,
                                          trainer.new_metric_states())
        preds = trainer.predict_step(state, batch)
        torch.cuda.synchronize()
        losses = [float(x) for x in losses]
        entry = {"batch": b, "params": params, "steps": ZOO_STEPS,
                 "step_mode": step_mode(trainer),
                 "losses": losses, "step_ms": step_ms,
                 "host_ms_per_step": host_s * 1e3 / (ZOO_STEPS - 1),
                 "samples_per_s": b / (step_ms / 1e3),
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "k1_launches": n, "eval": trainer.metric_results(metric_states),
                 "predict_shape": list(preds.shape),
                 "bn_hand_update_max_abs_diff": bn_err}
        if name == "resnet50":
            entry["remat"] = remat_equal(spec_fn, state, batch)
        step_cost(name, trainer, state, batch, step_ms, spec_fn, smi,
                  batch_size=b)
        report[name] = entry
        want = placement.PASSES * ZOO_STEPS if recsys else 0
        problems = []
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            problems.append(f"losses not finite and falling: {losses}")
        if n != want:
            problems.append(f"K1 launched {n} kernels in {ZOO_STEPS} steps, "
                            f"want {want}")
        if bn_err is not None and bn_err != 0.0:
            problems.append(f"BatchNorm's running averages are {bn_err} off "
                            "one hand update")
        if not bool(torch.isfinite(preds).all()) or preds.shape[0] != b:
            problems.append(f"predictions {tuple(preds.shape)} not finite")
        if name == "resnet50" and not entry["remat"]["bit_equal"]:
            problems.append(f"remat differs from base: {entry['remat']}")
        if problems:
            emit("zoo_train", card=smi, models=report)
            raise AssertionError(f"{name}: {problems}")
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    emit("zoo_train", card=smi, models=report)
    return launches


def zoo_job_argv(out, model_def, params, batch, data, n, per_task, eval_data):
    return [
        "--model_zoo", ZOO, "--model_def", model_def,
        "--model_params", params, "--minibatch_size", str(batch),
        "--training_data", data.format(n=n),
        "--records_per_task", str(per_task),
        "--validation_data", eval_data,
        "--checkpoint_dir", os.path.join(out, "ckpt"),
        "--checkpoint_steps", "4", "--keep_checkpoint_max", "2",
        "--output", os.path.join(out, "export"),
        "--worker_heartbeat_s", "2",
    ]


# (name, model_def, model_params, batch, training data, records, records a
# task, validation data, metric)
ZOO_JOBS = (
    ("resnet20", "cifar10.resnet.custom_model", "depth=20", 512,
     "synthetic://cifar10?n={n}&shards=2", 4096, 1024,
     "synthetic://cifar10?n=1024&shards=1", "accuracy"),
    ("wide_deep", "census.wide_deep.custom_model", "", 4096,
     "synthetic://census?n={n}&shards=2", 32768, 8192,
     "synthetic://census?n=8192&shards=1", "auc"),
)


def phase_zoo_job(smi):
    """ResNet-20 on `synthetic://cifar10` and Wide & Deep on
    `synthetic://census` through the job path in one process (the port's
    Master, its Worker on a thread on the card): 4 training tasks of 2
    steps, eval at epoch end, checkpoints every 4 steps, SAVE_MODEL and
    the export. Returns K1's launches a job."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.observability import profile
    from elasticdl_tpu_torch.observability.registry import default_registry
    from elasticdl_tpu_torch.ops import placement
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.training.export import load_model
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer
    from elasticdl_tpu_torch.worker.worker import Worker

    launches, report = {}, {}
    for (name, model_def, params, b, data, n, per_task, eval_data,
         metric) in ZOO_JOBS:
        with tempfile.TemporaryDirectory() as out:
            cfg = JobConfig.from_argv(
                zoo_job_argv(out, model_def, params, b, data, n, per_task,
                             eval_data)
                + ["--master_addr", f"localhost:{free_port()}"])
            master = Master(cfg)
            master.start()
            worker = Worker(cfg)
            reg = default_registry()
            before = reg.snapshot()
            profile.get_profiler().reset()
            rc = []
            thread = threading.Thread(target=lambda: rc.append(worker.run()),
                                      name=f"zoo-job-{name}", daemon=True)
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
            after = reg.snapshot()
            phases = profile.get_profiler().snapshot(update_memory=False)
            steps = worker._global_step
            k1 = launches[name] = placement.launches
            problems = []
            if not finished or rc != [0] or thread.is_alive():
                problems.append(f"job did not finish cleanly: finished "
                                f"{finished}, worker exit {rc}")
            if counts["finished_training"] != 4 or counts["failed_permanently"]:
                problems.append(f"dispatcher counts {counts}")
            if not all(np.isfinite(results.get(k, np.nan))
                       for k in (metric, "loss")):
                problems.append(f"eval results {results}")
            want = placement.PASSES * steps if name == "wide_deep" else 0
            if steps != 8 or k1 != want:
                problems.append(f"K1 launched {k1} kernels in {steps} train "
                                f"steps, want {want} over 8")
            final = worker._state
            mngr = CheckpointManager(cfg.checkpoint_dir)
            fresh = Trainer(ModelSpec.from_config(cfg)).init_state(None)
            if mngr.all_steps() != [4, 8]:
                problems.append(f"checkpoint steps {mngr.all_steps()}")
            elif mngr.restore(fresh) is not fresh or not states_equal(
                    fresh, final):
                problems.append("newest checkpoint does not restore the "
                                "final state (params, buffers, slots)")
            del fresh
            batch = zoo_batch(name, b, seed=5)
            model, _ = load_model(os.path.join(out, "export"), ZOO,
                                  device="cuda")
            feats = worker._trainer._to_device(batch["features"])
            with torch.no_grad():
                got = model(feats, training=False)
            export_err = float(
                (got - worker._trainer.predict_step(final, batch)).abs().max())
            if export_err > 1e-6:
                problems.append(f"export predicts {export_err} off the "
                                "final state")
            if problems:
                raise AssertionError(f"zoo_job {name}: {problems}")

        def delta(key):
            return after.get(key, 0.0) - before.get(key, 0.0)

        step_s = delta("edl_train_step_seconds_sum")
        records = delta("edl_train_records_total")
        report[name] = {
            "params": params, "batch": b, "train_steps": steps,
            "records": records, "counts": counts, "eval": results,
            "wall_s": wall_s, "samples_per_s": records / step_s,
            "host_ms_per_step": step_s * 1e3 / steps,
            "data_wait_ms_per_step": phases.get("phase_data_wait_ms", 0.0),
            "h2d_ms_per_step": phases.get("phase_h2d_ms", 0.0),
            "k1_launches": k1, "checkpoint_steps": [4, 8],
            "export_max_abs_err": export_err}
    emit("zoo_job", card=smi, jobs=report)
    return launches


def phase_build():
    """Compile every kernel of the paths (one nvcc per source, all at
    once) and hold the Hopper library's kernels to their layout: HGMMA in
    each, no spill where the layout was chosen to avoid one, the delta
    pass at every width and dtype the backward kernels take."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import native, placement

    built = native.build([placement.KERNEL, fa.LIBRARY, fa.LIBRARY_SM90])
    seconds = time.perf_counter() - PHASE_T0[0]
    hgmma = hgmma_counts(built[fa.LIBRARY_SM90]["path"])
    sm90 = ctypes.CDLL(built[fa.LIBRARY_SM90]["path"])
    hopper = ([(0, "flash_fwd_sm90_kernel", d) for d in (16, 32, 64, 128)]
              + [(1, "flash_bwd_dkv_sm90_kernel", d)
                 for d in (16, 32, 64, 128)]
              + [(2, "flash_bwd_dq_sm90_kernel", d)
                 for d in (16, 32, 64, 128)]
              + [(3, "flash_fwd_tf32_sm90_kernel", d) for d in TF32]
              + [(4, "flash_bwd_dkv_tf32_sm90_kernel", d)
                 for d in DKV_TF32]
              + [(5, "flash_bwd_dq_tf32_sm90_kernel", d)
                 for d in DQ_TF32])
    shared = {f"{name}<D={d}>": sm90.flash_sm90_shared_bytes(which, d)
              for which, name, d in hopper}
    ptxas = {k: ptxas_summary(v["log"]) for k, v in built.items()}
    emit("build", seconds=seconds,
         kernels={k: {"path": os.path.relpath(v["path"], REPO),
                      "seconds": v["seconds"], "ptxas": ptxas[k]}
                  for k, v in built.items()},
         hgmma=hgmma, dynamic_shared_bytes=shared)
    for kernel in shared:
        if not hgmma.get(kernel):
            raise AssertionError(f"{kernel} has no HGMMA instruction")
    # K4' at D 128, K2', K3' and K4' at D 16 and 32, and K2-tf32, K3-tf32
    # and K4-tf32 are laid out so that ptxas spills nothing; the delta
    # pass is built at every width and dtype the backward kernels take
    for kernel in ("flash_bwd_dkv_sm90_kernel<D=128>",
                   *(f"{name}<D={d}>" for _, name, d in hopper
                     if "tf32" in name),
                   "flash_fwd_sm90_kernel<D=16>",
                   "flash_fwd_sm90_kernel<D=32>",
                   "flash_bwd_dkv_sm90_kernel<D=16>",
                   "flash_bwd_dkv_sm90_kernel<D=32>",
                   "flash_bwd_dq_sm90_kernel<D=16>",
                   "flash_bwd_dq_sm90_kernel<D=32>"):
        info = ptxas[fa.LIBRARY_SM90].get(kernel, "")
        if "0 bytes spill stores, 0 bytes spill loads" not in info:
            raise AssertionError(f"{kernel} spills or was not built: "
                                 f"{info!r}")
    for d in (*(f"{d}" for d in (16, 32, 64, 128)),
              *(f"{d},f32" for d in TF32)):
        if f"flash_bwd_delta_sm90_kernel<D={d}>" not in ptxas[
                fa.LIBRARY_SM90]:
            raise AssertionError(f"the delta pass is not built at D {d}")


def main():
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import native, placement
    from elasticdl_tpu_torch.training import step_graph

    dev = torch.device("cuda")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         nvcc=run([native.nvcc(), "--version"]).splitlines()[-1])

    timed("build", phase_build)

    k1 = timed("kernel", phase_kernel, dev)
    zoo_streams = timed("zoo_kernel", phase_zoo_kernel, dev)
    manual_shard_launches = timed("manual_shards", phase_manual_shards,
                                  dev, smi)
    report, worst = timed("attn_kernel", phase_attn_kernel, dev)
    attn = timed("attn_times", attn_times, dev, report, worst, smi)
    ring_launches = timed("ring_attn", phase_ring_attn, dev, smi)
    timed("parity", phase_parity)
    parity_launches = timed("lm_parity", phase_lm_parity)
    graph_launches = timed("graph_step", phase_graph_step, smi)
    launches = timed("train", phase_train, smi)
    lm_launches = timed("lm_train", phase_lm_train, smi)
    f32_launches = timed("lm_train_f32", phase_lm_train_f32, smi)
    d128_launches = timed("lm_train_d128", phase_lm_train_d128, smi)
    f32_d128_launches = timed("lm_train_f32_d128", phase_lm_train_f32_d128,
                              smi)
    d16_launches = timed("lm_train_d16", phase_lm_train_narrow, smi,
                         LM_D16_PARAMS)
    d32_launches = timed("lm_train_d32", phase_lm_train_narrow, smi,
                         LM_D32_PARAMS)
    seq_launches, unsplit_losses = timed("seq_train", phase_seq_train, smi)
    seq_mix_launches = timed("seq_mix", phase_seq_mix, dev, smi,
                             unsplit_losses)
    moe_launches = timed("moe_train", phase_moe_train, smi)
    pp_launches = timed("pp_train", phase_pp_train, smi)
    timed("knobs", phase_knobs)
    zoo_train_launches = timed("zoo_train", phase_zoo_train, smi)
    grouped_launches = timed("grouped", phase_grouped)
    with tempfile.TemporaryDirectory() as serving:
        job_launches, job = timed("job", phase_job, smi, serving)
        serve_launches = timed("serve_export", phase_serve_export, smi,
                               serving)
    lm_job_launches = timed("lm_job", phase_lm_job, smi)
    moe_job_launches = timed("moe_job", phase_moe_job, smi)
    timed("job_cli", phase_job_cli, smi)
    k8s_launches = timed("k8s_job", phase_k8s_job, smi)
    timed("zoo_init", phase_zoo_init, smi)
    tools_launches, rio_k1 = timed("tools", phase_tools, dev, smi, job)
    zoo_job_launches = timed("zoo_job", phase_zoo_job, smi)
    tier_launches, tier_pushes = timed("tier", phase_tier, dev, smi)
    cohort_launches = timed("cohort_job", phase_cohort_job, smi, job)
    autoscale_launches = timed("autoscale_job", phase_autoscale_job, smi)
    callbacks_launches = timed("callbacks_job", phase_callbacks_job, smi)
    hybrid_launches = timed("hybrid_mesh", phase_hybrid_mesh, smi)
    PHASE_T0[0] = started
    emit("wall", seconds=time.perf_counter() - started, phases=PHASE_WALLS)

    f32_lm = (fa.FWD, fa.BWD_DQ, fa.BWD_DKV)
    f32_lm_launches = {name: sum(c[name] for c in parity_launches.values())
                       for name in fa.launches}
    # the float32 LMs' steps: the small ones at D 16 and 32 (lm_parity),
    # the full-width ones at D 64 (lm_train_f32) and 128
    # (lm_train_f32_d128)
    tf32_runs = {16: ("lm_parity_d16", parity_launches[16]),
                 32: ("lm_parity_d32", parity_launches[32]),
                 64: ("lm_train_f32", f32_launches),
                 128: ("lm_train_f32_d128", f32_d128_launches)}
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
        "grouped_launches": grouped_launches,
        # the captured DeepFM steps' replays (graph_step), and the
        # launches of every capture's warm-up in this run, which no
        # counter above holds
        "graph_step_launches": graph_launches[placement.KERNEL],
        "warmup_launches": step_graph.warmup_launches[placement.KERNEL],
        # the one-member NCCL cohort's job (both its processes), and the
        # per-rank backward of the manual schedule, 2 and 4 shards
        "cohort_launches": cohort_launches,
        "manual_shard_launches": manual_shard_launches,
        # the zoo's recsys models: 2 a train step of xDeepFM and Wide &
        # Deep, none in the CNNs
        "zoo_train_launches": zoo_train_launches,
        "zoo_job_launches": zoo_job_launches,
        # the embedding tier: device-mode pushes (2 a shard push), the
        # session's backward and pushes, the reshard's pushes
        "tier_launches": tier_launches,
        # the elastic control loop: the autoscaled job's evicted and
        # resumed workers, the callbacks job, the hybrid mesh's steps
        "autoscale_launches": autoscale_launches,
        "callbacks_launches": callbacks_launches,
        "hybrid_mesh_launches": hybrid_launches,
        # the Kubernetes path: both generations of the worker pod
        "k8s_job_launches": k8s_launches,
        # the DeepFM job over converted .rio shards (the tools phase)
        "tools_launches": tools_launches,
        "max_abs_err": max([k1["max_abs_err"], rio_k1["max_abs_err"]] + [
            e["max_abs_err"] for e in zoo_streams.values()]),
        "max_rel_err": max([k1["max_rel_err"], rio_k1["max_rel_err"]] + [
            e["max_rel_err"] for e in zoo_streams.values()]),
        "ms": k1["ms"],
        "device_ms": k1["device_ms"],
        "skewed_30pct_one_id_ms": k1["skewed_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k1["library_ms"],
        "zoo_streams": {name: {k: e[k] for k in (
            "n", "d", "num_rows", "distinct_ids", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "library_ms")}
            for name, e in zoo_streams.items()},
        "tier_pushes": {name: {k: e[k] for k in (
            "n", "d", "num_rows", "in_range_ids", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "library_ms", "push_ms",
            "push_bound_ms")}
            for name, e in tier_pushes.items()},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": ATTN_KERNELS[name][0],
        "replaces": ATTN_KERNELS[name][1],
        # K2-K4 report their launches in the float32 LMs' steps at D 128
        # (lm_train_f32_d128, beside lm_parity's): 0, since no LM's route
        # takes them; the Hopper kernels the
        # bf16 LM's train, eval and predict steps (lm_train), and those of
        # the MoE and pipelined LMs, the MoE job, the in-process ring and
        # Ulysses (ring_attn), the seq mesh's and ring LM's steps
        # (seq_train), and both schedules and the ring LM over head
        # groups (seq_mix)
        "launches": (f32_d128_launches[name] if name in f32_lm
                     else lm_launches[name]),
        "launches_in": "lm_train_f32_d128" if name in f32_lm
        else "lm_train",
        **({"lm_parity_launches": f32_lm_launches[name]}
           if name in f32_lm else {}),
        # the bf16 LMs with 16- and 32-wide heads and the float32 LMs: the
        # delta pass beside K2', K3', K4', K3-tf32 and K4-tf32 (entries of
        # their own below)
        **({"lm_train_d16_launches": d16_launches[name],
            "lm_train_d32_launches": d32_launches[name],
            "lm_train_f32_launches": f32_launches[name],
            "lm_train_f32_d128_launches": f32_d128_launches[name],
            "lm_parity_launches": f32_lm_launches[name]}
           if name == fa.BWD_DELTA_SM90 else {}),
        **({} if name in f32_lm else
           {"lm_train_d128_launches": d128_launches[name],
            "lm_job_launches": lm_job_launches[name],
            "moe_train_launches": moe_launches[name],
            "pp_train_launches": pp_launches[name],
            "moe_job_launches": moe_job_launches[name],
            "ring_attn_launches": ring_launches[name],
            "seq_train_launches": seq_launches[name],
            "seq_mix_launches": seq_mix_launches[name]}),
        # the exported bf16 LM's forward (serve_export): K2' once a layer
        **({"serve_export_launches": serve_launches[name]}
           if name == fa.FWD_SM90 else {}),
        # the captured LM steps' replays (graph_step), and every
        # capture warm-up's launches in this run
        "graph_step_launches": graph_launches[name],
        "warmup_launches": step_graph.warmup_launches[name],
        **attn[name],
    } for name in (fa.FWD, fa.FWD_SM90, fa.BWD_DQ, fa.BWD_DQ_SM90,
                   fa.BWD_DKV, fa.BWD_DKV_SM90, fa.BWD_DELTA_SM90)] + [{
        "name": entry,
        "route": "cuda",
        "source": ATTN_KERNELS[entry][0],
        "replaces": ATTN_KERNELS[entry][1],
        # K4', K2' and K3' launches at D 128 come from the bf16 LM with
        # 128-wide heads only
        "launches": d128_launches[kernel],
        "launches_in": "lm_train_d128",
        **attn[entry],
    } for entry, kernel in ((DKV128, fa.BWD_DKV_SM90),
                            (FWD128, fa.FWD_SM90),
                            (DQ128, fa.BWD_DQ_SM90))] + [{
        "name": entry,
        "route": "cuda",
        "source": ATTN_KERNELS[entry][0],
        "replaces": ATTN_KERNELS[entry][1],
        # K2', K4' and K3' at D 16 and 32 come from the LMs with 16- and
        # 32-wide heads (train, eval and predict)
        "launches": launches[kernel],
        "launches_in": f"lm_train_d{d}",
        **attn[entry],
    } for d, launches in ((16, d16_launches), (32, d32_launches))
        for entry, kernel in zip(NARROW[d], (fa.FWD_SM90, fa.BWD_DKV_SM90,
                                             fa.BWD_DQ_SM90))] + [{
        "name": entries[d],
        "route": "cuda",
        "source": ATTN_KERNELS[entries[d]][0],
        "replaces": ATTN_KERNELS[entries[d]][1],
        # K2-tf32, K3-tf32 and K4-tf32 come from the float32 LMs: the
        # small ones at D 16 and 32 (lm_parity), the full-width ones at D
        # 64 and 128 (train, eval, predict), lm_parity's D 128 LM beside
        "launches": tf32_runs[d][1][kernel],
        "launches_in": tf32_runs[d][0],
        **({"lm_parity_launches": parity_launches[128][kernel]}
           if d == 128 else {}),
        # the captured float32 LM's replays (graph_step, D 64), and the
        # kernel's capture warm-ups in this run at every D
        **({"graph_step_launches": graph_launches[kernel],
            "warmup_launches": step_graph.warmup_launches[kernel]}
           if d == 64 else {}),
        **attn[entries[d]],
    } for entries, kernel in ((TF32, fa.FWD_TF32), (DQ_TF32, fa.BWD_DQ_TF32),
                              (DKV_TF32, fa.BWD_DKV_TF32))
        for d in entries]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
