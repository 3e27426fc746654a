#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py
  python3 chip_smoke.py --ab PARENT   # moe_gemm, the selective scan,
                                      # the xLSTM scans and their
                                      # backwards, the f32 flash kernels
                                      # against another checkout
  python3 chip_smoke.py --apps        # phases 1 and 33 alone (the apps;
                                      # no kernel build, no result line)
  python3 chip_smoke.py --procs       # phases 1 and 35 alone (the process
                                      # backend; no build, no result line)
  python3 chip_smoke.py --examples    # phases 1 and 36 alone (the port's
                                      # examples; no result line)
  python3 chip_smoke.py --optimizer   # phases 1 and 37 alone (the fused
                                      # clip and AdamW at every training
                                      # path's leaves; no result line)

Run from the repository root on a machine with a Hopper card and `nvcc`.
With `--ab PARENT` (a checkout of another commit, e.g. unpacked from `git
archive` into a directory `.gitignore` lists) it only compares the
`moe_gemm` kernels of the two trees (`compare_trees`: bf16; f32 in
`compare_f32`), their selective
scans (`compare_scans`), their xLSTM forward scans (`compare_xlstm`),
the xLSTM backwards (`compare_xlstm_bwd`) and the f32 flash forward and
backward (`compare_flash_f32`: both trees in turns with SDPA at the path
and whisper encoder shapes, each kernel alone, and a full-width
qwen2-0.5b f32 train step's flash share under the profiler), each
through its own tree's wrapper. With no argument,
phases, in order; any failure raises and exits non-zero (no phase catches
its own failure):

  1. the card's name and power limit (nvidia-smi); TF32 off for f32;
  2. build the `moe_gemm` (forward and backward), `flash_attention`,
     `ssm_scan`, `xlstm_scan` and `xlstm_scan_bwd` kernels from
     `src/repro_torch/kernels/csrc/` with nvcc for sm_90a, one nvcc per
     source, and a copy of `ssm_scan.cu` for each selective-scan split of
     SEL_SPLITS (phase 11 times them), all started together; print the
     build times and ptxas's report
     (registers, spills, static smem, warnings) for every kernel, the bf16
     tensor-core ones included (the xLSTM scans and their backwards at hd
     192 and 16 of their 16 head dims), the mLSTM's layout, dynamic smem
     and blocks an SM, its backward's (the states pass's and the chunk
     kernel's), the sLSTM's cluster layout and how
     many clusters the card holds at once, its backward's, the flash
     kernels' dynamic smem
     (forward, dq and dk/dv, each in both routes), the selective scan's
     and its backward's dynamic smem (both dtypes), the three scan
     kernels' resident blocks an SM, the backward's channels a block and
     the steps between the states the forward keeps; fail unless ptxas
     reports each instantiation of the f32 GEMM `moe_gemm_f32_kernel` (the
     forward in 128- and 16-row tiles, dx, dw) and of the f32 flash
     kernels (forward, dq, dk/dv and the group sum at hd 16, 64 and 128)
     with no spill;
  3. `moe_gemm` and its backward kernels (dx, dw) against their plain
     PyTorch versions on the card, in bf16 (wgmma/TMA) and f32 (CUDA
     cores): the qwen2-moe serving path's two shapes, the Jamba prefill's
     (C=640) and Jamba decode's, the MoE train shapes (C=640), the Jamba
     train shapes (E=16, C=1280, d=4096, f=14336),
     qwen3-moe's E=128 experts at decode, up and down, a ragged shape, one
     with d and f not multiples of 8 (bf16 goes through the padding), and
     the persistent backward's edges: one expert with fewer tiles than
     SMs, 2 x SMs + 1 tiles, one expert whose rows span many tiles; in
     f32 also the f32 GEMM's edges: the contraction under one chunk, C at
     the forward's route threshold and one row either side, one expert
     whose output spans many tiles with d and f ragged; the
     backward's two calls bit for bit and exact zeros for an expert no
     token reaches (with one expert: for all-zero x and dy); expert
     isolation; a SHA-256 digest of the bf16 forward's output on seeded
     inputs (to compare two trees' forwards bit for bit); f32 batch
     invariance: the forward's and dx's first c1 rows of a C = 640 call,
     for c1 across the route threshold, bit for bit against the call on
     those rows alone; times (CUDA
     events, median after warm-up) of the kernel, the plain version and
     `torch.bmm` for one MoE layer at the qwen2-moe serving shapes (bf16
     and f32), at the Jamba prefill's and at Jamba decode's, and of the
     forward, dx and dw at the MoE train shapes in both routes and at the
     Jamba train shapes in bf16 (kernel and `torch.bmm` in turns), beside
     the least time the card could take; dw's K sweep (C = 320 ... 2560
     at E=64, d=2048, f=1408): its fixed cost and main-loop rate; the f32
     forward's C sweep (C = 16 ... 640 at the qwen2-moe gate/up dims)
     through its 16- and 128-row tiles' C entry points and `torch.bmm`,
     from which the wrapper's route threshold is set;
  4. the flash-attention forward and backward kernels (bf16 on tensor
     cores, f32 on CUDA cores) against their plain versions (and the
     backward against autograd through `attention_ref`) at every
     ATTN_CASES case, each with its own causal flag: the training path's
     shape, the forward at the Jamba prefill's (S=4096, 32:8 heads, hd
     128), a ragged S, MQA at head dim 128, causal + window + softcap,
     whisper-base's encoder layer (B=16, S=T=1500, 8:8, hd 64, not
     causal) and its decoder's self-attention (B=16, S=T=448, causal),
     a non-causal call with S=200 and a ragged T=333, and
     gemma2-27b's local (window 4096) and global layers at S=8192 and
     6144, 32:16, hd 128, softcap 50, in bf16 and f32 (the plain versions run a few
     heads at a time where their f32 scores would pass 4 GiB); two
     backward calls on the same inputs give bit-identical dq, dk and dv;
     the f32 forward's rows 0-1,023 at the path's shape equal a call on
     the first 1,024 positions bit for bit, and its batch row 1 a call
     on that row alone; times of the kernels, the plain versions and
     `scaled_dot_product_attention` (where it computes the same function:
     no window, no softcap) at the path's shape (forward and backward in
     both dtypes, and the backward's dq and dk/dv kernels each alone in
     both, the f32 group sum alone and the f32 dk/dv kernel on its other
     grid), of the bf16 forward at the Jamba shape, at the whisper
     encoder's and decoder's and at gemma2's prefill shapes, and of the
     bf16 forward and backward at the whisper encoder's and decoder's and
     gemma2's train shapes (S=6144), beside their bounds (the live
     (query, key) pairs' products);
  5. slice 1's main path: `serve()` on full-width qwen2-moe-a2.7b with
     random bf16 weights from a seeded generator, with the `moe_gemm`
     launch count set to 0 just before and read just after;
  6. where a full-width decode step's time goes: host wall per step, then
     a torch.profiler window over the same steps for device busy time by
     kernel (device idle share = 1 - busy / wall);
  7. the tiny qwen2-moe engine in f32 on the card gives the same tokens as
     the port's greedy decode for each request, through the private drain
     loop and through a runtime-backed engine (`ServeEngine(runtime=)` on
     `TaskRuntime(num_workers=2, mode="ddast", num_clients=2)`, two
     clients);
  8. `moe_gemm`'s gradients through its autograd Function (the dx and dw
     kernels) equal autograd through `moe_gemm_ref`, in bf16 and f32, one
     launch of each a call, and dw alone when only the weight requires
     grad;
  9. slice 2's main path: `train()` on full-width qwen2-0.5b, 6 steps of
     B=4 x S=2048 in bf16, with the flash-attention launch counts set to
     0 just before and read just after; the step's host wall with and
     without a running `TaskRuntime(num_workers=2, mode="ddast")` (the
     trainer's host runtime); then a torch.profiler window over
     two train steps, with the launch counts set to 0 just before and
     read just after (exactly 24 flash forwards and 48 backward kernels a
     step); the profiler's records of each bf16 kernel
     (`flash_fwd_mma_kernel`, `flash_bwd_dq_mma_kernel`,
     `flash_bwd_dkdv_mma_kernel`) are printed beside the wrappers' counts
     with the number it dropped, must not exceed them, and hold none of
     the CUDA-core flash kernels;
 10. tiny qwen2-0.5b training in f32 on the card: the loss falls over 24
     steps, and a resume from the step-24 checkpoint to step 30 equals a
     straight run to step 30; the flash launch counts of these 60 steps
     (the f32 routes' launches: a forward and three backward kernels an
     attention layer; no moe_gemm);
 11. the selective-scan and linear-scan kernels against their plain
     versions, in bf16 and f32: the Jamba prefill path's shape (B=1,
     S=4096, D=8192, N=16), S=4097 with D=8200 beside it, B=2, a ragged S
     and D, a state dim that is not a power of two, h0 given (h_last held
     too, and not given), B and C as strided column slices; two calls on
     the same inputs bit for bit (both kernels), and the selective scan's
     state carried across two calls equal to one call bit for bit; the
     linear scan also
     on LIN_DEEP, 2,048 tiles 1,024 deep in time against ~260 resident
     blocks (look-back waits on tiles still loading); the linear scan's
     carried pair goes through `ops.ssm_scan` with its launch count set to
     0 just before and read just after (within 1e-4: the look-back
     associates differently across the split); times of kernels (through
     their wrappers by plain CUDA events, as every kernel here, and behind
     a queued device sleep) and plain versions beside their bounds, and
     the selective scan in every (states a thread, of them on the FMA
     pipes) split of SEL_SPLITS, each built as its own copy of the source
     (no single PyTorch call computes either scan), and a SHA-256 digest
     of the selective scan's y and h_last on seeded inputs (to compare
     two trees' kernels bit for bit); then the selective scan's
     backward kernel and its second pass against
     `selective_scan_bwd_ref` at every SCAN_CASES shape (the Jamba train
     path's, B=2 S=4096, among them) and SCAN_BWD_EDGES shape (S inside
     one segment and one step past a segment or chunk, fewer blocks than
     SMs, D off the channel block and odd), in bf16 and f32, with h0 and a
     dh_last cotangent and without either, B and C strided: two calls bit
     for bit, the forward that keeps the segment states bit-identical to
     the plain one; gradients through `selective_scan`'s autograd Function
     equal autograd through `selective_scan_ref`; the backward's time at
     the train path's shape (CUDA events, and behind a device sleep)
     beside its bound and the plain version, and the forward's with and
     without the states kept;
 12. slice 3's main path: `make_prefill_step` on full-width Jamba cut to
     2 of its 4 periods (16 layers), random bf16 weights from a seeded
     generator, B=1 x S=4096, with the selective-scan, flash-forward and
     moe_gemm launch counts set to 0 just before and read just after
     (14, 2 and 24 a call); ms per prefill, tokens/s, peak memory; then
     a torch.profiler window over one prefill;
 13. the serving engine on the same weights and the traffic of phase 5:
     moe_gemm launches 24 a step and no selective scan (decode takes the
     recurrence in plain ops);
 14. tiny Jamba with the full 8-position pattern, in f32 on the card:
     decode step by step equals the forward (which runs the scan and
     flash kernels) within 1e-4, and the engine equals greedy decode;
     under grad `selective_scan` runs its autograd Function and only
     `ssm_scan` raises;
 15. slice 7's main path: `make_train_step` on full-width qwen2-moe-a2.7b
     cut to 4 of its 24 layers, random bf16 weights from a seeded
     generator, f32 AdamW, 6 steps of B=4 x S=2048, with the moe_gemm
     (forward, dx, dw) and flash launch counts set to 0 just before and
     read just after (12, 12, 12, 4 and 8 a step); step wall, tokens/s,
     peak memory; then a torch.profiler window over two more steps;
 16. tiny qwen2-moe training in f32 on the card, as phase 10: the loss
     falls, a resume is exact; the f32 routes' launches of its 60 steps
     (forward, dx and dw 360 each);
 17. slice 8's main path: `make_train_step` on full-width Jamba cut to
     layers 0-1 of its period (Mamba + MLP, Mamba + 16-expert top-2 MoE;
     3,733,864,448 parameters by `ModelConfig.param_count`), random bf16
     weights from a seeded generator, f32 AdamW, 6 steps of B=2 x
     S=4096, with the launch counts set to 0 just before and read just
     after (a step: selective scan 2, its backward 2 and the backward's
     second pass 2, moe_gemm forward, dx and dw 3 each, flash 0); step
     wall, tokens/s, peak memory; then a torch.profiler window over two
     more steps;
 18. tiny Jamba training in f32 on the card through `train()`, as phase
     10: the loss falls, a resume is exact;
 19. slice 11's main path: `make_prefill_step` on full-width gemma2-27b,
     all 46 layers (23 local with the 4096-key window, 23 global, every
     one softcapped; 27,226,275,840 parameters by `param_count`), random
     bf16 weights from a seeded generator, B=1 x S=8192, with the launch
     counts set to 0 just before and read just after (46 flash forwards
     a call, 23 at the local layer's shape and 23 at the global's, by
     the wrapper's count by call shape); ms per prefill, tokens/s, peak memory; then a
     torch.profiler window over one prefill;
 20. the serving engine on the same weights and the traffic of phase 5:
     no flash launch (decode takes the plain op);
 21. `make_train_step` on full-width gemma2-27b cut to one period (a
     local and a global layer, 2,312,110,080 parameters), f32 AdamW, 6
     steps of B=1 x S=6144 (at 8192 the loss's f32 logits ran out of
     memory), with the launch counts set to 0 just before and read just
     after (2 flash forwards and 4 backward kernels a step, half of each
     at either layer's shape);
     step wall, tokens/s, peak memory; a torch.profiler window over two
     more steps;
 22. `train()` on full-width whisper-base, 6 steps of B=16 x S=448 over
     1,500 zero frames, launch counts set to 0 just before and read just
     after (12 flash forwards a step: 6 encoder layers not causal, 6
     decoder layers causal, counted by call shape; 24 backward kernels;
     cross-attention on the plain op); step wall, tokens/s, peak memory; then a torch.profiler
     window over two steps, gated on the wrappers' counts as in phase 9
     (12 flash forwards and 24 backward kernels a step);
 23. whisper-base decode, B=4: `fill_cross_cache` over seeded frames (6
     encoder flash launches), then 32 greedy `decode_step`s (none); ms per
     step; max |decode - forward| in bf16;
 24. tiny whisper in f32 on the card: decode after `fill_cross_cache`
     equals the forward (through the kernels) within 1e-4, with a decoder
     S that is not encoder_seq;
 25. tiny whisper training in f32 on the card through `train()`, as phase
     10: the loss falls, a resume is exact;
 26. the xLSTM scan kernels (the mLSTM's chunkwise pair
     `mlstm_scan_state_kernel` and `mlstm_scan_out_kernel`, and
     `slstm_scan_kernel`, which compute the lax.scan the JAX package runs:
     no TPU kernel) against their plain versions in f32 at every
     XLSTM_CASES shape: the prefill path's (B=8, S=32,768, H=4, hd 192),
     B=1, a ragged S, the tiny hd 16, S=1 and hd 256 with a part-empty
     cluster; two calls bit for bit; at the path shape each kernel's error
     against a float64 plain run of the first XLSTM_F64_SEQ steps, at most
     XLSTM_F64_FACTOR times its plain f32 version's, the times (CUDA events through the wrapper, and behind
     a device sleep), us a step, the plain version's one call and the
     bound (f32 CUDA-core operations or bytes; the mLSTM's also that of
     the chunkwise form's own work), the mLSTM's two kernels each alone
     behind the sleep and its chunkwise mirror (several PyTorch calls);
     the times again at the train shape 8 x 2048; then the
     backward kernels (the mLSTM's four in the chunkwise form, prep,
     states, chunks and gates, on the chunk states and den' its keeping
     forward left, whose y is the inference kernels' bit for bit; the
     sLSTM's reverse walk, after the trail-keeping forward, held against
     `slstm_scan_trails_ref`) against their plain mirrors
     (`mlstm_scan_bwd_chunkwise_ref`, `slstm_scan_dpre_affine_ref`) and
     the step forms `mlstm_scan_bwd_ref` and `slstm_scan_bwd_ref` at
     every XLSTM_BWD_CASES shape (XLSTM_CASES with the B=1 shape, S=4,096,
     as the long case, and the train cell's 8 x 2048), a dy of seeded
     noise, two calls bit for bit, the share of steps past each clamp
     (|n . q| > 1, n > 1); through the autograd Functions against
     autograd of the plain scans at small shapes; at S=4,096 each
     kernel's, its mirror's and
     the step form's error against a float64 plain backward; at the train
     shape the times (CUDA events, and behind a device sleep; the
     mLSTM's four kernels each alone behind the sleep), us a step, the
     bounds (the mLSTM's also its chunkwise work's), the plain version's
     and the mirror's one call;
 27. slice 12's main path: `make_prefill_step` on full-width xlstm-125m
     (12 layers: 9 mLSTM, 3 sLSTM), random bf16 weights from a seeded
     generator, B=8 x S=32,768 (the prefill_32k sequence; B cut from 32,
     where the bf16 logits alone would take 105.5 GB), with the launch
     counts set to 0 just before and read just after (9 mlstm_scan and 3
     slstm_scan a call, nothing else); ms per prefill, tokens/s, peak
     memory; a torch.profiler window over one prefill;
 28. the serving engine on the same weights and the traffic of phase 5:
     no scan launch (decode takes the one-step recurrence in plain ops, as
     in JAX);
 29. tiny xlstm in f32 on the card: decode step by step equals the forward
     (both scan kernels at hd 16) within 1e-4, and the engine (four
     requests through two slots) equals greedy decode with no scan launch;
 30. slice 13's main path: `make_train_step` on full-width xlstm-125m (12
     layers, 9 mLSTM + 3 sLSTM), random bf16 weights from a seeded
     generator, f32 AdamW, 6 steps of B=8 x S=2048 (the training context
     of arXiv:2405.04517), with the launch counts set to 0 just before and
     read just after: a step runs 9 `mlstm_scan` and each of its four
     backward kernels 9 times, 3 trail-keeping `slstm_scan` and 3 of its
     backward, and no other kernel of the port; step wall, tokens/s, peak
     memory, then a torch.profiler window over two more steps;
 31. tiny xlstm training in f32 on the card through `train()`: the loss
     falls, a resume is exact, and the launches are 60 steps' worth;
 32. slice 16's main path: the runtime-backed engine, `ServeEngine(...,
     runtime=rt)` on `TaskRuntime(num_workers=2, mode="ddast",
     num_clients=4)`, on full-width qwen2-moe-a2.7b in bf16 with phase 5's
     weights (seed 0) and traffic (16 requests from 4 client threads, 8
     new tokens each, 4 slots), beside the private drain loop on the same
     model object (private, runtime-backed, private): moe_gemm launches,
     set to 0 just before and read just after, 72 a step; every request's
     tokens equal the private loop's; each client's scope admitted its 4
     requests and ran 4 tasks; ms/step of both; then `decode_profile` of
     both engines on the same model (all slots decoding: host wall, and
     device busy and idle share under torch.profiler);
 33. slice 17's path: the paper's three applications
     (`repro_torch.core.taskgraph_apps`) on the card through `TaskRuntime(
     num_workers=4)` in each of `sync`, `dast`, `ddast` and `sharded`, f32
     inputs from seeded numpy, every body on the caller's stream: Matmul
     coarse (n=16,384, blocks of 2,048: 512 GEMMs of 17.2 GFLOP) and fine
     (n=8,192, blocks of 512: 4,096 of 0.27 GFLOP), against one float64
     `torch.matmul` on the card; the fine products in a plain loop on this
     thread (no runtime), bit-identical to the runtime's; the fine run on
     a side stream and under a `DynamicTuner`, both bit-identical to the
     default-stream run; `run_matmul_epochs` x3 under `replay=True` equal
     to 3 A@B; Sparse LU (n=4,096, blocks of 256, M = rand + n I: 1,496
     tasks) against the float64 sequential oracle (each factor apart);
     nested N-Body (N=16,384, blocks of 1,024, 4 steps, masses summing to
     ~0.5) against the float64 oracle; each app bit-identical across the
     four modes, within APP_TOL of float64; for every run the wall,
     `tasks_executed`, tasks/s over the graph (first submit to the card's
     last kernel) and host us a task (first submit to the root taskwait's
     return, over the tasks); peak memory; a torch.profiler window over one
     `ddast` run each of coarse and fine Matmul: device busy, idle share,
     launches by group;
 34. slice 18's path, the roofline and the dry-run: the card's own
     peaks (a bf16 `torch.matmul` at 8192^3 and a 1 GiB device-to-device
     copy, CUDA events, median after warm-up) beside the data sheet's
     (`repro_torch.analysis.roofline.PEAKS`), failing if either measured
     rate passes 105% of its figure; the model-level work of phase 9's
     train step (qwen2-0.5b, B=4 x S=2048) and of phase 5's decode step
     (qwen2-moe-a2.7b, 4 slots against the engine's 64-row cache),
     counted by `StepCounter` on fake host tensors at those shapes on a
     1 x 1 mesh (`lower_cell(..., mesh_shape=(1, 1))`): `model_flops`,
     the counted flops, `useful_ratio` and the share of the card's bf16
     peak each reaches over the wall and over the device-busy time that
     phases 5, 6 and 9 measured; then one full-size dry-run cell on this
     machine's host, `perf.py`'s `small_baseline` (qwen2-0.5b train_4k on
     the 16 x 16 fake world): its record and its time, failing on an
     error, on collectives that are all zero, or on a process group left
     initialised;
 35. slice 19's path, the process backend (`repro_torch.core.procs`):
     `ProcessRuntime(num_workers=4, device="cuda")` started from the fork
     server (launched after phase 1, so that its preload of torch and
     the port runs beside phases 2-34) in this process, whose CUDA is
     long initialised; every worker
     makes its own CUDA context before it says it is ready (start method,
     start-up seconds and pids printed), f32 data from seeded numpy in
     `procs.apps.DeviceArray`s that the workers attach by CUDA IPC handle,
     TF32 off: the fine Matmul (n=8,192 in blocks of 512, 4,096
     `addmm_(beta=0.999)` tasks) in each of the four modes and, on the
     same kernels and arrays, on `TaskRuntime(num_workers=4)` in each
     mode: graph wall, tasks/s, host us a task, the bodies' own seconds
     and the per-task device synchronisations' (the counter plane's
     `exec_time_s`, `sync_time_s`); every result bit-identical to
     `run_serial` of the same calls in this process, which is within
     PROC_TOL of a float64 run of the same recurrence on the card; the
     Matmul x3 under `replay=True` (no Submit or Done frame on the
     replayed epochs, equal to three serial epochs); Sparse LU (PROC_LU)
     and flat N-Body (PROC_NBODY) in `sharded`, each serial-exact; the
     chaos suite's ping-pong stencil on device arrays under a seeded
     worker kill with retries (serial-exact, a respawn, no leaked
     segment or semaphore), then a CUDA call in the respawned worker
     (its pid and result printed); the phase's time (within 60 s);
 36. slice 20's path, the port's examples (`examples/torch_*.py`), each
     imported and its `main(device="cuda")` run at its own defaults but
     EXAMPLE_CUTS, with the kernel launch counts set to 0 just before each
     and read just after: the quickstart (Matmul 128 in blocks of 32 on
     `TaskRuntime` in sync and ddast, within APP_TOL of float64), the
     multi-tenant scopes (three tenants, four replayed epochs each), the
     serving tour (tiny qwen2-0.5b, 24 requests from 4 clients, 12 tokens
     each; no kernel: it decodes through the plain attention op), the
     training tour (tiny qwen2-0.5b in bf16, 40 steps of 8 x 128 and a
     resume to 50, through the flash forward and backward kernels: their
     launches must be 50 steps' worth), Sparse LU (128 in blocks of 32,
     within APP_TOL of the numpy oracle; the simulator at 16 cores), and
     the process backend's tour (spin chains on threads and processes;
     N-Body on device arrays by CUDA IPC, bit-identical to `run_serial`;
     a merged trace); then the flash kernels against their plain versions
     at the shapes the training tour gave them (`check_flash_case`); each
     example's time and the phase's (within 60 s);
 37. the fused clip and AdamW (`train/optimizer.py` `ClipAndAdamW`,
     `kernels/adamw.py`) at the leaves of every training phase (9, 10,
     15-18, 21, 22, 25, 30, 31) and of the benchmark's training cell
     (`port_bench`'s qwen2-moe-a2.7b, views of one buffer a dtype, f32
     routers): seeded gradients in each parameter's dtype and drawn m and
     v, one clipped step on the fused pass (one launch of each kernel,
     every leaf counted fused, none plain), its norm within 1e-5 of
     `global_norm`, and each leaf's p, m and v bit-equal to `adamw_update`
     given the fused norm's scale, on copies kept on the host; then each
     kernel alone by CUDA events against its bytes bound (the training
     phases themselves count one launch of each kernel a step, and their
     fused and plain leaves);
 38. the seconds of each phase (from its start to the next one's), then
     a JSON line with the kernels' numbers (the bf16 and f32 routes of
     `moe_gemm`, of its backward and of the flash forward and backward as
     entries of their own, the flash entries with the whisper encoder's
     and gemma2's shapes and the training tour's launches; the selective
     scan's backward; the two xLSTM scans and their backwards; the fused
     clip and AdamW), then, last, the result line {"ok": true, "device":
     {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import ctypes
import gc
import hashlib
import importlib
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.roofline import peaks_for  # noqa: E402
from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DynamicTuner, FaultPlan, ProcessRuntime, TaskRuntime, TunerConfig)
from repro_torch.core.procs import apps as papps, chaos  # noqa: E402
from repro_torch.core.procs.driver import start_fork_server  # noqa: E402
from repro_torch.core.taskgraph_apps import (  # noqa: E402
    matmul_oracle_torch, nbody_oracle_torch, run_matmul, run_matmul_epochs,
    run_nbody, run_sparselu, sim_sparselu_specs, sparselu_oracle_torch)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import adamw as fused_adamw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels.moe_gemm import (  # noqa: E402
    load as mg_load, moe_gemm, moe_gemm_bwd_dw, moe_gemm_bwd_dx)
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref, flash_attention_bwd_ref, flash_attention_ref,
    mlstm_scan_bwd_chunkwise_ref, mlstm_scan_bwd_ref,
    mlstm_scan_chunkwise_ref, mlstm_scan_ref, moe_gemm_bwd_ref,
    moe_gemm_dw_ref, moe_gemm_dx_ref, moe_gemm_ref, selective_scan_bwd_ref,
    selective_scan_ref, slstm_scan_bwd_ref, slstm_scan_dpre_affine_ref,
    slstm_scan_dpre_ref, slstm_scan_ref, slstm_scan_trails_ref, ssm_scan_ref)
from repro_torch.kernels import ssm_scan as sscan  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    selective_scan, selective_scan_bwd, ssm_scan)
from repro_torch.kernels import xlstm_scan as xls  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.launch.serve import serve, serve_requests  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.layers import padded_vocab  # noqa: E402
from repro_torch.models.moe import capacity, padded_experts  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import greedy_decode  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    ClipAndAdamW, OptConfig, adamw_update, global_norm, init_opt_state)
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig, make_prefill_step, make_train_step)

ARCH = "qwen2-moe-a2.7b"
SLOTS, CLIENTS, REQUESTS, MAX_NEW = 4, 4, 16, 8
MOE_TRAIN_REPEATS = 4                    # of qwen2-moe-a2.7b's 24 layers
QWEN3 = "qwen3-moe-235b-a22b"            # the zoo's E=128 expert shape
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 2048


class AttnCase(NamedTuple):
    """A flash-attention call: q [B,S,nq,hd], k/v [B,T,nkv,hd] (T = S
    unless given; a causal mask or a window needs S == T)."""
    b: int
    s: int
    nq: int
    nkv: int
    hd: int
    window: Optional[int]
    softcap: Optional[float]
    causal: bool
    t: Optional[int] = None

    @property
    def kw(self) -> dict:
        return dict(causal=self.causal, window=self.window,
                    softcap=self.softcap)


GEMMA2 = "gemma2-27b"
WHISPER = "whisper-base"
ATTN_CASES = {"path": AttnCase(4, 2048, 14, 2, 64, None, None, True),
              "jamba": AttnCase(1, 4096, 32, 8, 128, None, None, True),
              "ragged S=200": AttnCase(2, 200, 14, 2, 64, None, None, True),
              "MQA 4:1 hd128": AttnCase(2, 256, 4, 1, 128, None, None, True),
              "window+softcap": AttnCase(1, 256, 4, 2, 64, 64, 50.0, True),
              # whisper-base's encoder layer at the train cell's B=16:
              # bidirectional, S = T = 1500 frames (23 full 64-key tiles
              # and one of 28)
              "whisper encoder": AttnCase(16, 1500, 8, 8, 64, None, None,
                                          False),
              # its decoder's self-attention: causal, S = T = 448 tokens
              # (cross-attention, S != T, takes the plain op)
              "whisper decoder": AttnCase(16, 448, 8, 8, 64, None, None,
                                          True),
              # not causal, S != T and both ragged: the T edge of every
              # q tile, and q tiles past the keys' length
              "non-causal ragged T": AttnCase(2, 200, 4, 2, 64, None, None,
                                              False, t=333),
              # gemma2-27b's layers at the prefill's S=8192 and the train
              # cell's 6144: local (window 4096) and global, both with the
              # attention softcap
              "gemma2 local": AttnCase(1, 8192, 32, 16, 128, 4096, 50.0,
                                       True),
              "gemma2 global": AttnCase(1, 8192, 32, 16, 128, None, 50.0,
                                        True),
              "gemma2 train local": AttnCase(1, 6144, 32, 16, 128, 4096,
                                             50.0, True),
              "gemma2 train global": AttnCase(1, 6144, 32, 16, 128, None,
                                              50.0, True)}
ATTN_FWD_ONLY = ("jamba",)               # the prefill runs no backward
JAMBA = "jamba-v0.1-52b"
JAMBA_REPEATS, PREFILL_SEQ = 2, 4096     # 2 of 4 periods; S cut from 32,768
# Jamba training: layers 0-1 of the period (Mamba + MLP, Mamba + MoE),
# B x S = 8,192 tokens a step as in the other train cells
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ = 2, 2, 4096
JAMBA_TRAIN_PARAMS = 3_733_864_448       # ModelConfig.param_count of the cut
# gemma2-27b: prefill at its 8,192-token context, all 46 layers; train one
# period (a local and a global layer) at B=1 x 6,144: at 8,192 the loss's
# f32 copies of the 256,000-entry logits in the backward do not fit beside
# the weights and the f32 AdamW state on an 80 GB H100; 6,144 is still
# past the 4,096-key window
GEMMA2_SEQ, GEMMA2_TRAIN_SEQ = 8192, 6144
GEMMA2_PARAMS = 27_226_275_840
GEMMA2_TRAIN_PARAMS = 2_312_110_080
# whisper-base: 16 x 448-token texts (its decoder context) over 1,500
# encoder frames a train step; decode 4 streams for 32 greedy steps
WHISPER_BATCH, WHISPER_SEQ = 16, 448
WHISPER_DECODE_BATCH, WHISPER_DECODE_STEPS = 4, 32
# (B, S, D, N) of the scans; "path" is the Jamba prefill's (D = 2 x 4096)
SCAN_CASES = {"path": (1, PREFILL_SEQ, 8192, 16),
              "train": (JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, 8192, 16),
              "S=4097 D=8200": (1, PREFILL_SEQ + 1, 8200, 16),
              "B=2": (2, 1024, 8192, 16),
              "ragged S=1000 D=200": (2, 1000, 200, 16),
              "N=5": (1, 300, 72, 5)}
# the selective-scan backward's edges (h kept every 16 steps, 64-channel
# blocks of 2-channel pairs), held against the plain version beside
# SCAN_CASES: S inside one segment (1, 15), one step past a segment (17)
# and past the forward's 32-step chunk (33), S=31; fewer blocks than SMs
# (B=1, D=200: 4 blocks); D off the 64-channel block (200, 96) and odd
# (201: the last pair half outside D, every row's pairs unaligned)
SCAN_BWD_EDGES = {"S=1": (1, 1, 64, 16), "S=15 D=200": (1, 15, 200, 16),
                  "S=17": (2, 17, 64, 16), "S=31 D=96": (1, 31, 96, 16),
                  "S=33 D=201 N=7": (2, 33, 201, 7),
                  "B=1 D=200": (1, 100, 200, 16)}
# (B, S, D) of a linear scan with 2,048 tiles of 64 steps, 1,024 deep in
# time: far more than the card holds blocks at once, so look-backs wait on
# tiles still loading and walk back over aggregates
LIN_DEEP = (1, 65536, 512)
# (states a thread, of them on the FMA pipes) of the selective scan: phase
# 2 builds a copy of ssm_scan.cu for each (-DSEL_SCAN_R, -DSEL_SCAN_P) and
# phase 11 times them beside one another; the wrapper uses the split the
# source itself defines
SEL_SPLITS = ((2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (8, 0), (8, 3))
SCAN_SPLIT = 1000                        # carried state: steps of call 1
# xlstm-125m prefill: the repo's prefill_32k sequence, B cut from that
# shape's 32 to 8 (its bf16 logits alone: 105.5 GB at 32, 26.4 GB at 8)
XLSTM = "xlstm-125m"
XLSTM_BATCH, XLSTM_SEQ = 8, 32768
# (B, S, H, hd) of the xLSTM scans: the prefill path's (hd 192), B=1, a
# ragged S, the tiny config's hd 16, S=1, and hd 256 (the largest the
# kernels take) at B=5 (a cluster's 4 batch rows, 3 of the second past B)
XLSTM_CASES = {"path": (XLSTM_BATCH, XLSTM_SEQ, 4, 192),
               "B=1": (1, 4096, 4, 192),
               "ragged S=1001": (2, 1001, 4, 192),
               "tiny hd=16": (2, 300, 4, 16),
               "S=1": (3, 1, 4, 192),
               "hd=256 B=5": (5, 77, 2, 256)}
# kernel vs plain, f32 (|diff| <= tol * (1 + |plain|)): the mLSTM's
# chunkwise form sums the step form's terms in another order (C q_t and
# the chunk's own terms as q k^T weighted, relative ~1e-5 of the sum of
# |terms| at hd 192, y up to ~20); the sLSTM's h lies in (-1, 1), its
# hd-term matvec rounds as the plain version's but for the sum order, its
# gates through the cell's short forms (a few ulps)
XLSTM_TOL = {"mlstm_scan": 1e-4, "slstm_scan": 1e-5}
# xlstm-125m training: the training context of arXiv:2405.04517 (2,048
# tokens), B=8 (the sLSTM backward then runs 8 clusters, one wave)
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 8, 2048
# (B, S, H, hd) of the backward checks: XLSTM_CASES with the long case at
# B=1 x S=4,096 (the plain backward walks S four times in Python: the
# prefill path's 32,768 took ~4 min of the run's limit; the backward's own
# path is the train shape), and the train cell's shape
XLSTM_BWD_CASES = {**{k: v for k, v in XLSTM_CASES.items() if k != "B=1"},
                   "path": XLSTM_CASES["B=1"],
                   "train": (XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, 4, 192)}
# backward kernel vs plain, f32: max |diff| <= tol * max |plain| over each
# gradient (sums over hd, the bands and time in other orders; the gates'
# gradients sum q . dq - k . dk over the rest of the sequence)
XLSTM_BWD_TOL = 1e-4
# at the long S (the forward's first 8,192 of its 32,768 steps, the
# backward's 4,096) a kernel's error against a float64 plain run (of the
# forward or the backward) may be at most this many times the plain f32
# version's (the same f32 arithmetic, summed in other orders)
XLSTM_F64_FACTOR = 2.0
# the forward's float64 walk covers this prefix of the path shape's
# 32,768 steps (the whole walk took ~17-23 s a scan)
XLSTM_F64_SEQ = 8192
BACKLOG_CYCLES = 20_000_000              # ~10 ms of device sleep
# dw's contraction C = K of the K sweep (phase 3), at the MoE train gate/up
# shape's (E, d, f): time against 64-deep k-steps gives the main loop's
# rate (slope) and the fixed cost of the tiles (intercept)
DW_SWEEP_C = (320, 640, 1280, 2560)
DW_SWEEP_EDF = (64, 2048, 1408)
# C of the f32 forward's route sweep (phase 3), at the qwen2-moe gate/up
# dims: the wrapper's F32_NARROW_MAX_C is set from it
F32_SWEEP_C = (16, 24, 32, 48, 64, 80, 96, 112, 128, 192, 256, 384, 512,
               640)
# the forward's output digest: (E, C, d, f), the MoE train gate/up shape
FWD_DIGEST_SHAPE = (64, 640, 2048, 1408)
SFU_PER_CLOCK = 16                       # exp2 results a clock on an SM
# f32 flops an exp2 costs on the FMA pipes instead of the SFU: range
# reduction and a degree-3 polynomial, ~5 instructions of 2 flops' issue
# time each (the software exp2 of FlashAttention-3/4)
EXP2_FMA_FLOPS = 10

# Phase 33: the paper's three applications on TaskRuntime(APP_WORKERS)
APP_WORKERS = 4
APP_MODES = ("sync", "dast", "ddast", "sharded")
MM_COARSE, MM_FINE = (16384, 2048), (8192, 512)      # (n, block)
MM_EPOCHS = 3
# (n, block): the 16 x 16 block graph (1,496 tasks) at blocks of 256,
# cut from 512 in PR 30 to keep the run inside its limit (the in-block
# LU's column loop sets the time: 72.2 s at 512 on a slow host)
LU_SIZE = (4096, 256)
NBODY = (16384, 1024, 4)                              # (N, block, steps)
APP_TOL = 1e-4      # f32 runs vs float64: of the largest magnitude

# Phase 35: the process backend on ProcessRuntime(PROC_WORKERS), each
# worker with its own CUDA context: phase 33's fine Matmul (host-bound),
# Sparse LU in (blocks a side, block), flat N-Body in (bodies, steps), the
# ping-pong stencil (cells, stages) under FaultPlan.seeded_kills(seed)
PROC_WORKERS = 4
PROC_MM = MM_FINE                                     # (n, block)
PROC_LU = (16, 256)
PROC_NBODY = (128, 2)
PROC_KILL = (64, 8, 0)                                # (cells, stages, seed)
PROC_TOL = APP_TOL  # f32 Matmul vs float64: of the largest |C|
PROC_BUDGET_S = 60.0

# Phase 36: the port's examples (examples/torch_<name>.py), each through
# its main() on the card at its own default sizes but EXAMPLE_CUTS (the
# training tour's steps, 200 + 20 by default, ~155 ms each on a slow
# host; the simulator's cores, 64 by default: ~10 s on the host, its
# ddast manager's polling);
# EXAMPLE_TASKS: the tasks each task-graph example runs at those sizes
EXAMPLES = ("quickstart", "multi_tenant", "serve_lm", "train_lm",
            "sparselu_taskgraph", "multi_process")
EXAMPLE_CUTS = {"train_lm": {"steps": 40, "more": 10},
                "sparselu_taskgraph": {"sim_cores": 16}}
EXAMPLE_TASKS = {"quickstart": 4 ** 3,                # (128 / 32)^3
                 "multi_tenant": 3 * 4 * 4 ** 3,      # tenants x epochs
                 "multi_process": 2 * 2 * 12}         # steps x rows x 2
EXAMPLE_SERVE = (24, 12)                  # requests, new tokens each
EXAMPLES_BUDGET_S = 60.0

# Phase 34: the card's own rates (a bf16 product of PEAK_MM^3 and a copy
# of PEAK_COPY bytes) may pass their data-sheet figures by at most 5%
PEAK_MM, PEAK_COPY, PEAK_SLACK = 8192, 2 ** 30, 1.05


def time_ms(fn, reps: int = 20, warmup: int = 3,
            backlog: bool = False) -> float:
    """Median device time of `fn` in ms, by CUDA events around each call.
    `backlog`: first queue a device sleep longer than the calls' host work,
    so that the card runs them back to back and the events time the device
    even where a call's host work outlasts its kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if backlog:
        torch.cuda._sleep(BACKLOG_CYCLES)
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def time_turns(fns: dict, reps: int = 20, warmup: int = 2) -> dict:
    """Median device ms of each of `fns` (name -> call), by CUDA events
    around each call, the calls interleaved in turns (the names in order,
    then in reverse, and so on), so that a drift of the card's clock
    under load reaches each alike."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    names = list(fns)
    for i in range(reps):
        for name in (names if i % 2 == 0 else names[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[name]()
            b.record()
            events[name].append((a, b))
    torch.cuda.synchronize()
    return {name: statistics.median(a.elapsed_time(b) for a, b in ev)
            for name, ev in events.items()}


def bound(shapes, itemsize: int, flops_peak: float, bytes_peak: float):
    """Least ms for grouped matmuls of `shapes` (E,C,d,f): each input read
    once and the output written once at the memory rate, or the products
    at the peak rate, whichever is longer."""
    nbytes = sum((e * c * d + e * d * f + e * c * f) * itemsize
                 for e, c, d, f in shapes)
    flops = sum(2 * e * c * d * f for e, c, d, f in shapes)
    t_bytes, t_ops = nbytes / bytes_peak, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def live_pairs(case: AttnCase) -> int:
    """The (query, key) pairs the call's masks leave: all S x T without a
    causal mask; with one (S == T) query i sees min(i + 1, window) keys."""
    if not case.causal:
        return case.b * case.nq * case.s * (case.t or case.s)
    w = min(case.window or case.s, case.s)
    per_head = w * (w + 1) // 2 + (case.s - w) * w
    return case.b * case.nq * per_head


def attn_bound(case: AttnCase, products, nbytes, flops_peak, bytes_peak):
    """Least ms for attention of `case`: `products` matrix products over
    its live (query, key) pairs (the masked-out tiles count nothing),
    2*hd flops each, at the peak rate, or `nbytes` at the memory rate."""
    t_ops = products * 2 * live_pairs(case) * case.hd / flops_peak
    t_bytes = nbytes / bytes_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def scan_bound(nbytes, exps, flops, mem_bps, sfu_rate, f32_fps) -> dict:
    """Least ms for a scan: `nbytes` at the memory rate, or its operations:
    `flops` f32 flops at the CUDA-core rate and `exps` exponentials, a
    share p of them on the FMA pipes at EXP2_FMA_FLOPS each and the rest
    on the SFU, p chosen so that the two pipes finish together; whichever
    is longer. Also the bytes' time alone and the operations' time with
    every exponential on the SFU (an upper estimate of the floor)."""
    t_bytes = nbytes / mem_bps
    t_sfu_only = max(exps / sfu_rate, flops / f32_fps)
    if exps:
        p = (exps * f32_fps - flops * sfu_rate) / (
            exps * f32_fps + exps * EXP2_FMA_FLOPS * sfu_rate)
        p = min(1.0, max(0.0, p))
        t_ops = max((1 - p) * exps / sfu_rate,
                    (flops + p * exps * EXP2_FMA_FLOPS) / f32_fps)
    else:
        t_ops = flops / f32_fps
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes * 1e3,
            "sfu_only_bound_ms": max(t_bytes, t_sfu_only) * 1e3}


F32_PRODUCTS = {("0", "1"): "forward", ("0", "0"): "dx", ("1", "1"): "dw"}


def ptxas_report(lib: Path, only="") -> dict:
    """ptxas's registers, spills and static smem for each kernel entry
    (those whose name starts with `only`, a string or a tuple of them),
    printed; returns the printed lines by kernel name."""
    name, lines = "?", {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)I(13__nv_bfloat16|f)"
                          r"((?:Li\d+E)*)(?:Lb(\d)E)?E", m.group(1))
            t = re.search(r"([a-z_]+_kernel)ILi(\d+)E(?:Lb(\d)E)?E",
                          m.group(1))
            b = re.search(r"(moe_gemm_f32_kernel)ILi(\d+)ELb(\d)ELb(\d)EE",
                          m.group(1))
            fl = re.search(r"(flash_\w+?_f32_kernel)ILi(\d+)E(?:Lb(\d)E)?E",
                           m.group(1))
            if fl:                   # the f32 flash kernels: hd, dk/dv's grid
                grid = {None: "", "0": ", a block a q head",
                        "1": ", a block a kv head"}[fl.group(3)]
                name = f"{fl.group(1)}<hd {fl.group(2)}{grid}>"
            elif b:                  # the f32 GEMM: rows a tile, product
                name = (f"{b.group(1)}<{b.group(2)} rows, "
                        f"{F32_PRODUCTS[b.group(3), b.group(4)]}>")
            elif k:
                labels = (("R", "P") if k.group(1) == "sel_scan_kernel"
                          else ("hd",))
                params = "".join(
                    f", {lb} {v}" for lb, v in
                    zip(labels, re.findall(r"Li(\d+)E", k.group(3))))
                if k.group(4) is not None:      # the forward's kStates
                    params += f", states {k.group(4)}"
                name = (f"{k.group(1)}<"
                        f"{'bf16' if k.group(2) != 'f' else 'f32'}{params}>")
            elif t and t.group(1) in ("mlstm_scan_out_kernel",
                                      "slstm_scan_kernel",
                                      "mlstm_bwd_chunk_kernel",
                                      "slstm_scan_bwd_kernel"):
                trails = ("" if t.group(3) is None else
                          ", trails" if t.group(3) == "1" else ", no trails")
                name = (f"{t.group(1)}<f32, hd {16 * int(t.group(2))}"
                        f"{trails}>")
            elif t:                  # the bf16 tensor-core kernels
                name = (f"{t.group(1)}<bf16, "
                        f"{'warpgroups' if 'moe' in t.group(1) else 'hd'} "
                        f"{t.group(2)}>")
            else:
                plain = re.search(r"\d([a-z_]+_kernel)E", m.group(1))
                name = plain.group(1) if plain else m.group(1)
        elif ("registers" in line or "spill" in line or "smem" in line
              or "warning" in line) and name.startswith(only):
            print(f"[build]   {name}: {line.strip()}")
            lines.setdefault(name, []).append(line)
    return lines


# the f32 CUDA-core kernels that must not spill: in each library, the name
# pattern of its f32 kernels and how many instantiations it has (the f32
# GEMM: the forward in both tiles, dx, dw; the flash kernels: forward, dq,
# dk/dv and the group sum at hd 16, 64 and 128)
F32_KERNELS = {"moe_gemm": (r"moe_gemm_f32_kernel", 4),
               "flash_attention": (r"flash_\w+_f32_kernel", 12)}


def f32_spills(report: dict, lib: str) -> None:
    """Fails unless ptxas reports each f32 CUDA-core instantiation of `lib`
    (F32_KERNELS) with no spill (`report`: ptxas_report's lines of that
    library)."""
    pattern, count = F32_KERNELS[lib]
    f32 = {k: v for k, v in report.items() if re.match(pattern, k)}
    assert len(f32) == count, sorted(f32)
    for kname, lines in f32.items():
        assert any("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in lines), (kname, lines)
    print(f"[build]   {len(f32)} f32 instantiations of {lib} "
          f"({', '.join(sorted(f32))}): no spills")


def f32_batch_invariance(shape, gen) -> None:
    """Each row of the f32 forward's and dx's outputs, bit for bit, the
    same whatever the other rows of its expert: `moe_gemm(x)[:, :c1]`
    against `moe_gemm(x[:, :c1])` and dx's rows of dy likewise, at the
    dims of `shape` (E, C, d, f) with C = 640 (128-row tiles) and c1 on
    both sides of the forward's route threshold."""
    e, _, d, f = shape
    c, t = 640, mg.F32_NARROW_MAX_C
    x = torch.randn((e, c, d), generator=gen, device="cuda") * d ** -0.25
    w = torch.randn((e, d, f), generator=gen, device="cuda") * d ** -0.25
    dy = torch.randn((e, c, f), generator=gen, device="cuda")
    full, dfull = moe_gemm(x, w), moe_gemm_bwd_dx(dy, w)
    cuts = (1, 16, t - 1, t, t + 1, 200, c - 1)
    for c1 in cuts:
        part = moe_gemm(x[:, :c1].contiguous(), w)
        dpart = moe_gemm_bwd_dx(dy[:, :c1].contiguous(), w)
        torch.cuda.synchronize()
        assert torch.equal(part, full[:, :c1]), ("forward", c1)
        assert torch.equal(dpart, dfull[:, :c1]), ("dx", c1)
    print(f"[check] moe_gemm f32 batch invariance at (E, C, d, f) = "
          f"{(e, c, d, f)}: the forward's and dx's first c1 rows, for c1 in "
          f"{cuts} (routes: " + ", ".join(
              f"{c1} {mg.forward_entry(torch.float32, c1)}" for c1 in cuts)
          + f"; C = {c} {mg.forward_entry(torch.float32, c)}), bit-identical "
          f"to those rows of the whole call")


def f32_route_sweep(shape, gen) -> dict:
    """The f32 forward at the dims of `shape` (E, C, d, f) with C = each of
    F32_SWEEP_C rows an expert, through each route's C entry point (16-
    and 128-row tiles) and `torch.bmm`, in turns: the C up to which the
    16-row tiles were faster, beside the wrapper's F32_NARROW_MAX_C."""
    e, _, d, f = shape
    lib = mg._lib()
    routes = {"16-row tiles": lib_fn(lib, "moe_gemm_f32_narrow"),
              "128-row tiles": lib_fn(lib, "moe_gemm_f32"),
              "torch.bmm": torch.bmm}
    rows = {}
    for c in F32_SWEEP_C:
        x = torch.randn((e, c, d), generator=gen, device="cuda") * d ** -0.25
        w = torch.randn((e, d, f), generator=gen, device="cuda") * d ** -0.25
        rows[c] = time_turns({name: (lambda fn=fn: fn(x, w))
                              for name, fn in routes.items()}, 10, 2)
        print(f"[time] moe_gemm f32 forward C sweep {(e, c, d, f)}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in rows[c].items())
              + " ms")
        del x, w
    narrow = [c for c in F32_SWEEP_C
              if rows[c]["16-row tiles"] < rows[c]["128-row tiles"]]
    print(f"[time] moe_gemm f32 forward: 16-row tiles faster at C = "
          f"{narrow} of {list(F32_SWEEP_C)}; the wrapper takes them up to C "
          f"= {mg.F32_NARROW_MAX_C}")
    return {"c": list(F32_SWEEP_C), "ms": [rows[c] for c in F32_SWEEP_C],
            "narrow_faster_at": narrow,
            "narrow_max_c": mg.F32_NARROW_MAX_C}


def check_moe_bwd(label, x, w, scale, tol, gen) -> tuple[float, float]:
    """The backward kernels on the forward's x [E,C,d] and w [E,d,f] and a
    random dy [E,C,f] at `scale`, the last expert's x and dy rows all zero
    (an expert no token reaches): dx and dw against `moe_gemm_bwd_ref` at
    `tol`, two calls bit for bit, that expert's dx and dw exact zeros. With
    one expert, that expert keeps its tokens, and a third pair of calls on
    all-zero x and dy must give exact zeros. Returns max |kernel - plain|
    of dx and of dw."""
    e, c, _ = x.shape
    dy = (torch.randn((e, c, w.shape[2]), generator=gen, device="cuda")
          * scale).to(x.dtype)
    x = x.clone()
    if e > 1:
        x[-1] = 0
        dy[-1] = 0
    dx, dw = moe_gemm_bwd_dx(dy, w), moe_gemm_bwd_dw(x, dy)
    dx2, dw2 = moe_gemm_bwd_dx(dy, w), moe_gemm_bwd_dw(x, dy)
    rdx, rdw = moe_gemm_bwd_ref(x, w, dy)
    if e == 1:
        zdx = moe_gemm_bwd_dx(torch.zeros_like(dy), w)
        zdw = moe_gemm_bwd_dw(torch.zeros_like(x), torch.zeros_like(dy))
    else:
        zdx, zdw = dx[-1], dw[-1]
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2), \
        f"moe_gemm backward differs between two calls ({label}, {x.dtype})"
    assert not (zdx.any() or zdw.any()), \
        f"an expert with no token got a nonzero gradient ({label})"
    for g, r in ((dx, rdx), (dw, rdw)):
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol)
    e_dx = (dx.float() - rdx.float()).abs().max().item()
    e_dw = (dw.float() - rdw.float()).abs().max().item()
    print(f"[check] moe_gemm backward {label} {tuple(x.shape)} x "
          f"{tuple(w.shape)} {x.dtype}: max |kernel - plain| dx {e_dx:.3e}, "
          f"dw {e_dw:.3e} (tol {tol}); two calls bit-identical; the expert "
          f"with no token has exact-zero dx and dw")
    return e_dx, e_dw


def check_moe_autograd(gen) -> None:
    """`moe_gemm`'s gradients through its autograd Function (the dx and dw
    kernels) against autograd through `moe_gemm_ref`, in bf16 and f32, at
    phase 3's tolerances, with one launch of each kernel a call; then a
    weight alone that requires grad launches dw and not dx."""
    tols = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    for dtype in (torch.bfloat16, torch.float32):
        for e, c, d, f in ((4, 100, 96, 72), (3, 100, 93, 71)):
            x, w, dy = ((torch.randn(shp, generator=gen, device="cuda") * 0.3)
                        .to(dtype) for shp in ((e, c, d), (e, d, f),
                                               (e, c, f)))
            xk, wk, xr, wr = (t.clone().requires_grad_()
                              for t in (x, w, x, w))
            moe_gemm_bwd_dx.launches = moe_gemm_bwd_dw.launches = 0
            got = torch.autograd.grad(moe_gemm(xk, wk), (xk, wk), dy)
            launches = (moe_gemm_bwd_dx.launches, moe_gemm_bwd_dw.launches)
            want = torch.autograd.grad(moe_gemm_ref(xr, wr), (xr, wr), dy)
            torch.cuda.synchronize()
            assert launches == (1, 1), launches
            errs = []
            for g, r in zip(got, want):
                torch.testing.assert_close(g.float(), r.float(),
                                           rtol=tols[dtype], atol=tols[dtype])
                errs.append((g.float() - r.float()).abs().max().item())
            print(f"[check] moe_gemm autograd {(e, c, d, f)} {dtype}: dx, dw "
                  f"through the kernels vs autograd through moe_gemm_ref "
                  f"max |diff| {errs[0]:.3e}, {errs[1]:.3e} (tol "
                  f"{tols[dtype]}); launches dx, dw {launches}")
        moe_gemm_bwd_dx.launches = moe_gemm_bwd_dw.launches = 0
        torch.autograd.grad(moe_gemm(x, wk), wk, dy)
        torch.cuda.synchronize()
        launches = (moe_gemm_bwd_dx.launches, moe_gemm_bwd_dw.launches)
        assert launches == (0, 1), launches
        print(f"[check] moe_gemm autograd {dtype}, only w requires grad: "
              f"launches dx, dw {launches}")


def forward_digest(fwd) -> str:
    """SHA-256 of the bf16 forward's output at FWD_DIGEST_SHAPE on inputs
    from a generator seeded 7, through `fwd(x, w)`: the bits of the
    forward kernel, to compare two trees' kernels."""
    e, c, d, f = FWD_DIGEST_SHAPE
    gen = torch.Generator("cuda").manual_seed(7)
    x = (torch.randn((e, c, d), generator=gen, device="cuda")
         * d ** -0.25).to(torch.bfloat16)
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         * d ** -0.25).to(torch.bfloat16)
    out = fwd(x, w)
    return hashlib.sha256(out.view(torch.int16).cpu().numpy()
                          .tobytes()).hexdigest()


def dw_sweep(dws: dict, flops_peak: float, sms: int) -> dict:
    """dw at DW_SWEEP_EDF with C = each of DW_SWEEP_C, through each of
    `dws` (name -> fn(x, dy)), the names in turns at each C (time_turns);
    then, for each name, the least-squares
    line of ms against the number of 64-deep k-steps: the slope is the
    main loop's time a k-step over the whole output, the intercept the
    fixed cost of the tiles. Both also per wave of `sms` tiles of 16,384
    outputs (128 x 128 or 64 x 256), beside a k-step's products at the
    peak rate."""
    e, d, f = DW_SWEEP_EDF
    gen = torch.Generator("cuda").manual_seed(3)
    ms = {name: [] for name in dws}
    for c in DW_SWEEP_C:
        x = (torch.randn((e, c, d), generator=gen, device="cuda")
             * d ** -0.25).to(torch.bfloat16)
        dy = torch.randn((e, c, f), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        t = time_turns({name: (lambda fn=fn: fn(x, dy))
                        for name, fn in dws.items()})
        for name in dws:
            ms[name].append(t[name])
        del x, dy
    torch.cuda.empty_cache()
    ks = [c / 64 for c in DW_SWEEP_C]
    waves = e * d * f / (16384 * sms)
    peak_us = 2 * 16384 * 64 / (flops_peak / sms) * 1e6
    fits = {}
    for name, t in ms.items():
        k_mean, t_mean = statistics.mean(ks), statistics.mean(t)
        slope = (sum((k - k_mean) * (y - t_mean) for k, y in zip(ks, t))
                 / sum((k - k_mean) ** 2 for k in ks))
        intercept = t_mean - slope * k_mean
        fits[name] = {"c": list(DW_SWEEP_C), "ms": t,
                      "ms_per_k_step": slope, "intercept_ms": intercept,
                      "us_per_k_step_a_wave": 1e3 * slope / waves,
                      "fixed_us_a_wave": 1e3 * intercept / waves}
        print(f"[time] moe_gemm dw K sweep {name}, (E, d, f) = "
              f"{DW_SWEEP_EDF}, C = {list(DW_SWEEP_C)}: "
              + ", ".join(f"{y:.4f}" for y in t) + f" ms; fit "
              f"{intercept:.4f} ms + {slope:.5f} ms a 64-deep k-step; "
              f"per wave of {sms} tiles of 16,384 outputs ({waves:.1f} "
              f"waves): {1e3 * intercept / waves:.3f} us fixed + "
              f"{1e3 * slope / waves:.4f} us a k-step (its products at "
              f"peak {peak_us:.4f} us)")
    return fits


def card_state() -> str:
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def kernel_sass(lib: Path, pattern: str = r"moe_gemm_wgmma_kernelI(\w+?)E"
                ) -> dict:
    """cuobjdump's SASS of each kernel in a built library whose mangled
    name `pattern` matches, keyed by the pattern's group (the template
    arguments: the anonymous namespace differs between sources); by
    default the bf16 moe_gemm forward's instantiations. Each line's runs
    of blanks are collapsed: cuobjdump pads its columns to the longest
    name in the file. Empty where the toolkit has no cuobjdump."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            t = re.search(pattern, m.group(1))
            cur = t.group(1) if t else None
            if cur:
                funcs[cur] = []
        elif cur and line.strip():
            funcs[cur].append(" ".join(line.split()))
    return funcs


F32_SASS = (r"(moe_gemm_kernelIfE|moe_gemm_bwd_kernelILb\dELb\dEE"
            r"|moe_gemm_f32_kernelILi\d+ELb\dELb\dEE)")


def loop_mix(lines: list) -> dict:
    """The instruction mix of the longest loop in a kernel's SASS (lines
    from `kernel_sass`: the span from a backward branch's target to the
    branch): its instructions, FFMAs, shared-memory and global loads and
    stores, and the FFMAs' share."""
    code = []
    for line in lines:
        m = re.match(r"/\*([0-9a-f]{4,})\*/ (?:@!?U?P\w+ )?([A-Z][A-Z0-9_.]*)"
                     r"(.*?);", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    span = (0, 0)
    for off, op, args in code:
        t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if t and int(t.group(1), 16) < off and \
                off - int(t.group(1), 16) > span[1] - span[0]:
            span = (int(t.group(1), 16), off)
    ops = [op for off, op, _ in code if span[0] <= off <= span[1]]
    count = {k: sum(o.startswith(k) for o in ops)
             for k in ("FFMA", "LDS", "STS", "LDG", "BAR")}
    return {"instructions": len(ops), **count,
            "ffma_share": count["FFMA"] / max(len(ops), 1)}


def lib_fn(lib, entry: str):
    """fn(a, b) -> out through the C entry point `entry` of a loaded
    moe_gemm library (a forward's, dx's or dw's, in either dtype), on
    operands that need no padding, with no wrapper around it: the
    forward's (x, w), dx's (dy, w) or dw's (x, dy)."""
    fn_c = getattr(lib, entry)

    def fn(a, b):
        if entry.startswith("moe_gemm_bwd_dx"):
            (e, c, f), d = a.shape, b.shape[1]
            shape = (e, c, d)
        elif entry.startswith("moe_gemm_bwd_dw"):
            (e, c, d), f = a.shape, b.shape[2]
            shape = (e, d, f)
        else:
            (e, c, d), f = a.shape, b.shape[2]
            shape = (e, c, f)
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
        err = fn_c(a.data_ptr(), b.data_ptr(), out.data_ptr(), e, c, d, f,
                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry} launch failed: "
                               f"{lib.moe_gemm_error_string(err).decode()}")
        return out
    return fn


def bwd_bound(shapes, itemsize: int, flops_peak: float, bytes_peak: float):
    """Least ms for the backward (dx and dw) of grouped matmuls of `shapes`
    (E,C,d,f): x, w and dy read once, dx and dw written once, or the two
    products at the peak rate, whichever is longer."""
    nbytes = sum((2 * e * c * d + 2 * e * d * f + e * c * f) * itemsize
                 for e, c, d, f in shapes)
    flops = sum(4 * e * c * d * f for e, c, d, f in shapes)
    t_bytes, t_ops = nbytes / bytes_peak, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def time_moe_train_layer(shapes, dtype, gen, flops_peak, mem_bps) -> dict:
    """One MoE layer's three calls (gate, up, down) at the train shapes
    `shapes` (E,C,d,f each): the forward, dx and dw, each through its
    wrapper (by CUDA events in turns with `torch.bmm` on the same
    operands, and behind a queued device sleep: the device's time alone)
    and its plain version, beside its bound; then the backward as dx +
    dw."""
    calls = []
    for e, c, d, f in shapes:
        scale = d ** -0.25
        calls.append(tuple(
            (torch.randn(shp, generator=gen, device="cuda") * scale)
            .to(dtype) for shp in ((e, c, d), (e, d, f), (e, c, f))))
    size = calls[0][0].element_size()
    reps = (20, 3) if dtype == torch.bfloat16 else (5, 1)
    fns = {"forward": (lambda x, w, dy: moe_gemm(x, w),
                       lambda x, w, dy: moe_gemm_ref(x, w),
                       lambda x, w, dy: torch.bmm(x, w)),
           "dx": (lambda x, w, dy: moe_gemm_bwd_dx(dy, w),
                  lambda x, w, dy: moe_gemm_dx_ref(dy, w),
                  lambda x, w, dy: torch.bmm(dy, w.transpose(1, 2))),
           "dw": (lambda x, w, dy: moe_gemm_bwd_dw(x, dy),
                  lambda x, w, dy: moe_gemm_dw_ref(x, dy),
                  lambda x, w, dy: torch.bmm(x.transpose(1, 2), dy))}
    out = {}
    for kname, (kern, plain, lib) in fns.items():
        # the kernel and torch.bmm in turns (the card's clock drifts under
        # load); the plain version alone
        t = time_turns({key: (lambda fn=fn: [fn(*a) for a in calls])
                        for key, fn in (("ms", kern), ("library_ms", lib))},
                       *reps)
        t["plain_ms"] = time_ms(lambda: [plain(*a) for a in calls], 3, 1)
        t["device_ms"] = time_ms(lambda: [kern(*a) for a in calls], *reps,
                                 backlog=True)
        # dx and dw move the forward's three tensors' sizes and do its
        # products: the same bound
        t["bound_ms"], t["bound_by"] = bound(shapes, size, flops_peak,
                                             mem_bps)
        out[kname] = t
    bwd = {k_: out["dx"][k_] + out["dw"][k_]
           for k_ in ("ms", "device_ms", "plain_ms", "library_ms")}
    bwd["bound_ms"], bwd["bound_by"] = bwd_bound(shapes, size, flops_peak,
                                                 mem_bps)
    out["backward"] = bwd
    route = ("bf16 (wgmma)" if dtype == torch.bfloat16
             else "f32 (CUDA cores)")
    for kname, t in out.items():
        print(f"[time] moe_gemm {kname} train layer {shapes} {route}: kernel "
              f"{t['ms']:.4f} ms (behind a device sleep "
              f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
              f"torch.bmm {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}); kernel at "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound")
    del calls
    torch.cuda.empty_cache()
    return out


def train_shapes() -> dict:
    """(E, C, d, f) of the grouped GEMMs of the MoE and Jamba train cells:
    the gate/up and down calls of one layer each."""
    cfg, jcfg = get_config(ARCH), get_config(JAMBA)
    e, d, f = padded_experts(cfg), cfg.d_model, cfg.moe_d_ff
    je, jd, jf = padded_experts(jcfg), jcfg.d_model, jcfg.moe_d_ff
    # MoE training (slice 7): B=4 x S=2048, 160 slots an expert a row
    c = TRAIN_BATCH * capacity(cfg, TRAIN_SEQ)
    # Jamba training (slice 8): B=2 x S=4096, 640 slots an expert a row
    jc = JAMBA_TRAIN_BATCH * capacity(jcfg, JAMBA_TRAIN_SEQ)
    assert jc == 1280, jc
    return {"train gate/up": (e, c, d, f), "train down": (e, c, f, d),
            "jamba train gate/up": (je, jc, jd, jf),
            "jamba train down": (je, jc, jf, jd)}


def compare_trees(parent: Path) -> int:
    """`python3 chip_smoke.py --ab PARENT`: the bf16 moe_gemm kernels of
    this tree and of another checkout at PARENT (the parent commit from
    `git archive`) built side by side and called through their C entry
    points on the same operands: the forward's SASS and output digest of
    each (the digests must be equal); dx and dw of each at several shapes,
    against the parent's; times in turns (parent, change, change, parent)
    of the forward, dx and dw of one layer at the MoE and Jamba train
    shapes, beside `torch.bmm` on the same operands and their bound, and
    of the dw K sweep; the f32 kernels likewise (`compare_f32`); then the
    scans (`compare_scans`, `compare_xlstm`), the xLSTM backwards
    (`compare_xlstm_bwd`) and the f32 flash kernels
    (`compare_flash_f32`)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    pk = peaks_for(name)[1]
    mem_bps, bf16_fps = pk.hbm_bps, pk.bf16_fps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    jobs = {"parent": parent / "src/repro_torch/kernels/csrc/moe_gemm.cu",
            "change": None}
    # the selective scan through each tree's own wrapper: the parent's
    # package, imported beside this one, builds its own ssm_scan.cu
    parent_scan = tree_module(parent, "kernels.ssm_scan", "parent_repro_torch")
    with ThreadPoolExecutor(max_workers=len(jobs) + 2) as pool:
        scan_builds = [pool.submit(mod._lib) for mod in (parent_scan, sscan)]
        built = dict(zip(jobs, pool.map(
            lambda src: _build.build("moe_gemm", src=src), jobs.values())))
        for job in scan_builds:
            job.result()
    fns, f32_fns = {}, {}
    for tag, lib in built.items():
        print(f"[build] moe_gemm ({tag}) -> {lib.name}")
        ptxas_report(lib, only="moe_gemm_")
        # the entry points this tree's library has (the parent's has no
        # 16-row route of the f32 forward)
        raw = ctypes.CDLL(str(lib))
        loaded = mg_load(lib, entries=[e_ for e_ in mg.ENTRIES
                                       if hasattr(raw, e_)])
        fns[tag] = {k: lib_fn(loaded, f"{k}_bf16") for k in
                    ("moe_gemm", "moe_gemm_bwd_dx", "moe_gemm_bwd_dw")}
        f32_fns[tag] = {k: lib_fn(loaded, f"{k}_f32") for k in
                        ("moe_gemm", "moe_gemm_bwd_dx", "moe_gemm_bwd_dw")}
        # the f32 forward at decode's C: the route this tree's wrapper
        # takes there, where the library has it
        entry = mg.forward_entry(torch.float32,
                                 SLOTS * capacity(get_config(ARCH), 1))
        f32_fns[tag]["decode"] = lib_fn(
            loaded, entry if hasattr(raw, entry) else "moe_gemm_f32")
    shapes = train_shapes()
    sass = {tag: kernel_sass(lib) for tag, lib in built.items()}
    print(f"[ab] bf16 forward kernel's SASS (cuobjdump), "
          f"{len(sass['change'])} instantiations: "
          + ("not compared (no cuobjdump)" if not sass["change"] else
             f"identical in both libraries {sass['parent'] == sass['change']}"
             f" ({sum(map(len, sass['change'].values()))} lines)"))
    digests = {tag: forward_digest(f["moe_gemm"]) for tag, f in fns.items()}
    print(f"[ab] bf16 forward output digest at {FWD_DIGEST_SHAPE}: "
          + ", ".join(f"{t} {d_}" for t, d_ in digests.items()))
    assert digests["parent"] == digests["change"], digests

    gen = torch.Generator("cuda").manual_seed(5)
    for shape in (shapes["train gate/up"], shapes["jamba train down"],
                  (3, 100, 96, 72), (1, 256, 512, 512),
                  (2 * sms + 1, 64, 64, 200), (1, 4096, 4096, 1024)):
        e, c, d, f = shape
        x, w, dy = ((torch.randn(shp, generator=gen, device="cuda")
                     * d ** -0.25).to(torch.bfloat16)
                    for shp in ((e, c, d), (e, d, f), (e, c, f)))
        for kname, args in (("moe_gemm_bwd_dx", (dy, w)),
                            ("moe_gemm_bwd_dw", (x, dy))):
            got = {tag: fns[tag][kname](*args).float() for tag in fns}
            print(f"[ab] {kname} at {shape}: change vs parent max |diff| "
                  f"{(got['change'] - got['parent']).abs().max():.3e}, "
                  f"bit-identical "
                  f"{torch.equal(got['change'], got['parent'])}")
        del x, w, dy, got
    torch.cuda.empty_cache()

    for label, keys in (("MoE train layer", ("train gate/up",) * 2
                         + ("train down",)),
                        ("Jamba train layer", ("jamba train gate/up",) * 2
                         + ("jamba train down",))):
        layer = [shapes[k] for k in keys]
        calls = [tuple((torch.randn(shp, generator=gen, device="cuda")
                        * d_ ** -0.25).to(torch.bfloat16)
                       for shp in ((e_, c_, d_), (e_, d_, f_), (e_, c_, f_)))
                 for e_, c_, d_, f_ in layer]
        bound_ms, bound_by = bound(layer, 2, bf16_fps, mem_bps)
        for kname, pick, lib in (
                ("moe_gemm", lambda x_, w_, dy_: (x_, w_), torch.bmm),
                ("moe_gemm_bwd_dx", lambda x_, w_, dy_: (dy_, w_),
                 lambda a, b: torch.bmm(a, b.transpose(1, 2))),
                ("moe_gemm_bwd_dw", lambda x_, w_, dy_: (x_, dy_),
                 lambda a, b: torch.bmm(a.transpose(1, 2), b))):
            fns_ = {tag: fns[tag][kname] for tag in ("parent", "change")}
            fns_["torch.bmm"] = lib
            runs = [time_turns({
                tag: (lambda fn=fn: [fn(*pick(*a)) for a in calls])
                for tag, fn in fns_.items()}) for _ in range(2)]
            print(f"[ab] {kname} {label} {layer}, ms (two runs of 20 "
                  f"calls each in turns): " + "; ".join(
                      ", ".join(f"{tag} {ms:.4f}" for tag, ms in t.items())
                      + f" (change / parent {t['change'] / t['parent']:.4f})"
                      for t in runs)
                  + f"; bound {bound_ms:.4f} ms ({bound_by}); change at "
                  f"{100 * bound_ms / runs[-1]['change']:.1f}% of the bound;"
                  f" card just after: {card_state()}")
        del calls
        torch.cuda.empty_cache()
    dw_sweep({tag: fns[tag]["moe_gemm_bwd_dw"] for tag in fns}, bf16_fps,
             sms)
    compare_f32(built, f32_fns, shapes, gen, pk.f32_fps, mem_bps)
    compare_scans(parent_scan)
    parent_xls = tree_module(parent, "kernels.xlstm_scan",
                             "parent_repro_torch")
    compare_xlstm(parent_xls)
    compare_xlstm_bwd(parent_xls)
    compare_flash_f32(parent, pk.f32_fps, mem_bps)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def compare_f32(libs: dict, f32_fns: dict, shapes: dict, gen,
                f32_fps: float, mem_bps: float) -> None:
    """`--ab`'s f32 kernels: the instruction mix of each f32 kernel's main
    loop in each tree's library (`libs`: tree -> path; `loop_mix`); each
    tree's forward, dx and dw (`f32_fns`: tree -> product -> fn, through
    the C entry points) against the
    other's on one MoE train layer's operands (max |diff|, bit for bit),
    then their times in turns (parent, change, change, parent) beside
    `torch.bmm` on the same operands and the bound, at the MoE train
    layer (gate, up, down at E=64, C=640) and, for the forward, at the
    qwen2-moe serving layer (C=16)."""
    for tag, lib in libs.items():
        for kname, lines in sorted(kernel_sass(lib, F32_SASS).items()):
            mix = loop_mix(lines)
            print(f"[ab] f32 SASS ({tag}) {kname}: main loop "
                  + ", ".join(f"{k} {v}" for k, v in mix.items()
                              if k != "ffma_share")
                  + f"; FFMA share {mix['ffma_share']:.3f}")
    cfg = get_config(ARCH)
    e, c, d, f = padded_experts(cfg), SLOTS * capacity(cfg, 1), \
        cfg.d_model, cfg.moe_d_ff
    for label, layer, products in (
            ("MoE train layer", [shapes["train gate/up"]] * 2
             + [shapes["train down"]], ("moe_gemm", "moe_gemm_bwd_dx",
                                        "moe_gemm_bwd_dw")),
            ("serving layer", [(e, c, d, f)] * 2 + [(e, c, f, d)],
             ("decode",))):
        calls = [tuple((torch.randn(shp, generator=gen, device="cuda")
                        * d_ ** -0.25)
                       for shp in ((e_, c_, d_), (e_, d_, f_), (e_, c_, f_)))
                 for e_, c_, d_, f_ in layer]
        bound_ms, bound_by = bound(layer, 4, f32_fps, mem_bps)
        for kname in products:
            pick, lib = {
                "moe_gemm": (lambda x_, w_, dy_: (x_, w_), torch.bmm),
                "decode": (lambda x_, w_, dy_: (x_, w_), torch.bmm),
                "moe_gemm_bwd_dx": (lambda x_, w_, dy_: (dy_, w_),
                                    lambda a, b: torch.bmm(
                                        a, b.transpose(1, 2))),
                "moe_gemm_bwd_dw": (lambda x_, w_, dy_: (x_, dy_),
                                    lambda a, b: torch.bmm(
                                        a.transpose(1, 2), b))}[kname]
            got = {tag: f32_fns[tag][kname](*pick(*calls[0]))
                   for tag in ("parent", "change")}
            fns_ = {tag: f32_fns[tag][kname] for tag in ("parent", "change")}
            fns_["torch.bmm"] = lib
            runs = [time_turns({
                tag: (lambda fn=fn: [fn(*pick(*a)) for a in calls])
                for tag, fn in fns_.items()}, 10, 2) for _ in range(2)]
            print(f"[ab] f32 {kname} {label} {layer}: change vs parent max "
                  f"|diff| {(got['change'] - got['parent']).abs().max():.3e}"
                  f", bit-identical "
                  f"{torch.equal(got['change'], got['parent'])}; ms (two "
                  f"runs of 10 calls each in turns): " + "; ".join(
                      ", ".join(f"{tag} {ms:.4f}" for tag, ms in t.items())
                      + f" (change / parent {t['change'] / t['parent']:.4f})"
                      for t in runs)
                  + f"; bound {bound_ms:.4f} ms ({bound_by}); change at "
                  f"{100 * bound_ms / runs[-1]['change']:.1f}% of the bound;"
                  f" card just after: {card_state()}")
            del got
        del calls
        torch.cuda.empty_cache()


def tree_module(root: Path, dotted: str, alias: str):
    """`repro_torch.<dotted>` of the checkout at `root`, imported as the
    package `alias` beside this tree's own (its wrappers build their
    kernels from its own sources into its own `_build/`)."""
    pkg = root / "src" / "repro_torch"
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[alias] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.{dotted}")


def compare_scans(parent_scan) -> None:
    """`--ab`'s selective-scan part: this tree's `ssm_scan` wrappers and
    the parent checkout's (`parent_scan`), each launching its own build.
    The inference forward `sel_scan_kernel<T, R, P, false>`: SASS
    (cuobjdump) and output digest, both equal. The backward, each from its
    own forward's states, against `selective_scan_bwd_ref` and against
    each other at the Jamba train shape and two SCAN_CASES edge shapes (h0
    and dh_last given). Then times in turns (parent, change, change,
    parent; two runs) at the train shape of the backward, the forward
    that keeps the states and the inference forward, with the card's
    state just after each."""
    pattern = r"sel_scan_kernelI(\w+?Lb0E)E"
    sass = {tag: kernel_sass(mod._build.build("ssm_scan"), pattern)
            for tag, mod in (("parent", parent_scan), ("change", sscan))}
    print(f"[ab] selective scan's inference forward SASS (cuobjdump), "
          f"{len(sass['change'])} instantiations: "
          + ("not compared (no cuobjdump)" if not sass["change"] else
             f"identical in both libraries {sass['parent'] == sass['change']}"
             f" ({sum(map(len, sass['change'].values()))} lines)"))
    digests = {"parent": scan_digest(parent_scan.selective_scan),
               "change": scan_digest(selective_scan)}
    print(f"[ab] selective scan output digest at {SCAN_CASES['path']}: "
          + ", ".join(f"{t} {d_}" for t, d_ in digests.items()))
    assert digests["parent"] == digests["change"], digests

    gen = torch.Generator("cuda").manual_seed(11)
    mods = {"parent": parent_scan, "change": sscan}
    for label in ("train", "ragged S=1000 D=200", "N=5"):
        args = sel_inputs(SCAN_CASES[label], torch.bfloat16, gen, True)
        dy = torch.randn(args[0].shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        dh = torch.randn(args[6].shape, generator=gen, device="cuda")
        got = {tag: mod.selective_scan_bwd(*args, dy, dh,
                                           mod._forward_states(*args)[2])
               for tag, mod in mods.items()}
        want = selective_scan_bwd_ref(*args, dy, dh)
        errs = {tag: {k: grad_err(g, w)[1]
                      for k, g, w in zip(SCAN_GRADS, got[tag], want)}
                for tag in got}
        diff = {k: (a.float() - b.float()).abs().max().item() for k, a, b in
                zip(SCAN_GRADS, got["change"], got["parent"])}
        print(f"[ab] selective_scan_bwd {label} {SCAN_CASES[label]} bf16, h0 "
              f"and dh_last: max |kernel - plain| / max(1, |plain|) "
              + "; ".join(f"{tag} " + ", ".join(f"{k} {e:.2e}" for k, e in
                                                 errs[tag].items())
                          for tag in errs)
              + "; change vs parent max |diff| "
              + ", ".join(f"{k} {e:.3e}" for k, e in diff.items()))
        for tag in errs:
            assert all(e <= SCAN_BWD_TOL[g.dtype] for e, g in
                       zip(errs[tag].values(), got[tag])), (label, tag, errs)
        del args, dy, dh, got, want
        torch.cuda.empty_cache()

    args = sel_inputs(SCAN_CASES["train"], torch.bfloat16, gen, False)
    dy = torch.randn(args[0].shape, generator=gen,
                     device="cuda").to(torch.bfloat16)
    h_seg = {tag: mod._forward_states(*args)[2] for tag, mod in mods.items()}
    for what, call in (
            ("backward (both kernels)",
             lambda m, tag: m.selective_scan_bwd(*args, dy, None,
                                                 h_seg[tag])),
            ("forward keeping the states",
             lambda m, tag: m._forward_states(*args)),
            ("inference forward", lambda m, tag: m.selective_scan(*args))):
        runs = [time_turns({tag: (lambda m=mod, tag=tag: call(m, tag))
                            for tag, mod in mods.items()}) for _ in range(2)]
        print(f"[ab] selective scan {what} {SCAN_CASES['train']} bf16, ms "
              f"(two runs of 20 calls each in turns): " + "; ".join(
                  ", ".join(f"{tag} {ms:.4f}" for tag, ms in t.items())
                  + f" (change / parent {t['change'] / t['parent']:.4f})"
                  for t in runs) + f"; card just after: {card_state()}")
    del args, dy, h_seg
    torch.cuda.empty_cache()


def compare_xlstm(parent_xls) -> None:
    """`--ab`'s xLSTM part: this tree's forward scans and the parent
    checkout's (`parent_xls`), each through its own tree's wrapper and
    build. At the train shape each against the plain version and the two
    against each other; then times in turns (parent, change, change,
    parent; two runs) at the train and path shapes, with the card's state
    just after each."""
    gen = torch.Generator("cuda").manual_seed(13)
    mods = {"parent": parent_xls, "change": xls}
    for kind, ref in (("mlstm_scan", mlstm_scan_ref),
                      ("slstm_scan", slstm_scan_ref)):
        for label, case in (("train", XLSTM_BWD_CASES["train"]),
                            ("path", XLSTM_CASES["path"])):
            args = xlstm_inputs(kind, case, gen)
            with torch.no_grad():
                if label == "train":
                    got = {tag: getattr(m, kind)(*args)
                           for tag, m in mods.items()}
                    want = ref(*args)
                    print(f"[ab] {kind} {label} {case} f32: max |kernel - "
                          f"plain| " + ", ".join(
                              f"{tag} {(g - want).abs().max().item():.3e}"
                              for tag, g in got.items())
                          + f"; change vs parent max |diff| "
                          f"{(got['change'] - got['parent']).abs().max():.3e}")
                    del got, want
                runs = [time_turns(
                    {tag: (lambda m=m: getattr(m, kind)(*args))
                     for tag, m in mods.items()},
                    reps=6 if label == "path" else 20) for _ in range(2)]
            print(f"[ab] {kind} {label} {case} f32, ms (two runs of "
                  f"{6 if label == 'path' else 20} calls each in turns): "
                  + "; ".join(", ".join(f"{tag} {ms:.4f}"
                                        for tag, ms in t.items())
                              + f" (change / parent "
                              f"{t['change'] / t['parent']:.4f})"
                              for t in runs)
                  + f"; card just after: {card_state()}")
            del args
            torch.cuda.empty_cache()


def mlstm_bwd_call(mod, args, y, dy):
    """One mLSTM backward through tree `mod`'s wrapper, on the chunk states
    its own keeping forward leaves."""
    _, states = mod._mlstm_fwd(*args, keep=True)
    return lambda: mod.mlstm_scan_bwd(*args, y, dy, states)


def compare_xlstm_bwd(parent_xls) -> None:
    """`--ab`'s xLSTM backward part: this tree's two backwards and the
    parent checkout's, each through its own tree's wrapper and build, at
    the train shape on one forward's y and trails: each against the plain
    version (`mlstm_scan_bwd_ref`; `slstm_scan_dpre_ref`, the sLSTM
    kernel's dpre) and the two against each other; then times in turns
    (parent, change, change, parent; two runs of 20 calls), with the
    card's state just after each."""
    gen = torch.Generator("cuda").manual_seed(17)
    mods = {"parent": parent_xls, "change": xls}
    case = XLSTM_BWD_CASES["train"]
    for kind in ("mlstm_scan_bwd", "slstm_scan_bwd"):
        args = xlstm_inputs(kind[:-4], case, gen)
        dy = torch.randn(case, generator=gen, device="cuda")
        with torch.no_grad():
            if kind == "mlstm_scan_bwd":
                y = xls.mlstm_scan(*args)
                calls = {tag: mlstm_bwd_call(m, args, y, dy)
                         for tag, m in mods.items()}
                want = mlstm_scan_bwd_ref(*args, y, dy)
            else:
                trails = xls._slstm_fwd(*args, trails=True)
                calls = {tag: (lambda m=m: (m._slstm_bwd(args[1], dy,
                                                         trails[1:]),))
                         for tag, m in mods.items()}
                want = (slstm_scan_dpre_ref(args[1], dy, trails[1:]),)
            got = {tag: fn() for tag, fn in calls.items()}
            print(f"[ab] {kind} train {case} f32: max |kernel - plain| / "
                  f"max |plain| " + ", ".join(
                      f"{tag} {grads_rel_err(g, want):.3e}"
                      for tag, g in got.items())
                  + f"; change vs parent "
                  f"{grads_rel_err(got['change'], got['parent']):.3e}")
            del got, want
            runs = [time_turns(calls) for _ in range(2)]
        print(f"[ab] {kind} train {case} f32, ms (two runs of 20 calls each "
              f"in turns): " + "; ".join(
                  ", ".join(f"{tag} {ms:.4f}" for tag, ms in t.items())
                  + f" (change / parent {t['change'] / t['parent']:.4f})"
                  for t in runs) + f"; card just after: {card_state()}")
        del args, dy, calls
        torch.cuda.empty_cache()


# --ab's f32 flash shapes: the training path's and whisper-base's encoder
AB_FLASH_CASES = ("path", "whisper encoder")


def compare_flash_f32(parent: Path, f32_fps: float, mem_bps: float) -> None:
    """`--ab`'s f32 flash attention: the parent's wrapper (its package
    imported beside this one as `parent_repro_torch`, building its own
    flash_attention.cu) and this tree's at AB_FLASH_CASES: the change's o,
    lse, dq, dk and dv against the parent's within the f32 tolerances (the
    sums' order differs, so not bit for bit); the forward, the whole
    backward and the dq and dk/dv kernels each alone of both trees in turns
    (the first two with SDPA's f32 forward and backward), beside the
    bounds, and the change's group sum alone; then a full-width qwen2-0.5b
    f32 train step under the profiler on each tree
    (`ab_f32_train_step`)."""
    pfa = tree_module(parent, "kernels.flash_attention", "parent_repro_torch")
    trees = {"parent": pfa, "change": fa}
    # the parent's f32 backward is dq then dk/dv; the change adds the sum
    entries = {"parent": ("flash_attention_bwd_dq",
                          "flash_attention_bwd_dkdv"),
               "change": fa._BWD_ENTRIES[:fa.BWD_LAUNCHES[torch.float32]]}
    gen = torch.Generator("cuda").manual_seed(7)
    for label in AB_FLASH_CASES:
        case = ATTN_CASES[label]
        kw = case.kw
        q, k, v, do = attn_inputs(case, torch.float32, gen)
        outs = {tag: m.flash_attention_fwd(q, k, v, **kw)
                for tag, m in trees.items()}
        grads = {tag: m.flash_attention_bwd(q, k, v, *outs[tag], do, **kw)
                 for tag, m in trees.items()}
        torch.cuda.synchronize()
        errs = {}
        for name, tol, got, want in (
                ("o", FLASH_TOL_O[torch.float32], outs["change"][0],
                 outs["parent"][0]),
                ("lse", FLASH_TOL_LSE, outs["change"][1], outs["parent"][1]),
                *((f"d{x}", FLASH_TOL_G[torch.float32], g, w)
                  for x, g, w in zip("qkv", grads["change"],
                                     grads["parent"]))):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            errs[name] = (got - want).abs().max().item()
        print(f"[ab] f32 flash {label} {case}: change vs parent max |diff| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + " (within the f32 tolerances, |diff| <= tol * (1 + "
              "|parent|); not bit for bit: the sums' order changed)")
        o, lse = outs["change"]
        args = {tag: m._bwd_args(q, k, v, o, lse, do, **kw)
                for tag, m in trees.items()}
        for tag, m in trees.items():          # D and the partials, once
            for entry in entries[tag]:
                m._launch(entry, args[tag][0], q)
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        sdpa = sdpa_fn(case, qs, ks, vs)
        so = sdpa()

        def sdpa_fwd():
            with torch.no_grad():
                sdpa()
        stat = 4 * lse.numel()
        qb, kvb = 4 * q.numel(), 4 * (k.numel() + v.numel())
        for which, fns, products, nbytes in (
                ("forward", {
                    **{tag: (lambda m=m: m.flash_attention_fwd(q, k, v, **kw))
                       for tag, m in trees.items()},
                    "SDPA": sdpa_fwd}, 2, 2 * qb + kvb + stat),
                ("backward", {
                    **{tag: (lambda m=m: m.flash_attention_bwd(
                        q, k, v, o, lse, do, **kw))
                       for tag, m in trees.items()},
                    "SDPA": lambda: torch.autograd.grad(
                        so, (qs, ks, vs), dos, retain_graph=True)},
                 5, 4 * qb + 2 * kvb + stat),
                ("dq kernel", {
                    tag: (lambda m=m, a=args[tag][0]: m._launch(
                        "flash_attention_bwd_dq", a, q))
                    for tag, m in trees.items()}, 3, 3 * qb + kvb + 2 * stat),
                ("dk/dv kernel", {
                    tag: (lambda m=m, a=args[tag][0]: m._launch(
                        "flash_attention_bwd_dkdv", a, q))
                    for tag, m in trees.items()},
                 4, 2 * qb + 2 * kvb + 2 * stat)):
            runs = [time_turns(fns) for _ in range(2)]
            bms, by = attn_bound(case, products, nbytes, f32_fps, mem_bps)
            print(f"[ab] f32 flash {which} {label}, ms (two runs of 20 calls "
                  f"each in turns): " + "; ".join(
                      ", ".join(f"{tag} {ms:.4f}" for tag, ms in t.items())
                      + f" (change / parent {t['change'] / t['parent']:.4f})"
                      for t in runs)
                  + f"; bound {bms:.4f} ms ({by}); change at "
                  f"{100 * bms / runs[-1]['change']:.1f}% of the bound; card "
                  f"just after: {card_state()}")
        ms = time_ms(lambda: fa._launch("flash_attention_bwd_sum",
                                        args["change"][0], q))
        print(f"[ab] f32 flash group sum {label} (the change's third "
              f"launch): {ms:.4f} ms")
        del q, k, v, do, outs, grads, o, lse, args, qs, ks, vs, dos, sdpa, so
        torch.cuda.empty_cache()
    ab_f32_train_step(pfa)


def ab_f32_train_step(parent_fa) -> None:
    """`--ab`: full-width qwen2-0.5b train steps in f32 (B=TRAIN_BATCH x
    S=TRAIN_SEQ) under the profiler, on this tree (`profile_train`, its
    wrappers' counts exact) and once with the parent's flash wrappers in
    place of this tree's: flash's share of device busy on each."""
    cfg = get_config(TRAIN_ARCH).scaled(dtype="float32")
    batch = TRAIN_BATCH
    mine = profile_train(cfg, batch, TRAIN_SEQ)
    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = parent_fa.flash_attention_fwd
    fa.flash_attention_bwd = parent_fa.flash_attention_bwd
    try:
        theirs = profile_train(cfg, batch, TRAIN_SEQ, counted=False)
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved
    print(f"[ab] full-width {TRAIN_ARCH} f32 train step, B={batch} "
          f"S={TRAIN_SEQ}, ms/step: " + "; ".join(
              f"{tag} wall {r['wall_ms']:.3f}, device busy {r['busy_ms']:.3f}"
              f", flash {r['flash_ms']:.3f} "
              f"({r['flash_ms'] / r['busy_ms']:.3f} of busy)"
              for tag, r in (("change", mine), ("parent", theirs))))


def attn_inputs(case: AttnCase, dtype, gen):
    b, s, nq, nkv, hd = case[:5]
    t = case.t or s
    q = torch.randn((b, s, nq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, t, nkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, t, nkv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, nq, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


SCORES_BUDGET = 4 << 30        # bytes of f32 scores a plain call may hold


def head_chunks(q, k) -> list:
    """(query-head slice, kv-head slice) pairs covering every head, as few
    as keep each chunk's f32 scores [B, kv heads, group, S, T] within
    SCORES_BUDGET. Heads are independent, so the plain versions run chunk
    by chunk compute the same function; one chunk for every case but
    gemma2-27b's (8.6 GB of scores at S=8192, 32 heads)."""
    b, s, nq, _ = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    c = max(1, min(nkv, SCORES_BUDGET // (b * g * s * t * 4)))
    return [(slice(h * g, min(h + c, nkv) * g), slice(h, min(h + c, nkv)))
            for h in range(0, nkv, c)]


def plain_fwd(q, k, v, **kw):
    """`flash_attention_ref` over `head_chunks` -> (o, lse)."""
    outs = [flash_attention_ref(q[:, :, qs], k[:, :, ks], v[:, :, ks], **kw)
            for qs, ks in head_chunks(q, k)]
    return (torch.cat([o for o, _ in outs], dim=2),
            torch.cat([lse for _, lse in outs], dim=1))


def plain_bwd(q, k, v, o, lse, do, **kw):
    """`flash_attention_bwd_ref` over `head_chunks` -> (dq, dk, dv)."""
    outs = [flash_attention_bwd_ref(q[:, :, qs], k[:, :, ks], v[:, :, ks],
                                    o[:, :, qs], lse[:, qs], do[:, :, qs],
                                    **kw)
            for qs, ks in head_chunks(q, k)]
    return tuple(torch.cat(g, dim=2) for g in zip(*outs))


def autograd_grads(q, k, v, do, **kw):
    """(dq, dk, dv) by autograd through `attention_ref`, over
    `head_chunks`."""
    outs = []
    for qs, ks in head_chunks(q, k):
        qa, ka, va = (t.detach().clone().requires_grad_()
                      for t in (q[:, :, qs], k[:, :, ks], v[:, :, ks]))
        outs.append(torch.autograd.grad(attention_ref(qa, ka, va, **kw),
                                        (qa, ka, va), do[:, :, qs]))
    return tuple(torch.cat(g, dim=2) for g in zip(*outs))


# o: the kernel rounds once, to the input dtype (tests/test_kernels.py
# tolerances). lse: f32 arithmetic on both sides from the same inputs,
# summed in another order. Grads vs the plain backward: the same f32
# arithmetic from the same o and lse, one rounding to the input dtype.
# Grads vs autograd through attention_ref: in f32 only the summation
# order differs; in bf16 attention_ref also rounds the softmax weights
# to bf16 before P@V and its D comes from the unrounded output, so the
# bf16 grads carry about one more bf16 rounding.
FLASH_TOL_O = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_TOL_LSE = 1e-5
FLASH_TOL_G = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
FLASH_TOL_AG = {torch.bfloat16: 5e-2, torch.float32: 1e-4}


def check_flash_case(label: str, case: AttnCase, dtype, gen,
                     fwd_only: bool = False) -> tuple:
    """The forward and backward kernels at `case` against their plain
    versions, and the backward against autograd through `attention_ref`
    (the forward alone with `fwd_only`); two backward calls bit for bit.
    Returns the max |kernel - plain| of o and of the grads (None with
    `fwd_only`)."""
    tol_o, tol_lse = FLASH_TOL_O, FLASH_TOL_LSE
    tol_g, tol_ag = FLASH_TOL_G, FLASH_TOL_AG
    kw = case.kw
    q, k, v, do = attn_inputs(case, dtype, gen)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ro, rlse = plain_fwd(q, k, v, **kw)
    torch.testing.assert_close(o.float(), ro.float(),
                               rtol=tol_o[dtype], atol=tol_o[dtype])
    torch.testing.assert_close(lse, rlse, rtol=tol_lse, atol=tol_lse)
    e_o = (o.float() - ro.float()).abs().max().item()
    e_lse = (lse - rlse).abs().max().item()
    if fwd_only:
        print(f"[check] flash_attention {label} {case} "
              f"{dtype}, forward only (the prefill's): max |kernel "
              f"- plain| o {e_o:.3e} (tol {tol_o[dtype]}), lse "
              f"{e_lse:.3e} (tol {tol_lse}); tolerances hold |diff| "
              f"<= tol * (1 + |plain|)")
        del q, k, v, do, o, lse, ro, rlse
        torch.cuda.empty_cache()
        return e_o, None
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    # no atomics: the same inputs give the same bits
    for name, g, g2 in zip("qkv", grads, again):
        assert torch.equal(g, g2), \
            f"d{name} differs between two calls ({label}, {dtype})"
    rgrads = plain_bwd(q, k, v, o, lse, do, **kw)
    agrads = autograd_grads(q, k, v, do, **kw)
    e_g = e_ag = 0.0
    for name, g, rg, ag in zip("qkv", grads, rgrads, agrads):
        torch.testing.assert_close(g.float(), rg.float(),
                                   rtol=tol_g[dtype], atol=tol_g[dtype])
        torch.testing.assert_close(g.float(), ag.float(),
                                   rtol=tol_ag[dtype], atol=tol_ag[dtype])
        e_g = max(e_g, (g.float() - rg.float()).abs().max().item())
        e_ag = max(e_ag, (g.float() - ag.float()).abs().max().item())
    print(f"[check] flash_attention {label} {case} "
          f"{dtype}: max |kernel - "
          f"plain| o {e_o:.3e} (tol {tol_o[dtype]}), lse "
          f"{e_lse:.3e} (tol {tol_lse}); dq/dk/dv vs plain "
          f"backward {e_g:.3e} (tol {tol_g[dtype]}), vs autograd "
          f"through attention_ref {e_ag:.3e} (tol {tol_ag[dtype]}); "
          f"two calls bit-identical; tolerances hold |diff| <= tol "
          f"* (1 + |plain|)")
    del q, k, v, do, o, lse, ro, rlse, grads, again, rgrads, agrads
    torch.cuda.empty_cache()
    return e_o, e_g


def check_flash(gen) -> dict:
    """`check_flash_case` at every ATTN_CASES case in both dtypes (the
    forward alone for ATTN_FWD_ONLY's). Returns the max |kernel - plain|
    at the path's shape in bf16 for o and for the grads."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, case in ATTN_CASES.items():
            fwd_only = label in ATTN_FWD_ONLY
            e = check_flash_case(label, case, dtype, gen, fwd_only)
            if not fwd_only:
                errs[(label, dtype)] = e
    return {"o": errs[("path", torch.bfloat16)][0],
            "o_f32": errs[("path", torch.float32)][0],
            "grads": errs[("path", torch.bfloat16)][1],
            "grads_f32": errs[("path", torch.float32)][1],
            **{label: {"o": errs[(label, torch.bfloat16)][0],
                       "grads": errs[(label, torch.bfloat16)][1]}
               for label in FWD_PATH_CASES + BWD_PATH_CASES}}


def sdpa_fn(case: AttnCase, qs, ks, vs):
    """`scaled_dot_product_attention` computing the same function as the
    kernel on `case` (q, k, v as [B, heads, S, hd]), or None where no
    single PyTorch call does: a window or a softcap."""
    if case.window is not None or case.softcap is not None:
        return None
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=case.causal, enable_gqa=True)


def time_fwd(label, dtype, gen, flops_peak, mem_bps, plain_reps) -> dict:
    """The forward at ATTN_CASES[label]: the kernel, the plain version and
    SDPA where it computes the same function (no grad), beside the
    bound."""
    case = ATTN_CASES[label]
    q, k, v, _ = attn_inputs(case, dtype, gen)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = sdpa_fn(case, qs, ks, vs)
    t = {"ms": time_ms(lambda: flash_attention_fwd(q, k, v, **case.kw)),
         "plain_ms": time_ms(lambda: plain_fwd(q, k, v, **case.kw),
                             *plain_reps),
         "library_ms": None}
    if sdpa is not None:
        with torch.no_grad():
            t["library_ms"] = time_ms(sdpa)
    size = q.element_size()
    t["bound_ms"], t["bound_by"] = attn_bound(
        case, 2, size * (2 * q.numel() + k.numel() + v.numel())
        + 4 * case.b * case.nq * case.s, flops_peak, mem_bps)
    route = ("bf16 (mma.sync)" if dtype == torch.bfloat16
             else "f32 (CUDA cores)")
    lib = ("none" if t["library_ms"] is None
           else f"{t['library_ms']:.4f} ms")
    print(f"[time] flash_attention forward {label} {case} {route}: kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA {lib}, "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
          f"{live_pairs(case):,} live pairs); kernel at "
          f"{100 * t['bound_ms'] / t['ms']:.2f}% of the bound")
    del q, k, v, qs, ks, vs, sdpa
    torch.cuda.empty_cache()
    return t


def time_bwd(label, dtype, gen, flops_peak, mem_bps, plain_reps) -> dict:
    """The backward at ATTN_CASES[label]: its kernels (`fa.BWD_LAUNCHES`
    of the dtype), the plain version and SDPA's backward alone
    (autograd.grad on a retained graph) where SDPA computes the same
    function, beside the bound of its 5 products; the dq and dk/dv kernels
    each alone beside the bounds of their 3 and 4 products, in f32 also
    the group sum alone (bound by its bytes); in bf16 SDPA's forward +
    backward."""
    case = ATTN_CASES[label]
    q, k, v, do = attn_inputs(case, dtype, gen)
    o, lse = flash_attention_fwd(q, k, v, **case.kw)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    sdpa = sdpa_fn(case, qs, ks, vs)
    t = {"ms": time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                   **case.kw)),
         "plain_ms": time_ms(lambda: plain_bwd(q, k, v, o, lse, do,
                                               **case.kw), *plain_reps),
         "library_ms": None}
    if sdpa is not None:
        so = sdpa()
        t["library_ms"] = time_ms(lambda: torch.autograd.grad(
            so, (qs, ks, vs), dos, retain_graph=True))
        del so
    size = q.element_size()
    qb, kvb = size * q.numel(), size * (k.numel() + v.numel())
    stat = 4 * lse.numel()                   # lse, or the D scratch
    # bytes: q, k, v, o, do and lse read, dq, dk, dv written
    t["bound_ms"], t["bound_by"] = attn_bound(
        case, 5, 4 * qb + 2 * kvb + stat, flops_peak, mem_bps)
    route = ("bf16 (mma.sync)" if dtype == torch.bfloat16
             else "f32 (CUDA cores)")
    lib = ("none" if t["library_ms"] is None
           else f"{t['library_ms']:.4f} ms")
    print(f"[time] flash_attention backward {label} {case} {route}: "
          f"kernels {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA's "
          f"backward {lib}, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}); kernels at "
          f"{100 * t['bound_ms'] / t['ms']:.2f}% of the bound")
    args, alive, grads = fa._bwd_args(q, k, v, o, lse, do, **case.kw)
    for entry in fa._BWD_ENTRIES[:fa.BWD_LAUNCHES[dtype]]:
        fa._launch(entry, args, q)           # D, and the f32 partials
    # dq: q, k, v, o, do, lse read; dq, D written. dk/dv: q, k, v, do, lse,
    # D read; dk, dv written (f32: each query head's partials, nq / nkv
    # times dk and dv's bytes). The f32 sum: the partials read, dk and dv
    # written.
    f32 = dtype == torch.float32
    written = kvb * case.nq // case.nkv if f32 else kvb
    kernels = [("dq", 3, 3 * qb + kvb + 2 * stat),
               ("dkdv", 4, 2 * qb + kvb + written + 2 * stat)]
    if f32:
        kernels.append(("sum", 0, written + kvb))
    for name, products, nbytes in kernels:
        entry = f"flash_attention_bwd_{name}"
        ms = time_ms(lambda: fa._launch(entry, args, q))
        bms, by = attn_bound(case, products, nbytes, flops_peak, mem_bps)
        t[name] = {"ms": ms, "bound_ms": bms, "bound_by": by}
        print(f"[time]   {name} kernel alone: {ms:.4f} ms, bound of its "
              f"{products} products and {nbytes / 1e6:.1f} MB {bms:.4f} ms "
              f"({by}), {100 * bms / ms:.2f}% of it")
    print(f"[time]   the kernels recompute S and dP (7 products in all, no "
          f"atomics): their own ceiling is {t['bound_ms'] * 7 / 5:.4f} ms, "
          f"the backward at {100 * t['bound_ms'] * 7 / 5 / t['ms']:.2f}% of "
          f"it")
    del args, alive, grads
    if dtype == torch.bfloat16 and sdpa is not None:
        t["sdpa_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qs, ks, vs), dos))
    del q, k, v, do, o, lse, qs, ks, vs, dos, sdpa
    torch.cuda.empty_cache()
    return t


# the flash kernels' shapes on slice 11's paths, timed in bf16: the
# forward at the whisper-base train cell's encoder and decoder, the
# gemma2-27b prefill's two layers and the gemma2 train cell's two layers,
# the backward at the whisper encoder's and decoder's and the gemma2 train
# cell's two layers
FWD_PATH_CASES = ("whisper encoder", "whisper decoder", "gemma2 local",
                  "gemma2 global", "gemma2 train local", "gemma2 train global")
BWD_PATH_CASES = ("whisper encoder", "whisper decoder", "gemma2 train local",
                  "gemma2 train global")


def time_flash(gen, bf16_fps, f32_fps, mem_bps) -> dict:
    """Forward and backward at the path's shape in both dtypes (kernels,
    plain versions, SDPA), the bf16 forward at the Jamba shape and at
    FWD_PATH_CASES, and the bf16 backward at BWD_PATH_CASES, beside their
    bounds."""
    out = {"forward": time_fwd("path", torch.bfloat16, gen, bf16_fps,
                               mem_bps, (20, 3)),
           "backward": time_bwd("path", torch.bfloat16, gen, bf16_fps,
                                mem_bps, (20, 3))}
    fwd, bwd = out["forward"], out["backward"]
    print(f"[time] flash_attention forward+backward bf16: kernels "
          f"{fwd['ms'] + bwd['ms']:.4f} ms, SDPA "
          f"{bwd['sdpa_fwd_bwd_ms']:.4f} ms")
    out["jamba"] = time_fwd("jamba", torch.bfloat16, gen, bf16_fps, mem_bps,
                            (3, 1))
    for label in FWD_PATH_CASES:
        out[("forward", label)] = time_fwd(label, torch.bfloat16, gen,
                                           bf16_fps, mem_bps, (3, 1))
    for label in BWD_PATH_CASES:
        out[("backward", label)] = time_bwd(label, torch.bfloat16, gen,
                                            bf16_fps, mem_bps, (3, 1))
    out["forward_f32"] = time_fwd("path", torch.float32, gen, f32_fps,
                                  mem_bps, (5, 1))
    out["backward_f32"] = time_bwd("path", torch.float32, gen, f32_fps,
                                   mem_bps, (5, 1))
    return out


# the f32 forward's rows that `check_f32_rows` calls again alone
F32_ROWS = 1024


def check_f32_rows(gen) -> None:
    """The f32 forward at the path shape: its rows 0 .. F32_ROWS-1 equal,
    bit for bit (o and lse), a call on the first F32_ROWS positions, and
    its batch row 1 a call on that row alone: a row's result does not
    depend on S or B (the tiny f32 checks compare calls of other
    shapes)."""
    case = ATTN_CASES["path"]
    q, k, v, _ = attn_inputs(case, torch.float32, gen)
    o, lse = flash_attention_fwd(q, k, v, **case.kw)
    n = F32_ROWS
    o_s, lse_s = flash_attention_fwd(q[:, :n], k[:, :n], v[:, :n], **case.kw)
    o_b, lse_b = flash_attention_fwd(q[1:2], k[1:2], v[1:2], **case.kw)
    torch.cuda.synchronize()
    assert torch.equal(o[:, :n], o_s) and torch.equal(lse[..., :n], lse_s), \
        "f32 forward rows depend on S"
    assert torch.equal(o[1:2], o_b) and torch.equal(lse[1:2], lse_b), \
        "f32 forward rows depend on B"
    print(f"[check] flash_attention f32 forward at {case}: rows 0-{n - 1} "
          f"equal a call on the first {n} positions and batch row 1 a call "
          f"on it alone, bit for bit (o and lse)")
    del q, k, v, o, lse, o_s, lse_s, o_b, lse_b
    torch.cuda.empty_cache()


# kernel-name substrings -> the group a train step's device time is
# summed under (first match wins)
KERNEL_GROUPS = (("moe_gemm backward", ("moe_gemm_dx", "moe_gemm_dw",
                                         "moe_gemm_bwd")),
                 ("moe_gemm", ("moe_gemm",)),
                 ("selective scan backward", ("sel_scan_bwd",)),
                 ("selective scan", ("sel_scan",)),
                 ("xLSTM backward", ("mlstm_bwd", "slstm_scan_bwd")),
                 ("xLSTM scans", ("mlstm_scan", "slstm_scan")),
                 ("flash attention", ("flash_",)),
                 ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("softmax (loss)", ("SoftMax",)),
                 ("reductions", ("reduce_kernel",)),
                 ("elementwise and copies", ("elementwise", "copy")))


def profile_train(cfg, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                  n_steps: int = 2, counted: bool = True) -> dict:
    """Full-width train steps of `batch` x `seq` (an encoder-decoder's
    over the zero frames its forward makes when given none, as `train()`
    gives them): host wall per step without
    the profiler, with and without a running `TaskRuntime(num_workers=2,
    mode="ddast")`, the trainer's host runtime (no runtime first and
    last), then device busy time per step by kernel and by group under
    torch.profiler, with the wrappers' launch counts set to 0 just before
    that window and read just after: they must be `train_step_counts`
    exactly; the profiler's flash records (the kernels of the config's
    dtype, FLASH_KERNELS) are printed beside them. `counted=False` (the
    parent's flash wrappers swapped in, `--ab`) skips the counts."""
    model = get_model(cfg, "cuda")
    params = model.init_params(torch.Generator("cuda").manual_seed(1))
    opt = init_opt_state(params)
    step_fn = make_train_step(model, TrainConfig(opt=OptConfig(
        peak_lr=1e-3, warmup_steps=20, total_steps=100)))
    ds = SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in ds.batch_at(i).items()} for i in range(3)]
    step_fn(params, opt, batches[0])                    # warm up
    torch.cuda.synchronize()

    def wall_ms() -> float:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step_fn(params, opt, batches[1 + i % 2])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    plain, threaded = [wall_ms()], []
    for _ in range(2):
        with TaskRuntime(num_workers=2, mode="ddast"):
            threaded.append(wall_ms())
    plain.append(wall_ms())
    print(f"[profile] train step host wall, ms/step over {n_steps} steps: "
          f"no runtime {[round(x, 3) for x in plain]}, a running "
          f"TaskRuntime(num_workers=2, mode='ddast') "
          f"{[round(x, 3) for x in threaded]}")
    wall = statistics.mean(plain)
    zero_train_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps):
            step_fn(params, opt, batches[1 + i % 2])
        torch.cuda.synchronize()
    counts = read_train_counts()
    rows = kernel_rows(prof, n_steps)
    busy = sum(r[0] for r in rows)
    attn = sum(r[0] for r in rows if "flash_" in r[2])
    print(f"[profile] full-width {cfg.name} train step, B={batch} "
          f"S={seq}: wall {wall:.3f} ms/step (no profiler, no "
          f"runtime); device busy {busy:.3f} ms/step in "
          f"{sum(r[1] for r in rows):.0f} kernels; idle share "
          f"{1 - busy / wall:.3f}; flash-attention kernels {attn:.3f} "
          f"ms/step ({attn / busy if busy else 0:.3f} of busy)")
    if not rows:
        print("[profile] device time not measured: the profiler saw no "
              "CUDA kernels")
    print_groups(rows, "ms/step (launches/step)")
    for ms, count, key in rows[:12]:
        print(f"[profile]   {ms:8.4f} ms/step {count:6.1f}x  {key[:90]}")
    result = {"wall_ms": wall, "busy_ms": busy, "flash_ms": attn}
    if not counted:
        del model, params, opt, step_fn, batches, prof
        gc.collect()
        torch.cuda.empty_cache()
        return result
    # The exact gate is the wrappers' counts around the profiled steps: the
    # profiler can drop kernel records (1 of 48 flash forwards has gone
    # missing from a window). A step runs only the flash kernels of its
    # dtype's route, one of each an attention layer: the profiler may see
    # fewer, never more, and none of the other route's.
    per_step = train_step_counts(cfg)
    assert counts == {k: v * n_steps for k, v in per_step.items()}, \
        (counts, per_step)
    flash = {}
    for ms, count, key in rows:
        m = re.search(r"(flash_\w+?_kernel)", key)
        if m:
            flash[m.group(1)] = flash.get(m.group(1), 0) + round(
                count * n_steps)
    n_attn = n_steps * forward_counts(cfg)["flash_attention"]
    want = {k: n_attn for k in FLASH_KERNELS[cfg.torch_dtype]}
    dropped = {k: n - flash.get(k, 0) for k, n in want.items()}
    print(f"[profile] flash launches over the {n_steps} profiled steps: "
          f"wrappers {counts['flash_attention']} forward, "
          f"{counts['flash_attention_bwd']} backward ({want}); profiler "
          f"records {flash}, dropped {dropped}")
    assert set(flash) <= set(want), flash
    assert all(n >= 0 for n in dropped.values()), dropped
    del model, params, opt, step_fn, batches, prof
    gc.collect()
    torch.cuda.empty_cache()
    return result


def print_groups(rows, unit: str) -> None:
    """Device time and launches of `kernel_rows` summed by KERNEL_GROUPS."""
    groups = {}
    for ms, count, key in rows:
        g = next((g for g, subs in KERNEL_GROUPS
                  if any(x in key for x in subs)), "other")
        ms0, n0 = groups.get(g, (0.0, 0.0))
        groups[g] = (ms0 + ms, n0 + count)
    print(f"[profile] by group, {unit}: " + "; ".join(
        f"{g} {ms:.3f} ({n:.0f})" for g, (ms, n) in
        sorted(groups.items(), key=lambda kv: -kv[1][0])))


def kernel_rows(prof, n_steps: int):
    """(device ms per step, launches per step, name) for each kernel the
    profiler saw, longest first."""
    rows = []
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            us = getattr(a, "self_device_time_total", None)
            if us is None:
                us = a.self_cuda_time_total
            rows.append((us / 1e3 / n_steps, a.count / n_steps, a.key))
    rows.sort(reverse=True)
    return rows


def profile_steps(cfg, per_step: int, n_steps: int = 8) -> dict:
    """Full-width engine with all slots decoding, on weights of its own
    (seed 1): see `decode_profile`."""
    model = get_model(cfg, "cuda")
    with torch.no_grad():
        params = model.init_params(torch.Generator("cuda").manual_seed(1))
    params.requires_grad_(False)
    return decode_profile(model, params, per_step, n_steps)


def decode_profile(model, params, per_step: int, n_steps: int = 8,
                   runtime=None) -> dict:
    """An engine with all slots decoding (runtime-backed when `runtime` is
    given): host wall per step without the profiler, then device busy time
    per step by kernel over the same number of steps under
    torch.profiler. Returns wall, busy and idle share."""
    eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=64,
                      num_clients=1, runtime=runtime)
    for i in range(SLOTS):
        eng.submit(Request(prompt=[1 + i, 2, 3], max_new_tokens=64))
    t0 = time.perf_counter()
    warm = 0
    while warm < 3 or eng._free_slots():            # admit and warm up
        warm += 1 if eng.step() else 0
        assert time.perf_counter() - t0 < 60, "slots not filled"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    launches0 = moe_gemm.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    assert moe_gemm.launches - launches0 == per_step * n_steps
    rows = kernel_rows(prof, n_steps)
    busy = sum(r[0] for r in rows)
    moe = sum(r[0] for r in rows if "moe_gemm" in r[2])
    which = "runtime-backed" if runtime is not None else "private loop"
    print(f"[profile] full-width decode step ({which}), {SLOTS} slots "
          f"busy: wall {wall_ms:.3f} ms/step (no profiler); device busy "
          f"{busy:.3f} ms/step in {sum(r[1] for r in rows):.0f} kernels; "
          f"idle share {1 - busy / wall_ms:.3f}; moe_gemm {moe:.3f} "
          f"ms/step ({moe / busy if busy else 0:.3f} of busy)")
    if not rows:
        print("[profile] device time not measured: the profiler saw no "
              "CUDA kernels")
    for ms, count, key in rows[:10]:
        print(f"[profile]   {ms:8.4f} ms/step {count:6.1f}x  {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms}


def drive_traffic(eng: ServeEngine, n: int = REQUESTS,
                  clients: int = CLIENTS, max_new: int = MAX_NEW) -> dict:
    """Phase 5's traffic (`serve_requests`): `n` prompts of 2-9 tokens
    from `RandomState(0)`, sent round-robin from `clients` threads, each
    asking for `max_new` tokens; the engine steps on this thread until
    every request is done. Returns each prompt's tokens, wall and
    steps."""
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 100, rng.randint(2, 10)).tolist(),
                    max_new_tokens=max_new) for _ in range(n)]

    def client(cid: int) -> None:
        for i, r in enumerate(reqs):
            if i % clients == cid:
                eng.submit(r, client_id=cid)
                time.sleep(0.001)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    steps0 = eng.steps
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    while len(eng.completed) < n:
        eng.step()
        assert time.perf_counter() - t0 < 120, "serve timeout"
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = {tuple(r.prompt): r.output for r in reqs}
    assert len(tokens) == n, "two requests share a prompt"
    return {"tokens": tokens, "wall_s": wall, "steps": eng.steps - steps0}


def runtime_serve_path(cfg, per_step: int) -> dict:
    """Slice 16's main path: the runtime-backed engine (`ServeEngine(...,
    runtime=rt)` on `TaskRuntime(num_workers=2, mode="ddast",
    num_clients=CLIENTS)`) on full-width qwen2-moe-a2.7b, phase 5's
    weights (seed 0) and traffic, beside the private drain loop on the
    same model object (private, runtime-backed, private). The moe_gemm
    count is set to 0 just before the runtime-backed run and read just
    after. Every request's tokens must equal the private loop's: at SLOTS
    slots `capacity()` gives each expert at least SLOTS rows, so no token
    is dropped at decode and no row depends on which slot holds it."""
    model = get_model(cfg, "cuda")
    with torch.no_grad():
        params = model.init_params(torch.Generator("cuda").manual_seed(0))
    params.requires_grad_(False)
    assert capacity(cfg, SLOTS) >= SLOTS

    def private_run() -> dict:
        return drive_traffic(ServeEngine(model, params, batch_slots=SLOTS,
                                         max_len=64, num_clients=CLIENTS))

    private = [private_run()]
    # one client slot a client scope, as the JAX package's tests size it;
    # the engine steps on this thread, which owns the main slot
    with TaskRuntime(num_workers=2, mode="ddast",
                     num_clients=CLIENTS) as rt:
        eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=64,
                          num_clients=CLIENTS, runtime=rt)
        moe_gemm.launches = 0
        got = drive_traffic(eng)
        launches = moe_gemm.launches
        admission = eng.scope_admission()
        nonfinite = eng.stats["nonfinite_steps"]
    private.append(private_run())
    scopes = rt.stats.scopes
    steps = got["steps"]
    ms = 1e3 * got["wall_s"] / steps
    private_ms = [1e3 * r["wall_s"] / r["steps"] for r in private]
    tokens = sum(len(v) for v in got["tokens"].values())
    print(f"[runtime-serve] {cfg.name} full width, bf16, "
          f"ServeEngine(runtime=TaskRuntime(num_workers=2, mode='ddast', "
          f"num_clients={CLIENTS})): {len(got['tokens'])} requests, "
          f"{tokens} tokens, {steps} engine steps, wall "
          f"{got['wall_s']:.3f} s, {ms:.3f} ms/step; private drain loop "
          f"on the same model before and after: "
          f"{[round(x, 3) for x in private_ms]} ms/step over "
          f"{[r['steps'] for r in private]} steps; moe_gemm launches "
          f"{launches} ({per_step} per step)")
    print(f"[runtime-serve] scope admission {admission}; runtime scopes "
          f"{ {k: v['tasks'] for k, v in scopes.items()} }")
    assert tokens == REQUESTS * MAX_NEW, tokens
    assert nonfinite == 0, nonfinite
    assert per_step == 72 and launches == per_step * steps > 0, \
        (launches, per_step, steps)
    for r in private:
        bad = [p for p in got["tokens"]
               if got["tokens"][p] != r["tokens"][p]]
        assert not bad, [(p, got["tokens"][p], r["tokens"][p])
                         for p in bad]
    per_client = REQUESTS // CLIENTS
    for c in range(CLIENTS):
        assert admission[f"client{c}"]["admitted"] == per_client, admission
        assert scopes[f"client{c}"]["tasks"] == per_client, scopes
    print(f"[check] runtime-backed engine == private drain loop for all "
          f"{REQUESTS} requests (bf16, cuda); each client admitted "
          f"{per_client}")
    profiles = {"private": decode_profile(model, params, per_step)}
    with TaskRuntime(num_workers=2, mode="ddast", num_clients=1) as rt:
        profiles["runtime"] = decode_profile(model, params, per_step,
                                             runtime=rt)
    del model, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "ms_per_step": ms,
            "private_ms_per_step": private_ms, "profiles": profiles}


class ClockedRuntime(TaskRuntime):
    """A `TaskRuntime` that stamps the host clock at its first submission
    and at each return of a root taskwait on the thread that started it;
    there it also synchronises the card and stamps again (the runners copy
    their result to the host next, which waits for the card all the same;
    the epochs runner's next epoch starts behind the sync). Nested
    taskwaits (N-Body's step bodies, which may run on that thread too) are
    not stamped."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.first_submit: Optional[float] = None
        self.waits: list = []           # (enqueued, card done) a root wait
        self._depth = 0

    def task(self, *args, **kwargs):
        if self.first_submit is None:
            self.first_submit = time.perf_counter()
        return super().task(*args, **kwargs)

    def taskwait(self) -> None:
        main = threading.current_thread() is self._main_thread
        root = main and self._depth == 0
        self._depth += main
        try:
            super().taskwait()
        finally:
            self._depth -= main
        if root and self.first_submit is not None:
            t = time.perf_counter()
            torch.cuda.synchronize()
            self.waits.append((t, time.perf_counter()))


def app_outs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def app_run(name: str, mode: str, run, setup=None, **rt_kw) -> dict:
    """`run(rt)` (a runner of `taskgraph_apps`, numpy in and out) on
    `ClockedRuntime(APP_WORKERS, mode)`; `setup(rt)` first (a tuner).
    Prints the call's wall, the tasks, the graph's time from the first
    submission to the card's last kernel (tasks/s over it) and the host µs
    a task: the first submission to the last root taskwait's return, over
    the tasks."""
    with ClockedRuntime(num_workers=APP_WORKERS, mode=mode, **rt_kw) as rt:
        hook = setup(rt) if setup else None
        t0 = time.perf_counter()
        out = run(rt)
        wall = time.perf_counter() - t0
        enqueued, done = rt.waits[-1]
        first = rt.first_submit
    tasks = rt.stats.tasks_executed
    graph = done - first
    r = {"out": out, "wall_ms": 1e3 * wall, "tasks": tasks,
         "graph_ms": 1e3 * graph, "tasks_per_s": tasks / graph,
         "host_us_per_task": 1e6 * (enqueued - first) / tasks,
         "stats": rt.stats, "hook": hook}
    print(f"[apps] {name}, {mode}: wall {r['wall_ms']:.3f} ms (numpy in, "
          f"numpy out); tasks_executed {tasks}; graph {r['graph_ms']:.3f} "
          f"ms (first submit to the card's last kernel), "
          f"{r['tasks_per_s']:.0f} tasks/s; host "
          f"{r['host_us_per_task']:.3f} us a task")
    return r


def app_modes(name: str, run, tasks: int) -> dict:
    """`app_run` in each of APP_MODES; every result bit-identical to the
    first mode's, and `tasks` tasks executed in each."""
    runs = {mode: app_run(name, mode, run) for mode in APP_MODES}
    ref = app_outs(runs[APP_MODES[0]]["out"])
    for mode, r in runs.items():
        assert r["tasks"] == tasks, (name, mode, r["tasks"], tasks)
        assert all(np.array_equal(x, y) for x, y in
                   zip(app_outs(r["out"]), ref)), f"{name}: {mode} differs"
    print(f"[check] {name}: bit-identical across {', '.join(APP_MODES)}; "
          f"{tasks} tasks each; host us a task "
          + ", ".join(f"{m} {r['host_us_per_task']:.3f}"
                      for m, r in runs.items()))
    return runs


def rel_err(got, want: torch.Tensor) -> float:
    """max |got - want| / max |want| on the card in float64 (`got` a numpy
    array or a tensor)."""
    g = torch.as_tensor(got).to("cuda", torch.float64)
    return float((g - want).abs().max() / want.abs().max())


def app_profile(name: str, run, graph_ms: float, products: int) -> None:
    """One `ddast` run of `run` under torch.profiler: device busy in
    kernels (copies and fills apart), the idle share against the
    unprofiled run's graph time `graph_ms`, and launches by group. The
    profiler keeps only some kernel records of such a window (55 of 512
    have gone missing): every one of the `products` launches the same
    kernels once each, so a kernel seen on most products counts at its
    mean time on all of them."""
    with ClockedRuntime(num_workers=APP_WORKERS, mode="ddast") as rt:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(rt)
        prof_graph = 1e3 * (rt.waits[-1][1] - rt.first_submit)
    rows = kernel_rows(prof, 1)
    kern = [r for r in rows if not r[2].startswith(("Memcpy", "Memset"))]
    seen = sum(r[0] for r in kern)
    busy = sum(ms * products / n if products / 2 <= n < products else ms
               for ms, n, _ in kern)
    copies = sum(r[0] for r in rows) - seen
    print(f"[profile] {name}, ddast: device busy {seen:.3f} ms in "
          f"{sum(r[1] for r in kern):.0f} kernel records, {busy:.3f} ms "
          f"with each product's kernels counted on all {products}; idle "
          f"share {1 - busy / graph_ms:.3f} of the unprofiled graph "
          f"{graph_ms:.3f} ms ({1 - busy / prof_graph:.3f} of the profiled "
          f"run's own {prof_graph:.3f} ms); copies and fills {copies:.3f} "
          f"ms (the inputs in, the result out)")
    if not kern:
        print("[profile] device time not measured: the profiler saw no "
              "CUDA kernels")
    print_groups(kern, "ms (launches)")
    for ms, count, key in kern[:4]:
        print(f"[profile]   {ms:9.4f} ms {count:6.0f}x  {key[:90]}")


def plain_matmul(a: np.ndarray, b: np.ndarray, bs: int) -> dict:
    """The runner's products (`addmm_` into a view of C, the same views,
    the same (i, j, k) order) in a plain loop on this thread, no runtime:
    host us a product and the time to the card's last kernel."""
    nb = a.shape[0] // bs
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    ct = torch.zeros_like(at)

    def views(t):
        return {(i, j): t[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
                for i in range(nb) for j in range(nb)}

    ab, bb, cb = views(at), views(bt), views(ct)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(nb):
        for j in range(nb):
            for k in range(nb):
                cb[(i, j)].addmm_(ab[(i, k)], bb[(k, j)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = nb ** 3
    r = {"out": ct.cpu().numpy(), "host_us_per_task": 1e6 * (t1 - t0) / n,
         "graph_ms": 1e3 * (t2 - t0), "tasks_per_s": n / (t2 - t0)}
    print(f"[apps] matmul fine, plain loop on this thread (no runtime): "
          f"{n} products, host {r['host_us_per_task']:.3f} us a product, "
          f"graph {r['graph_ms']:.3f} ms, {r['tasks_per_s']:.0f} "
          f"products/s")
    return r


def empty_matmul_graph(rt, nb: int) -> None:
    """The Matmul runner's task graph (nb³ tasks, its dependences and
    labels) with empty bodies: what the runtime alone costs the host."""
    for i in range(nb):
        for j in range(nb):
            for k in range(nb):
                rt.task(lambda: None,
                        deps=[(("A", i, k), "in"), (("B", k, j), "in"),
                              (("C", i, j), "inout")],
                        label=f"gemm{i}.{j}.{k}")
    rt.taskwait()


def apps_path() -> None:
    """Slice 17's path: the paper's three applications
    (`repro_torch.core.taskgraph_apps`) on the card through
    `TaskRuntime(num_workers=APP_WORKERS)` in each mode of APP_MODES, f32
    inputs from seeded numpy (TF32 off since phase 1): Matmul coarse and
    fine, the fine products in a plain loop beside them, the fine run on
    a side stream and under a DynamicTuner, `run_matmul_epochs` with
    replay, Sparse LU, nested N-Body, each held bit-identical across the
    modes and within APP_TOL of a float64 run on the card; a
    torch.profiler window over one `ddast` run each of coarse and fine
    Matmul."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    marks = [t_phase]

    def peak(label: str) -> None:
        marks.append(time.perf_counter())
        print(f"[apps] {label}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{marks[-1] - marks[-2]:.1f} s")
        torch.cuda.reset_peak_memory_stats()

    # warm-up, not reported: the CUDA context and cuBLAS handles of this
    # thread and of pooled worker threads, and both products' kernels
    for _, bs in (MM_COARSE, MM_FINE):
        w = np.ones((2 * bs, 2 * bs), np.float32)
        with TaskRuntime(num_workers=APP_WORKERS, mode="sync") as rt:
            run_matmul(rt, w, w, bs)
    peak("warm-up")

    # ---- Matmul, coarse: device-bound blocks
    n, bs = MM_COARSE
    a = rng.random((n, n), dtype=np.float32)
    b = rng.random((n, n), dtype=np.float32)
    name = f"matmul coarse n={n} bs={bs}"
    runs = app_modes(name, lambda rt: run_matmul(rt, a, b, bs),
                     (n // bs) ** 3)
    want = matmul_oracle_torch(a, b)
    err = rel_err(runs["ddast"]["out"], want)
    err32 = rel_err(matmul_oracle_torch(a, b, dtype=torch.float32), want)
    print(f"[check] {name} vs one float64 torch.matmul on the card: "
          f"{err:.3e} of the largest |C| (tolerance {APP_TOL}); one float32 "
          f"torch.matmul {err32:.3e}")
    assert err <= APP_TOL, err
    del want
    app_profile(name, lambda rt: run_matmul(rt, a, b, bs),
                runs["ddast"]["graph_ms"], (n // bs) ** 3)
    peak(name)
    del a, b, runs

    # ---- Matmul, fine: the runtime sets the pace
    n, bs = MM_FINE
    a = rng.random((n, n), dtype=np.float32)
    b = rng.random((n, n), dtype=np.float32)
    tasks = (n // bs) ** 3
    name = f"matmul fine n={n} bs={bs}"
    fine = app_modes(name, lambda rt: run_matmul(rt, a, b, bs), tasks)
    c = fine["ddast"]["out"]
    want = matmul_oracle_torch(a, b)
    err = rel_err(c, want)
    print(f"[check] {name} vs float64 torch.matmul on the card: {err:.3e} "
          f"(tolerance {APP_TOL})")
    assert err <= APP_TOL, err
    base = plain_matmul(a, b, bs)
    assert np.array_equal(base["out"], c), "plain loop != runtime"
    print(f"[check] {name}: the plain loop's C is bit-identical to the "
          f"runtime's; the runtime costs "
          + ", ".join(f"{m} {r['host_us_per_task'] - base['host_us_per_task']:.3f}"
                      for m, r in fine.items())
          + " host us a task more")
    empty = {mode: app_run(name + " with empty bodies", mode,
                           lambda rt: empty_matmul_graph(rt, n // bs))
             for mode in APP_MODES}
    print(f"[apps] {name}: host us a task of the runtime alone (empty "
          f"bodies) "
          + ", ".join(f"{m} {r['host_us_per_task']:.3f}"
                      for m, r in empty.items())
          + "; the bodies' PyTorch calls add "
          + ", ".join(f"{m} {fine[m]['host_us_per_task'] - r['host_us_per_task']:.3f}"
                      for m, r in empty.items())
          + f" (one product in the plain loop: "
          f"{base['host_us_per_task']:.3f})")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        on_side = app_run(name + " on a side stream", "ddast",
                          lambda rt: run_matmul(rt, a, b, bs))
    assert np.array_equal(on_side["out"], c), "side stream differs"
    print(f"[check] {name}: the run on a side stream is bit-identical to "
          f"the default stream's")
    tuned = app_run(name + " with DynamicTuner", "ddast",
                    lambda rt: run_matmul(rt, a, b, bs),
                    setup=lambda rt: DynamicTuner(
                        rt, TunerConfig(interval_s=0.0005)))
    tuner = tuned["hook"]
    assert tuned["tasks"] == tasks
    assert np.array_equal(tuned["out"], c), "tuned run differs"
    print(f"[check] {name} with DynamicTuner: bit-identical to the untuned "
          f"run; {len(tuner.adjustments)} adjustments (max_ddast_threads, "
          f"max_ops_thread; last {[a_[1:] for a_ in tuner.adjustments[-4:]]}"
          f"), final max_ddast_threads {tuner.rt.params.max_ddast_threads}")
    epochs = app_run(f"matmul_epochs fine x{MM_EPOCHS}, replay", "ddast",
                     lambda rt: run_matmul_epochs(rt, a, b, bs, MM_EPOCHS),
                     replay=True)
    st = epochs["stats"]
    assert epochs["tasks"] == MM_EPOCHS * tasks, epochs["tasks"]
    err = rel_err(epochs["out"], MM_EPOCHS * want)
    err1 = rel_err(epochs["out"], MM_EPOCHS * torch.from_numpy(c).cuda()
                   .double())
    print(f"[check] matmul_epochs: {MM_EPOCHS} A@B within {err:.3e} of "
          f"float64 (tolerance {APP_TOL}), {err1:.3e} of {MM_EPOCHS} x the "
          f"single run's C; replay iterations {st.replay_iterations}, "
          f"replayed tasks {st.replayed_tasks}, invalidations "
          f"{st.replay_invalidations} (printed only)")
    assert err <= APP_TOL, err
    del want
    app_profile(name, lambda rt: run_matmul(rt, a, b, bs),
                fine["ddast"]["graph_ms"], tasks)
    peak(name)
    del a, b, c, fine, base, empty, on_side, tuned, epochs

    # ---- Sparse LU: the irregular graph
    n, bs = LU_SIZE
    m = rng.random((n, n), dtype=np.float32) + n * np.eye(n, dtype=np.float32)
    name = f"sparselu n={n} bs={bs}"
    lu = app_modes(name, lambda rt: run_sparselu(rt, m, bs),
                   len(sim_sparselu_specs(n // bs)))
    want = sparselu_oracle_torch(m, bs)
    got32 = sparselu_oracle_torch(m, bs, dtype=torch.float32)
    got = torch.from_numpy(lu["ddast"]["out"]).cuda()
    errs = {}
    for part, f in (("L", lambda x: torch.tril(x, -1)), ("U", torch.triu)):
        w = f(want)
        errs[part] = rel_err(f(got), w)
        errs[part + " (f32 oracle)"] = rel_err(f(got32), w)
    # the same calls in the same order per block as the sequential oracle
    same = torch.equal(got, got32)
    print(f"[check] {name} vs the sequential oracle in float64 on the card, "
          f"of each factor's largest |entry| (tolerance {APP_TOL}): {errs}; "
          f"bit-identical to the oracle in f32: {same}")
    assert errs["L"] <= APP_TOL and errs["U"] <= APP_TOL, errs
    assert same, "sparselu differs from its f32 sequential oracle"
    peak(name)
    del m, lu, want, got, got32

    # ---- N-Body: nested tasks; masses sum to ~0.5 (N-body units)
    nn, bs, steps = NBODY
    pos = rng.random((nn, 3), dtype=np.float32)
    vel = np.zeros((nn, 3), np.float32)
    mass = rng.random(nn, dtype=np.float32) / nn
    name = f"nbody N={nn} bs={bs} steps={steps}"
    nbr = app_modes(name, lambda rt: run_nbody(rt, pos, vel, mass, bs,
                                               steps),
                    steps * (2 * (nn // bs) + 1))
    want = nbody_oracle_torch(pos, vel, mass, steps)
    got32 = nbody_oracle_torch(pos, vel, mass, steps, dtype=torch.float32)
    errs = {}
    for i, part in enumerate(("p", "v")):
        errs[part] = rel_err(nbr["ddast"]["out"][i], want[i])
        errs[part + " (f32 oracle)"] = rel_err(got32[i], want[i])
    same = all(torch.equal(torch.from_numpy(x).cuda(), y)
               for x, y in zip(nbr["ddast"]["out"], got32))
    print(f"[check] {name} vs the oracle in float64 on the card, of the "
          f"largest magnitude (tolerance {APP_TOL}): {errs}; bit-identical "
          f"to the oracle in f32: {same}")
    assert errs["p"] <= APP_TOL and errs["v"] <= APP_TOL, errs
    peak(name)
    del nbr, want, got32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[apps] phase 33 took {time.perf_counter() - t_phase:.1f} s")


class _NoRuntime:
    """Takes the place of a runtime in `procs.apps.submit_*`: runs
    nothing, so the calls those return are the graph to run serially."""

    def task(self, *args, **kwargs) -> None:
        pass


def renamed(calls, mapping: dict) -> list:
    """The same calls on other arrays: each name in `mapping` swapped."""
    return [(f, tuple(mapping.get(x, x) for x in a), d, lb)
            for f, a, d, lb in calls]


def dev_array(shape, src=None, dtype=torch.float32):
    arr = papps.DeviceArray(shape, dtype)
    if src is not None:
        arr.tensor.copy_(src.reshape(arr.tensor.shape))
    return arr


def serial_run(calls, reps: int = 1) -> float:
    """`run_serial` of the calls in this process, `reps` times; seconds
    to the card's last kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        papps.run_serial(calls)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fork_server() -> str:
    """This process's fork server: its pid and resident memory (it holds
    torch and the port's modules once preloaded)."""
    from multiprocessing import forkserver
    pid = forkserver._forkserver._forkserver_pid
    if pid is None:
        return "none"
    with open(f"/proc/{pid}/status") as f:
        rss = [ln.split()[1] for ln in f if ln.startswith("VmRSS")]
    return f"pid {pid}, resident {int(rss[0]) / 2**10:.0f} MiB"


def proc_run(label: str, submit, tasks: int, mode: str = "sharded",
             **kw) -> dict:
    """`submit(rt)` then a taskwait on `ProcessRuntime(PROC_WORKERS, mode,
    device="cuda", metrics=True)`: the graph's wall from the first submit
    to the taskwait's return (every body's device work is synchronised in
    its worker before its Done), tasks/s, host us a task, and the counter
    plane's body and device-sync seconds."""
    torch.cuda.synchronize()
    rt = ProcessRuntime(num_workers=PROC_WORKERS, mode=mode, device="cuda",
                        metrics=True, **kw)
    t0 = time.perf_counter()
    rt.start()
    start_s = time.perf_counter() - t0
    with rt:
        t0 = time.perf_counter()
        submit(rt)
        rt.taskwait()
        wall = time.perf_counter() - t0
    st = rt.stats
    plane = st.metrics["workers"]["totals"]
    assert st.tasks_executed == tasks, (label, st.tasks_executed, tasks)
    assert plane["tasks_finished"] == tasks, (label, plane)
    assert st.leaked_shm == [], st.leaked_shm
    r = {"rt": rt, "graph_ms": 1e3 * wall,
         "tasks_per_s": tasks / wall, "host_us_per_task": 1e6 * wall / tasks,
         "exec_ms": 1e3 * plane["exec_time_s"],
         "sync_ms": 1e3 * plane["sync_time_s"],
         "start_s": start_s,
         "startup_s": [w["startup_s"] for w in rt.worker_starts],
         "boot_s": [w["boot_s"] for w in rt.worker_starts],
         "device_s": [w["device_s"] for w in rt.worker_starts]}
    print(f"[procs] {label}, {mode}: graph {r['graph_ms']:.3f} ms (first "
          f"submit to the last Done), {r['tasks_per_s']:.0f} tasks/s, host "
          f"{r['host_us_per_task']:.3f} us a task; the bodies "
          f"{r['exec_ms']:.3f} ms in all ({1e3 * r['exec_ms'] / tasks:.3f} "
          f"us a task), their device syncs {r['sync_ms']:.3f} ms "
          f"({1e3 * r['sync_ms'] / tasks:.3f} us a task); start() "
          f"{start_s:.3f} s, worker start-ups "
          + ", ".join(f"{x:.3f} (to its first line {y:.3f}, its CUDA "
                      f"context {z:.3f})" for x, y, z in zip(
                          r["startup_s"], r["boot_s"], r["device_s"]))
          + f" s; fork server {fork_server()}")
    return r


def thread_run(label: str, submit, tasks: int, mode: str) -> dict:
    """The same graph on `TaskRuntime(PROC_WORKERS, mode)` (bodies on this
    process's tensors and stream): graph wall to the card's last kernel,
    tasks/s, host us a task to the taskwait's return."""
    torch.cuda.synchronize()
    with TaskRuntime(num_workers=PROC_WORKERS, mode=mode) as rt:
        t0 = time.perf_counter()
        submit(rt)
        rt.taskwait()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    assert rt.stats.tasks_executed == tasks
    r = {"graph_ms": 1e3 * (t2 - t0), "tasks_per_s": tasks / (t2 - t0),
         "host_us_per_task": 1e6 * (t1 - t0) / tasks}
    print(f"[procs] {label}, {mode}, threads: graph {r['graph_ms']:.3f} ms "
          f"(first submit to the card's last kernel), "
          f"{r['tasks_per_s']:.0f} tasks/s, host {r['host_us_per_task']:.3f}"
          f" us a task (no counter plane on threads)")
    return r


def load_example(name: str):
    """`examples/torch_<name>.py` as a module (imported, not run)."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example(name: str, out: dict, counts: dict) -> str:
    """The checks of one example's result on the card (beside the ones the
    example makes itself); returns what they found, for the log."""
    if name == "train_lm":
        first, resumed = out["first"], out["resumed"]
        steps = len(first["losses"]) + len(resumed["losses"])
        want = {k: steps * v for k, v in
                train_step_counts(tiny_config("qwen2-0.5b")).items()}
        assert counts == want, (counts, want)
        assert counts["flash_attention"] > 0
        assert all(map(math.isfinite, first["losses"] + resumed["losses"]))
        assert first["final_loss"] < first["losses"][0], first["losses"]
        step_ms = [1e3 * x for x in first["step_s"] + resumed["step_s"]]
        return (f"{steps} steps, each {statistics.median(step_ms):.3f} ms "
                f"(median; the first {step_ms[0]:.1f}, the slowest "
                f"{max(step_ms):.1f}); loss {first['losses'][0]:.4f} -> "
                f"{first['final_loss']:.4f}, resumed to "
                f"{resumed['final_loss']:.4f}; {first['ckpt_writes']} async "
                f"checkpoint writes; launches {counts} ({steps} steps' "
                f"worth)")
    # the task bodies are library calls and tensor ops, and serving
    # tiny qwen2-0.5b decodes through the plain attention op
    assert not any(counts.values()), counts
    if name == "quickstart":
        for mode, r in out.items():
            assert r["tasks"] == EXAMPLE_TASKS[name], (mode, r["tasks"])
            rel = r["max_err"] / float(np.abs(r["c"]).max())
            assert rel <= APP_TOL, (mode, rel)
        return "; ".join(
            f"{m} {r['tasks']} tasks, max err vs float64 {r['max_err']:.3e}"
            f" ({r['max_err'] / np.abs(r['c']).max():.3e} of the largest "
            f"|C|, tolerance {APP_TOL})" for m, r in out.items())
    if name == "multi_tenant":
        assert out["tasks"] == EXAMPLE_TASKS[name], out["tasks"]
        return (f"{out['tasks']} tasks, {out['replay_iterations']} replayed "
                f"iterations; each tenant within 1e-2 of float64 (the "
                f"example's check)")
    if name == "serve_lm":
        n_req, new = EXAMPLE_SERVE
        assert (out["requests"], out["tokens"]) == (n_req, n_req * new), out
        assert out["stats"]["nonfinite_steps"] == 0, out["stats"]
        return (f"{out['requests']} requests, {out['tokens']} tokens, "
                f"{out['engine_steps']} engine steps, {out['tok_per_s']:.1f} "
                f"tok/s")
    if name == "sparselu_taskgraph":
        rel = out["max_err"] / float(np.abs(out["oracle"]).max())
        assert rel <= APP_TOL, rel
        return (f"{out['tasks']} tasks, max err vs the numpy oracle "
                f"{out['max_err']:.3e} ({rel:.3e} of the largest |LU|, "
                f"tolerance {APP_TOL}); simulator speedups "
                + ", ".join(f"{m} {r.speedup:.2f}"
                            for m, r in out["sim"].items()))
    assert name == "multi_process", name
    assert out["exact"], "n-body on the process backend != run_serial"
    assert out["spin_tasks"] == {"threads": 24, "processes": 24}, out
    assert out["nbody_tasks"] == EXAMPLE_TASKS[name], out["nbody_tasks"]
    assert out["events"] > 0
    return (f"spin chains threads {out['spin_ms']['threads']:.1f} ms, "
            f"processes {out['spin_ms']['processes']:.1f} ms; n-body "
            f"{out['nbody_tasks']} tasks on device arrays by CUDA IPC, "
            f"bit-identical to run_serial; {out['events']} trace events")


def examples_path() -> dict:
    """Slice 20's path: each of the port's examples through its `main()`
    on the card at its defaults but EXAMPLE_CUTS (see the module
    docstring, phase 36).
    Returns {"launches": {name: the kernel launches of its run},
    "flash_errs": {the train example's flash shape: (o, grads) errors}}."""
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    launches, walls, shapes = {}, {}, {}
    try:
        for name in EXAMPLES:
            mod = load_example(name)
            kw = dict(EXAMPLE_CUTS.get(name, {}))
            if name == "multi_process":
                kw["trace_dir"] = trace_dir
            torch.cuda.synchronize()
            zero_train_counts()
            t0 = time.perf_counter()
            out = mod.main(device="cuda", **kw)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            launches[name] = read_train_counts()
            if name == "train_lm":
                shapes = read_flash_shapes()
            found = check_example(name, out, launches[name])
            print(f"[examples] examples/torch_{name}.py on the card: "
                  f"{walls[name]:.3f} s; {found}")
            del out
            gc.collect()
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    # the flash kernels at the shapes the training example gave them,
    # against their plain versions (tiny qwen2-0.5b: bf16, hd 16)
    cfg = tiny_config("qwen2-0.5b")
    gen = torch.Generator("cuda").manual_seed(0)
    assert shapes["forward"] and set(shapes["forward"]) == set(
        shapes["backward"]), shapes
    flash_errs = {}
    for key in sorted(shapes["forward"], key=str):
        (b, s_, nq, hd), t, causal, window, softcap = key
        case = AttnCase(b, s_, nq, cfg.num_kv_heads, hd, window, softcap,
                        causal, None if t == s_ else t)
        assert case_key(case) == key, (case, key)
        flash_errs[key] = check_flash_case(
            "train example", case, cfg.torch_dtype, gen)
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    print(f"[examples] /dev/shm entries the phase left: {left or 'none'}")
    print(f"[examples] phase 36 took {time.perf_counter() - t_phase:.1f} s "
          f"(budget {EXAMPLES_BUDGET_S:.0f} s): "
          + ", ".join(f"{n} {w:.1f}" for n, w in walls.items()))
    torch.cuda.empty_cache()
    return {"launches": launches, "flash_errs": flash_errs}


def procs_path() -> None:
    """Slice 19's path: the process backend with worker processes that
    each hold their own CUDA context, on `DeviceArray`s shared by CUDA IPC
    (see the module docstring, phase 35)."""
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    rng = np.random.default_rng(0)

    # ---- Matmul, fine: 4,096 products, the host sets the pace
    n, bs = PROC_MM
    nb = n // bs
    tasks = nb ** 3
    name = f"matmul n={n} bs={bs}"
    a = torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda()
    b = torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda()
    A, B, C, Cs = dev_array((n, n), a), dev_array((n, n), b), \
        dev_array((n, n)), dev_array((n, n))
    calls = papps.submit_matmul(_NoRuntime(), A.name, B.name, C.name, nb, bs)
    serial_s = serial_run(renamed(calls, {C.name: Cs.name}))
    print(f"[procs] {name}: run_serial in this process {1e3 * serial_s:.3f}"
          f" ms, {1e6 * serial_s / tasks:.3f} us a product")
    A64, B64, C64 = (dev_array((n, n), x, torch.float64)
                     for x in (a, b, torch.zeros_like(a)))
    serial_run(renamed(calls, {A.name: A64.name, B.name: B64.name,
                               C.name: C64.name}))
    err = rel_err(Cs.tensor, C64.tensor)
    print(f"[check] {name}: the serial f32 run vs the same recurrence in "
          f"float64 on the card: {err:.3e} of the largest |C| (tolerance "
          f"{PROC_TOL})")
    assert err <= PROC_TOL, err
    for x in (A64, B64, C64):
        x.close_unlink()
    del a, b

    def submit_mm(rt):
        return papps.submit_matmul(rt, A.name, B.name, C.name, nb, bs)

    procs, threads = {}, {}
    for mode in APP_MODES:
        C.tensor.zero_()
        r = proc_run(name, submit_mm, tasks, mode)
        assert torch.equal(C.tensor, Cs.tensor), f"{name} {mode}: != serial"
        if mode == APP_MODES[0]:
            rt = r["rt"]
            print(f"[procs] start method {rt.start_method}; workers (widx, "
                  f"pid, start-up s with the CUDA context): "
                  + ", ".join(f"({w['widx']}, {w['pid']}, "
                              f"{w['startup_s']:.3f})"
                              for w in rt.worker_starts)
                  + f"; this process {os.getpid()}")
        procs[mode] = r
        C.tensor.zero_()
        threads[mode] = thread_run(name, submit_mm, tasks, mode)
        assert torch.equal(C.tensor, Cs.tensor), \
            f"{name} {mode} threads: != serial"
    print(f"[check] {name}: every process and threads run bit-identical to "
          f"run_serial in this process; host us a task, processes "
          + ", ".join(f"{m} {r['host_us_per_task']:.3f}"
                      for m, r in procs.items())
          + "; threads "
          + ", ".join(f"{m} {r['host_us_per_task']:.3f}"
                      for m, r in threads.items()))

    # ---- the same Matmul x3 under replay: epochs 2 and 3 on the plane
    C.tensor.zero_()
    epoch_ms = []

    def submit_epochs(rt):
        for _ in range(MM_EPOCHS):
            t0 = time.perf_counter()
            submit_mm(rt)
            rt.taskwait()
            epoch_ms.append(1e3 * (time.perf_counter() - t0))

    r = proc_run(f"{name} x{MM_EPOCHS}, replay", submit_epochs,
                 MM_EPOCHS * tasks, replay=True)
    ipc = [tuple(x) for x in r["rt"].stats.ipc_iter]
    serial_run(renamed(calls, {C.name: Cs.name}), reps=MM_EPOCHS - 1)
    assert torch.equal(C.tensor, Cs.tensor), "replayed epochs != serial"
    assert ipc[0][0] > 0 and ipc[1:MM_EPOCHS] == [(0, 0)] * (MM_EPOCHS - 1), \
        ipc
    print(f"[check] {name} x{MM_EPOCHS} under replay: equal to {MM_EPOCHS} "
          f"serial epochs; (Submit, Done) frames by epoch {ipc}; epochs "
          + ", ".join(f"{x:.3f}" for x in epoch_ms) + " ms")
    for x in (A, B, C, Cs):
        x.close_unlink()

    # ---- Sparse LU: the irregular graph, column loops in each body
    lnb, lbs = PROC_LU
    ln = lnb * lbs
    m = torch.from_numpy(rng.random((ln, ln), dtype=np.float32)).cuda()
    m += ln * torch.eye(ln, device="cuda")
    blocks = m.view(lnb, lbs, lnb, lbs).transpose(1, 2)
    M, Ms = dev_array(ln * ln, blocks), dev_array(ln * ln, blocks)
    del m, blocks
    calls = papps.submit_sparselu(_NoRuntime(), M.name, lnb, lbs)
    name = f"sparselu n={ln} bs={lbs}"
    proc_run(name, lambda rt: papps.submit_sparselu(rt, M.name, lnb, lbs),
             len(calls))
    serial_s = serial_run(renamed(calls, {M.name: Ms.name}))
    assert torch.equal(M.tensor, Ms.tensor), f"{name} != serial"
    assert torch.isfinite(M.tensor).all()
    print(f"[check] {name}: {len(calls)} tasks bit-identical to run_serial "
          f"in this process ({1e3 * serial_s:.3f} ms there)")
    for x in (M, Ms):
        x.close_unlink()

    # ---- N-Body, flat: force rows then integrate rows
    nn, steps = PROC_NBODY
    pos = torch.from_numpy(rng.random(nn, dtype=np.float32)).cuda()
    P, V, Acc = dev_array(nn, pos), dev_array(nn), dev_array(nn)
    P2, V2, A2 = dev_array(nn, pos), dev_array(nn), dev_array(nn)
    name = f"nbody n={nn} steps={steps}"
    calls = papps.submit_nbody(_NoRuntime(), P.name, V.name, Acc.name, nn,
                               steps)
    proc_run(name, lambda rt: papps.submit_nbody(
        rt, P.name, V.name, Acc.name, nn, steps), len(calls))
    serial_run(renamed(calls, {P.name: P2.name, V.name: V2.name,
                               Acc.name: A2.name}))
    assert torch.equal(P.tensor, P2.tensor) and \
        torch.equal(V.tensor, V2.tensor), f"{name} != serial"
    assert V.tensor.abs().sum() > 0
    print(f"[check] {name}: {len(calls)} tasks, positions and velocities "
          f"bit-identical to run_serial in this process")
    for x in (P, V, Acc, P2, V2, A2):
        x.close_unlink()

    # ---- a seeded worker kill on the card: the stencil, then a CUDA call
    # in the respawned worker
    cells, stages, seed = PROC_KILL
    init = torch.from_numpy(rng.random(cells, dtype=np.float32)).cuda()
    b0, b1, s0, s1 = (dev_array(cells, init), dev_array(cells),
                      dev_array(cells, init), dev_array(cells))
    plan = FaultPlan.seeded_kills(seed, PROC_WORKERS, cells * stages, kills=1)
    probes: list = []

    def submit_kill(rt):
        calls = chaos.submit_pingpong(rt, b0.name, b1.name, cells, 0, stages,
                                      retries=3)
        rt.taskwait()
        respawned = {w["pid"] for w in rt.worker_starts[PROC_WORKERS:]}
        for _ in range(8):               # least-loaded placement: 4 at once
            wds = [rt.task(chaos.worker_probe, "cuda", label=f"probe{w}")
                   for w in range(PROC_WORKERS)]
            rt.taskwait()
            probes[:] = [wd.result for wd in wds]
            if respawned & {p_["pid"] for p_ in probes}:
                break
        return calls

    name = f"pingpong cells={cells} stages={stages}, seeded kill {seed}"
    torch.cuda.synchronize()
    with ProcessRuntime(num_workers=PROC_WORKERS, mode="sharded",
                        device="cuda", ipc_batch=1, fault_plan=plan) as rt:
        t0 = time.perf_counter()
        calls = submit_kill(rt)
        wall = time.perf_counter() - t0
    st = rt.stats
    papps.run_serial(renamed(calls, {b0.name: s0.name, b1.name: s1.name}))
    torch.cuda.synchronize()
    assert torch.equal(b0.tensor, s0.tensor), "killed run != serial"
    assert torch.equal(b1.tensor, s1.tensor), "killed run != serial"
    assert st.worker_respawns >= 1, st.worker_respawns
    assert st.leaked_shm == [], st.leaked_shm
    fresh = rt.worker_starts[PROC_WORKERS:]
    seen = [p_ for p_ in probes if p_["pid"] in {w["pid"] for w in fresh}]
    assert seen and all(p_["value"] == 30.0 for p_ in probes), probes
    print(f"[check] {name}: serial-exact after {st.worker_respawns} "
          f"respawn(s), {st.task_retries} retries, {st.trace_lost} task(s) "
          f"lost in flight, leaked_shm {st.leaked_shm}; {wall:.3f} s; "
          f"respawned worker(s) (pid, start-up s with a new CUDA context): "
          + ", ".join(f"({w['pid']}, {w['startup_s']:.3f})" for w in fresh)
          + f"; a CUDA call there: {seen[0]}")
    for x in (b0, b1, s0, s1):
        x.close_unlink()

    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    print(f"[procs] /dev/shm entries the phase left: {left or 'none'}")
    print(f"[procs] phase 35 took {time.perf_counter() - t_phase:.1f} s "
          f"(budget {PROC_BUDGET_S:.0f} s)")
    gc.collect()
    torch.cuda.empty_cache()


def sel_inputs(case, dtype, gen, with_h0=True):
    """Selective-scan operands on the card, at the Mamba path's scales: x,
    dt, b, c in `dtype` (b and c as column slices of one x_proj-like
    output, with its row stride); a_log, d and h0 in f32."""
    b, s, d, n = case

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = rnd(b, s, d).to(dtype)
    dt = (torch.nn.functional.softplus(rnd(b, s, d)) * 0.1).to(dtype)
    dbc = (rnd(b, s, 32 + 2 * n) * 0.5).to(dtype)
    a_log = torch.log(torch.arange(1, n + 1, device="cuda",
                                   dtype=torch.float32)).expand(d, n) \
        + rnd(d, n) * 0.1
    return (x, dt, a_log.contiguous(), dbc[..., 32:32 + n], dbc[..., 32 + n:],
            torch.ones(d, device="cuda"),
            rnd(b, d, n) if with_h0 else None)


def scan_digest(scan=selective_scan) -> str:
    """SHA-256 of the selective scan's y and h_last at the path's shape in
    bf16 with no h0, on inputs from a generator seeded 7: the bits of the
    forward kernel as the inference path launches it (`scan`: this tree's
    wrapper or another checkout's), to compare two trees' kernels."""
    args = sel_inputs(SCAN_CASES["path"], torch.bfloat16,
                      torch.Generator("cuda").manual_seed(7), False)
    y, h_last = scan(*args)
    return hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()
                          + h_last.cpu().numpy().tobytes()).hexdigest()


def lin_inputs(case, dtype, gen):
    b, s, d = case[:3]
    a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device="cuda"))
    bx = torch.randn((b, s, d), generator=gen, device="cuda")
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    return a.to(dtype), bx.to(dtype), h0


def check_scans(gen, mem_bps, sfu_rate, f32_fps, split_libs) -> dict:
    """Both scan kernels against their plain versions (y at the dtype's
    tolerance, h_last at 1e-3: tests/test_kernels.py's), two calls on the
    same inputs bit for bit, and the selective scan's state carried across
    two calls equal to one call bit for bit; the linear scan also on
    LIN_DEEP, more tiles than the card holds blocks; then the times at the
    path's shape in bf16: each kernel through its wrapper by plain CUDA
    events (as every kernel in the table is timed) and behind a queued
    device sleep (the device's time alone), and the selective scan in
    every (R, P) split of `split_libs` behind the sleep.
    Returns, for each kernel, its max |kernel - plain| at the path's shape
    in bf16, its times and bound, and the linear scan's launches through
    `ops.ssm_scan`."""
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    tol_h = 1e-3
    out = {"selective_scan": {}, "ssm_scan": {}}
    lib = sscan._lib()
    for dtype in (torch.bfloat16, torch.float32):
        for label, case in SCAN_CASES.items():
            args = sel_inputs(case, dtype, gen)
            y, h = selective_scan(*args)
            y_again, h_again = selective_scan(*args)
            torch.cuda.synchronize()
            assert torch.equal(y, y_again) and torch.equal(h, h_again), label
            yr, hr = selective_scan_ref(*args)
            torch.testing.assert_close(y.float(), yr.float(), rtol=tol[dtype],
                                       atol=tol[dtype])
            torch.testing.assert_close(h, hr, rtol=tol_h, atol=tol_h)
            e_y = (y.float() - yr.float()).abs().max().item()
            e_h = (h - hr).abs().max().item()
            # the state carried across two calls equals one call, bit for bit
            x, dt, a_log, bm, cm, dv, h0 = args
            k = min(SCAN_SPLIT, case[1] // 2)
            y1, h1 = selective_scan(x[:, :k], dt[:, :k], a_log, bm[:, :k],
                                    cm[:, :k], dv, h0)
            y2, h2 = selective_scan(x[:, k:], dt[:, k:], a_log, bm[:, k:],
                                    cm[:, k:], dv, h1)
            torch.cuda.synchronize()
            assert torch.equal(torch.cat([y1, y2], 1), y) and \
                torch.equal(h2, h), (label, dtype)
            if label == "path" and dtype == torch.bfloat16:
                out["selective_scan"]["max_abs_err"] = e_y
            print(f"[check] selective_scan {label} {case} {dtype}, h0 "
                  f"given, B and C strided: max |kernel - plain| y "
                  f"{e_y:.3e} (tol {tol[dtype]}), h_last {e_h:.3e} (tol "
                  f"{tol_h}); two calls bit-identical; state carried over "
                  f"2 calls ({k} + {case[1] - k} steps) == 1 call bit for "
                  f"bit; tolerances hold |diff| <= tol * (1 + |plain|)")
            del args, y, h, y_again, h_again, yr, hr, x, dt, bm, cm, y1, \
                h1, y2, h2
            lin_cases = [(label, case[:3])]
            if label == "path":
                lin_cases.append(("deep", LIN_DEEP))
            for lin_label, lcase in lin_cases:
                a, bx, h0 = lin_inputs(lcase, dtype, gen)
                got, again = ssm_scan(a, bx, h0), ssm_scan(a, bx, h0)
                want = ssm_scan_ref(a, bx, h0)
                torch.cuda.synchronize()
                assert torch.equal(got, again), (lin_label, dtype)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol[dtype], atol=tol[dtype])
                e_l = (got.float() - want.float()).abs().max().item()
                if label == "path" and lin_label == "path" and \
                        dtype == torch.bfloat16:
                    out["ssm_scan"]["max_abs_err"] = e_l
                b_, s_, d_ = lcase
                tiles = b_ * -(-d_ // lib.ssm_scan_tile(1)) \
                    * -(-s_ // lib.ssm_scan_tile(0))
                resident = torch.cuda.get_device_properties(0) \
                    .multi_processor_count * lib.ssm_scan_blocks_per_sm(
                        int(dtype == torch.bfloat16))
                print(f"[check] ssm_scan {lin_label} {lcase} {dtype}, h0 "
                      f"given: max |kernel - plain| {e_l:.3e} (tol "
                      f"{tol[dtype]}); two calls bit-identical; {tiles} "
                      f"tiles, {resident} blocks resident at once")
                del a, bx, h0, got, again, want
            torch.cuda.empty_cache()

    # h0 not given: both kernels start from a zero state (a null pointer)
    case = SCAN_CASES["ragged S=1000 D=200"]
    for dtype in (torch.bfloat16, torch.float32):
        args = sel_inputs(case, dtype, gen, False)
        (y, h), (yr, hr) = selective_scan(*args), selective_scan_ref(*args)
        a, bx, _ = lin_inputs(case, dtype, gen)
        got, want = ssm_scan(a, bx), ssm_scan_ref(a, bx)
        torch.cuda.synchronize()
        for kout, kref in ((y, yr), (got, want)):
            torch.testing.assert_close(kout.float(), kref.float(),
                                       rtol=tol[dtype], atol=tol[dtype])
        torch.testing.assert_close(h, hr, rtol=tol_h, atol=tol_h)
        print(f"[check] selective_scan and ssm_scan {case} {dtype}, no h0: "
              f"max |kernel - plain| y "
              f"{(y.float() - yr.float()).abs().max().item():.3e}, h_last "
              f"{(h - hr).abs().max().item():.3e}, ssm_scan "
              f"{(got.float() - want.float()).abs().max().item():.3e}")
        del args, y, h, yr, hr, a, bx, got, want

    # ssm_scan's path: ops.ssm_scan, the state carried across two calls
    # (within rounding: the split changes how the look-back associates)
    b, s, d, _ = SCAN_CASES["path"]
    a, bx, _ = lin_inputs(SCAN_CASES["path"], torch.float32, gen)
    whole = ops.ssm_scan(a, bx)
    ssm_scan.launches = 0
    first = ops.ssm_scan(a[:, :SCAN_SPLIT], bx[:, :SCAN_SPLIT])
    rest = ops.ssm_scan(a[:, SCAN_SPLIT:], bx[:, SCAN_SPLIT:],
                        first[:, -1])
    out["ssm_scan"]["launches"] = ssm_scan.launches
    torch.cuda.synchronize()
    assert out["ssm_scan"]["launches"] == 2, out
    torch.testing.assert_close(torch.cat([first, rest], 1), whole,
                               rtol=1e-4, atol=1e-4)
    print(f"[check] ops.ssm_scan at the path's shape, f32, state carried "
          f"over 2 calls ({SCAN_SPLIT} + {s - SCAN_SPLIT} steps) vs 1 "
          f"call: max diff "
          f"{(torch.cat([first, rest], 1) - whole).abs().max().item():.3e} "
          f"(tol 1e-4); ssm_scan launches {out['ssm_scan']['launches']} "
          f"(one kernel a call)")
    del a, bx, whole, first, rest

    print(f"[check] selective_scan {SCAN_CASES['path']} bf16, no h0, seeded "
          f"7: sha256 of y and h_last {scan_digest()}")

    # times at the path's shape in bf16 (plain versions: one Python step
    # per time step, so few repeats); the selective scan in every (R, P)
    # split built, each held against the plain version first and timed
    # behind the device sleep, as its launches alone (no wrapper checks)
    n = SCAN_CASES["path"][3]
    args = sel_inputs(SCAN_CASES["path"], torch.bfloat16, gen, False)
    yr, _ = selective_scan_ref(*args)
    shipped = (lib.selective_scan_split(0), lib.selective_scan_split(1))
    splits = {}
    for split, vlib in split_libs.items():
        y, _ = sscan.launch_sel(vlib.selective_scan_bf16, *args)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), yr.float(), rtol=3e-2,
                                   atol=3e-2)
        splits[split] = time_ms(
            lambda: sscan.launch_sel(vlib.selective_scan_bf16, *args),
            backlog=True)
        err = (y.float() - yr.float()).abs().max().item()
        mark = " (the split the wrapper runs)" if split == shipped else ""
        print(f"[time] selective_scan {SCAN_CASES['path']} bf16, R="
              f"{split[0]} states a thread, P={split[1]} of them on the FMA "
              f"pipes, behind a device sleep: {splits[split]:.4f} ms; max "
              f"|kernel - plain| {err:.3e}{mark}")
        del y
    del yr
    # the same steps over D/8 channels: 32 blocks, one an SM, so the time is
    # one block's walk through time with the SM to itself
    lone_args = sel_inputs((b, s, d // 8, n), torch.bfloat16, gen, False)
    lone = time_ms(lambda: selective_scan(*lone_args), backlog=True)
    print(f"[time] selective_scan {(b, s, d // 8, n)} bf16, one block an "
          f"SM, behind a device sleep: {lone:.4f} ms, {1e6 * lone / s:.2f} "
          f"ns a step")
    del lone_args
    t = {"ms": time_ms(lambda: selective_scan(*args)),
         "device_ms": time_ms(lambda: selective_scan(*args), backlog=True),
         "plain_ms": time_ms(lambda: selective_scan_ref(*args), 1, 0),
         "library_ms": None,
         "splits_ms": {f"R={r_} P={p_}": v for (r_, p_), v in
                       splits.items()},
         "one_block_an_sm_ms": lone}
    nbytes = 2 * (3 * b * s * d + 2 * b * s * n) + 4 * (d * n + d
                                                        + b * d * n)
    t.update(scan_bound(nbytes, b * s * d * n, 6 * b * s * d * n, mem_bps,
                        sfu_rate, f32_fps))
    out["selective_scan"].update(t)
    a, bx, _ = lin_inputs(SCAN_CASES["path"], torch.bfloat16, gen)
    t = {"ms": time_ms(lambda: ssm_scan(a, bx)),
         "device_ms": time_ms(lambda: ssm_scan(a, bx), backlog=True),
         "plain_ms": time_ms(lambda: ssm_scan_ref(a, bx), 1, 0),
         "library_ms": None}
    t.update(scan_bound(2 * 3 * b * s * d, 0, 2 * b * s * d, mem_bps,
                        sfu_rate, f32_fps))
    out["ssm_scan"].update(t)
    for kname, t in out.items():
        shape = SCAN_CASES["path"][:3 if kname == "ssm_scan" else 4]
        print(f"[time] {kname} {shape} bf16: kernel {t['ms']:.4f} ms "
              f"(behind a device sleep {t['device_ms']:.4f} ms), "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; bytes alone {t['bytes_bound_ms']:.4f} ms, "
              f"every exp2 on the SFU {t['sfu_only_bound_ms']:.4f} ms); "
              f"kernel at {100 * t['bound_ms'] / t['ms']:.2f}% of the bound, "
              f"{100 * t['bytes_bound_ms'] / t['ms']:.2f}% of the bytes' "
              f"time; no single PyTorch call computes it")
    del args, a, bx
    torch.cuda.empty_cache()
    return out


# The backward's tolerance, by output dtype, on max |kernel - plain| /
# max(1, max |plain|): its sums over time, D and the batch run in other
# orders than the plain version's and its exp2 is ex2.approx, so f32
# outputs are held to 1e-3, the forward's h_last tolerance; bf16 outputs
# (dx, ddt, dB, dC) are rounded once on each side, up to 2^-8 apart.
SCAN_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
SCAN_GRADS = ("dx", "ddt", "da_log", "db", "dc", "dd", "dh0")


def grad_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max(1, max |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def check_scan_bwd(gen, mem_bps, sfu_rate, f32_fps) -> dict:
    """The selective-scan backward kernel (and its second pass) against
    `selective_scan_bwd_ref` at every SCAN_CASES and SCAN_BWD_EDGES shape,
    in bf16 and f32, with h0 and a dh_last cotangent and without either,
    B and C strided:
    each gradient within SCAN_BWD_TOL, two calls bit for bit, and the
    forward that keeps the segment states bit-identical to the plain
    launch in y and h_last. Then the gradients through `selective_scan`'s
    autograd Function against autograd through `selective_scan_ref`; then
    times at the Jamba train path's shape in bf16 (the Mamba path: no h0,
    no dh_last). Returns the max |kernel - plain| there and the times."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, case in {**SCAN_CASES, **SCAN_BWD_EDGES}.items():
            for with_h0 in (True, False):
                args = sel_inputs(case, dtype, gen, with_h0)
                y, h_last, h_seg = sscan._forward_states(*args)
                y_plain, h_plain = selective_scan(*args)
                dy = torch.randn(y.shape, generator=gen,
                                 device="cuda").to(dtype)
                dh = (torch.randn(h_last.shape, generator=gen, device="cuda")
                      if with_h0 else None)
                got = selective_scan_bwd(*args, dy, dh, h_seg)
                again = selective_scan_bwd(*args, dy, dh, h_seg)
                want = selective_scan_bwd_ref(*args, dy, dh)
                torch.cuda.synchronize()
                assert torch.equal(y, y_plain) and \
                    torch.equal(h_last, h_plain), (label, dtype)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    f"selective_scan_bwd differs between two calls {label}"
                errs = {}
                for name, g, w in zip(SCAN_GRADS, got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape, \
                        (name, g.dtype, w.dtype, g.shape, w.shape)
                    errs[name] = grad_err(g, w)
                    tol = SCAN_BWD_TOL[g.dtype]
                    assert errs[name][1] <= tol, (label, dtype, name,
                                                  errs[name], tol)
                if label == "train" and dtype == torch.bfloat16 and \
                        not with_h0:
                    out["max_abs_err"] = max(e for e, _ in errs.values())
                print(f"[check] selective_scan_bwd {label} {case} {dtype}, "
                      f"{'h0 and dh_last' if with_h0 else 'no h0, no dh_last'}"
                      f", B and C strided: max |kernel - plain| (over max(1,"
                      f" |plain|)) " + ", ".join(
                          f"{k} {e:.3e} ({r:.2e})" for k, (e, r) in
                          errs.items())
                      + f" (tol {SCAN_BWD_TOL[dtype]} for {dtype} outputs, "
                      f"{SCAN_BWD_TOL[torch.float32]} for f32); two calls "
                      f"bit-identical; the forward keeping the states "
                      f"equals the plain launch bit for bit")
                del args, y, h_last, h_seg, y_plain, h_plain, dy, dh, got, \
                    again, want
            torch.cuda.empty_cache()

    # through the autograd Function: b and c column slices of one leaf
    for dtype in (torch.bfloat16, torch.float32):
        b_, s_, d_, n_ = 2, 100, 64, 16
        x, dt, a_log, bm, cm, dv, h0 = sel_inputs((b_, s_, d_, n_), dtype, gen)
        dbc = torch.cat([torch.zeros_like(bm[..., :8]), bm, cm], -1)
        base = (x, dt, a_log, dbc, dv, h0)
        wy = torch.randn((b_, s_, d_), generator=gen, device="cuda")
        wh = torch.randn((b_, d_, n_), generator=gen, device="cuda")

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_() for t in base]
            xx, dtt, al, bc, dd_, hh = leaves
            y, hl = fn(xx, dtt, al, bc[..., 8:8 + n_], bc[..., 8 + n_:], dd_,
                       hh)
            loss = (y.float() * wy).sum() + (hl * wh).sum()
            return torch.autograd.grad(loss, leaves)

        zero_train_counts()
        got = grads(selective_scan)
        counts = read_train_counts()
        want = grads(selective_scan_ref)
        torch.cuda.synchronize()
        assert (counts["selective_scan"], counts["selective_scan_bwd"],
                counts["selective_scan_bwd_reduce"]) == (1, 1, 1), counts
        errs = {}
        for name, g, w in zip(("x", "dt", "a_log", "dbc", "d", "h0"), got,
                              want):
            errs[name] = grad_err(g, w)
            assert errs[name][1] <= SCAN_BWD_TOL[g.dtype], (name, errs)
        print(f"[check] selective_scan autograd {(b_, s_, d_, n_)} {dtype}, "
              f"B and C slices of one leaf, h0 and h_last in the loss: "
              f"grads through the kernels vs autograd through "
              f"selective_scan_ref, max |diff| (over max(1, |plain|)) "
              + ", ".join(f"{k} {e:.3e} ({r:.2e})"
                          for k, (e, r) in errs.items())
              + "; one launch each of the forward, the backward and its "
              "second pass")

    # times at the Jamba train path's shape, bf16
    b, s, d, n = SCAN_CASES["train"]
    args = sel_inputs(SCAN_CASES["train"], torch.bfloat16, gen, False)
    _, _, h_seg = sscan._forward_states(*args)
    dy = torch.randn((b, s, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    t = {"ms": time_ms(lambda: selective_scan_bwd(*args, dy, None, h_seg)),
         "device_ms": time_ms(lambda: selective_scan_bwd(*args, dy, None,
                                                         h_seg),
                              backlog=True),
         "plain_ms": time_ms(lambda: selective_scan_bwd_ref(*args, dy), 1, 0),
         "library_ms": None,
         # the forward as the path runs it, plain and keeping the states
         "forward_device_ms": time_ms(lambda: selective_scan(*args),
                                      backlog=True),
         "forward_states_device_ms": time_ms(
             lambda: sscan._forward_states(*args), backlog=True)}
    # bytes: x, dt, dy, B, C and h_seg read, dx, ddt, dB, dC written (bf16),
    # a_log and D read and da_log, dD, dh0 written (f32); operations: one
    # exp2 and ~20 flops a state a step (the recurrence and the reverse
    # walk's products)
    nseg = h_seg.shape[1]
    nbytes = (2 * (5 * b * s * d + 4 * b * s * n) + 4 * b * nseg * d * n
              + 4 * 2 * (d * n + d) + 4 * b * d * n)
    t.update(scan_bound(nbytes, b * s * d * n, 20 * b * s * d * n, mem_bps,
                        sfu_rate, f32_fps))
    out.update(t)
    print(f"[time] selective_scan_bwd {(b, s, d, n)} bf16 (both kernels): "
          f"{t['ms']:.4f} ms (behind a device sleep {t['device_ms']:.4f} "
          f"ms), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}; bytes alone {t['bytes_bound_ms']:.4f} ms, "
          f"every exp2 on the SFU {t['sfu_only_bound_ms']:.4f} ms); kernel "
          f"at {100 * t['bound_ms'] / t['ms']:.2f}% of the bound; no single "
          f"PyTorch call computes it. The forward at this shape behind a "
          f"device sleep: {t['forward_device_ms']:.4f} ms plain, "
          f"{t['forward_states_device_ms']:.4f} ms keeping the states")
    del args, h_seg, dy
    torch.cuda.empty_cache()
    return out


def jamba_tiny_f32():
    """Tiny Jamba with the published 8-position period (tiny_config keeps
    only pattern[:4], which has no attention layer), one repeat, f32, and
    a capacity factor at which the MoE drops no token."""
    return tiny_config(JAMBA).scaled(pattern=get_config(JAMBA).pattern,
                                     repeats=1, dtype="float32",
                                     capacity_factor=16.0)


def forward_counts(cfg) -> dict:
    """Kernel launches of one full-sequence forward of `cfg`: a flash
    forward a self-attention layer (an encoder-decoder's encoder layers
    too; its cross-attention takes the plain op), a selective scan a
    Mamba layer, three grouped GEMMs a MoE layer, an mLSTM or sLSTM scan
    an xLSTM layer."""
    per = lambda f: sum(map(f, cfg.pattern)) * cfg.repeats  # noqa: E731
    return {"selective_scan": per(lambda b: b.mixer == "mamba"),
            "flash_attention": per(lambda b: b.mixer.startswith("attn"))
            + cfg.encoder_layers,
            "moe_gemm": 3 * per(lambda b: b.ffn == "moe"),
            "mlstm_scan": per(lambda b: b.mixer == "mlstm"),
            "slstm_scan": per(lambda b: b.mixer == "slstm")}


# (name, wrapper) of every counter a forward reads (read_counts)
FORWARD_COUNTERS = (("selective_scan", selective_scan),
                    ("flash_attention", fa.flash_attention),
                    ("moe_gemm", moe_gemm),
                    ("mlstm_scan", xls.mlstm_scan),
                    ("slstm_scan", xls.slstm_scan))


def read_counts() -> dict:
    return {name: fn.launches for name, fn in FORWARD_COUNTERS}


def only(**nonzero) -> dict:
    """A `read_counts` dict: these counts, every other 0."""
    return {name: nonzero.get(name, 0) for name, _ in FORWARD_COUNTERS}


def zero_counts() -> None:
    for _, fn in FORWARD_COUNTERS:
        fn.launches = 0
    fa.flash_attention.by_shape.clear()


def case_key(case: AttnCase) -> tuple:
    """The flash wrappers' `by_shape` key of a call at `case`."""
    return ((case.b, case.s, case.nq, case.hd), case.t or case.s,
            case.causal, case.window, case.softcap)


def shape_launches(by_shape: dict, want: dict) -> dict:
    """A flash wrapper's launches by call shape, read just after a path's
    run, at each ATTN_CASES label of `want` (label -> the launches the
    config gives that shape). Fails unless each shape's count is the
    config's and together they make up every launch of the run."""
    got = {label: by_shape.get(case_key(ATTN_CASES[label]), 0)
           for label in want}
    assert got == want and sum(by_shape.values()) == sum(got.values()), \
        (by_shape, want)
    return got


def prefill_and_serve(cfg, seq: int, per_call: dict, n_calls: int = 3,
                      bsz: int = 1) -> dict:
    """A prefill main path at full width: `make_prefill_step` on `cfg`,
    random bf16 weights from a seeded generator, `bsz` x `seq` (a warm-up,
    then `n_calls` timed calls, launch counts set to 0 just before and
    read after the first call and after all of them, `per_call` a call),
    a profiled prefill, then the serving engine on the same weights and
    the traffic of phase 5 (counts set to 0 just before and read just
    after: `per_call`'s moe_gemm a step, no flash, no scan)."""
    assert forward_counts(cfg) == per_call, forward_counts(cfg)
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, "cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init_params(torch.Generator("cuda").manual_seed(0))
    params.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[prefill] {cfg.name} full width, {cfg.num_layers} layers, "
          f"{n_params:,} parameters by sum of numel (ModelConfig.param_count "
          f"{cfg.param_count():,}), {n_bytes / 2**30:.2f} GiB of weights, "
          f"made in {time.perf_counter() - t0:.2f} s")
    prefill = make_prefill_step(model)
    tokens = torch.randint(0, cfg.vocab_size, (bsz, seq),
                           generator=torch.Generator("cuda").manual_seed(2),
                           device="cuda")
    batch = {"tokens": tokens}
    zero_counts()
    walls = []
    logits = None
    for i in range(1 + n_calls):
        logits = None       # the last call's logits go before the next's
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        assert logits.shape == (bsz, seq, padded_vocab(cfg)), logits.shape
        # a batch row at a time: the whole check's bool copy would take
        # half the logits' memory again
        assert all(bool(torch.isfinite(row).all()) for row in logits), \
            "non-finite logits"
        if i == 0:
            counts = read_counts()
            assert counts == per_call, (counts, per_call)
    counts = read_counts()
    shapes = dict(fa.flash_attention.by_shape)
    peak = torch.cuda.max_memory_allocated()
    assert counts == {k: v * (1 + n_calls) for k, v in per_call.items()}, \
        counts
    ms = 1e3 * statistics.median(walls[1:])
    print(f"[prefill] B={bsz} S={seq} bf16: wall "
          f"{[round(1e3 * w, 1) for w in walls]} ms (first is the warm-up); "
          f"median of {n_calls} {ms:.1f} ms, "
          f"{bsz * seq / ms * 1e3:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches over {1 + n_calls} calls "
          f"{counts} ({per_call} a call); logits finite, last row max "
          f"|logit| {logits[0, -1].float().abs().max().item():.4f}")
    del logits
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    rows = kernel_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    print(f"[profile] full-width {cfg.name} prefill (B={bsz}, S={seq}): wall "
          f"{ms:.3f} ms (no profiler); device busy {busy:.3f} ms in "
          f"{sum(r[1] for r in rows):.0f} kernels; idle share "
          f"{1 - busy / ms:.3f}")
    if not rows:
        print("[profile] device time not measured: the profiler saw no "
              "CUDA kernels")
    print_groups(rows, "ms (launches)")
    for t_ms, count, key in rows[:10]:
        print(f"[profile]   {t_ms:9.4f} ms {count:6.1f}x  {key[:90]}")
    del prof

    # serving on the same weights
    zero_counts()
    out = serve_requests(model, params, REQUESTS, CLIENTS, SLOTS, MAX_NEW)
    serve_counts = read_counts()
    steps = out["engine_steps"]
    print(f"[serve] {cfg.name} full width, {cfg.num_layers} layers, bf16: "
          f"{out['requests']} requests, {out['tokens']} tokens, {steps} "
          f"engine steps, wall {out['wall_s']:.3f} s, "
          f"{out['tok_per_s']:.2f} tok/s, "
          f"{1e3 * out['wall_s'] / steps:.2f} ms/step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{serve_counts}; stats {out['stats']}")
    assert out["requests"] == REQUESTS and \
        out["tokens"] == REQUESTS * MAX_NEW, out
    assert serve_counts == only(moe_gemm=per_call["moe_gemm"] * steps) \
        and steps > 0, (serve_counts, steps)
    assert out["stats"]["nonfinite_steps"] == 0, out["stats"]
    out_wall, out_tok_s = out["wall_s"], out["tok_per_s"]
    del model, params, prefill, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_counts": counts, "prefill_shapes": shapes,
            "serve_counts": serve_counts, "prefill_ms": ms,
            "peak_gib": peak / 2**30, "calls": 1 + n_calls,
            "serve_ms_per_step": 1e3 * out_wall / steps,
            "serve_tok_per_s": out_tok_s}


def jamba_prefill_and_serve() -> dict:
    """Slice 3's main path: full-width Jamba cut to JAMBA_REPEATS of its
    periods, prefill at PREFILL_SEQ and serving on the same weights."""
    cfg = get_config(JAMBA).scaled(repeats=JAMBA_REPEATS)
    return prefill_and_serve(cfg, PREFILL_SEQ, only(
        selective_scan=14, flash_attention=2, moe_gemm=24))


def gemma2_prefill_and_serve() -> dict:
    """Slice 11's main path: full-width gemma2-27b, all 46 layers (23
    local with the 4096-key window, 23 global, both softcapped), prefill
    at GEMMA2_SEQ (past the window) and serving on the same weights."""
    cfg = get_config(GEMMA2)
    assert cfg.param_count() == GEMMA2_PARAMS, cfg.param_count()
    assert GEMMA2_SEQ > cfg.sliding_window
    out = prefill_and_serve(cfg, GEMMA2_SEQ, only(flash_attention=46))
    local, glob = mixer_layers(cfg)
    out["prefill_shapes"] = shape_launches(out["prefill_shapes"], {
        "gemma2 local": local * out["calls"],
        "gemma2 global": glob * out["calls"]})
    print(f"[prefill] {GEMMA2} flash-forward launches by shape over "
          f"{out['calls']} prefills: {out['prefill_shapes']}")
    return out


def mixer_layers(cfg) -> tuple[int, int]:
    """(local, global) attention layers of a decoder arch's config."""
    per = lambda m: sum(b.mixer == m for b in cfg.pattern) * cfg.repeats  # noqa: E731,E501
    return per("attn_local"), per("attn")


def tiny_decode_check(cfg, toks, frames=None) -> tuple:
    """Tiny f32 `cfg` on the card, weights from seed 0: decode step by step
    over `toks` [B, S] (after `fill_cross_cache` over `frames` for an
    encoder-decoder) equals the forward within 1e-4, and the forward
    launches `forward_counts(cfg)`. Returns (model, params, max |diff|,
    the forward's launches)."""
    model = get_model(cfg, "cuda")
    params = model.init_params(torch.Generator("cuda").manual_seed(0))
    params.requires_grad_(False)
    b, s = toks.shape
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    zero_counts()
    with torch.inference_mode():
        ref, _ = model.forward(params, batch)
        counts = read_counts()
        cache = model.init_cache(b, s)
        if frames is not None:
            cache = params.fill_cross_cache(cache, frames)
        outs = []
        for t in range(s):
            lg, cache = model.decode_step(params, cache, toks[:, t], t)
            outs.append(lg)
    err = (torch.stack(outs, 1) - ref).abs().max().item()
    assert counts == forward_counts(cfg), counts
    assert err < 1e-4, err
    return model, params, err, counts


def jamba_tiny_checks() -> dict:
    """Tiny f32 Jamba (full pattern) on the card: decode == forward, the
    engine == greedy decode; then under autograd the selective scan runs
    its Function and ssm_scan raises. Returns the kernel launches of the
    f32 forward."""
    toks = torch.randint(0, 500, (2, 8), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
    model, params, err, counts = tiny_decode_check(jamba_tiny_f32(), toks)
    print(f"[check] tiny {JAMBA} (full 8-position pattern, f32, cuda): "
          f"decode step by step vs forward max |diff| {err:.3e} (tol "
          f"1e-4); the forward launched {counts}")
    prompts = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 8, 1, 6]]
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, num_clients=1)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=5)) for p in prompts]
    eng.run_until_drained()
    for p, r in zip(prompts, reqs):
        want = greedy_decode(model, params,
                             torch.tensor([p], device="cuda"), 5, 32)
        assert r.output == want[0].tolist(), (p, r.output, want)
    print(f"[check] tiny {JAMBA} engine == greedy decode for "
          f"{len(prompts)} requests (f32, cuda)")
    del model, params, eng

    # under grad the selective scan runs its autograd Function; ssm_scan,
    # with no backward kernel, raises
    args = sel_inputs((1, 64, 32, 16), torch.float32,
                      torch.Generator("cuda").manual_seed(4))
    x = args[0].clone().requires_grad_()
    y, _ = selective_scan(x, *args[1:])
    assert y.grad_fn is not None, "selective_scan under grad has no grad_fn"
    a = torch.rand((1, 64, 32), device="cuda", requires_grad=True)
    try:
        ssm_scan(a, args[0])
    except NotImplementedError as e:
        print(f"[check] selective_scan under grad returns y with grad_fn "
              f"{type(y.grad_fn).__name__}; ssm_scan on an operand that "
              f"requires grad raises: {e}")
    else:
        raise AssertionError("ssm_scan under grad did not raise")
    with torch.no_grad():
        ssm_scan(a, args[0])
    torch.cuda.synchronize()
    return counts


def xlstm_inputs(kind: str, case, gen) -> tuple:
    """Seeded f32 operands of one scan at (B, S, H, hd), as the layers make
    them: q (scaled by hd**-0.5), k, v, i, f (forget gates biased open, as
    b_f = 3), or pre, w_r (N(0, 1/hd), as the init) and bias."""
    b, s, h, hd = case
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731,E501
    if kind == "mlstm_scan":
        return (r(b, s, h, hd) * hd ** -0.5, r(b, s, h, hd), r(b, s, h, hd),
                r(b, s, h), r(b, s, h) + 3.0)
    return r(b, s, 4, h, hd), r(4, h, hd, hd) * hd ** -0.5, r(4, h, hd) * 0.1


def xlstm_bound(kind: str, case, mem_bps: float, f32_fps: float,
                chunk: int = 0) -> dict:
    """Least ms for one scan at (B, S, H, hd): each input read once and y
    written once at the memory rate, or its f32 operations at the CUDA-core
    rate (no tensor-core form keeps the f32 recurrence), whichever is
    longer. mLSTM, the step form's work: an entry of C takes one FMA a
    step and C q one more (4 flops), n and n . q 4 flops a column. sLSTM:
    the recurrent products, 4 hd^2 FMAs a (b, h, step), and the cell
    update, 31 operations a row (its 6 transcendentals counted as one
    each). With `chunk` (mLSTM) also the bound of the work the chunkwise
    kernels do (`chunk_*`): the step form's plus, a chunk, q k^T and P v
    over its causal pairs (4 hd flops a pair), and the bytes of the chunk
    states written by one pass and read by the other."""
    b, s, h, hd = case
    n = b * s * h
    if kind == "mlstm_scan":
        nbytes = 4 * (4 * n * hd + 2 * n)               # q, k, v, y; i, f
        flops = n * (4 * hd * hd + 4 * hd)
    else:
        nbytes = 4 * (5 * n * hd + 4 * h * hd * hd + 4 * h * hd)
        flops = n * (8 * hd * hd + 31 * hd)
    t_bytes, t_ops = nbytes / mem_bps, flops / f32_fps
    out = {"bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_bound_ms": 1e3 * t_bytes, "gflop": flops / 1e9}
    if chunk:
        nch = -(-s // chunk)
        pairs = b * h * sum(L_ * (L_ + 1) // 2 for L_ in
                            [chunk] * (s // chunk) + [s % chunk] * (s % chunk > 0))
        c_flops = flops + 4 * hd * pairs
        c_bytes = nbytes + 2 * 4 * b * h * nch * (hd * hd + hd + 1)
        tb, to = c_bytes / mem_bps, c_flops / f32_fps
        out.update({"chunk_bound_ms": 1e3 * max(tb, to),
                    "chunk_bound_by": "bytes" if tb >= to else "operations",
                    "chunk_gflop": c_flops / 1e9,
                    "chunk_bytes_bound_ms": 1e3 * tb})
    return out


def mlstm_passes(args) -> dict:
    """The mLSTM's two kernels of one call on `args`, each alone through
    its C entry point, on one call's scratch (the closures keep it)."""
    cargs, y, kept = xls._mlstm_args(*args, xls.mlstm_chunk())
    lib = xls._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def run(entry):
        def fn():
            err = getattr(lib, entry)(ctypes.byref(cargs), stream)
            assert err == 0, lib.xlstm_scan_error_string(err).decode()
            return y, kept
        return fn
    return {"states": run("mlstm_scan_state_f32"),
            "outputs": run("mlstm_scan_out_f32")}


def mlstm_bwd_passes(args, y, dy, states) -> dict:
    """The mLSTM backward's four kernels of one call on `args`, each alone
    through its C entry point, on one call's operands and scratch (the
    closures keep them; each kernel reads what those before it left)."""
    cargs, grads, kept = xls._mlstm_bwd_args(*args, y, dy, states)
    lib = xls._bwd_lib()
    stream = torch.cuda.current_stream().cuda_stream

    def run(entry):
        def fn():
            err = getattr(lib, entry)(ctypes.byref(cargs), stream)
            assert err == 0, lib.xlstm_scan_bwd_error_string(err).decode()
            return grads, kept
        return fn
    return {entry[10:-4]: run(entry) for entry in xls.MLSTM_BWD_ENTRIES}


def check_xlstm(gen, mem_bps: float, f32_fps: float) -> dict:
    """Both xLSTM scans' kernels against their plain versions on the card,
    in f32, at every XLSTM_CASES shape (within XLSTM_TOL), two calls bit
    for bit. At the path shape: each kernel's and its plain f32 version's
    error against a float64 plain run (the kernel's at most
    XLSTM_F64_FACTOR times the plain version's); the times (through the
    wrapper by CUDA events, and behind a device sleep), us per step, the
    plain version's time (one call) and the bound (the mLSTM's also that
    of the chunkwise form's own work); the mLSTM's two kernels each alone
    behind the sleep, and its chunkwise mirror (several PyTorch calls).
    At the train shape the times again. Returns {kernel: the path's
    numbers}."""
    out = {}
    chunk = xls.mlstm_chunk()
    train = XLSTM_BWD_CASES["train"]
    for kind, wrapper, ref in (("mlstm_scan", xls.mlstm_scan, mlstm_scan_ref),
                               ("slstm_scan", xls.slstm_scan, slstm_scan_ref)):
        tol = XLSTM_TOL[kind]
        errs = {}
        for label, case in XLSTM_CASES.items():
            args = xlstm_inputs(kind, case, gen)
            with torch.no_grad():
                got, again = wrapper(*args), wrapper(*args)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                want = ref(*args)
                b.record()
                torch.cuda.synchronize()
            assert torch.equal(got, again), f"{kind} {label}: two calls differ"
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            errs[label] = (got - want).abs().max().item()
            print(f"[check] {kind} {label} {case}: max |kernel - plain| "
                  f"{errs[label]:.3e} (max |plain| "
                  f"{want.abs().max().item():.4f}; holds |diff| <= {tol} * "
                  f"(1 + |plain|)); two calls bit for bit")
            if label != "path":
                del args, got, again, want
                continue
            t = {"max_abs_err": errs[label], "plain_ms": a.elapsed_time(b),
                 "library_ms": None,
                 **xlstm_bound(kind, case, mem_bps, f32_fps,
                               chunk if kind == "mlstm_scan" else 0)}
            # the float64 walk over the first XLSTM_F64_SEQ steps: a scan's
            # first steps do not depend on later ones, so the kernel's and
            # the plain f32 run's prefixes are held against it
            p64 = XLSTM_F64_SEQ
            head = (tuple(x[:, :p64] for x in args) if kind == "mlstm_scan"
                    else (args[0][:, :p64],) + args[1:])
            with torch.no_grad():
                w64 = ref(*(x.double() for x in head))
            t["err_vs_f64"] = (got[:, :p64].double() - w64).abs().max().item()
            t["plain_err_vs_f64"] = (want[:, :p64].double()
                                     - w64).abs().max().item()
            del w64, head
            print(f"[check] {kind} path: against a float64 plain run of the "
                  f"first {p64} steps, kernel {t['err_vs_f64']:.3e}, plain "
                  f"f32 {t['plain_err_vs_f64']:.3e} (holds kernel <= "
                  f"{XLSTM_F64_FACTOR} x plain)")
            assert t["err_vs_f64"] <= XLSTM_F64_FACTOR * t["plain_err_vs_f64"], \
                (kind, t["err_vs_f64"], t["plain_err_vs_f64"])
            with torch.no_grad():
                t["ms"] = time_ms(lambda: wrapper(*args), reps=5, warmup=1)
                t["device_ms"] = time_ms(lambda: wrapper(*args), reps=5,
                                         warmup=1, backlog=True)
                if kind == "mlstm_scan":
                    for name, fn in mlstm_passes(args).items():
                        t[f"{name}_device_ms"] = time_ms(fn, reps=5, warmup=1,
                                                         backlog=True)
                    t["mirror_ms"] = time_ms(
                        lambda: mlstm_scan_chunkwise_ref(*args, chunk), reps=1,
                        warmup=0)
            t["us_per_step"] = 1e3 * t["ms"] / case[1]
            print(f"[time] {kind} path {case} f32: kernel {t['ms']:.4f} ms "
                  f"({t['us_per_step']:.4f} us a step; behind a device sleep "
                  f"{t['device_ms']:.4f}), plain {t['plain_ms']:.1f} ms (one "
                  f"call), bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
                  f"{t['gflop']:.1f} GFLOP, bytes {t['bytes_bound_ms']:.4f}); "
                  f"kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of the "
                  f"bound; no PyTorch call computes it"
                  + (f"; chunks of {chunk}: states kernel "
                     f"{t['states_device_ms']:.4f} ms, outputs kernel "
                     f"{t['outputs_device_ms']:.4f} ms (each alone behind a "
                     f"sleep); the chunkwise form's own bound "
                     f"{t['chunk_bound_ms']:.4f} ms ({t['chunk_bound_by']}; "
                     f"{t['chunk_gflop']:.1f} GFLOP, bytes with the chunk "
                     f"states {t['chunk_bytes_bound_ms']:.4f}); its plain "
                     f"mirror (several PyTorch calls, "
                     f"ref.mlstm_scan_chunkwise_ref) {t['mirror_ms']:.2f} ms"
                     if kind == "mlstm_scan" else ""))
            out[kind] = t
            del args, got, again, want
            torch.cuda.empty_cache()
        out[kind]["max_abs_err_by_case"] = errs
        args = xlstm_inputs(kind, train, gen)
        t = out[kind]
        with torch.no_grad():
            t["train_ms"] = time_ms(lambda: wrapper(*args))
            t["train_device_ms"] = time_ms(lambda: wrapper(*args),
                                           backlog=True)
        t["train_bound"] = xlstm_bound(kind, train, mem_bps, f32_fps,
                                       chunk if kind == "mlstm_scan" else 0)
        print(f"[time] {kind} train {train} f32: kernel {t['train_ms']:.4f} "
              f"ms ({1e3 * t['train_ms'] / train[1]:.4f} us a step; behind "
              f"a device sleep {t['train_device_ms']:.4f}), bound "
              f"{t['train_bound']['bound_ms']:.4f} ms")
        del args
    return out


def xlstm_bwd_bound(kind: str, case, mem_bps: float, f32_fps: float,
                    chunk: int = 0) -> dict:
    """Least ms for one backward at (B, S, H, hd), as `xlstm_bound`. mLSTM:
    reads q, k, v, y, dy, i, f, writes dq, dk, dv, di, df; the step form's
    work, 10 hd^2 + 10 hd flops a (b, s, h) (2 FMAs an entry of C a step
    forward, 3 in reverse, the n chains and the sums). With `chunk` also
    the bound of the work the chunkwise kernels do (`chunk_*`): a chunk 4
    L hd^2 FMAs (the reverse walk, C^T dnum, dC^T v, dC k) and 5 causal
    products of L (L + 1) / 2 pairs by hd (dy v^T, q k^T, A k, A^T q, P^T
    dnum); its bytes add den' read, the chunk states read, and the state
    gradients written and read. Both forms compute the function, so
    `bound_ms` (and `bound_by`, `gflop`, `bytes_bound_ms`) is the smaller
    of the two; `step_*` keeps the step form's and `chunk_*` the chunkwise
    form's. sLSTM (the kernel): reads the p trail, c, n, m, dy and W,
    writes dpre; the transposed products, 4 hd^2 FMAs a (b, h, step), and
    the cell's backward, about 60 operations a row (its transcendentals
    counted as one each)."""
    b, s, h, hd = case
    n = b * s * h
    if kind == "mlstm_scan_bwd":
        nbytes = 4 * (8 * n * hd + 4 * n)
        flops = n * (10 * hd * hd + 10 * hd)
    else:
        nbytes = 4 * (12 * n * hd + 4 * h * hd * hd)
        flops = n * (8 * hd * hd + 60 * hd)
    t_bytes, t_ops = nbytes / mem_bps, flops / f32_fps
    out = {"bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_bound_ms": 1e3 * t_bytes, "gflop": flops / 1e9}
    if chunk:
        nch = -(-s // chunk)
        lens = [chunk] * (s // chunk) + [s % chunk] * (s % chunk > 0)
        pairs = sum(L_ * (L_ + 1) // 2 for L_ in lens)
        c_flops = 2 * b * h * (4 * nch * chunk * hd * hd + 5 * pairs * hd)
        c_bytes = nbytes + 4 * n + 4 * b * h * nch * (
            (hd * hd + hd + 1) + 2 * (hd * hd + hd))
        tb, to = c_bytes / mem_bps, c_flops / f32_fps
        out.update({"chunk_bound_ms": 1e3 * max(tb, to),
                    "chunk_bound_by": "bytes" if tb >= to else "operations",
                    "chunk_gflop": c_flops / 1e9,
                    "chunk_bytes_bound_ms": 1e3 * tb})
        out.update({f"step_{k_}": out[k_] for k_ in (
            "bound_ms", "bound_by", "gflop", "bytes_bound_ms")})
        if out["chunk_bound_ms"] < out["bound_ms"]:
            out.update({k_: out[f"chunk_{k_}"] for k_ in (
                "bound_ms", "bound_by", "gflop", "bytes_bound_ms")})
    return out


def mlstm_branches(q, k, v, i, f) -> tuple[torch.Tensor, ...]:
    """Which side of each branch point the mLSTM's forward takes at each
    step, walked in plain ops in the inputs' dtype: |n . q| > 1 (the clamp
    passes its gradient), log_sigmoid(f) + m > i (the max takes the forget
    arm) and log_sigmoid(f) + m == i (a tie, whose gradient autograd
    splits half to each arm), bool [B,S,H] each."""
    lf = torch.nn.functional.logsigmoid(f)
    m = torch.zeros_like(i[:, 0])
    n = torch.zeros_like(q[:, 0])
    past, arm, tie = [], [], []
    for t in range(q.shape[1]):
        mf = lf[:, t] + m
        arm.append(mf > i[:, t])
        tie.append(mf == i[:, t])
        m = torch.maximum(mf, i[:, t])
        n = torch.exp(mf - m)[..., None] * n + \
            torch.exp(i[:, t] - m)[..., None] * k[:, t]
        past.append((n * q[:, t]).sum(-1).abs() > 1)
    return torch.stack(past, 1), torch.stack(arm, 1), torch.stack(tie, 1)


def grads_rel_errs(got, want) -> list:
    """max |got - want| / max |want| of each gradient."""
    return [((g.double() - w.double()).abs().max()
             / w.double().abs().max().clamp_min(1e-30)).item()
            for g, w in zip(got, want)]


def grads_rel_err(got, want) -> float:
    """The largest of `grads_rel_errs`."""
    return max(grads_rel_errs(got, want))


def check_xlstm_bwd(gen, mem_bps: float, f32_fps: float) -> dict:
    """Both xLSTM backwards on the card against their plain versions, in
    f32, at every XLSTM_BWD_CASES shape with a dy of seeded noise (within
    XLSTM_BWD_TOL of each gradient's largest magnitude), two calls bit for
    bit: the mLSTM's four kernels, on the chunk states and den' that its
    keeping forward left (that forward's y bit for bit the inference
    kernels'), against their plain mirror `mlstm_scan_bwd_chunkwise_ref`
    and the step form `mlstm_scan_bwd_ref`; the sLSTM's kernel after the
    trail-keeping forward (held against `slstm_scan_trails_ref`, its y bit
    for bit the inference kernel's), its dpre against its mirror
    `slstm_scan_dpre_affine_ref` and, with the weight products, against
    `slstm_scan_bwd_ref`; the shares of steps past each clamp and on each
    arm of the max; at the long S=4,096 (B=1) each kernel's and the
    plain f32 versions' error against a float64 plain backward (the
    kernel's at most XLSTM_F64_FACTOR times the step form's); through the
    autograd Functions against autograd of the plain scans at the small
    shapes; at the train shape the times (the mLSTM's four kernels through
    the wrapper and each alone behind a device sleep; the sLSTM's kernel
    alone and with the weight products; CUDA events, and behind a device
    sleep), us a step, the plain versions' one call each and the bounds
    (the mLSTM's also its chunkwise work's). Returns {kernel: the train
    shape's numbers}."""
    out = {}
    chunk = xls.mlstm_chunk()
    for kind in ("mlstm_scan_bwd", "slstm_scan_bwd"):
        fwd = kind[:-4]
        errs = {}
        for label, case in XLSTM_BWD_CASES.items():
            args = xlstm_inputs(fwd, case, gen)
            dy = torch.randn(case, generator=gen, device="cuda")
            with torch.no_grad():
                if kind == "mlstm_scan_bwd":
                    y, states = xls._mlstm_fwd(*args, keep=True)
                    assert torch.equal(y, xls.mlstm_scan(*args))
                    kernel = lambda: xls.mlstm_scan_bwd(  # noqa: E731
                        *args, y, dy, states)
                    plain = lambda: mlstm_scan_bwd_ref(*args, y, dy)  # noqa: E731,E501
                    mirror = lambda: mlstm_scan_bwd_chunkwise_ref(  # noqa: E731
                        *args, y, dy, chunk)
                    past_t, arm_t, tie_t = mlstm_branches(*args)
                    past = past_t.double().mean().item()
                    arm = arm_t.double().mean().item()
                    clamp = (f"|n . q| > 1 at {past:.4f} of steps; the "
                             f"keeping forward's y bit for bit the "
                             f"inference kernels'")
                else:
                    trails = xls._slstm_fwd(*args, trails=True)
                    want_tr = slstm_scan_trails_ref(*args)
                    assert torch.equal(trails[0], xls.slstm_scan(*args))
                    for got_t, want_t in zip(trails, want_tr):
                        torch.testing.assert_close(
                            got_t, want_t, rtol=XLSTM_TOL[fwd],
                            atol=XLSTM_TOL[fwd])
                    kernel = lambda: xls.slstm_scan_bwd(  # noqa: E731
                        args[1], dy, trails)
                    plain = lambda: slstm_scan_bwd_ref(  # noqa: E731
                        *args, dy, trails)
                    mirror = lambda: (slstm_scan_dpre_affine_ref(  # noqa: E731
                        args[1], dy, trails[1:]),)
                    n_tr, p_tr, m_tr = trails[3], trails[1], trails[4]
                    m_prev = torch.cat([torch.zeros_like(m_tr[:, :1]),
                                        m_tr[:, :-1]], 1)
                    past = (n_tr > 1).double().mean().item()
                    arm = (torch.nn.functional.logsigmoid(p_tr[:, :, 1])
                           + m_prev > p_tr[:, :, 0]).double().mean().item()
                    clamp = (f"n > 1 at {past:.4f} of steps (n == 1 at "
                             f"{(n_tr == 1).double().mean().item():.4f}); "
                             f"trails within {XLSTM_TOL[fwd]} of "
                             f"slstm_scan_trails_ref, y bit for bit the "
                             f"inference kernel's")
                got, again = kernel(), kernel()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                want = plain()
                b.record()
                mir = mirror()
                torch.cuda.synchronize()
            assert all(torch.equal(g, h) for g, h in zip(got, again)), \
                f"{kind} {label}: two calls differ"
            errs[label] = grads_rel_err(got, want)
            err_m = grads_rel_err(got[:len(mir)], mir)
            assert errs[label] <= XLSTM_BWD_TOL, (kind, label, errs[label])
            assert err_m <= XLSTM_BWD_TOL, (kind, label, err_m)
            print(f"[check] {kind} {label} {case}: max |kernel - plain| / "
                  f"max |plain| over the gradients {errs[label]:.3e}, "
                  f"against its plain mirror {err_m:.3e} "
                  f"(tol {XLSTM_BWD_TOL}); two calls bit for bit; {clamp}; "
                  f"forget arm of the max at {arm:.4f}")
            if label in ("path", "train"):   # against float64
                with torch.no_grad():
                    a64 = [x.double() for x in args]
                    if kind == "mlstm_scan_bwd":
                        w64 = mlstm_scan_bwd_ref(*a64, mlstm_scan_ref(*a64),
                                                 dy.double())
                        # steps where f32 and float64 take different sides
                        # of a branch point, where the gradient jumps
                        past64, arm64, tie64 = mlstm_branches(*a64)
                        flips = (f"; the f32 and float64 forwards part at "
                                 f"{int((past64 != past_t).sum())} clamp "
                                 f"and {int((arm64 != arm_t).sum())} max "
                                 f"steps of {past_t.numel()}, and the max "
                                 f"ties at {int(tie_t.sum())} steps in f32 "
                                 f"(at {tie_t.nonzero().tolist()[:4]}), "
                                 f"{int(tie64.sum())} in float64")
                    else:
                        w64 = slstm_scan_bwd_ref(*a64, dy.double())
                        flips = ""
                e_k, e_p = grads_rel_errs(got, w64), grads_rel_errs(want, w64)
                e_m = grads_rel_errs(mir, w64[:len(mir)])
                print(f"[check] {kind} {label} S={case[1]}: against a float64 "
                      f"plain backward, kernel {max(e_k):.3e}, plain f32 "
                      f"{max(e_p):.3e}, its mirror in f32 {max(e_m):.3e} "
                      f"(max |diff| / max |f64|; by gradient kernel "
                      f"{[f'{e:.2e}' for e in e_k]}, plain "
                      f"{[f'{e:.2e}' for e in e_p]}, mirror "
                      f"{[f'{e:.2e}' for e in e_m]}){flips}"
                      + (f"; at most {XLSTM_F64_FACTOR} x the plain"
                         if label == "path" else ""))
                if label == "path":
                    assert max(e_k) <= XLSTM_F64_FACTOR * max(e_p), (e_k, e_p)
                key = "" if label == "path" else "train_"
                out.setdefault(kind, {}).update({
                    f"{key}err_vs_f64": max(e_k),
                    f"{key}plain_err_vs_f64": max(e_p),
                    f"{key}mirror_err_vs_f64": max(e_m),
                    f"{key}err_vs_f64_by_grad": e_k,
                    f"{key}plain_err_vs_f64_by_grad": e_p})
                del a64, w64
            if label == "train":
                t = {"max_abs_err": max((g - w).abs().max().item()
                                        for g, w in zip(got, want)),
                     "mirror_max_rel_err": err_m,
                     "plain_ms": a.elapsed_time(b), "library_ms": None,
                     **xlstm_bwd_bound(kind, case, mem_bps, f32_fps,
                                       chunk if kind == "mlstm_scan_bwd"
                                       else 0)}
                with torch.no_grad():
                    if kind == "slstm_scan_bwd":
                        alone = lambda: xls._slstm_bwd(  # noqa: E731
                            args[1], dy, trails[1:])
                        t["with_weight_products_ms"] = time_ms(kernel, reps=5,
                                                               warmup=1)
                    else:
                        alone = kernel
                        for name, fn in mlstm_bwd_passes(args, y, dy,
                                                         states).items():
                            t[f"{name}_device_ms"] = time_ms(
                                fn, reps=5, warmup=1, backlog=True)
                    t["ms"] = time_ms(alone, reps=5, warmup=1)
                    t["device_ms"] = time_ms(alone, reps=5, warmup=1,
                                             backlog=True)
                    t["mirror_ms"] = time_ms(mirror, reps=1, warmup=0)
                t["us_per_step"] = 1e3 * t["ms"] / case[1]
                print(f"[time] {kind} train {case} f32: kernel"
                      f"{'s' if kind == 'mlstm_scan_bwd' else ''} "
                      f"{t['ms']:.4f} ms ({t['us_per_step']:.4f} us a step; "
                      f"behind a device sleep {t['device_ms']:.4f}"
                      + (f"; with the weight products "
                         f"{t['with_weight_products_ms']:.4f}"
                         if kind == "slstm_scan_bwd" else
                         "; alone behind a sleep " + ", ".join(
                             f"{k_} {t[k_ + '_device_ms']:.4f}"
                             for k_ in ("prep", "state", "chunk", "gate")))
                      + f"), plain {t['plain_ms']:.1f} ms (one call), its "
                      f"mirror {t['mirror_ms']:.1f} ms, bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_by']}; "
                      f"{t['gflop']:.1f} GFLOP, bytes "
                      f"{t['bytes_bound_ms']:.4f}); kernel at "
                      f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound"
                      + (f" (the smaller of: the step form's "
                         f"{t['step_bound_ms']:.4f} ms ({t['step_bound_by']}; "
                         f"{t['step_gflop']:.1f} GFLOP, bytes "
                         f"{t['step_bytes_bound_ms']:.4f}), kernels at "
                         f"{100 * t['step_bound_ms'] / t['ms']:.1f}% of it; "
                         f"the chunkwise form's own "
                         f"{t['chunk_bound_ms']:.4f} ms "
                         f"({t['chunk_bound_by']}; {t['chunk_gflop']:.1f} "
                         f"GFLOP, bytes {t['chunk_bytes_bound_ms']:.4f}), "
                         f"kernels at "
                         f"{100 * t['chunk_bound_ms'] / t['ms']:.1f}% of it)"
                         if kind == "mlstm_scan_bwd" else "")
                      + "; no PyTorch call computes it")
                out.setdefault(kind, {}).update(t)
            del args, dy, got, again, want, mir
            torch.cuda.empty_cache()
        out[kind]["max_rel_err_by_case"] = errs
        # through the autograd Function against autograd of the plain scan
        wrapper, ref = ((xls.mlstm_scan, mlstm_scan_ref)
                        if kind == "mlstm_scan_bwd"
                        else (xls.slstm_scan, slstm_scan_ref))
        node = ("_MlstmScanBackward" if kind == "mlstm_scan_bwd"
                else "_SlstmScanBackward")
        for label in ("tiny hd=16", "S=1", "hd=256 B=5"):
            case = XLSTM_CASES[label]
            args = xlstm_inputs(fwd, case, gen)
            dy = torch.randn(case, generator=gen, device="cuda")
            leaves = [x.clone().requires_grad_() for x in args]
            y = wrapper(*leaves)
            assert type(y.grad_fn).__name__ == node, type(y.grad_fn)
            got = torch.autograd.grad(y, leaves, dy)
            leaves = [x.clone().requires_grad_() for x in args]
            want = torch.autograd.grad(ref(*leaves), leaves, dy)
            err = grads_rel_err(got, want)
            assert err <= XLSTM_BWD_TOL, (kind, label, err)
            print(f"[check] {fwd} {label} {case} under autograd: grad_fn "
                  f"{node}; gradients vs autograd of {ref.__name__} "
                  f"{err:.3e} (max |diff| / max |plain|, tol "
                  f"{XLSTM_BWD_TOL})")
    return out


def xlstm_prefill_and_serve() -> dict:
    """Slice 12's main path: full-width xlstm-125m (12 layers: 9 mLSTM, 3
    sLSTM), prefill at XLSTM_BATCH x XLSTM_SEQ and serving on the same
    weights."""
    cfg = get_config(XLSTM)
    return prefill_and_serve(cfg, XLSTM_SEQ, only(mlstm_scan=9, slstm_scan=3),
                             bsz=XLSTM_BATCH)


XLSTM_KERNELS = ("mlstm_scan_state_kernel", "mlstm_scan_out_kernel",
                 "mlstm_bwd_prep_kernel", "mlstm_bwd_state_kernel",
                 "mlstm_bwd_chunk_kernel", "mlstm_bwd_gate_kernel",
                 "slstm_scan_kernel", "slstm_scan_bwd_kernel")


def xlstm_train_path() -> dict:
    """Slice 13's main path: full-width xlstm-125m (12 layers: 9 mLSTM, 3
    sLSTM), XLSTM_TRAIN_BATCH x XLSTM_TRAIN_SEQ, through `train_cell`: a
    step runs each mLSTM layer's scan and its three backward kernels, each
    sLSTM layer's trail-keeping scan and its backward, and no other kernel
    of the port but the optimizer's two (OPTIMIZER_STEP)."""
    cfg = get_config(XLSTM)
    return train_cell("xlstm-train", cfg, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ,
                      train_only(**OPTIMIZER_STEP, mlstm_scan=9,
                                 mlstm_scan_bwd_prep=9,
                                 mlstm_scan_bwd_state=9, mlstm_scan_bwd=9,
                                 mlstm_scan_bwd_gate=9,
                                 slstm_scan=3, slstm_scan_trails=3,
                                 slstm_scan_bwd=3), XLSTM_KERNELS)


def xlstm_tiny_checks() -> dict:
    """Tiny f32 xlstm on the card: decode step by step equals the forward
    (which runs both scan kernels at hd 16) within 1e-4, and the engine
    (two slots, four requests: a slot's states are zeroed and reused)
    equals greedy decode. Returns the forward's launches."""
    cfg = tiny_config(XLSTM).scaled(dtype="float32")
    toks = torch.randint(0, 500, (2, 12), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
    model, params, err, counts = tiny_decode_check(cfg, toks)
    print(f"[check] tiny {XLSTM} (f32, cuda): decode step by step vs "
          f"forward max |diff| {err:.3e} (tol 1e-4); the forward launched "
          f"{counts}")
    prompts = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 8, 1, 6]]
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, num_clients=1)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=5)) for p in prompts]
    zero_counts()
    eng.run_until_drained()
    assert read_counts() == only(), read_counts()
    for p, r in zip(prompts, reqs):
        want = greedy_decode(model, params,
                             torch.tensor([p], device="cuda"), 5, 32)
        assert r.output == want[0].tolist(), (p, r.output, want)
    print(f"[check] tiny {XLSTM} engine == greedy decode for "
          f"{len(prompts)} requests through 2 slots (f32, cuda); the engine "
          f"launched no scan kernel")
    del model, params, eng
    return counts


# (name, wrapper, counter) of every kernel a train step can launch
TRAIN_COUNTERS = (("moe_gemm", moe_gemm, "launches"),
                  ("moe_gemm_bwd_dx", moe_gemm_bwd_dx, "launches"),
                  ("moe_gemm_bwd_dw", moe_gemm_bwd_dw, "launches"),
                  ("flash_attention", fa.flash_attention, "launches"),
                  ("flash_attention_bwd", fa.flash_attention_bwd, "launches"),
                  ("selective_scan", selective_scan, "launches"),
                  ("selective_scan_bwd", selective_scan_bwd, "launches"),
                  ("selective_scan_bwd_reduce", selective_scan_bwd,
                   "reduce_launches"),
                  ("mlstm_scan", xls.mlstm_scan, "launches"),
                  ("mlstm_scan_bwd_prep", xls.mlstm_scan_bwd,
                   "prep_launches"),
                  ("mlstm_scan_bwd_state", xls.mlstm_scan_bwd,
                   "state_launches"),
                  ("mlstm_scan_bwd", xls.mlstm_scan_bwd, "launches"),
                  ("mlstm_scan_bwd_gate", xls.mlstm_scan_bwd,
                   "gate_launches"),
                  ("slstm_scan", xls.slstm_scan, "launches"),
                  ("slstm_scan_trails", xls.slstm_scan, "trail_launches"),
                  ("slstm_scan_bwd", xls.slstm_scan_bwd, "launches"),
                  ("adamw_norm", fused_adamw.norm, "launches"),
                  ("adamw_update", fused_adamw.update, "launches"))

# the fused clip and AdamW's launches a train step: one of each (up to
# fused_adamw.MAX_LEAVES leaves)
OPTIMIZER_STEP = {"adamw_norm": 1, "adamw_update": 1}


def train_only(**nonzero) -> dict:
    """A `read_train_counts` dict: these counts, every other 0."""
    return {key: nonzero.get(key, 0) for key, _, _ in TRAIN_COUNTERS}


def zero_train_counts() -> None:
    for _, fn, attr in TRAIN_COUNTERS:
        setattr(fn, attr, 0)
    fa.flash_attention.by_shape.clear()
    fa.flash_attention_bwd.by_shape.clear()


def read_train_counts() -> dict:
    return {key: getattr(fn, attr) for key, fn, attr in TRAIN_COUNTERS}


def read_flash_shapes() -> dict:
    """The flash wrappers' launches by call shape, forward and backward."""
    return {"forward": dict(fa.flash_attention.by_shape),
            "backward": dict(fa.flash_attention_bwd.by_shape)}


def train_step_counts(cfg) -> dict:
    """Kernel launches of one train step of `cfg`: three grouped GEMMs a
    MoE layer, each with its dx and dw; the flash forward and its
    backward kernels (`fa.BWD_LAUNCHES` of the config's dtype: two in bf16,
    three in f32) a self-attention layer (`forward_counts`); the
    selective scan, its backward and the backward's second pass a Mamba
    layer; the mLSTM scan and its four backward kernels an mLSTM layer;
    the trail-keeping sLSTM scan and its backward an sLSTM layer; the
    fused clip and AdamW's two kernels (OPTIMIZER_STEP)."""
    fwd = forward_counts(cfg)
    moe, attn = fwd["moe_gemm"], fwd["flash_attention"]
    mamba, mlstm, slstm = (fwd["selective_scan"], fwd["mlstm_scan"],
                           fwd["slstm_scan"])
    return {"moe_gemm": moe, "moe_gemm_bwd_dx": moe, "moe_gemm_bwd_dw": moe,
            "flash_attention": attn,
            "flash_attention_bwd": fa.BWD_LAUNCHES[cfg.torch_dtype] * attn,
            "selective_scan": mamba, "selective_scan_bwd": mamba,
            "selective_scan_bwd_reduce": mamba, "mlstm_scan": mlstm,
            "mlstm_scan_bwd_prep": mlstm, "mlstm_scan_bwd_state": mlstm,
            "mlstm_scan_bwd": mlstm, "mlstm_scan_bwd_gate": mlstm,
            "slstm_scan": slstm,
            "slstm_scan_trails": slstm, "slstm_scan_bwd": slstm,
            **OPTIMIZER_STEP}


def train_cell(name: str, cfg, batch: int, seq: int, per_step: dict,
               kernels: tuple) -> dict:
    """`make_train_step` on `cfg`, random bf16 weights from a seeded
    generator, f32 AdamW, `SyntheticLM` batches of batch x seq,
    TRAIN_STEPS steps with the launch counts set to 0 just before and read
    just after (`per_step` a step) and the optimizer's leaf counters
    (every leaf fused each step, none plain); then a torch.profiler
    window over two
    more steps, with the device time of each of `kernels` (name
    substrings) a step."""
    assert train_step_counts(cfg) == per_step, train_step_counts(cfg)
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, "cuda")
    params = model.init_params(torch.Generator("cuda").manual_seed(0))
    opt = init_opt_state(params)
    n_params = sum(p.numel() for p in params.parameters())
    step_fn = make_train_step(model, TrainConfig(opt=OptConfig(
        peak_lr=1e-3, warmup_steps=20, total_steps=100)))
    ds = SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq))
    losses, gnorms, walls = [], [], []
    zero_train_counts()
    for i in range(TRAIN_STEPS):
        batch_dev = {k: torch.from_numpy(v).cuda()
                     for k, v in ds.batch_at(i).items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch_dev)
        losses.append(float(metrics["loss"]))     # the step's sync
        walls.append(time.perf_counter() - t0)
        gnorms.append(float(metrics["grad_norm"]))
    counts = read_train_counts()
    shapes = read_flash_shapes()
    peak = torch.cuda.max_memory_allocated()
    leaves = leaf_counts(step_fn.optimizer.fused_leaves.total,
                         step_fn.optimizer.plain_leaves.total,
                         len(list(params.parameters())), TRAIN_STEPS)
    tokens = batch * seq
    wall = statistics.median(walls[1:])
    print(f"[{name}] {cfg.name} full width, {cfg.num_layers} layers "
          f"({'/'.join(f'{b.mixer}+{b.ffn}' for b in cfg.pattern)} x "
          f"{cfg.repeats}), {n_params / 1e9:.3f} B parameters "
          f"(ModelConfig.param_count {cfg.param_count():,}), bf16, f32 "
          f"AdamW, B={batch} S={seq}: losses "
          f"{[round(x_, 4) for x_ in losses]}; grad norms "
          f"{[round(x_, 4) for x_ in gnorms]}")
    print(f"[{name}] wall per step (host, ends in the loss's sync) "
          f"{[round(1e3 * t, 1) for t in walls]} ms; steps 2.. median "
          f"{1e3 * wall:.1f} ms, {tokens / wall:.0f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches over {TRAIN_STEPS} steps "
          f"{counts} ({per_step} a step); optimizer leaves {leaves}")
    assert all(math.isfinite(x_) for x_ in losses + gnorms), (losses, gnorms)
    assert counts == {k: v * TRAIN_STEPS for k, v in per_step.items()}, \
        counts

    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in ds.batch_at(TRAIN_STEPS + i).items()}
               for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            params, opt, metrics = step_fn(params, opt, b)
        float(metrics["loss"])
        torch.cuda.synchronize()
    rows = kernel_rows(prof, len(batches))
    busy = sum(r[0] for r in rows)
    kernel_ms = {kn: sum(r[0] for r in rows if kn in r[2]) for kn in kernels}
    print(f"[profile] full-width {cfg.name} train step ({cfg.num_layers} "
          f"layers), B={batch} S={seq}: wall {1e3 * wall:.3f} ms/step (no "
          f"profiler); device busy {busy:.3f} ms/step in "
          f"{sum(r[1] for r in rows):.0f} kernels; idle share "
          f"{1 - busy / (1e3 * wall):.3f}; ms/step " + ", ".join(
              f"{kn} {ms:.3f}" for kn, ms in kernel_ms.items()))
    if not rows:
        print("[profile] device time not measured: the profiler saw no "
              "CUDA kernels")
    print_groups(rows, "ms/step (launches/step)")
    for ms, count, key in rows[:14]:
        print(f"[profile]   {ms:8.4f} ms/step {count:6.1f}x  {key[:90]}")
    del model, params, opt, step_fn, batches, metrics, prof
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "shapes": shapes, "wall_ms": 1e3 * wall,
            "busy_ms": busy, "peak_gib": peak / 2**30,
            "kernel_ms": kernel_ms, "leaves": leaves}


MOE_KERNELS = ("moe_gemm_wgmma_kernel", "moe_gemm_dx_wgmma_kernel",
               "moe_gemm_dw_wgmma_kernel")


def moe_train_path() -> dict:
    """Slice 7's main path: full-width qwen2-moe-a2.7b cut to
    MOE_TRAIN_REPEATS of its 24 layers, TRAIN_BATCH x TRAIN_SEQ, through
    `train_cell`."""
    cfg = get_config(ARCH).scaled(repeats=MOE_TRAIN_REPEATS)
    return train_cell("moe-train", cfg, TRAIN_BATCH, TRAIN_SEQ, train_only(
        **OPTIMIZER_STEP, moe_gemm=12, moe_gemm_bwd_dx=12, moe_gemm_bwd_dw=12,
        flash_attention=4, flash_attention_bwd=8), MOE_KERNELS)


def jamba_train_path() -> dict:
    """Slice 8's main path: full-width Jamba cut to layers 0-1 of its
    period (Mamba + MLP, Mamba + 16-expert top-2 MoE), JAMBA_TRAIN_BATCH
    x JAMBA_TRAIN_SEQ, through `train_cell`: a step runs two selective
    scans with their backwards and one MoE layer (3 grouped GEMMs with dx
    and dw), and no attention."""
    full = get_config(JAMBA)
    cfg = full.scaled(pattern=full.pattern[:JAMBA_TRAIN_LAYERS], repeats=1)
    assert cfg.param_count() == JAMBA_TRAIN_PARAMS, cfg.param_count()
    return train_cell("jamba-train", cfg, JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ,
                      train_only(**OPTIMIZER_STEP, moe_gemm=3,
                                 moe_gemm_bwd_dx=3,
                                 moe_gemm_bwd_dw=3, selective_scan=2,
                                 selective_scan_bwd=2,
                                 selective_scan_bwd_reduce=2),
                      ("sel_scan_kernel", "sel_scan_bwd_kernel",
                       "sel_scan_bwd_reduce_kernel") + MOE_KERNELS)


# the flash kernels a train step of each dtype launches, one each an
# attention layer
FLASH_KERNELS = {torch.bfloat16: ("flash_fwd_mma_kernel",
                                  "flash_bwd_dq_mma_kernel",
                                  "flash_bwd_dkdv_mma_kernel"),
                 torch.float32: ("flash_fwd_f32_kernel",
                                 "flash_bwd_dq_f32_kernel",
                                 "flash_bwd_dkdv_f32_kernel",
                                 "flash_bwd_dkdv_sum_f32_kernel")}


def gemma2_train_path() -> dict:
    """Slice 11's train path: full-width gemma2-27b cut to one period (a
    local layer with the 4096-key window and a global one, both
    softcapped), B=1 x GEMMA2_TRAIN_SEQ, through `train_cell`: a step
    runs two flash forwards and their four backward kernels and the
    optimizer's two (OPTIMIZER_STEP), nothing else of the port's."""
    cfg = get_config(GEMMA2).scaled(repeats=1)
    assert cfg.param_count() == GEMMA2_TRAIN_PARAMS, cfg.param_count()
    assert GEMMA2_TRAIN_SEQ > cfg.sliding_window
    out = train_cell("gemma2-train", cfg, 1, GEMMA2_TRAIN_SEQ,
                     train_only(**OPTIMIZER_STEP, flash_attention=2,
                                flash_attention_bwd=4),
                     FLASH_KERNELS[torch.bfloat16])
    local, glob = mixer_layers(cfg)
    out["shapes"] = {which: shape_launches(out["shapes"][which], {
        "gemma2 train local": n * local * TRAIN_STEPS,
        "gemma2 train global": n * glob * TRAIN_STEPS})
        for which, n in (("forward", 1),
                         ("backward", fa.BWD_LAUNCHES[torch.bfloat16]))}
    print(f"[gemma2-train] flash launches by shape over {TRAIN_STEPS} "
          f"steps: {out['shapes']}")
    return out


def launcher_train_path(arch: str, batch: int, seq: int) -> dict:
    """`train()` on full-width `arch` (bf16, its host runtime
    `TaskRuntime(num_workers=2, mode="ddast")` running), TRAIN_STEPS
    steps of `batch` x `seq` (an encoder-decoder's over encoder_seq zero
    frames), with the launch
    counts set to 0 just before and read just after (`train_step_counts`
    a step) and the optimizer's leaf counters; step wall, tokens/s, peak memory, the final checkpoint; then
    `profile_train` over two steps."""
    cfg = get_config(arch)
    per_step = train_step_counts(cfg)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_train_counts()
        out = train(arch, tiny=False, steps=TRAIN_STEPS, batch=batch,
                    seq=seq, ckpt_dir=ckpt_dir, log_every=1, device="cuda")
        counts = read_train_counts()
        shapes = read_flash_shapes()
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    leaves = leaf_counts(out["fused_leaves"], out["plain_leaves"],
                         n_leaves(cfg), TRAIN_STEPS)
    wall = statistics.median(out["step_s"][1:])
    ck = out["last_ckpt"]
    layers = (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
              f"layers over {cfg.encoder_seq} zero frames"
              if cfg.is_encoder_decoder else f"{cfg.num_layers} layers")
    print(f"[train] {arch} full width, {layers}, "
          f"{cfg.param_count():,} parameters by ModelConfig.param_count, "
          f"bf16, B={batch} S={seq}: losses "
          f"{[round(x_, 4) for x_ in out['losses']]}; grad norms "
          f"{[round(x_, 4) for x_ in out['grad_norms']]}")
    print(f"[train] wall per step (host, ends in the loss's sync, "
          f"TaskRuntime(num_workers=2, mode='ddast') running) "
          f"{[round(1e3 * t, 1) for t in out['step_s']]} ms; steps 2.. "
          f"median {1e3 * wall:.1f} ms, {batch * seq / wall:.0f} tok/s; "
          f"peak memory {peak / 2**30:.2f} GiB; final checkpoint "
          f"{ck['bytes'] / 1e9:.3f} GB written in {ck['seconds']:.2f} s; "
          f"launches over {TRAIN_STEPS} steps {counts} ({per_step} a step); "
          f"optimizer leaves {leaves}")
    assert all(math.isfinite(x_) for x_ in out["losses"] + out["grad_norms"])
    assert len(out["losses"]) == TRAIN_STEPS
    assert counts == {k: v * TRAIN_STEPS for k, v in per_step.items()}, \
        counts
    del out
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_train(cfg, batch, seq)
    return {"counts": counts, "shapes": shapes, "wall_ms": 1e3 * wall,
            "peak_gib": peak / 2**30, "leaves": leaves,
            **{f"profile_{k}": v for k, v in prof.items()}}


def whisper_train_path() -> dict:
    """Slice 11's encoder-decoder path: `train()` on full-width
    whisper-base (`launcher_train_path`), with the flash launches split by
    shape: the encoder's non-causal layers over 1500 frames and the
    decoder's causal self-attention over WHISPER_SEQ tokens."""
    cfg = get_config(WHISPER)
    out = launcher_train_path(WHISPER, WHISPER_BATCH, WHISPER_SEQ)
    out["shapes"] = {which: shape_launches(out["shapes"][which], {
        "whisper encoder": n * cfg.encoder_layers * TRAIN_STEPS,
        "whisper decoder": n * cfg.num_layers * TRAIN_STEPS})
        for which, n in (("forward", 1),
                         ("backward", fa.BWD_LAUNCHES[torch.bfloat16]))}
    print(f"[train] {WHISPER} flash launches by shape over {TRAIN_STEPS} "
          f"steps: {out['shapes']}")
    return out


def whisper_decode() -> dict:
    """Full-width whisper-base decode, bf16: `fill_cross_cache` over
    seeded frames (x 0.1, as tests/test_archs.py draws them) for
    WHISPER_DECODE_BATCH streams (the encoder's 6 flash launches), then
    WHISPER_DECODE_STEPS greedy `decode_step`s (no flash launch), with
    the launch counts set to 0 just before each and read just after;
    ms per step; then the teacher-forced forward over the decoded tokens
    and max |decode - forward| in bf16."""
    cfg = get_config(WHISPER)
    b, n = WHISPER_DECODE_BATCH, WHISPER_DECODE_STEPS
    model = get_model(cfg, "cuda")
    with torch.no_grad():
        params = model.init_params(torch.Generator("cuda").manual_seed(0))
    params.requires_grad_(False)
    gen = torch.Generator("cuda").manual_seed(6)
    frames = (torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                          device="cuda") * 0.1).to(cfg.torch_dtype)
    tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                        device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(b, n)
        params.fill_cross_cache(cache, frames)      # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        cache = params.fill_cross_cache(cache, frames)
        torch.cuda.synchronize()
        fill_ms = 1e3 * (time.perf_counter() - t0)
        fill_counts = read_counts()
        toks, outs = [tok], []
        zero_counts()
        t0 = time.perf_counter()
        for t in range(n):
            lg, cache = model.decode_step(params, cache, toks[-1], t)
            outs.append(lg)
            toks.append(lg.argmax(dim=-1))
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n
        decode_counts = read_counts()
        ref, _ = model.forward(params, {"tokens": torch.stack(toks[:-1], 1),
                                        "frames": frames})
    dec = torch.stack(outs, 1)
    err = (dec.float() - ref.float()).abs().max().item()
    print(f"[whisper-decode] {WHISPER} full width, bf16, B={b}: "
          f"fill_cross_cache over {cfg.encoder_seq} frames {fill_ms:.3f} ms, "
          f"launches {fill_counts}; {n} greedy decode steps {step_ms:.3f} "
          f"ms/step ({b * 1e3 / step_ms:.1f} tok/s), launches "
          f"{decode_counts}; max |decode - forward| over the decoded "
          f"tokens {err:.4e} (bf16, max |logit| "
          f"{ref.float().abs().max().item():.4f})")
    assert fill_counts == only(flash_attention=cfg.encoder_layers), \
        fill_counts
    assert decode_counts == only(), decode_counts
    assert bool(torch.isfinite(dec).all()) and math.isfinite(err)
    del model, params, cache, dec, ref, outs
    gc.collect()
    torch.cuda.empty_cache()
    return {"fill_ms": fill_ms, "step_ms": step_ms, "max_abs_diff": err,
            "fill_counts": fill_counts}


def whisper_tiny_checks() -> dict:
    """Tiny whisper in f32 on the card: the forward (its encoder and
    decoder self-attention through the flash kernels, f32 route) equals
    decode step by step after `fill_cross_cache` within 1e-4. The decoder
    S (8) is not encoder_seq (24), so cross-attention stays on the plain
    op, as in JAX. Returns the forward's launches."""
    cfg = tiny_config(WHISPER).scaled(dtype="float32")
    s = 8
    assert s != cfg.encoder_seq
    gen = torch.Generator("cuda").manual_seed(3)
    toks = torch.randint(0, 500, (2, s), device="cuda", generator=gen)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda") * 0.1
    _, _, err, counts = tiny_decode_check(cfg, toks, frames)
    print(f"[check] tiny {WHISPER} (f32, cuda): decode after "
          f"fill_cross_cache vs forward max |diff| {err:.3e} (tol 1e-4); "
          f"the forward launched {counts}")
    return counts


def tiny_f32_train(arch: str) -> dict:
    """Tiny `arch` in f32 through `train()` on the card: the loss falls over
    24 steps, and a resume from the step-24 checkpoint to step 30 equals a
    straight run to step 30. Returns the launches of those 60 steps (the
    f32 routes'), which must be 60 steps' worth."""
    tiny_dir = tempfile.mkdtemp(prefix="chip_smoke_tiny_")
    try:
        run = dict(tiny=True, batch=4, seq=32, log_every=100,
                   schedule_steps=30, device="cuda", dtype="float32")
        d1, d2 = str(Path(tiny_dir) / "a"), str(Path(tiny_dir) / "b")
        zero_train_counts()
        first = train(arch, steps=24, ckpt_dir=d1, **run)
        resumed = train(arch, steps=30, ckpt_dir=d1, **run)
        straight = train(arch, steps=30, ckpt_dir=d2, **run)
        counts = read_train_counts()
    finally:
        shutil.rmtree(tiny_dir, ignore_errors=True)
    cfg = tiny_config(arch).scaled(dtype="float32")
    per_step = train_step_counts(cfg)
    assert counts == {k: 60 * v for k, v in per_step.items()}, counts
    leaves = leaf_counts(
        sum(r["fused_leaves"] for r in (first, resumed, straight)),
        sum(r["plain_leaves"] for r in (first, resumed, straight)),
        n_leaves(cfg), 60)
    assert first["final_loss"] < first["losses"][0], first["losses"]
    assert len(resumed["losses"]) == 6
    assert math.isclose(resumed["losses"][-1], straight["losses"][-1],
                        rel_tol=1e-4), (resumed["losses"], straight["losses"])
    print(f"[check] tiny {arch} f32 training on the card: loss "
          f"{first['losses'][0]:.4f} -> {first['final_loss']:.4f} over 24 "
          f"steps; step-30 loss resumed from step 24 "
          f"{resumed['losses'][-1]:.6f}, straight "
          f"{straight['losses'][-1]:.6f}; launches over the 60 steps "
          f"{counts}; optimizer leaves {leaves}")
    return counts


def n_leaves(cfg) -> int:
    """The parameters (leaves) of `cfg`'s model, counted on the meta
    device."""
    with torch.device("meta"):
        return len(list(get_model(cfg, "meta").init_params(None)
                        .parameters()))


def leaf_counts(fused_n: int, plain_n: int, leaves: int,
                steps: int) -> dict:
    """A training run's optimizer leaf counters (`ClipAndAdamW`), which
    must read every leaf of every step fused and none plain."""
    out = {"fused": fused_n, "plain": plain_n, "leaves": leaves,
           "steps": steps}
    assert (fused_n, plain_n) == (leaves * steps, 0), out
    return out


OPT_SLICE = 1 << 26     # elements of a leaf the plain loop takes at once


class _OneLeaf:
    """`adamw_update`'s view of one named parameter."""

    def __init__(self, name: str, p: torch.Tensor):
        self._item = (name, p)

    def named_parameters(self):
        return [self._item]


def bench_cell_params():
    """The benchmark's training cell's parameters on the card
    (`port_bench`: qwen2-moe-a2.7b cut to 4 layers, views of one buffer a
    dtype, f32 routers)."""
    from port_bench import harness
    from port_bench.arch import Arch
    from port_bench.weights import make_weights
    a = Arch.load("qwen2-moe-a2.7b")
    dev = torch.device("cuda")
    _, params = harness.load_program(a, make_weights(a, 2**31 + 11, dev),
                                     dev, train=True)
    return params


def model_params(cfg):
    with torch.no_grad():
        return get_model(cfg, "cuda").init_params(
            torch.Generator("cuda").manual_seed(0))


def optimizer_check(label: str, params, mem_bps: float) -> dict:
    """The fused clip and AdamW (`ClipAndAdamW` on the card) at one set of
    training leaves against the plain loop: seeded gradients in each
    parameter's dtype, drawn m and v (v >= 0), one clipped step; its
    launches and leaf counters, its norm within 1e-5 of `global_norm`,
    then each leaf's p, m and v bit-equal to `adamw_update` on copies
    kept on the host, given the fused norm's scale (OPT_SLICE elements
    at a time); then each kernel
    alone (CUDA events, in turns) against its bytes bound at `mem_bps`."""
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    named = list(params.named_parameters())
    gen = torch.Generator("cuda").manual_seed(7)

    def draw(p, dtype):
        return (torch.randn(p.shape, generator=gen, device="cuda")
                * 1e-3).to(dtype)
    with torch.no_grad():
        grads = {n: draw(p, p.dtype) for n, p in named}
        opt = {"m": {n: draw(p, torch.float32) for n, p in named},
               "v": {n: draw(p, torch.float32).square_() for n, p in named},
               "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    host = {n: (p.detach().cpu(), opt["m"][n].cpu(), opt["v"][n].cpu())
            for n, p in named}
    step = ClipAndAdamW(cfg)
    zero_train_counts()
    _, _, lr, gnorm = step(grads, opt, params)
    launches = read_train_counts()
    ref = float(global_norm(grads))
    norm_err = abs(float(gnorm) - ref) / ref
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    unequal = []
    with torch.no_grad():
        for n, p in named:
            # the plain loop is elementwise: run it on OPT_SLICE elements
            # of the leaf at a time, so that its f32 temporaries fit
            flat = [t.reshape(-1) for t in host.pop(n)]
            got = (p.detach().reshape(-1), grads[n].reshape(-1),
                   opt["m"][n].reshape(-1), opt["v"][n].reshape(-1))
            same = True
            for i in range(0, p.numel(), OPT_SLICE):
                pc, mc, vc = (t[i:i + OPT_SLICE].cuda() for t in flat)
                pf, g, mf, vf = (t[i:i + OPT_SLICE] for t in got)
                _, _, lr_b = adamw_update(
                    cfg, {n: g * scale.to(g.dtype)},
                    {"m": {n: mc}, "v": {n: vc},
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="cuda")},
                    _OneLeaf(n, pc))
                assert torch.equal(lr, lr_b), (n, lr, lr_b)
                same = same and (torch.equal(pc, pf) and torch.equal(mc, mf)
                                 and torch.equal(vc, vf))
            if not same:
                unequal.append(n)
            del flat, got
    leaves = [(p.detach(), grads[n], opt["m"][n], opt["v"][n])
              for n, p in named]
    plan = fused_adamw.make_plan(leaves, fused_adamw.grid_blocks(0))
    gs = [g for _, g, _, _ in leaves]
    out = fused_adamw.norm(plan, gs, cfg.clip_norm)
    lr_t, bc1, bc2 = (torch.tensor(x, device="cuda")
                      for x in (1e-6, 0.1, 0.05))
    ms = time_turns({
        "norm": lambda: fused_adamw.norm(plan, gs, cfg.clip_norm),
        "update": lambda: fused_adamw.update(
            plan, gs, out, lr_t, bc1, bc2, cfg.b1, cfg.b2, cfg.eps,
            cfg.weight_decay)}, reps=10)
    elements = sum(p.numel() for _, p in named)
    nbytes = {"norm": sum(g.numel() * g.element_size() for g in gs),
              "update": sum(p.numel() * (2 * p.element_size()
                                         + g.element_size() + 16)
                            for p, g, _, _ in leaves)}
    bound = {k: 1e3 * b / mem_bps for k, b in nbytes.items()}
    pairs = {}
    for p, g, _, _ in leaves:
        key = f"{str(p.dtype)[6:]}/{str(g.dtype)[6:]}"
        pairs[key] = pairs.get(key, 0) + 1
    res = {"leaves": len(named), "elements": elements, "dtypes": pairs,
           "launches": {k: launches[k] for k in OPTIMIZER_STEP},
           "fused_leaves": step.fused_leaves.total,
           "plain_leaves": step.plain_leaves.total,
           "norm_rel_err": norm_err, "unequal_leaves": len(unequal),
           "norm_ms": ms["norm"], "update_ms": ms["update"],
           "norm_bound_ms": bound["norm"],
           "update_bound_ms": bound["update"]}
    print(f"[optimizer] {label}: {len(named)} leaves, {elements:,} elements "
          f"(p/g {pairs}); one clipped step: launches {res['launches']}, "
          f"leaves fused {res['fused_leaves']}, plain "
          f"{res['plain_leaves']}; norm {float(gnorm):.6g} against "
          f"global_norm's {ref:.6g}, relative {norm_err:.2e} (tolerance "
          f"1e-5); p, m, v bit-equal to the plain loop given that scale on "
          f"{len(named) - len(unequal)} of {len(named)} leaves "
          f"{unequal[:4]}; alone: norm {ms['norm']:.4f} ms (bytes bound "
          f"{bound['norm']:.4f}, {100 * bound['norm'] / ms['norm']:.1f}%), "
          f"update {ms['update']:.4f} ms (bound {bound['update']:.4f}, "
          f"{100 * bound['update'] / ms['update']:.1f}%)")
    assert res["launches"] == OPTIMIZER_STEP, res
    assert (res["fused_leaves"], res["plain_leaves"]) == (len(named), 0), res
    assert norm_err <= 1e-5 and not unequal, res
    del params, grads, opt, leaves, gs, plan, out, named
    gc.collect()
    torch.cuda.empty_cache()
    return res


def optimizer_path(mem_bps: float) -> dict:
    """Phase 37: `optimizer_check` at the benchmark's training cell's
    leaves and at those of every training phase, full width and tiny
    f32."""
    jamba = get_config(JAMBA)
    sets = {
        "bench qwen2moe-train-b4s2048": bench_cell_params,
        f"phase 9 {TRAIN_ARCH}": lambda: model_params(get_config(TRAIN_ARCH)),
        f"phase 15 {ARCH} x{MOE_TRAIN_REPEATS}": lambda: model_params(
            get_config(ARCH).scaled(repeats=MOE_TRAIN_REPEATS)),
        f"phase 17 {JAMBA} layers 0-{JAMBA_TRAIN_LAYERS - 1}":
            lambda: model_params(jamba.scaled(
                pattern=jamba.pattern[:JAMBA_TRAIN_LAYERS], repeats=1)),
        f"phase 21 {GEMMA2} one period": lambda: model_params(
            get_config(GEMMA2).scaled(repeats=1)),
        f"phase 22 {WHISPER}": lambda: model_params(get_config(WHISPER)),
        f"phase 30 {XLSTM}": lambda: model_params(get_config(XLSTM)),
    }
    for ph, arch in (("10", TRAIN_ARCH), ("16", ARCH), ("18", JAMBA),
                     ("25", WHISPER), ("31", XLSTM)):
        sets[f"phase {ph} tiny {arch} f32"] = (
            lambda a=arch: model_params(
                tiny_config(a).scaled(dtype="float32")))
    return {label: optimizer_check(label, make(), mem_bps)
            for label, make in sets.items()}


def card_peaks(smi: str, peak_key: str, pk) -> dict:
    """The card's own rates beside the data sheet's: a bf16 `torch.matmul`
    of PEAK_MM^3 (2 n^3 flops) and a device-to-device copy of PEAK_COPY
    bytes (each byte read once and written once), CUDA events, median
    after warm-up. These library calls are yardsticks, not ports. Fails
    if either rate passes PEAK_SLACK x its data-sheet figure."""
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randn((PEAK_MM, PEAK_MM), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    b = torch.randn((PEAK_MM, PEAK_MM), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(a, b), reps=20, warmup=5)
    src = torch.empty(PEAK_COPY, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), reps=20, warmup=5)
    out = {"matmul_ms": mm_ms, "copy_ms": copy_ms,
           "bf16_fps": 2 * PEAK_MM ** 3 / (mm_ms * 1e-3),
           "hbm_bps": 2 * PEAK_COPY / (copy_ms * 1e-3)}
    del a, b, src, dst
    torch.cuda.empty_cache()
    print(f"[roofline] {smi}: bf16 torch.matmul {PEAK_MM}^3 {mm_ms:.4f} ms "
          f"= {out['bf16_fps'] / 1e12:.1f} TFLOP/s against the {peak_key} "
          f"data sheet's {pk.bf16_fps / 1e12:.1f} "
          f"({100 * out['bf16_fps'] / pk.bf16_fps:.1f}%); copy of "
          f"{PEAK_COPY / 2**30:.0f} GiB {copy_ms:.4f} ms = "
          f"{out['hbm_bps'] / 1e12:.3f} TB/s read + written against "
          f"{pk.hbm_bps / 1e12:.2f} ({100 * out['hbm_bps'] / pk.hbm_bps:.1f}"
          f"%); NVLink in the collective term {pk.link_bps / 1e9:.0f} GB/s "
          f"a direction (not measured: one card)")
    assert out["bf16_fps"] <= PEAK_SLACK * pk.bf16_fps, out
    assert out["hbm_bps"] <= PEAK_SLACK * pk.hbm_bps, out
    return out


def step_work(label: str, arch: str, shape: ShapeSpec, times: dict,
              bf16_fps: float) -> dict:
    """Model-level work of a step the card ran: `lower_cell` on fake host
    tensors at the step's shape on a 1 x 1 mesh (the whole step on one
    rank, no collective), and the share of the bf16 peak that its
    `model_flops` and its counted flops reach over each of `times` (ms a
    step, measured by the phases named)."""
    t0 = time.perf_counter()
    rec = dryrun.lower_cell(arch, shape.name, False, shape=shape,
                            mesh_shape=(1, 1))
    secs = time.perf_counter() - t0
    shares = {name: {"model": rec["model_flops"] / (ms * 1e-3) / bf16_fps,
                     "counted": rec["flops"] / (ms * 1e-3) / bf16_fps}
              for name, ms in times.items()}
    print(f"[roofline] {label}: {arch} {shape}: model_flops "
          f"{rec['model_flops']:.4e}, counted {rec['flops']:.4e} "
          f"({rec['collective_ops'] or 'no collective'}), useful_ratio "
          f"{rec['useful_ratio']:.4f}; counted in {secs:.1f} s on the host")
    for name, ms in times.items():
        print(f"[roofline]   over {name} {ms:.3f} ms a step: model_flops "
              f"at {100 * shares[name]['model']:.2f}% of the bf16 peak, the "
              f"counted flops at {100 * shares[name]['counted']:.2f}%")
    assert rec["flops"] > 0, rec
    return {"model_flops": rec["model_flops"], "flops": rec["flops"],
            "useful_ratio": rec["useful_ratio"], "shares": shares}


def roofline_path(smi: str, peak_key: str, pk, qwen_train: dict,
                  serve_ms: float, dec_prof: dict) -> dict:
    """Slice 18's path on this machine: the card's peaks, the work of
    phase 9's train step and phase 5's decode step, and one full-size
    dry-run cell on the host's fake 256-rank world."""
    t_phase = time.perf_counter()
    out = {"peaks": card_peaks(smi, peak_key, pk)}
    out["train"] = step_work(
        "phase 9's train step", TRAIN_ARCH,
        ShapeSpec("phase9_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        {"train() wall (phase 9)": qwen_train["wall_ms"],
         "profiled wall (phase 9)": qwen_train["profile_wall_ms"],
         "device busy (phase 9)": qwen_train["profile_busy_ms"]},
        pk.bf16_fps)
    out["decode"] = step_work(
        "phase 5's decode step", ARCH,
        ShapeSpec("phase5_decode", 64, SLOTS, "decode"),
        {"engine wall (phase 5)": serve_ms,
         "profiled wall (phase 6)": dec_prof["wall_ms"],
         "device busy (phase 6)": dec_prof["busy_ms"]}, pk.bf16_fps)
    arch, shape, kw = perf.ITERATIONS["small_baseline"]
    t0 = time.perf_counter()
    rec = dryrun.lower_cell(arch, shape, multi_pod=False, **kw)
    secs = time.perf_counter() - t0
    print(f"[dryrun] small_baseline ({arch} {shape}, pod mesh 16 x 16, "
          f"{kw or 'default knobs'}) on the host in {secs:.1f} s, torch "
          f"{torch.__version__}: "
          f"{json.dumps(rec)}")
    assert "error" not in rec and "skip" not in rec, rec
    assert sum(rec["collectives"].values()) > 0, rec["collectives"]
    assert not torch.distributed.is_initialized()
    out["dryrun"] = {"record": rec, "seconds": secs}
    print(f"[roofline] phase 34 took {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ab"]:
        return compare_trees(Path(sys.argv[2]))
    apps_only = sys.argv[1:2] == ["--apps"]
    procs_only = sys.argv[1:2] == ["--procs"]
    examples_only = sys.argv[1:2] == ["--examples"]
    optimizer_only = sys.argv[1:2] == ["--optimizer"]

    # each phase's start, to print where the run's time goes (phase 38)
    starts = [("1", time.perf_counter())]

    def lap(label: str) -> None:
        starts.append((label, time.perf_counter()))

    # ---- 1. the card -----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    smi = smi.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak_key, pk = peaks_for(name)
    mem_bps, bf16_fps, f32_fps = pk.hbm_bps, pk.bf16_fps, pk.f32_fps
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_rate = sms * SFU_PER_CLOCK * max_sm_mhz * 1e6
    print(f"[card] {name}, capability {torch.cuda.get_device_capability(0)},"
          f" peaks of {peak_key}: {mem_bps / 1e12} TB/s, "
          f"{bf16_fps / 1e12} bf16 TFLOP/s, {f32_fps / 1e12} f32 TFLOP/s; "
          f"{sms} SMs at up to {max_sm_mhz:.0f} MHz: "
          f"{sfu_rate / 1e12:.3f} T exp2/s ({SFU_PER_CLOCK} a clock an SM)")
    if apps_only:
        apps_path()
        return 0
    if optimizer_only:
        optimizer_path(mem_bps)
        return 0
    # phase 35's workers fork from this process's fork server: start it
    # now, so that its preload (torch and the port) runs beside phases
    # 2-34 and not inside phase 35
    start_fork_server()
    if procs_only:
        procs_path()
        return 0
    if examples_only:
        examples_path()
        return 0

    lap("2")
    # ---- 2. build, one nvcc per source, all started together ----------
    def timed_build(job):
        name, split = job
        defines = () if split is None else (f"-DSEL_SCAN_R={split[0]}",
                                            f"-DSEL_SCAN_P={split[1]}")
        t0 = time.time()
        return name, split, _build.build(name, defines), time.time() - t0

    jobs = [("moe_gemm", None), ("flash_attention", None), ("ssm_scan", None),
            ("xlstm_scan", None), ("xlstm_scan_bwd", None)]
    jobs += [("ssm_scan", split) for split in SEL_SPLITS]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(timed_build, jobs))
    split_libs = {}
    for kname, split, lib, secs in built:
        if kname.startswith("xlstm_scan"):   # 16 head dims: the paths' two
            print(f"[build] {kname}: {secs:.2f} s -> {lib.name}")
            kerns = (("mlstm_scan_out_kernel", "slstm_scan_kernel")
                     if kname == "xlstm_scan" else
                     ("mlstm_bwd_chunk_kernel", "slstm_scan_bwd_kernel"))
            for kern in kerns:
                for hd in (192, 16):
                    ptxas_report(lib, only=(f"{kern}<f32, hd {hd}>",
                                            f"{kern}<f32, hd {hd},"))
            if kname == "xlstm_scan":
                ptxas_report(lib, only="mlstm_scan_state_kernel")
            else:
                ptxas_report(lib, only=("mlstm_bwd_prep_kernel",
                                        "mlstm_bwd_state_kernel",
                                        "mlstm_bwd_gate_kernel"))
        elif split is None:
            print(f"[build] {kname}: {secs:.2f} s -> {lib.name}")
            report = ptxas_report(lib)
            if kname in F32_KERNELS:
                f32_spills(report, kname)
        else:
            print(f"[build] {kname} with R={split[0]} P={split[1]}, to time "
                  f"it: {secs:.2f} s -> {lib.name}")
            ptxas_report(lib, only="sel_scan_kernel<bf16")
            split_libs[split] = sscan.load(lib)
    flib = fa._lib()
    flib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    for which, bf16, kname in ((0, 1, "flash_fwd_mma_kernel<bf16>"),
                               (0, 0, "flash_fwd_f32_kernel"),
                               (1, 1, "flash_bwd_dq_mma_kernel<bf16>"),
                               (1, 0, "flash_bwd_dq_f32_kernel"),
                               (2, 1, "flash_bwd_dkdv_mma_kernel<bf16>"),
                               (2, 0, "flash_bwd_dkdv_f32_kernel")):
        print(f"[build]   {kname}: dynamic smem " + ", ".join(
            f"hd {hd} {flib.flash_attention_smem_bytes(which, hd, bf16)} B"
            for hd in fa.HEAD_DIMS))
    slib = sscan._lib()
    print(f"[build]   sel_scan_kernel: dynamic smem bf16 "
          f"{slib.selective_scan_smem_bytes(1)} B, f32 "
          f"{slib.selective_scan_smem_bytes(0)} B")
    print(f"[build]   blocks an SM: sel_scan_kernel<R "
          f"{slib.selective_scan_split(0)}, P {slib.selective_scan_split(1)}>"
          f" bf16 "
          f"{slib.selective_scan_blocks_per_sm(1)}, f32 "
          f"{slib.selective_scan_blocks_per_sm(0)}; lin_scan_kernel bf16 "
          f"{slib.ssm_scan_blocks_per_sm(1)}, f32 "
          f"{slib.ssm_scan_blocks_per_sm(0)}")
    print(f"[build]   sel_scan_bwd_kernel: dynamic smem bf16 "
          f"{slib.selective_scan_bwd_smem_bytes(1)} B, f32 "
          f"{slib.selective_scan_bwd_smem_bytes(0)} B; blocks an SM bf16 "
          f"{slib.selective_scan_bwd_blocks_per_sm(1)}, f32 "
          f"{slib.selective_scan_bwd_blocks_per_sm(0)}; "
          f"{slib.selective_scan_bwd_block_channels()} channels a block; h "
          f"kept every {slib.selective_scan_seg_steps()} steps")
    xlib = xls._lib()
    print(f"[build]   mlstm_scan_state_kernel and mlstm_scan_out_kernel: "
          f"chunks of {xlib.xlstm_scan_layout(0)} steps; states in C tiles "
          f"of {xlib.xlstm_scan_layout(1)} x {xlib.xlstm_scan_layout(1)}, "
          f"dynamic smem {xlib.mlstm_scan_smem_bytes(192, 0)} B, "
          f"{xlib.mlstm_scan_blocks_per_sm(192, 0)} blocks an SM; outputs at "
          f"hd 192 {xlib.mlstm_scan_smem_bytes(192, 1)} B, "
          f"{xlib.mlstm_scan_blocks_per_sm(192, 1)} blocks an SM; "
          f"slstm_scan_kernel: clusters of {xlib.xlstm_scan_layout(2)} "
          f"blocks, {xlib.xlstm_scan_layout(3)} batch rows a cluster, "
          f"{xlib.slstm_scan_max_active_clusters(192, XLSTM_BATCH, 4)} "
          f"clusters at once at hd 192 (the path needs "
          f"{4 * -(-XLSTM_BATCH // xlib.xlstm_scan_layout(3))})")
    blib = xls._bwd_lib()
    print(f"[build]   mlstm_bwd_state_kernel: dynamic smem "
          f"{blib.mlstm_bwd_smem_bytes(192, 0)} B (one block an SM); "
          f"mlstm_bwd_chunk_kernel: dynamic smem at hd 192 "
          f"{blib.mlstm_bwd_smem_bytes(192, 1)} B, "
          f"{blib.mlstm_bwd_blocks_per_sm(192)} blocks an SM; "
          f"slstm_scan_bwd_kernel: "
          f"{blib.slstm_bwd_max_active_clusters(192, XLSTM_TRAIN_BATCH, 4)}"
          f" clusters at once at hd 192 (the train cell needs "
          f"{4 * -(-XLSTM_TRAIN_BATCH // xlib.xlstm_scan_layout(3))})")

    lap("3")
    # ---- 3. kernel vs plain ---------------------------------------------
    cfg = get_config(ARCH)
    e_pad = padded_experts(cfg)
    c = SLOTS * capacity(cfg, 1)                  # decode: S=1 per slot
    d, f = cfg.d_model, cfg.moe_d_ff
    up_shape, down_shape = (e_pad, c, d, f), (e_pad, c, f, d)
    jcfg = get_config(JAMBA)
    je, jd, jf = padded_experts(jcfg), jcfg.d_model, jcfg.moe_d_ff
    jc_prefill = capacity(jcfg, PREFILL_SEQ)      # B=1, S=4096: C=640
    jc_decode = SLOTS * capacity(jcfg, 1)
    gemm_cases = [("gate/up", up_shape), ("down", down_shape)]
    for label, jc in (("jamba prefill", jc_prefill),
                      ("jamba decode", jc_decode)):
        gemm_cases += [(f"{label} gate/up", (je, jc, jd, jf)),
                       (f"{label} down", (je, jc, jf, jd))]
    tshapes = train_shapes()
    train_up, train_down = tshapes["train gate/up"], tshapes["train down"]
    jtrain_up = tshapes["jamba train gate/up"]
    jtrain_down = tshapes["jamba train down"]
    gemm_cases += [("jamba train gate/up", jtrain_up),
                   ("jamba train down", jtrain_down)]
    qcfg = get_config(QWEN3)
    qe, qc = padded_experts(qcfg), SLOTS * capacity(qcfg, 1)
    gemm_cases += [("train gate/up", train_up), ("train down", train_down),
                   ("qwen3 gate/up", (qe, qc, qcfg.d_model, qcfg.moe_d_ff)),
                   ("qwen3 down", (qe, qc, qcfg.moe_d_ff, qcfg.d_model))]
    gemm_cases.append(("ragged", (3, 100, 96, 72)))
    # d and f not multiples of 8: bf16 goes through the wrapper's padding
    gemm_cases.append(("unaligned d, f", (3, 100, 93, 71)))
    # the persistent backward's schedule at its edges (64 x 256 output
    # tiles, one block an SM): fewer tiles than SMs (dx 8, dw 16); 2 x
    # SMs + 1 tiles in both dx and dw (a ragged f in dw's columns); one
    # expert whose rows span many tiles (dx 1,024 tiles, dw 256)
    gemm_cases += [("edge: one expert, few tiles", (1, 256, 512, 512)),
                   ("edge: 2 x SMs + 1 tiles", (2 * sms + 1, 64, 64, 200)),
                   ("edge: one expert, many row tiles",
                    (1, 4096, 4096, 1024))]
    # the f32 GEMM's edges, f32 only: the contraction under one chunk of 8
    # (d 6 for the forward, f 7 for dx, C 5 for dw; d and f padded to 8);
    # C at the forward's route threshold and one row either side (16- and
    # 128-row tiles) at the qwen2-moe gate/up dims; one expert whose
    # output spans many tiles in every product, all three dims ragged
    t_c = mg.F32_NARROW_MAX_C
    f32_cases = [("f32 edge: K under one chunk", (3, 5, 6, 7))]
    f32_cases += [(f"f32 edge: C = threshold {c_ - t_c:+d}", (4, c_, d, f))
                  for c_ in (t_c - 1, t_c, t_c + 1)]
    f32_cases.append(("f32 edge: one expert, many tiles", (1, 1000, 2050,
                                                            1410)))
    gen = torch.Generator("cuda").manual_seed(0)

    def operands(shape, dtype, scale=0.3):
        e_, c_, d_, f_ = shape
        x = torch.randn((e_, c_, d_), generator=gen, device="cuda") * scale
        w = torch.randn((e_, d_, f_), generator=gen, device="cuda") * scale
        return x.to(dtype), w.to(dtype)

    tols = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    errs, bwd_errs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape in gemm_cases + (
                f32_cases if dtype == torch.float32 else []):
            # Jamba's, the train and the qwen3 shapes: operands at
            # d**-0.25, so outputs have unit variance as in the model. At
            # 0.3 they reach |out| ~ 65, and f32 sums over d=4096 in the
            # kernel's and cuBLAS's orders part by up to 1.5e-4 (H100 80GB
            # HBM3, 700 W).
            scale = (shape[2] ** -0.25 if label.startswith(
                ("jamba", "train", "qwen3", "edge", "f32 edge")) else 0.3)
            x, w = operands(shape, dtype, scale)
            got, want = moe_gemm(x, w), moe_gemm_ref(x, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tols[dtype], atol=tols[dtype])
            errs[(label, dtype)] = err
            print(f"[check] moe_gemm {label} {tuple(shape)} {dtype}: "
                  f"max |kernel - plain| = {err:.3e} (holds "
                  f"|diff| <= {tols[dtype]} * (1 + |plain|))")
            del got, want
            bwd_errs[(label, dtype)] = check_moe_bwd(label, x, w, scale,
                                                     tols[dtype], gen)
            del x, w
            torch.cuda.empty_cache()
    x, w = operands((4, 32, 64, 64), torch.float32, 1.0)
    base = moe_gemm(x, w)
    x[2] = 999.0
    pert = moe_gemm(x, w)
    assert torch.equal(base[0], pert[0]) and torch.equal(base[3], pert[3])
    assert not torch.allclose(base[2], pert[2])
    print("[check] moe_gemm expert isolation: ok")
    print(f"[check] moe_gemm bf16 forward output digest at "
          f"{FWD_DIGEST_SHAPE}: {forward_digest(moe_gemm)}")
    f32_batch_invariance(up_shape, gen)

    # times at the path's shapes, bf16: each shape, then one MoE layer's
    # three calls (gate, up, down) as the kernel's line in the JSON, at the
    # serving shapes, at the Jamba prefill's and at Jamba decode's (C=16,
    # on the prefill's weights); then the f32 kernel's layer at the
    # serving shapes
    xu, wg = operands(up_shape, torch.bfloat16)
    _, wu = operands(up_shape, torch.bfloat16)
    xd, wd = operands(down_shape, torch.bfloat16)
    xju, wjg = operands((je, jc_prefill, jd, jf), torch.bfloat16)
    _, wju = operands((je, jc_prefill, jd, jf), torch.bfloat16)
    xjd, wjd = operands((je, jc_prefill, jf, jd), torch.bfloat16)
    xju1, xjd1 = (t[:, :jc_decode].contiguous() for t in (xju, xjd))
    xu32, wg32 = operands(up_shape, torch.float32)
    _, wu32 = operands(up_shape, torch.float32)
    xd32, wd32 = operands(down_shape, torch.float32)
    calls = {"gate/up": [(xu, wg)], "down": [(xd, wd)],
             "layer": [(xu, wg), (xu, wu), (xd, wd)],
             "jamba prefill layer": [(xju, wjg), (xju, wju), (xjd, wjd)],
             "jamba decode layer": [(xju1, wjg), (xju1, wju), (xjd1, wjd)],
             "f32 layer": [(xu32, wg32), (xu32, wu32), (xd32, wd32)]}
    times = {}
    for label, args in calls.items():
        shapes = [(*x_.shape, w_.shape[2]) for x_, w_ in args]
        f32 = args[0][0].dtype == torch.float32
        reps = (5, 1) if label == "jamba prefill layer" else (20, 3)
        t = {"ms": time_ms(lambda: [moe_gemm(*a) for a in args], *reps),
             "plain_ms": time_ms(lambda: [moe_gemm_ref(*a) for a in args],
                                 *reps),
             "library_ms": time_ms(lambda: [torch.bmm(*a) for a in args],
                                   *reps)}
        t["bound_ms"], t["bound_by"] = bound(
            shapes, 4 if f32 else 2, f32_fps if f32 else bf16_fps, mem_bps)
        times[label] = t
        print(f"[time] moe_gemm {label} {shapes} "
              f"{'f32 (CUDA cores)' if f32 else 'bf16 (wgmma)'}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.bmm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); kernel at "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound")
    del xu, wg, wu, xd, wd, xju, wjg, wju, xjd, wjd, xju1, xjd1, xu32, \
        wg32, wu32, xd32, wd32, x, w, base, pert, args, calls
    torch.cuda.empty_cache()

    train_times = {dtype: time_moe_train_layer(
        [train_up, train_up, train_down], dtype, gen,
        bf16_fps if dtype == torch.bfloat16 else f32_fps, mem_bps)
        for dtype in (torch.bfloat16, torch.float32)}
    jamba_train_times = time_moe_train_layer(
        [jtrain_up, jtrain_up, jtrain_down], torch.bfloat16, gen, bf16_fps,
        mem_bps)
    dw_sweep({"dw": moe_gemm_bwd_dw}, bf16_fps, sms)
    f32_sweep = f32_route_sweep(up_shape, gen)

    lap("4")
    # ---- 4. flash attention vs plain, and its times ---------------------
    flash_errs = check_flash(gen)
    check_f32_rows(gen)
    flash_times = time_flash(gen, bf16_fps, f32_fps, mem_bps)

    lap("5")
    # ---- 5. slice 1's main path: full-width serve -----------------------
    moe_layers = sum(b.ffn == "moe" for b in cfg.pattern) * cfg.repeats
    per_step = 3 * moe_layers
    torch.cuda.reset_peak_memory_stats()
    moe_gemm.launches = 0
    out = serve(ARCH, num_requests=REQUESTS, clients=CLIENTS, slots=SLOTS,
                max_new=MAX_NEW, tiny=False, device="cuda")
    launches = moe_gemm.launches
    peak = torch.cuda.max_memory_allocated()
    steps = out["engine_steps"]
    serve_ms = 1e3 * out["wall_s"] / steps
    print(f"[serve] {ARCH} full width, {cfg.num_layers} layers, bf16: "
          f"{out['requests']} requests, {out['tokens']} tokens, {steps} "
          f"engine steps, wall {out['wall_s']:.3f} s, "
          f"{out['tok_per_s']:.2f} tok/s, "
          f"{1e3 * out['wall_s'] / steps:.2f} ms/step, peak memory "
          f"{peak / 2**30:.2f} GiB; moe_gemm launches {launches} "
          f"({per_step} per step); stats {out['stats']}")
    assert out["requests"] == REQUESTS, out
    assert out["tokens"] == REQUESTS * MAX_NEW, out
    assert per_step == 72 and launches == per_step * steps > 0, \
        (launches, per_step, steps)
    assert out["stats"]["nonfinite_steps"] == 0, out["stats"]

    lap("6")
    # ---- 6. where a decode step's time goes -----------------------------
    del out
    dec_prof = profile_steps(cfg, per_step)

    lap("7")
    # ---- 7. tiny engine == greedy reference, f32 on the card -----------
    tcfg = tiny_config(ARCH).scaled(dtype="float32")
    model = get_model(tcfg, "cuda")
    params = model.init_params(torch.Generator("cuda").manual_seed(0))
    prompts = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 8, 1, 6]]
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, num_clients=1)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=5)) for p in prompts]
    eng.run_until_drained()
    # the same prompts through a runtime-backed engine, two clients
    with TaskRuntime(num_workers=2, mode="ddast", num_clients=2) as rt:
        rt_eng = ServeEngine(model, params, batch_slots=2, max_len=32,
                             num_clients=2, runtime=rt)
        rt_reqs = [rt_eng.submit(Request(prompt=p, max_new_tokens=5), i % 2)
                   for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        while not all(r.done_event.is_set() for r in rt_reqs):
            rt_eng.step()
            assert time.perf_counter() - t0 < 60, "runtime engine timeout"
    for p, r, rr in zip(prompts, reqs, rt_reqs):
        want = greedy_decode(model, params,
                             torch.tensor([p], device="cuda"), 5, 32)
        assert r.output == want[0].tolist(), (p, r.output, want)
        assert rr.output == want[0].tolist(), (p, rr.output, want)
    print(f"[check] tiny {ARCH} engine == greedy decode for "
          f"{len(prompts)} requests (f32, cuda), the private loop and the "
          f"runtime-backed engine (2 clients)")

    del model, params, eng, rt_eng
    gc.collect()
    torch.cuda.empty_cache()

    lap("8")
    # ---- 8. moe_gemm's gradients: the kernels vs autograd of the plain --
    check_moe_autograd(gen)

    lap("9")
    # ---- 9. slice 2's main path: full-width training --------------------
    qwen_train = launcher_train_path(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ)
    fwd_launches = qwen_train["counts"]["flash_attention"]
    bwd_launches = qwen_train["counts"]["flash_attention_bwd"]
    assert fwd_launches == 24 * TRAIN_STEPS, fwd_launches

    lap("10")
    # ---- 10. tiny training in f32 on the card: learns, resumes exactly --
    tiny_counts = tiny_f32_train(TRAIN_ARCH)
    f32_train = {"forward": tiny_counts["flash_attention"],
                 "backward": tiny_counts["flash_attention_bwd"]}

    lap("11")
    # ---- 11. the scan kernels vs plain, and their times ----------------
    gc.collect()
    torch.cuda.empty_cache()
    scans = check_scans(gen, mem_bps, sfu_rate, f32_fps, split_libs)
    scans["selective_scan_bwd"] = check_scan_bwd(gen, mem_bps, sfu_rate,
                                                 f32_fps)

    lap("12")
    # ---- 12, 13. slice 3's main path: full-width Jamba prefill, serve ---
    jamba = jamba_prefill_and_serve()

    lap("14")
    # ---- 14. tiny f32 Jamba on the card; ssm_scan under grad raises -----
    f32_counts = jamba_tiny_checks()

    lap("15")
    # ---- 15. slice 7's main path: full-width MoE training --------------
    moe_train = moe_train_path()

    lap("16")
    # ---- 16. tiny f32 MoE training on the card: learns, resumes exactly -
    moe_f32 = tiny_f32_train(ARCH)

    lap("17")
    # ---- 17. slice 8's main path: full-width Jamba training ------------
    jamba_train = jamba_train_path()

    lap("18")
    # ---- 18. tiny f32 Jamba training on the card: learns, resumes -------
    jamba_f32 = tiny_f32_train(JAMBA)

    lap("19")
    # ---- 19, 20. slice 11's main path: full-width gemma2-27b prefill,
    # serve -----------------------------------------------------------------
    gemma2 = gemma2_prefill_and_serve()

    lap("21")
    # ---- 21. slice 11's train path: gemma2-27b cut to one period --------
    gemma2_train = gemma2_train_path()

    lap("22")
    # ---- 22. slice 11's encoder-decoder path: whisper-base training -----
    whisper_train = whisper_train_path()
    assert whisper_train["counts"]["flash_attention"] == 12 * TRAIN_STEPS

    lap("23")
    # ---- 23. whisper-base decode after fill_cross_cache ------------------
    whisper_dec = whisper_decode()

    lap("24")
    # ---- 24, 25. tiny f32 whisper on the card: decode == forward; train()
    # learns and resumes exactly ------------------------------------------
    whisper_f32 = whisper_tiny_checks()
    whisper_f32_train = tiny_f32_train(WHISPER)

    lap("26")
    # ---- 26. the xLSTM scan kernels vs plain, and their times -----------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    xlstm_times = check_xlstm(gen, mem_bps, f32_fps)
    # the backward checks draw from a generator of their own, so that
    # their inputs do not depend on what the phases before them drew
    xlstm_times.update(check_xlstm_bwd(torch.Generator("cuda").manual_seed(0),
                                       mem_bps, f32_fps))
    print(f"[xlstm] phase 26 took {time.perf_counter() - t_phase:.1f} s")

    lap("27")
    # ---- 27, 28. slice 12's main path: full-width xlstm-125m prefill,
    # serve ---------------------------------------------------------------
    xlstm = xlstm_prefill_and_serve()

    lap("29")
    # ---- 29. tiny f32 xlstm on the card: decode == forward, engine ------
    xlstm_f32 = xlstm_tiny_checks()

    lap("30")
    # ---- 30. slice 13's main path: full-width xlstm-125m training --------
    gc.collect()
    torch.cuda.empty_cache()
    xlstm_train = xlstm_train_path()

    lap("31")
    # ---- 31. tiny f32 xlstm training on the card: learns, resumes -------
    xlstm_f32_train = tiny_f32_train(XLSTM)

    lap("32")
    # ---- 32. slice 16's main path: the runtime-backed engine -----------
    gc.collect()
    torch.cuda.empty_cache()
    rt_serve = runtime_serve_path(cfg, per_step)

    lap("33")
    # ---- 33. slice 17's path: the paper's three apps on TaskRuntime ------
    gc.collect()
    torch.cuda.empty_cache()
    apps_path()

    lap("34")
    # ---- 34. slice 18's path: the roofline and the dry-run --------------
    gc.collect()
    torch.cuda.empty_cache()
    roofline_path(smi, peak_key, pk, qwen_train, serve_ms, dec_prof)

    lap("35")
    # ---- 35. slice 19's path: the process backend on the card -----------
    gc.collect()
    torch.cuda.empty_cache()
    procs_path()

    lap("36")
    # ---- 36. slice 20's path: the port's examples on the card ------------
    gc.collect()
    torch.cuda.empty_cache()
    examples = examples_path()
    ex_train = examples["launches"]["train_lm"]
    ex_errs = list(examples["flash_errs"].values())

    lap("37")
    # ---- 37. the fused clip and AdamW at every training path's leaves --
    gc.collect()
    torch.cuda.empty_cache()
    optimizer = optimizer_path(mem_bps)

    lap("38")
    print("[phases] seconds from each phase's start to the next's: "
          + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1)
                      in zip(starts, starts[1:]))
          + f"; phases 1-37 {starts[-1][1] - starts[0][1]:.1f}")
    # ---- 38. results -----------------------------------------------------
    # Both dtypes of moe_gemm, of its backward and of the flash forward and
    # backward count in one `launches`; each route's own count is that of
    # a run in its dtype: bf16 the main paths (phases 5, 9 and 15), f32 the
    # tiny f32 Jamba forward (phase 14) and the tiny f32 trainings (phases
    # 10 and 16). The selective scan's backward counts its launches on the
    # Jamba train path (phase 17).
    def times_of(t):
        return {k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}

    kernels = []
    for dtype, t, count, unit in (
            (torch.bfloat16, times["layer"], launches,
             "one MoE layer's three calls (gate, up, down) at the serving "
             "path's bf16 shapes; launches over the serve run"),
            (torch.float32, times["f32 layer"], f32_counts["moe_gemm"],
             "one MoE layer's three calls at the serving path's shapes in "
             "f32; launches: the tiny f32 Jamba forward")):
        bf16 = dtype == torch.bfloat16
        kernels.append({
            "name": f"moe_gemm ({'bf16' if bf16 else 'f32'})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
            "kernel": ("moe_gemm_wgmma_kernel" if bf16 else
                       "moe_gemm_f32_kernel<16, false, true> (16 x 256 "
                       "tiles, C <= F32_NARROW_MAX_C), <128, false, true> "
                       "(128 x 128 tiles)"),
            "replaces": "src/repro/kernels/moe_gemm.py:21",
            "launches": count,
            "max_abs_err": max(errs[(lb, dtype)]
                               for lb in ("gate/up", "down")),
            **times_of(t), "unit": unit,
            **({"runtime_serve": {
                "launches": rt_serve["launches"],
                "unit": "over the runtime-backed serve run (phase 32)"}}
               if bf16 else {}),
            **({"jamba_prefill_layer": times_of(times["jamba prefill layer"]),
                "jamba_decode_layer": times_of(times["jamba decode layer"]),
                "jamba_train_layer": {
                    **times_of(jamba_train_times["forward"]),
                    "device_ms": jamba_train_times["forward"]["device_ms"],
                    "launches": jamba_train["counts"]["moe_gemm"],
                    "unit": "one MoE layer's three calls at the Jamba "
                            "train shapes (E=16, C=1280, d=4096, "
                            "f=14336); launches over the 6 full-width "
                            "Jamba train steps"}}
               if bf16 else {}),
            "train_layer": {
                **times_of(train_times[dtype]["forward"]),
                "device_ms": train_times[dtype]["forward"]["device_ms"],
                "launches": (moe_train["counts"] if bf16
                             else moe_f32)["moe_gemm"],
                "unit": "one MoE layer's three calls at the MoE train "
                        "shapes (E=64, C=640, d=2048, f=1408); launches "
                        + ("over the 6 full-width train steps" if bf16
                           else "over the tiny f32 MoE training (60 steps)")},
            **({} if bf16 else {"c_sweep": f32_sweep}),
        })
    # the backward: no TPU counterpart (the JAX package differentiates its
    # jnp oracle); each route's launches are those of its training run
    for dtype, count in ((torch.bfloat16, moe_train["counts"]),
                         (torch.float32, moe_f32)):
        bf16 = dtype == torch.bfloat16
        t = train_times[dtype]
        kernels.append({
            "name": f"moe_gemm_bwd ({'bf16' if bf16 else 'f32'})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
            "kernel": ("moe_gemm_dx_wgmma_kernel, moe_gemm_dw_wgmma_kernel"
                       if bf16 else "moe_gemm_f32_kernel<128, false, false> "
                       "(dx), <128, true, true> (dw)"),
            "replaces": None,
            "launches": count["moe_gemm_bwd_dx"] + count["moe_gemm_bwd_dw"],
            "max_abs_err": max(max(bwd_errs[(lb, dtype)])
                               for lb in ("train gate/up", "train down")),
            **times_of(t["backward"]), "device_ms": t["backward"]["device_ms"],
            "unit": "one MoE layer's backward at the train shapes (E=64, "
                    "C=640, d=2048, f=1408): dx and dw of the gate, up and "
                    "down calls, 6 launches; launches "
                    + ("over the 6 full-width train steps" if bf16 else
                       "over the tiny f32 MoE training (60 steps)")
                    + "; library = torch.bmm on the same operands",
            **{g: {**times_of(t[g]), "device_ms": t[g]["device_ms"],
                   "launches": count[f"moe_gemm_bwd_{g}"],
                   "max_abs_err": max(bwd_errs[(lb, dtype)][i]
                                      for lb in ("train gate/up",
                                                 "train down"))}
               for i, g in enumerate(("dx", "dw"))},
            **({"jamba_train_layer": {
                **times_of(jamba_train_times["backward"]),
                "device_ms": jamba_train_times["backward"]["device_ms"],
                "launches": jamba_train["counts"]["moe_gemm_bwd_dx"]
                + jamba_train["counts"]["moe_gemm_bwd_dw"],
                "max_abs_err": max(max(bwd_errs[(lb, dtype)])
                                   for lb in ("jamba train gate/up",
                                              "jamba train down")),
                "unit": "dx and dw of one MoE layer's three calls at the "
                        "Jamba train shapes (E=16, C=1280, d=4096, "
                        "f=14336); launches over the 6 full-width Jamba "
                        "train steps",
                **{g: {**times_of(jamba_train_times[g]),
                       "device_ms": jamba_train_times[g]["device_ms"],
                       "launches": jamba_train["counts"][
                           f"moe_gemm_bwd_{g}"],
                       "max_abs_err": max(bwd_errs[(lb, dtype)][i]
                                          for lb in ("jamba train gate/up",
                                                     "jamba train down"))}
                   for i, g in enumerate(("dx", "dw"))}}} if bf16 else {}),
        })
    bwd_unit = ("one layer's call at the training path's shape (B=4, "
                "S=T=2048, 14:2 heads, hd 64, causal)")
    # the flash kernels at slice 11's path shapes, bf16; launches: each
    # shape's own count (the wrappers' `by_shape`) over its path's run
    g_fwd = gemma2["prefill_shapes"]
    g_tfwd = gemma2_train["shapes"]["forward"]
    g_bwd = gemma2_train["shapes"]["backward"]
    w_fwd, w_bwd = (whisper_train["shapes"][w] for w in ("forward",
                                                          "backward"))
    path_shapes = {
        ("forward", "whisper encoder"): (
            w_fwd["whisper encoder"],
            "whisper-base's encoder layer (B=16, S=T=1500, 8:8 heads, hd "
            "64, not causal); library = SDPA (is_causal=False); launches: "
            "the encoder's over the 6 whisper train steps"),
        ("forward", "whisper decoder"): (
            w_fwd["whisper decoder"],
            "whisper-base's decoder self-attention (B=16, S=T=448, 8:8 "
            "heads, hd 64, causal); library = SDPA (is_causal=True); "
            "launches: the decoder's over the 6 whisper train steps"),
        ("forward", "gemma2 local"): (
            g_fwd["gemma2 local"],
            "gemma2-27b's local layer at the prefill's S (B=1, S=T=8192, "
            "32:16 heads, hd 128, causal, window 4096, softcap 50); no "
            "PyTorch call computes softcapped attention; launches: the "
            "local layers' over the 4 gemma2 prefills"),
        ("forward", "gemma2 global"): (
            g_fwd["gemma2 global"],
            "gemma2-27b's global layer at the prefill's S (window none, "
            "softcap 50); launches: the global layers' over the 4 gemma2 "
            "prefills"),
        ("forward", "gemma2 train local"): (
            g_tfwd["gemma2 train local"],
            "gemma2-27b's local layer at the train cell's S (B=1, S=T=6144, "
            "32:16 heads, hd 128, causal, window 4096, softcap 50); no "
            "PyTorch call computes softcapped attention; launches: the "
            "local layer's over the 6 gemma2 train steps"),
        ("forward", "gemma2 train global"): (
            g_tfwd["gemma2 train global"],
            "gemma2-27b's global layer at the train cell's S (S=T=6144, "
            "window none, softcap 50); launches: the global layer's over "
            "the 6 gemma2 train steps"),
        ("backward", "whisper encoder"): (
            w_bwd["whisper encoder"],
            "whisper-base's encoder layer, dq then dk/dv; library = SDPA's "
            "backward alone; launches: the encoder's over the 6 whisper "
            "train steps"),
        ("backward", "whisper decoder"): (
            w_bwd["whisper decoder"],
            "whisper-base's decoder self-attention, dq then dk/dv; library "
            "= SDPA's backward alone (is_causal=True); launches: the "
            "decoder's over the 6 whisper train steps"),
        ("backward", "gemma2 train local"): (
            g_bwd["gemma2 train local"],
            "gemma2-27b's local layer at the train cell's S (B=1, S=T="
            "6144, window 4096, softcap 50), dq then dk/dv; no library "
            "call; launches: the local layer's over the 6 gemma2 train "
            "steps"),
        ("backward", "gemma2 train global"): (
            g_bwd["gemma2 train global"],
            "gemma2-27b's global layer at the train cell's S (S=T=6144, "
            "softcap 50), dq then dk/dv; launches: the global layer's over "
            "the 6 gemma2 train steps")}

    def path_entries(which: str) -> dict:
        err_key = "o" if which == "forward" else "grads"
        return {label.replace(" ", "_"): {
            **times_of(flash_times[(which, label)]), "launches": n,
            "max_abs_err": flash_errs[label][err_key], "unit": unit}
            for (w, label), (n, unit) in path_shapes.items() if w == which}
    for kname, kern, replaces, count, err, t, unit, extra in (
            ("flash_attention (bf16)", "flash_fwd_mma_kernel",
             "src/repro/kernels/flash_attention.py:30", fwd_launches,
             flash_errs["o"], flash_times["forward"],
             "one layer's forward at the training path's bf16 shape (B=4, "
             "S=T=2048, 14:2 heads, hd 64, causal); launches over the "
             "train run", {"jamba": times_of(flash_times["jamba"]),
                           **path_entries("forward"),
                           "examples_train": {
                               "launches": ex_train["flash_attention"],
                               "max_abs_err": max(e[0] for e in ex_errs),
                               "unit": "examples/torch_train_lm.py on "
                               "the card (tiny qwen2-0.5b, bf16, hd 16), "
                               "its two runs (phase 36)"}}),
            ("flash_attention (f32)", "flash_fwd_f32_kernel",
             "src/repro/kernels/flash_attention.py:30",
             f32_counts["flash_attention"], flash_errs["o_f32"],
             flash_times["forward_f32"],
             "one layer's forward at the training path's shape in f32; "
             "launches: the tiny f32 Jamba forward",
             {"f32_tiny_train_launches": f32_train["forward"],
              "whisper_tiny_f32_launches": {
                  "forward": whisper_f32["flash_attention"],
                  "training": whisper_f32_train["flash_attention"]}}),
            ("flash_attention_bwd (bf16)",
             "flash_bwd_dq_mma_kernel, flash_bwd_dkdv_mma_kernel", None,
             bwd_launches, flash_errs["grads"], flash_times["backward"],
             bwd_unit + " in bf16 (dq, then dk/dv: two launches); launches "
             "over the train run; library = SDPA's backward alone",
             {**{k_: flash_times["backward"][k_] for k_ in ("dq", "dkdv")},
              **path_entries("backward"),
              "examples_train": {
                  "launches": ex_train["flash_attention_bwd"],
                  "max_abs_err": max(e[1] for e in ex_errs),
                  "unit": "examples/torch_train_lm.py on the card, its two "
                  "runs (phase 36)"}}),
            ("flash_attention_bwd (f32)",
             "flash_bwd_dq_f32_kernel, flash_bwd_dkdv_f32_kernel, "
             "flash_bwd_dkdv_sum_f32_kernel", None,
             f32_train["backward"], flash_errs["grads_f32"],
             flash_times["backward_f32"],
             bwd_unit + " in f32 (dq, dk/dv into per-head partials, their "
             "sum: three launches); launches: the tiny f32 training (60 "
             "steps); library = SDPA's backward alone, f32",
             {**{k_: flash_times["backward_f32"][k_]
                 for k_ in ("dq", "dkdv", "sum")},
              "whisper_tiny_f32_launches":
              whisper_f32_train["flash_attention_bwd"]})):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "kernel": kern, "replaces": replaces, "launches": count,
            "max_abs_err": err, **times_of(t), "unit": unit, **extra,
        })
    for kname, replaces, count in (
            ("selective_scan", "src/repro/kernels/ssm_scan.py:27",
             jamba["prefill_counts"]["selective_scan"]),
            ("ssm_scan", "src/repro/kernels/ssm_scan.py:105",
             scans["ssm_scan"]["launches"])):
        t = scans[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": replaces, "launches": count,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "bytes_bound_ms": t["bytes_bound_ms"],
            "sfu_only_bound_ms": t["sfu_only_bound_ms"],
            "device_ms": t["device_ms"],
            **({"split": {"states_per_thread": sscan._lib()
                          .selective_scan_split(0),
                          "fma_exp_states": sscan._lib()
                          .selective_scan_split(1)},
                "splits_ms": t["splits_ms"],
                "one_block_an_sm_ms": t["one_block_an_sm_ms"]}
               if kname == "selective_scan" else {}),
            "unit": ("one Mamba layer's call at the Jamba prefill path's "
                     "bf16 shape (B=1, S=4096, D=8192, N=16); launches "
                     "over 4 prefills (14 each)"
                     if kname == "selective_scan" else
                     "one call at B=1, S=4096, D=8192 in bf16; launches: "
                     "the carried pair through ops.ssm_scan (no model "
                     "calls it)"),
            **({"jamba_train_launches":
                jamba_train["counts"]["selective_scan"]}
               if kname == "selective_scan" else {}),
        })
    # the selective scan's backward: no TPU counterpart (the JAX package
    # differentiates its oracle)
    t = scans["selective_scan_bwd"]
    kernels.append({
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "kernel": "sel_scan_bwd_kernel, sel_scan_bwd_reduce_kernel",
        "layout": {"seg_steps": slib.selective_scan_seg_steps(),
                   "block_channels": slib.selective_scan_bwd_block_channels(),
                   "smem_bytes": slib.selective_scan_bwd_smem_bytes(1),
                   "blocks_per_sm": slib.selective_scan_bwd_blocks_per_sm(1)},
        "replaces": None,
        "launches": jamba_train["counts"]["selective_scan_bwd"],
        "reduce_launches":
            jamba_train["counts"]["selective_scan_bwd_reduce"],
        "max_abs_err": t["max_abs_err"], **times_of(t),
        "bytes_bound_ms": t["bytes_bound_ms"],
        "sfu_only_bound_ms": t["sfu_only_bound_ms"],
        "device_ms": t["device_ms"],
        "forward_device_ms": t["forward_device_ms"],
        "forward_states_device_ms": t["forward_states_device_ms"],
        "f32_launches": jamba_f32["selective_scan_bwd"],
        "unit": "one Mamba layer's backward (the scan kernel and its "
                "second pass) at the Jamba train path's bf16 shape (B=2, "
                "S=4096, D=8192, N=16); launches (one of each kernel a "
                "call) over the 6 full-width Jamba train steps; f32: the "
                "tiny f32 Jamba training (60 steps)",
    })
    # the xLSTM scans: no TPU counterpart (the JAX package runs them as
    # lax.scan bodies); launches over the xlstm prefills (phase 27), and
    # over the xlstm train steps (phase 30) and the tiny f32 training
    # (phase 31)
    for kname, kern, step in (
            ("mlstm_scan", "mlstm_scan_state_kernel + mlstm_scan_out_kernel"
             "<hd 192>", "_mlstm_step"),
            ("slstm_scan", "slstm_scan_kernel<hd 192>", "_slstm_step")):
        t = xlstm_times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/xlstm_scan.cu",
            "kernel": kern, "replaces": None,
            "note": f"computes the lax.scan of repro/models/ssm.py:{step} "
                    f"over the sequence (no Pallas kernel in the JAX "
                    f"package)",
            "launches": xlstm["prefill_counts"][kname],
            "max_abs_err": t["max_abs_err"],
            "max_abs_err_by_case": t["max_abs_err_by_case"],
            **times_of(t), "device_ms": t["device_ms"],
            "bytes_bound_ms": t["bytes_bound_ms"],
            "us_per_step": t["us_per_step"],
            "err_vs_f64": t["err_vs_f64"],
            "plain_err_vs_f64": t["plain_err_vs_f64"],
            **{k_: t[k_] for k_ in (
                "states_device_ms", "outputs_device_ms", "mirror_ms",
                "chunk_bound_ms", "chunk_bound_by") if k_ in t},
            "train_ms": t["train_ms"],
            "train_device_ms": t["train_device_ms"],
            "train_bound_ms": t["train_bound"]["bound_ms"],
            "f32_tiny_forward_launches": xlstm_f32[kname],
            "train_launches": xlstm_train["counts"][kname],
            "f32_tiny_train_launches": xlstm_f32_train[kname],
            **({"trail_launches": {
                "train": xlstm_train["counts"]["slstm_scan_trails"],
                "f32_tiny_train": xlstm_f32_train["slstm_scan_trails"]}}
               if kname == "slstm_scan" else {}),
            "unit": f"one layer's call at the xlstm-125m prefill path's shape "
                    f"(B={XLSTM_BATCH}, S={XLSTM_SEQ}, H=4, hd=192, f32); "
                    f"launches over {xlstm['calls']} prefills"
                    + (" (a launch of each of its two kernels a call)"
                       if kname == "mlstm_scan" else "")
                    + "; no PyTorch call computes it (library none"
                    + ("; mirror_ms: the chunkwise form in several PyTorch "
                       "calls)" if kname == "mlstm_scan" else ")"),
        })
    # their backwards: no TPU counterpart (the JAX package differentiates
    # the lax.scan); launches over the 6 xlstm train steps (phase 30)
    for kname, kern, step, launches in (
            ("mlstm_scan_bwd", "mlstm_bwd_prep_kernel, "
             "mlstm_bwd_state_kernel, mlstm_bwd_chunk_kernel<hd 192>, "
             "mlstm_bwd_gate_kernel",
             "_mlstm_step",
             {k_: xlstm_train["counts"][k_] for k_ in (
                 "mlstm_scan_bwd_prep", "mlstm_scan_bwd_state",
                 "mlstm_scan_bwd", "mlstm_scan_bwd_gate")}),
            ("slstm_scan_bwd", "slstm_scan_bwd_kernel<hd 192>", "_slstm_step",
             {"slstm_scan_bwd": xlstm_train["counts"]["slstm_scan_bwd"]})):
        t = xlstm_times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/xlstm_scan_bwd.cu",
            "kernel": kern, "replaces": None,
            "note": f"computes jax.grad of the lax.scan of "
                    f"repro/models/ssm.py:{step} (no Pallas kernel in the "
                    f"JAX package)",
            "launches": launches[kname], "launches_by_kernel": launches,
            "max_abs_err": t["max_abs_err"],
            "max_rel_err_by_case": t["max_rel_err_by_case"],
            **{k_: t[k_] for k_ in t if "err_vs_f64" in k_},
            **times_of(t), "device_ms": t["device_ms"],
            "bytes_bound_ms": t["bytes_bound_ms"],
            "us_per_step": t["us_per_step"],
            **({"with_weight_products_ms": t["with_weight_products_ms"]}
               if kname == "slstm_scan_bwd" else {}),
            **{k_: t[k_] for k_ in (
                "prep_device_ms", "state_device_ms", "chunk_device_ms",
                "gate_device_ms", "step_bound_ms", "step_bound_by",
                "step_bytes_bound_ms", "chunk_bound_ms", "chunk_bound_by",
                "chunk_bytes_bound_ms") if k_ in t},
            "mirror_ms": t["mirror_ms"],
            "mirror_max_rel_err": t["mirror_max_rel_err"],
            "f32_tiny_train_launches": {
                k_: xlstm_f32_train[k_] for k_ in launches},
            "unit": f"one layer's backward at the xlstm-125m train path's "
                    f"shape (B={XLSTM_TRAIN_BATCH}, S={XLSTM_TRAIN_SEQ}, "
                    f"H=4, hd=192, f32)"
                    + ("; its four kernels through the wrapper (each alone "
                       "behind a sleep: *_device_ms); bound_ms the smaller "
                       "of step_bound_ms (the step form's work) and "
                       "chunk_bound_ms (the chunkwise kernels')"
                       if kname == "mlstm_scan_bwd" else
                       "; the kernel alone (dW and dbias are an f32 einsum "
                       "outside it)")
                    + f"; launches over the {TRAIN_STEPS} xlstm train steps; "
                    f"no PyTorch call computes it (library none)",
        })
    cell = optimizer["bench qwen2moe-train-b4s2048"]
    kernels.append({
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "kernel": "adamw_norm_kernel, adamw_update_kernel", "replaces": None,
        "note": "the JAX package's clip and AdamW "
                "(repro/train/optimizer.py) are jnp code that XLA fuses",
        "launches": {k_: moe_train["counts"][k_] for k_ in OPTIMIZER_STEP},
        "max_norm_rel_err": max(r["norm_rel_err"]
                                for r in optimizer.values()),
        "device_ms": cell["norm_ms"] + cell["update_ms"],
        "bytes_bound_ms": cell["norm_bound_ms"] + cell["update_bound_ms"],
        "by_leaf_set": optimizer,
        "unit": "one clipped step over the benchmark's training cell's "
                "leaves (each kernel alone, CUDA events); launches over "
                f"phase 15's {TRAIN_STEPS} train steps; p, m and v "
                "bit-equal to the plain loop on every leaf set "
                "(unequal_leaves)",
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
