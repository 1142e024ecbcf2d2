#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):

1. the card (``nvidia-smi`` name and power limit) and the versions of
   torch and CUDA;
2. build every kernel from the sources in this checkout (``nvcc`` for
   ``csrc/*.cu``, the CuTe source ``matmul_wgmma.cu`` with CUTLASS's
   include path) and print the seconds each build took and ptxas's
   register / shared-memory / spill report (for K1 one line: registers
   and spills of each instance of ``csrc/rmsnorm.cu``);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: max abs error against a stated tolerance; the
   device time of one call (CUDA graph replays timed by CUDA events, L2
   warm) of the kernel, of the plain version and of the one PyTorch call
   that computes the same function (timed only; the port never calls it);
   the kernel's time per call made from Python, launch included
   (``eager_ms``); and the least time the card could take (bytes /
   3.35 TB/s or operations / peak rate, the larger); every case names the
   variant its dtype and shape take (K1: ``packed``, ``warp`` or
   ``block`` from ``rmsnorm.plan``, at the six main-path shapes in bf16,
   phase 4b's prefill rows (one request at each bucket) and phase 5's
   shapes in fp32; K3: ``mma`` for bf16, at phase 4's shapes and at phase
   4b's first prefill chunks, ``tf32x3`` for fp32, at the prefill shape,
   at phase 4b's first chunks (the shapes phase 5's fp32 engines give it)
   and at a batch-1 chunk with ``q_offset``, each fp32 case beside its
   max abs error against a float64 attention and the plain version's,
   and a second bound, that of its 3xTF32 work; K2: ``wgmma``, with split
   K below one wave, or ``mma`` for bf16, ``skinny`` or ``tf32x3`` for
   fp32); and decode attention (plain PyTorch) at
   a decode step's shape, the card's bf16-read form against the upcast
   form, both timed;
4. the main path: ``repro_torch.launch.serve``'s code serving qwen3-4b at
   full width (36 layers, d_model 2560, bf16, random weights from a seed)
   to 4 requests (prompts up to 200 tokens, 32 new tokens each, one
   sampled at T=0.8 with top-k 50) through ``BatchedEngine``, its decode
   chunk replayed as a CUDA graph, with every kernel's launch count
   checked against the path's structure, replays included, K1's per
   variant (``packed`` for the 128-wide qk_norm rows, ``warp`` for the
   prefill's d_model rows, ``block`` for a decode step's four) and every
   K3 launch on ``mma``; a third run under ``torch.profiler`` holds the
   K1 and K3 kernels the card ran to the counted launches (short by at
   most the profiler's lost records, ``PROFILER_LOSS``);
4b. continuous serving on the same weights: ``ContinuousEngine`` with 4
   slots, chunk 8, prefill chunk 128, 8 requests (prompts 200 / 151 / 64
   / 23 / 180 / 40 / 97 / 12, so admissions happen mid-run and the 200-,
   180- and 151-token prompts prefill in two chunks; 32 new tokens each,
   one at T=0.8 with top-k 50), KV dense and paged, each with the chunk as
   a CUDA graph (after a warm run that captures, runs only replay) and
   eagerly, the four engines timed three times each in alternating order:
   tokens equal between graph and eager and between the layouts, zero
   re-captures after warm-up, exact K1 / K3 counts with replays counted
   in every run; tok/s with the graph and eager, time to first token at
   the 200-token prompt (median and range), peak memory and the captures
   printed; and the static engine on the same requests (its agreement in bf16 is
   printed: the two round different computations in bf16; phase 5 holds
   them equal in fp32);
5. full width against the CPU: 2 layers at full width in float32 (TF32 off
   for matmuls and cuDNN), the same weights on the card (kernels) and on
   the CPU (plain versions): last-position logits within a stated
   tolerance and identical greedy tokens, every K3 launch on ``tf32x3``
   and no K1 launch on ``packed`` (fp32 rows of 128 are 32 vectors); and
   at all 36 layers in float32 on the card, the continuous engine (dense
   and paged, graphs) against the static engine on phase 4b's traffic:
   equal tokens, the sampled request included, its K3 launches (all
   ``tf32x3``) printed apart from the 2-layer part's;
6. K2, the hand-written matmul, against its plain version at qwen3-4b's
   projection shapes and one ragged shape, in bf16 and fp32 (times as in
   phase 3, the library call being ``torch.matmul``), the regime of each
   asserted and launched (``wgmma`` / ``mma`` for bf16, ``skinny`` /
   ``tf32x3`` for fp32), each case's max abs error against a float64
   product on the card too, and for ``tf32x3`` a second bound, that of
   the work it does (three tensor-core products a product at 495
   TFLOP/s, or bytes); and the tile-width check of ``matmul.plan``: both
   wgmma tile widths timed at the prefill projections;
7. K4, the DPIA pipeline on the card: for each of the paper's BLAS
   strategies at the Fig. 7 sizes and the transformer strategies at
   qwen3-4b's shapes, ``Program(expr, args).check().lower()
   .compile("cuda")`` against ``compile("torch")`` (the plain version) on
   the same CUDA tensors, with the launches per call and each stage's CUDA
   grid asserted against the strategy's top-level grid parfor extents; the
   generated kernels' time and each stage's alone (``stage_ms``), the
   plain version's (one call: it is a python loop), the one PyTorch
   call's, the bound and the bound under the strategy's grid (the
   operations' rate scaled by min(1, blocks / SMs) for the stage with the
   most blocks), the build seconds and ptxas's registers, shared memory and
   spills per stage;
8. Fig. 7 on the card: generated / library time for scal, asum, dot and
   gemv at both sizes (a reproduction, no claim);
9. the main path of the pipeline slice: ``ops.matmul(impl="cuda")`` at
   phase 6's shapes in bf16 and fp32 (every K2 regime and both split
   reductions launched) and every DPIA op through ``impl="dpia-cuda"`` at the
   shapes of phase 7, with K2's and K4's launch counts checked, per K2
   variant too; (b) the same DPIA ops as a user calls them by default
   (``impl="dpia-cuda"``, the tuner on, no measured record): the cuda row
   takes no analytic pick, so each runs phase 9's executor, bitwise, its
   eager time held to the ``autotune=False`` form's;
10. compiler services and obs (``repro_torch.compiler``, ``repro_torch.obs``):
   (a) the DPIA ops of phase 9 under ``compiler.options(backend=
   "dpia-cuda")`` with no ``impl=``: K4's launches the sum of their stages,
   outputs bitwise phase 9's; (b) ``ops.matmul`` under ``options(backend=
   "cuda")``: K2 with phase 9's variants, bitwise phase 9's outputs; (c) the
   executor cache: one build per program, hits after; (d) ``save_aot`` to a
   temporary directory, then a fresh Python process (this script with
   ``--aot-child DIR``) runs ``load_aot`` and the eleven programs: bitwise
   phase 9's outputs, zero ``compiler.lower`` / ``compiler.check`` spans,
   zero ``nvcc`` runs; its load time beside phase 2's cold staging and
   build; (e) right after phase 4b, on its weights: one continuous run
   (dense, graph) repeated with tracing on: phase 4b's tokens and launch
   counts, a Chrome trace that loads with ``json`` and holds
   ``serve.prefill_chunk`` / ``serve.decode_chunk`` spans, submit / admit /
   first_token / retire events in that order for each of the 8 requests,
   8 ``serve.ttft_s`` observations and ``serve.recompiles_after_warm`` 0;
   (f) phase 4's static engine, tok/s with obs disabled and with tracing
   on, three runs each in turns, medians beside the card's name and power
   limit; (g) the quickstart (``repro_torch.examples.quickstart``) on the
   card, its step 5 a measured tune on the card;
11. the autotuner on the card (``repro_torch.autotune``): (a) ``tune(kernel,
   backend="cuda", measure=True, verify=True, top_k=4)`` for scal, asum,
   dot at n = 2**22, rmsnorm (800, 2560), softmax (25600, 200) and matmul
   (1024, 2560, 2560), every picked candidate generated by K4 and the
   picks of all six built in one parallel nvcc batch first; for each
   kernel the candidates enumerated and measured (none dropped but for
   ``NotImplementedError`` or a verify miss), the analytic winner (the
   ``gpu`` preset) and the measured one, the winner's and the default's
   time as CUDA-graph replays, its bound, the ``torch`` call's time, and
   the winner against its plain version within phase 7's tolerance; (b)
   ``obs.audit_cache`` over that cache: whether the analytic ranking
   agrees with the card's, and each timed candidate's time beside the
   cost model's terms (what an ``h100`` preset would be fitted to); (c)
   the same calls again: all cache hits, no ``autotune.measure`` span, no
   nvcc run; (d) the ops under ``options(backend="dpia-cuda",
   autotune=True, tuning_cache=...)``: executor keys carrying the tuned
   params, outputs bitwise the winners', K4's launches the winners'
   stages, and the op table's tuner fallback fired zero times; (e) right
   after phase 4b, on its weights: ``ContinuousEngine(kv_layout="auto")``
   serves 4b's traffic in the layout ``autotune.pick_kv_layout`` picks,
   with 4b's exact K1 / K3 counts and its tokens bit for bit; (f) the
   engines' ``tuning_cache=`` warm-up: a qwen3-4b ``ContinuousEngine``
   built under ``options(backend="dpia-cuda")`` pre-tunes and stages the
   model's op shapes and exports ``<cache>.aot`` holding exactly the keys
   it staged; a second engine, in emptied executor caches, loads them all
   from the store and stages none.  Phases 9
   and 10 run the op rows under ``options(autotune=False)``, at phase 7's
   programs.  Every tuning cache lives in a temporary directory
   (``REPRO_AUTOTUNE_CACHE`` points there for the whole run);
12. serving under faults, right after phase 11e on phase 4's weights:
   phase 4b's engine shape (4 slots, chunk 8, prefill chunk 128, block
   16, the chunk a CUDA graph) on 12 requests (4b's eight prompts and
   120 / 33 / 77 / 150; 32 new tokens each, request 1 at T=0.8, top-k
   50), every run seeded 0 and every drill on a warm engine held bit for
   bit against a fault-free run of the same engine, K1 / K3 counts zeroed
   before each run and read after it: (a) dense, the watchdog at 0.15 s:
   ``serve.nan_prefill`` on request 1, ``serve.nan_decode`` on request
   2, ``serve.chunk_error(times=2)`` (retried), ``serve.slow_chunk`` of
   0.2 s and request 11 at a 1 ms TTFT deadline: the hit requests end
   failed / timeout with their reasons, 2 retries, a straggler, no
   capture; (b) ``serve.chunk_error(times=3)`` past the 2 retries: the
   in-flight requests fail, the chunk's buffers are rebuilt in place
   (same tensors, no capture) and the queued requests are served; (c)
   paged with 32 pages (the queue head defers): ``serve.nan_decode`` on
   request 0 (its pages scrubbed and reissued), then
   ``serve.pool_corrupt`` at boundary 5: one ``degraded(paged->dense)``
   decision and one flight dump, the pending requests served on a new
   capture of the dense chunk, the trash page finite at every paged
   boundary; (d) a dense engine with ``journal=`` abandoned after 4
   boundaries and ``domains.replay`` into a fresh engine, twice: every
   live request's tokens, the journal's bytes and records; (e) tok/s of
   phase 4's static engine with the NaN guard against
   ``nan_guard=False``, and of a dense engine built with ``journal=``
   on phase 4b's traffic with the journal detached and attached, three
   runs each in turns, with the host seconds of the journal's writes;
13. training, right after phase 12 (its serving weights freed): (a) the
   backward kernels of K1 (at (2048, 2560), (65536, 128), (16384, 128))
   and K3 (q (128, 512, 128), kv (32, 512, 128), causal; in bf16 also
   at the ragged S 200) in bf16 and fp32 against their plain versions
   (and K3's row log-sum-exp), bitwise repeatable, with their times,
   bounds, the library's backward (``F.rms_norm``'s, SDPA's), each
   case's plan or variant (K3-bwd: ``mma`` for bf16, ``tf32x3`` for fp32,
   each launch counted; fp32 beside a second bound, that of its 3xTF32
   work) and ptxas's registers and spills of every
   backward instance; qwen3-4b at full width (bf16, 36 layers,
   remat, weights from seed 0, batch 4 x seq 512): (c) one step at
   ``microbatches=2`` on the fresh state (lr 0 at step 0: the params keep
   their bits), its loss within 1e-3 and its gradient norm within 5 % of
   (b)'s first step; (b) ``TrainLoop`` for 6 steps with no checkpoint:
   every leaf's gradient set and finite after step 1, every matrix
   changed after step 2, exact K1 / K3 forward and backward launches a
   step (K3-bwd: 36 ``mma``, 0 ``tf32x3``), step time, tok/s, MFU (6 x
   matmul params x tokens / step time / 989 TFLOP/s) and peak memory;
   (d) a loss that is NaN on the third call: ``applied`` 0, every tensor
   of the state bitwise kept (checksums), one skipped step; (e) this
   script with
   ``--train-child`` in a fresh process (deterministic algorithms,
   ``CUBLAS_WORKSPACE_CONFIG``): 20 smoke-config steps (fp32) equal 10,
   a checkpoint, a restore and 10 more, bitwise, and the card's step-1
   state equals the CPU's; every K3 and K3-bwd launch there is
   ``tf32x3``.
14. the pipeline on a mesh, after phase 11, in ranks spawned by
   ``repro_torch.testing.ranks`` (a failed rank fails the run): (a) one
   NCCL rank (``data=1``): phase 7's programs but gemv as mesh terms
   (default placement) through ``Program.compile("shardmap", mesh=...,
   inner="cuda")``, each shard's body a K4 program built in phase 2, one
   launch a stage and one ``all_reduce`` for dot / asum a call, held to
   the plain version within phase 7's tolerance; (b) two ranks sharing
   the card over gloo (NCCL refuses two ranks on one GPU; gloo takes CUDA
   tensors for ``all_reduce``): the same ops through
   ``compiler.options(backend="dpia-shardmap", mesh=...)``, counts zeroed
   just before and read just after, each rank's ``to_local()`` against its
   slice of the plain version computed whole on the rank, one
   ``all_reduce`` for dot / asum and none for the maps (``torch.profiler``),
   executor keys with ``|shardmap|data=2|`` that ``save_aot`` skips, and
   ``tune("dot", n=2**22, backend="shardmap", mesh=..., measure=True)``
   measured with the same pick on both ranks.  Times: each shard's K4
   device time (graph replays of its launches; in 14b each rank's while
   the other waits), the plain version's and the library call's on the
   shard's inputs, the shard's bound, each op call's time (14b: both
   ranks calling, "two processes sharing one card") and phase 7's
   single-device K4 time beside them;
15. sharded serving (``ShardedEngine``), after phase 14, qwen3-4b at full
   width and depth on phase 4b's traffic and engine shape, in spawned
   ranks (a failed rank fails the run): (a) one NCCL rank (``data=1``),
   bf16, dense and paged: tokens bitwise phase 4b's dense graph run, 4b's
   exact K1 / K3 counts, one ``all_gather`` a boundary, 0 re-captures
   after warm-up, tok/s beside 4b's; then one process in fp32 (TF32 off)
   cut to SHARD_FP32_LAYERS layers, on the same traffic and slots, its
   tokens and tok/s taken and its weights freed; (b) two gloo ranks sharing the card, fp32, 2 slots a
   rank, dense and paged: tokens equal to that process's, each rank's
   K1 / K3 launches exact against its own prefill calls, admissions and
   decode steps (every K3 launch ``tf32x3``), one ``all_gather`` a
   boundary, 0 re-captures after warm-up, per-rank (its own slots'
   tokens) and combined tok/s; (c) a fresh engine on (b)'s ranks, dense
   then paged (the re-placement sends the live slots' pages), with
   ``hosts=2`` and a journal under ``mesh.host_lost(host=1, after=2)``:
   rank 1 leaves, rank 0 serves every request on ``data=1``
   to (b)'s tokens, one host loss, the chunk captured anew at 4 lanes (each
   key once), one ``host_lost`` flight dump, the ``degraded(mesh(data=2)
   ->mesh(data=1))`` origin, a clean journal with one shrink record;
16. training on the data axes (``train.step`` on a mesh), after phase 15,
   in spawned ranks (a failed rank fails the run), K1 / K3 forward and
   backward launches zeroed before each step and checked exactly after it
   on every rank: (a) one NCCL rank (``data=1``), qwen3-4b at full width
   cut to 6 layers, bf16, remat, 13b's batch, lr and warm-up, deterministic
   algorithms: 3 one-device steps, then 3 mesh steps from the same seed-0
   weights, their loss, grad norm and every tensor's bits (checksums)
   equal, step time and peak memory beside 13b's; (b) DP, qwen3-4b cut
   to 1 layer (two fp32 states share the card; 4 until phase 17 came, 2
   until phase 20), and (c) FSDP, yi-9b (``fsdp=True``) cut to 1 layer,
   fp32 with TF32
   off, on two gloo ranks
   sharing the card: rank 0 first runs the one-device step on the same
   global batches (the other waits) and keeps its state on the host; then
   both run 2 mesh steps, each rank's loss, grad norm and lr and every
   leaf (gathered whole) held to it, (c)'s per-rank state bytes to
   ``launch.dryrun.reckon``'s, each rank's collectives, state bytes,
   peak memory and step times printed;
17. training on the model axis (tensor and sequence parallelism), after
   phase 16: (k) K1, K3 and their backward kernels against their plain
   versions at a tensor-parallel rank's shapes in 17a (K1 on the rank's
   sequence rows and its 16 query / 4 kv heads' rows, K3 on those heads at
   S 512; fp32, and K3 in bf16 too), timed as in phases 3 and 13a; then in
   spawned ranks (a failed rank fails the run), fp32 with TF32 off, each
   cut to 1 layer (4 before phase 19 came, 2 before phase 20), on gloo
   ranks sharing the
   card: (a) TP + SP, qwen3-4b
   on ``model=2``, and (b) FSDP + TP, yi-9b (``fsdp=True``) on ``data=2,
   model=2``: rank 0 first runs the one-device step on the same global
   batches (the others wait) and keeps its state on the host; then every
   rank runs 2 mesh steps with K1 / K3 forward and backward launches
   checked exactly a step (the one-device step's), its loss, grad norm and
   lr held to the one-device step's, every leaf gathered whole over both
   axes held to it on rank 0 (16b / 16c's tolerances) and summed alike on
   every rank, its state bytes to ``launch.dryrun.reckon``'s; each rank's
   collectives by group (data, model, world) with their bytes, state
   bytes, peak memory and step times printed;
18. the transformer families, after phase 17, random weights drawn on
   the card from seed 0, K1 / K3 counts zeroed before each counted run
   and checked exactly after it: (a) dbrx-132b (moe: 16 experts top-4)
   at full width cut to 2 layers (15.5 GB), bf16, on phase 4b's traffic
   through ``BatchedEngine`` and ``ContinuousEngine`` (dense and paged,
   the decode chunk a CUDA graph): each engine's second run bitwise its
   first (the sampled request included), dense = paged, tok/s and a
   decode step's device time at 4 lanes (every expert read); then 2
   layers in fp32 (TF32 off), the same weights on the card and on the
   CPU: a right-padded prefill's and one decode step's logits within
   ``LOGIT_TOL``, the same greedy tokens; (b) musicgen-large (audio, 4
   codebooks, head dim 64), 24 of its 48 layers, likewise (no CPU
   part); (c)
   stablelm-1.6b (not cut), qwen1.5-32b and chameleon-34b (8 layers),
   grok-1-314b (2 layers): one static prefill and its 8 decode steps
   each; (k) K1 and K3 at the new shapes (K3 ``mma`` at head dim 64 at
   18b's and 18c's prefills; K1 at d_model 6144 and 2048), timed as in
   phase 3; (d) expert parallelism: dbrx-132b, 1 layer at full width,
   bf16, capacity factor 2 (nothing drops), batch 4 x 128, lr 0, on two
   gloo ranks sharing the card on ``model=2`` against the same step on
   a one-rank ``(1, 1)`` mesh (rank 0 first): loss and grad norm within
   13c's bf16 tolerances, the params bitwise, every moment's error
   printed, each rank's all-to-alls a step (calls and bytes) against the
   prediction, its state bytes against ``launch.dryrun.reckon``'s.  The depth cuts keep
   the part's weights on the card and phase 18 near 4 minutes.
19. the recurrent families, after phase 18, random weights drawn on the
   card from seed 0: (k) K3 at head dim 80 (zamba2's shared attention)
   in all four variants against the plain versions, timed as in phase 3:
   ``mma`` at the static prefill (4 x 32 heads, 200) and at phase 4b's
   batch-1 first chunks, ``tf32x3`` at the static prefill (held to
   float64), both backwards at 19c's (4 x 32, 128), and ptxas's
   registers and spills of every D 80 instance; (a) rwkv6-1.6b (ssm) and
   (b) zamba2-2.7b (hybrid) at full width cut to 6 layers and to 2
   groups (12 mamba layers, 2 shared-attention sites), bf16: phase 4's
   traffic through
   ``BatchedEngine`` and phase 4b's through ``ContinuousEngine``, dense
   and paged, each with the decode chunk a CUDA graph and eagerly: every
   continuous run's tokens equal, zero re-captures after warm-up, exact
   K1 / K3 counts, the recurrent bytes a slot (and zamba2's KV bytes a
   token) against the reckoning, a decode step's device time; then a cut
   (rwkv6 2 layers, zamba2 one group) in fp32 against the CPU as 18a;
   (c) two bf16 remat train steps of each at the same cut, batch
   4 x 64 (the time loops' length cut), with their time, tok/s, peak
   memory and exact K1 / K3 forward and backward launches, and the cut's
   fp32 step
   against the CPU's (loss and gradient norm); (d) FSDP on two gloo
   ranks sharing the card, zamba2 cut to one group, fp32, held to the
   one-device step as 16c (params whose gradient sits at its sums'
   rounding within twice the update), each rank's state bytes against
   the dry run's.  ``tools/recurrent.py`` runs phase 19
   alone.
20. the model axis for the recurrent families and the op counter, after
   phase 19: (k) K1 and its backward at 20a / 20b's rank rows (32 rows of
   2048 / 2560, fp32) and K3 ``tf32x3`` at D 80, forward (held to
   float64 too) and backward, at 20b's rank shape (2 x 16 heads, 32), as
   17k; (a) rwkv6-1.6b (2 layers) and (b) zamba2-2.7b (one group: 6 mamba
   layers, one shared-block site) at full width, TP + SP on ``model=2``,
   fp32, batch 2 x 32, two gloo ranks sharing the card, held to the
   one-device step with 17a's checks (each rank's state bytes against the
   dry run's); (c) ``analysis.hlo_counter`` on the card: 13b's qwen3-4b
   step and 20a's rwkv6 step on each rank, counted with the layers and
   time steps scaled and in full, equal to the same step counted on the
   ``meta`` device (20a's ranks through ``collectives.CountingMesh``),
   and the roofline terms (``analysis.hlo``) beside the measured step
   time.  ``tools/recurrent_tp.py`` runs phase 20 alone.
21. serving with the params split over ``model``, after phase 20: (k) K1
   fp32 at a serving rank's rows (qwen3-4b on ``model=2``: the prefill's
   SP rows, its 16 query / 4 kv heads' rows, a decode step's) and K3
   ``tf32x3`` / ``mma`` on the rank's 16 / 4 heads over phase 4's 200
   positions; (a) qwen3-4b (2 layers) and (b) dbrx-132b (1 layer) at full
   width, fp32, ``data=1, model=2`` on two gloo ranks sharing the card
   (``sharding.serving.ServingStep``: the params and the cache placed by
   the rules), phase 4's prompts right-padded and 4 new tokens
   greedy, each row at its own position: tokens identical to the one-device
   port's on the same weights, first-step logits within
   SERVE_TP_LOGIT_TOL, K1 / K3 launches a rank predicted
   (:func:`serve_tp_launches`), each rank's cache bytes the dry run's;
   21b's MoE runs each rank's experts and all-gathers their outputs, as
   the reference's serving MoE; (c) 21a's decode step counted on each
   rank of the card equal to its count on the ``meta`` device.
   ``tools/serve_tp.py`` runs phase 21 alone.
22. the recurrent families served with the params split over ``model``,
   after phase 21: (k) K1 fp32 on a serving rank's rows (the prefill's SP
   rows of phase 4's 4 x 200 prompt, 400 of 2048 / 2560; a decode step's
   4) and K3 at D 80 (``tf32x3`` fp32, ``mma`` bf16) on 22b's rank's 16 of
   32 shared-block heads over 200 positions, causal; (a) rwkv6-1.6b (2
   layers) and (b) zamba2-2.7b (one group: 6 mamba layers and the shared
   block) at full width, fp32, ``data=1, model=2`` on the shared spawn's
   two gloo ranks, as 21a / 21b: tokens identical to the one-device port's,
   first-step logits within SERVE_TP_LOGIT_TOL, each rank's cache after
   the prefill (the recurrent state in the rules' layout, the hybrid's KV)
   the one-device cache's piece within the same tolerance, each rank's
   cache bytes the dry run's, K1 / K3 launches a rank predicted; (c) 22a's
   decode step counted on each rank of the card equal to its count on the
   ``meta`` device.  ``tools/serve_tp.py --phase 22`` runs phase 22 alone.

The two-rank gloo cells of phases 16-22 (16b / 16c, 17a, 18d, 19d, 20a /
20b, 21a / 21b, 22a / 22b) run after phase 15 in one spawn of two ranks
(:func:`two_rank_cells`; a spawn a cell took the script to 1 151 s on an
NVIDIA H100 80GB HBM3 at 700 W: each spawn costs its processes' start-up
and a process's slow first fp32 step); each phase then checks and logs
its own cells.  ``[phases]`` logs each phase's wall seconds.

All generated programs and the ``csrc/`` kernels build in one parallel
batch in phase 2.  It then prints one ``{"kernels": [...]}`` line (K1, K2,
K3, the backward kernels of K1 and K3 (their launches, and K3-bwd's per
variant, phase 13b's; K3-bwd's per variant in 13e too, as
``launches_13e``, and K3's fp32 variant's in phases 5 and 13e, as
``launches_phase5`` and ``launches_13e``), one entry per generated K4 program of phase 7 and
one per tuned winner of phase 11, one ``dpia_cuda:mesh_<op>`` per mesh op
of phase 14; K1's and K3's ``launches_phase15`` by run and rank; K1's, K3's
and their backward kernels' ``launches_phase16`` and ``launches_phase17``,
a step, by part and rank; K1's and K3's ``launches_phase18`` by part:
18a / 18b by engine, 18c by arch, 18d's ranks a step with the backward
kernels'; ``launches_phase19`` likewise: 19a / 19b by engine, 19c by
arch, 19d's ranks; ``launches_phase20``, 20a's and 20b's ranks a step;
``launches_phase21``, 21a's and 21b's ranks a run; ``launches_phase22``,
22a's and 22b's ranks a run; phase 17k's, 18k's, 19k's, 20k's, 21k's and
22k's cases among their ``cases``), the
card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``; ``[12] summary`` and
``[13] summary`` lines before them gather phases 12 and 13.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core rate
              torch.float32: 67e12}     # fp32 outside the tensor cores
TF32_FLOPS = 495e12              # dense TF32 tensor-core rate
ELEMENTWISE_FLOPS = 67e12        # fp32 on the CUDA cores

# Kernel against plain version on the card, |err| <= atol + rtol * |plain|.
# fp32: the same fp32 arithmetic in another summation order.  bf16: both
# round the same fp32 value to bf16, so a rounding flip costs one bf16 ulp
# (2**-8 relative).
TOLS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}

# K2 against its plain version (phase 6): fp32 sums over K = 2560 in
# another order than cuBLAS (inputs scaled by K**-0.25, so |C| ~ 1); bf16
# output: one rounding of nearly the same fp32 value
MM_TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
MM_SHAPES = [(800, 2560, 4096), (800, 2560, 9728), (4, 2560, 4096),
             (37, 100, 75)]
# phase 9's K2 calls: every shape in both dtypes, so that every regime
# (wgmma and its reduction, mma; skinny and its reduction, tf32x3) runs
MM_CALLS = [(m, k, n, dt) for dt in (torch.bfloat16, torch.float32)
            for m, k, n in MM_SHAPES]

# K4 programs (phase 7): kernel, shape.  Fig. 7 sizes
# (benchmarks/fig7_overhead.py:25-26) and qwen3-4b's shapes.
FIG7_N = (1 << 20, 1 << 22)
FIG7_GEMV = ((1024, 1024), (2048, 2048))
DPIA_CASES = ([("scal", dict(n=n)) for n in FIG7_N]
              + [("asum", dict(n=n)) for n in FIG7_N]
              + [("dot", dict(n=n)) for n in FIG7_N]
              + [("gemv", dict(m=m, n=n)) for m, n in FIG7_GEMV]
              + [("rmsnorm", dict(rows=800, d=2560, eps=1e-6)),
                 ("softmax", dict(rows=25600, d=200)),
                 ("matmul", dict(m=1024, k=2560, n=2560))])

# main path (phase 4)
ARCH = "qwen3_4b"
PROMPT_LENS = (200, 151, 64, 23)
MAX_NEW = 32
CHUNK = 8
# continuous serving (phase 4b): request 1 samples at T=0.8, top-k 50
CONT_PROMPT_LENS = (200, 151, 64, 23, 180, 40, 97, 12)
SLOTS = 4
PREFILL_CHUNK = 128
BLOCK = 16
CONT_ROUNDS = 3    # timed runs of each continuous engine, in turns
# full width against the CPU (phase 5): fp32 on both sides, TF32 off; the
# sums run in other orders over K = 2560 / 9728, so logits of order 1
# differ by ~1e-5
CPU_LAYERS = 2
CPU_PROMPT_LENS = (100, 37)
CPU_MAX_NEW = 6
LOGIT_TOL = 1e-3
# no path but training launches a backward kernel: every exact count of
# the serving and pipeline phases holds them at 0
NO_BWD = {"rmsnorm_bwd": 0, "flash_attention_bwd": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, trials: int = 7, stream=None) -> float:
    """Device time of one call: the median over ``trials`` replays of a
    CUDA graph holding ``reps`` back-to-back calls, from CUDA events, after
    a warm-up.  Replaying a graph takes the host's launch cost out, so a
    kernel of a few microseconds is timed by its work on the card.
    ``stream``: warm up and capture on that stream (a backward pass must
    run on the stream of its forward)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def eager_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Time of one call made from Python, launch included: the median over
    ``trials`` of the mean of ``reps`` back-to-back calls, from CUDA
    events.  For a kernel shorter than its launch this is the host's cost
    of a call, not the kernel's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_close(got, want, dtype, what: str) -> float:
    atol, rtol = TOLS[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond "
                             f"atol {atol} + rtol {rtol}; max abs err "
                             f"{err.max().item()}")
    return err.max().item()


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.dpia import stage3_cuda
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()      # Stage I/II, the SCIR check and codegen
    progs = {ops.program_name(k, **sh): ops.compiled(k, "cuda", **sh)._fn
             for k, sh in DPIA_CASES}
    stage_s = time.perf_counter() - t0
    # phase 14's K4 shards: built here, found by its ranks
    mesh_progs = mesh_shard_programs()
    plain = [n for n in _build.sources() if n not in _build.SOURCE_FLAGS]
    cute = sorted(_build.SOURCE_FLAGS)
    with ThreadPoolExecutor(3) as pool:      # every nvcc starts at once
        csrc = pool.submit(_build.build, plain)
        cute_f = pool.submit(_build.build, cute)
        gen = pool.submit(stage3_cuda.build_all,
                          list(progs.values()) + mesh_progs)
        secs, cute_secs, gen_secs = (csrc.result(), cute_f.result(),
                                     gen.result())
    log(f"[2] staged {len(progs)} DPIA programs (Stage I/II, SCIR check, "
        f"CUDA codegen) in {stage_s:.3f} s")
    log(f"[2] nvcc built {plain} in {secs:.2f} s, the CuTe source(s) "
        f"{cute} in {cute_secs:.2f} s (flags beyond the common ones: "
        f"{ {n: ' '.join(_build.SOURCE_FLAGS[n]) for n in cute} }; CUTLASS "
        f"include path {_build.CUTLASS_INCLUDE}) and {len(progs)} generated "
        f"DPIA programs with phase 14's {len(mesh_progs)} K4 shard programs "
        f"in {gen_secs:.2f} s, in parallel (0 means already built)")
    for src in _build.sources():
        if src == "rmsnorm":
            continue
        kernel = None
        for line in _build.target(src).with_suffix(".log").read_text(
                ).splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"    ptxas {src} {kernel}: {line.strip()}")
    # dynamic shared memory, which ptxas does not see: the sources report it
    import ctypes

    from repro_torch.kernels import flash_attention as fa
    fa_lib = _build.library("flash_attention")
    fa_smem = fa_lib.repro_flash_attention_mma_smem
    fa_tf32_smem = fa_lib.repro_flash_attention_tf32_smem
    fa_bwd_smem = fa_lib.repro_flash_attention_bwd_mma_smem
    mm_smem = _build.library("matmul_wgmma").repro_matmul_wgmma_smem
    for fn in (fa_smem, fa_tf32_smem, fa_bwd_smem, mm_smem):
        fn.argtypes = [ctypes.c_int]
    dims = fa.SUPPORTED_HEAD_DIMS
    log(f"[2] dynamic shared memory: flash_fwd_mma "
        f"{ {d: fa_smem(d) for d in dims} } B by head dim; "
        f"flash_fwd_tf32 "
        f"{ {d: fa_tf32_smem(d) for d in dims} } B; "
        f"flash_bwd_dkv_mma and flash_bwd_dq_mma "
        f"{ {d: fa_bwd_smem(d) for d in dims} } B each; "
        f"gemm_wgmma { {bn: mm_smem(bn) for bn in (128, 256)} } B by tile "
        f"width")
    k1 = k1_ptxas(_build.target("rmsnorm").with_suffix(".log").read_text())
    log("[2] ptxas rmsnorm [registers, spill stores, spill loads] by "
        "instance (dtype, elements an access, threads a row, accesses a "
        "thread): " + json.dumps(k1))
    return gen_secs, k1, stage_s


def k1_instance(p, dtype) -> str:
    """The name :func:`k1_ptxas` gives the kernel instance plan ``p``
    launches."""
    per = (16 // (4 if dtype == torch.float32 else 2)) if p.vector else 1
    tpr = 0 if p.variant == "block" else p.threads_per_row
    return (f"{'fp32' if dtype == torch.float32 else 'bf16'} n{per} "
            f"tpr{tpr} vpt{p.vectors_per_thread}")


def k1_ptxas(log_text: str) -> dict:
    """[registers, spill store bytes, spill load bytes] of every instance
    of ``rmsnorm_kernel<T, N, TPR, VPT>`` in a ``-Xptxas -v`` log."""
    from repro_torch.kernels import _build
    rep = _build.ptxas_report(log_text, r"rmsnorm_kernelI(f|13__nv_bfloat16)"
                                        r"Li(\d+)ELi(\d+)ELi(\d+)E")
    return {f"{'fp32' if t == 'f' else 'bf16'} n{n} tpr{tpr} vpt{vpt}":
            [r.get("registers"), r.get("spill_stores", 0),
             r.get("spill_loads", 0)]
            for (t, n, tpr, vpt), r in rep.items()}


def _rmsnorm_case(rows, d, dtype, gen, k1):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rms
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=gen,
                               device="cuda")).to(dtype)
    p = rms.plan(rows, d, dtype)
    ptx = k1.get(k1_instance(p, dtype))
    if ptx is None or ptx[1] or ptx[2]:
        raise AssertionError(f"rmsnorm {(rows, d)} {dtype}: ptxas "
                             f"[registers, spill stores, spill loads] of "
                             f"{k1_instance(p, dtype)}: {ptx}")
    before = rms.launches_by_variant[p.variant]
    err = check_close(ops.rmsnorm(x, w), ref.rmsnorm(x, w), dtype,
                      f"rmsnorm {(rows, d)} {dtype}")
    if rms.launches_by_variant[p.variant] != before + 1:
        raise AssertionError(f"rmsnorm {(rows, d)} {dtype}: {p.variant} was "
                             f"not launched")
    elt = x.element_size()
    b_ms, b_by = bound(2 * rows * d * elt + d * elt, 4 * rows * d,
                       ELEMENTWISE_FLOPS)
    return {"shape": [rows, d], "dtype": str(dtype).split(".")[-1],
            "variant": p.variant, "vector": p.vector,
            "threads_per_row": p.threads_per_row,
            "vectors_per_thread": p.vectors_per_thread,
            "rows_per_block": p.rows_per_block, "grid": p.grid,
            "ptxas": ptx,
            "max_abs_err": err, "tol": list(TOLS[dtype]),
            "ms": time_ms(lambda: ops.rmsnorm(x, w)),
            "eager_ms": eager_ms(lambda: ops.rmsnorm(x, w)),
            "plain_ms": time_ms(lambda: ref.rmsnorm(x, w)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}


def attention_f64(q, k, v, causal, q_offset):
    """Attention of ``q`` (BH, Sq, D), ``k`` / ``v`` (BKV, Sk, D) in float64,
    causal on absolute positions ``q_offset + row``: what a fp32 kernel's
    and the plain version's errors are measured against."""
    group = q.shape[0] // k.shape[0]
    q64 = q.double()
    k64 = k.double().repeat_interleave(group, dim=0)
    v64 = v.double().repeat_interleave(group, dim=0)
    s = q64 @ k64.transpose(1, 2) / math.sqrt(q.shape[-1])
    if causal:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        keys = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(keys > q_offset + rows, float("-inf"))
    return torch.softmax(s, dim=-1) @ v64


def _flash_case(sq, sk, causal, q_offset, gen, b=4, nh=32, nkv=8, hd=128,
                dtype=torch.bfloat16, f64_check=False):
    """One K3 case on the card; ``f64_check`` (fp32): fail if the kernel's
    error against float64 is above 2 x the plain version's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q = (0.5 * torch.randn((b * nh, sq, hd), generator=gen,
                           device="cuda")).to(dtype)
    k = (0.5 * torch.randn((b * nkv, sk, hd), generator=gen,
                           device="cuda")).to(dtype)
    v = torch.randn((b * nkv, sk, hd), generator=gen,
                    device="cuda").to(dtype)
    kw = dict(causal=causal, q_offset=q_offset)
    variant = fa.variant(dtype)
    before = fa.launches_by_variant[variant]
    got, want = ops.flash_attention(q, k, v, **kw), ref.flash_attention(
        q, k, v, **kw)
    if fa.launches_by_variant[variant] != before + 1:
        raise AssertionError(f"flash_attention sq={sq} sk={sk} {kw}: "
                             f"{variant} was not launched")
    err = check_close(got, want, dtype,
                      f"flash_attention sq={sq} sk={sk} {kw}")
    # the library call: same function in (b, heads, s, hd) layout; causal
    # SDPA is top-left aligned, right for q_offset 0 with sq == sk; a single
    # last-position query attends to every key; any other causal offset
    # takes an explicit mask
    lib_causal = causal and sq == sk and q_offset == 0
    mask = None
    if causal and not lib_causal and not (sq == 1 and q_offset == sk - 1):
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device="cuda").tril(q_offset)
    q4 = q.view(b, nh, sq, hd)
    k4, v4 = k.view(b, nkv, sk, hd), v.view(b, nkv, sk, hd)
    pairs = (sum(min(q_offset + r + 1, sk) for r in range(sq)) if causal
             else sq * sk)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * b * nh * hd * pairs
    b_ms, b_by = bound(nbytes, flops, PEAK_FLOPS[dtype])
    case = {"q": [b * nh, sq, hd], "kv": [b * nkv, sk, hd],
            "causal": causal, "q_offset": q_offset, "variant": variant,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "tol": list(TOLS[dtype]),
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "eager_ms": eager_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v, **kw)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, is_causal=lib_causal,
                enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}
    if variant == "tf32x3":
        # what 3xTF32 keeps: the error against float64, beside the plain
        # fp32 version's; and the bound of the work it does (three TF32
        # products a product)
        exact = attention_f64(q, k, v, causal, q_offset)
        case["max_abs_err_f64"] = (got.double() - exact).abs().max().item()
        case["plain_max_abs_err_f64"] = (want.double() - exact).abs(
            ).max().item()
        if f64_check and \
                case["max_abs_err_f64"] > 2 * case["plain_max_abs_err_f64"]:
            raise AssertionError(f"flash_attention sq={sq} sk={sk} {kw}: "
                                 f"float64 error {case['max_abs_err_f64']} "
                                 f"above 2 x the plain version's "
                                 f"{case['plain_max_abs_err_f64']}")
        case["bound_3xtf32_ms"], case["bound_3xtf32_by"] = bound(
            nbytes, 3 * flops, TF32_FLOPS)
    return case


def rms_shapes(b: int, s: int):
    """K1's shapes in one prefill of ``b`` x ``s`` tokens and one decode
    step of qwen3-4b: d_model rows, then the qk_norm's q and k rows."""
    return [(b * s, 2560), (b * s * 32, 128), (b * s * 8, 128),
            (b, 2560), (b * 32, 128), (b * 8, 128)]


def continuous_buckets():
    """Phase 4b's prefill calls, each a batch of 1 padded to its bucket:
    the buckets of every call (K1) and of the first chunks (K3; a
    continuation chunk attends through the plain masked attention)."""
    from repro_torch.serve.scheduler import pick_bucket, seq_buckets
    buckets = seq_buckets(PREFILL_CHUNK)      # the engine's min_bucket 16
    first = {pick_bucket(min(n, PREFILL_CHUNK), buckets)
             for n in CONT_PROMPT_LENS}
    return sorted(set(_prefill_rows(buckets))), sorted(first)


def phase_kernels(k1):
    gen = torch.Generator(device="cuda").manual_seed(0)
    every, first = continuous_buckets()
    # the main path's shapes in bf16 (phase 4, then phase 4b's prefill
    # rows: its decode steps have phase 4's), phase 5's in fp32
    rms = ([_rmsnorm_case(r, d, torch.bfloat16, gen, k1)
            for r, d in rms_shapes(len(PROMPT_LENS), max(PROMPT_LENS))]
           + [_rmsnorm_case(r, d, torch.bfloat16, gen, k1)
              for s in every for r, d in rms_shapes(1, s)[:3]]
           + [_rmsnorm_case(r, d, torch.float32, gen, k1)
              for r, d in rms_shapes(len(CPU_PROMPT_LENS),
                                     max(CPU_PROMPT_LENS))])
    s_main = max(PROMPT_LENS)
    fa = [_flash_case(s, s, causal, 0, gen)
          for s in (s_main, 128, 100) for causal in (True, False)]
    fa.append(_flash_case(1, s_main, True, s_main - 1, gen))
    # phase 4b's first prefill chunks: one request at each bucket
    fa += [_flash_case(s, s, True, 0, gen, b=1) for s in first]
    # the fp32 variant (tf32x3) at the prefill shape, at phase 4b's first
    # chunks (the shapes of phase 5's 36-layer fp32 engines) and at a
    # batch-1 chunk with q_offset: the last 72 of a 200-token prompt
    f32 = torch.float32
    fa.append(_flash_case(s_main, s_main, True, 0, gen, dtype=f32,
                          f64_check=True))
    fa += [_flash_case(s, s, True, 0, gen, b=1, dtype=f32) for s in first]
    fa.append(_flash_case(s_main - PREFILL_CHUNK, s_main, True,
                          PREFILL_CHUNK, gen, b=1, dtype=f32))
    for name, cases in (("rmsnorm", rms), ("flash_attention", fa)):
        for c in cases:
            log(f"[3] {name} " + json.dumps(c))
    log("[3] decode attention " + json.dumps(_decode_attention_case(gen)))
    return {"rmsnorm": rms, "flash_attention": fa}


def _decode_attention_case(gen):
    """Decode attention (plain PyTorch, no kernel of the port) at a decode
    step of phases 4 and 4b, one layer, bf16: the card's form (the cache
    read in bf16 by two fp32-out GEMMs) against the upcast form (the CPU's
    plain version) on the same card tensors, timed in turns in one call."""
    from repro_torch.configs import config
    from repro_torch.models import attention as attn
    cfg = config(ARCH)
    b, t = SLOTS, continuous_max_seq()
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf = torch.bfloat16
    q = (0.3 * torch.randn((b, 1, nh, hd), generator=gen,
                           device="cuda")).to(bf)
    k = (0.3 * torch.randn((b, t, nkv, hd), generator=gen,
                           device="cuda")).to(bf)
    v = torch.randn((b, t, nkv, hd), generator=gen, device="cuda").to(bf)
    pos = torch.tensor([t - 1, 150, 60, 20][:b], device="cuda")
    forms = {"card": lambda: attn._token_attention(cfg, q, k, v, pos, True),
             "upcast": lambda: attn._token_attention(cfg, q, k, v, pos, True,
                                                     upcast=True)}
    # the same products in another order; probabilities rounded to bf16
    err = check_close(forms["card"](), forms["upcast"](), bf,
                      "decode attention, card form against upcast form")
    ms = {"card": [], "upcast": []}
    for form in ("card", "upcast", "upcast", "card"):
        ms[form].append(time_ms(forms[form]))
    return {"q": [b, 1, nh, hd], "kv": [b, t, nkv, hd], "dtype": "bfloat16",
            "max_abs_err": err, "tol": list(TOLS[bf]),
            "ms_card": ms["card"], "ms_upcast": ms["upcast"],
            "layers": cfg.n_layers}


# torch.profiler's kernel records of a long run fall short of what ran,
# though every run launches the same kernels (tools/profiler_loss.py
# measures the loss on the card): a K1 or K3 count may be short by this
# share of the counted launches, plus one
PROFILER_LOSS = 1e-3


def device_checked(run, what: str):
    """``run()`` under torch.profiler, and the K1 and K3 kernels the card
    ran in it (by kernel name; a CUDA graph's replayed kernels are traced
    one by one) held to ``ops.launch_counts()`` read after the run: the
    host's counts, replays included, against the device's.  The profiler
    loses a few records of a long run (PROFILER_LOSS), so the device's
    count may fall short by that much and never exceed the host's.
    Returns ``run()``'s result and the device's counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
        time.sleep(0.2)     # the last kernels' records land in the window
    dev = {"rmsnorm": 0, "flash_attention": {"mma": 0, "tf32x3": 0}}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "rmsnorm_kernel" in e.key:
            dev["rmsnorm"] += e.count
        elif "flash_fwd_mma" in e.key:
            dev["flash_attention"]["mma"] += e.count
        elif "flash_fwd_tf32" in e.key:
            dev["flash_attention"]["tf32x3"] += e.count
    host = {"rmsnorm": ops.launch_counts()["rmsnorm"],
            "flash_attention": ops.launch_counts_by_variant()[
                "flash_attention"]}
    pairs = [(dev["rmsnorm"], host["rmsnorm"])] + [
        (dev["flash_attention"][v], host["flash_attention"][v])
        for v in ("mma", "tf32x3")]
    if dev["rmsnorm"] == 0 or any(
            not 0 <= h - d <= PROFILER_LOSS * h + 1 for d, h in pairs):
        raise AssertionError(f"{what}: kernels on the card (torch.profiler) "
                             f"{dev} != the counted launches {host}")
    return out, dev


def phase_main_path(smi: str):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import BatchedEngine
    t0 = time.perf_counter()
    cfg, model, params = serve.build(ARCH, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[4] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}, {n_params / 1e9:.3f} B params initialised on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    reqs = serve.make_requests(cfg.vocab, PROMPT_LENS, MAX_NEW, seed=1)
    reqs[1].temperature, reqs[1].top_k = 0.8, 50
    engine = BatchedEngine(model, params,
                           max_seq=max(PROMPT_LENS) + MAX_NEW + CHUNK,
                           chunk=CHUNK)
    warm = engine.run(reqs)          # warm-up: cuBLAS, allocator, capture
    torch.cuda.synchronize()
    before = engine.stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    variants = ops.launch_counts_by_variant()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    if after["captures"] != before["captures"] or after["captures"] != 1:
        raise AssertionError(f"captures {before['captures']} -> "
                             f"{after['captures']}: the measured run must "
                             f"only replay the one (batch, chunk, sampled) "
                             f"graph")
    per_pass = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    want = {"flash_attention": cfg.n_layers * prefills,
            "rmsnorm": per_pass * (prefills + steps),
            "matmul": 0, "dpia_cuda": 0, **NO_BWD}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want} for "
                             f"{prefills} prefill(s), {steps} decode steps")
    # K1: the qk_norm's 128-wide q and k rows (2 a layer) packed; the
    # d_model rows (2 a layer + the final norm) a warp each in the prefill
    # (4 x 200 rows), a block each in a decode step (4 rows: too few to
    # give every SM a warp)
    want_k1 = {"packed": 2 * cfg.n_layers * (prefills + steps),
               "warp": (2 * cfg.n_layers + 1) * prefills,
               "block": (2 * cfg.n_layers + 1) * steps}
    if variants["rmsnorm"] != want_k1:
        raise AssertionError(f"K1 variants {variants['rmsnorm']} != "
                             f"{want_k1}")
    if variants["flash_attention"] != {"mma": cfg.n_layers * prefills,
                                       "tf32x3": 0}:
        raise AssertionError(f"K3 variants {variants['flash_attention']}: "
                             f"every bf16 prefill launch must take mma")
    if outs != warm:
        raise AssertionError("two runs of the same requests and seed gave "
                             "different tokens")
    for o in outs:
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab for t in o):
            raise AssertionError(f"bad output {o}")
    n_tok = sum(len(o) for o in outs)
    log(f"[4] served {len(reqs)} requests (prompts {list(PROMPT_LENS)}, "
        f"{MAX_NEW} new each, request 1 at T=0.8 top-k 50): {n_tok} tokens "
        f"in {dt:.3f} s = {n_tok / dt:.1f} tok/s, 1 prefill + {steps} decode "
        f"steps in {after['chunks'] - before['chunks']} chunks, each a "
        f"replay of the graph {after['graph_keys']}; max memory "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {counts} (rmsnorm = {per_pass} x (prefills + steps), "
        f"flash = {cfg.n_layers} x prefills, variants "
        f"{variants['flash_attention']}, K1 variants "
        f"{variants['rmsnorm']}); card {smi}")
    for i, o in enumerate(outs):
        log(f"    request[{i}] ({PROMPT_LENS[i]} prompt tokens): {o[:10]}")
    ops.reset_launch_counts()
    prof_outs, dev = device_checked(lambda: engine.run(reqs), "phase 4")
    if prof_outs != outs or ops.launch_counts() != counts:
        raise AssertionError(f"phase 4 under the profiler: launches "
                             f"{ops.launch_counts()} != {counts}, or other "
                             f"tokens")
    counted = {"rmsnorm": counts["rmsnorm"],
               "flash_attention": variants["flash_attention"]}
    log(f"[4] a third run under torch.profiler: the card ran {dev} K1 / K3 "
        f"kernels against the counted launches with replays {counted}")
    return (counts, {k: variants[k] for k in ("rmsnorm", "flash_attention")},
            (cfg, model, params), (engine, reqs, outs))


def continuous_requests(vocab: int):
    """Phase 4b's traffic (and phase 5's, at 2 layers)."""
    from repro_torch.launch import serve
    reqs = serve.make_requests(vocab, CONT_PROMPT_LENS, MAX_NEW, seed=3)
    reqs[1].temperature, reqs[1].top_k = 0.8, 50
    return reqs


def continuous_max_seq() -> int:
    return -(-(max(CONT_PROMPT_LENS) + MAX_NEW + CHUNK) // BLOCK) * BLOCK


def continuous_engine(model, params, layout: str, graph: bool, **kw):
    from repro_torch.serve.engine import ContinuousEngine
    return ContinuousEngine(model, params, max_seq=continuous_max_seq(),
                            slots=SLOTS, chunk=CHUNK, kv_layout=layout,
                            block_size=BLOCK, prefill_chunk=PREFILL_CHUNK,
                            graph=graph, **kw)


def norms_a_pass(cfg) -> int:
    """K1 launches on d_model rows in one forward pass: two a block and
    the final norm; the hybrid's one a mamba layer, two a shared-block
    site and the final norm (its gated norm is inline arithmetic, not
    K1)."""
    if cfg.family == "hybrid":
        return cfg.n_layers + 2 * (cfg.n_layers // cfg.attn_every) + 1
    return 2 * cfg.n_layers + 1


def attention_sites(cfg) -> int:
    """K3 launches in one prefill (one a layer; the hybrid's one a shared
    site; none for ssm)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _prefill_rows(buckets):
    """The row count of each prefill call phase 4b's traffic makes: chunks
    of the largest bucket, the tail padded to the smallest that fits."""
    from repro_torch.serve.scheduler import pick_bucket
    rows = []
    for n in CONT_PROMPT_LENS:
        for start in range(0, n, buckets[-1]):
            rows.append(pick_bucket(min(n - start, buckets[-1]), buckets))
    return rows


def _continuous_run(engine, reqs, cfg):
    """One timed run of ``reqs``; the launch counts checked against the
    run's prefill calls, admissions and decode steps, replays included."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    torch.cuda.synchronize()
    before = engine.stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_results(reqs, seed=5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, variants = ops.launch_counts(), ops.launch_counts_by_variant()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    admits = after["scheduler"]["admits"] - before["scheduler"]["admits"]
    rows = _prefill_rows(engine.buckets)
    if prefills != len(rows) or admits != len(reqs):
        raise AssertionError(f"{prefills} prefill calls for {admits} "
                             f"admissions; want {len(rows)} for {len(reqs)}")
    # qk_norm's q and k rows (2 a layer, packed) where the config has it
    qk = 2 * cfg.n_layers if cfg.qk_norm else 0
    per_pass = qk + norms_a_pass(cfg)
    want = {"flash_attention": attention_sites(cfg) * admits,
            "rmsnorm": per_pass * (prefills + steps),
            "matmul": 0, "dpia_cuda": 0, **NO_BWD}
    want_k1 = {"packed": qk * (prefills + steps), "warp": 0, "block": 0}
    for r in rows + [SLOTS] * steps:     # the d_model rows of each pass
        want_k1[rms.plan(r, cfg.d_model, cfg.torch_dtype).variant] += \
            norms_a_pass(cfg)
    if counts != want or variants["rmsnorm"] != want_k1 or \
            variants["flash_attention"] != {
                "mma": want["flash_attention"], "tf32x3": 0}:
        raise AssertionError(f"{engine.kv_layout}: launches {counts} != "
                             f"{want}, K1 {variants['rmsnorm']} != {want_k1}, "
                             f"K3 {variants['flash_attention']}")
    toks = [list(r.tokens) for r in results]
    for o in toks:
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab for t in o):
            raise AssertionError(f"bad output {o}")
    return toks, {"tok_s": sum(map(len, toks)) / dt, "s": dt,
                  "ttft_200_s": results[0].ttft_s,
                  "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "prefills": prefills, "steps": steps,
                  "chunks": after["chunks"] - before["chunks"],
                  "launches": counts, "k1_variants": variants["rmsnorm"]}


def phase_continuous(smi: str, cfg, model, params):
    """Four engines (dense / paged, graph / eager) on one traffic, in
    CONT_ROUNDS rounds of alternating order: every run's tokens equal, and
    the median and range of each engine's tok/s and TTFT."""
    from repro_torch.serve.engine import BatchedEngine
    reqs = continuous_requests(cfg.vocab)
    engines = {}
    for layout in ("dense", "paged"):
        graph = continuous_engine(model, params, layout, graph=True)
        graph.run(reqs, seed=5)           # warm-up: captures every key
        engines[(layout, "graph")] = graph
        engines[(layout, "eager")] = continuous_engine(model, params, layout,
                                                       graph=False)
    want, runs = None, {key: [] for key in engines}
    for r in range(CONT_ROUNDS):
        for key in (list(engines) if r % 2 == 0 else reversed(engines)):
            toks, rep = _continuous_run(engines[key], reqs, cfg)
            if want is None:
                want = toks
            elif toks != want:
                raise AssertionError(f"{key} round {r}: tokens {toks} != "
                                     f"{want} (graph, eager and the layouts "
                                     f"must agree)")
            runs[key].append(rep)
    report = {}
    for (layout, mode), reps in runs.items():
        st = engines[(layout, mode)].stats()
        if mode == "graph" and (st["recaptures_after_warm"]
                                or st["captures"] > 2):
            raise AssertionError(f"{layout}: {st['captures']} captures, "
                                 f"{st['recaptures_after_warm']} after "
                                 f"warm-up: {st['graph_keys']}")
        tok_s = [x["tok_s"] for x in reps]
        ttft = [x["ttft_200_s"] for x in reps]
        report[f"{layout} {mode}"] = {
            "tok_s_median": statistics.median(tok_s), "tok_s": tok_s,
            "ttft_200_s_median": statistics.median(ttft), "ttft_200_s": ttft,
            "max_memory_gib": max(x["max_memory_gib"] for x in reps),
            **{k: reps[0][k] for k in ("prefills", "steps", "chunks",
                                       "launches", "k1_variants")},
            **({"captures": st["captures"], "graph_keys": st["graph_keys"],
                "recaptures_after_warm": st["recaptures_after_warm"]}
               if mode == "graph" else {})}
        log(f"[4b] {layout} {mode}: " + json.dumps(report[f"{layout} {mode}"]))
    dense_graph = engines[("dense", "graph")]
    del engines
    static = BatchedEngine(model, params,
                           max_seq=max(CONT_PROMPT_LENS) + MAX_NEW + CHUNK,
                           chunk=CHUNK)
    static_toks = static.run(reqs, seed=5)
    agree = [next((j for j, (a, b) in enumerate(zip(c, s)) if a != b), None)
             for c, s in zip(want, static_toks)]
    del static
    torch.cuda.empty_cache()
    log(f"[4b] continuous vs static engine in bf16, first differing token "
        f"per request (None: all {MAX_NEW} equal): {agree}")
    for layout in ("dense", "paged"):
        g, e = report[f"{layout} graph"], report[f"{layout} eager"]
        log(f"[4b] {layout}, {CONT_ROUNDS} runs each, median [min, max]: "
            f"tok/s graph {g['tok_s_median']:.1f} [{min(g['tok_s']):.1f}, "
            f"{max(g['tok_s']):.1f}], eager {e['tok_s_median']:.1f} "
            f"[{min(e['tok_s']):.1f}, {max(e['tok_s']):.1f}]; ttft at the "
            f"200-token prompt graph {g['ttft_200_s_median']:.4f} s "
            f"[{min(g['ttft_200_s']):.4f}, {max(g['ttft_200_s']):.4f}], eager "
            f"{e['ttft_200_s_median']:.4f} s [{min(e['ttft_200_s']):.4f}, "
            f"{max(e['ttft_200_s']):.4f}]; max memory "
            f"{g['max_memory_gib']:.2f} GiB; captures {g['captures']} "
            f"{g['graph_keys']}; card {smi}")
    return report, (dense_graph, reqs, want)


def _tensors(node):
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, list):
        for v in node:
            yield from _tensors(v)


def _to(node, device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node


def phase_against_cpu():
    from repro_torch.configs import config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import BatchedEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = config(ARCH, n_layers=CPU_LAYERS, dtype="float32", use_flash=True)
    model = Model(cfg)
    p_cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    p_gpu = _to(p_cpu, "cuda")
    reqs = serve.make_requests(cfg.vocab, CPU_PROMPT_LENS, CPU_MAX_NEW,
                               seed=2)
    b, s = len(reqs), max(CPU_PROMPT_LENS)
    tokens = torch.zeros((b, s), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, :len(r.prompt)] = r.prompt
    lengths = torch.tensor(CPU_PROMPT_LENS)
    ops.reset_launch_counts()
    logits = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        with torch.inference_mode():
            cache = model.init_cache(b, s, device=dev)
            logits[dev], _ = model.prefill(params, tokens.to(dev), cache,
                                           lengths=lengths.to(dev))
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    if not err <= LOGIT_TOL:
        raise AssertionError(f"full-width logits: card vs CPU max abs err "
                             f"{err} > {LOGIT_TOL}")
    max_seq = s + CPU_MAX_NEW + 2
    toks = {dev: BatchedEngine(model, params, max_seq=max_seq,
                               chunk=4).run(reqs)
            for dev, params in (("cpu", p_cpu), ("cuda", p_gpu))}
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"greedy tokens differ: card {toks['cuda']} "
                             f"cpu {toks['cpu']}")
    del p_gpu
    two_layer = ops.launch_counts_by_variant()["flash_attention"]
    t_full = time.perf_counter()
    full_cfg = continuous_against_static()
    t_full = time.perf_counter() - t_full
    fa_variants = ops.launch_counts_by_variant()["flash_attention"]
    full_k3 = {v: n - two_layer[v] for v, n in fa_variants.items()}
    if fa_variants["mma"] != 0 or two_layer["tf32x3"] == 0 or \
            full_k3["tf32x3"] == 0:
        raise AssertionError(f"K3 variants {two_layer} (2 layers), "
                             f"{full_k3} (36 layers): every fp32 launch "
                             f"must take tf32x3")
    k1_variants = ops.launch_counts_by_variant()["rmsnorm"]
    if k1_variants["packed"] or not (k1_variants["warp"]
                                     and k1_variants["block"]):
        raise AssertionError(f"K1 variants {k1_variants}: fp32 rows of 128 "
                             f"and the prefill's d_model rows take warp, "
                             f"the decode steps' d_model rows block")
    log(f"[5] {CPU_LAYERS} layers at full width, float32, TF32 off: "
        f"last-position logits card vs CPU max abs err {err:.3e} "
        f"(tol {LOGIT_TOL}, |logit| max "
        f"{logits['cpu'].abs().max().item():.2f}); greedy tokens equal "
        f"{toks['cuda']}; at all {full_cfg.n_layers} layers in float32, "
        f"continuous (dense, paged; graphs) = static on phase 4b's traffic "
        f"({t_full:.1f} s); K3 variants {two_layer} in the {CPU_LAYERS}-"
        f"layer part, {full_k3} in the {full_cfg.n_layers}-layer runs; K1 "
        f"variants {k1_variants}; {time.perf_counter() - t0:.1f} s")
    return fa_variants


def continuous_against_static():
    """qwen3-4b at full depth in float32 (17.6 GB of weights), phase 4b's
    traffic through the continuous engine (dense and paged, graphs) and the
    static engine: equal tokens, the sampled request included.  In fp32 the
    engines' other batch shapes and summation orders do not flip a token;
    in bf16 they do (phase 4b prints where)."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import BatchedEngine
    cfg, model, params = serve.build(ARCH, seed=0, dtype="float32")
    reqs = continuous_requests(cfg.vocab)
    static = BatchedEngine(model, params,
                           max_seq=max(CONT_PROMPT_LENS) + MAX_NEW + CHUNK,
                           chunk=CHUNK).run(reqs, seed=5)
    for layout in ("dense", "paged"):
        cont = continuous_engine(model, params, layout, graph=True).run(
            reqs, seed=5)
        if cont != static:
            first = [next((j for j, (a, b) in enumerate(zip(c, s)) if a != b),
                          None) for c, s in zip(cont, static)]
            raise AssertionError(f"fp32, {cfg.n_layers} layers, {layout}: "
                                 f"continuous tokens != static tokens; first "
                                 f"differing token per request {first}")
    del params
    torch.cuda.empty_cache()
    return cfg


# ---------------------------------------------------------------------------
# the pipeline slice: K2 and K4
# ---------------------------------------------------------------------------

def time_auto(fn) -> float:
    """:func:`time_ms` with fewer replays for a call of many milliseconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    if once > 20:
        return time_ms(fn, reps=1, trials=3)
    if once > 2:
        return time_ms(fn, reps=3, trials=5)
    return time_ms(fn)


def eager_auto(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) * 1e3 > 20:
        return eager_ms(fn, reps=1, trials=3)
    return eager_ms(fn)


def _mm_variant(m, k, n, dtype) -> str:
    """The regime phases 6 and 9 hold each K2 case to: bf16 rows TMA can
    describe on wgmma, other bf16 on mma; fp32 up to 16 rows on skinny
    (split K, CUDA cores), more on tf32x3 (3xTF32 tiles)."""
    if dtype == torch.bfloat16:
        return "wgmma" if k % 8 == 0 and n % 8 == 0 else "mma"
    return "skinny" if m <= 16 else "tf32x3"


def _mm_planned(plans) -> dict:
    """K2's launches per variant that calls with these plans make: one of
    the plan's kernel each, and one of its reduction where K is split."""
    from repro_torch.kernels import matmul as mm
    want = {v: 0 for v in mm.launches_by_variant}
    for p in plans:
        want[p.variant] += 1
        if p.split > 1:
            want[mm._REDUCE[p.variant]] += 1
    return want


def _matmul_case(m, k, n, dtype, gen):
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    s = k ** -0.25
    a = (s * torch.randn((m, k), generator=gen, device="cuda")).to(dtype)
    b = (s * torch.randn((k, n), generator=gen, device="cuda")).to(dtype)
    p = mm.plan(m, n, k, dtype)
    if p.variant != _mm_variant(m, k, n, dtype):
        raise AssertionError(f"matmul {(m, k, n)} {dtype}: planned "
                             f"{p.variant}, want {_mm_variant(m, k, n, dtype)}")
    before = dict(mm.launches_by_variant)
    got, want = mm.matmul(a, b), ref.matmul(a, b)
    planned = _mm_planned([p])
    if mm.launches_by_variant != {v: c + planned[v]
                                  for v, c in before.items()}:
        raise AssertionError(f"matmul {(m, k, n)} {dtype}: {p.variant} was "
                             f"not launched as planned: "
                             f"{mm.launches_by_variant}")
    atol, rtol = MM_TOLS[dtype]
    err = (got.float() - want.float()).abs()
    if (err > atol + rtol * want.float().abs()).any():
        raise AssertionError(f"matmul {(m, k, n)} {dtype}: max abs err "
                             f"{err.max().item()} beyond atol {atol} + rtol "
                             f"{rtol}")
    # against the exact product of the same inputs: what 3xTF32 keeps
    err64 = (got.double() - a.double() @ b.double()).abs().max().item()
    plain64 = (want.double() - a.double() @ b.double()).abs().max().item()
    elt = a.element_size()
    nbytes = (m * k + k * n + m * n) * elt
    b_ms, b_by = bound(nbytes, 2 * m * k * n, PEAK_FLOPS[dtype])
    case = {"shape": [m, k, n], "dtype": str(dtype).split(".")[-1],
            "variant": p.variant, "block_n": p.block_n, "split": p.split,
            "grid": list(p.grid), "max_abs_err": err.max().item(),
            "max_abs_err_f64": err64, "plain_max_abs_err_f64": plain64,
            "tol": [atol, rtol], "ms": time_ms(lambda: mm.matmul(a, b)),
            "eager_ms": eager_ms(lambda: mm.matmul(a, b)),
            "plain_ms": time_ms(lambda: ref.matmul(a, b)),
            "library_ms": time_ms(lambda: torch.matmul(a, b)),
            "bound_ms": b_ms, "bound_by": b_by}
    if p.variant == "tf32x3":
        # the work it does: three TF32 products a product
        case["bound_3xtf32_ms"], case["bound_3xtf32_by"] = bound(
            nbytes, 3 * 2 * m * k * n, TF32_FLOPS)
    return case


def phase_matmul():
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [_matmul_case(m, k, n, dt, gen)
             for dt in (torch.bfloat16, torch.float32)
             for m, k, n in MM_SHAPES]
    for c in cases:
        log("[6] matmul " + json.dumps(c))
    for m, k, n in MM_SHAPES[:2]:
        log("[6] matmul tile width " + json.dumps(_tile_widths(m, k, n, gen)))
    return cases


def _tile_widths(m, k, n, gen):
    """Both wgmma tile widths at one shape, split 1, timed in turns (128,
    256, 256, 128), against the width ``matmul.plan`` picks: the check of
    its rule on this card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul as mm
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    fn = mm._wgmma_entry()

    def call(bn):
        def run():                     # the stream a graph capture runs on
            _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), None,
                            m, n, k, 1, bn, 1,
                            torch.cuda.current_stream().cuda_stream),
                         f"matmul wgmma block_n {bn}")
        return run
    ms = {128: [], 256: []}
    for bn in (128, 256, 256, 128):
        ms[bn].append(time_ms(call(bn)))
    return {"shape": [m, k, n], "ms_block_n_128": ms[128],
            "ms_block_n_256": ms[256],
            "plan_block_n": mm.plan(m, n, k, torch.bfloat16).block_n}


def grid_extents(cmd):
    """The extents of every top-level grid-level parfor nest of a hoisted
    command, in order: what the strategy says the card must launch."""
    from repro_torch.core.dpia import phrases as P
    from repro_torch.core.dpia.types import AccT, ExpT, Idx, VarT
    out = []

    def walk(p):
        if isinstance(p, P.SeqC):
            walk(p.c1)
            walk(p.c2)
        elif isinstance(p, P.New):
            walk(p.f(P.Var(P.fresh("h"), VarT(p.d))))
        elif isinstance(p, P.ParFor) and p.level.kind in ("grid", "par"):
            dims = []
            while isinstance(p, P.ParFor) and p.level.kind in ("grid", "par"):
                dims.append(p.n)
                p = p.f(P.Var(P.fresh("g"), ExpT(Idx(p.n))),
                        P.Var(P.fresh("o"), AccT(p.d)))
            out.append(tuple(dims))
    walk(cmd)
    return out


def _dpia_inputs(kernel, shape, gen):
    def r(*s, scale=1.0):
        return scale * torch.randn(s, generator=gen, device="cuda")
    if kernel == "scal":
        return (torch.tensor(2.5, device="cuda"), r(shape["n"]))
    if kernel == "asum":
        return (r(shape["n"]),)
    if kernel == "dot":
        return (r(shape["n"]), r(shape["n"]))
    if kernel == "gemv":
        return (r(shape["m"], shape["n"]), r(shape["n"]))
    if kernel == "rmsnorm":
        return (r(shape["rows"], shape["d"]), 1 + r(shape["d"], scale=0.1))
    if kernel == "softmax":
        return (r(shape["rows"], shape["d"]),)
    return (r(shape["m"], shape["k"], scale=0.1),
            r(shape["k"], shape["n"], scale=0.1))


def _dpia_library(kernel, args, shape):
    import torch.nn.functional as F
    if kernel == "scal":
        return lambda: args[1] * args[0]
    if kernel == "asum":
        return lambda: args[0].abs().sum()
    if kernel == "dot":
        return lambda: torch.dot(*args)
    if kernel == "gemv":
        return lambda: torch.mv(*args)
    if kernel == "rmsnorm":
        return lambda: F.rms_norm(args[0], (shape["d"],), args[1],
                                  shape["eps"])
    if kernel == "softmax":
        return lambda: torch.softmax(args[0], dim=-1)
    return lambda: torch.matmul(*args)


def _dpia_work(kernel, shape):
    """(bytes, fp32 operations) the function needs: each input read once,
    the output written once."""
    if kernel in ("scal", "asum", "dot"):
        n = shape["n"]
        ins = {"scal": n + 1, "asum": n, "dot": 2 * n}[kernel]
        outs = n if kernel == "scal" else 1
        return 4 * (ins + outs), {"scal": n, "asum": 2 * n, "dot": 2 * n}[kernel]
    if kernel == "gemv":
        m, n = shape["m"], shape["n"]
        return 4 * (m * n + n + m), 2 * m * n
    if kernel in ("rmsnorm", "softmax"):
        rows, d = shape["rows"], shape["d"]
        w = d if kernel == "rmsnorm" else 0
        return 4 * (2 * rows * d + w), (4 if kernel == "rmsnorm" else 5) * rows * d
    m, k, n = shape["m"], shape["k"], shape["n"]
    return 4 * (m * k + k * n + m * n), 2 * m * k * n


def _dpia_tol(kernel, args, want):
    """(atol, rtol) of the generated program against the plain version.
    scal: the same one multiply.  asum / dot: the same fp32 terms summed in
    another order (a block tree against torch's sum per block), so the
    error is held to 1e-5 of the sum of the terms' magnitudes.  The rest
    sum rows of 200 to 2560 fp32 terms in another order."""
    if kernel == "scal":
        return 0.0, 0.0
    if kernel == "asum":
        return 1e-5 * args[0].abs().sum().item(), 0.0
    if kernel == "dot":
        return 1e-5 * (args[0] * args[1]).abs().sum().item(), 0.0
    return {"gemv": (1e-4, 1e-4), "rmsnorm": (1e-5, 1e-5),
            "softmax": (1e-6, 1e-5), "matmul": (1e-4, 1e-4)}[kernel]


def _dpia_case(kernel, shape, gen, build_s):
    from repro_torch.core.dpia import hoist
    from repro_torch.core.dpia import phrases as P
    from repro_torch.kernels import ops
    prog = ops.program(kernel, **shape)          # Program(expr, argv)
    fn = prog.check().lower().compile("cuda")
    plain = prog.check().lower().compile("torch")
    args = _dpia_inputs(kernel, shape, gen)
    # strategy preservation: one CUDA grid per top-level grid parfor nest
    want_grids = grid_extents(hoist.hoist(prog.imperative, spaces=(P.HBM,)))
    got_grids = [s.grid for s in fn.stages if s.kind == "grid"]
    if got_grids != want_grids or any(s.grid != (1,) for s in fn.stages
                                      if s.kind != "grid"):
        raise AssertionError(f"{kernel} {shape}: stage grids "
                             f"{fn.plan.grids} against the strategy's "
                             f"{want_grids}")
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    if fn.launches - before != len(fn.stages):
        raise AssertionError(f"{kernel}: {fn.launches - before} launches "
                             f"per call, want {len(fn.stages)}")
    t0 = time.perf_counter()
    want = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    atol, rtol = _dpia_tol(kernel, args, want)
    err = (got - want).abs()
    if not torch.isfinite(got).all() or \
            (err > atol + rtol * want.abs()).any():
        raise AssertionError(f"{kernel} {shape}: generated against plain "
                             f"max abs err {err.max().item()} beyond atol "
                             f"{atol} + rtol {rtol}")
    nbytes, flops = _dpia_work(kernel, shape)
    b_ms, b_by = bound(nbytes, flops, ELEMENTWISE_FLOPS)
    # under the strategy's grid: its largest stage reaches at most that
    # many of the card's SMs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = max(s.blocks for s in fn.stages)
    g_ms, g_by = bound(nbytes, flops,
                       ELEMENTWISE_FLOPS * min(1.0, blocks / sms))
    # each stage alone, on the buffers of one call that ran them all
    launchers, _ = fn.bind(*args)
    for launch in launchers:
        launch()
    stage_ms = [time_auto(launch) for launch in launchers]
    ptx = fn.ptxas()
    return {"program": ops.program_name(kernel, **shape), "kernel": kernel,
            "shape": shape, "stages": len(fn.stages),
            "grids": [list(g) for g in fn.plan.grids],
            "smem_bytes": [s.smem_bytes for s in fn.stages],
            "scratch_bytes": [s.scratch_bytes for s in fn.stages],
            "ptxas": [ptx.get(s.index, {}) for s in fn.stages],
            "build_s": build_s, "max_abs_err": err.max().item(),
            "tol": [atol, rtol],
            "ms": time_auto(lambda: fn(*args)), "stage_ms": stage_ms,
            "eager_ms": eager_auto(lambda: fn(*args)),
            "plain_ms": plain_ms, "plain_calls": 1,
            "library_ms": time_ms(_dpia_library(kernel, args, shape)),
            "bound_ms": b_ms, "bound_by": b_by}, {
                # derived, not measured: logged, kept out of the kernels line
                "bound_grid_ms": g_ms, "bound_grid_by": g_by, "sms": sms}


def phase_dpia(build_s):
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for k, sh in DPIA_CASES:
        c, under_grid = _dpia_case(k, sh, gen, build_s)
        log("[7] dpia " + json.dumps({**c, **under_grid}))
        cases.append(c)
    fig7 = {f"{c['kernel']}_{'x'.join(str(v) for v in c['shape'].values())}":
            c["ms"] / c["library_ms"] for c in cases
            if c["kernel"] in ("scal", "asum", "dot", "gemv")}
    log("[8] fig7 generated/library time " + json.dumps(fig7))
    return cases


def phase_pipeline_main_path():
    """The slice's main path through the entry points a user calls:
    ops.matmul(impl="cuda") at the projection shapes, every DPIA op with
    impl="dpia-cuda" at its default strategy (autotune off, so the
    programs are phase 7's); counts zeroed just before and read just
    after."""
    from repro_torch import compiler
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    mm_in = [(torch.randn((m, k), generator=gen, device="cuda").to(dt),
              torch.randn((k, n), generator=gen, device="cuda").to(dt))
             for m, k, n, dt in MM_CALLS]
    dpia_in = [(k, sh, _dpia_inputs(k, sh, gen)) for k, sh in DPIA_CASES]
    calls = {"scal": lambda a, sh: ops.scal(*a, impl="dpia-cuda"),
             "asum": lambda a, sh: ops.asum(*a, impl="dpia-cuda"),
             "dot": lambda a, sh: ops.dot(*a, impl="dpia-cuda"),
             "gemv": lambda a, sh: ops.gemv(*a, impl="dpia-cuda"),
             "rmsnorm": lambda a, sh: ops.rmsnorm(*a, eps=sh["eps"],
                                                  impl="dpia-cuda"),
             "softmax": lambda a, sh: ops.softmax(*a, impl="dpia-cuda"),
             "matmul": lambda a, sh: ops.matmul(*a, impl="dpia-cuda")}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = [ops.matmul(a, b, impl="cuda") for a, b in mm_in]
    with compiler.options(autotune=False):
        outs += [calls[k](a, sh) for k, sh, a in dpia_in]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    mm_variants = ops.launch_counts_by_variant()["matmul"]
    per_prog = {ops.program_name(k, **sh):
                ops.compiled(k, "cuda", **sh).launches for k, sh in DPIA_CASES}
    stages = sum(len(ops.compiled(k, "cuda", **sh).stages)
                 for k, sh in DPIA_CASES)
    plans = [mm.plan(m, n, k, dt) for m, k, n, dt in MM_CALLS]
    want = {"rmsnorm": 0, "matmul": sum(p.launches for p in plans),
            "flash_attention": 0, "dpia_cuda": stages, **NO_BWD}
    want_variants = _mm_planned(plans)
    if [p.variant for p in plans] != [_mm_variant(m, k, n, dt)
                                      for m, k, n, dt in MM_CALLS]:
        raise AssertionError(f"pipeline main path: K2 plans {plans}")
    if counts != want or 0 in per_prog.values() \
            or mm_variants != want_variants or 0 in mm_variants.values():
        raise AssertionError(f"pipeline main path: launch counts {counts} != "
                             f"{want}, K2 variants {mm_variants} != "
                             f"{want_variants} (per program {per_prog})")
    for o in outs:
        if not torch.isfinite(o.float()).all():
            raise AssertionError("pipeline main path: a non-finite output")
    log(f"[9] pipeline main path: {len(MM_CALLS)} K2 calls + "
        f"{len(DPIA_CASES)} dpia-cuda ops, launches {counts}, K2 variants "
        f"{mm_variants}, per generated program {per_prog}")
    return counts, mm_variants, per_prog, {
        "mm_in": mm_in, "dpia_in": dpia_in, "mm_out": outs[:len(mm_in)],
        "dpia_out": outs[len(mm_in):], "stages": stages}


def phase_default_options(p9):
    """[9b] the same DPIA ops as a user calls them by default: ``impl=
    "dpia-cuda"`` under the default options (the tuner on unless
    ``REPRO_AUTOTUNE=0``, this run's empty default cache).  The cuda row
    takes only measured params, so with no measured record each op runs
    phase 9's executor: no new executor staged, outputs bitwise phase 9's,
    and its time (eager, interleaved with phase 9's form) held to that
    form's."""
    from repro_torch import compiler
    from repro_torch.kernels import ops
    opts = compiler.current_options()
    keys = set(compiler.executor_cache().keys())

    def user(k, a, sh):
        return lambda: ops.rmsnorm(*a, eps=sh["eps"], impl="dpia-cuda") \
            if k == "rmsnorm" else getattr(ops, k)(*a, impl="dpia-cuda")

    def off(k, a, sh):
        def run():
            with compiler.options(autotune=False):
                return user(k, a, sh)()
        return run
    rows = {}
    for (k, sh, a), want in zip(p9["dpia_in"], p9["dpia_out"]):
        got = user(k, a, sh)()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[9b] {k} {sh} under the default options "
                                 f"is not phase 9's output")
        t_def, t_off = [], []
        for _ in range(2):
            t_def.append(eager_auto(user(k, a, sh)))
            t_off.append(eager_auto(off(k, a, sh)))
        rows[ops.program_name(k, **sh)] = (min(t_def), min(t_off))
    staged = set(compiler.executor_cache().keys()) - keys
    slow = {n: t for n, t in rows.items() if t[0] > 1.5 * t[1] + 0.02}
    if staged or slow:
        raise AssertionError(f"[9b] default options: new executors "
                             f"{sorted(staged)}; slower than autotune=False "
                             f"(ms, ms): {slow}")
    log(f"[9b] {len(rows)} dpia-cuda ops under the default options "
        f"(autotune={opts.autotune}, no measured record): phase 9's "
        f"executors, outputs bitwise phase 9's; eager ms (default options, "
        f"autotune=False): " + json.dumps(rows))


# ---------------------------------------------------------------------------
# phase 10: compiler services and obs
# ---------------------------------------------------------------------------

def dpia_call(kernel, args, shape):
    """The DPIA op for ``kernel`` with no ``impl=``: the options in scope
    pick the row."""
    from repro_torch.kernels import ops
    if kernel == "rmsnorm":
        return ops.rmsnorm(*args, eps=shape["eps"])
    return getattr(ops, kernel)(*args)


def phase_traced_continuous(smi, cfg, engine, reqs, want, untraced):
    """[10e] one phase 4b run (dense, graph, warm) repeated with tracing
    on: the same tokens and launch counts, a loadable Chrome trace with the
    serving spans, each request's lifecycle in order, 8 TTFT observations
    and no re-capture."""
    from repro_torch import obs
    obs.metrics_reset()
    obs.clear_trace()
    obs.enable()
    try:
        toks, rep = _continuous_run(engine, reqs, cfg)
    finally:
        obs.disable()
    if toks != want:
        raise AssertionError("[10e] traced continuous run: tokens differ "
                             "from the untraced runs'")
    with tempfile.TemporaryDirectory() as d:
        path = obs.export_trace(os.path.join(d, "serve-trace.json"))
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    obs.clear_trace()
    spans = {}
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    if not spans.get("serve.prefill_chunk") or \
            not spans.get("serve.decode_chunk"):
        raise AssertionError(f"[10e] trace spans {spans}: want "
                             f"serve.prefill_chunk and serve.decode_chunk")
    life = ("serve.submit", "serve.admit", "serve.first_token",
            "serve.retire")
    per_req = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["ph"] == "i" and e["name"] in life:
            per_req.setdefault(e["args"]["req_id"], []).append(e["name"])
    if len(per_req) != len(reqs) or any(names != list(life)
                                        for names in per_req.values()):
        raise AssertionError(f"[10e] lifecycle events per request "
                             f"{per_req}: want {list(life)} for each of "
                             f"{len(reqs)}")
    snap = obs.metrics_snapshot()
    recompiles = obs.counter("serve.recompiles_after_warm").value
    if snap["serve.ttft_s"]["count"] != len(reqs) or recompiles != 0 or \
            engine.stats()["recaptures_after_warm"] != 0:
        raise AssertionError(f"[10e] serve.ttft_s observations "
                             f"{snap['serve.ttft_s']['count']} (want "
                             f"{len(reqs)}), serve.recompiles_after_warm "
                             f"{recompiles} (want 0)")
    out = {"tok_s_traced": rep["tok_s"], "tok_s_untraced_median": untraced,
           "trace_events": len(events), "trace_bytes": size, "spans": spans,
           "ttft_s": {k: snap["serve.ttft_s"][k]
                      for k in ("count", "p50", "p95", "max")},
           "chunk_s": {k: snap["serve.chunk_s"][k]
                       for k in ("count", "p50", "p95", "max")},
           "recompiles_after_warm": recompiles}
    log("[10e] traced continuous run (dense, graph): " + json.dumps(out)
        + f"; card {smi}")
    return out


def phase_obs_cost(smi, engine, reqs, want):
    """[10f] phase 4's static engine: tok/s with obs disabled and with
    tracing on, three runs each in turns (off, on, on, off, off, on)."""
    from repro_torch import obs
    tok_s = {"disabled": [], "tracing": []}
    n_events = 0
    for traced in (False, True, True, False, False, True):
        obs.clear_trace()
        if traced:
            obs.enable()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = engine.run(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            obs.disable()
        if outs != want:
            raise AssertionError("[10f] a run gave other tokens")
        n_events = max(n_events, len(obs.trace_events()))
        tok_s["tracing" if traced else "disabled"].append(
            sum(map(len, outs)) / dt)
    obs.clear_trace()
    out = {k: {"median": statistics.median(v), "runs": v}
           for k, v in tok_s.items()}
    out["trace_events_per_run"] = n_events
    log("[10f] static tok/s, obs disabled against tracing on, 3 runs each "
        f"in turns: {json.dumps(out)}; card {smi}")
    return out


def aot_child(directory: str) -> int:
    """``--aot-child DIR``: a fresh process loads the AOT store in DIR and
    runs the eleven programs on the inputs saved there; prints one JSON
    line (spans by name, nvcc runs, K4 launches, times)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import compiler, obs
    from repro_torch.kernels import _build, ops
    obs.enable()
    cache = compiler.executor_cache()
    t0 = time.perf_counter()
    loaded = cache.load_aot(directory)
    load_s = time.perf_counter() - t0
    inputs = torch.load(os.path.join(directory, "inputs.pt"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with compiler.options(backend="dpia-cuda", autotune=False):
        outs = [dpia_call(k, a, sh) for (k, sh), a in zip(DPIA_CASES,
                                                          inputs)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.save(outs, os.path.join(directory, "outputs.pt"))
    names = [e["name"] for e in obs.trace_events()]
    print(json.dumps({
        "loaded": loaded, "load_s": load_s, "first_calls_s": first_s,
        "stats": cache.stats(), "nvcc_runs": _build.nvcc_runs,
        "launches": ops.launch_counts(),
        "trace_events": {n: names.count(n) for n in sorted(set(names))}}))
    return 0


def phase_services(smi, p9, stage_s, build_s):
    """[10a-d, g] the compiler's services on the card."""
    from repro_torch import compiler
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    n = len(DPIA_CASES)
    zero = {"rmsnorm": 0, "matmul": 0, "flash_attention": 0, "dpia_cuda": 0,
            **NO_BWD}
    # (a) the DPIA ops under an options scope, no impl=
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with compiler.options(backend="dpia-cuda", autotune=False):
        outs = [dpia_call(k, a, sh) for k, sh, a in p9["dpia_in"]]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts != {**zero, "dpia_cuda": p9["stages"]} or \
            any(not torch.equal(g, w) for g, w in zip(outs, p9["dpia_out"])):
        raise AssertionError(f"[10a] options(backend='dpia-cuda'): launches "
                             f"{counts}, want {p9['stages']} K4 stages, and "
                             f"phase 9's outputs bit for bit")
    # (b) matmul under options(backend="cuda"): K2 with phase 9's variants
    ops.reset_launch_counts()
    with compiler.options(backend="cuda"):
        mm_outs = [ops.matmul(a, b) for a, b in p9["mm_in"]]
    torch.cuda.synchronize()
    counts, variants = ops.launch_counts(), ops.launch_counts_by_variant()
    want_mm = sum(mm.plan(m, nn, k, dt).launches
                  for m, k, nn, dt in MM_CALLS)
    if counts != {**zero, "matmul": want_mm} or \
            variants["matmul"] != p9["mm_variants"] or \
            any(not torch.equal(g, w) for g, w in zip(mm_outs, p9["mm_out"])):
        raise AssertionError(f"[10b] options(backend='cuda'): launches "
                             f"{counts}, K2 variants {variants['matmul']} "
                             f"against phase 9's {p9['mm_variants']}")
    # (c) one build per program, hits after
    stats = compiler.executor_cache().stats()
    if stats["builds"] != n or stats["entries"] != n or \
            stats["aot_loads"] or stats["hits"] < 2 * n:
        raise AssertionError(f"[10c] executor cache {stats}: want {n} "
                             f"builds and entries, hits from phases 9 and "
                             f"10a")
    log(f"[10a-c] {n} DPIA ops under options(backend='dpia-cuda') = phase 9 "
        f"bit for bit, K4 launches {p9['stages']} (the stages); "
        f"{len(MM_SHAPES)} matmuls under options(backend='cuda'): K2 "
        f"variants {variants['matmul']} = phase 9's; executor cache {stats}")
    # (d) the AOT store, reloaded in a fresh process
    with tempfile.TemporaryDirectory() as d:
        written = compiler.executor_cache().save_aot(d)
        torch.save([list(a) for _, _, a in p9["dpia_in"]],
                   os.path.join(d, "inputs.pt"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--aot-child", d], capture_output=True,
                              text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[10d] the AOT child failed:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        outs = torch.load(os.path.join(d, "outputs.pt"))
    spans = rep["trace_events"]
    if written != n or rep["loaded"] != n or rep["nvcc_runs"] != 0 or \
            spans.get("compiler.lower", 0) or spans.get("compiler.check", 0) \
            or rep["launches"]["dpia_cuda"] != p9["stages"] or \
            any(not torch.equal(g, w) for g, w in zip(outs, p9["dpia_out"])):
        raise AssertionError(f"[10d] AOT reload: wrote {written}, child "
                             f"{rep}; want {n} loaded, zero lower / check "
                             f"spans and nvcc runs, phase 9's outputs bit "
                             f"for bit")
    aot = {"programs": n, "load_aot_s": rep["load_s"],
           "first_calls_s": rep["first_calls_s"], "child_process_s": child_s,
           "cold_stage_s": stage_s, "cold_nvcc_s": build_s,
           "trace_events": spans, "nvcc_runs": rep["nvcc_runs"]}
    log("[10d] AOT reload in a fresh process, bitwise phase 9: "
        + json.dumps(aot))
    # (g) the quickstart on the card
    from repro_torch.examples import quickstart
    t0 = time.perf_counter()
    qs = quickstart.main([])
    log(f"[10g] quickstart on the card: {json.dumps(qs)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return aot


# ---------------------------------------------------------------------------
# phase 11: the tuner on the card
# ---------------------------------------------------------------------------

# the pipeline's sizes (phase 7's; gemv has no strategy space to tune)
TUNE_CASES = [("scal", dict(n=1 << 22)), ("asum", dict(n=1 << 22)),
              ("dot", dict(n=1 << 22)), ("rmsnorm", dict(rows=800, d=2560)),
              ("softmax", dict(rows=25600, d=200)),
              ("matmul", dict(m=1024, k=2560, n=2560))]
TUNE_TOP_K = 4
# the only reasons the tuner may drop a candidate
DROP_REASONS = {"unsupported", "verify"}


def _op_shape(kernel, shape):
    """The op layer's shape of a tuned kernel (rmsnorm's carries eps)."""
    return {**shape, "eps": 1e-6} if kernel == "rmsnorm" else dict(shape)


def _preset_inputs(record):
    """Each timed candidate's measured time beside the cost model's terms
    for it: what an ``h100`` preset would be fitted to."""
    from repro_torch.autotune import cost, space
    from repro_torch.obs.audit import _parse_params_key
    out = {}
    for pk, us in sorted(record["timings"].items()):
        cand = space.candidate_from_params(
            record["kernel"], _parse_params_key(pk), **record["shape"])
        est = cost.estimate(cand.build()[0])
        out[pk] = {"measured_us": us, **{k: float(v) for k, v in
                                          vars(est).items() if v}}
    return out


def phase_tune(smi: str, cache_path: str):
    """[11a-d] ``autotune.tune(backend="cuda", measure=True, verify=True)``
    at the pipeline's sizes, every measured candidate generated by K4 and
    timed on the card; the ranking audit; a second call served from the
    cache; the op table under the tuned options."""
    from repro_torch import autotune, compiler, obs
    from repro_torch.autotune import measure, space
    from repro_torch.compiler import executors
    from repro_torch.kernels import _build, ops
    t_phase = time.perf_counter()
    fallbacks = obs.counter("kernels.fallbacks").value
    # (a) every kernel's picks generated, then built in one nvcc batch
    nvcc0 = _build.nvcc_runs
    t0 = time.perf_counter()
    gens = [c.program().check().lower().compile("cuda")
            for k, sh in TUNE_CASES
            for c in autotune.api.measure_picks(k, top_k=TUNE_TOP_K,
                                                cache=cache_path, **sh)]
    stage_s = time.perf_counter() - t0
    nvcc_s = measure.build_candidates(gens)
    batch = {"programs": len(gens), "stage_s": stage_s, "nvcc_s": nvcc_s,
             "nvcc_runs": _build.nvcc_runs - nvcc0}
    log("[11a] the picked candidates of every kernel, generated and built "
        "in one parallel batch: " + json.dumps(batch))
    rows, winners = [], {}
    for kernel, shape in TUNE_CASES:
        dropped = {}
        t0 = time.perf_counter()
        res = autotune.tune(kernel, backend="cuda", measure=True, verify=True,
                            top_k=TUNE_TOP_K, cache=cache_path,
                            dropped=dropped, **shape)
        tune_s = time.perf_counter() - t0
        bad = {pk: r for pk, r in dropped.items() if r not in DROP_REASONS}
        if res.source != "measured" or bad or not res.timings:
            raise AssertionError(f"[11a] {kernel}: source {res.source}, "
                                 f"dropped {dropped}")
        ranked = measure.rank_by_cost(space.enumerate_space(kernel, **shape))
        default = space.default_params(kernel, **shape)
        win = space.candidate_from_params(kernel, res.params, **shape)
        wfn, args = measure.compile_candidate(win, "cuda")
        dfn, _ = measure.compile_candidate(
            space.candidate_from_params(kernel, default, **shape), "cuda")
        plain = win.program().check().lower().compile("torch")
        got = wfn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        atol, rtol = _dpia_tol(kernel, args, want)
        err = (got - want).abs()
        if not torch.isfinite(got).all() or \
                (err > atol + rtol * want.abs()).any():
            raise AssertionError(f"[11a] {kernel} winner {res.params}: "
                                 f"max abs err {err.max().item()} against "
                                 f"its plain version beyond atol {atol} + "
                                 f"rtol {rtol}")
        op_shape = _op_shape(kernel, shape)
        nbytes, flops = _dpia_work(kernel, op_shape)
        b_ms, b_by = bound(nbytes, flops, ELEMENTWISE_FLOPS)
        row = {"program": space.program_name(kernel, res.params, **op_shape),
               "kernel": kernel, "shape": shape, "params": res.params,
               "default": default,
               "analytic_winner": ranked[0][0].params_dict,
               "measured_winner": res.params,
               "enumerated": res.n_candidates, "measured": len(res.timings),
               "dropped": dropped, "timings_us": res.timings,
               "grids": [list(g) for g in wfn.plan.grids],
               "stages": len(wfn.stages), "tune_s": tune_s,
               "nvcc_s_batch": nvcc_s, "max_abs_err": err.max().item(),
               "tol": [atol, rtol],
               "ms": time_auto(lambda: wfn(*args)),
               "default_ms": time_auto(lambda: dfn(*args)),
               "eager_ms": eager_auto(lambda: wfn(*args)),
               "plain_ms": plain_ms, "plain_calls": 1,
               "library_ms": time_ms(_dpia_library(kernel, args, op_shape)),
               "bound_ms": b_ms, "bound_by": b_by}
        log("[11a] " + json.dumps(row))
        rows.append(row)
        winners[kernel] = (res, args, got)
    # (b) the ranking audit over that cache, under the card's preset
    tc = autotune.TuningCache(cache_path)
    findings = {f["kernel"]: f for f in obs.auditor().audit_cache(tc)}
    for kernel, _ in TUNE_CASES:
        if kernel not in findings:
            raise AssertionError(f"[11b] no ranking finding for {kernel}")
        key = winners[kernel][0].key
        log(f"[11b] {kernel}: analytic ranking (preset "
            f"{autotune.cost.default_platform()}) agrees with the card: "
            f"{findings[kernel]['agree']}; " + json.dumps(findings[kernel])
            + "; preset inputs " + json.dumps(_preset_inputs(tc.get(key))))
    # (c) the same calls again: cache hits, nothing measured or built
    obs.enable()
    obs.clear_trace()
    nvcc0 = _build.nvcc_runs
    try:
        hits = [autotune.tune(k, backend="cuda", measure=True, verify=True,
                              top_k=TUNE_TOP_K, cache=cache_path, **sh)
                for k, sh in TUNE_CASES]
        names = [e["name"] for e in obs.trace_events()]
    finally:
        obs.disable()
        obs.clear_trace()
    hit = {"sources": sorted({h.source for h in hits}),
           "measure_spans": names.count("autotune.measure"),
           "nvcc_runs": _build.nvcc_runs - nvcc0}
    if hit != {"sources": ["cache"], "measure_spans": 0, "nvcc_runs": 0} \
            or any(h.params != winners[k][0].params
                   for h, (k, _) in zip(hits, TUNE_CASES)):
        raise AssertionError(f"[11c] second tune calls: {hit}")
    log("[11c] second tune calls: " + json.dumps(hit))
    # (d) the op table under the tuned options: the winners, bit for bit
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with compiler.options(backend="dpia-cuda", autotune=True,
                          tuning_cache=cache_path):
        outs = {k: dpia_call(k, winners[k][1], _op_shape(k, sh))
                for k, sh in TUNE_CASES}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    launches = {}
    for (kernel, shape), row in zip(TUNE_CASES, rows):
        res, _, got = winners[kernel]
        key = executors.make_key(kernel, _op_shape(kernel, shape), "cuda",
                                 params=res.params)
        fn = compiler.executor_cache().get(key)
        if fn is None or not torch.equal(outs[kernel], got):
            raise AssertionError(f"[11d] {kernel}: executor {key} "
                                 f"{'missing' if fn is None else 'found'}; "
                                 f"outputs bitwise the winner's: "
                                 f"{torch.equal(outs[kernel], got)}")
        launches[row["program"]] = fn.launches
    stages = sum(r["stages"] for r in rows)
    if counts != {"rmsnorm": 0, "matmul": 0, "flash_attention": 0,
                  "dpia_cuda": stages, **NO_BWD} or \
            launches != {r["program"]: r["stages"] for r in rows}:
        raise AssertionError(f"[11d] launches {counts}, per program "
                             f"{launches}; want {stages} K4 stages")
    fired = int(obs.counter("kernels.fallbacks").value - fallbacks)
    if fired:
        raise AssertionError(f"[11] the op table's tuner fallback fired "
                             f"{fired} times")
    log(f"[11d] the {len(TUNE_CASES)} ops under options(backend="
        f"'dpia-cuda', autotune=True, tuning_cache=...): executor keys "
        f"carry the tuned params, outputs bitwise the winners', launches "
        f"{counts} (per program {launches}), tuner fallbacks {fired}")
    for r in rows:
        r["launches"] = launches[r["program"]]
    log(f"[11] phase 11a-d {time.perf_counter() - t_phase:.1f} s (cold "
        f"nvcc included); card {smi}")
    return rows


def phase_tuned_serving(smi, cfg, model, params, reqs, want):
    """[11e] phase 4b's traffic through ``ContinuousEngine(kv_layout=
    "auto")``: the planner's layout, then a run after the warm-up with
    phase 4b's exact K1 / K3 counts and its tokens bit for bit."""
    from repro_torch import autotune
    engine = continuous_engine(model, params, "auto", graph=True)
    pick = autotune.pick_kv_layout(cfg, slots=SLOTS,
                                   max_seq=continuous_max_seq(),
                                   block_size=BLOCK)
    engine.run(reqs, seed=5)                 # warm-up: captures
    toks, rep = _continuous_run(engine, reqs, cfg)
    if engine.kv_layout != pick["layout"] or toks != want:
        raise AssertionError(f"[11e] layout {engine.kv_layout} (planner: "
                             f"{pick['layout']}); tokens equal phase 4b's: "
                             f"{toks == want}")
    log(f"[11e] kv_layout='auto' chose {pick['layout']} "
        + json.dumps(pick) + f"; tokens bitwise phase 4b's; {rep['tok_s']:.1f}"
        f" tok/s, launches {rep['launches']}, K1 {rep['k1_variants']}; "
        f"card {smi}")
    del engine
    torch.cuda.empty_cache()
    phase_engine_warm(smi, model, params)


def phase_engine_warm(smi, model, params):
    """[11f] the engines' ``tuning_cache=`` warm-up under
    ``options(backend="dpia-cuda")``: a ContinuousEngine of phase 4b's
    shape pre-tunes the model's op shapes and stages their K4 programs,
    exporting ``<cache>.aot`` with exactly the keys it staged; a second
    engine, in emptied executor caches, loads every program from the store
    and stages none.  Both engines' seconds and counts are logged."""
    import json as _json
    from repro_torch import compiler
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ContinuousEngine
    where = tempfile.mkdtemp(prefix="chip_smoke_warm_")
    path = os.path.join(where, "warm.json")
    store = compiler.executor_cache()
    try:
        ops.clear_caches()
        out = {}
        for label in ("first", "second"):
            before = set(store.keys())
            t0 = time.perf_counter()
            with compiler.options(backend="dpia-cuda"):
                engine = ContinuousEngine(
                    model, params, max_seq=continuous_max_seq(), slots=SLOTS,
                    chunk=CHUNK, tuning_cache=path)
            out[label] = {"s": time.perf_counter() - t0,
                          "tuned": len(engine.tuned),
                          "staged": len(set(store.keys()) - before),
                          **store.stats()}
            if label == "first":
                staged = set(store.keys()) - before
                aot = set()
                for name in os.listdir(path + ".aot"):
                    if name.endswith(".json"):
                        with open(os.path.join(path + ".aot", name)) as f:
                            aot.add(_json.load(f)["key"])
                if not staged or aot != staged:
                    raise AssertionError(
                        f"[11f] the first engine staged {sorted(staged)}; "
                        f"its store holds {sorted(aot)}")
                out[label]["aot_files"] = len(aot)
                ops.clear_caches()
            del engine
        second = out["second"]
        if second["builds"] != 0 or second["aot_loads"] != len(staged) or \
                second["staged"] != len(staged):
            raise AssertionError(f"[11f] the second engine: {second}, the "
                                 f"first staged {len(staged)}")
        log(f"[11f] ContinuousEngine(tuning_cache=...) under "
            f"options(backend='dpia-cuda'): qwen3-4b's op shapes pre-tuned "
            f"and staged, <cache>.aot holding exactly the first engine's "
            f"keys, the second engine loading all of them and staging none: "
            + _json.dumps(out) + f"; card {smi}")
    finally:
        ops.clear_caches()
        shutil.rmtree(where, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: serving under faults
# ---------------------------------------------------------------------------

# phase 4b's eight prompts and four more; request 1 samples (T=0.8, top-k
# 50).  Every run of the phase is seeded 0.
FAULT_PROMPT_LENS = CONT_PROMPT_LENS + (120, 33, 77, 150)
# pages for the paged drill: the first four requests need 15 + 12 + 6 + 4
# = 37, so the queue head defers
FAULT_KV_BLOCKS = 32
SLOW_CHUNK_S = 0.2           # serve.slow_chunk's sleep
CHUNK_DEADLINE_S = 0.15      # the straggler watchdog's deadline (12a, 12b)
JOURNAL_BOUNDARIES = 4       # 12d: boundaries served before the crash
COST_ROUNDS = 3              # 12e: timed runs of each side, in turns


def fault_requests(vocab: int):
    from repro_torch.launch import serve
    reqs = serve.make_requests(vocab, FAULT_PROMPT_LENS, MAX_NEW, seed=3)
    reqs[1].temperature, reqs[1].top_k = 0.8, 50
    return reqs


def _serve(engine, reqs, spec_of=None, on_boundary=None):
    """Submit ``reqs`` (streams 0, 1, ...), then step the engine to idle
    under the fault plan ``spec_of(rids)``; ``on_boundary(engine)`` runs
    after every boundary.  K1 / K3 counts are zeroed just before and read
    just after.  Returns the results in request order and the counts."""
    from repro_torch.kernels import ops
    from repro_torch.testing import faults
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rids = [engine.submit(r, stream=i) for i, r in enumerate(reqs)]
    with faults.inject(spec_of(rids) if spec_of else ""):
        while not engine.sched.idle:
            engine.step_chunk()
            if on_boundary is not None:
                on_boundary(engine)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if not counts["rmsnorm"] or not counts["flash_attention"]:
        raise AssertionError(f"[12] launches {counts}: the run must go "
                             f"through K1 and K3")
    return [engine.take_result(rid) for rid in rids], counts


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _check_drill(what, results, want, expect):
    """``expect``: request index -> (state, reason prefix) of the requests
    the faults hit; every other request ends ok with the fault-free run's
    tokens, bit for bit."""
    for i, r in enumerate(results):
        state, reason = expect.get(i, ("ok", ""))
        if r.state != state or not r.reason.startswith(reason):
            raise AssertionError(f"{what}: request {i} ended {r.state!r} "
                                 f"({r.reason!r}); want {state!r} "
                                 f"({reason!r}...)")
        if r.state == "ok" and list(r.tokens) != want[i]:
            raise AssertionError(f"{what}: innocent request {i} gave other "
                                 f"tokens than the fault-free run")


def _trash_page_finite(engine) -> bool:
    k, v = engine.st.cache
    return bool(torch.isfinite(k[:, engine.kv_blocks]).all()
                and torch.isfinite(v[:, engine.kv_blocks]).all())


def phase_faults(smi: str, cfg, model, params, static, cont):
    """[12] serving under faults at full width: every drill on a warm
    engine with the chunk as a CUDA graph, held bit for bit against a
    fault-free run of the same engine; then the guard's and the journal's
    cost."""
    from repro_torch import obs
    from repro_torch.ft import artefacts
    from repro_torch.serve import domains
    from repro_torch.serve.engine import BatchedEngine
    from repro_torch.serve.resilience import ResilienceConfig
    t_phase = time.perf_counter()
    reqs = fault_requests(cfg.vocab)
    summary = {}

    # 12a / 12b: dense, the watchdog armed
    dense = continuous_engine(
        model, params, "dense", graph=True,
        resilience=ResilienceConfig(chunk_deadline_s=CHUNK_DEADLINE_S))
    warm, _ = _serve(dense, reqs)              # captures; the reference
    want = [list(r.tokens) for r in warm]
    if any(r.state != "ok" or len(r.tokens) != MAX_NEW for r in warm):
        raise AssertionError(f"[12] fault-free run: {warm}")
    st0 = dense.st
    ptrs0 = [t.data_ptr() for t in (*st0.cache, st0.tokens, st0.pos,
                                    st0.out)]

    drill = list(reqs)
    drill[11] = dataclasses.replace(reqs[11], ttft_deadline_s=1e-3)
    before = dense.stats()
    res, counts = _serve(dense, drill, lambda rids: (
        f"serve.nan_prefill(req_id={rids[1]}); "
        f"serve.nan_decode(req_id={rids[2]}); "
        f"serve.chunk_error(times=2); "
        f"serve.slow_chunk(times=1, value={SLOW_CHUNK_S})"))
    after = dense.stats()
    rs = _delta(after["resilience"], before["resilience"])
    _check_drill("[12a]", res, want, {
        1: ("failed", "non-finite prefill logits"),
        2: ("failed", "non-finite logits in decode chunk"),
        11: ("timeout", "ttft deadline expired")})
    if rs["stragglers"] < 1 or rs["chunk_retries"] != 2 or \
            rs["nan_quarantines"] != 2 or after["recaptures_after_warm"] or \
            after["captures"] != before["captures"]:
        raise AssertionError(f"[12a] resilience {rs}, captures "
                             f"{before['captures']} -> {after['captures']}, "
                             f"re-captures {after['recaptures_after_warm']}")
    summary["12a"] = {"states": [r.state for r in res], "resilience": rs,
                      "captures": after["captures"],
                      "recaptures_after_warm":
                          after["recaptures_after_warm"],
                      "launches": counts}
    log("[12a] dense, graph: nan_prefill(request 1), nan_decode(request 2), "
        "chunk_error(times=2), slow_chunk 0.2 s against a 0.15 s deadline, "
        "request 11 at ttft_deadline 1 ms; innocent requests bitwise the "
        "fault-free run: " + json.dumps(summary["12a"]))

    before = dense.stats()
    res, counts = _serve(dense, reqs, lambda rids: "serve.chunk_error(times=3)")
    after = dense.stats()
    rs = _delta(after["resilience"], before["resilience"])
    failed = [i for i, r in enumerate(res) if r.state == "failed"]
    _check_drill("[12b]", res, want, {
        i: ("failed", "decode chunk failed: InjectedFault") for i in failed})
    ptrs = [t.data_ptr() for t in (*dense.st.cache, dense.st.tokens,
                                   dense.st.pos, dense.st.out)]
    if not failed or len(failed) == len(res) or rs["chunk_quarantines"] != 1 \
            or rs["chunk_retries"] != 2 or dense.st is not st0 or \
            ptrs != ptrs0 or after["recaptures_after_warm"] or \
            after["captures"] != before["captures"]:
        raise AssertionError(f"[12b] failed {failed}, resilience {rs}, "
                             f"buffers kept {ptrs == ptrs0}, captures "
                             f"{before['captures']} -> {after['captures']}")
    summary["12b"] = {"failed": failed, "resilience": rs,
                      "buffers_kept": True,
                      "recaptures_after_warm":
                          after["recaptures_after_warm"],
                      "launches": counts}
    log("[12b] dense, graph: chunk_error(times=3) past 2 retries: in-flight "
        "requests fail, the buffers rebuilt in place (same tensors, no "
        "capture), queued requests bitwise the fault-free run: "
        + json.dumps(summary["12b"]))

    # 12c: paged, a pool the queue head defers on
    paged = continuous_engine(model, params, "paged", graph=True,
                              kv_blocks=FAULT_KV_BLOCKS)
    warm_p, _ = _serve(paged, reqs)
    want_p = [list(r.tokens) for r in warm_p]
    if want_p != want:
        raise AssertionError("[12c] fault-free paged run != fault-free "
                             "dense run (paged decode is the dense "
                             "computation)")
    paged_graphs = paged._graphs
    obs.flight_clear()
    obs.clear_decisions()
    before = paged.stats()
    trash = []

    def check_trash(engine):
        if engine.kv_layout == "paged":
            trash.append(_trash_page_finite(engine))
    res, counts = _serve(paged, reqs, lambda rids: (
        f"serve.nan_decode(req_id={rids[0]}); serve.pool_corrupt(after=4)"),
        on_boundary=check_trash)
    after = paged.stats()
    rs = _delta(after["resilience"], before["resilience"])
    deferrals = (after["scheduler"]["deferrals"]
                 - before["scheduler"]["deferrals"])
    corrupt = [i for i, r in enumerate(res)
               if r.reason.startswith("kv pool corrupt")]
    _check_drill("[12c]", res, want_p, {
        0: ("failed", "non-finite logits in decode chunk"),
        **{i: ("failed", "kv pool corrupt") for i in corrupt}})
    decs = [d for d in obs.decisions()
            if d.origin == "degraded(paged->dense)"]
    dumps = [d["reason"] for d in obs.flight_dumps()]
    on_dense = [i for i, r in enumerate(res) if r.ok and
                i > max(corrupt, default=len(res))]
    if deferrals < 1 or rs["nan_quarantines"] != 1 or \
            rs["degradations"] != 1 or len(decs) != 1 or \
            dumps.count("degradation") != 1 or not all(trash) or \
            len(trash) < 3 or paged.kv_layout != "dense" or \
            paged._graphs is paged_graphs or not on_dense:
        raise AssertionError(f"[12c] deferrals {deferrals}, resilience "
                             f"{rs}, decisions {len(decs)}, dumps {dumps}, "
                             f"trash page finite {trash}, layout "
                             f"{paged.kv_layout}, served on dense {on_dense}")
    summary["12c"] = {"states": [r.state for r in res], "resilience": rs,
                      "deferrals": deferrals,
                      "degradation_decisions": len(decs),
                      "degradation_dumps": dumps.count("degradation"),
                      "trash_page_finite_boundaries": len(trash),
                      "served_on_dense": on_dense,
                      "dense_captures": after["captures"],
                      "dense_graph_keys": after["graph_keys"],
                      "launches": counts}
    log(f"[12c] paged ({FAULT_KV_BLOCKS} pages), graph: nan_decode(request "
        "0) scrubbed and reissued, then pool_corrupt at boundary 5 -> "
        "dense; innocent requests bitwise the fault-free paged run: "
        + json.dumps(summary["12c"]))
    del paged, paged_graphs

    # 12d: the journal, an abandoned engine and its replay
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "journal.jsonl")
        crashed = continuous_engine(model, params, "dense", graph=True,
                                    journal=path)
        for i, r in enumerate(reqs):
            crashed.submit(r, stream=i)
        for _ in range(JOURNAL_BOUNDARIES):
            crashed.step_chunk()
        del crashed                            # the crash
        torch.cuda.synchronize()
        nbytes = os.path.getsize(path)
        records, clean = artefacts.read_records(path)
        state = domains.SchedulerJournal.load(path)
        live = sorted(state.live())
        fresh = continuous_engine(model, params, "dense", graph=True)
        t0 = time.perf_counter()
        got = domains.replay(path, fresh, seed=0)
        replay_s = time.perf_counter() - t0
        again = domains.replay(path, fresh, seed=0)
    # what the crashed engine emitted is a prefix of the fault-free run,
    # and all of it for the requests that ended before the crash
    emitted_prefix = all(r["emitted"] == want[rid][:len(r["emitted"])]
                         for rid, r in state.requests.items())
    ended_ok = all(state.terminals.get(rid) == ("ok", "")
                   and state.requests[rid]["emitted"] == want[rid]
                   for rid in range(len(reqs)) if rid not in live)
    if not clean or sorted(got) != live or again != got or not live or \
            any(got[rid] != want[rid] for rid in live) or \
            not emitted_prefix or not ended_ok or \
            len(state.requests) != len(reqs):
        raise AssertionError(f"[12d] clean {clean}, live {live}, replayed "
                             f"{sorted(got)}, idempotent {again == got}, "
                             f"emitted prefixes {emitted_prefix}, ended "
                             f"before the crash as run {ended_ok}")
    kinds = {}
    for r in records:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    summary["12d"] = {"boundaries": JOURNAL_BOUNDARIES,
                      "journal_bytes": nbytes, "records": kinds,
                      "live": len(live),
                      "ended_before_crash": len(state.terminals),
                      "emitted_at_crash": sum(len(r["emitted"]) for r in
                                              state.requests.values()),
                      "replay_s": replay_s}
    log("[12d] journal of a dense engine abandoned after 4 boundaries, "
        "replayed into a fresh engine twice: every live request bitwise "
        "the fault-free run: " + json.dumps(summary["12d"]))
    del fresh, dense
    torch.cuda.empty_cache()

    # 12e: what the guard and the journal cost
    s_engine, s_reqs, s_want = static
    unguarded = BatchedEngine(model, params,
                              max_seq=max(PROMPT_LENS) + MAX_NEW + CHUNK,
                              chunk=CHUNK,
                              resilience=ResilienceConfig(nan_guard=False))
    if unguarded.run(s_reqs) != s_want:
        raise AssertionError("[12e] the guard changed the static tokens")
    tok_s = {"guard": [], "no_guard": []}
    for r in range(COST_ROUNDS):
        order = (("guard", s_engine), ("no_guard", unguarded))
        for name, eng in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = eng.run(s_reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if outs != s_want:
                raise AssertionError(f"[12e] static {name}: other tokens")
            tok_s[name].append(sum(map(len, outs)) / dt)
    del unguarded
    # the journal on one engine, attached and detached in turns (one
    # engine's graphs on both sides), its writes timed on the host clock
    class TimedJournal(domains.SchedulerJournal):
        seconds = 0.0

        def _timed(self, write, *args, **kw):
            t0 = time.perf_counter()
            write(*args, **kw)
            self.seconds += time.perf_counter() - t0

        def record_submit(self, *args, **kw):
            self._timed(super().record_submit, *args, **kw)

        def record_progress(self, *args, **kw):
            self._timed(super().record_progress, *args, **kw)

        def record_terminal(self, *args, **kw):
            self._timed(super().record_terminal, *args, **kw)

    _, c_reqs, c_want = cont
    with tempfile.TemporaryDirectory() as d:
        journal = TimedJournal(os.path.join(d, "journal.jsonl"))
        engine = continuous_engine(model, params, "dense", graph=True,
                                   journal=journal)
        engine.run(c_reqs, seed=5)             # warm-up: captures
        run_s, journal_s = [], []
        for r in range(COST_ROUNDS):
            order = ("no_journal", "journal")
            for name in (order if r % 2 == 0 else order[::-1]):
                engine.journal = journal if name == "journal" else None
                before = journal.seconds
                toks, rep = _continuous_run(engine, c_reqs, cfg)
                if toks != c_want:
                    raise AssertionError(f"[12e] continuous {name}: other "
                                         f"tokens than phase 4b's")
                tok_s.setdefault(name, []).append(rep["tok_s"])
                if name == "journal":
                    run_s.append(rep["s"])
                    journal_s.append(journal.seconds - before)
        records = len(artefacts.read_records(journal.path)[0])
        journal_bytes = os.path.getsize(journal.path)
        del engine
    torch.cuda.empty_cache()
    summary["12e"] = {k: {"median": statistics.median(v), "runs": v}
                      for k, v in tok_s.items()}
    summary["12e"]["journal"].update(
        host_s=journal_s, run_s=run_s,
        records_a_run=records // (COST_ROUNDS + 1),
        bytes_a_run=journal_bytes // (COST_ROUNDS + 1))
    log(f"[12e] tok/s, {COST_ROUNDS} runs each in turns: static batch 4 "
        "with the NaN guard (default ResilienceConfig) against "
        "nan_guard=False; continuous (phase 4b's traffic, dense, graph), one "
        "engine built with journal= and run with it detached and attached, "
        "with the host seconds of its journal writes: "
        + json.dumps(summary["12e"]) + f"; card {smi}")
    summary["s"] = time.perf_counter() - t_phase
    return summary


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

# K1 / K3 backward against their plain versions on the card, |err| <= atol
# * max|plain| + rtol * |plain|.  fp32: the same fp32 arithmetic in another
# order (dw sums 2048-65536 rows).  bf16: both compute in fp32 from the
# same bf16 inputs and round each gradient once; another order of sums
# flips that rounding (2**-8 relative).
BWD_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
LSE_TOL = 1e-4          # fp32 row log-sum-exp, values of order 10
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS = 3e-4, 2, 6
NAN_CALL = 3
# the card's step-1 state against the CPU's (smoke config, fp32, TF32
# off): gradients summed in other orders, |err| <= 1e-4 |cpu| + 1e-5
# max|cpu| per leaf
STATE_TOL = (1e-5, 1e-4)
SMOKE_STEPS = 20


def check_bwd(got, want, dtype, what: str) -> float:
    """``got`` against ``want`` under :data:`BWD_TOLS`; the max abs err."""
    atol, rtol = BWD_TOLS[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol * w.abs().max() + rtol * w.abs()
    if bad.any() or not torch.isfinite(g).all():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond "
                             f"atol {atol} x max + rtol {rtol}; max abs err "
                             f"{err.max().item()}")
    return err.max().item()


def time_backward_ms(forward, inputs, grad_out) -> float:
    """Device time of one autograd backward of ``forward()`` (a library
    call's yardstick): the forward runs once on a side stream, then
    :func:`time_ms` captures backward passes (``retain_graph``) on that
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad_out,
                                               retain_graph=True),
                   reps=10, stream=side)


def bwd_ptxas() -> dict:
    """Registers and spills of the backward kernels' instances (ptxas's
    ``-v`` report of their sources): K1-bwd's rows kernel by (dtype,
    elements an access, threads a row, accesses a thread), K3-bwd's mma
    and tf32 kernels by (kernel, head dim)."""
    from repro_torch.kernels import _build
    k1 = _build.ptxas_report(
        _build.target("rmsnorm").with_suffix(".log").read_text(),
        r"rmsnorm_bwd_rowsI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E")
    k3 = _build.ptxas_report(
        _build.target("flash_attention").with_suffix(".log").read_text(),
        r"flash_bwd_(dkv|dq)_(mma|tf32)ILi(\d+)E")
    return {"rmsnorm_bwd": {
                f"{'fp32' if t == 'f' else 'bf16'} N{n} TPR{p} VPT{v}": r
                for (t, n, p, v), r in sorted(k1.items())},
            "flash_attention_bwd": {f"{k}_{v} D{dd}": r
                                    for (k, v, dd), r in sorted(k3.items())}}


def _rmsnorm_bwd_case(rows, d, dtype, gen, ptxas):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=gen,
                               device="cuda")).to(dtype)
    dy = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    before = rms.backward.launches
    dx, dw = rms._launch_bwd(x, w, dy, 1e-6)
    if rms.backward.launches != before + 1:
        raise AssertionError("rmsnorm_bwd was not launched")
    want_dx, want_dw = ref.rmsnorm_bwd(x, w, dy)
    what = f"rmsnorm_bwd {(rows, d)} {dtype}"
    errs = {"dx": check_bwd(dx, want_dx, dtype, what + " dx"),
            "dw": check_bwd(dw, want_dw, dtype, what + " dw")}
    again = rms._launch_bwd(x, w, dy, 1e-6)
    if not (torch.equal(again[0], dx) and torch.equal(again[1], dw)):
        raise AssertionError(f"{what}: two launches gave different bits")
    elt = x.element_size()
    b_ms, b_by = bound((3 * rows * d + 2 * d) * elt, 10 * rows * d,
                       ELEMENTWISE_FLOPS)
    xa = x.detach().requires_grad_()
    wa = w.detach().requires_grad_()
    p = rms.bwd_plan(rows, d, dtype)
    name = (f"{'fp32' if dtype == torch.float32 else 'bf16'} N"
            f"{16 // elt if p.vector else 1} TPR{p.threads_per_row} VPT"
            f"{p.vectors_per_thread}")
    return {"shape": [rows, d], "dtype": str(dtype).split(".")[-1],
            "plan": p._asdict(), "ptxas": ptxas["rmsnorm_bwd"].get(name),
            "max_abs_err": max(errs.values()),
            "errs": errs, "tol": list(BWD_TOLS[dtype]), "bitwise_repeat": True,
            "ms": time_ms(lambda: rms._launch_bwd(x, w, dy, 1e-6)),
            "eager_ms": eager_ms(lambda: rms._launch_bwd(x, w, dy, 1e-6)),
            "plain_ms": time_ms(lambda: ref.rmsnorm_bwd(x, w, dy)),
            "library_ms": time_backward_ms(
                lambda: F.rms_norm(xa, (d,), wa, 1e-6), (xa, wa), dy),
            "bound_ms": b_ms, "bound_by": b_by}


def _flash_bwd_case(b, nh, nkv, s, hd, dtype, gen, ptxas):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q = (0.5 * torch.randn((b * nh, s, hd), generator=gen,
                           device="cuda")).to(dtype)
    k = (0.5 * torch.randn((b * nkv, s, hd), generator=gen,
                           device="cuda")).to(dtype)
    v = torch.randn((b * nkv, s, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b * nh, s, hd), generator=gen, device="cuda").to(dtype)
    o, lse = fa._launch(q, k, v, causal=True, scale=None, q_offset=0,
                        with_lse=True)
    want_o, want_lse = ref.flash_attention(q, k, v, causal=True,
                                           return_lse=True)
    what = f"flash_attention_bwd {(b * nh, s, hd)} {dtype}"
    check_close(o, want_o, dtype, what + " forward")
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"{what}: lse max abs err {lse_err} > {LSE_TOL}")
    before = fa.backward.launches
    variant = fa.bwd_variant(dtype)
    before_v = fa.backward.launches_by_variant[variant]

    def kernel():
        return fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=None)
    got = kernel()
    if fa.backward.launches != before + 1 or \
            fa.backward.launches_by_variant[variant] != before_v + 1:
        raise AssertionError(f"flash_attention_bwd ({variant}) was not "
                             f"launched")
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    errs = {n: check_bwd(g, w, dtype, f"{what} {n}")
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    again = kernel()
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        raise AssertionError(f"{what}: two launches gave different bits")
    pairs = s * (s + 1) // 2
    elt = q.element_size()
    # the function's work: S = QK^T recomputed, dP = dO V^T, dV = P^T dO,
    # dQ = dS K, dK = dS^T Q over the causal pairs of every query head;
    # its bytes: q, o, dO read and dQ written; k, v read and dK, dV
    # written; lse read
    nbytes = (4 * q.numel() + 4 * k.numel()) * elt + 4 * lse.numel()
    flops = 10 * b * nh * hd * pairs
    b_ms, b_by = bound(nbytes, flops, PEAK_FLOPS[dtype])
    q4, k4, v4 = (t.detach().view(b, n, s, hd).requires_grad_()
                  for t, n in ((q, nh), (k, nkv), (v, nkv)))
    extra = {}
    if variant == "tf32x3":
        # the work it does: three TF32 products a product
        extra["bound_3xtf32_ms"], extra["bound_3xtf32_by"] = bound(
            nbytes, 3 * flops, TF32_FLOPS)
    kind = "_mma " if variant == "mma" else "_tf32 "
    return {"q": [b * nh, s, hd], "kv": [b * nkv, s, hd], "causal": True,
            "dtype": str(dtype).split(".")[-1], "variant": variant,
            "ptxas": {n: r for n, r in ptxas["flash_attention_bwd"].items()
                      if n.endswith(f" D{hd}") and kind in n}, **extra,
            "max_abs_err": max(errs.values()), "errs": errs,
            "lse_max_abs_err": lse_err, "tol": list(BWD_TOLS[dtype]),
            "bitwise_repeat": True,
            "ms": time_ms(kernel), "eager_ms": eager_ms(kernel),
            "plain_ms": time_ms(lambda: ref.flash_attention_bwd(
                q, k, v, o, lse, do, causal=True)),
            "library_ms": time_backward_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True),
                (q4, k4, v4), do.view(b, nh, s, hd)),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_train_kernels():
    """[13a] the backward kernels against their plain versions on the
    card, at the shapes one full-width train step gives them."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    t = TRAIN_BATCH * TRAIN_SEQ
    ptxas = bwd_ptxas()
    log("[13a] ptxas of the backward kernels [registers, spills]: "
        + json.dumps(ptxas))
    rms = [_rmsnorm_bwd_case(r, d, dt, gen, ptxas)
           for dt in (torch.bfloat16, torch.float32)
           for r, d in ((t, 2560), (t * 32, 128), (t * 8, 128))]
    # the train step's shape in both dtypes, then a ragged length (the
    # serving prefill's) in bf16
    fa = [_flash_bwd_case(TRAIN_BATCH, 32, 8, s, 128, dt, gen, ptxas)
          for s, dt in ((TRAIN_SEQ, torch.bfloat16),
                        (TRAIN_SEQ, torch.float32), (200, torch.bfloat16))]
    for name, cases in (("rmsnorm_bwd", rms), ("flash_attention_bwd", fa)):
        for c in cases:
            log(f"[13a] {name} " + json.dumps(c))
    return {"rmsnorm_bwd": rms, "flash_attention_bwd": fa}


def checksums(state) -> list:
    """Two 64-bit checksums of the raw bits of every tensor of ``state``
    (a plain sum and a sum of xor-shifted words), read in one sync: equal
    lists mean nothing was written, short of an exact cancellation."""
    from repro_torch.optim import adamw
    sums = []
    for _, leaf in adamw.leaves(state):
        for t in (leaf if isinstance(leaf, adamw.QTensor) else (leaf,)):
            bits = t.detach().reshape(-1).view(
                {1: torch.int8, 2: torch.int16, 4: torch.int32}[
                    t.element_size()])
            sums += [bits.sum(dtype=torch.int64),
                     (bits ^ (bits >> 3)).sum(dtype=torch.int64)]
    return torch.stack(sums).tolist()


def _matrix_ids(state):
    from repro_torch.optim import adamw
    return [(p, t) for p, t in adamw.leaves(state["params"]) if t.ndim >= 2]


def phase_train(smi):
    """[13b-d] qwen3-4b at full width (bf16, 36 layers, remat): one step
    at microbatches=2 (13c), 6 TrainLoop steps (13b), the NaN drill
    (13d)."""
    import gc

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.ft.resilience import TrainLoop
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_state, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"[13] start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved")
    cfg = config(ARCH)
    if not (cfg.remat and cfg.dtype == "bfloat16" and cfg.n_layers == 36):
        raise AssertionError(f"qwen3-4b at full width, bf16, remat: {cfg}")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2**30
    n_params = sum(t.numel() for _, t in adamw.leaves(state["params"]))
    # model FLOPs: 6 x the matmul params (every 2-D leaf but the embedding
    # lookup) x tokens; remat's recompute is not counted
    n_matmul = sum(t.numel() for p, t in _matrix_ids(state)
                   if p != ("embed",))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    kw = dict(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)

    # 13c first, on the fresh state: lr is 0 at step 0, so the params keep
    # their bits; then the moments and counters go back to zero
    before = checksums(state["params"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, m_mb = make_train_step(model, microbatches=2, **kw)(
        state, data.global_batch_at(0))
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    mb_peak = torch.cuda.max_memory_allocated() / 2**30
    if checksums(state["params"]) != before or m_mb["applied"] != 1:
        raise AssertionError(f"[13c] the lr-0 step changed the params or "
                             f"was not applied: {m_mb}")
    for _, t in adamw.leaves(state["opt"]):
        t.zero_()
    state["step"].zero_()

    # 13b: TrainLoop, 6 steps, no checkpoint inside the run
    step = make_train_step(model, **kw)
    first = {k: torch.as_tensor(v).cuda().long()
             for k, v in data.global_batch_at(0).items()}
    matrices = _matrix_ids(state)
    mat_before = checksums([t for _, t in matrices])
    rows, counts_total, bwd_variants = [], {}, {}
    check = {}
    clock = [0.0]

    def on_metrics(i, m):
        # the step returns with its AdamW kernels still queued (its one
        # host sync is the guard's read, before the update): wait for them
        torch.cuda.synchronize()
        dt = time.perf_counter() - clock[0]
        counts = ops.launch_counts()
        bwd_v = ops.launch_counts_by_variant()["flash_attention_bwd"]
        for k, n in counts.items():
            counts_total[k] = counts_total.get(k, 0) + n
        for k, n in bwd_v.items():
            bwd_variants[k] = bwd_variants.get(k, 0) + n
        rows.append({"step": i + 1, "loss": m["loss"],
                     "grad_norm": m["grad_norm"], "lr": m["lr"],
                     "applied": m["applied"], "s": dt, "tok_s": tokens / dt,
                     "mfu": 6 * n_matmul * tokens / dt / PEAK_FLOPS[
                         torch.bfloat16],
                     "launches": {k: counts[k] for k in (
                         "rmsnorm", "rmsnorm_bwd", "flash_attention",
                         "flash_attention_bwd")},
                     "flash_attention_bwd_variants": bwd_v})
        if i == 0:
            # every leaf's gradient at the state after step 1, set and
            # finite (autograd.grad raises for a leaf the loss misses)
            flat = [t for _, t in adamw.leaves(state["params"])]
            grads = torch.autograd.grad(model.loss(state["params"], first),
                                        flat)
            bad = [p for (p, _), g in zip(adamw.leaves(state["params"]),
                                          grads)
                   if g is None or not bool(torch.isfinite(g).all())]
            check["grad_leaves"], check["grad_bad"] = len(grads), bad
            del grads
        if i == 1:
            after = checksums([t for _, t in matrices])
            check["unchanged_matrices"] = [
                p for j, (p, _) in enumerate(matrices)
                if after[2 * j:2 * j + 2] == mat_before[2 * j:2 * j + 2]]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        clock[0] = time.perf_counter()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(step, CheckpointManager(ckdir), data,
                         ckpt_every=10 ** 9)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        clock[0] = time.perf_counter()
        state = loop.run(state, num_steps=TRAIN_STEPS, on_metrics=on_metrics)
        if os.listdir(ckdir):
            raise AssertionError("[13b] the run wrote a checkpoint")
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_pass_k1 = cfg.n_layers * 4 + 1
    want_step = {"rmsnorm": 2 * per_pass_k1 - 1, "rmsnorm_bwd": per_pass_k1,
                 "flash_attention": 2 * cfg.n_layers,
                 "flash_attention_bwd": cfg.n_layers}
    want_bwd_variants = {"mma": cfg.n_layers, "tf32x3": 0}
    bad_launch = [(r["launches"], r["flash_attention_bwd_variants"])
                  for r in rows if r["launches"] != want_step or
                  r["flash_attention_bwd_variants"] != want_bwd_variants]
    losses = [r["loss"] for r in rows]
    if check["grad_bad"] or check["grad_leaves"] != len(
            adamw.leaves(state["params"])) or check["unchanged_matrices"] \
            or bad_launch or not all(map(math.isfinite, losses)) or \
            any(r["applied"] != 1 for r in rows):
        raise AssertionError(f"[13b] leaves without a finite gradient "
                             f"{check['grad_bad']}, matrices unchanged after "
                             f"step 2 {check['unchanged_matrices']}, launches "
                             f"{bad_launch} (want {want_step} and K3-bwd "
                             f"{want_bwd_variants} a step), "
                             f"losses {losses}")
    steady = [r["s"] for r in rows[1:]]
    summary = {"state_gib": state_gib, "init_s": init_s, "params": n_params,
               "matmul_params": n_matmul, "tokens_a_step": tokens,
               "peak_gib": peak, "steps": rows,
               "median_step_s": statistics.median(steady),
               "median_tok_s": tokens / statistics.median(steady),
               "median_mfu": 6 * n_matmul * tokens / statistics.median(
                   steady) / PEAK_FLOPS[torch.bfloat16],
               "launches_a_step": want_step,
               "flash_attention_bwd_variants_a_step": want_bwd_variants,
               "grad_leaves_finite": check["grad_leaves"]}
    log(f"[13b] qwen3-4b full width (36 layers, d_model 2560, bf16, remat, "
        f"weights from seed 0), TrainLoop batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, lr {TRAIN_LR}, warmup {TRAIN_WARMUP}, "
        f"{TRAIN_STEPS} steps; MFU = 6 x {n_matmul} matmul params x "
        f"{tokens} tokens / step s / 989e12: " + json.dumps(summary)
        + f"; card {smi}")
    mb_rel = abs(m_mb["loss"] - rows[0]["loss"]) / abs(rows[0]["loss"])
    gn_rel = abs(m_mb["grad_norm"] - rows[0]["grad_norm"]) / \
        rows[0]["grad_norm"]
    if not (mb_rel <= 1e-3 and gn_rel <= 0.05):
        raise AssertionError(f"[13c] microbatches=2: loss {m_mb['loss']} vs "
                             f"{rows[0]['loss']} (rel {mb_rel}), grad_norm "
                             f"{m_mb['grad_norm']} vs {rows[0]['grad_norm']} "
                             f"(rel {gn_rel})")
    log("[13c] " + json.dumps({"microbatches": 2, "loss": m_mb["loss"],
                               "loss_rel_to_13b": mb_rel,
                               "grad_norm": m_mb["grad_norm"],
                               "grad_norm_rel_to_13b": gn_rel,
                               "s": mb_s, "peak_gib": mb_peak}))

    # 13d: a loss that is NaN on the third call
    class NanOnThird(Model):
        calls = 0

        def loss(self, params, batch):
            NanOnThird.calls += 1
            out = super().loss(params, batch)
            return out * float("nan") if self.calls == NAN_CALL else out

    nan_step = make_train_step(NanOnThird(cfg), **kw)
    seen = {}

    def watched(st, batch):
        if NanOnThird.calls == NAN_CALL - 1:
            seen["before"] = checksums(st)
        new, m = nan_step(st, batch)
        if NanOnThird.calls == NAN_CALL:
            seen["after"], seen["m"] = checksums(new), m
        return new, m
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        loop = TrainLoop(watched, CheckpointManager(ckdir), data,
                         ckpt_every=10 ** 9)
        step_before = int(state["step"])
        state = loop.run(state, num_steps=NAN_CALL)
    if seen["m"]["applied"] != 0 or seen["after"] != seen["before"] or \
            loop.skipped_steps != 1 or \
            int(state["step"]) != step_before + NAN_CALL - 1:
        raise AssertionError(f"[13d] the NaN step: metrics {seen['m']}, "
                             f"state kept bitwise "
                             f"{seen['after'] == seen['before']}, skipped "
                             f"{loop.skipped_steps}")
    log("[13d] " + json.dumps({
        "nan_call": NAN_CALL, "metrics": seen["m"],
        "state_bitwise_kept": True, "checksummed_tensors": len(
            seen["after"]) // 2, "skipped_steps": loop.skipped_steps}))
    del state, step, nan_step, loop
    gc.collect()
    torch.cuda.empty_cache()
    summary["s"] = time.perf_counter() - t_phase
    return summary, counts_total, bwd_variants


def train_child() -> int:
    """``--train-child``: [13e] the smoke config (fp32) on the card, with
    deterministic algorithms (the embedding's index-add gradient through
    the deterministic sort-based path): 20 straight steps against 10, a
    checkpoint, a restore and 10 more, bitwise; the card's step-1 state
    against the CPU's.  Prints one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    import copy

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.ft.resilience import TrainLoop
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_state, make_train_step
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = smoke_config(ARCH)
    model = Model(cfg)
    cpu0 = make_train_state(model, torch.Generator().manual_seed(0),
                            device="cpu")

    def to(state, device):
        return adamw.tree_map(
            lambda t: (adamw.QTensor(*(x.detach().to(device) for x in t))
                       if isinstance(t, adamw.QTensor) else
                       t.detach().to(device).requires_grad_(t.requires_grad)),
            state)
    card0 = to(cpu0, "cuda")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    step = make_train_step(model, base_lr=1e-3, warmup=2,
                           total_steps=SMOKE_STEPS)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
        a = TrainLoop(step, CheckpointManager(os.path.join(d, "a")), data,
                      ckpt_every=10 ** 9).run(copy.deepcopy(card0),
                                              num_steps=SMOKE_STEPS)
        mgr = CheckpointManager(os.path.join(d, "b"), async_save=False)
        TrainLoop(step, mgr, data, ckpt_every=SMOKE_STEPS // 2).run(
            copy.deepcopy(card0), num_steps=SMOKE_STEPS // 2)
        saved = mgr.all_steps()
        b = TrainLoop(step, mgr, data, ckpt_every=SMOKE_STEPS // 2).run(
            copy.deepcopy(card0), num_steps=SMOKE_STEPS)
    counts, by_variant = ops.launch_counts(), ops.launch_counts_by_variant()
    bitwise = all(torch.equal(x, y) for (_, x), (_, y)
                  in zip(adamw.leaves(a), adamw.leaves(b)))
    # one step on each device from the same state and batch
    batch = data.global_batch_at(0)
    cpu1, m_cpu = step(copy.deepcopy(cpu0), batch)
    card1, m_card = step(copy.deepcopy(card0), batch)
    worst, bad = 0.0, []
    for (path, x), (_, y) in zip(adamw.leaves(card1), adamw.leaves(cpu1)):
        x, y = x.detach().cpu().float(), y.detach().float()
        err = (x - y).abs()
        worst = max(worst, err.max().item())
        if (err > STATE_TOL[0] * y.abs().max() + STATE_TOL[1] * y.abs()
                ).any():
            bad.append("/".join(map(str, path)))
    print(json.dumps({
        "resume_bitwise": bitwise, "checkpoints": saved,
        "launches": counts,
        "flash_attention_bwd_variants": by_variant["flash_attention_bwd"],
        "flash_attention_variants": by_variant["flash_attention"],
        "deterministic": True,
        "card_vs_cpu_bad_leaves": bad,
        "card_vs_cpu_max_abs_err": worst, "tol": list(STATE_TOL),
        "loss_card": m_card["loss"], "loss_cpu": m_cpu["loss"],
        "grad_norm_card": m_card["grad_norm"],
        "grad_norm_cpu": m_cpu["grad_norm"],
        "s": time.perf_counter() - t0}), flush=True)
    return 0


def phase_train_smoke(smi):
    """[13e] the smoke config on the card in a fresh process (deterministic
    algorithms want ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts,
    which this process did long ago)."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--train-child"], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(ROOT))
    if r.returncode != 0:
        raise AssertionError(f"[13e] the train child failed "
                             f"(rc {r.returncode}):\n{r.stdout}\n{r.stderr}")
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    if not rep["resume_bitwise"] or rep["checkpoints"] != [
            SMOKE_STEPS // 2] or rep["card_vs_cpu_bad_leaves"] or \
            rep["launches"]["rmsnorm_bwd"] == 0 or \
            rep["launches"]["flash_attention_bwd"] == 0 or \
            rep["flash_attention_bwd_variants"] != {
                "mma": 0, "tf32x3": rep["launches"]["flash_attention_bwd"]} \
            or rep["launches"]["flash_attention"] == 0 or \
            rep["flash_attention_variants"] != {
                "mma": 0, "tf32x3": rep["launches"]["flash_attention"]}:
        raise AssertionError(f"[13e] {rep}")
    rep["process_s"] = time.perf_counter() - t0
    log("[13e] smoke config, fp32, on the card (torch.use_deterministic_"
        "algorithms(True), CUBLAS_WORKSPACE_CONFIG=:4096:8): 20 straight "
        "steps = 10 + checkpoint + restore + 10, bitwise; the card's "
        "step-1 state against the CPU's: " + json.dumps(rep)
        + f"; card {smi}")
    return rep


# ---------------------------------------------------------------------------
# phase 14: the pipeline on a mesh
# ---------------------------------------------------------------------------

# phase 7's programs but gemv (no mesh strategy), sharded over "data"
MESH_CASES = [(k, sh) for k, sh in DPIA_CASES if k != "gemv"]
MESH_TUNE_N = 1 << 22
MESH_TUNE_TOP_K = 2
MESH_RANKS = 2            # 14b: processes sharing the one card over gloo
MESH_TIMED_CALLS = 5      # 14b: op calls timed on every rank (a collective
                          # each for dot / asum, so every rank makes them)


def _mesh_shape(shape):
    """The tuner's / executor key's shape: no eps."""
    return {k: v for k, v in shape.items() if k != "eps"}


def _mesh_name(kernel, shape):
    """The name of the default placement's program (14a names its program
    as the op table names 14b's executor)."""
    from repro_torch import mesh as mesh_mod
    from repro_torch.kernels import ops
    sh = _mesh_shape(shape)
    return ops.mesh_program_name(kernel, mesh_mod.default_mesh_params(
        kernel, {"data": MESH_RANKS}, **sh), **sh)


def mesh_shard_programs():
    """The K4 shard programs phase 14 runs, generated here so that phase 2
    builds them in its batch: each case's default placement on 1 and on
    ``MESH_RANKS`` shards, and every candidate of 14b's tune."""
    from repro_torch import mesh as mesh_mod
    from repro_torch.core.dpia import stage3_shardmap as S
    progs = []
    for shards in (1, MESH_RANKS):
        for k, sh in MESH_CASES:
            build, _ = mesh_mod.MESH_KERNELS[k]
            progs.append(S.shard_program(*build("data", shards, **sh),
                                         shards, inner="cuda",
                                         name=_mesh_name(k, sh))[0])
    for cand in mesh_mod.mesh_space("dot", {"data": MESH_RANKS},
                                    n=MESH_TUNE_N):
        prog = cand.program()
        progs.append(S.shard_program(prog.expr, prog.arg_vars, MESH_RANKS,
                                     inner="cuda", name=prog.name)[0])
    return progs


def _mesh_inputs(i, kernel, shape):
    """Case ``i``'s global inputs, the same on every rank (one seed)."""
    gen = torch.Generator(device="cuda").manual_seed(140 + i)
    return _dpia_inputs(kernel, shape, gen)


def _mesh_plain(kernel, args, shape):
    """The plain PyTorch version on whole tensors."""
    from repro_torch.kernels import ref
    if kernel == "rmsnorm":
        return ref.rmsnorm(*args, eps=shape["eps"])
    if kernel == "softmax":
        return ref.softmax(args[0], dim=-1)
    return {"scal": ref.scal, "asum": ref.asum, "dot": ref.dot,
            "matmul": ref.matmul}[kernel](*args)


def _shard_of(kernel, args, shape, index, shards):
    """(shard's inputs, shard's shape): what one shard's function reads."""
    if kernel in ("scal", "asum", "dot"):
        c = shape["n"] // shards
        pick = [a if a.dim() == 0 else a[index * c:(index + 1) * c]
                for a in args]
        return pick, {**shape, "n": c}
    ext = "m" if kernel == "matmul" else "rows"
    c = shape[ext] // shards
    return ([args[0][index * c:(index + 1) * c]] + list(args[1:]),
            {**shape, ext: c})


def _mesh_check(kernel, shape, got_local, args, index, shards, what):
    """This rank's output against its slice of the plain version (the whole
    value for a mesh reduce), within phase 7's tolerance."""
    want = _mesh_plain(kernel, args, shape)
    if kernel not in ("asum", "dot"):
        c = want.shape[0] // shards
        want = want[index * c:(index + 1) * c]
    atol, rtol = _dpia_tol(kernel, args, want)
    err = (got_local - want).abs()
    if not torch.isfinite(got_local).all() or \
            (err > atol + rtol * want.abs()).any():
        raise AssertionError(f"{what}: shard {index} of {shards} against "
                             f"the plain version: max abs err "
                             f"{err.max().item()} beyond atol {atol} + rtol "
                             f"{rtol}")
    return err.max().item(), [atol, rtol]


def _shard_times(fn, args, kernel, shape, index, shards):
    """Device ms of this rank's K4 shard (graph replays of its launches),
    of the plain version and of the library call on the shard's inputs, and
    the shard's bound."""
    launchers, _ = fn.shard.bind(*fn.shard_args(*args))

    def shard():
        for launch in launchers:
            launch()
    s_args, s_shape = _shard_of(kernel, args, shape, index, shards)
    nbytes, flops = _dpia_work(kernel, s_shape)
    b_ms, b_by = bound(nbytes, flops, ELEMENTWISE_FLOPS)
    return {"ms": time_auto(shard),
            "plain_ms": time_auto(
                lambda: _mesh_plain(kernel, s_args, s_shape)),
            "library_ms": time_auto(_dpia_library(kernel, s_args, s_shape)),
            "bound_ms": b_ms, "bound_by": b_by,
            "stages": [list(s.grid) for s in fn.shard.stages]}


def _count_allreduce(prof) -> int:
    return sum(e.name == "c10d::allreduce_" for e in prof.events())


def mesh_rank_one(rank, world):
    """[14a] one NCCL rank on the card: each case's default placement on a
    ``data=1`` mesh, through ``Program.compile("shardmap", inner="cuda")``
    (the op table would run its single-device row: an axis of size 1
    shards nothing)."""
    from repro_torch import compiler
    from repro_torch import mesh as mesh_mod
    from repro_torch.core.dpia import stage3_shardmap as S
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh((1,), ("data",))
    out = []
    for i, (k, sh) in enumerate(MESH_CASES):
        args = _mesh_inputs(i, k, sh)
        build, _ = mesh_mod.MESH_KERNELS[k]
        expr, argv = build("data", 1, **sh)
        fn = compiler.Program(expr, argv, name=_mesh_name(k, sh)).compile(
            "shardmap", mesh=m, inner="cuda")
        before, c0 = fn.launches, S.collectives
        got = fn(*args)
        torch.cuda.synchronize()
        launches, coll = fn.launches - before, S.collectives - c0
        if launches != len(fn.shard.stages) or \
                coll != (1 if k in ("asum", "dot") else 0):
            raise AssertionError(f"[14a] {k} {sh}: {launches} launches, "
                                 f"{coll} all-reduces a call")
        err, tol = _mesh_check(k, sh, got.to_local(), args, 0, 1, "[14a]")
        out.append({"kernel": k, "shape": sh, "program": fn.shard.name,
                    "launches": launches, "all_reduce": coll,
                    "max_abs_err": err, "tol": tol,
                    "eager_ms": eager_auto(lambda: fn(*args)),
                    **_shard_times(fn, args, k, sh, 0, 1)})
    return out


def _op_call(kernel, args, shape):
    from repro_torch.kernels import ops
    if kernel == "rmsnorm":
        return ops.rmsnorm(*args, eps=shape["eps"])
    return getattr(ops, kernel)(*args)


def _timed_calls(call, n) -> float:
    """Median ms of ``n`` calls (CUDA events, after one warm-up): the same
    number of calls on every rank."""
    call()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mesh_rank_two(rank, world, tune_cache):
    """[14b] ``world`` ranks sharing the card over gloo: the six ops through
    ``options(backend="dpia-shardmap", mesh=...)``, K4 per shard; counts
    zeroed just before and read just after; then a measured mesh tune."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import autotune, compiler
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh((world,), ("data",))
    index = m.get_local_rank("data")
    inputs = [_mesh_inputs(i, k, sh) for i, (k, sh) in enumerate(MESH_CASES)]
    opts = compiler.CompileOptions(backend="dpia-shardmap", mesh=m)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs, seen = [], []
    with compiler.options(opts):
        for (k, sh), args in zip(MESH_CASES, inputs):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                outs.append(_op_call(k, args, sh))
            seen.append(_count_allreduce(prof))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    fns = [ops.mesh_compiled(k, opts, m, "cuda", **sh)
           for k, sh in MESH_CASES]
    cases = []
    for (k, sh), args, got, n_ar, fn in zip(MESH_CASES, inputs, outs, seen,
                                            fns):
        if n_ar != (1 if k in ("asum", "dot") else 0):
            raise AssertionError(f"[14b] {k} {sh}: {n_ar} all_reduce calls "
                                 f"in the profile of one op call")
        err, tol = _mesh_check(k, sh, got.to_local(), args, index, world,
                               "[14b]")
        cases.append({"kernel": k, "shape": sh, "program": fn.shard.name,
                      "launches": fn.launches, "all_reduce": n_ar,
                      "max_abs_err": err, "tol": tol})
    if counts["dpia_cuda"] != sum(c["launches"] for c in cases) or \
            0 in [c["launches"] for c in cases]:
        raise AssertionError(f"[14b] launch counts {counts}, per program "
                             f"{[c['launches'] for c in cases]}")
    keys = [k for k in compiler.executor_cache().keys()
            if f"|shardmap|data={world}|" in k]
    aot = tempfile.mkdtemp(prefix="chip_smoke_mesh_aot_")
    try:
        written = compiler.executor_cache().save_aot(aot)
    finally:
        shutil.rmtree(aot, ignore_errors=True)
    if len(keys) != len(MESH_CASES) or written != 0:
        raise AssertionError(f"[14b] mesh executor keys {keys}, save_aot "
                             f"wrote {written}")
    # each op's call on every rank (the same count), then each rank's
    # shard alone while the other waits
    with compiler.options(opts):
        for c, (k, sh), args in zip(cases, MESH_CASES, inputs):
            c["op_ms"] = _timed_calls(lambda: _op_call(k, args, sh),
                                      MESH_TIMED_CALLS)
    for r in range(world):
        dist.barrier()
        if r == rank:
            for c, fn, (k, sh), args in zip(cases, fns, MESH_CASES, inputs):
                c.update(_shard_times(fn, args, k, sh, index, world))
    dist.barrier()
    t0 = time.perf_counter()
    res = autotune.tune("dot", n=MESH_TUNE_N, backend="shardmap", mesh=m,
                        measure=True, top_k=MESH_TUNE_TOP_K,
                        cache=tune_cache)
    tune = {"source": res.source, "params": res.params, "key": res.key,
            "timings_us": res.timings, "s": time.perf_counter() - t0}
    return {"rank": rank, "index": index, "cases": cases, "counts": counts,
            "keys": keys, "aot_written": written, "tune": tune}


def phase_mesh(smi, dpia):
    """[14] the pipeline on a mesh, in spawned ranks (``testing.ranks``):
    (a) one NCCL rank, (b) two gloo ranks sharing the card.  A failed rank
    fails the run."""
    from repro_torch.testing import ranks
    t0 = time.perf_counter()
    one = ranks.spawn(mesh_rank_one, 1, backend="nccl", device="cuda",
                      timeout=300)[0]
    t_one = time.perf_counter() - t0
    k4 = {(c["kernel"], json.dumps(c["shape"], sort_keys=True)): c["ms"]
          for c in dpia}
    for c in one:
        c["phase7_k4_ms"] = k4[(c["kernel"],
                                json.dumps(c["shape"], sort_keys=True))]
        log("[14a] data=1 (one NCCL rank) " + json.dumps(c))
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_tune_")
    try:
        t0 = time.perf_counter()
        two = ranks.spawn(mesh_rank_two, MESH_RANKS, backend="gloo",
                          device="cuda", timeout=400,
                          args=(os.path.join(tune_dir, "mesh.json"),))
        t_two = time.perf_counter() - t0
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)
    picks = [(r["tune"]["source"], r["tune"]["params"]) for r in two]
    if picks[0][0] != "measured" or any(p != picks[0] for p in picks):
        raise AssertionError(f"[14b] the measured mesh tune's picks by rank: "
                             f"{picks}")
    for r in two:
        for c in r["cases"]:
            c["phase7_k4_ms"] = k4[(c["kernel"],
                                    json.dumps(c["shape"], sort_keys=True))]
            log(f"[14b] data={MESH_RANKS}, rank {r['rank']} (two processes "
                f"sharing one card over gloo) " + json.dumps(c))
        log(f"[14b] rank {r['rank']}: launches {r['counts']}, executor keys "
            f"{r['keys']}, save_aot wrote {r['aot_written']}, tune "
            + json.dumps(r["tune"]))
    log(f"[14] summary: 14a {t_one:.1f} s, 14b {t_two:.1f} s (processes "
        f"included); per-shard K4 ms beside phase 7's single-device K4 ms "
        + json.dumps({c["program"]: [c["ms"], c["phase7_k4_ms"]]
                      for c in one + two[0]["cases"]}) + f"; card {smi}")
    return one, two


def mesh_kernel_entries(smi, one, two):
    """One kernels-line entry per mesh op (phase 14).  The head is 14b's
    first case on rank 0: the per-shard K4 time of two processes sharing
    the card, ``eager_ms`` its op call's time; launches are rank 0's in
    14b's main path, each rank's in ``launches_by_rank``; 14a's cases are
    listed too."""
    out = []
    for op in dict(MESH_CASES):
        by_rank = [[c for c in r["cases"] if c["kernel"] == op] for r in two]
        cs = by_rank[0]
        out.append({"name": f"dpia_cuda:mesh_{op}", **K4,
                    "launches": sum(c["launches"] for c in cs),
                    "launches_by_rank": [sum(c["launches"] for c in r)
                                         for r in by_rank],
                    "max_abs_err": max(c["max_abs_err"] for r in by_rank
                                       for c in r),
                    **{key: cs[0][key] for key in _HEAD_KEYS
                       if key != "eager_ms"},
                    "eager_ms": cs[0]["op_ms"], "card": smi,
                    "cases": [c for r in by_rank for c in r]
                    + [c for c in one if c["kernel"] == op]})
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 15: sharded serving
# ---------------------------------------------------------------------------

SHARD_RANKS = 2         # 15b / 15c: processes sharing the one card over gloo
# 15b / 15c (and their one-process fp32 engine): qwen3-4b at full width
# cut to 12 of its 36 layers since the script passed 1 100 s with phase 21
# (NVIDIA H100 80GB HBM3, 700 W; phase 15 58-79 s at full depth), to 6
# when phase 22 came (phase 15 56.5 s at 12 in a whole run of the script)
SHARD_FP32_LAYERS = 6
SHARD_LOST_AFTER = 2    # 15c: host 1 is lost at the third boundary
SHARD_EXIT_RANKS = 4    # 15d: processes sharing the card, one a host
# 15d: host 3's loss drops host 2 from the tail (4 slots do not divide 3
# positions: data=2), host 1's leaves rank 0 alone (data=1); each lost
# rank's process exits at its loss
SHARD_EXIT_PLAN = ("mesh.host_lost(host=3, after=2); "
                   "mesh.host_lost(host=1, after=4)")
SHARD_EXIT_SHRINKS = [("data=4", "data=2", 3), ("data=2", "data=1", 1)]


def sharded_engine(model, params, mesh, layout: str, **kw):
    """Phase 4b's engine shape as a ``ShardedEngine`` on ``mesh``."""
    from repro_torch.serve.engine import ShardedEngine
    return ShardedEngine(model, params, max_seq=continuous_max_seq(),
                         slots=SLOTS, chunk=CHUNK, kv_layout=layout,
                         block_size=BLOCK, prefill_chunk=PREFILL_CHUNK,
                         mesh=mesh, **kw)


def _sharded_run(engine, reqs, cfg, k3_variant: str):
    """One timed run of ``reqs`` on this rank (None tokens where its host
    was lost): K1 / K3 launches checked exactly against this rank's own
    prefill calls and admissions and its chunk's decode steps, every K3
    launch on ``k3_variant``, and the boundary ``all_gather`` calls
    counted against the boundaries."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    owned, calls = {}, {"boundaries": 0, "all_gather": 0}
    admissions, step, gather = (engine.sched.admissions, engine.step_chunk,
                                dist.all_gather)

    def admit():
        out = admissions()
        owned.update({rid: engine._lane(slot) is not None
                      for slot, rid in out})
        return out

    def counted_step():
        calls["boundaries"] += 1
        return step()

    def counted_gather(*a, **kw):
        calls["all_gather"] += 1
        return gather(*a, **kw)
    engine.sched.admissions, engine.step_chunk = admit, counted_step
    dist.all_gather = counted_gather
    try:
        torch.cuda.synchronize()
        before = engine.stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = engine.run_results(reqs, seed=5)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        del engine.sched.admissions, engine.step_chunk
        dist.all_gather = gather
    counts, variants = ops.launch_counts(), ops.launch_counts_by_variant()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    own = sum(owned.values())
    want = {"flash_attention": cfg.n_layers * own,
            "rmsnorm": (4 * cfg.n_layers + 1) * (prefills + steps),
            "matmul": 0, "dpia_cuda": 0, **NO_BWD}
    if counts != want or variants["flash_attention"][k3_variant] != \
            counts["flash_attention"]:
        raise AssertionError(f"[15] launches {counts} != {want} for "
                             f"{prefills} prefill calls, {own} admissions, "
                             f"{steps} decode steps; K3 "
                             f"{variants['flash_attention']}")
    toks = None if results is None else [list(r.tokens) for r in results]
    own_tokens = (None if results is None else
                  sum(len(r.tokens) for r in results if owned[r.req_id]))
    return {"tokens": toks, "s": dt, "own_tokens": own_tokens,
            "tok_s": None if toks is None else sum(map(len, toks)) / dt,
            "own_tok_s": None if toks is None else own_tokens / dt,
            "prefills": prefills, "admissions": own, "steps": steps,
            "launches": counts, "k1_variants": variants["rmsnorm"],
            "boundaries": calls["boundaries"],
            "all_gather": calls["all_gather"],
            "gather_s": after["mesh"]["gather_s"]
            - before["mesh"]["gather_s"],
            "recaptures_after_warm": after.get("recaptures_after_warm", 0),
            "graph_keys": [list(k) for k in after.get("graph_keys", ())],
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def sharded_rank_one(rank, world):
    """[15a] one NCCL rank (``data=1``), bf16, phase 4's weights: phase
    4b's traffic through ``ShardedEngine``, dense and paged, a warm run
    then a timed one with phase 4b's exact K1 / K3 counts."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    cfg, model, params = serve.build(ARCH, seed=0)
    mesh = make_mesh((1,), ("data",))
    reqs = continuous_requests(cfg.vocab)
    out = {}
    for layout in ("dense", "paged"):
        engine = sharded_engine(model, params, mesh, layout)
        engine.run(reqs, seed=5)                 # warm-up: captures
        toks, rep = _continuous_run(engine, reqs, cfg)
        run = _sharded_run(engine, reqs, cfg, "mma")
        if run["tokens"] != toks or run["all_gather"] != run["boundaries"] \
                or run["recaptures_after_warm"]:
            raise AssertionError(f"[15a] {layout}: two runs' tokens differ, "
                                 f"or {run['all_gather']} gathers for "
                                 f"{run['boundaries']} boundaries, or "
                                 f"{run['recaptures_after_warm']} "
                                 f"re-captures after warm-up")
        out[layout] = {**run, "continuous_run": rep,
                       "tok_s": [rep["tok_s"], run["tok_s"]]}
        del engine
    return out


def sharded_rank_two(rank, world, want, journal):
    """[15b] ``world`` ranks sharing the card over gloo, fp32 (TF32 off),
    2 slots a rank: dense and paged, a warm run then a timed one, tokens
    equal to the single process's; [15c] a fresh engine, dense then paged,
    with ``hosts=world`` and a journal under ``mesh.host_lost(host=1)``:
    rank 1 leaves, rank 0 serves every request on ``data=1``."""
    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.domains import SchedulerJournal
    from repro_torch.testing import faults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, params = serve.build(ARCH, seed=0, dtype="float32",
                                     n_layers=SHARD_FP32_LAYERS)
    mesh = make_mesh((world,), ("data",))
    reqs = continuous_requests(cfg.vocab)
    out = {"rank": rank}
    for layout in ("dense", "paged"):
        engine = sharded_engine(model, params, mesh, layout)
        engine.run(reqs, seed=5)                 # warm-up: captures
        run = _sharded_run(engine, reqs, cfg, "tf32x3")
        if run["tokens"] != want or run["all_gather"] != run["boundaries"] \
                or run["recaptures_after_warm"]:
            raise AssertionError(
                f"[15b] {layout}, rank {rank}: tokens equal to the single "
                f"process's: {run['tokens'] == want}; {run['all_gather']} "
                f"gathers for {run['boundaries']} boundaries; "
                f"{run['recaptures_after_warm']} re-captures after warm-up")
        out[layout] = run
        del engine
    for layout in ("dense", "paged"):
        obs.flight_clear()
        obs.clear_decisions()
        path = f"{journal}.{layout}"
        engine = sharded_engine(model, params, mesh, layout, hosts=world,
                                journal=path)
        with faults.inject(f"mesh.host_lost(host=1, after="
                           f"{SHARD_LOST_AFTER})") as plan:
            run = _sharded_run(engine, reqs, cfg, "tf32x3")
        st = engine.stats()
        run.update(
            fired=plan[0].fired, left=engine.left,
            descriptor=st["mesh"]["descriptor"],
            host_losses=st["resilience"]["host_losses"],
            evacuations=st["scheduler"]["evacuations"],
            captures_since_shrink=st["mesh"].get("captures_since_shrink"),
            dumps=[d["reason"] for d in obs.flight_dumps()],
            origin="degraded(mesh(data=2)->mesh(data=1))" in obs.explain())
        if rank == 0:
            state = SchedulerJournal.load(f"{path}.rank0")
            run["journal"] = {"clean": state.clean,
                              "shrinks": state.shrinks,
                              "evacuations": state.evacuations,
                              "terminals": len(state.terminals)}
        out[f"15c_{layout}"] = run
        del engine
    return out


def sharded_rank_exit(rank, world, want, journal):
    """[15d] ``world`` gloo ranks sharing the card, one a host
    (``hosts=world``), fp32 (TF32 off), 15b's model, dense: phase 4b's
    traffic under :data:`SHARD_EXIT_PLAN`.  Each lost rank's process
    exits at its loss (``ranks.die`` posts its run first) and calls
    nothing more; rank 0 serves every request on ``data=1``."""
    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.domains import SchedulerJournal
    from repro_torch.testing import faults, ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, params = serve.build(ARCH, seed=0, dtype="float32",
                                     n_layers=SHARD_FP32_LAYERS)
    mesh = make_mesh((world,), ("data",))
    reqs = continuous_requests(cfg.vocab)
    obs.flight_clear()
    obs.clear_decisions()
    engine = sharded_engine(model, params, mesh, "dense", hosts=world,
                            journal=journal)
    with faults.inject(SHARD_EXIT_PLAN) as plan:
        run = _sharded_run(engine, reqs, cfg, "tf32x3")
    st = engine.stats()
    run.update(
        rank=rank, fired=[f.fired for f in plan], left=engine.left,
        descriptor=st["mesh"]["descriptor"],
        host_losses=st["resilience"]["host_losses"],
        evacuations=st["scheduler"]["evacuations"],
        shrinks=st["mesh"]["shrinks"],
        dumps=[(d["reason"], d["ctx"]["frm"], d["ctx"]["to"])
               for d in obs.flight_dumps()],
        explain=obs.explain())
    if engine.left:
        ranks.die(run)
    state = SchedulerJournal.load(f"{journal}.rank{rank}")
    run["journal"] = {"clean": state.clean,
                      "shrinks": [(r["frm"], r["to"], r["host"])
                                  for r in state.shrinks],
                      "evacuations": state.evacuations,
                      "terminals": len(state.terminals)}
    return run


def _check_exit_drill(runs, want, smi):
    """[15d]'s checks: rank 0 alone on ``data=1`` with every request's tokens equal to the one-process fp32
    engine's, both shrinks dumped, recorded and journalled, the chunk
    captured anew at 2 and then 4 lanes; ranks 1-3 left at their losses
    (their runs were posted before they exited)."""
    r0 = runs[0]
    lanes = [k[0] for k in r0["graph_keys"]]
    # a rank's host losses seen and the descriptor it ended on
    seen = {0: (2, "data=1"), 1: (2, "data=2"), 2: (1, "data=4"),
            3: (1, "data=4")}
    bad = [r["rank"] for r in runs
           if (r["host_losses"], r["descriptor"]) != seen[r["rank"]]
           or (r["tokens"] is None) != (r["rank"] != 0)
           or r["left"] != (r["rank"] != 0)]
    origin = "degraded(mesh(data=2)->mesh(data=1))"
    if bad or r0["tokens"] != want or r0["fired"] != [1, 1] \
            or [(f, t) for _, f, t in r0["dumps"]] != \
            [(f, t) for f, t, _ in SHARD_EXIT_SHRINKS] \
            or {d[0] for d in r0["dumps"]} != {"host_lost"} \
            or origin not in r0["explain"] \
            or [(s["frm"], s["to"], s["host"]) for s in r0["shrinks"]] != \
            SHARD_EXIT_SHRINKS \
            or r0["journal"] != {"clean": True,
                                 "shrinks": SHARD_EXIT_SHRINKS,
                                 "evacuations": r0["evacuations"],
                                 "terminals": len(want)} \
            or lanes != sorted(lanes) or not {2, SLOTS} <= set(lanes) \
            or r0["all_gather"] != r0["boundaries"] + 2:
        raise AssertionError(
            f"[15d] two host losses with the lost ranks exiting: ranks "
            f"{bad} off; rank 0 "
            f"{ {k: v for k, v in r0.items() if k not in ('tokens', 'explain')} }"
            f", tokens equal {r0['tokens'] == want}")
    for s in r0["shrinks"]:
        log(f"[15d] shrink {s['frm']} -> {s['to']} (host {s['host']} lost): "
            f"rendezvous of the survivors {s['rendezvous_s'] * 1e3:.3f} ms, "
            f"re-placement gather {s['gather_bytes']} bytes sent by each "
            f"survivor in {s['gather_s'] * 1e3:.3f} ms (host clock); card "
            f"{smi}")
    log(f"[15d] {SHARD_EXIT_PLAN} on data={SHARD_EXIT_RANKS}, hosts="
        f"{SHARD_EXIT_RANKS}, fp32, {SHARD_FP32_LAYERS} layers, dense, the "
        f"lost ranks' processes exiting at their loss: rank 0 served every "
        f"request on {r0['descriptor']} to 15b's tokens; host_losses "
        f"{[r['host_losses'] for r in runs]}, evacuations "
        f"{r0['evacuations']}, flight dumps {r0['dumps']}, journal "
        f"{r0['journal']}, graph keys {r0['graph_keys']}; K1 / K3 launches "
        f"a rank {[(r['launches']['rmsnorm'], r['launches']['flash_attention']) for r in runs]}"
        f" (K3 `tf32x3`); {r0['boundaries']} boundaries, all_gather a rank "
        f"{[r['all_gather'] for r in runs]}, {r0['gather_s'] * 1e3:.3f} ms "
        f"in rank 0's; rank 0 {r0['s']:.2f} s; max memory GiB "
        f"{[round(r['max_memory_gib'], 2) for r in runs]}; card {smi}")


def phase_sharded(smi, want_bf16, tok_s_4b):
    """[15] sharded serving in spawned ranks (a failed rank fails the run):
    (a) one NCCL rank, bf16, tokens bitwise phase 4b's; (b) two gloo ranks
    sharing the card, fp32, tokens equal to one process's; (c) the
    host-loss drill on (b)'s ranks, dense and paged; (d) four gloo ranks,
    one a host, through two losses, the lost ranks' processes exiting."""
    from repro_torch.launch import serve
    from repro_torch.testing import ranks
    t_start = time.perf_counter()
    one = ranks.spawn(sharded_rank_one, 1, backend="nccl", device="cuda",
                      timeout=300)[0]
    t_one = time.perf_counter() - t_start
    for layout in ("dense", "paged"):
        r = one[layout]
        if r["tokens"] != want_bf16:
            raise AssertionError(f"[15a] {layout}: tokens differ from phase "
                                 f"4b's dense graph run")
        log(f"[15a] data=1 (one NCCL rank), bf16, {layout}: tokens bitwise "
            f"phase 4b's; tok/s {r['tok_s']} beside phase 4b's dense graph "
            f"median {tok_s_4b:.1f}; launches {r['launches']} (K1 variants "
            f"{r['k1_variants']}); {r['boundaries']} boundaries, "
            f"{r['all_gather']} all_gather, {r['gather_s'] * 1e3:.3f} ms in "
            f"them; re-captures after warm-up {r['recaptures_after_warm']}; "
            f"graph keys {r['graph_keys']}; card {smi}")
    # the single-process fp32 engine on the same traffic and slots, freed
    # before the ranks start (two fp32 ranks hold 2 x 5.9 GB of weights at
    # SHARD_FP32_LAYERS layers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, params = serve.build(ARCH, seed=0, dtype="float32",
                                     n_layers=SHARD_FP32_LAYERS)
    reqs = continuous_requests(cfg.vocab)
    single = continuous_engine(model, params, "dense", graph=True)
    single.run(reqs, seed=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = single.run(reqs, seed=5)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_tok_s = sum(map(len, want)) / single_s
    del single, model, params
    torch.cuda.empty_cache()
    jdir = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    try:
        t0 = time.perf_counter()
        two = ranks.spawn(sharded_rank_two, SHARD_RANKS, backend="gloo",
                          device="cuda", timeout=600,
                          args=(want, os.path.join(jdir, "15c.jsonl")))
        t_two = time.perf_counter() - t0
        t0 = time.perf_counter()
        exits = ranks.spawn(sharded_rank_exit, SHARD_EXIT_RANKS,
                            backend="gloo", device="cuda", timeout=600,
                            args=(want, os.path.join(jdir, "15d.jsonl")))
        t_exit = time.perf_counter() - t0
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    out = {"15a": {l: one[l]["launches"] for l in ("dense", "paged")}}
    for layout in ("dense", "paged"):
        rs = [r[layout] for r in two]
        combined = sum(map(len, want)) / max(r["s"] for r in rs)
        log(f"[15b] data={SHARD_RANKS} (gloo ranks sharing one card), fp32, "
            f"{SHARD_FP32_LAYERS} layers, "
            f"{layout}: tokens equal to one process's; tok/s combined "
            f"{combined:.1f}, per rank (its own slots' tokens) "
            f"{[round(r['own_tok_s'], 1) for r in rs]}, one process "
            f"{single_tok_s:.1f}; K1 / K3 launches per rank "
            f"{[(r['launches']['rmsnorm'], r['launches']['flash_attention']) for r in rs]}"
            f"; admissions per rank {[r['admissions'] for r in rs]}; "
            f"all_gather per rank {[r['all_gather'] for r in rs]} for "
            f"{rs[0]['boundaries']} boundaries, "
            f"{[round(r['gather_s'] * 1e3, 3) for r in rs]} ms in them; "
            f"re-captures after warm-up {[r['recaptures_after_warm'] for r in rs]}; "
            f"max memory GiB {[round(r['max_memory_gib'], 2) for r in rs]}; "
            f"card {smi}")
        out[f"15b_{layout}"] = [r["launches"] for r in rs]
    for layout in ("dense", "paged"):
        c0, c1 = two[0][f"15c_{layout}"], two[1][f"15c_{layout}"]
        keys = c0["graph_keys"]
        shrunk = keys[len(keys) - (c0["captures_since_shrink"] or 0):]
        if c0["tokens"] != want or c0["left"] \
                or c0["descriptor"] != "data=1" \
                or c0["host_losses"] != 1 or c0["dumps"] != ["host_lost"] \
                or not c0["origin"] or c0["fired"] != 1 \
                or not c0["captures_since_shrink"] \
                or any(k[0] != SLOTS for k in shrunk) \
                or len(set(map(tuple, shrunk))) != len(shrunk) \
                or c0["journal"]["clean"] is not True \
                or len(c0["journal"]["shrinks"]) != 1 \
                or c0["journal"]["terminals"] != len(want) \
                or c1["tokens"] is not None or not c1["left"]:
            raise AssertionError(
                f"[15c] {layout} host-loss drill: rank 0 "
                f"{ {k: v for k, v in c0.items() if k != 'tokens'} }, "
                f"tokens equal {c0['tokens'] == want}; rank 1 left "
                f"{c1['left']}")
        log(f"[15c] mesh.host_lost(host=1, after={SHARD_LOST_AFTER}) on "
            f"data={SHARD_RANKS}, hosts={SHARD_RANKS}, fp32, {layout}: rank "
            f"1 left, rank 0 served every request on {c0['descriptor']} to "
            f"15b's tokens; host_losses {c0['host_losses']}, evacuations "
            f"{c0['evacuations']}, captures after the shrink "
            f"{c0['captures_since_shrink']} {shrunk} (graph keys {keys}), "
            f"flight dumps {c0['dumps']}, journal {c0['journal']}; K1 / K3 "
            f"launches rank 0 {(c0['launches']['rmsnorm'], c0['launches']['flash_attention'])}"
            f", rank 1 {(c1['launches']['rmsnorm'], c1['launches']['flash_attention'])}"
            f" (until it left); {c0['boundaries']} boundaries, all_gather "
            f"rank 0 {c0['all_gather']} (one re-placement included), rank 1 "
            f"{c1['all_gather']}; {c0['s']:.2f} s; card {smi}")
        out[f"15c_{layout}"] = [c0["launches"], c1["launches"]]
    _check_exit_drill(exits, want, smi)
    out["15d"] = [r["launches"] for r in exits]
    log(f"[15] summary: 15a {t_one:.1f} s, 15b + 15c {t_two:.1f} s, 15d "
        f"{t_exit:.1f} s (processes included), phase 15 "
        f"{time.perf_counter() - t_start:.1f} s; card {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 16: training on the data axes
# ---------------------------------------------------------------------------

SHARDED_TRAIN_STEPS_ONE = 3   # 16a: one-device steps, then mesh steps
# 16a: qwen3-4b at full width cut to 12 of its 36 layers since the script
# passed 1 100 s with phase 21 (NVIDIA H100 80GB HBM3, 700 W; 16a 28-42 s
# at full depth), to 6 when phase 22 came (27.8 s at 12, a whole run);
# its bits are compared at any depth
SHARDED_ONE_LAYERS = 6
SHARDED_TRAIN_STEPS = 2       # 16b / 16c
SHARDED_TRAIN_RANKS = 2       # 16b / 16c: processes sharing the one card
# 16b / 16c / 17a / 17b: depth cut.  Two fp32 states with gradients (16
# bytes a param: qwen3-4b 0.101 B a layer + 0.778 B embed and head; yi-9b
# 0.173 B a layer + 0.524 B) would share the card at 8 layers; 4 halves the
# layers' bytes that gloo moves through the host (~0.8 GB/s between the
# processes), which set the phases' time: qwen3-4b ~19 GB a rank, yi-9b
# ~19 GB whole, ~10 GB a rank under FSDP
# 16b / 16c went to 2 layers when phase 17 (TP, its four-rank 17b the
# longest part) added 3.4 minutes to the script: the cut keeps phases
# 16 + 17 near phase 16's earlier time.  17a / 17b went to 2 layers too
# when phase 19 (the recurrent families' eager time loops) took the
# script past 1 000 s (1 090 s before 19d on an NVIDIA H100 80GB HBM3 at
# 700 W; 179 s of it phase 17's at 4 layers).  All four went to one layer
# when phase 20 took the script to 1 253 s (same card; phase 16 171.1 s,
# 17 155.9 s at 2 layers)
SHARDED_TRAIN_LAYERS = 1
DATA_AXIS_LAYERS = 1
# 16b / 16c against the one-device step: 13e's card-vs-CPU tolerance (fp32,
# TF32 off; sums in other orders), loss and gradient norm 1e-5 relative;
# params also get 2 % of the one-device step's largest update of the leaf
# (AdamW's update lr * m / sqrt(v) is O(lr) however small the gradient, so
# where a gradient is near its sums' rounding the update's own error is
# of the update's order; the CPU tests' 8-bit bound has the same form)
SHARDED_STATE_TOL = STATE_TOL
SHARDED_UPDATE_TOL = 2e-2
SHARDED_METRIC_RTOL = 1e-5


def _train_launches_a_step(cfg) -> dict:
    """K1 / K3 forward and backward launches of one remat train step:
    remat runs every block's (every hybrid group's) norms and attention
    again in its recompute, the final norm once."""
    per_pass = norms_a_pass(cfg) + (2 * cfg.n_layers if cfg.qk_norm else 0)
    return {"rmsnorm": 2 * per_pass - 1, "rmsnorm_bwd": per_pass,
            "flash_attention": 2 * attention_sites(cfg),
            "flash_attention_bwd": attention_sites(cfg)}


def _sharded_steps(step, state, batches, cfg, variant, groups=None,
                   phase="16"):
    """Run ``batches`` through ``step``, counts zeroed just before each
    step and read just after: per step its metrics, seconds, K1 / K3
    launches (checked exactly, every K3 launch on ``variant``) and, with
    ``groups`` (name -> a collectives group), each group's collectives."""
    from repro_torch.kernels import ops
    want = _train_launches_a_step(cfg)
    groups = groups or {}
    rows = []
    for batch in batches:
        before = {n: dict(g.counts) for n, g in groups.items()}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if k in want}
        by_v = ops.launch_counts_by_variant()
        if counts != want or any(
                by_v[k][variant] != want[k]
                for k in ("flash_attention", "flash_attention_bwd")):
            raise AssertionError(f"[{phase}] launches {counts} (K3 {by_v}) "
                                 f"!= {want} a step, K3 all {variant}")
        rows.append({**m, "s": dt, "launches": counts, "collectives": {
            n: {k: v - before[n].get(k, 0) for k, v in g.counts.items()}
            for n, g in groups.items()}})
    return state, rows


def _state_bytes(state) -> int:
    from repro_torch.optim import adamw
    return sum(t.numel() * t.element_size()
               for _, leaf in adamw.leaves(state)
               for t in (leaf if isinstance(leaf, adamw.QTensor) else (leaf,)))


def sharded_train_one(rank, world):
    """[16a] one NCCL rank (``data=1``), qwen3-4b at full width cut to
    SHARDED_ONE_LAYERS layers,
    bf16, remat, 13b's batch, lr and warm-up: 3 one-device steps, then 3
    mesh steps from the same seed-0 weights; loss, grad norm and every
    tensor's bits (checksums) compared."""
    import gc
    # deterministic algorithms (the embedding's gradient without atomics)
    # want this set before cuBLAS starts, which it has not in this process
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.sharding import ctx
    from repro_torch.train.step import make_train_state, make_train_step
    cfg = config(ARCH, n_layers=SHARDED_ONE_LAYERS)
    model = Model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    batches = [data.global_batch_at(i)
               for i in range(SHARDED_TRAIN_STEPS_ONE)]
    kw = dict(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    out = {}
    for label, mesh in (("one_device", None),
                        ("mesh", make_mesh((1, 1), ("data", "model")))):
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(
            model, torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
        step = make_train_step(model, mesh, **kw)
        state, rows = _sharded_steps(step, state, batches, cfg, "mma")
        out[label] = {"steps": rows, "checksums": checksums(state),
                      "state_bytes": _state_bytes(state),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    ctx.set_mesh(None)
    return out


# _held_to_oracle's elements a chunk: the comparison's temporaries of a
# (16, 6144, 10 752) expert leaf whole (4 GB each in fp32) did not fit
# beside 18d's two ranks on one H100
ORACLE_CHUNK = 1 << 24


def _chunks(flat, scale, device):
    """``flat`` (a 1-D tensor, on the host or the card) chunk by chunk on
    ``device``, dequantized by ``scale`` where given."""
    for lo in range(0, flat.numel(), ORACLE_CHUNK):
        c = flat[lo:lo + ORACLE_CHUNK].to(device)
        yield c.float() * scale if scale is not None else c


def _held_to_oracle(state, specs, place, oracle, start, floor=None):
    """Every leaf of a mesh ``state``, gathered whole over the data and
    model groups of the step's placement ``place`` one at a time (a
    collective on every rank), against the one-device step's
    final state ``oracle`` (host tensors by path, an 8-bit moment as its
    ``(q, scale)``, on the group's first rank; None elsewhere) from
    ``start`` (its params at the start; 8-bit moments are compared
    dequantized, within one quantization step more), ``ORACLE_CHUNK``
    elements at a time:
    ``(worst error over the leaf's largest magnitude by part, params also
    over the largest update; the leaves beyond the tolerance; a float64
    sum of each gathered leaf)``.  With ``floor``, a param element whose
    oracle first moment is under ``floor`` of its leaf's largest (a
    gradient at its sums' rounding, where the update is the rounding's
    sign) is held to twice the leaf's largest update instead, as
    ``tests/test_torch_tp_train.py`` holds it; ``worst`` then also counts
    the elements past the plain tolerance (``beyond_plain``) and how many
    of them lie under the floor (``beyond_plain_floored``)."""
    from repro_torch.optim import adamw
    from repro_torch.sharding.collectives import gather_whole
    worst, bad, sums = {}, [], []
    for path, t in adamw.leaves(state):
        spec = specs
        for k in path:
            spec = spec[k]
        scale = None
        if isinstance(t, adamw.QTensor):
            # an 8-bit moment, dequantized (the oracle's too): within one
            # quantization step of it
            spec, scale = spec.q, t.scale
            t = t.q
        whole = gather_whole(t.detach(), spec, place.group,
                             place.model).reshape(-1)
        dev = whole.device
        sums.append(sum(c.double().sum().item()
                        for c in _chunks(whole, scale, dev)))
        if oracle is None:
            continue
        want = oracle[path]
        if scale is None and not whole.is_floating_point():
            if not torch.equal(whole.cpu(), want.reshape(-1)):
                bad.append("/".join(map(str, path)))
            continue
        want, w_scale = want if isinstance(want, tuple) else (want, None)
        want = want.reshape(-1)
        w_max = max(c.abs().max().item()
                    for c in _chunks(want, w_scale, dev))
        part = path[0] if path[0] != "opt" else path[1]
        update = None
        if part == "params":
            update = max((c - s0.to(dev)).abs().max().item() for c, s0 in
                         zip(_chunks(want, None, dev), _chunks(
                             start[path[1:]].reshape(-1), None, "cpu")))
        step = 0.0 if scale is None else scale.item()
        m_chunks = None
        if floor is not None and update is not None:
            m_want = oracle[("opt", "m") + path[1:]]
            m_want, m_scale = (m_want if isinstance(m_want, tuple)
                               else (m_want, None))
            m_want = m_want.reshape(-1)
            m_cut = floor * max(c.abs().max().item()
                                for c in _chunks(m_want, m_scale, dev))
            m_chunks = _chunks(m_want, m_scale, dev)
        err_max, beyond = 0.0, False
        for g, w in zip(_chunks(whole, scale, dev),
                        _chunks(want, w_scale, dev)):
            err = (g - w).abs()
            tol = SHARDED_STATE_TOL[0] * w_max + \
                SHARDED_STATE_TOL[1] * w.abs() + step
            if update is not None:
                tol = tol + SHARDED_UPDATE_TOL * update
            if m_chunks is not None:
                floored = next(m_chunks).abs() < m_cut
                past = err > tol
                worst["beyond_plain"] = worst.get("beyond_plain", 0) + \
                    int(past.sum().item())
                worst["beyond_plain_floored"] = worst.get(
                    "beyond_plain_floored", 0) + int(
                        (past & floored).sum().item())
                tol = torch.where(floored, tol.clamp(min=2 * update), tol)
            err_max = max(err_max, err.max().item())
            beyond = beyond or bool((err > tol).any())
        worst[part] = max(worst.get(part, 0.0), err_max / max(w_max, 1e-30))
        if update is not None:
            worst["params_over_update"] = max(
                worst.get("params_over_update", 0.0),
                err_max / max(update, 1e-30))
        if beyond:
            bad.append("/".join(map(str, path)))
        del whole
    return worst, bad, sums


# 16b / 16c: arch; both run in one spawn of the two ranks (a process's
# first fp32 step is the slow one)
DATA_AXIS_CELLS = {"16b": "qwen3_4b", "16c": "yi_9b"}


def data_axis_ranks(rank, world):
    """[16b] and [16c] in one spawn of two gloo ranks sharing the card
    (one start-up of the processes for both): :func:`sharded_train_two`
    for each of DATA_AXIS_CELLS, each cell's seconds."""
    out = {}
    for label, arch in DATA_AXIS_CELLS.items():
        t0 = time.perf_counter()
        out[label] = sharded_train_two(rank, world, arch)
        out[label]["cell_s"] = time.perf_counter() - t0
    return out


def sharded_train_two(rank, world, arch, cfg_kw=None, shape=None,
                      phase="16", floor=None):
    """[16b] (qwen3-4b: DP) / [16c] (yi-9b: FSDP) on ``world`` gloo ranks
    sharing the card, fp32 (TF32 off), cut to DATA_AXIS_LAYERS layers
    (``cfg_kw`` overrides the config; ``shape`` is (batch, seq), 13b's by
    default; ``floor`` goes to :func:`_held_to_oracle`): rank 0 first runs
    the one-device step on the global batches
    (the other waits) and keeps the final state on the host; then every
    rank runs the mesh step from the same seed-0 weights, and each leaf,
    gathered whole, is held to that state on rank 0."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding import ctx
    from repro_torch.train.step import (make_train_state, make_train_step,
                                        state_specs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(arch, **{"n_layers": DATA_AXIS_LAYERS, "dtype": "float32",
                          **(cfg_kw or {})})
    model = Model(cfg)
    batch, seq = shape or (TRAIN_BATCH, TRAIN_SEQ)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    batches = [data.global_batch_at(i) for i in range(SHARDED_TRAIN_STEPS)]
    kw = dict(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    out = {"rank": rank, "fsdp": cfg.fsdp}
    oracle = start = None
    if rank == 0:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(
            model, torch.Generator(device="cuda").manual_seed(0))
        start = {p: t.detach().to("cpu")
                 for p, t in adamw.leaves(state["params"])}
        state, rows = _sharded_steps(make_train_step(model, **kw), state,
                                     batches, cfg, "tf32x3", phase=phase)
        oracle = {p: t.detach().to("cpu") for p, t in adamw.leaves(state)}
        out["one_device"] = {
            "steps": rows, "state_bytes": _state_bytes(state),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "s": time.perf_counter() - t0}
        del state
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh((world, 1), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
    out["init_s"] = time.perf_counter() - t0
    out["state_bytes"] = _state_bytes(state)
    step = make_train_step(model, mesh, **kw)
    group = step.placement.group
    state, out["steps"] = _sharded_steps(step, state, batches, cfg, "tf32x3",
                                         {"data": group}, phase=phase)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # every leaf whole (gathered one at a time) against the one-device step
    specs = state_specs(make_train_state(model, torch.Generator(),
                                         device="meta"), mesh, cfg)
    worst, bad, _ = _held_to_oracle(state, specs, step.placement, oracle,
                                    start, floor)
    out["worst_rel_to_leaf_max"], out["bad_leaves"] = worst, bad
    del state, step, oracle, start
    gc.collect()
    torch.cuda.empty_cache()
    ctx.set_mesh(None)
    return out


def phase_sharded_train(smi, train13, cells=None):
    """[16] training on the data axes, in spawned ranks (a failed rank
    fails the run): (a) one NCCL rank, bitwise the one-device step; (b)
    DP and (c) FSDP on two gloo ranks sharing the card, each held to the
    one-device step, (c)'s per-rank state bytes to the dry run's
    (``cells``: (b) and (c)'s ranks' results from the shared spawn of
    :func:`two_rank_cells`, else they run in a spawn of their own).
    Returns the launches a step."""
    import gc

    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    # 13b's numbers to print beside 16a's (none when run alone)
    train13 = train13 or {"median_step_s": math.nan, "peak_gib": math.nan,
                          "launches_a_step": None}
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[16] start: main process {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved")
    one = ranks.spawn(sharded_train_one, 1, backend="nccl", device="cuda",
                      timeout=400)[0]
    t_one = time.perf_counter() - t_start
    a, b = one["one_device"], one["mesh"]
    for x, y in zip(a["steps"], b["steps"]):
        if (x["loss"], x["grad_norm"], x["applied"]) != (
                y["loss"], y["grad_norm"], y["applied"]) or x["applied"] != 1:
            raise AssertionError(f"[16a] one-device {x} != mesh {y}")
    if a["checksums"] != b["checksums"] or \
            a["state_bytes"] != b["state_bytes"]:
        raise AssertionError("[16a] the mesh step's state differs from the "
                             "one-device step's")
    med = statistics.median(r["s"] for r in b["steps"][1:])
    launches16 = {"16a": b["steps"][0]["launches"]}
    log(f"[16a] data=1 (one NCCL rank), qwen3-4b at full width cut to "
        f"{SHARDED_ONE_LAYERS} layers (13b's numbers beside it are full "
        f"depth's), bf16, "
        f"remat, batch {TRAIN_BATCH} x {TRAIN_SEQ}, deterministic algorithms: "
        f"{SHARDED_TRAIN_STEPS_ONE} one-device steps then "
        f"{SHARDED_TRAIN_STEPS_ONE} mesh steps from seed 0, loss, grad norm "
        f"and every tensor bitwise equal (checksums of "
        f"{len(a['checksums']) // 2} tensors); losses "
        f"{[r['loss'] for r in b['steps']]}; step s one-device "
        f"{[round(r['s'], 4) for r in a['steps']]}, mesh "
        f"{[round(r['s'], 4) for r in b['steps']]} (median after the first "
        f"{med:.4f}) beside 13b's {train13['median_step_s']:.4f}; peak GiB "
        f"{a['peak_gib']:.2f} / {b['peak_gib']:.2f} beside 13b's "
        f"{train13['peak_gib']:.2f}; K1 / K3 launches a step "
        f"{b['steps'][0]['launches']} beside 13b's "
        f"{train13['launches_a_step']}; card {smi}")
    times = {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    both = cells
    if both is None:
        both = ranks.spawn(data_axis_ranks, SHARDED_TRAIN_RANKS,
                           backend="gloo", device="cuda", timeout=900)
    times["16b + 16c"] = time.perf_counter() - t0
    for label, arch in DATA_AXIS_CELLS.items():
        two = [r[label] for r in both]
        times[label] = max(r["cell_s"] for r in two)
        ref = two[0]["one_device"]
        cfg = config(arch, n_layers=DATA_AXIS_LAYERS, dtype="float32")
        reckoned = dryrun.reckon(
            cfg, {"seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "kind": "train"},
            {"data": SHARDED_TRAIN_RANKS, "model": 1})["memory"]
        for r in two:
            for x, y in zip(r["steps"], ref["steps"]):
                for key in ("loss", "grad_norm"):
                    if not math.isclose(x[key], y[key],
                                        rel_tol=SHARDED_METRIC_RTOL):
                        raise AssertionError(
                            f"[{label}] rank {r['rank']} {key} {x[key]} vs "
                            f"the one-device step's {y[key]}")
                if x["applied"] != 1 or x["lr"] != y["lr"]:
                    raise AssertionError(f"[{label}] rank {r['rank']}: {x}")
            if label == "16c" and r["state_bytes"] != reckoned["state_bytes"]:
                raise AssertionError(
                    f"[16c] rank {r['rank']} holds {r['state_bytes']} bytes "
                    f"of state, the dry run reckons "
                    f"{reckoned['state_bytes']}")
        if two[0]["bad_leaves"]:
            raise AssertionError(f"[{label}] leaves beyond the tolerance "
                                 f"{SHARDED_STATE_TOL} (params + "
                                 f"{SHARDED_UPDATE_TOL} x update): "
                                 f"{two[0]['bad_leaves']} (worst "
                                 f"{two[0]['worst_rel_to_leaf_max']})")
        launches16[label] = [r["steps"][0]["launches"] for r in two]
        mode = "FSDP" if two[0]["fsdp"] else "DP"
        log(f"[{label}] {mode}, {arch} at full width cut to "
            f"{DATA_AXIS_LAYERS} layers (two fp32 states share the one "
            f"card), fp32 (TF32 off), data={SHARDED_TRAIN_RANKS} (gloo ranks "
            f"sharing one card), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
            f"{SHARDED_TRAIN_STEPS} steps: loss, grad norm, lr and every leaf "
            f"against the one-device step (tolerance {SHARDED_STATE_TOL}, "
            f"params + {SHARDED_UPDATE_TOL} x the leaf's largest update, "
            f"metrics {SHARDED_METRIC_RTOL} relative): worst error over the "
            f"leaf's largest magnitude (params: and over its largest update) "
            f"{two[0]['worst_rel_to_leaf_max']}; "
            + json.dumps({
                "one_device": {k: ref[k] for k in ("state_bytes", "peak_gib",
                                                   "s")},
                "one_device_steps": [{k: s[k] for k in ("loss", "grad_norm",
                                                        "s")}
                                     for s in ref["steps"]],
                "dryrun_memory": reckoned,
                "ranks": [{"rank": r["rank"], "state_bytes": r["state_bytes"],
                           "peak_gib": r["peak_gib"], "init_s": r["init_s"],
                           "steps": r["steps"]} for r in two]})
            + f"; {times[label]:.1f} s in the ranks; card {smi}")
    log(f"[16] summary: 16a {t_one:.1f} s, 16b + 16c "
        f"{times['16b + 16c']:.1f} s (processes included unless they ran in "
        f"the shared spawn; 16b {times['16b']:.1f} s, 16c "
        f"{times['16c']:.1f} s in the ranks), "
        f"phase 16 {time.perf_counter() - t_start:.1f} s; card {smi}")
    return launches16


# ---------------------------------------------------------------------------
# phase 17: the model axis in training
# ---------------------------------------------------------------------------

# 17a: TP + SP; 17b: FSDP + TP.  Both at full width cut to
# SHARDED_TRAIN_LAYERS layers, fp32, 13b's batch; their ranks share the one
# card over gloo (NCCL refuses two ranks on one card)
TP_TRAIN_CELLS = {"17a": ("qwen3_4b", (1, 2)), "17b": ("yi_9b", (2, 2))}


def phase_tp_kernels(k1):
    """[17k] K1, K3 and their backward kernels against their plain
    versions at a tensor-parallel rank's shapes in 17a (qwen3-4b on
    ``model=2``, batch 4 x 512): K1 on the rank's sequence rows (4 x 256,
    d_model) and on its 16 query / 4 kv heads' rows (q_norm, k_norm); K3
    on its 16 / 4 heads at S 512, fp32 (what phase 17 runs) and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    ptxas = bwd_ptxas()
    rows, t = TRAIN_BATCH * TRAIN_SEQ // 2, TRAIN_BATCH * TRAIN_SEQ
    shapes = ((rows, 2560), (t * 16, 128), (t * 4, 128))
    out = {
        "rmsnorm": [_rmsnorm_case(r, d, torch.float32, gen, k1)
                    for r, d in shapes],
        "rmsnorm_bwd": [_rmsnorm_bwd_case(r, d, torch.float32, gen, ptxas)
                        for r, d in shapes],
        "flash_attention": [_flash_case(TRAIN_SEQ, TRAIN_SEQ, True, 0, gen,
                                        b=TRAIN_BATCH, nh=16, nkv=4, dtype=dt)
                            for dt in (torch.float32, torch.bfloat16)],
        "flash_attention_bwd": [_flash_bwd_case(TRAIN_BATCH, 16, 4, TRAIN_SEQ,
                                                128, dt, gen, ptxas)
                                for dt in (torch.float32, torch.bfloat16)]}
    for name, cs in out.items():
        for c in cs:
            log(f"[17k] {name} " + json.dumps(c))
    return out


def tp_train_rank(rank, world, arch, shape, layers=None, bs=None,
                  count=False):
    """[17a] / [17b] (and phase 20's cells) on ``world`` gloo ranks sharing
    the card, the mesh ``(data, model) = shape``, fp32 (TF32 off), cut to
    ``layers`` (SHARDED_TRAIN_LAYERS) layers, a global batch of ``bs``
    (batch, seq; 13b's by default): rank 0 first runs the one-device step
    on the global batches (the others wait) and keeps the final state on
    the host; then every rank runs SHARDED_TRAIN_STEPS mesh steps from the
    same seed-0 weights, K1 / K3 counted exactly a step on every rank;
    every leaf, gathered whole over both axes, is held to that state on
    rank 0 and summed on every rank (the ranks' sums must agree).  With
    ``count``, one more step is counted by ``analysis.hlo_counter`` on
    every rank, scaled and in full (:func:`counted`)."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding import ctx
    from repro_torch.train.step import (make_train_state, make_train_step,
                                        state_specs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(arch, n_layers=layers or SHARDED_TRAIN_LAYERS,
                 dtype="float32")
    model = Model(cfg)
    n_batch, seq = bs or (TRAIN_BATCH, TRAIN_SEQ)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=n_batch))
    batches = [data.global_batch_at(i) for i in range(SHARDED_TRAIN_STEPS)]
    kw = dict(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    out = {"rank": rank, "fsdp": cfg.fsdp}
    oracle = start = None
    if rank == 0:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(
            model, torch.Generator(device="cuda").manual_seed(0))
        start = {p: t.detach().to("cpu")
                 for p, t in adamw.leaves(state["params"])}
        state, rows = _sharded_steps(make_train_step(model, **kw), state,
                                     batches, cfg, "tf32x3", phase="17")
        oracle = {p: t.detach().to("cpu") for p, t in adamw.leaves(state)}
        out["one_device"] = {
            "steps": rows, "state_bytes": _state_bytes(state),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "s": time.perf_counter() - t0}
        del state
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh(shape, ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
    out["init_s"] = time.perf_counter() - t0
    out["state_bytes"] = _state_bytes(state)
    # the init draws the global params on every rank before cutting them
    out["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(model, mesh, **kw)
    place = step.placement
    out["sp"] = place.tensor_parallel(seq).sp
    state, out["steps"] = _sharded_steps(
        step, state, batches, cfg, "tf32x3",
        {"data": place.group, "model": place.model, "world": place.world},
        phase="17")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    specs = state_specs(make_train_state(model, torch.Generator(),
                                         device="meta"), mesh, cfg)
    out["worst_rel_to_leaf_max"], out["bad_leaves"], out["sums"] = \
        _held_to_oracle(state, specs, place, oracle, start)
    if count:
        out["count"] = counted(step, state, batches[0])
    del state, step, oracle, start
    gc.collect()
    torch.cuda.empty_cache()
    ctx.set_mesh(None)
    return out


def tp_cell(smi, label, arch, shape, backend="gloo", layers=None, bs=None,
            report=None, results=None):
    """Run one phase-17 cell (``tp_train_rank`` on a ``shape`` mesh, its
    ranks over ``backend``: gloo ranks share the card, NCCL takes one card
    a rank), check it (every rank's metrics against the one-device step's,
    its state bytes against ``launch.dryrun.reckon``'s, its gathered
    leaves the same as rank 0's, SP on; rank 0's leaves within 16b /
    16c's tolerances) and log it; returns each rank's K1 / K3 launches a
    step and the seconds it took.  ``layers`` and ``bs`` (batch, seq) go
    to the ranks; with ``report`` (a dict), the ranks also count a step
    (:func:`counted`) and ``report`` gets each rank's counts and steps.
    With ``results`` (each rank's ``tp_train_rank`` output from a spawn
    that ran several cells) it checks and logs those."""
    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    t0 = time.perf_counter()
    world = shape[0] * shape[1]
    layers = layers or SHARDED_TRAIN_LAYERS
    n_batch, seq = bs or (TRAIN_BATCH, TRAIN_SEQ)
    if results is None:
        res = ranks.spawn(tp_train_rank, world, backend=backend,
                          device="cuda", timeout=900,
                          args=(arch, shape, layers, (n_batch, seq),
                                report is not None))
        took, where_s = time.perf_counter() - t0, "with the processes"
    else:
        res = results
        took, where_s = res[0]["cell_s"], "on rank 0, in a shared spawn"
    ref = res[0]["one_device"]
    cfg = config(arch, n_layers=layers, dtype="float32")
    mesh = {"data": shape[0], "model": shape[1]}
    reckoned = dryrun.reckon(
        cfg, {"seq": seq, "batch": n_batch, "kind": "train"},
        mesh)["memory"]
    for r in res:
        for x, y in zip(r["steps"], ref["steps"]):
            for key in ("loss", "grad_norm"):
                if not math.isclose(x[key], y[key],
                                    rel_tol=SHARDED_METRIC_RTOL):
                    raise AssertionError(
                        f"[{label}] rank {r['rank']} {key} {x[key]} vs "
                        f"the one-device step's {y[key]}")
            if x["applied"] != 1 or x["lr"] != y["lr"]:
                raise AssertionError(f"[{label}] rank {r['rank']}: {x}")
        if r["state_bytes"] != reckoned["state_bytes"]:
            raise AssertionError(
                f"[{label}] rank {r['rank']} holds {r['state_bytes']} "
                f"bytes of state, the dry run reckons "
                f"{reckoned['state_bytes']}")
        if r["sums"] != res[0]["sums"]:
            raise AssertionError(f"[{label}] rank {r['rank']}'s gathered "
                                 f"leaves differ from rank 0's")
        if not r["sp"]:
            raise AssertionError(f"[{label}] SP is off at seq {seq}")
    if res[0]["bad_leaves"]:
        raise AssertionError(f"[{label}] leaves beyond the tolerance "
                             f"{SHARDED_STATE_TOL} (params + "
                             f"{SHARDED_UPDATE_TOL} x update): "
                             f"{res[0]['bad_leaves']} (worst "
                             f"{res[0]['worst_rel_to_leaf_max']})")
    mode = "FSDP + TP" if res[0]["fsdp"] else "TP + SP"
    where = (f"{world} gloo ranks sharing one card" if backend == "gloo"
             else f"{world} {backend} ranks, a card each")
    if report is not None:
        report.update({"counts": [r["count"] for r in res],
                       "steps": [r["steps"] for r in res]})
    log(f"[{label}] {mode}, {arch} at full width cut to "
        f"{layers} layers, fp32 (TF32 off), {mesh} ({where}), "
        f"batch {n_batch} x {seq} (SP on), {SHARDED_TRAIN_STEPS} "
        f"steps: loss, grad norm, lr and every leaf against the one-device "
        f"step (tolerance {SHARDED_STATE_TOL}, params + {SHARDED_UPDATE_TOL} "
        f"x the leaf's largest update, metrics {SHARDED_METRIC_RTOL} "
        f"relative; every rank's gathered leaves the same): worst error "
        f"over the leaf's largest magnitude (params: and over its largest "
        f"update) {res[0]['worst_rel_to_leaf_max']}; "
        + json.dumps({
            "one_device": {k: ref[k] for k in ("state_bytes", "peak_gib",
                                               "s")},
            "one_device_steps": [{k: s[k] for k in ("loss", "grad_norm", "s")}
                                 for s in ref["steps"]],
            "dryrun_memory": reckoned,
            "ranks": [{"rank": r["rank"], "state_bytes": r["state_bytes"],
                       "peak_gib": r["peak_gib"],
                       "init_peak_gib": r["init_peak_gib"],
                       "init_s": r["init_s"], "steps": r["steps"]}
                      for r in res]})
        + f"; {took:.1f} s {where_s}; card {smi}")
    return [r["steps"][0]["launches"] for r in res], took


def phase_tp_train(smi, results_17a=None):
    """[17] the model axis in training, in spawned gloo ranks sharing the
    card (a failed rank fails the run): (a) TP + SP, qwen3-4b on
    ``model=2``; (b) FSDP + TP, yi-9b on ``data=2, model=2``
    (:func:`tp_cell`).  ``results_17a``: 17a's ranks' results from the
    shared spawn of :func:`two_rank_cells`, checked and logged here."""
    import gc
    t_start = time.perf_counter()
    launches, times = {}, {}
    for label, (arch, shape) in TP_TRAIN_CELLS.items():
        gc.collect()
        torch.cuda.empty_cache()
        launches[label], times[label] = tp_cell(
            smi, label, arch, shape,
            results=results_17a if label == "17a" else None)
    log(f"[17] summary: 17a {times['17a']:.1f} s, 17b {times['17b']:.1f} s "
        f"(processes included; 17a's in the shared spawn when it ran "
        f"there), phase 17 {time.perf_counter() - t_start:.1f} s; card "
        f"{smi}")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the transformer families (moe, vlm, audio, two more dense)
# ---------------------------------------------------------------------------

# depth cuts (None: every layer): bf16 weights a part holds on the card
# (``ModelConfig.param_count`` x 2 bytes): dbrx-132b 4 x 3.26 B + 1.23 B
# = 28.5 GB, musicgen-large 6.5 GB whole, stablelm-1.6b 3.3 GB whole,
# qwen1.5-32b 8 x 0.53 B + 1.56 B = 11.5 GB, chameleon-34b 8 x 0.69 B +
# 1.07 B = 13.2 GB, grok-1-314b 2 x 4.92 B + 1.61 B = 22.9 GB.  dbrx went
# from 4 to 2 layers and musicgen from its 48 to 24 when phase 22 came
# (18a 25.2 s, 18b 15.5 s in a whole run of the script)
FAMILY_LAYERS = {"dbrx_132b": 2, "musicgen_large": 24,
                 "stablelm_1_6b": None, "qwen1_5_32b": 8,
                 "chameleon_34b": 8, "grok_1_314b": 2}
# 18c: one static prefill of two prompts and its decode steps
FAMILY_PROMPT_LENS = (48, 17)
FAMILY_MAX_NEW = 8
# 18a's fp32 check against the CPU: 2 layers of dbrx-132b at full width
# (31 GB of fp32 weights on each side), one prefill and one decode step;
# fp32 on both sides, TF32 off, sums in other orders (phase 5's tolerance)
MOE_CPU_LAYERS = 2
MOE_CPU_PROMPT_LENS = (64, 23)
# 18d: dbrx-132b at full width, 1 layer, capacity factor 2 (a
# destination's cap = tl * k: nothing drops, so the two-rank step and the
# one-process step compute the same function), batch 4 x 128, lr 0 (the
# 8-bit moments hold the gradients, the params keep their bits), two
# steps on two batches.  bf16: in fp32 the one-process yardstick holds 45
# GB of params and gradients (4.49 B params), and AdamW's fp32 temporaries
# of one (16, 6144, 10 752) expert leaf took it past the H100's 80 GB; in
# bf16 it holds 27 GB.  At batch 4 x 512 the
# yardstick's expert buffers (every expert over 8 x 2048 slots) would
# not fit beside it either.  Tolerances: 13c's for two bf16 computations
# of one step (loss 1e-3 relative, grad norm 5 %); the params bitwise
EP_ARCH, EP_SHAPE, EP_DTYPE = "dbrx_132b", (1, 2), "bfloat16"
EP_LAYERS, EP_BATCH, EP_SEQ, EP_CF, EP_STEPS = 1, 4, 128, 2.0, 2
EP_LOSS_RTOL, EP_GNORM_RTOL = 1e-3, 5e-2


def _family_build(arch: str, **kw):
    """(cfg, model, params) of ``arch`` at full width cut to its
    FAMILY_LAYERS, random weights from seed 0 drawn on the card."""
    from repro_torch.launch import serve
    layers = FAMILY_LAYERS.get(arch)
    if layers is not None:
        kw.setdefault("n_layers", layers)
    cfg, model, params = serve.build(arch, seed=0, **kw)
    torch.cuda.synchronize()
    return cfg, model, params


def _family_static(cfg, model, params, reqs, label: str):
    """``BatchedEngine`` on ``reqs``: a warm run, then a counted run whose
    tokens must be the warm run's bit for bit, its K1 / K3 launches exact
    against its prefill and decode steps (K1 by variant, every K3 launch
    on ``mma``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.serve.engine import BatchedEngine
    lens = [len(r.prompt) for r in reqs]
    engine = BatchedEngine(model, params,
                           max_seq=max(lens) + max(r.max_new_tokens
                                                   for r in reqs) + CHUNK,
                           chunk=CHUNK)
    warm = engine.run(reqs, seed=5)
    torch.cuda.synchronize()
    before = engine.stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.run(reqs, seed=5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, variants = ops.launch_counts(), ops.launch_counts_by_variant()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    if cfg.qk_norm:
        raise AssertionError(f"{cfg.name}: qk_norm rows are not counted here")
    per_pass = norms_a_pass(cfg)
    want = {"flash_attention": attention_sites(cfg) * prefills,
            "rmsnorm": per_pass * (prefills + steps),
            "matmul": 0, "dpia_cuda": 0, **NO_BWD}
    want_k1 = {"packed": 0, "warp": 0, "block": 0}
    for r in [len(reqs) * max(lens)] * prefills + [len(reqs)] * steps:
        want_k1[rms.plan(r, cfg.d_model, cfg.torch_dtype).variant] += \
            per_pass
    if counts != want or variants["rmsnorm"] != want_k1 or \
            variants["flash_attention"] != {"mma": want["flash_attention"],
                                            "tf32x3": 0}:
        raise AssertionError(f"[{label}] static: launches {counts} != "
                             f"{want}, K1 {variants['rmsnorm']} != {want_k1}, "
                             f"K3 {variants['flash_attention']}")
    if outs != warm:
        raise AssertionError(f"[{label}] static: a second run of the same "
                             f"requests and seed gave other tokens")
    for o, r in zip(outs, reqs):
        if len(o) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in o):
            raise AssertionError(f"[{label}] bad output {o}")
    return outs, {"tok_s": sum(map(len, outs)) / dt, "s": dt,
                  "prefills": prefills, "steps": steps, "launches": counts,
                  "k1_variants": variants["rmsnorm"],
                  "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def _family_serving(cfg, model, params, reqs, label: str):
    """Phase 4b's traffic through the static engine and the continuous
    engine (dense and paged, the decode chunk a CUDA graph): each engine's
    second run bitwise its first, dense = paged, exact K1 / K3 counts."""
    static, rep = _family_static(cfg, model, params, reqs, label)
    out = {"static": rep}
    toks = {}
    for layout in ("dense", "paged"):
        engine = continuous_engine(model, params, layout, graph=True)
        first = [list(r.tokens) for r in engine.run_results(reqs, seed=5)]
        toks[layout], rep = _continuous_run(engine, reqs, cfg)
        st = engine.stats()
        if toks[layout] != first or st.get("recaptures_after_warm"):
            raise AssertionError(f"[{label}] {layout}: a second run gave "
                                 f"other tokens, or re-captured "
                                 f"({st.get('recaptures_after_warm')})")
        out[layout] = {k: rep[k] for k in ("tok_s", "s", "ttft_200_s",
                                           "max_memory_gib", "prefills",
                                           "steps", "launches",
                                           "k1_variants")}
        out[layout]["captures"] = st.get("captures")
        del engine
    if toks["dense"] != toks["paged"]:
        raise AssertionError(f"[{label}] dense and paged tokens differ")
    agree = [next((j for j, (a, b) in enumerate(zip(c, s)) if a != b), None)
             for c, s in zip(toks["dense"], static)]
    out["continuous_vs_static_first_diff"] = agree
    return out


def _decode_step_ms(model, params, b: int, pos: int) -> float:
    """Device time of one decode step of ``b`` lanes at ``pos`` (graph
    replays), the cache a scratch one."""
    cfg = model.cfg
    cache = model.init_cache(b, pos + 8)
    shape = (b, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    tok = torch.zeros(shape, dtype=torch.long, device="cuda")
    at = torch.full((b,), pos, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        ms = time_ms(lambda: model.decode_step(params, tok, cache, at),
                     reps=5, trials=3)
    del cache
    return ms


def _moe_against_cpu():
    """[18a] dbrx-132b cut to MOE_CPU_LAYERS layers at full width in fp32
    (:func:`_against_cpu`)."""
    return _against_cpu("dbrx_132b", MOE_CPU_LAYERS, MOE_CPU_PROMPT_LENS,
                        "18a")


def _against_cpu(arch, layers, prompt_lens, label):
    """``arch`` cut to ``layers`` layers at full width in fp32 (TF32 off):
    the same weights (drawn on the card, copied to the host) on the card
    (kernels) and on the CPU (plain versions); a right-padded prefill's
    last-position logits, then one decode step's, within LOGIT_TOL, and
    the same greedy tokens."""
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, model, p_gpu = _family_build(arch, n_layers=layers,
                                      dtype="float32")
    p_cpu = _to(p_gpu, "cpu")
    gen = torch.Generator().manual_seed(6)
    b, s = len(prompt_lens), max(prompt_lens)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    lengths = torch.tensor(prompt_lens)
    ops.reset_launch_counts()
    logits, nxt = {}, {}
    for where, params in (("cpu", p_cpu), ("card", p_gpu)):
        dev = params["embed"].device
        with torch.inference_mode():
            cache = model.init_cache(b, s + 2, device=dev)
            first, _ = model.prefill(params, tokens.to(dev), cache,
                                     lengths=lengths.to(dev))
            nxt[where] = first.argmax(-1).cpu()
            step, _ = model.decode_step(params, first.argmax(-1)[:, None],
                                        cache, lengths.to(dev))
        logits[where] = (first.cpu(), step.cpu())
        del cache
    errs = [(logits["card"][i] - logits["cpu"][i]).abs().max().item()
            for i in range(2)]
    if not max(errs) <= LOGIT_TOL or not torch.equal(nxt["card"],
                                                     nxt["cpu"]):
        raise AssertionError(f"[{label}] fp32 card vs CPU: max abs err "
                             f"{errs} (tol {LOGIT_TOL}), greedy {nxt}")
    fa = ops.launch_counts_by_variant()["flash_attention"]
    if fa != {"mma": 0, "tf32x3": attention_sites(cfg)}:
        raise AssertionError(f"[{label}] fp32 K3 launches {fa}: one tf32x3 "
                             f"an attention site in the card's prefill")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return {"max_abs_err_prefill": errs[0], "max_abs_err_decode": errs[1],
            "logit_max": logits["cpu"][0].abs().max().item(),
            "greedy": nxt["cpu"].tolist(), "k3": fa,
            "s": time.perf_counter() - t0}


def _family_kernel_cases(k1):
    """K1 and K3 at the new families' shapes (bf16): K3 ``mma`` at head dim
    64 at musicgen-large's static prefill (8 x 200, 32 heads) and
    stablelm-1.6b's (18c: 2 x 48, 32 heads); K1 at d_model 6144 (dbrx's
    prefill rows and a decode step's 4) and 2048 (musicgen's, stablelm's
    18c prefill)."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    b, s = len(CONT_PROMPT_LENS), max(CONT_PROMPT_LENS)
    b2, s2 = len(FAMILY_PROMPT_LENS), max(FAMILY_PROMPT_LENS)
    return {
        "rmsnorm": [_rmsnorm_case(r, d, torch.bfloat16, gen, k1)
                    for r, d in ((b * s, 6144), (SLOTS, 6144), (b * s, 2048),
                                 (SLOTS, 2048), (b2 * s2, 2048))],
        "flash_attention": [
            _flash_case(s, s, True, 0, gen, b=b, nh=32, nkv=32, hd=64),
            _flash_case(s2, s2, True, 0, gen, b=b2, nh=32, nkv=32, hd=64)]}


def _one_rank_mesh():
    """A ``(data, model) = (1, 1)`` mesh of this rank alone inside a larger
    world (no process group: every group of a one-rank axis is None)."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    return DeviceMesh("cuda", torch.tensor([[dist.get_rank()]]),
                      mesh_dim_names=("data", "model"), _init_backend=False)


def _ep_prediction(cfg):
    """18d's all-to-alls a step and their bytes: per layer the payload,
    its metadata and the outputs back in the forward, again in remat's
    recompute, the two float ones in the backward (8 calls); payloads
    (M, cap, d) in the model's dtype and metadata (M, cap) int32, cap =
    ceil(cf * tl * k / M) for a rank's tl tokens."""
    m = EP_SHAPE[1]
    tl = EP_BATCH // EP_SHAPE[0] * EP_SEQ // m
    cap = max(math.ceil(EP_CF * tl * cfg.top_k / m), 4)
    payload = m * cap * cfg.d_model * cfg.torch_dtype.itemsize
    return {"all_to_all": 8 * cfg.n_layers,
            "all_to_all_bytes": cfg.n_layers * (6 * payload + 2 * m * cap * 4),
            "cap": cap, "tl": tl}


def ep_rank(rank, world):
    """[18d] dbrx-132b, one layer at full width, bf16, on ``world`` gloo
    ranks sharing the card, mesh ``EP_SHAPE``: rank 0 first runs the step
    on a one-rank ``(1, 1)`` mesh (the EP path with its model group of one:
    the yardstick) and keeps its final state on the host; then every rank
    runs the EP step from the same seed-0 weights, K1 / K3 counted exactly
    a step, its all-to-alls counted, every leaf gathered whole and
    compared with the yardstick's on rank 0."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding import ctx
    from repro_torch.train.step import (make_train_state, make_train_step,
                                        state_specs)
    cfg = config(EP_ARCH, n_layers=EP_LAYERS, dtype=EP_DTYPE,
                 moe_capacity_factor=EP_CF)
    model = Model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=EP_SEQ,
                                  global_batch=EP_BATCH))
    batches = [data.global_batch_at(i) for i in range(EP_STEPS)]
    kw = dict(base_lr=0.0, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    out = {"rank": rank}
    oracle = start = None
    if rank == 0:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        one = _one_rank_mesh()
        state = make_train_state(
            model, torch.Generator(device="cuda").manual_seed(0), mesh=one,
            use_8bit=cfg.opt_8bit)
        state, rows = _sharded_steps(make_train_step(model, one, **kw),
                                     state, batches, cfg, "mma",
                                     phase="18d")
        # on the host: 18 GB of params, the 8-bit moments as they are
        oracle = {p: ((t.q.cpu(), t.scale.item())
                      if isinstance(t, adamw.QTensor)
                      else t.detach().to("cpu"))
                  for p, t in adamw.leaves(state)}
        # lr 0: the params end where they started
        start = {p[1:]: t for p, t in oracle.items() if p[0] == "params"}
        out["one_process"] = {
            "steps": rows, "state_bytes": _state_bytes(state),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "s": time.perf_counter() - t0}
        del state
        ctx.set_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh(EP_SHAPE, ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), mesh=mesh,
        use_8bit=cfg.opt_8bit)
    out["init_s"] = time.perf_counter() - t0
    out["state_bytes"] = _state_bytes(state)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(model, mesh, **kw)
    place = step.placement
    state, out["steps"] = _sharded_steps(
        step, state, batches, cfg, "mma",
        {"data": place.group, "model": place.model, "world": place.world},
        phase="18d")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # both ranks compare at once, beside the script's own process: give
    # the cached blocks back first
    gc.collect()
    torch.cuda.empty_cache()
    specs = state_specs(make_train_state(model, torch.Generator(),
                                         device="meta",
                                         use_8bit=cfg.opt_8bit), mesh, cfg)
    out["worst_rel_to_leaf_max"], out["bad_leaves"], out["sums"] = \
        _held_to_oracle(state, specs, place, oracle, start)
    del state, step, oracle, start
    gc.collect()
    torch.cuda.empty_cache()
    ctx.set_mesh(None)
    return out


def phase_ep(smi, res=None):
    """[18d] expert parallelism: :func:`ep_rank` on two gloo ranks sharing
    the card, checked (every rank's loss and grad norm against the
    one-process step's, its all-to-alls against :func:`_ep_prediction`,
    its state bytes against ``launch.dryrun.reckon``'s, rank 0's leaves
    within 16b's tolerances, every rank's gathered leaves alike) and
    logged (``res``: the ranks' results from a shared spawn, else it spawns
    them); returns each rank's K1 / K3 launches a step and the seconds."""
    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    t0 = time.perf_counter()
    world = EP_SHAPE[0] * EP_SHAPE[1]
    if res is None:
        # the ranks share the card with this process: what it holds
        log(f"[18d] this process holds "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        res = ranks.spawn(ep_rank, world, backend="gloo", device="cuda",
                          timeout=900)
        took, where = time.perf_counter() - t0, "with the processes"
    else:
        took, where = res[0]["cell_s"], "in the shared spawn"
    cfg = config(EP_ARCH, n_layers=EP_LAYERS, dtype=EP_DTYPE,
                 moe_capacity_factor=EP_CF)
    ref = res[0]["one_process"]
    want = _ep_prediction(cfg)
    mesh = {"data": EP_SHAPE[0], "model": EP_SHAPE[1]}
    reckoned = dryrun.reckon(cfg, {"seq": EP_SEQ, "batch": EP_BATCH,
                                   "kind": "train"}, mesh)["memory"]
    for r in res:
        for x, y in zip(r["steps"], ref["steps"]):
            for key, tol in (("loss", EP_LOSS_RTOL),
                             ("grad_norm", EP_GNORM_RTOL)):
                if not math.isclose(x[key], y[key], rel_tol=tol):
                    raise AssertionError(
                        f"[18d] rank {r['rank']} {key} {x[key]} vs the "
                        f"one-process step's {y[key]} (tolerance {tol})")
            a2a = {k: x["collectives"]["model"].get(k, 0)
                   for k in ("all_to_all", "all_to_all_bytes")}
            if a2a != {k: want[k] for k in a2a} or x["applied"] != 1:
                raise AssertionError(f"[18d] rank {r['rank']}: all-to-alls "
                                     f"{a2a} a step, predicted {want}; {x}")
        if r["state_bytes"] != reckoned["state_bytes"]:
            raise AssertionError(f"[18d] rank {r['rank']} holds "
                                 f"{r['state_bytes']} bytes of state, the "
                                 f"dry run reckons "
                                 f"{reckoned['state_bytes']}")
        if r["sums"] != res[0]["sums"]:
            raise AssertionError(f"[18d] rank {r['rank']}'s gathered leaves "
                                 f"differ from rank 0's")
    worst = res[0]["worst_rel_to_leaf_max"]
    if worst["params"] != 0.0:
        raise AssertionError(f"[18d] lr 0, yet the params moved: {worst}")
    log(f"[18d] expert parallelism, {EP_ARCH} at full width cut to "
        f"{EP_LAYERS} layer, {EP_DTYPE}, capacity factor {EP_CF} (no "
        f"drops), 8-bit moments, lr 0, {mesh} on {world} gloo ranks sharing "
        f"one card against the same step on a one-rank (1, 1) mesh, batch "
        f"{EP_BATCH} x {EP_SEQ}, {EP_STEPS} steps: loss within "
        f"{EP_LOSS_RTOL} and grad norm within {EP_GNORM_RTOL} relative, "
        f"the params bitwise; the moments' worst error over the leaf's "
        f"largest (8-bit, both sides' routing in bf16) {worst}, leaves "
        f"past 16b's fp32 tolerance {res[0]['bad_leaves']}; all-to-alls "
        f"a step on every rank {want} (predicted and counted); "
        + json.dumps({
            "one_process": {k: ref[k] for k in ("state_bytes", "peak_gib",
                                                "s")},
            "one_process_steps": [{k: s[k] for k in ("loss", "grad_norm",
                                                     "s")}
                                  for s in ref["steps"]],
            "dryrun_memory": reckoned,
            "ranks": [{"rank": r["rank"], "state_bytes": r["state_bytes"],
                       "peak_gib": r["peak_gib"], "init_s": r["init_s"],
                       "steps": r["steps"]} for r in res]})
        + f"; {took:.1f} s {where}; card {smi}")
    return [r["steps"][0]["launches"] for r in res], took


def phase_families(smi, k1, ep=None):
    """[18] the transformer families, after phase 17, random weights drawn
    on the card from seed 0: (a) dbrx-132b at full width cut to 2 layers,
    bf16, on phase 4b's traffic through the static engine and the
    continuous engine (dense and paged, graphs), each second run bitwise
    its first, exact K1 / K3 counts, a decode step's device time; then 2
    layers in fp32 against the CPU; (b) musicgen-large (4 codebooks, 24
    layers) likewise, K3 at head dim 64; (c) stablelm-1.6b (whole), qwen1.5-32b
    and chameleon-34b (8 layers), grok-1-314b (2 layers): one static
    prefill and its decode each; (d) expert parallelism on two gloo
    ranks (:func:`phase_ep`; ``ep``: its ranks' results from a shared
    spawn).  Returns (the K1 / K3 cases at the new shapes, each part's K1
    / K3 launches)."""
    import gc
    from repro_torch.launch import serve
    t_start = time.perf_counter()
    launches, times, report = {}, {}, {}
    for label, arch in (("18a", "dbrx_132b"), ("18b", "musicgen_large")):
        t0 = time.perf_counter()
        cfg, model, params = _family_build(arch)
        reqs = serve.make_requests(cfg.vocab, CONT_PROMPT_LENS, MAX_NEW,
                                   seed=3, codebooks=cfg.n_codebooks)
        reqs[1].temperature, reqs[1].top_k = 0.8, 50
        rep = _family_serving(cfg, model, params, reqs, label)
        rep["decode_step_ms_4_lanes"] = _decode_step_ms(model, params, SLOTS,
                                                        200)
        launches[label] = {k: {"rmsnorm": v["launches"]["rmsnorm"],
                               "flash_attention": v["launches"][
                                   "flash_attention"]}
                           for k, v in rep.items()
                           if isinstance(v, dict) and "launches" in v}
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        if label == "18a":
            rep["fp32_against_cpu"] = _moe_against_cpu()
        times[label] = time.perf_counter() - t0
        report[label] = rep
        log(f"[{label}] {cfg.name}, {cfg.n_layers} layers at full width "
            f"(d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads "
            f"of {cfg.hd}, family {cfg.family}), bf16, phase 4b's traffic: "
            + json.dumps(rep) + f"; {times[label]:.1f} s; card {smi}")
    c_rep = {}
    for arch in ("stablelm_1_6b", "qwen1_5_32b", "chameleon_34b",
                 "grok_1_314b"):
        t0 = time.perf_counter()
        cfg, model, params = _family_build(arch)
        reqs = serve.make_requests(cfg.vocab, FAMILY_PROMPT_LENS,
                                   FAMILY_MAX_NEW, seed=4)
        outs, rep = _family_static(cfg, model, params, reqs, "18c")
        rep["layers"], rep["s_all"] = cfg.n_layers, time.perf_counter() - t0
        rep["first_tokens"] = [o[:4] for o in outs]
        c_rep[arch] = rep
        launches.setdefault("18c", {})[arch] = {
            k: rep["launches"][k] for k in ("rmsnorm", "flash_attention")}
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    times["18c"] = sum(r["s_all"] for r in c_rep.values())
    log(f"[18c] one static prefill ({list(FAMILY_PROMPT_LENS)}) and "
        f"{FAMILY_MAX_NEW} decode steps each, bf16, exact K1 / K3 counts: "
        + json.dumps(c_rep) + f"; card {smi}")
    cases = _family_kernel_cases(k1)
    for name, cs in cases.items():
        for c in cs:
            log(f"[18k] {name} " + json.dumps(c))
    launches["18d"], times["18d"] = phase_ep(smi, ep)
    log(f"[18] summary: " + json.dumps({k: round(v, 1)
                                        for k, v in times.items()})
        + f", phase 18 {time.perf_counter() - t_start:.1f} s; card {smi}")
    return cases, launches


# ---------------------------------------------------------------------------
# phase 19: the recurrent families
# ---------------------------------------------------------------------------

REC_ARCHS = (("19a", "rwkv6_1_6b"), ("19b", "zamba2_2_7b"))
# 19a / 19b's fp32 check against the CPU: rwkv6-1.6b cut to 2 layers,
# zamba2-2.7b to one group (6 mamba layers and one shared-block site); a
# prefill and a decode step (phase 5's tolerance, LOGIT_TOL)
REC_CPU_LAYERS = {"rwkv6_1_6b": 2, "zamba2_2_7b": 6}
REC_CPU_PROMPT_LENS = (64, 23)
# 19c: a bf16 remat step at full width and depth, (batch, seq).  What
# autograd keeps through a time loop: a recomputed rwkv6 layer holds
# about three (b, 32, 64, 64) fp32 states a time step, 3 x 0.5 MB x b x s;
# a recomputed zamba2 group of 6 mamba layers about one (b, 80, 64, 64)
# fp32 state a layer and time step, 6 x 1.3 MB x b x s: 16 GB at 4 x 512
# beside 4.84 GB of bf16 params, as much again of gradients and 19.4 GB
# of fp32 moments.  A step's time is its time loops' launches, which grow
# with s alone: on an NVIDIA H100 80GB HBM3 at 700 W, at 512 rwkv6 took
# 14.8 s and zamba2 (batch 2) 31.8 s a step, at 4 x 256 8.5 s and 18.9 s:
# both were cut to 4 x 128 to keep the script inside its time, and to 4 x
# 64 when phase 22 came (19c 23.4 s at 4 x 128, NVIDIA H100 80GB HBM3,
# 700 W, in a whole run of the script)
REC_TRAIN_SHAPE = {"rwkv6_1_6b": (4, 64), "zamba2_2_7b": (4, 64)}
# 19a / 19b / 19c: depth cut (full width) when phase 20 took the script
# to 1 253 s (NVIDIA H100 80GB HBM3, 700.00 W; phase 19 251.2 s, 19a
# 39.1, 19b 74.1, 19c 50.7 s at full depth): the eager time loops' time
# grows with the layers; 6 of rwkv6's 24, 2 of zamba2's 9 groups (12
# mamba layers, 2 shared-block sites).  Cut again to 4 and one group (6
# mamba layers, one site) when phase 22 came (19a 11.9 s, 19b 17.5, 19c
# 28.3 at 6 / 12 layers in a whole run of the script)
REC_LAYERS = {"rwkv6_1_6b": 4, "zamba2_2_7b": 6}
REC_TRAIN_STEPS = 2
# 19c's fp32 step on the card against the CPU's (REC_CPU_LAYERS layers,
# TF32 off): loss and gradient norm within 1e-4 relative (the kernels' and
# the plain versions' sums in other orders, over time loops of 32 steps)
REC_TRAIN_CPU_SHAPE = (2, 32)
REC_TRAIN_CPU_RTOL = 1e-4
# 19d: FSDP on two gloo ranks sharing the card, zamba2-2.7b cut to one
# group, fp32, batch 2 x 64 (REC_FSDP_SHAPE), 16c's checks and lr. At 2 x
# 128 (the earlier runs) AdamW's update
# divides by sqrt(v) + 1e-8, so where a gradient sits at its sums'
# rounding the update is that rounding's sign: the embedding's params
# parted from the one-device step's by 13 % of the update under 16c's
# limit alone (NVIDIA H100 80GB HBM3, 700 W). Such elements (the
# one-device step's first moment under REC_FSDP_FLOOR of the leaf's
# largest) are held to twice the update, as tests/test_torch_tp_train.py
# holds them; every other element keeps 16c's limit
# 19d: batch 2 x 64 since phase 20 (the time loops' length; 2 x 128
# before, 85.9 s with the processes in that run)
REC_FSDP_ARCH, REC_FSDP_SHAPE = "zamba2_2_7b", (2, 64)
REC_FSDP_FLOOR = 1e-5
REC_FSDP_KW = {"n_layers": REC_CPU_LAYERS[REC_FSDP_ARCH], "fsdp": True}


def recurrent_state_reckoned(cfg) -> dict:
    """Bytes of a slot's recurrent state and of a token's KV, reckoned from
    the config: rwkv6 L x (nh 64 64 fp32 + 2 d); zamba2 L x (nheads 64 N
    fp32 + (CONV_W - 1)(din + 2N)), KV G x 2 x nkv x hd."""
    elt = cfg.torch_dtype.itemsize
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"state": cfg.n_layers * ((d // 64) * 64 * 64 * 4
                                         + 2 * d * elt), "kv_a_token": 0}
    din, n = 2 * d, cfg.ssm_state
    g = cfg.n_layers // cfg.attn_every
    return {"state": cfg.n_layers * ((din // 64) * 64 * n * 4
                                     + 3 * (din + 2 * n) * elt),
            "kv_a_token": g * 2 * cfg.n_kv_heads * cfg.hd * elt}


def _recurrent_state_bytes(engine) -> dict:
    """A dense engine's recurrent bytes a slot and KV bytes a token."""
    kv, state = engine.model.split_paged_cache(engine.st.cache)

    def nbytes(node):
        return sum(t.numel() * t.element_size() for t in
                   (node if isinstance(node, tuple) else ()))
    lanes = engine.slots
    kv_bytes = 0 if kv is None else nbytes(kv)
    return {"state": nbytes(state) // lanes,
            "kv_a_token": kv_bytes // (lanes * engine.max_seq)}


def _k3_ptxas() -> dict:
    """Registers and spills of every K3 instance (forward, D and the
    backward's kernels) by (kernel, head dim)."""
    from repro_torch.kernels import _build
    rep = _build.ptxas_report(
        _build.target("flash_attention").with_suffix(".log").read_text(),
        r"flash_(fwd_mma|fwd_tf32|bwd_delta_mma|bwd_delta_f32|bwd_dkv_mma|"
        r"bwd_dq_mma|bwd_dkv_tf32|bwd_dq_tf32)ILi(\d+)E")
    return {f"{k} D{d}": r for (k, d), r in sorted(rep.items())}


def _recurrent_kernel_cases():
    """[19k] K3 at head dim 80 (zamba2's shared attention, 32 heads of 80)
    against its plain version: ``mma`` at the static prefill (4 x 32, 200)
    and at phase 4b's batch-1 first chunks, ``tf32x3`` at the static
    prefill (held to float64), both backwards at 19c's shape (4 x 32,
    128); with ptxas's registers and spills of the D 80 instances."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    _, first = continuous_buckets()
    hd, s = 80, max(PROMPT_LENS)
    fa = [_flash_case(s, s, True, 0, gen, b=len(PROMPT_LENS), nh=32,
                      nkv=32, hd=hd)]
    fa += [_flash_case(n, n, True, 0, gen, b=1, nh=32, nkv=32, hd=hd)
           for n in first]
    fa.append(_flash_case(s, s, True, 0, gen, b=len(PROMPT_LENS), nh=32,
                          nkv=32, hd=hd, dtype=torch.float32,
                          f64_check=True))
    ptx = _k3_ptxas()
    for c in fa:
        c["ptxas"] = {k: r for k, r in ptx.items()
                      if k.endswith(f" D{hd}") and k.startswith(
                          "fwd_mma" if c["variant"] == "mma" else "fwd_tf32")}
    b, seq = REC_TRAIN_SHAPE["zamba2_2_7b"]
    bwd = [_flash_bwd_case(b, 32, 32, seq, hd, dt, gen, bwd_ptxas())
           for dt in (torch.bfloat16, torch.float32)]
    for c in bwd:
        c["ptxas"]["delta"] = ptx.get(
            f"bwd_delta_{'mma' if c['variant'] == 'mma' else 'f32'} D{hd}")
    d80 = {k: r for k, r in ptx.items() if k.endswith(" D80")}
    spills = {k: r for k, r in d80.items()
              if r.get("spill_stores") or r.get("spill_loads")}
    return {"flash_attention": fa, "flash_attention_bwd": bwd}, d80, spills


def _recurrent_serving(cfg, model, params, label):
    """Phase 4's traffic through the static engine; phase 4b's through the
    continuous engine, dense and paged, each with its decode chunk a CUDA
    graph (a warm run, then a counted one: bitwise the first, no
    re-capture) and eagerly: every continuous run's tokens equal, exact
    K1 / K3 counts (K3 at the config's head dim on every first prefill
    chunk), and the dense cache's recurrent bytes a slot and KV bytes a
    token against the reckoning."""
    from repro_torch.launch import serve
    reqs4 = serve.make_requests(cfg.vocab, PROMPT_LENS, MAX_NEW, seed=1)
    reqs4[1].temperature, reqs4[1].top_k = 0.8, 50
    _, rep = _family_static(cfg, model, params, reqs4, label)
    out = {"static": rep}
    reqs = continuous_requests(cfg.vocab)
    toks = {}
    for layout in ("dense", "paged"):
        for graph in (True, False):
            key = f"{layout} {'graph' if graph else 'eager'}"
            engine = continuous_engine(model, params, layout, graph=graph)
            first = None
            if graph:
                first = [list(r.tokens)
                         for r in engine.run_results(reqs, seed=5)]
            toks[key], rep = _continuous_run(engine, reqs, cfg)
            st = engine.stats()
            if graph and (toks[key] != first
                          or st.get("recaptures_after_warm")):
                raise AssertionError(
                    f"[{label}] {key}: a second run gave other tokens, or "
                    f"re-captured ({st.get('recaptures_after_warm')})")
            out[key] = {k: rep[k] for k in (
                "tok_s", "s", "ttft_200_s", "max_memory_gib", "prefills",
                "steps", "launches", "k1_variants")}
            out[key]["captures"] = st.get("captures")
            if key == "dense graph":
                got = _recurrent_state_bytes(engine)
                want = recurrent_state_reckoned(cfg)
                if got != want:
                    raise AssertionError(f"[{label}] cache bytes {got}, "
                                         f"reckoned {want}")
                out["bytes_a_slot"] = got
            del engine
    if any(t != toks["dense graph"] for t in toks.values()):
        raise AssertionError(f"[{label}] continuous tokens differ across "
                             f"layouts / graph and eager: {toks}")
    return out


def _recurrent_train(arch):
    """[19c] bf16 remat train steps of ``arch`` at full width cut to
    REC_LAYERS layers (REC_TRAIN_STEPS, the first building what the step
    needs), REC_TRAIN_SHAPE: each step's time, tokens a second, peak
    memory and exact K1 / K3 forward and backward launches (K3 all
    ``mma``)."""
    import gc
    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import make_train_state, make_train_step
    cfg = config(arch, n_layers=REC_LAYERS[arch])
    model = Model(cfg)
    batch, seq = REC_TRAIN_SHAPE[arch]
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    batches = [data.global_batch_at(i) for i in range(REC_TRAIN_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    state, rows = _sharded_steps(step, state, batches, cfg, "mma",
                                 phase="19c")
    for r in rows:
        if r["applied"] != 1 or not math.isfinite(r["loss"]):
            raise AssertionError(f"[19c] {arch}: step {r}")
        r["tok_s"] = batch * seq / r["s"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": batch, "seq": seq,
            "steps": [{k: r[k] for k in ("loss", "grad_norm", "s", "tok_s",
                                         "launches")} for r in rows],
            "peak_gib": peak}


def _detached_to(node, device):
    """A train state's tensors on ``device``, params leaves again."""
    if isinstance(node, torch.Tensor):
        return node.detach().to(device).requires_grad_(node.requires_grad)
    if isinstance(node, dict):
        return {k: _detached_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_detached_to(v, device) for v in node]
    return node


def _recurrent_train_against_cpu(arch):
    """[19c] ``arch`` cut to REC_CPU_LAYERS layers at full width, fp32 (TF32
    off): one train step from the same seed-0 state on the card (kernels)
    and on the CPU (plain versions), loss and gradient norm within
    REC_TRAIN_CPU_RTOL."""
    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import make_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(arch, n_layers=REC_CPU_LAYERS[arch], dtype="float32")
    model = Model(cfg)
    batch, seq = REC_TRAIN_CPU_SHAPE
    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch)).global_batch_at(0)
    cpu = make_train_state(model, torch.Generator().manual_seed(0),
                           device="cpu")
    card = _detached_to(cpu, "cuda")
    kw = dict(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    _, m_cpu = make_train_step(model, **kw)(cpu, b)
    _, rows = _sharded_steps(make_train_step(model, **kw), card, [b], cfg,
                             "tf32x3", phase="19c")
    m_card = rows[0]
    for key in ("loss", "grad_norm"):
        if not math.isclose(m_card[key], m_cpu[key],
                            rel_tol=REC_TRAIN_CPU_RTOL):
            raise AssertionError(f"[19c] {arch} fp32 card {key} "
                                 f"{m_card[key]} vs the CPU's {m_cpu[key]}")
    del cpu, card
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "card": {k: m_card[k] for k in (
        "loss", "grad_norm", "launches")},
            "cpu": {k: m_cpu[k] for k in ("loss", "grad_norm")}}


def phase_recurrent_fsdp(smi, two=None):
    """[19d] FSDP over the data axis, :func:`sharded_train_two` on two gloo
    ranks sharing the card: zamba2-2.7b cut to one group, fp32, held to
    the one-device step (16c's tolerances; params at the gradient's
    rounding floor within twice the update, REC_FSDP_SHAPE's note), each
    rank's state bytes equal to ``launch.dryrun.reckon``'s (``two``: the
    ranks' results from a shared spawn, else it spawns them)."""
    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    t0 = time.perf_counter()
    kw = REC_FSDP_KW
    if two is None:
        two = ranks.spawn(sharded_train_two, SHARDED_TRAIN_RANKS,
                          backend="gloo", device="cuda", timeout=600,
                          args=(REC_FSDP_ARCH, kw, REC_FSDP_SHAPE, "19d",
                                REC_FSDP_FLOOR))
        took, where = time.perf_counter() - t0, "with the processes"
    else:
        took, where = two[0]["cell_s"], "in the shared spawn"
    ref = two[0]["one_device"]
    cfg = config(REC_FSDP_ARCH, dtype="float32", **kw)
    batch, seq = REC_FSDP_SHAPE
    reckoned = dryrun.reckon(cfg, {"seq": seq, "batch": batch,
                                   "kind": "train"},
                             {"data": SHARDED_TRAIN_RANKS, "model": 1})[
        "memory"]
    for r in two:
        for x, y in zip(r["steps"], ref["steps"]):
            for key in ("loss", "grad_norm"):
                if not math.isclose(x[key], y[key],
                                    rel_tol=SHARDED_METRIC_RTOL):
                    raise AssertionError(
                        f"[19d] rank {r['rank']} {key} {x[key]} vs the "
                        f"one-device step's {y[key]}")
            if x["applied"] != 1 or x["lr"] != y["lr"]:
                raise AssertionError(f"[19d] rank {r['rank']}: {x}")
        if r["state_bytes"] != reckoned["state_bytes"]:
            raise AssertionError(f"[19d] rank {r['rank']} holds "
                                 f"{r['state_bytes']} bytes of state, the "
                                 f"dry run reckons {reckoned['state_bytes']}")
    worst = two[0]["worst_rel_to_leaf_max"]
    if two[0]["bad_leaves"]:
        raise AssertionError(f"[19d] leaves beyond the tolerance: "
                             f"{two[0]['bad_leaves']} (worst {worst})")
    log(f"[19d] FSDP, {REC_FSDP_ARCH} at full width cut to one group "
        f"({cfg.n_layers} mamba layers, one shared-block site), fp32 (TF32 "
        f"off), data={SHARDED_TRAIN_RANKS} (gloo ranks sharing one card), "
        f"batch {batch} x {seq}, lr {TRAIN_LR}, {SHARDED_TRAIN_STEPS} steps "
        f"against the one-device step (16c's tolerances; params whose first "
        f"moment is under {REC_FSDP_FLOOR} of the leaf's largest within "
        f"twice the update): worst error over the leaf's largest magnitude "
        f"and params' over the update, and the elements past 16c's limit "
        f"(all / under the floor) {worst}; each rank's "
        f"state bytes equal to the dry run's; "
        + json.dumps({
            "one_device": {k: ref[k] for k in ("state_bytes", "peak_gib",
                                               "s")},
            "one_device_steps": [{k: s[k] for k in ("loss", "grad_norm",
                                                    "s")}
                                 for s in ref["steps"]],
            "dryrun_memory": reckoned,
            "ranks": [{"rank": r["rank"], "state_bytes": r["state_bytes"],
                       "peak_gib": r["peak_gib"], "init_s": r["init_s"],
                       "steps": r["steps"]} for r in two]})
        + f"; {took:.1f} s {where}; card {smi}")
    return [r["steps"][0]["launches"] for r in two], took


def phase_recurrent(smi, fsdp=None):
    """[19] the recurrent families, random weights drawn on the card from
    seed 0: (k) K3 at head dim 80 in all four variants; (a) rwkv6-1.6b and
    (b) zamba2-2.7b at full width cut to REC_LAYERS, bf16, through every
    engine (:func:`_recurrent_serving`), a decode step's device time, then
    a cut in fp32 against the CPU; (c) a train step of each at that cut,
    and an
    fp32 step against the CPU's; (d) FSDP on two gloo ranks
    (:func:`phase_recurrent_fsdp`; ``fsdp``: its ranks' results from a
    shared spawn).  Returns (the K3 cases at D 80, each part's K1 / K3
    launches)."""
    import gc
    t_start = time.perf_counter()
    times, launches = {}, {}
    t0 = time.perf_counter()
    cases, d80, spills = _recurrent_kernel_cases()
    for name, cs in cases.items():
        for c in cs:
            log(f"[19k] {name} " + json.dumps(c))
    log(f"[19k] ptxas of the D 80 instances [registers, spills]: "
        + json.dumps({k: [r.get("registers"), r.get("spill_stores", 0),
                          r.get("spill_loads", 0)] for k, r in d80.items()})
        + f"; instances that spill: {sorted(spills)}; card {smi}")
    times["19k"] = time.perf_counter() - t0
    for label, arch in REC_ARCHS:
        t0 = time.perf_counter()
        cfg, model, params = _family_build(arch,
                                           n_layers=REC_LAYERS[arch])
        n_params = sum(t.numel() for t in _tensors(params))
        rep = _recurrent_serving(cfg, model, params, label)
        rep["params"] = n_params
        rep["decode_step_ms_4_lanes"] = _decode_step_ms(model, params, SLOTS,
                                                        200)
        launches[label] = {k: {"rmsnorm": v["launches"]["rmsnorm"],
                               "flash_attention": v["launches"][
                                   "flash_attention"]}
                           for k, v in rep.items()
                           if isinstance(v, dict) and "launches" in v}
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        rep["fp32_against_cpu"] = _against_cpu(
            arch, REC_CPU_LAYERS[arch], REC_CPU_PROMPT_LENS, label)
        times[label] = time.perf_counter() - t0
        log(f"[{label}] {cfg.name}, {cfg.n_layers} layers at full width "
            f"(d_model {cfg.d_model}, family {cfg.family}"
            + (f", {attention_sites(cfg)} shared-attention sites of "
               f"{cfg.n_heads} heads of {cfg.hd}"
               if cfg.family == "hybrid" else "")
            + f"), {n_params / 1e9:.3f} B params, bf16, phase 4's traffic "
            f"(static) and phase 4b's (continuous, dense / paged, graph / "
            f"eager): " + json.dumps(rep) + f"; {times[label]:.1f} s; "
            f"card {smi}")
    t0 = time.perf_counter()
    c_rep = {}
    for _, arch in REC_ARCHS:
        t1 = time.perf_counter()
        c_rep[arch] = _recurrent_train(arch)
        t2 = time.perf_counter()
        c_rep[arch]["fp32_against_cpu"] = _recurrent_train_against_cpu(arch)
        c_rep[arch]["s_bf16"] = t2 - t1
        c_rep[arch]["s_fp32_against_cpu"] = time.perf_counter() - t2
        launches.setdefault("19c", {})[arch] = \
            c_rep[arch]["steps"][0]["launches"]
    times["19c"] = time.perf_counter() - t0
    log(f"[19c] one bf16 remat train step at full width, layers "
        f"{REC_LAYERS}, "
        f"{REC_TRAIN_STEPS} steps (the first builds), batch x seq "
        f"{REC_TRAIN_SHAPE}, exact K1 / K3 forward and backward launches; "
        f"an fp32 step of a cut against the CPU's: " + json.dumps(c_rep)
        + f"; card {smi}")
    launches["19d"], times["19d"] = phase_recurrent_fsdp(smi, fsdp)
    log(f"[19] summary: " + json.dumps({k: round(v, 1)
                                        for k, v in times.items()})
        + f", phase 19 {time.perf_counter() - t_start:.1f} s; card {smi}")
    return cases, launches


# ---------------------------------------------------------------------------
# phase 20: the model axis for the recurrent families; the op counter
# ---------------------------------------------------------------------------

# 20a / 20b: TP + SP on model=2, two gloo ranks sharing the card (as 17a),
# fp32, held to the one-device step with 17a's checks: rwkv6-1.6b at full
# width cut to 2 layers, zamba2-2.7b to one group (6 mamba layers and one
# shared-block site); batch 2 x 32 (the eager time loops: a step's
# launches grow with the sequence; 2 x 64 until phase 22 came, 20a 22.9 s
# and 20b 26.0 s in the shared spawn, in a whole run of the script)
REC_TP_CELLS = {"20a": ("rwkv6_1_6b", 2), "20b": ("zamba2_2_7b", 6)}
REC_TP_SHAPE = (2, 32)
# the counts 20c compares: every number of a count but its seconds
COUNT_KEYS = ("flops", "bytes", "bytes_min", "coll_bytes", "coll_by_kind",
              "kernels", "coll_calls", "ops")


def recurrent_tp_ranks(rank, world):
    """[20a] and [20b] in one spawn of two gloo ranks sharing the card
    (one start-up of the processes for both): :func:`tp_train_rank` for
    each of REC_TP_CELLS, 20a's step counted too; each cell's seconds."""
    out = {}
    for label, (arch, layers) in REC_TP_CELLS.items():
        t0 = time.perf_counter()
        out[label] = tp_train_rank(rank, world, arch, (1, 2), layers,
                                   REC_TP_SHAPE, label == "20a")
        out[label]["cell_s"] = time.perf_counter() - t0
    return out


def counted(step, state, batch) -> dict:
    """One more step of ``step`` on ``state`` counted by
    ``analysis.hlo_counter``, its layers and time steps scaled by their
    trip counts (``scaled``) and every one counted (``full``): each
    count's totals, kernel and collective calls, ops and seconds.  The
    counted steps update ``state`` (the scaled one with the first layer's
    gradients alone): a caller counts last."""
    from repro_torch.analysis import hlo_counter
    out = {}
    for scale in (True, False):
        if state["step"].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, c = hlo_counter.count(step, state, batch, scale=scale)
        if state["step"].is_cuda:
            torch.cuda.synchronize()
        t = c.totals
        out["scaled" if scale else "full"] = {
            "flops": t.flops, "bytes": t.bytes, "bytes_min": t.bytes_min,
            "coll_bytes": t.coll_bytes, "coll_by_kind": dict(t.coll_by_kind),
            "kernels": dict(c.kernels), "coll_calls": dict(c.coll_calls),
            "ops": c.ops, "s": time.perf_counter() - t0}
    return out


def meta_counted(cfg, batch, sizes=None, coordinate=None) -> dict:
    """:func:`counted` of the same step on the ``meta`` device: one
    device, or the rank at ``coordinate`` of a mesh of ``sizes`` stood in
    for by ``collectives.CountingMesh`` (its groups count and exchange
    nothing)."""
    from repro_torch.models.transformer import Model
    from repro_torch.sharding import ctx
    from repro_torch.sharding.collectives import CountingMesh
    from repro_torch.train.step import make_train_state, make_train_step
    model = Model(cfg)
    mesh = None if sizes is None else CountingMesh(sizes, coordinate)
    state = make_train_state(model, torch.Generator(), device="meta",
                             mesh=mesh)
    step = make_train_step(model, mesh, base_lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    try:
        return counted(step, state, batch)
    finally:
        ctx.set_mesh(None)


def _same_counts(label, card, meta) -> None:
    for scale in ("scaled", "full"):
        a = {k: card[scale][k] for k in COUNT_KEYS}
        b = {k: meta[scale][k] for k in COUNT_KEYS}
        if a != b:
            raise AssertionError(f"[20c] {label} {scale}: the card's count "
                                 f"{a} differs from the meta device's {b}")
    for k in ("flops", "bytes", "bytes_min", "coll_bytes"):
        if card["scaled"][k] != card["full"][k]:
            raise AssertionError(f"[20c] {label}: the scaled count's {k} "
                                 f"{card['scaled'][k]} is not the full "
                                 f"count's {card['full'][k]}")


def _roofline(c, chips, model_flops, measured_s, widest_axis=1) -> dict:
    """The roofline terms of one rank's count ``c`` beside a measured step
    time."""
    from repro_torch.analysis import hlo, hlo_counter
    tot = hlo_counter.Totals(c["flops"], c["bytes"], c["bytes_min"],
                             c["coll_bytes"], sum(c["coll_calls"].values()),
                             dict(c["coll_by_kind"]))
    r = hlo.from_totals(tot, c["coll_calls"], chips=chips,
                        model_flops=model_flops, widest_axis=widest_axis)
    return {**r.row(), "roofline_step_s": r.step_time_s,
            "measured_step_s": measured_s,
            "counted_over_measured": r.step_time_s / measured_s}


def _recurrent_tp_kernel_cases(k1):
    """[20k] K1 and its backward on a TP rank's sequence rows of 20a / 20b
    (REC_TP_SHAPE over model=2: b s / 2 rows of 2048 / 2560, fp32); K3
    ``tf32x3`` at D 80 forward (held to float64 too) and backward on
    20b's rank's 16 heads of the whole sequence (2 x 16, s, 80)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    ptxas = bwd_ptxas()
    b, s = REC_TP_SHAPE
    rows = b * s // 2
    shapes = ((rows, 2048), (rows, 2560))
    return {
        "rmsnorm": [_rmsnorm_case(r, d, torch.float32, gen, k1)
                    for r, d in shapes],
        "rmsnorm_bwd": [_rmsnorm_bwd_case(r, d, torch.float32, gen, ptxas)
                        for r, d in shapes],
        "flash_attention": [_flash_case(s, s, True, 0, gen, b=b, nh=16,
                                        nkv=16, hd=80, dtype=torch.float32,
                                        f64_check=True)],
        "flash_attention_bwd": [_flash_bwd_case(b, 16, 16, s, 80,
                                                torch.float32, gen, ptxas)]}


def phase_counter(smi, rwkv):
    """[20c] the op counter on the card: 13b's one-device step (qwen3-4b
    at full width and depth, bf16, 13b's batch, lr and warm-up) and 20a's
    rwkv6 step on each of its ranks (``rwkv``: the ranks' counts and
    steps), each counted scaled and in full on the card, then on the
    ``meta`` device (20a's ranks through counting groups): the totals,
    kernel calls and collectives must be equal, and the scaled count the
    full one; the roofline terms (``analysis.hlo``, an H100's rates)
    beside the measured step time."""
    import gc

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import make_train_state, make_train_step
    t_start = time.perf_counter()
    cfg = config(ARCH)
    model = Model(cfg)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH)
                        ).global_batch_at(0)
    gc.collect()
    torch.cuda.empty_cache()
    state = make_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    times = []
    for _ in range(3):            # the first builds what the step needs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    card = counted(step, state, batch)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    meta = meta_counted(cfg, batch)
    _same_counts("qwen3-4b", card, meta)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    qwen = {"counts": card, "roofline": _roofline(
        card["scaled"], 1, 6.0 * cfg.active_param_count() * tokens,
        statistics.median(times[1:])), "step_s": times}
    rcfg = config(REC_TP_CELLS["20a"][0], n_layers=REC_TP_CELLS["20a"][1],
                  dtype="float32")
    rbatch = SyntheticLM(DataConfig(vocab=rcfg.vocab,
                                    seq_len=REC_TP_SHAPE[1],
                                    global_batch=REC_TP_SHAPE[0])
                         ).global_batch_at(0)
    ranks_rep = []
    for r, (c, steps) in enumerate(zip(rwkv["counts"], rwkv["steps"])):
        m = meta_counted(rcfg, rbatch, {"data": 1, "model": 2}, {"model": r})
        _same_counts(f"rwkv6 20a rank {r}", c, m)
        # the last step: the first builds what the step needs
        ranks_rep.append({"rank": r, "counts": c, "roofline": _roofline(
            c["scaled"], 2, 6.0 * rcfg.active_param_count()
            * REC_TP_SHAPE[0] * REC_TP_SHAPE[1], steps[-1]["s"],
            widest_axis=2)})
    took = time.perf_counter() - t_start
    log("[20c] the op counter (analysis.hlo_counter) on the card against "
        "the meta device, scaled and in full (equal totals, kernel calls "
        "and collectives), and the roofline (analysis.hlo: "
        f"{cfg.name} bf16 one device, 13b's batch; rwkv6 20a's ranks, "
        "two gloo ranks sharing one card, so the measured time is both "
        "ranks' on one card) beside the measured step: "
        + json.dumps({"qwen3_4b": qwen, "rwkv6_20a": ranks_rep})
        + f"; {took:.1f} s; card {smi}")
    return took


def phase_recurrent_tp(smi, k1, res=None):
    """[20] the model axis for the recurrent families and the op counter:
    (k) K1 / K3 at 20a / 20b's rank shapes; (a) rwkv6-1.6b and (b)
    zamba2-2.7b, TP + SP on ``model=2`` (:func:`recurrent_tp_ranks`: two
    gloo ranks sharing the card, both cells in one spawn; each held to the
    one-device step and its state bytes to the dry run's by
    :func:`tp_cell`; ``res``: the ranks' results from a shared spawn);
    (c) the op counter on the card (:func:`phase_counter`).  Returns (the
    kernel cases, each cell's ranks' K1 / K3 launches a step)."""
    import gc
    t_start = time.perf_counter()
    times, launches = {}, {}
    t0 = time.perf_counter()
    cases = _recurrent_tp_kernel_cases(k1)
    for name, cs in cases.items():
        for c in cs:
            log(f"[20k] {name} " + json.dumps(c))
    times["20k"] = time.perf_counter() - t0
    from repro_torch.testing import ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if res is None:
        res = ranks.spawn(recurrent_tp_ranks, 2, backend="gloo",
                          device="cuda", timeout=900)
    times["20a + 20b"] = time.perf_counter() - t0
    rwkv = {}
    for label, (arch, layers) in REC_TP_CELLS.items():
        launches[label], times[label] = tp_cell(
            smi, label, arch, (1, 2), layers=layers, bs=REC_TP_SHAPE,
            report=rwkv if label == "20a" else None,
            results=[r[label] for r in res])
    times["20c"] = phase_counter(smi, rwkv)
    log(f"[20] summary: " + json.dumps({k: round(v, 1)
                                        for k, v in times.items()})
        + f", phase 20 {time.perf_counter() - t_start:.1f} s; card {smi}")
    return cases, launches


# ---------------------------------------------------------------------------
# phase 21: serving with the params split over model
# ---------------------------------------------------------------------------

# 21a / 21b (phase 21) and 22a / 22b (phase 22: the recurrent families):
# arch, layers, new tokens; fp32, (data, model) = SERVE_TP_SHAPE on gloo
# ranks sharing the card, phase 4's prompts (right-padded, each row's
# logits at its own last position), greedy.  A decode step gathers the
# head whole through the host (gloo): qwen3-4b's 1.56 GB in 1.4-1.9 s,
# dbrx's 2.47 GB in 2.1-2.7 s (NVIDIA H100 80GB HBM3, 700 W), so the
# phase 22 cells take 8 new tokens, not phase 4's 32, and 21a / 21b 4
# (16 and 8 until phase 22 came).  22b is zamba2's one group: 6 mamba
# layers and the shared block
SERVE_TP_CELLS = {"21a": ("qwen3_4b", 2, 4), "21b": ("dbrx_132b", 1, 4),
                  "22a": ("rwkv6_1_6b", 2, 8), "22b": ("zamba2_2_7b", 6, 8)}
SERVE_TP_SHAPE = (1, 2)
SERVE_TP_MAX_SEQ = 256
# the first step's logits against the one-device port's, of the largest
# magnitude: fp32, the rank's collectives summing in other orders
SERVE_TP_LOGIT_TOL = 1e-4


def serve_tp_launches(cfg, steps: int) -> dict:
    """K1 / K3 launches of a prefill and ``steps`` decode steps: every
    block's norms (the qk norms too) and the final norm a step; K3 once a
    layer in the prefill, never in a decode step (plain attention)."""
    norms = norms_a_pass(cfg) + (2 * cfg.n_layers if cfg.qk_norm else 0)
    return {"rmsnorm": norms * (1 + steps),
            "flash_attention": attention_sites(cfg)}


def _serve_tp_prompts(cfg):
    """Phase 4's prompt lengths, right-padded to the longest, tokens drawn
    from seed 21; the lengths as a (b,) tensor."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    lens = torch.tensor(PROMPT_LENS, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (len(PROMPT_LENS),
                                          max(PROMPT_LENS)),
                           generator=gen, device="cuda")
    return tokens, lens


def _cache_leaves(cache, prefix: str = "") -> dict:
    """``{path: tensor}`` of a serving cache (NamedTuples and dicts)."""
    fields = getattr(cache, "_fields", None)
    if fields is not None:
        return {prefix + f: getattr(cache, f) for f in fields}
    out = {}
    for k, v in cache.items():
        out.update(_cache_leaves(v, f"{prefix}{k}/"))
    return out


def _serve_tp_greedy(prefill, decode, tokens, lens, cache, new_tokens,
                     after_prefill=None):
    """Greedy serving of ``tokens``: the prefill, then ``new_tokens - 1``
    decode steps, each row at its own position; (new tokens (b,
    new_tokens) as lists, the first step's logits as numpy, the prefill's
    and the decode steps' seconds).  ``after_prefill(cache)`` runs between
    the two, untimed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(tokens, cache, lens)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    if after_prefill is not None:
        after_prefill(cache)
    first = logits.detach().cpu().numpy()
    new = [logits.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, cache = decode(new[-1][:, None], cache, lens + i)
        new.append(logits.argmax(-1))
    torch.cuda.synchronize()
    return (torch.stack(new, 1).tolist(), first, pre_s,
            (time.perf_counter() - t0) / (new_tokens - 1))


def serve_tp_cell(rank, world, arch, layers, new_tokens, count=False):
    """[21a] / [21b] / [22a] / [22b] on ``world`` gloo ranks sharing the
    card: rank 0 first serves the prompts on one device (the others wait);
    then the ranks draw the same seed-0 weights one after the other (a
    rank's whole params, cut to its pieces by ``params_specs`` and freed
    before the next draws) and serve them through ``sharding.serving.
    ServingStep`` on SERVE_TP_SHAPE, K1 / K3 counted from the prefill to
    the last decode step, the model group's collectives a step (the
    recurrent families': the model and data groups').  A recurrent
    family's cell also returns the cache after the prefill (the one
    device's whole, each rank's piece) as numpy.  With ``count``, one
    more decode step is counted by ``analysis.hlo_counter`` (scaled and in
    full, :func:`counted`'s keys)."""
    import gc

    import torch.distributed as dist

    from repro_torch.analysis import hlo_counter
    from repro_torch.configs import config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.sharding.serving import ServingStep
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(arch, n_layers=layers, dtype="float32")
    model = Model(cfg)
    tokens, lens = _serve_tp_prompts(cfg)
    b = tokens.shape[0]
    out = {"rank": rank}
    recurrent = cfg.family in ("ssm", "hybrid")

    def keep(key):
        if not recurrent:
            return None
        return lambda cache: out.__setitem__(key, {
            k: t.detach().to("cpu", copy=True).numpy()
            for k, t in _cache_leaves(cache).items()})
    if rank == 0:
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        ops.reset_launch_counts()
        with torch.no_grad():
            new, first, pre_s, dec_s = _serve_tp_greedy(
                lambda t, c, n: model.prefill(params, t, c, lengths=n),
                lambda t, c, p: model.decode_step(params, t, c, p),
                tokens, lens, model.init_cache(b, SERVE_TP_MAX_SEQ),
                new_tokens, keep("one_device_prefill_cache"))
        out["one_device"] = {
            "tokens": new, "first": first, "prefill_s": pre_s,
            "decode_step_s": dec_s,
            "launches": {k: ops.launch_counts()[k]
                         for k in ("rmsnorm", "flash_attention")}}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh(SERVE_TP_SHAPE, ("data", "model"))
    serve = ServingStep(model, mesh, b, SERVE_TP_MAX_SEQ)
    t0 = time.perf_counter()
    params = None
    for r in range(world):
        if r == rank:
            whole = model.init_params(
                torch.Generator(device="cuda").manual_seed(0))
            params = serve.shard_params(whole)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    out["draw_s"] = time.perf_counter() - t0
    out["params_bytes"] = sum(t.numel() * t.element_size()
                              for t in _tensors(params))
    cache = serve.shard_cache(model.init_cache(b, SERVE_TP_MAX_SEQ))
    out["cache_bytes"] = sum(t.nbytes for t in _cache_leaves(cache).values())
    out["kv"], out["state"] = serve.kv, serve.state
    groups = {"model": serve.place.model, "data": serve.place.group}
    steps = []

    def step_counts(fn):
        def run(*a):
            for g in groups.values():
                g.counts.clear()
            res = fn(*a)
            steps.append({k: dict(g.counts) for k, g in groups.items()}
                         if recurrent else dict(groups["model"].counts))
            return res
        return run
    mine = serve.rows(tokens), serve.rows(lens)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    new, first, pre_s, dec_s = _serve_tp_greedy(
        step_counts(lambda t, c, n: serve.prefill(params, t, c, lengths=n)),
        step_counts(lambda t, c, p: serve.decode_step(params, t, c, p)),
        *mine, cache, new_tokens, keep("prefill_cache"))
    out.update({"tokens": new, "first": first, "prefill_s": pre_s,
                "decode_step_s": dec_s, "collectives": steps,
                "launches": {k: ops.launch_counts()[k]
                             for k in ("rmsnorm", "flash_attention")},
                "launches_by_variant": {
                    k: ops.launch_counts_by_variant()[k]
                    for k in ("rmsnorm", "flash_attention")}})
    if count:
        pos = mine[1] + new_tokens - 1
        token = torch.tensor(new, device="cuda")[:, -1:]
        c = {}
        for scale in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cn = hlo_counter.count(serve.decode_step, params, token,
                                      cache, pos, scale=scale)
            torch.cuda.synchronize()
            t = cn.totals
            c["scaled" if scale else "full"] = {
                "flops": t.flops, "bytes": t.bytes,
                "bytes_min": t.bytes_min, "coll_bytes": t.coll_bytes,
                "coll_by_kind": dict(t.coll_by_kind),
                "kernels": dict(cn.kernels),
                "coll_calls": dict(cn.coll_calls), "ops": cn.ops,
                "s": time.perf_counter() - t0}
        out["count"] = c
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def two_rank_cells(rank, world):
    """The two-rank gloo cells of phases 16-22 in one spawn of two ranks
    sharing the card (a start-up of the processes, and a process's slow
    first fp32 step, once for all): 16b / 16c (:func:`data_axis_ranks`),
    17a (:func:`tp_train_rank`), 18d (:func:`ep_rank`), 19d
    (:func:`sharded_train_two`), 20a / 20b (:func:`recurrent_tp_ranks`),
    21a / 21b and 22a / 22b (:func:`serve_tp_ranks`); each is checked
    and logged by its phase."""
    out = data_axis_ranks(rank, world)
    t0 = time.perf_counter()
    out["17a"] = tp_train_rank(rank, world, *TP_TRAIN_CELLS["17a"])
    out["17a"]["cell_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["18d"] = ep_rank(rank, world)
    out["18d"]["cell_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["19d"] = sharded_train_two(rank, world, REC_FSDP_ARCH, REC_FSDP_KW,
                                   REC_FSDP_SHAPE, "19d", REC_FSDP_FLOOR)
    out["19d"]["cell_s"] = time.perf_counter() - t0
    out["20"] = recurrent_tp_ranks(rank, world)
    out["21"] = serve_tp_ranks(rank, world)
    return out


def serve_tp_ranks(rank, world, phase=None):
    """The cells of SERVE_TP_CELLS (those of ``phase`` alone, "21" or
    "22", where given): 21a / 21b and 22a / 22b in one spawn of two gloo
    ranks sharing the card; each cell's seconds."""
    out = {}
    for label, (arch, layers, new_tokens) in SERVE_TP_CELLS.items():
        if phase is not None and not label.startswith(phase):
            continue
        t0 = time.perf_counter()
        out[label] = serve_tp_cell(rank, world, arch, layers, new_tokens,
                                   count=label in ("21a", "22a"))
        out[label]["cell_s"] = time.perf_counter() - t0
    return out


def meta_serve_counted(cfg, batch, coordinate) -> dict:
    """[21c] the decode step of 21a's rank at ``coordinate`` counted on
    the ``meta`` device, its groups ``collectives.CountingMesh``'s: the
    params, a cache of SERVE_TP_MAX_SEQ and a (b,) position, as
    :func:`serve_tp_cell` counts it on the card."""
    from repro_torch.analysis import hlo_counter
    from repro_torch.models.transformer import Model
    from repro_torch.sharding.collectives import CountingMesh
    from repro_torch.sharding.serving import ServingStep
    model = Model(cfg)
    serve = ServingStep(model, CountingMesh(
        {"data": SERVE_TP_SHAPE[0], "model": SERVE_TP_SHAPE[1]},
        coordinate), batch, SERVE_TP_MAX_SEQ)
    params = serve.shard_params(model.init_params(torch.Generator(),
                                                  "meta"))
    cache = serve.shard_cache(model.init_cache(batch, SERVE_TP_MAX_SEQ,
                                               "meta"))
    rows = serve.rows(torch.zeros(batch, dtype=torch.long, device="meta"))
    token = torch.zeros((rows.shape[0], 1), dtype=torch.long, device="meta")
    out = {}
    for scale in (True, False):
        _, cn = hlo_counter.count(serve.decode_step, params, token, cache,
                                  rows, scale=scale)
        t = cn.totals
        out["scaled" if scale else "full"] = {
            "flops": t.flops, "bytes": t.bytes, "bytes_min": t.bytes_min,
            "coll_bytes": t.coll_bytes, "coll_by_kind": dict(t.coll_by_kind),
            "kernels": dict(cn.kernels), "coll_calls": dict(cn.coll_calls),
            "ops": cn.ops}
    return out


def _serve_tp_kernel_cases(k1):
    """[21k] K1 and K3 at 21a's serving rank's shapes (qwen3-4b on
    ``model=2``, phase 4's 4 prompts padded to 200): K1 fp32 on the
    prefill's SP rows (4 x 100 of 2560) and its 16 query / 4 kv heads' rows
    (q_norm, k_norm), and on a decode step's rows (4 of 2560; 4 x 16 / 4 x
    4 of 128); K3 on the rank's 16 / 4 heads over 200 positions, causal,
    ``tf32x3`` fp32 (what 21a runs) and ``mma`` bf16."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, s = len(PROMPT_LENS), max(PROMPT_LENS)
    shapes = ((b * s // 2, 2560), (b * s * 16, 128), (b * s * 4, 128),
              (b, 2560), (b * 16, 128), (b * 4, 128))
    return {
        "rmsnorm": [_rmsnorm_case(r, d, torch.float32, gen, k1)
                    for r, d in shapes],
        "flash_attention": [_flash_case(s, s, True, 0, gen, b=b, nh=16,
                                        nkv=4, dtype=dt)
                            for dt in (torch.float32, torch.bfloat16)]}


def phase_serve_tp(smi, k1, res=None):
    """[21] serving with the params split over ``model``: (k) K1 / K3 at
    21a's rank shapes; (a) qwen3-4b (2 layers, 4 new tokens) and (b)
    dbrx-132b (1 layer, 4 new tokens) at full width, fp32, on
    ``model=2`` (:func:`serve_tp_ranks`: two gloo
    ranks sharing the card), each held to the one-device port on the same
    weights (greedy tokens identical, the first step's logits within
    SERVE_TP_LOGIT_TOL of the largest), its K1 / K3 launches to
    :func:`serve_tp_launches`, every rank's cache bytes to the dry run's
    ``cache_bytes``; (c) 21a's decode step counted on each rank of the
    card equal to its count on the ``meta`` device (``res``: the ranks'
    results from a shared spawn, else it spawns them).  Returns (the
    kernel cases, each cell's ranks' K1 / K3 launches)."""
    import gc

    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    t_start = time.perf_counter()
    times, launches = {}, {}
    t0 = time.perf_counter()
    cases = _serve_tp_kernel_cases(k1)
    for name, cs in cases.items():
        for c in cs:
            log(f"[21k] {name} " + json.dumps(c))
    times["21k"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if res is None:
        res = ranks.spawn(serve_tp_ranks, 2, backend="gloo", device="cuda",
                          timeout=900, args=("21",))
    times["21a + 21b"] = time.perf_counter() - t0
    mesh = {"data": SERVE_TP_SHAPE[0], "model": SERVE_TP_SHAPE[1]}
    b = len(PROMPT_LENS)
    for label, (arch, layers, new_tokens) in SERVE_TP_CELLS.items():
        if not label.startswith("21"):
            continue
        cfg = config(arch, n_layers=layers, dtype="float32")
        cell = [r[label] for r in res]
        one = cell[0]["one_device"]
        want = serve_tp_launches(cfg, new_tokens - 1)
        reckoned = dryrun.reckon(cfg, {"seq": SERVE_TP_MAX_SEQ, "batch": b,
                                       "kind": "decode"}, mesh)["memory"]
        if one["launches"] != want:
            raise AssertionError(f"[{label}] one device: K1 / K3 launches "
                                 f"{one['launches']}, predicted {want}")
        scale = float(abs(one["first"]).max())
        errs = []
        for r in cell:
            if r["tokens"] != one["tokens"]:
                raise AssertionError(
                    f"[{label}] rank {r['rank']}: greedy tokens differ "
                    f"from the one-device port's: {r['tokens']} against "
                    f"{one['tokens']}")
            err = float(abs(r["first"] - one["first"]).max())
            errs.append(err)
            if err > SERVE_TP_LOGIT_TOL * scale:
                raise AssertionError(
                    f"[{label}] rank {r['rank']}: first-step logits "
                    f"{err} from the one-device port's (largest {scale}, "
                    f"tolerance {SERVE_TP_LOGIT_TOL} of it)")
            if r["launches"] != want:
                raise AssertionError(f"[{label}] rank {r['rank']}: K1 / K3 "
                                     f"launches {r['launches']}, predicted "
                                     f"{want}")
            if r["cache_bytes"] != reckoned["cache_bytes"]:
                raise AssertionError(
                    f"[{label}] rank {r['rank']} holds {r['cache_bytes']} "
                    f"cache bytes, the dry run reckons "
                    f"{reckoned['cache_bytes']}")
        launches[label] = [r["launches"] for r in cell]
        times[label] = max(r["cell_s"] for r in cell)
        log(f"[{label}] serving with the params split over model: {arch} "
            f"at full width cut to {layers} layer(s), fp32, {mesh} on two "
            f"gloo ranks sharing one card, phase 4's prompts "
            f"{list(PROMPT_LENS)} right-padded, {new_tokens} new tokens "
            f"greedy, each row at its own position: tokens identical to "
            f"the one-device port's, first-step logits within "
            f"{SERVE_TP_LOGIT_TOL} of the largest ({scale:.4g}); "
            + json.dumps({
                "max_abs_err": errs, "kv": cell[0]["kv"],
                "launches_predicted": want, "dryrun_memory": reckoned,
                "one_device": {k: one[k] for k in (
                    "prefill_s", "decode_step_s", "launches")},
                "ranks": [{k: r[k] for k in (
                    "rank", "prefill_s", "decode_step_s", "draw_s",
                    "cell_s", "params_bytes", "cache_bytes", "launches",
                    "launches_by_variant")}
                    | {"collectives_prefill": r["collectives"][0],
                       "collectives_decode_step": r["collectives"][1]}
                    for r in cell]})
            + f"; card {smi}")
    # [21c] 21a's decode step: the card's count against the meta device's
    t0 = time.perf_counter()
    cfg = config(SERVE_TP_CELLS["21a"][0], n_layers=SERVE_TP_CELLS["21a"][1],
                 dtype="float32")
    counts = []
    for rank, r in enumerate(res):
        card = r["21a"]["count"]
        meta = meta_serve_counted(cfg, b, {"model": rank})
        for scale in ("scaled", "full"):
            a = {k: card[scale][k] for k in COUNT_KEYS}
            m = {k: meta[scale][k] for k in COUNT_KEYS}
            if a != m:
                raise AssertionError(f"[21c] rank {rank} {scale}: the "
                                     f"card's count {a} differs from the "
                                     f"meta device's {m}")
        counts.append({"rank": rank, "count": card})
    times["21c"] = time.perf_counter() - t0
    log(f"[21c] 21a's decode step counted on each rank of the card "
        f"(analysis.hlo_counter, scaled and in full) equal to its count on "
        f"the meta device (collectives.CountingMesh): "
        + json.dumps(counts) + f"; card {smi}")
    log(f"[21] summary: " + json.dumps({k: round(v, 1)
                                        for k, v in times.items()})
        + f", phase 21 {time.perf_counter() - t_start:.1f} s; card {smi}")
    return cases, launches


def _serve_tp_rec_kernel_cases(k1):
    """[22k] K1 and K3 at 22a / 22b's serving rank's shapes (``model=2``,
    phase 4's 4 prompts padded to 200): K1 fp32 on the prefill's SP rows
    (4 x 100 of 2048 / 2560) and on a decode step's rows (4 of 2048 /
    2560); K3 at D 80 on 22b's rank's 16 of 32 shared-block heads over 200
    positions, causal, ``tf32x3`` fp32 (what 22b runs) and ``mma``
    bf16."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    b, s = len(PROMPT_LENS), max(PROMPT_LENS)
    shapes = ((b * s // 2, 2048), (b * s // 2, 2560), (b, 2048),
              (b, 2560))
    return {
        "rmsnorm": [_rmsnorm_case(r, d, torch.float32, gen, k1)
                    for r, d in shapes],
        "flash_attention": [_flash_case(s, s, True, 0, gen, b=b, nh=16,
                                        nkv=16, hd=80, dtype=dt)
                            for dt in (torch.float32, torch.bfloat16)]}


def phase_serve_tp_recurrent(smi, k1, res=None):
    """[22] the recurrent families served with the params split over
    ``model``: (k) K1 / K3 at 22a / 22b's rank shapes; (a) rwkv6-1.6b (2
    layers) and (b) zamba2-2.7b (one group) at full width, fp32, on
    ``model=2`` (:func:`serve_tp_ranks`: two gloo ranks sharing the card),
    each held to the one-device port on the same weights: greedy tokens
    identical, the first step's logits and each rank's cache after the
    prefill (its piece of the one-device cache under ``rules.
    cache_specs``) within SERVE_TP_LOGIT_TOL of the largest, its K1 / K3
    launches :func:`serve_tp_launches`', every rank's cache bytes the dry
    run's ``cache_bytes``; (c) 22a's decode step counted on each rank of
    the card equal to its count on the ``meta`` device (``res``: the
    ranks' results from a shared spawn, else it spawns them).  Returns
    (the kernel cases, each cell's ranks' K1 / K3 launches)."""
    import gc

    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import Model
    from repro_torch.sharding import rules
    from repro_torch.testing import ranks
    t_start = time.perf_counter()
    times, launches = {}, {}
    t0 = time.perf_counter()
    cases = _serve_tp_rec_kernel_cases(k1)
    for name, cs in cases.items():
        for c in cs:
            log(f"[22k] {name} " + json.dumps(c))
    times["22k"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if res is None:
        res = ranks.spawn(serve_tp_ranks, 2, backend="gloo", device="cuda",
                          timeout=900, args=("22",))
    times["22a + 22b"] = time.perf_counter() - t0
    mesh = {"data": SERVE_TP_SHAPE[0], "model": SERVE_TP_SHAPE[1]}
    b = len(PROMPT_LENS)
    for label, (arch, layers, new_tokens) in SERVE_TP_CELLS.items():
        if not label.startswith("22"):
            continue
        cfg = config(arch, n_layers=layers, dtype="float32")
        cell = [r[label] for r in res]
        one = cell[0]["one_device"]
        whole = cell[0]["one_device_prefill_cache"]
        want = serve_tp_launches(cfg, new_tokens - 1)
        reckoned = dryrun.reckon(cfg, {"seq": SERVE_TP_MAX_SEQ, "batch": b,
                                       "kind": "decode"}, mesh)["memory"]
        specs = _cache_leaves(rules.cache_specs(
            cfg, mesh, Model(cfg).init_cache(b, SERVE_TP_MAX_SEQ, "meta")))
        if one["launches"] != want:
            raise AssertionError(f"[{label}] one device: K1 / K3 launches "
                                 f"{one['launches']}, predicted {want}")
        scale = float(abs(one["first"]).max())
        errs, state_errs = [], []
        for r in cell:
            coord = {"data": 0, "model": r["rank"]}
            if r["tokens"] != one["tokens"]:
                raise AssertionError(
                    f"[{label}] rank {r['rank']}: greedy tokens differ "
                    f"from the one-device port's: {r['tokens']} against "
                    f"{one['tokens']}")
            err = float(abs(r["first"] - one["first"]).max())
            errs.append(err)
            if err > SERVE_TP_LOGIT_TOL * scale:
                raise AssertionError(
                    f"[{label}] rank {r['rank']}: first-step logits "
                    f"{err} from the one-device port's (largest {scale}, "
                    f"tolerance {SERVE_TP_LOGIT_TOL} of it)")
            mine = {}
            for leaf, w in whole.items():
                piece = rules.local_shard(torch.from_numpy(w), mesh,
                                          specs[leaf], coord).numpy()
                got = r["prefill_cache"][leaf]
                big = float(abs(w).max())
                e = float(abs(got - piece).max()) if got.shape == \
                    piece.shape else float("inf")
                mine[leaf] = e
                if not e <= SERVE_TP_LOGIT_TOL * big:
                    raise AssertionError(
                        f"[{label}] rank {r['rank']}: {leaf} after the "
                        f"prefill {e} from the one-device cache's piece "
                        f"{piece.shape} (largest {big}, tolerance "
                        f"{SERVE_TP_LOGIT_TOL} of it), shape {got.shape}")
            state_errs.append(mine)
            if r["launches"] != want:
                raise AssertionError(f"[{label}] rank {r['rank']}: K1 / K3 "
                                     f"launches {r['launches']}, predicted "
                                     f"{want}")
            if r["cache_bytes"] != reckoned["cache_bytes"]:
                raise AssertionError(
                    f"[{label}] rank {r['rank']} holds {r['cache_bytes']} "
                    f"cache bytes, the dry run reckons "
                    f"{reckoned['cache_bytes']}")
        launches[label] = [r["launches"] for r in cell]
        times[label] = max(r["cell_s"] for r in cell)
        log(f"[{label}] the recurrent family served with the params split "
            f"over model: {arch} at full width cut to {layers} layer(s), "
            f"fp32, {mesh} on two gloo ranks sharing one card, phase 4's "
            f"prompts {list(PROMPT_LENS)} right-padded, {new_tokens} new "
            f"tokens greedy, each row at its own position: tokens identical "
            f"to the one-device port's, first-step logits and each rank's "
            f"cache after the prefill within {SERVE_TP_LOGIT_TOL} of the "
            f"largest ({scale:.4g}); "
            + json.dumps({
                "max_abs_err": errs, "cache_max_abs_err": state_errs,
                "state": {k: {"spec": list(v["spec"]), "held": v["held"]}
                          for k, v in cell[0]["state"].items()},
                "kv": cell[0]["kv"],
                "launches_predicted": want, "dryrun_memory": reckoned,
                "one_device": {k: one[k] for k in (
                    "prefill_s", "decode_step_s", "launches")},
                "ranks": [{k: r[k] for k in (
                    "rank", "prefill_s", "decode_step_s", "draw_s",
                    "cell_s", "params_bytes", "cache_bytes", "launches",
                    "launches_by_variant")}
                    | {"collectives_prefill": r["collectives"][0],
                       "collectives_decode_step": r["collectives"][1]}
                    for r in cell]}, default=str)
            + f"; card {smi}")
    # [22c] 22a's decode step: the card's count against the meta device's
    t0 = time.perf_counter()
    cfg = config(SERVE_TP_CELLS["22a"][0], n_layers=SERVE_TP_CELLS["22a"][1],
                 dtype="float32")
    counts = []
    for rank, r in enumerate(res):
        card = r["22a"]["count"]
        meta = meta_serve_counted(cfg, b, {"model": rank})
        for scale in ("scaled", "full"):
            a = {k: card[scale][k] for k in COUNT_KEYS}
            m = {k: meta[scale][k] for k in COUNT_KEYS}
            if a != m:
                raise AssertionError(f"[22c] rank {rank} {scale}: the "
                                     f"card's count {a} differs from the "
                                     f"meta device's {m}")
        counts.append({"rank": rank, "count": card})
    times["22c"] = time.perf_counter() - t0
    log(f"[22c] 22a's decode step counted on each rank of the card "
        f"(analysis.hlo_counter, scaled and in full) equal to its count on "
        f"the meta device (collectives.CountingMesh): "
        + json.dumps(counts) + f"; card {smi}")
    log(f"[22] summary: " + json.dumps({k: round(v, 1)
                                        for k, v in times.items()})
        + f", phase 22 {time.perf_counter() - t_start:.1f} s; card {smi}")
    return cases, launches


KERNELS = [
    {"name": "rmsnorm", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "replaces": "src/repro/kernels/rmsnorm.py:36"},
    {"name": "flash_attention", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
     "replaces": "src/repro/kernels/flash_attention.py:90"},
    {"name": "matmul", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
     "replaces": "src/repro/kernels/matmul.py:56"},
    # the backward kernels of K1 and K3 (phase 13): the TPU kernels have
    # none (the reference trains through XLA's autodiff of its jnp path)
    {"name": "rmsnorm_bwd", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "replaces": "src/repro/kernels/rmsnorm.py:36"},
    {"name": "flash_attention_bwd", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
     "replaces": "src/repro/kernels/flash_attention.py:90"},
]
# the source of each variant of a kernel that has several
VARIANT_SOURCES = {
    "rmsnorm": {v: "src/repro_torch/kernels/csrc/rmsnorm.cu"
                for v in ("packed", "warp", "block")},
    "flash_attention": {
        "mma": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "tf32x3": "src/repro_torch/kernels/csrc/flash_attention.cu"},
    "matmul": {"wgmma": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
               "splitk_reduce": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
               **{v: "src/repro_torch/kernels/csrc/matmul.cu"
                  for v in ("skinny", "skinny_reduce", "tf32x3", "mma")}},
    "flash_attention_bwd": {
        "mma": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "tf32x3": "src/repro_torch/kernels/csrc/flash_attention.cu"},
}
K4 = {"route": "cuda", "source": "src/repro_torch/core/dpia/stage3_cuda.py",
      "replaces": "src/repro/core/dpia/stage3_pallas.py:430"}
_HEAD_KEYS = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--aot-child"]:
        return aot_child(sys.argv[2])
    if sys.argv[1:2] == ["--train-child"]:
        return train_child()
    sys.path.insert(0, str(ROOT / "src"))
    # every tuning cache of this run lives in a temporary directory: the
    # default cache (REPRO_AUTOTUNE_CACHE, read by the AOT child and the
    # quickstart too) and phase 11's
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tune_dir,
                                                      "default.json")
    try:
        return _run_phases(os.path.join(tune_dir, "phase11.json"))
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _run_phases(tune_cache: str) -> int:
    import gc
    t_start = time.perf_counter()
    # each phase's wall seconds (logged last)
    marks, last = {}, [t_start]

    def mark(label):
        now = time.perf_counter()
        marks[label] = round(now - last[0], 1)
        last[0] = now
    smi = phase_card()
    build_s, k1, stage_s = phase_build()
    cases = phase_kernels(k1)
    mark("1-3")
    counts, variants, (cfg, model, params), static = phase_main_path(smi)
    mark("4")
    report, (dense_graph, reqs, want) = phase_continuous(smi, cfg, model,
                                                         params)
    mark("4b")
    phase_traced_continuous(smi, cfg, dense_graph, reqs, want,
                            report["dense graph"]["tok_s_median"])
    phase_obs_cost(smi, *static)
    phase_tuned_serving(smi, cfg, model, params, reqs, want)
    mark("10e-f, 11e")
    faults = phase_faults(smi, cfg, model, params, static,
                          (dense_graph, reqs, want))
    del model, params, static, dense_graph
    torch.cuda.empty_cache()
    cases.update(phase_train_kernels())
    train, train_counts, variants["flash_attention_bwd"] = phase_train(smi)
    train["13e"] = phase_train_smoke(smi)
    mark("12-13")
    fp32_k3 = phase_against_cpu()
    mark("5")
    cases["matmul"] = phase_matmul()
    mark("6")
    dpia = phase_dpia(build_s)
    mark("7")
    p_counts, mm_variants, per_prog, p9 = phase_pipeline_main_path()
    p9["mm_variants"] = mm_variants
    phase_default_options(p9)
    phase_services(smi, p9, stage_s, build_s)
    mark("8-10")
    tuned = phase_tune(smi, tune_cache)
    mark("11")
    mesh_one, mesh_two = phase_mesh(smi, dpia)
    mark("14")
    sharded = phase_sharded(smi, want, report["dense graph"]["tok_s_median"])
    mark("15")
    # the two-rank gloo cells of phases 16-22 (16b / 16c, 17a, 18d, 19d,
    # 20a / 20b, 21a / 21b, 22a / 22b) run here, in one spawn; each phase
    # checks and logs its own
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.testing import ranks
    shared = ranks.spawn(two_rank_cells, 2, backend="gloo", device="cuda",
                         timeout=1500)
    log(f"[16-22] the two-rank cells in one spawn: "
        f"{time.perf_counter() - t0:.1f} s with the processes; card {smi}")
    mark("16-22 two-rank cells")
    sharded_train = phase_sharded_train(
        smi, train, cells=[{k: r[k] for k in DATA_AXIS_CELLS}
                           for r in shared])
    mark("16")
    for name, cs in phase_tp_kernels(k1).items():
        cases[name] += cs
    tp_train = phase_tp_train(smi, [r["17a"] for r in shared])
    mark("17")
    family_cases, families = phase_families(
        smi, k1, ep=[r["18d"] for r in shared])
    for name, cs in family_cases.items():
        cases[name] += cs
    mark("18")
    rec_cases, recurrent = phase_recurrent(
        smi, fsdp=[r["19d"] for r in shared])
    for name, cs in rec_cases.items():
        cases[name] += cs
    mark("19")
    rec_tp_cases, rec_tp = phase_recurrent_tp(
        smi, k1, res=[r["20"] for r in shared])
    for name, cs in rec_tp_cases.items():
        cases[name] += cs
    mark("20")
    serve_tp_cases, serve_tp = phase_serve_tp(
        smi, k1, res=[r["21"] for r in shared])
    for name, cs in serve_tp_cases.items():
        cases[name] += cs
    mark("21")
    serve_rec_cases, serve_rec = phase_serve_tp_recurrent(
        smi, k1, res=[r["21"] for r in shared])
    for name, cs in serve_rec_cases.items():
        cases[name] += cs
    mark("22")
    counts = {**counts, "matmul": p_counts["matmul"],
              "rmsnorm_bwd": train_counts["rmsnorm_bwd"],
              "flash_attention_bwd": train_counts["flash_attention_bwd"]}
    variants["matmul"] = mm_variants
    # the headline case of each kernel is its first: the main path's
    # prefill shape in bf16 (K2: the (800, 2560) x (2560, 4096) projection);
    # every case is listed under "cases".  K4 has one entry per generated
    # program.
    line = []
    for k in KERNELS:
        cs = cases[k["name"]]
        head = cs[0]
        entry = {**k, "launches": counts[k["name"]],
                 "max_abs_err": max(c["max_abs_err"] for c in cs),
                 **{key: head[key] for key in _HEAD_KEYS},
                 "card": smi, "cases": cs}
        if k["name"] in variants:
            entry["variant"] = head["variant"]
            entry["variants"] = {
                v: {"source": src, "launches": variants[k["name"]][v]}
                for v, src in VARIANT_SOURCES[k["name"]].items()}
        if k["name"] in ("rmsnorm", "flash_attention"):
            # phase 15's sharded runs: 15a's one rank by layout, 15b's,
            # 15c's and 15d's ranks
            entry["launches_phase15"] = {
                key: ([c[k["name"]] for c in v] if isinstance(v, list)
                      else {lay: c[k["name"]] for lay, c in v.items()})
                for key, v in sharded.items()}
        if k["name"] in ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                         "flash_attention_bwd"):
            # phase 16's sharded training, a step: 16a's one rank, 16b's and
            # 16c's ranks
            entry["launches_phase16"] = {
                key: ([c[k["name"]] for c in v] if isinstance(v, list)
                      else v[k["name"]])
                for key, v in sharded_train.items()}
            # phase 17's model axis, a step: 17a's and 17b's ranks
            entry["launches_phase17"] = {
                key: [c[k["name"]] for c in v]
                for key, v in tp_train.items()}
            # phase 18's parts: 18a / 18b by engine, 18c by arch, 18d's
            # ranks a step
            entry["launches_phase18"] = {
                part: ([c[k["name"]] for c in v] if isinstance(v, list)
                       else {key: c.get(k["name"], 0)
                             for key, c in v.items()})
                for part, v in families.items()}
            # phase 19's parts: 19a / 19b by engine, 19c by arch, 19d's
            # ranks a step
            entry["launches_phase19"] = {
                part: ([c[k["name"]] for c in v] if isinstance(v, list)
                       else {key: c.get(k["name"], 0)
                             for key, c in v.items()})
                for part, v in recurrent.items()}
            # phase 20's model axis, a step: 20a's and 20b's ranks
            entry["launches_phase20"] = {
                key: [c[k["name"]] for c in v] for key, v in rec_tp.items()}
            if k["name"] in serve_tp_cases:
                # phase 21's serving cells, a run: 21a's and 21b's ranks
                entry["launches_phase21"] = {
                    key: [c[k["name"]] for c in v]
                    for key, v in serve_tp.items()}
                # phase 22's: 22a's and 22b's ranks, a run
                entry["launches_phase22"] = {
                    key: [c[k["name"]] for c in v]
                    for key, v in serve_rec.items()}
        if k["name"] == "flash_attention_bwd":
            # the fp32 backward runs in 13e's fp32 training, not 13b's
            for v, n in train["13e"]["flash_attention_bwd_variants"].items():
                entry["variants"][v]["launches_13e"] = n
        if k["name"] == "flash_attention":
            # the fp32 forward runs in phase 5 and in 13e, not in phase 4
            for v, n in fp32_k3.items():
                entry["variants"][v]["launches_phase5"] = n
            for v, n in train["13e"]["flash_attention_variants"].items():
                entry["variants"][v]["launches_13e"] = n
        line.append(entry)
    for c in dpia:
        line.append({"name": f"dpia_cuda:{c['program']}", **K4,
                     "launches": per_prog[c["program"]],
                     "max_abs_err": c["max_abs_err"],
                     **{key: c[key] for key in _HEAD_KEYS},
                     "card": smi, "cases": [c]})
    # and one per tuned winner (phase 11: its launches are 11d's)
    for c in tuned:
        line.append({"name": f"dpia_cuda:{c['program']}", **K4,
                     "launches": c["launches"],
                     "max_abs_err": c["max_abs_err"],
                     **{key: c[key] for key in _HEAD_KEYS},
                     "card": smi, "cases": [c]})
    line += mesh_kernel_entries(smi, mesh_one, mesh_two)
    log("[phases] wall seconds: " + json.dumps(marks))
    log("[12] summary: " + json.dumps(faults))
    log("[13] summary: " + json.dumps({
        k: train[k] for k in ("median_step_s", "median_tok_s", "median_mfu",
                              "peak_gib", "launches_a_step",
                              "flash_attention_bwd_variants_a_step", "s")}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
