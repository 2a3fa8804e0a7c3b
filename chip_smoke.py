"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--sequential]

(``--sequential`` runs the robustness phase's two drills one after the
other.)  Phases, in order; any failure exits non-zero before the result line:

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles every ``bagua_tpu_torch/ops/csrc/*.cu`` with ``nvcc``.
3. kernels: each flash-attention kernel against its plain PyTorch version on
   the card (bf16 at every slice's training shape: b·h 32 and 64 at seq
   4096, BERT-Large's 128 at seq 384; a ragged bf16 length; f32; f16; heads
   of 32, 96 and 136, which the kernels widen to 64, 128 and 256, of 256
   in bf16, f16 and f32, and of 384 and 512, above 256, on the wide kernels,
   in every dtype); a head of 100 through ``flash_attention``, which
   pads it to 104 (forward and gradients against the same call on the CPU);
   every kernel at a ragged length beside a head of values near 1e4 (no read
   across heads) and twice on the same inputs (bitwise equal), at D = 64,
   128 and 256; the times of
   each kernel (hot and cold L2), its plain version and the PyTorch library
   call at slice 1's shape, the forward's and SDPA's forward at slice 2's and
   BERT-Large's shapes, each kernel at heads of 384 and 512 (b·h 4, seq 4096)
   beside its bound and SDPA's forward and backward, and the port's whole
   backward (delta, dK/dV and dQ,
   as autograd runs them) against SDPA's backward; SDPA's forward and
   backward kernels are named from one profiler window each.
4. gmm kernels: each grouped-matmul kernel against its plain version at the
   MoE path's shapes (both (d, f) pairs; balanced, skewed and empty-group
   sizes), a small ragged case, one at widths that end inside a tile (64 and
   200), one in f32, f16 at the path's shapes, widths that are not multiples
   of 8 ((100, 200) and (200, 100)) through ``gmm``, which pads them; K7b
   twice on the same inputs, balanced and skewed (bitwise equal); each
   kernel's times per form, hot and cold, balanced and skewed, beside
   ``torch._grouped_mm``; and one MoE layer's forward and backward under
   ``torch.cuda.set_sync_debug_mode("error")``, so that a host sync on the
   MoE path fails the run.
5. codec kernels: the MinMaxUInt8 compress (K1) and decompress (K2) and the
   absmax (K3) kernels against their plain versions, payload bytes,
   sidecars, decoded values and maxima exactly equal: chunks of 128 KiB,
   1 MiB, 8 MiB, the path's bucket chunk (10 MiB / 2 ranks) and its embedding
   bucket's chunk, a ragged, a tiny, a constant, a ±inf and a NaN chunk, a
   bf16 input, and for K3 a chunk of -0.0 and one holding ±inf and a NaN;
   their times against the plain versions at every size, and each kernel's
   time with a cold L2, beside its bound; K1's times on the embedding
   bucket's chunk (more than its grid holds in shared memory); K1 and K2 on
   a whole 10 MiB bucket and the whole embedding bucket as one chunk, as
   the low-precision gossip ring runs them, equal to plain, with their
   times hot, cold and plain and their bounds; the device
   kernels a call of each runs (K1 and K3 must run one).
6. sign kernels: the 1-bit codec's compress (K4) and decompress (K5) against
   their plain versions, payload bytes and decoded values exactly equal, the
   scale within 1e-6 relative: chunks of 128 KiB, 1 MiB, 8 MiB, the main
   path's ring chunk (5 MiB), its whole 10 MiB bucket (the error-feedback
   step encodes a bucket as one chunk), its embedding bucket's chunk and the
   2 x 2 path's inter-node chunk, a ragged, a tiny, an all-zero, a ±inf and a
   NaN chunk, a bf16 input; their times hot and cold against the plain
   versions and their bounds, and against ``abs().sum(dim=1)``, K4's
   reduction half; the device kernels a call of each runs (K4 must run one).
7. narrow, f16 and f32 shapes: the tiny SQuAD model of
   ``examples/squad_finetune.py`` (head_dim 32), in bf16 and in f16, takes
   one forward and backward on the card through the flash kernels (one launch
   of each a layer), its loss and gradients finite and its logits against
   the same model with the plain attention; an ``MoEMLP`` with d_model 64 in
   bf16, one with d_model 128 in f32 and one with d_model 128 in f16 each
   take one forward and backward through the gmm kernels, against the same
   layer with the dense reference gmm.
8. slice 1: every ``ReduceOp`` through the communicator over NCCL at world
   1 (f32; int32 for the bitwise ops, which take NCCL's gather path), each
   equal to its operand, nothing staged; every eager collective
   (``eager_checks``) equal to plain torch, and refused after an abort; then
   the long-context
   TransformerLM (``bench_longctx``'s widths,
   random weights from a seed) trained for 10 steps by ``BaguaTrainer`` with
   ``GradientAllReduceAlgorithm`` over NCCL; losses must be finite and
   falling, every flash kernel must have launched ``n_layers * steps`` times,
   and the model's logits on a short input must agree with the plain
   attention; then the step with the hang watchdog on against off.  The
   observability plane is on (the default): each step's span names (the
   first a ``step/build``, every later one a dispatch with one
   ``trace/bucket_collective`` a bucket), the goodput ledger (``compile``,
   then ``productive_step``), ``obs/mfu`` against the analytic count
   (``lm_step_flops``) and the allocator poll's peak are gated
   (``check_slice_obs``).  Then ``obs`` (``phase_obs``): slice 1 by two
   trainers built with ``BAGUA_OBS`` on and off, ``OBS_STEPS`` steps each,
   parameters bitwise equal; a ``StepProfiler`` window of steps 2:5 whose
   Chrome trace names K6a-c ``n_layers`` times a step; the plane's cost, A B
   B A, and its spans a step times one span's cost.  Then the HTTP status
   plane: a third trainer built with ``BAGUA_OBS_HTTP_PORT`` set (the trainer
   starts the plane) runs 5 steps while a thread scrapes ``/metrics``,
   ``/healthz`` and ``/ledger``; ``/metrics`` parses with a HELP and a TYPE
   line for every series, its series equal ``metrics.prom``'s written by an
   exporter of the same snapshot, and the parameters are bitwise those of
   the plane-off run after 5 steps; a scrape's ms.
9. slice 2: the dropless MoE TransformerLM of ``bench_moe_longseq`` (MoE in
   every odd layer, 8 experts, top-2) trained for 10 steps with Adam and the
   load-balancing loss; losses finite and falling, exact launch counts of
   the gmm and flash kernels, and the logits on a short input against the
   plain gmm and plain attention.
10. remat: slices 1 and 2 again from the same weights, batch and optimizer,
   each under its bench's rematerialization (slice 1 ``dots_no_batch``,
   slice 2 whole blocks): exact launches (the flash forward twice a layer,
   the gmm forward twice more a MoE layer), losses finite and falling, the
   first loss bitwise equal to the run just before without remat, the
   parameters' updates after 10 steps within the bf16 tolerance of it (the
   log says whether bitwise), the peak below it; the step time, the peak and
   each kernel's device time a step beside it.
11. slice 3: compressed data parallelism at world size 2.  The script starts
   itself twice as worker processes, two ranks on the one card, whose
   collectives go over gloo through host memory (NCCL refuses two ranks on
   one device; phases of one world and tiers share a spawn, ``SPAWNS``:
   every two-rank phase, slice 3 to tensor_pipeline, in one but checkpoint
   (b, c); slice 4 (2 x 2) and decentralized (2 x 2) in another, which runs
   beside the first on the card, as do tensor_pipeline (pp 2 x tp 2), the
   robustness drills and checkpoint (b, c)).  Each rank trains a 4-layer cut of BERT-Large (``bench_bert``:
   24 layers, seq 384, batch 8 per rank, AdamW 1e-4) for 5 steps
   (``CODEC_STEPS``) with ``ByteGradAlgorithm`` (the overlap phase runs it on
   the full model), then the cut with
   ``GradientAllReduceAlgorithm`` and ``compress_intra`` ``int8`` and
   ``fp8_e4m3``, and with ``QAdamAlgorithm(warmup_steps=2, lr=1e-5)``; losses finite
   and falling, exact codec and flash launch counts, parameters bitwise
   equal on both ranks, and one ByteGrad bucket's reduction through the
   kernels equal byte for byte to the same collective through the plain
   codec.  Each run prints its step time, the bytes staged through the host
   and the time of a forward and backward alone.  The ByteGrad run takes one
   step more under ``profiling.trace``: every bucket's device work is
   attributed to it (gloo's staging copies beside its codec kernels,
   ``check_slice3_obs``), and the two ranks' span dumps merge through
   ``assemble_timeline`` into a trace ``validate_timeline`` accepts.
12. slice 4, the 1-bit and top-k codecs with the error-feedback residual, two
   ranks as in slice 3: the main path is the README quick start with
   ``GradientAllReduceAlgorithm()`` and ``compress_intra="onebit_ef"`` on the
   4-layer cut, AdamW 1e-4, 5 steps; then ``compress_intra="topk"`` on the
   cut.  Launches exact (K4 = K5 = 3 x buckets x steps), the residual finite
   and nonzero, parameters bitwise equal on both ranks, and the
   error-feedback step of the largest bucket through the kernels against
   the plain codec (payload equal, residual within 1e-5 of the scale).
13. slice 4 at 2 x 2: four ranks of this script on the card, two nodes of two
   (``intra_size=2``), on the 4-layer cut: ``GradientAllReduceAlgorithm(
   hierarchical=True)`` with ``compress_inter="onebit_ef"`` (K4 = K5 = 3 x
   buckets x steps) and ``ByteGradAlgorithm()`` at its default two-level form
   (K1 = K2 = 2 x buckets x steps), and staged ZeRO
   (``ZeroOptimizerAlgorithm(hierarchical=True)``, AdamW 1e-4; no codec);
   the same checks.
14. zero, ZeRO-1 at world size 2, two ranks as in slice 3: the full
   BERT-Large with ``ZeroOptimizerAlgorithm`` over AdamW 1e-4 beside the
   replicated ``GradientAllReduceAlgorithm`` with the same AdamW, then the
   4-layer cut with ``compress_intra="int8"`` (K3 = 2 x buckets x steps: one
   encode on the scatter hop, one on the gather; AdamW 1e-3, see
   ``ZERO_RUNS``); the same checks, and ZeRO's optimizer state a rank exactly
   half of the replicated run's, its peak memory below it.
15. decentralized, the gossip families at world size 2, two ranks as in
   slice 3, with AdamW 1e-4: ``DecentralizedAlgorithm(hierarchical=False,
   peer_selection_mode="all", track_peer_weights=True)`` (no codec) and
   ``LowPrecisionDecentralizedAlgorithm(hierarchical=False)`` on the 4-layer
   cut (K1 = buckets x steps, a whole bucket one chunk; K2 three times that).
   Their ranks differ by design, so in place of the parameters' equality:
   after every step, fingerprints of every bucket show the peer weights
   equal on both ranks (``all``), or each rank's ``left`` and ``right``
   replicas equal to its neighbours' ``self`` and its parameters to its own
   ``self`` (the ring), and the parameters of the ranks differ after the
   last step; losses equal on the ranks, finite and falling; exact launches;
   the ring's codec of a middle bucket's and of the embedding bucket's
   ``diff`` through the kernels equal to the plain codec.
   The same spawn then runs autotune (``AUTOTUNE_RUNS``) on the 4-layer
   cut, AdamW 1e-4: (a) the live loop: rank 0's ``init_process_group``
   serves the autotune sidecar (``BAGUA_SERVICE_PORT``, 2 samples, no
   warmup or confidence time), a ``GradientAllReduceAlgorithm(
   hierarchical=False)`` trainer at autotune level 1 with
   ``BAGUA_AUTOTUNE_SPACE=legacy`` (one node: the bucket size is the only
   knob) checks in every ``AUTOTUNE_EVERY`` (20) steps, where the trainer's
   default is the JAX package's 100, and trains until the first check-in
   that changes the plan, then 10 steps more (at most
   ``AUTOTUNE_MAX_STEPS``), and an untuned control trainer restored from a
   snapshot taken just before that check-in runs the same steps on the same
   batch.  Gates: the service's task holds the cut's tensors, every
   check-in reported a nonzero speed, the plan signature changed and is
   equal on both ranks at every step, the losses equal the control's bitwise
   at every step, the parameters bitwise equal on the ranks and to the
   control's.  Prints the check-ins (synchronization, report, ask, apply
   ms), the buckets before and after, and the step that rebucketed against
   the median step.  (b) the codec flip: the same cut and family, 3 steps,
   then ``_apply_recommendation(BaguaHyperparameter(compress_intra=
   "onebit_ef"))`` for 3 steps, then ``"off"`` for 2.  Gates: the residual
   appears zero-filled, one f32 a bucket element; the 1-bit steps launch K4
   and K5 as slice 4's 1-bit run does a step, and stage as many bytes a
   step; after the flip back ``algo_state`` holds no residual, allocated
   memory falls by its bytes and the staged bytes are the first steps';
   parameters bitwise equal on the ranks after every step.  Prints each
   migration's ms.
16. decentralized at 2 x 2, four ranks as two nodes of two on the 4-layer
   cut: ``shift_one`` over the four ranks (the peer weights equal to those
   of the step's partner) and ``LowPrecisionDecentralizedAlgorithm(
   hierarchical=True)`` (the intra-node average, then the ring over the two
   nodes); the same checks.
17. async, async model average at world size 2, two ranks as in slice 3:
   the full BERT-Large with the bench's ``AsyncModelAverageAlgorithm(
   sync_interval_ms=100)``, AdamW 1e-4, then on the 4-layer cut a pinned
   period of 2 after 2 warmup steps with ``async.partition`` armed on rank 1
   alone (staleness cap 2), and a period of 1 with an abort from rank 0 and
   a resume from rank 1.  Gates: the same period, launches, catch-ups and
   status after every step on both ranks; a round applied inside the full
   run's window; the ranks' parameters differ after the window and are
   bitwise equal after ``barrier`` and ``sync_for_checkpoint``; staged
   bytes exactly two f32 copies of the weights a round, warmup step or
   catch-up plus the losses; the partition run's catch-up at the same step
   on both ranks, bitwise equal right after it, its lag within the cap; the
   abort run's status turning at the same steps on both ranks; losses
   finite and falling; exact flash launches, no codec.  Prints the agreed
   period, the rounds, the step times against the replicated and ``all``
   gossip runs of the same call, the peak, and how long each apply waited
   for its round against a round's whole time alone.
18. features, the trainer's step features at world size 2, two ranks as in
   slice 3: the full BERT-Large ZeRO over AdamW 1e-4 on the leaf layout
   (``flat_resident="off"``, 3 steps), its per-step bucket fingerprints equal
   to the zero phase's ZeRO run (resident by default) and its peak at least
   0.9 GB above; on the cut, ``GradientAllReduceAlgorithm`` with
   ``accum_steps=2`` and ``grad_guard="skip"`` (3 steps), its losses within
   1e-2 of the first 3 of the cut's full-precision run without rebucket
   (below) and every verdict healthy (it ran on the full BERT-Large
   against the zero phase's replicated run until the autotune phase needed
   the time); on the cut, the
   1-bit ring under the guard with ``grad.poison`` at step 4 of 10 against a
   clean run of 9 (parameters and residual bitwise equal, after two clean
   runs shown bitwise equal; one skip), and a rebucket from 10 MiB to 2 MiB
   buckets after step 5, full precision (parameters bitwise equal to the run
   without it, AdamW's state on the new plan) and under the 1-bit ring (the
   residual on the new plan).  Every earlier phase runs on the default
   ``flat_resident="auto"`` layout, which each log line names.
19. overlap, the overlap scheduler at world size 2, two ranks as in slice 3
   (``OVERLAP_RUNS``): (a) the 4-layer cut with GradientAllReduce, AdamW
   1e-4, ``accum_steps=2``, ``overlap`` off then on (3 steps each): parameters
   bitwise equal after every step; the backward's time, the communication's
   and the wait after the backward a step, and the share of the serialized
   communication the overlap hides; (b) the full BERT-Large with ByteGrad
   and ``overlap="on"`` (3 steps): every K1 and K2 launch made on the comm
   stream by the comm worker (99 and 198 a step), one real K1 call of the
   last step equal to plain, parameters bitwise equal to the serialized run
   on the same plan; K1's device intervals against the backward's kernels in
   one profiled step; (c) the full BERT-Large with ZeRO and
   ``overlap="on"`` (3 steps): per-step fingerprints equal to the
   zero phase's serialized run, its state exactly half the replicated run's,
   the peak of the bytes it requests no higher; on the 4-layer cut, (d) the chunked ring
   (``overlap_chunk_bytes`` 1 MiB) within 1e-5 of the fused allreduce's
   losses, and the int8 (K3) and 1-bit (K4, K5) chunked rings with exact
   launches and the first sub-chunk encode of their last step on the comm
   worker equal to plain; (e) every eager collective on card tensors; (f)
   the collective log (``bagua_tpu_torch.analysis.collective_check``) of
   (b)'s overlapped and serialized ByteGrad runs and of (c) against the
   zero phase's serialized run: every step's multiset of collectives equal
   between the two, every bucket with at least one collective, the plan's
   upkeep (the readiness broadcast) counted apart (``check_collectives``).
20. checkpoint (``resume_check``): each run trains 4 steps uninterrupted, then
   again with an async save after step 2 and one step while it is in flight,
   then a fresh trainer and manager restore the newest verified step and
   train the rest; the restored step, the losses and the digest of the whole
   final state (parameters, optimizer state, the algorithm's state) must equal
   the uninterrupted run's bitwise, and the kernels' launches after the
   restore those of two of its steps.  (a) runs after ``remat``: slice 1's
   long-context LM at world 1 over NCCL (the flash kernels), a torn step 4
   saved after the resume point, so that the restore falls back to step 2.
   Then generate (``phase_generate``), still at world 1: slice 1's LM at
   full width (weights of seed 0) decodes the first 512 tokens of slice 1's
   batch (2 rows) and 256 greedy tokens through ``generate`` (the dense KV
   cache) and through the page pool (64 positions a page): paged tokens and
   logits bitwise equal to dense, every step's logits within 5e-2 of the
   training forward's (K6a) on prompt and generated tokens, each greedy
   token equal to that forward's argmax wherever its top-2 margin exceeds
   the gate, no flash launch in the decode loops; ms a step and tokens/s.
   Then serve (``phase_serve``, ``longctx-serve-1chip``): slice 1's LM saved
   as a serving artifact and loaded back bitwise, then ``ServeEngine`` (8
   slots, 64-token pages, 256-token prefill chunks, a pool of 80 pages)
   over a Poisson-paced trace of 16 requests (``SERVE``): every request
   completes, requests join running batches and one is preempted and
   recomputed, no page in use at the end, no flash launch in a tick, the
   ledger's serving classes fed; 4 requests against ``generate()``
   (``check_against_generate``); TTFT and TPOT percentiles, tokens/s, the
   peak, and continuous against static batching on one backlog.
   The multi-rank phase, two ranks as in slice 3 in a spawn of its own
   after the robustness drills (beside the spawn of the other two-rank
   phases), on the 4-layer cut: (b) the 1-bit ring with its residual (K4, K5), step 4's part
   of rank 1 alone corrupted, both ranks falling back to step 2; (c) ZeRO,
   the low-precision ring (K1, K2; peer replicas a rank) and async model
   average after ``sync_for_checkpoint``, and a resident
   GradientAllReduce checkpoint restored into the leaf layout with the saved
   parameters bitwise.  Prints the free space where it writes (a temporary
   directory, deleted after), and for each run and rank the save's stall (the
   snapshot), the time until it is durable, its digest time, the restore's
   time, the bytes on disk and the step with the save in flight against the
   same step without one, beside the card's name and power limit.
21. model_parallel, expert and sequence parallelism at world size 2, two ranks
   as in slice 3, in their spawn (``MP_RUNS``).  (a) Slice 2's MoE LM at full width
   expert-parallel over the mesh ``{"ep": 2}`` (4 experts and 8 rows a rank,
   ``expert_axis="ep"``, Adam 1e-4, ``FULL_STEPS`` steps), from the world-1
   model's weights, first with the dense-slot exchange, then with the
   exact-count one: exact launches (K7a ``4 n_moe`` and K7b ``2 n_moe`` a
   step, each flash kernel ``n_layers``), the dense parameters bitwise equal
   on both ranks, the two forms bitwise equal (losses, dense and expert
   parameters), every step's loss within ``MP_LOSS_RTOL`` of slice 2's model
   at world 1 on the global batch of 16 (run at the end of slice 2's phase,
   alone); on a cut (``MP_CUT``: d_model 128, f32, SGD 0.1) one step equal to
   the world-1 step within ``MP_CUT_RTOL`` of every parameter, a check that
   a missing ``1 / ep`` rescale would fail; then the dense-slot run again
   under ZeRO over the same Adam (the expert tables' state local: the dense
   state a rank exactly half of the replicated run's, losses within
   ``MP_LOSS_RTOL`` of it) and under QAdam through its switch (two warmup
   steps, lr 1e-5: K1 and K2 launched exactly as the compressed phase's
   buckets say), launches exact and dense parameters bitwise equal on both
   ranks.  (b) Slice 1's LM at full width
   sequence-parallel over ``{"sp": 2}``: the attention alone (ring with the
   flash kernels, ring's plain loop, Ulysses), outputs and q/k/v gradients
   gathered over sp against world-1 ``flash_attention``; on a cut
   (``SP_CUT``: d_model 256, f32, SGD 0.1) one ring step and one Ulysses step
   equal to the world-1 step within ``MP_CUT_RTOL`` of every parameter, a
   check that a control run at position offset 0 fails; then
   ``sp_lm_loss_fn`` with the ring and with Ulysses, ``FULL_STEPS`` AdamW
   steps each: exact launches (ring ``n_layers * sp`` of each flash kernel a
   step, Ulysses ``n_layers``), dense parameters bitwise equal on both ranks,
   losses within ``MP_LOSS_RTOL`` of slice 1's.  Prints step times, peaks,
   the bytes staged a step (the mesh axis's collectives apart) and, in an
   EP step of its own, the time in the exchange; K7a/K7b at the EP rank's
   shapes held against their plain versions (``GMM_TOL``, ``GMM_DRHS_TOL``)
   and timed beside them, ``torch._grouped_mm`` and their bounds.  The kernel phase also holds K6a-c non-causal with a random
   nonzero ``dlse`` at the ring's per-rank shape (b·h 32, s 2048) and times
   them beside SDPA's ``is_causal=False``.
22. tensor_pipeline, tensor and pipeline parallelism, two ranks as in slice 3,
   in their spawn (``TPP_RUNS``), then four (``TPP4_RUNS``).  Slice 1's LM at full
   width from slice 1's world-1 weights (each rank's slice cut by
   ``models.convert.shard_state_dict``), AdamW 1e-4, ``FULL_STEPS`` steps on
   slice 1's batch: (a) over ``{"tp": 2}`` (8 heads and d_ff 2048 a rank, no
   bucket collective: a tp-only mesh has no comm axis), launches exact (each
   flash kernel ``n_layers`` a step); (b) ``PipelinedTransformerLM`` over
   ``{"pp": 2}`` with ``PP_MICRO`` microbatches of one row, launches exact
   with the bubble ticks (``n_layers / pp`` a tick over ``PP_MICRO + pp - 1``
   ticks a step); each with its losses within ``MP_LOSS_RTOL`` of slice 1's,
   its dense parameters bitwise equal on both ranks and its sharded ones
   different.  Then one SGD step on a cut of slice 1 (``SP_CUT``: f32,
   d_model 256, 4 heads, seq 512) against world 1 within ``MP_CUT_RTOL`` of
   every parameter at tp 2 (control: ``tp_reduce`` with an allreduce
   backward), pp 2 (control: no ``pp_size`` prescale) and, as four ranks, pp
   2 x tp 2 (control: no prescale), whose state after the step is saved, one
   step more taken and resumed bitwise from the save.  At tp 2,
   ``generate_tp`` of slice 1's LM at full width from its world-1 weights on
   the generate phase's prompt: tokens and logits bitwise equal on both
   ranks, logits within 5e-2 of the generate phase's; and a restore across
   meshes that the JAX package completes, on the cut: saved over
   ``{"tp": 2}`` after 2 AdamW steps, restored over ``{"dp": 2}``, 2 steps
   there within ``MP_CUT_RTOL`` of the straight run's.  Prints the step times,
   peaks and the bytes staged a step (the axis's collectives and the bucket
   collectives apart).  The kernel phase holds K6a-c at the tp and pp rank's
   shape (b·h 16, s 4096, d 64, causal) against plain and times them hot and
   cold beside their bounds and SDPA.

23. vision, at world 1 over NCCL after ``generate`` (``phase_vision``;
   weights of seed 0, images N(0, 1) and labels uniform in [0, 1000) of
   seed 1): (a) ``resnet50-1chip``, ``bench_family``'s ResNet50 (128 images
   of 224 px f32) with ``SyncBatchNorm`` over the world's ``dp`` axis,
   ``fuse_optimizer(SGD(0.1, momentum=0.9))`` and GradientAllReduce, 10
   steps: losses finite and falling, no ported kernel launched, the first
   step's loss and the logits within the bf16 tolerance of a twin with the
   local norm; 3 steps of the fused wrapper (leaf layout) and of plain SGD
   (the default layout) from the same weights with cuDNN deterministic,
   parameters bitwise equal; the resident layout's unwrapping of
   ``fused_inner`` printed; one profiled step's device ms by class
   (convolution, batch norm, optimizer, collectives, elementwise) and a
   kernels-only step's idle share; (b) ``vgg16-1chip``, ``bench_vgg16``'s
   VGG16 (256 bf16 images, SGD with momentum 0.9 at ``VISION["vgg_lr"]``,
   GradientAllReduce flat; cuDNN's autotune on for it alone), 10 steps, the
   same loss gates.  Each prints its step ms, img/s, peak and model flops a
   step against the bf16 dense peak.
24. vision (2 ranks), in the two-rank spawn (``VISION_STACK``,
   ``VISION_CUT``): (c) ``examples/imagenet_resnet.py``'s stack on a
   one-block cut of ResNet50 (its widths, 1000 classes, 224 px, 16 images a
   rank): ``CachedDataset(backend="tcp", num_shards=2)`` on the native store
   server (built with the kernels, required) over 64 counted samples,
   ``LoadBalancingDistributedSampler`` shards, ``prefetch_to_device``,
   ``SyncBatchNorm`` over dp, ``ByteGradAlgorithm(hierarchical=False)`` and
   ``fuse_optimizer(SGD(0.05, momentum=0.9))``, 3 steps
   (``check_vision_ranks``: losses finite, parameters bitwise equal on both
   ranks, K1 = buckets x steps and K2 twice that, every SyncBN layer's last
   batch statistics bitwise equal on both ranks and a local-norm control's
   different, the shards disjoint and covering the dataset, every sample
   decoded once, every read after a rank's first pass a hit, the cache's
   keys the samples drawn); (d) one f32 SGD step of a small cut (16
   filters, two stages, 32 px, 4 images a rank) with SyncBN within
   ``MP_CUT_RTOL`` of world 1 on the 8 images, the local norm's control
   outside it.
25. robustness (``phase_robustness``), beside the two-rank spawn after the
   four-rank ones, each run
   through ``python -m bagua_tpu_torch.distributed.run`` as a subprocess with
   a free port and a wall-clock bound (``DRILL_BOUND_S``), its worker this
   script under ``--drill``: (a) ``longctx-watchdog-1chip``, slice 1's LM at
   full width (``build_slice``, weights of seed 0, batch of seed 1) with
   ``--nproc_per_node 1 --max_restarts 1`` and ``BAGUA_COMM_TIMEOUT_S=5``
   for 10 steps with ``BaguaCheckpointManager``: an async save of step 3,
   then before step 4's forward a real device wedge (``torch.cuda._sleep``
   of about ``WEDGE_S`` on the step's stream, once: a marker file).  Gates:
   the launcher exits 0 after exactly one restart; the first worker exits 3
   from the watchdog with its stacks in the log; the restarted worker
   resumes from step 3; the losses of steps 0-9 bitwise equal to slice 1's;
   the first worker's ``watchdog_abort`` flight record (``BAGUA_OBS_DUMP_DIR``)
   valid, its wedged section among its active spans.
   Prints the seconds from the wedge's enqueue to the worker's exit, from
   that exit to the restarted worker's first step, the restore, the steps
   lost and the run.  (b) ``elastic-cut-2to1to2-1chip``: two launchers
   (``--nnodes 1:2``, lease TTL 3 s, join window 4 s), each worker on
   ``cuda:0`` over gloo training slice 1's model cut to ``SP_CUT``'s widths
   with ``ByteGradAlgorithm(hierarchical=False)`` and SGD 0.1 on a fixed
   global batch split by the world, a save every step; node 1's launcher and
   worker killed as a process group after 3 world-2 steps, node 0 resuming
   at world 1 (whose worker leaves the last 5 steps to world 2 and waits),
   node 1 relaunched as a standby, a coordinated resize back to world 2.
   Gates: the worlds run ``[2, 1, 2]``; the launcher's counters
   ``elastic/lease_expired`` 1 and ``elastic/resizes`` >= 1; both launchers
   exit 0; every step run twice within ``ELASTIC_RERUN_RTOL`` relative; the
   last parameters bitwise equal on both ranks; K1 = buckets and K2 = 2 x
   buckets at every world-2 step of every rank.  Prints the seconds from the
   kill to the lease's expiry and to the first step at world 1, and from the
   relaunch to the first step at world 2.  The two drills run at once, one
   thread each (``--sequential``: one after the other, each drill's times
   its own).  Slice 1 (phase 8) also times its step with the hang watchdog
   on (the default) against off, A B B A, ``WATCHDOG_COST_STEPS`` steps a
   window, and the watchdog's work on the step's host path directly.  (a)
   runs with ``BAGUA_LOCKDEP=on``: the witness of the launcher and of each
   worker (the first writes it in the watchdog's exit) must hold no lock-order
   inversion and no edge among the package's locks that the static graph
   lacks (``check_lockdep_witness``).
26. podsim (``phase_podsim``), beside the two-rank spawn after checkpoint (a):
   the pod simulator's drill (``scripts/scale_drill.py:95-185``) at world
   32, the first size of ``BAGUA_SCALE_RANKS``, slice 8, link shape ``pod``,
   seed 0, inter-node codec ``minmax_uint8``, 1 step of 8192 elements, lease
   TTL 4 s: 32 node processes and the coordinator stack in this process,
   its 17 checks all true; prints the wall seconds, the cold start's
   rendezvous, the monitor tick's p50/p99, the slowest node's import seconds
   and the largest node resident set (the nodes import no torch).  Its processes are
   stopped when it ends.
27. lint (``phase_lint``), after podsim: ``python -m bagua_tpu_torch.analysis
   bagua_tpu_torch/ --engine ast,concurrency,trace`` exits 0 against the
   package's baseline; prints its findings by rule and its seconds.
28. records: the port's own records, written under ``chiprun_out/``
   (``RECORDS_DIR``) and validated by the port's schemas: (a) slice 1's
   ``bagua-efficiency-v1`` record (its ledger report, static footprint and
   ``obs/mfu`` record; ``efficiency_record``); (b) serve's
   ``bagua-bench-serve-v1`` list (``smoke``: TTFT/TPOT percentiles of the
   trace, continuous against static over ``SERVE_AB_TRIALS`` interleaved
   trials, the serving ledger classes, the weights through the serving
   loader; ``serve_bench_records``); (c) ``regress`` (``phase_regress``,
   after serve): ``obs.regress``'s card probe (ResNet50, flat-resident off
   against on, ``REGRESS_TRIALS`` trials, the efficiency trend records)
   twice, the second against the first through the CLI's file mode; the
   trend record validates, its verdicts printed, not gated; (d)
   ``profiling.trace_op_profile`` around ``OP_PROFILE_CALLS`` enqueued
   launches of each of K1-K5 at the 5 MiB chunk in the codec and sign phases:
   each kernel in the trace as many times as it was launched, its device time
   beside the event-timed row (``op_profile_check``); (e)
   ``profiling.trace_overlap`` over ``TRACE_OVERLAP_STEPS`` more steps of
   overlap's ``bytegrad_overlap`` run after its gates, rank 0 traced: non-empty,
   communication on the device, an overlap fraction in [0, 1]
   (``check_trace_overlap``).
29. chaos: ``scripts/torch_chaos_drill.py``'s matrix, the JAX drill's 16
   faults: its in-process drills at world 1 after ``regress``
   (``phase_chaos``), its two-rank drills at the end of the two-rank spawn
   and its 2 x 2 drill at the end of slice 4 (2 x 2)'s (``chaos_run``).
   Gate: every drill injected, detected and recovered, with its flight record
   and its badput class (``check_chaos``); the record to
   ``chiprun_out/torch_chaos_drill.json``.  The seconds of both groups and of
   both streams are printed at the end.

Phases 1-7 run alone (the kernels' times among them); then the spawn of
the two-rank phases starts, and beside it run, in order, the in-process
phases from slice 1 on, podsim and lint, the four-rank spawns, the robustness
drills and the spawn of checkpoint (b, c) (no gate of theirs is a time; their
printed times hold the other spawn's load).

The script is the subreaper of every process it starts (``adopt_orphans``):
after each phase (or group of phases run side by side) it stops and reaps
every child still alive, its own and the orphans of its children, and prints
them (``stop_leftovers``); a phase that leaves one fails the run.  A failing
run, a SIGTERM, SIGINT or SIGHUP, and ``SCRIPT_BOUND_S`` seconds of run stop
them too and exit non-zero; the workers die with their parent
(``PR_SET_PDEATHSIG``).

The flash kernels are checked at every slice's shape (phase 3).  The line
before the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  ``build_slice`` holds slices 1 and 2's
model, trainer and batch; ``scripts/torch_step_profile.py`` profiles the
same ones.
"""

from __future__ import annotations

import collections
import copy
import functools
import gc
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

_T_IMPORT = time.time()   # before torch: a drill worker's start-up breakdown

import numpy as np  # noqa: E402
import torch  # noqa: E402

_T_TORCH = time.time()

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
SLEEP_CYCLES = 50_000_000  # about 25 ms at the H100's clock: longer than any timed enqueue
L2_FLUSH_BYTES = 256 * 1024 ** 2   # five times the H100's 50 MB L2

MAIN = dict(b=2, s=4096, h=16, d=64)
MOE = dict(b=8, s=4096, h=8, experts=8, k=2, d_model=512, d_ff=2048)
BERT = dict(b=8, s=384, h=16, d=64, cut_layers=4)   # bench_bert, per rank
#: heads above 256, timed at slice 1's seq (no configuration of the repo has one)
WIDE = dict(bh=4)
#: examples/squad_finetune.py --tiny: head_dim 32, which the flash kernels widen to 64
SQUAD_TINY = dict(vocab_size=1024, d_model=128, n_heads=4, n_layers=4, d_ff=512,
                  max_seq_len=384)
CODEC_WORLD = 2
#: the model_parallel phase's ranks (one mesh axis of 2)
MP_WORLD = 2
CODEC_BUCKET_BYTES = 10 * 1024 ** 2
STEPS = 10
# flash: bf16 and f16 round P and dS at other places than the plain versions
# (f16's ulp is an eighth of bf16's); f32 sums in another order
TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
# gmm, by the operands' dtype: a 16-bit product is summed in f32 and rounded
# once on both sides (one ulp: bf16 2^-8, f16 2^-11); an f32 product, and
# d_rhs (f32 on both sides), differ by summation order only
GMM_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-4}
GMM_DRHS_TOL = 1e-4
REPLACES = {
    "flash_fwd": "bagua_tpu/ops/flash_attention.py:119",
    "flash_bwd_dkv": "bagua_tpu/ops/flash_attention.py:274",
    "flash_bwd_dq": "bagua_tpu/ops/flash_attention.py:291",
    "grouped_matmul": "bagua_tpu/ops/gmm.py:95",
    "grouped_matmul_drhs": "bagua_tpu/ops/gmm.py:133",
    "compress_chunked": "bagua_tpu/compression/pallas_codec.py:158",
    "decompress_chunked": "bagua_tpu/compression/pallas_codec.py:515",
    "absmax_chunked": "bagua_tpu/compression/pallas_codec.py:276",
    "sign_compress_chunked": "bagua_tpu/compression/pallas_codec.py:409",
    "sign_decompress_chunked": "bagua_tpu/compression/pallas_codec.py:483",
}
#: K4's scale against its plain version: the same sum of |x| in another order
SIGN_RTOL = 1e-6
#: the same, over the main path's largest bucket encoded as one chunk (31.6 M
#: elements): two f32 sums of that many positive terms in different orders
#: (the pairwise bound alone is log2(n) 2^-24 = 1.5e-6 for each)
EF_BUCKET_RTOL = 1e-5
SOURCE = "bagua_tpu_torch/ops/csrc/flash_attention.cu"
GMM_SOURCE = "bagua_tpu_torch/ops/csrc/gmm.cu"
CODEC_SOURCE = "bagua_tpu_torch/ops/csrc/codec.cu"


def log(*args):
    print(*args, flush=True)


#: the checkout's root, and where the records of a run go (``.gitignore``
#: lists it)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
RECORDS_DIR = os.path.join(REPO_DIR, "chiprun_out")


def write_record(name, obj) -> str:
    """``obj`` as JSON to ``RECORDS_DIR/name``; returns the path."""
    os.makedirs(RECORDS_DIR, exist_ok=True)
    path = os.path.join(RECORDS_DIR, name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    return path


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up.  A
    sleep kernel queued first holds the card while the host enqueues every
    call, so the launches run back to back and the events time the device,
    not the host's enqueue (longer than a small kernel's run)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` with a cold L2: before each call a write of
    ``L2_FLUSH_BYTES`` evicts its inputs, and two events around the call
    alone time it (behind a sleep kernel, as in :func:`cuda_ms`)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.fmean(start.elapsed_time(end) for start, end in events)


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def abs_err(got, want) -> float:
    d = (got.float() - want.float()).abs()
    return d.max().item() if d.numel() else 0.0


def phase_device():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return card


def phase_build():
    """Every kernel source with ``nvcc`` (one process each, all at once)
    and, beside them, the native store server with the host's C++ compiler
    (required: a failed build fails the run)."""
    import threading

    from bagua_tpu_torch.contrib.utils.native_build import ensure_store_server
    from bagua_tpu_torch.ops import _build

    t0 = time.perf_counter()
    store = {}
    thread = threading.Thread(target=lambda: store.update(
        path=_run_caught(ensure_store_server, required=True)))
    thread.start()
    logs = _build.build_all()
    thread.join()
    if isinstance(store["path"], Exception):
        raise store["path"]
    log(f"build: {sorted(logs)} and the native store server "
        f"{os.path.relpath(store['path'])} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        log(f"  {name}: " + "; ".join(ptxas_usage(text)))
        for warning in sorted({ln.strip() for ln in text.splitlines() if "Performance Loss" in ln}):
            log(f"  {name}: {warning}")


def _run_caught(fn, *args, **kwargs):
    """``fn``'s result, or the exception it raised (for a thread; the
    caller raises it)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:   # noqa: BLE001 - raised again on the main thread
        return e


def ptxas_usage(text):
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``'s output,
    as ``name<template args>: N registers, S spill bytes``."""
    out, kernel, spill = [], "?", "0"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:   # the mangled name: <length><name>, then I<template args>E
            mangled = m.group(1)
            names = [(mangled[end - n:end], end) for end in
                     (k.end() for k in re.finditer("kernel", mangled))
                     for n in range(len("kernel"), end)
                     if mangled[:end - n].endswith(str(n)) and not mangled[end - n].isdigit()]
            kernel = names[-1][0] + _template_args(mangled, names[-1][1]) if names else mangled
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{kernel}: {m.group(1)} registers, {spill} spill bytes")
            spill = "0"
    return out


def _template_args(mangled, i):
    """The template arguments that follow a kernel's name at ``i`` in its
    mangled name (``I`` ... ``E``), as ``<a,b>``; integers and bools by
    value, types by name."""
    if mangled[i:i + 1] != "I":
        return ""
    i, args = i + 1, []
    while i < len(mangled) and mangled[i] != "E":
        m = re.match(r"L[ib](\d+)E", mangled[i:])
        n = re.match(r"\d+", mangled[i:])
        if m:
            args.append(m.group(1))
            i += m.end()
        elif n:
            j = i + n.end()
            args.append(mangled[j:j + int(n.group())])
            i = j + int(n.group())
        else:
            args.append({"f": "float", "b": "bool", "i": "int"}.get(mangled[i], mangled[i]))
            i += 1
    return "<" + ",".join(args) + ">"


def _inputs(bh, s, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", dtype=dtype, generator=g)
            for _ in range(4)]


def check_kernels(bh, s, d, dtype, causal, seed=0, dlse=False):
    """Every kernel against its plain version on one input; returns the
    inputs and the absolute errors by kernel.  ``dlse``: a random nonzero
    logsumexp cotangent enters the backward's row statistic (``delta -
    dlse``), as ring attention's merge makes it."""
    from bagua_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(bh, s, d, dtype, seed)
    o, lse = fa.flash_fwd(q, k, v, causal)
    po, plse = fa.fwd_plain(q, k, v, causal)
    delta = (do.float() * po.float()).sum(dim=-1)
    if dlse:
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        delta = delta - torch.randn(bh, s, device="cuda", generator=g)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    pdk, pdv = fa.dkv_plain(q, k, v, do, plse, delta, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    pdq = fa.dq_plain(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    rel = {"o": rel_err(o, po), "lse": rel_err(lse, plse), "dk": rel_err(dk, pdk),
           "dv": rel_err(dv, pdv), "dq": rel_err(dq, pdq)}
    log(f"kernels bh={bh} s={s} d={d} {dtype} causal={causal}"
        + (" with dlse" if dlse else "") + ": "
        + ", ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    bad = {n: e for n, e in rel.items() if not e <= TOL[dtype]}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad} "
                             f"(tolerance {TOL[dtype]})")
    errs = {"flash_fwd": max(abs_err(o, po), abs_err(lse, plse)),
            "flash_bwd_dkv": max(abs_err(dk, pdk), abs_err(dv, pdv)),
            "flash_bwd_dq": abs_err(dq, pdq)}
    return (q, k, v, do, plse, delta), errs


def check_backward_edges():
    """The forward and backward kernels at a ragged length (100) with every
    row of the next head set to 1e4: the other heads' o, lse and gradients
    still match the plain versions (a tensor map over [bh * s, d] would fill
    a head's last tile with the next head's rows); and two launches on the
    same ordinary inputs give bitwise-equal o, lse, dK, dV and dQ (one block
    writes each output tile, in a fixed order)."""
    from bagua_tpu_torch.ops import flash_attention as fa

    def outputs(q, k, v, do, kernels):
        po, plse = fa.fwd_plain(q, k, v, True)
        delta = (do.float() * po.float()).sum(dim=-1)
        if kernels:
            return [*fa.flash_fwd(q, k, v, True),
                    *fa.flash_bwd_dkv(q, k, v, do, plse, delta, True),
                    fa.flash_bwd_dq(q, k, v, do, plse, delta, True)]
        return [po, plse, *fa.dkv_plain(q, k, v, do, plse, delta, True),
                fa.dq_plain(q, k, v, do, plse, delta, True)]

    for d in (32, 64, 128, 256):
        q, k, v, do = _inputs(3, 100, d, torch.bfloat16, seed=8)
        for x in (q, k, v, do):
            x[1] = 1e4
        got, want = outputs(q, k, v, do, True), outputs(q, k, v, do, False)
        rel = {n: max(rel_err(a[h], b[h]) for h in (0, 2))
               for n, a, b in zip(("o", "lse", "dk", "dv", "dq"), got, want)}
        inputs = _inputs(8, 1000, d, torch.bfloat16, seed=9)
        same_bits = all(torch.equal(a, b) for a, b in
                        zip(outputs(*inputs, True), outputs(*inputs, True)))
        torch.cuda.synchronize()
        log(f"forward and backward head boundary d={d} (s 100, head 1 at 1e4): heads 0 "
            f"and 2 " + ", ".join(f"{n} {e:.3g}" for n, e in rel.items())
            + f"; two launches (b·h 8, s 1000) bitwise equal: {same_bits}")
        if not (max(rel.values()) <= TOL[torch.bfloat16] and same_bits):
            raise AssertionError(f"flash kernels read across heads or are not "
                                 f"deterministic: {rel}, bitwise {same_bits}")


def check_padded_head():
    """A head of 100 through ``flash_attention``, which pads it to 104 on the
    card and passes the scale of 100: one launch of each kernel, and o and
    the gradients of q, k and v against the same call on the CPU, whose
    wrappers run the plain versions on the unpadded head (o within the
    kernels' tolerance, the gradients, two products deep, within twice it)."""
    from bagua_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(2, 512, 4, 100, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    runs = []
    for device in ("cuda", "cpu"):
        leaves = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        fa.reset_launch_counts()
        out = fa.flash_attention(*leaves)
        out.backward(do.to(device))
        torch.cuda.synchronize()
        runs.append(([out.cpu(), *(x.grad.cpu() for x in leaves)],
                     [f.launches for f in fa.KERNELS]))
    (got, launches), (want, _) = runs
    rel = {n: rel_err(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
    log(f"head_dim 100 through flash_attention (padded to 104; b 2, s 512, 4 heads, bf16): "
        f"launches {launches}, against the CPU's plain versions "
        + ", ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    tol = TOL[torch.bfloat16]
    if launches != [1, 1, 1] or rel["o"] > tol or max(rel.values()) > 2 * tol:
        raise AssertionError(f"padded head: launches {launches}, rel err {rel}")


def device_kernels(fn, unique=True):
    """Names of the device kernels one call of ``fn`` runs (one profiler
    window), so that a yardstick's implementation is on record; with
    ``unique`` False, one name a launch, in order."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(set(names)) if unique else names


def kernels_a_call(label, fns, single, calls=3):
    """Logs the device kernels a call of each codec wrapper of ``fns`` (name
    -> call) runs; fails unless each one named in ``single`` runs exactly one
    a call."""
    from bagua_tpu_torch.ops import _build

    for name, fn in fns.items():
        fn()   # built and warm
        kernels = _build.kernels_of_calls(fn, calls)
        log(f"{label}: {name} runs {len(kernels) / calls:g} device kernel(s) a call: "
            f"{sorted(set(kernels))}")
        if name in single and len(kernels) != calls:
            raise AssertionError(f"{name} must be one launch a call, ran {kernels} in "
                                 f"{calls} calls")


def bound(name, bh, s, d, dtype, causal):
    """Least time on the card: the larger of the matmul flops over the
    tensor-core peak and the bytes each input read once and each output
    written once over the memory rate."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    matmuls = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}[name]
    flops = 2 * d * pairs * matmuls
    item = torch.finfo(dtype).bits // 8
    mat, row = bh * s * d * item, bh * s * 4
    nbytes = {"flash_fwd": 4 * mat + row,          # q k v -> o, lse
              "flash_bwd_dkv": 6 * mat + 2 * row,  # q k v do lse delta -> dk dv
              "flash_bwd_dq": 5 * mat + 2 * row}[name]
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS   # f16's = bf16's
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_ring_shape():
    """The kernels as ring attention runs them off the diagonal: non-causal,
    with a random nonzero logsumexp cotangent, at the ring's per-rank shape
    (slice 1's batch 2 and 16 heads of 64 over half its sequence: b·h 32, s
    2048), against their plain versions; each kernel's time beside its bound
    and SDPA's with ``is_causal=False`` (its forward; its whole backward
    against dK/dV and dQ).  Returns the absolute errors."""
    from bagua_tpu_torch.ops import flash_attention as fa

    b, h, d, s = MAIN["b"], MAIN["h"], MAIN["d"], MAIN["s"] // MP_WORLD
    bh = b * h
    (q, k, v, do, lse, delta), errs = check_kernels(bh, s, d, torch.bfloat16, False, seed=30,
                                                   dlse=True)
    ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, False)),
          "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, False)),
          "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, False))}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))
    out = sdpa(qg, kg, vg, is_causal=False)
    sdpa_fwd = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=False))
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True))
    log(f"ring shape bh={bh} s={s} d={d} bf16 non-causal with dlse: "
        + ", ".join(f"{n} {t:.4f} ms (bound {bound(n, bh, s, d, torch.bfloat16, False)[0]:.4f}, "
                    f"{bound(n, bh, s, d, torch.bfloat16, False)[1]})" for n, t in ms.items())
        + f"; sdpa is_causal=False forward {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms "
        f"(flash dK/dV + dQ {ms['flash_bwd_dkv'] + ms['flash_bwd_dq']:.4f})")
    return errs


def check_tp_shape():
    """The kernels at the tensor- and pipeline-parallel ranks' shape, b·h
    16 (a tp rank's 8 heads of slice 1's 2 rows; a pp microbatch's one row
    of 16 heads), s 4096, d 64, bf16, causal, against their plain versions;
    each kernel's time hot and cold beside its plain version's and its
    bound, and SDPA's forward and whole backward.  Returns the absolute
    errors."""
    from bagua_tpu_torch.ops import flash_attention as fa

    b, h, d, s = MAIN["b"], MAIN["h"] // 2, MAIN["d"], MAIN["s"]
    bh = b * h
    (q, k, v, do, lse, delta), errs = check_kernels(bh, s, d, torch.bfloat16, True, seed=50)
    fns = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
           "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
           "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)}
    ms = {n: cuda_ms(fn) for n, fn in fns.items()}
    cold = {n: cuda_ms_cold(fn) for n, fn in fns.items()}
    plain = {"flash_fwd": cuda_ms(lambda: fa.fwd_plain(q, k, v, True), 3),
             "flash_bwd_dkv": cuda_ms(lambda: fa.dkv_plain(q, k, v, do, lse, delta, True), 3),
             "flash_bwd_dq": cuda_ms(lambda: fa.dq_plain(q, k, v, do, lse, delta, True), 3)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))
    out = sdpa(qg, kg, vg, is_causal=True)
    sdpa_fwd = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True))
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True))
    log(f"tp/pp rank shape bh={bh} s={s} d={d} bf16 causal: "
        + ", ".join(f"{n} {t:.4f} ms (cold {cold[n]:.4f}; plain {plain[n]:.4f}; bound "
                    f"{bound(n, bh, s, d, torch.bfloat16, True)[0]:.4f}, "
                    f"{bound(n, bh, s, d, torch.bfloat16, True)[1]})" for n, t in ms.items())
        + f"; sdpa forward {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms "
        f"(flash dK/dV + dQ {ms['flash_bwd_dkv'] + ms['flash_bwd_dq']:.4f})")
    return errs


def time_wide_head(bh, s, d):
    """The wide kernels' times at a head above 256 (bf16, causal), each
    beside its bound, and SDPA's forward and forward + backward on the same
    inputs (its kernels named: which backend takes such a head)."""
    from bagua_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(bh, s, d, torch.bfloat16, seed=d)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(dim=-1)
    fns = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
           "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
           "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)}
    ms = {n: cuda_ms(fn, 3) for n, fn in fns.items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.view(1, bh, s, d) for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do4)

    sdpa_ms = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True), 3)
    sdpa_train_ms = cuda_ms(sdpa_fwd_bwd, 3)
    log(f"wide head bh={bh} s={s} d={d} bf16 causal: "
        + ", ".join(f"{n} {t:.4f} ms (bound {bound(n, bh, s, d, torch.bfloat16, True)[0]:.4f})"
                    for n, t in ms.items())
        + f"; sdpa forward {sdpa_ms:.4f} ms, sdpa fwd+bwd {sdpa_train_ms:.4f} ms (flash "
        f"{sum(ms.values()):.4f}); sdpa kernels "
        f"{device_kernels(lambda: sdpa(q4, k4, v4, is_causal=True))}")


def phase_kernels():
    from bagua_tpu_torch.ops import flash_attention as fa

    b, s, h, d = MAIN["b"], MAIN["s"], MAIN["h"], MAIN["d"]
    bh = b * h
    check_kernels(bh, 1000, d, torch.bfloat16, True, seed=1)
    check_kernels(4, 512, d, torch.float32, True, seed=2)
    check_kernels(4, 512, 128, torch.float32, False, seed=3)
    check_kernels(4, 1000, 128, torch.bfloat16, True, seed=4)
    # heads the kernels widen: 32 to 64, 96 to 128, 136 to 256
    check_kernels(4, 1000, 32, torch.bfloat16, True, seed=10)
    check_kernels(4, 512, 32, torch.float32, True, seed=11)
    check_kernels(4, 384, 96, torch.bfloat16, False, seed=12)
    check_kernels(4, 384, 136, torch.bfloat16, False, seed=17)
    # f16, and heads of 256 (Gemma's), in every dtype
    check_kernels(4, 1000, 64, torch.float16, True, seed=14)
    check_kernels(4, 1000, 256, torch.float16, True, seed=15)
    check_kernels(4, 1000, 256, torch.bfloat16, True, seed=16)
    check_kernels(2, 256, 256, torch.float32, True, seed=18)
    # heads above 256 (the wide kernels), in every dtype, ragged and not
    check_kernels(4, 1000, 384, torch.bfloat16, True, seed=22)
    check_kernels(4, 1000, 512, torch.bfloat16, True, seed=23)
    check_kernels(3, 333, 384, torch.float16, False, seed=24)
    check_kernels(2, 256, 512, torch.float32, True, seed=25)
    check_padded_head()
    # slice 2's shape: b·h = 64 (batch 8 × 8 heads of 64) at its seq
    moe_inputs, errs_moe = check_kernels(MOE["b"] * MOE["h"], MOE["s"],
                                         MOE["d_model"] // MOE["h"], torch.bfloat16, True,
                                         seed=6)
    # slice 3's shape: BERT-Large, b·h = 128 (batch 8 × 16 heads of 64) at seq 384
    bert_inputs, errs_bert = check_kernels(BERT["b"] * BERT["h"], BERT["s"], BERT["d"],
                                           torch.bfloat16, True, seed=7)
    (q, k, v, do, lse, delta), errs = check_kernels(bh, s, d, torch.bfloat16, True)
    errs = {n: max(e, errs_moe[n], errs_bert[n]) for n, e in errs.items()}
    check_backward_edges()
    ring_errs, tp_errs = check_ring_shape(), check_tp_shape()
    errs = {n: max(e, ring_errs[n], tp_errs[n]) for n, e in errs.items()}

    ms = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, True)),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
    }
    cold_ms = {
        "flash_fwd": cuda_ms_cold(lambda: fa.flash_fwd(q, k, v, True)),
        "flash_bwd_dkv": cuda_ms_cold(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
        "flash_bwd_dq": cuda_ms_cold(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
    }
    # a head of 32 runs the kernels of width 64: its times beside d 64's
    qn, kn, vn, don = _inputs(bh, s, 32, torch.bfloat16, seed=13)
    on, lsen = fa.flash_fwd(qn, kn, vn, True)
    deltan = (don.float() * on.float()).sum(dim=-1)
    narrow = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(qn, kn, vn, True)),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(qn, kn, vn, don, lsen, deltan, True)),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(qn, kn, vn, don, lsen, deltan, True)),
    }
    log(f"narrow head bh={bh} s={s} d=32 bf16 causal (widened to 64): "
        + ", ".join(f"{n} {narrow[n]:.4f} ms (d 64 {ms[n]:.4f})" for n in ms))
    del qn, kn, vn, don, on, lsen, deltan
    # heads of 256 (the D = 256 layouts) and f16 at d 64: their times, at the
    # same tokens and the same b·h times head_dim as slice 1
    for dtype, bh_, d_ in ((torch.bfloat16, bh // 4, 256), (torch.float16, bh, d)):
        qw, kw, vw, dow = _inputs(bh_, s, d_, dtype, seed=20)
        ow, lsew = fa.flash_fwd(qw, kw, vw, True)
        deltaw = (dow.float() * ow.float()).sum(dim=-1)
        wide = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd(qw, kw, vw, True)),
            "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(qw, kw, vw, dow, lsew, deltaw, True)),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(qw, kw, vw, dow, lsew, deltaw, True)),
        }
        log(f"head bh={bh_} s={s} d={d_} {dtype} causal: "
            + ", ".join(f"{n} {t:.4f} ms (bound {bound(n, bh_, s, d_, dtype, True)[0]:.4f})"
                        for n, t in wide.items()))
        del qw, kw, vw, dow, ow, lsew, deltaw
    for d_ in (384, 512):
        time_wide_head(WIDE["bh"], s, d_)
    plain_ms = {
        "flash_fwd": cuda_ms(lambda: fa.fwd_plain(q, k, v, True), 3),
        "flash_bwd_dkv": cuda_ms(lambda: fa.dkv_plain(q, k, v, do, lse, delta, True), 3),
        "flash_bwd_dq": cuda_ms(lambda: fa.dq_plain(q, k, v, do, lse, delta, True), 3),
    }
    # the library yardstick, timed here only: PyTorch's fused attention on
    # the same [b, h, s, d] inputs (the port never calls it).  Its backward
    # computes dK, dV and dQ in one call, and its own row statistic (delta)
    # inside, so that one time stands against dK/dV and dQ together, on both
    # rows, and against the port's whole backward: delta, dK/dV and dQ as
    # autograd runs _FlashLse.backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))
    sdpa_out = sdpa(qg, kg, vg, is_causal=True)   # one forward, built once
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True))
    sdpa_kernels = device_kernels(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True))
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))
    port_out, _ = fa._FlashLse.apply(qf, kf, vf, True)
    port_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        port_out, (qf, kf, vf), do, retain_graph=True))
    log(f"whole backward bh={bh} s={s} d={d} bf16 causal: port (delta + dK/dV + dQ) "
        f"{port_bwd_ms:.4f} ms, sdpa {sdpa_bwd_ms:.4f} ms, port / sdpa "
        f"{port_bwd_ms / sdpa_bwd_ms:.3f}; sdpa backward kernels: {sdpa_kernels}")
    library = {"flash_fwd": cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True)),
               "flash_bwd_dkv": sdpa_bwd_ms, "flash_bwd_dq": sdpa_bwd_ms}
    log(f"sdpa forward kernels: "
        f"{device_kernels(lambda: sdpa(q4, k4, v4, is_causal=True))}")
    # the forward at slice 2's and BERT-Large's shapes, beside SDPA's forward
    for label, (q_, k_, v_, *_) in (("slice 2", moe_inputs), ("BERT-Large", bert_inputs)):
        bh_, s_, d_ = q_.shape
        q4_, k4_, v4_ = (x.view(1, bh_, s_, d_) for x in (q_, k_, v_))
        fwd_ms = cuda_ms(lambda: fa.flash_fwd(q_, k_, v_, True))
        sdpa_ms = cuda_ms(lambda: sdpa(q4_, k4_, v4_, is_causal=True))
        log(f"forward {label} bh={bh_} s={s_} d={d_} bf16 causal: flash_fwd {fwd_ms:.4f} ms, "
            f"cold {cuda_ms_cold(lambda: fa.flash_fwd(q_, k_, v_, True)):.4f} ms, sdpa "
            f"forward {sdpa_ms:.4f} ms, flash / sdpa {fwd_ms / sdpa_ms:.3f}, bound "
            f"{bound('flash_fwd', bh_, s_, d_, torch.bfloat16, True)[0]:.4f} ms")

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do4)

    sdpa_train_ms = cuda_ms(sdpa_fwd_bwd)
    flash_train_ms = ms["flash_fwd"] + ms["flash_bwd_dkv"] + ms["flash_bwd_dq"]
    log(f"timing bh={bh} s={s} d={d} bf16 causal: kernels {ms}, cold {cold_ms}, "
        f"plain {plain_ms}, "
        f"sdpa fwd {library['flash_fwd']:.4f} ms, sdpa bwd alone {sdpa_bwd_ms:.4f} ms "
        f"(flash dkv+dq {ms['flash_bwd_dkv'] + ms['flash_bwd_dq']:.4f} ms), sdpa "
        f"fwd+bwd {sdpa_train_ms:.4f} ms, flash fwd+dkv+dq {flash_train_ms:.4f} ms")
    rows = {}
    for name in ms:
        b_ms, b_by = bound(name, bh, s, d, torch.bfloat16, True)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE,
                      "replaces": REPLACES[name], "launches": None,
                      "max_abs_err": errs[name], "ms": ms[name],
                      "plain_ms": plain_ms[name], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library[name]}
    return rows


def slice_config(name, **widths):
    """Slice ``name``'s ``TransformerConfig``: ``"longctx"`` the long-context
    LM of ``bench_longctx``, ``"moe"`` the dropless MoE LM of
    ``bench_moe_longseq``; ``widths`` replace its fields (the cuts, the
    rematerialization and model-parallel knobs)."""
    from bagua_tpu_torch.models.transformer import TransformerConfig

    if name == "moe":
        base = dict(vocab_size=32768, d_model=MOE["d_model"], n_heads=MOE["h"], n_layers=4,
                    d_ff=MOE["d_ff"], max_seq_len=MOE["s"])
    else:
        base = dict(vocab_size=32768, d_model=MAIN["h"] * MAIN["d"], n_heads=MAIN["h"],
                    n_layers=4, d_ff=4096, max_seq_len=MAIN["s"])
    return TransformerConfig(**{**base, **widths})


def slice_model(name, attn_fn=None, gmm_fn=None, ep_size=1, use_ragged=False, **widths):
    """The model of slice ``name`` (:func:`slice_config`), weights from seed
    0: for ``"moe"`` a ``MoEMLP`` in every odd layer.  ``attn_fn`` and
    ``gmm_fn`` replace the attention and the grouped matmul (for example with
    their plain versions); ``ep_size`` and ``use_ragged`` are the MoE layers'
    expert parallelism and exchange form (over the global mesh's ``ep``
    axis); ``widths`` replace the configuration's fields (the cuts,
    ``remat``, ``remat_policy``, ``sp_axis``, ``tp_axis``/``tp_size``)."""
    from bagua_tpu_torch.model_parallel.moe import MoEMLP
    from bagua_tpu_torch.models.transformer import TransformerLM

    cfg = slice_config(name, **widths)
    factory = None
    if name == "moe":
        moe = lambda: MoEMLP(MOE["experts"], cfg.d_ff, d_model=cfg.d_model, k=MOE["k"],
                             dropless=True, gmm_fn=gmm_fn, ep_size=ep_size,
                             use_ragged=use_ragged, dtype=cfg.dtype)
        factory = lambda i: moe if i % 2 == 1 else None
    return TransformerLM(cfg, seed=0, attn_fn=attn_fn, mlp_factory=factory)


def build_slice(name, remat=False, remat_policy=None):
    """Slice ``name``'s model (with the given rematerialization), its
    ``BaguaTrainer`` (GradientAllReduce; AdamW for ``"longctx"``, Adam and the
    load-balancing loss for ``"moe"``), the initial state and one fixed random
    batch (seed 1).  Needs the process group."""
    import bagua_tpu_torch as bt

    model = slice_model(name, remat=remat, remat_policy=remat_policy)
    if name == "moe":
        loss_fn, batch_size = bt.moe_lm_loss_fn(aux_loss_weight=0.01), MOE["b"]
        opt = functools.partial(torch.optim.Adam, lr=1e-4)
    else:
        loss_fn, batch_size = bt.lm_loss_fn, MAIN["b"]
        opt = functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
    trainer = bt.BaguaTrainer(loss_fn, opt, bt.GradientAllReduceAlgorithm(hierarchical=False))
    state = trainer.init(model)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab_size, (batch_size, model.cfg.max_seq_len + 1),
                           device="cuda", generator=g)
    return model, trainer, state, trainer.shard_batch({"tokens": tokens})


def train_steps(trainer, state, batch, tokens_per_step, modules, after_step=None, steps=STEPS):
    """``steps`` training steps with every launch count of ``modules`` set to
    0 just before and read just after; returns the losses, the launches by
    kernel, the step statistics and the last state.  ``after_step(state)``
    runs after each step, outside the steps' times, and launches none of
    ``modules``' kernels."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in modules:
        mod.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())   # synchronizes
        times.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step(state)
    launches = {k.__name__: k.launches for mod in modules for k in mod.KERNELS}
    # step 1 pays the allocator's and the libraries' warm-up; the rest is
    # one window, so a slow step in it counts in full
    window_s = sum(times[1:])
    stats = {
        "step_ms": window_s / (steps - 1) * 1e3,
        "tokens_s": (steps - 1) * tokens_per_step / window_s,
        "median_ms": statistics.median(times[1:]) * 1e3,
        "first_ms": times[0] * 1e3,
        "times_ms": [t * 1e3 for t in times],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        # the peak of the bytes the run asked the allocator for, without
        # the caching allocator's rounding of the blocks it handed out
        "requested_peak_bytes": torch.cuda.memory_stats().get("requested_bytes.all.peak"),
        "layout": "resident" if trainer._flat_resident else "leaf",
    }
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses, launches, stats, state


def log_steps(name, losses, launches, st):
    log(f"{name} losses: {losses}")
    log(f"{name}: step {st['step_ms']:.3f} ms (steps 2-{len(losses)} as one window; median "
        f"step {st['median_ms']:.3f} ms; first {st['first_ms']:.3f} ms), "
        f"{st['tokens_s']:.1f} tokens/s, peak memory {st['peak_gb']:.3f} GB ({st['layout']} "
        f"layout), launches {launches}")


def check_reductions():
    """Every ``ReduceOp`` through the global communicator on the card: NCCL at
    world 1, where each reduction of one rank is its operand, bit for bit
    (AVG divides by 1).  SUM, AVG, MIN, MAX and PRODUCT on f32 run NCCL's own
    reductions; BOR, BAND and BXOR on int32 its gather, then the local fold
    (NCCL has no bitwise reductions).  Nothing stages through the host."""
    import bagua_tpu_torch as bt

    comm = bt.get_backend().global_communicator
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(1 << 20, device="cuda", generator=g)
    i = torch.randint(0, 2 ** 30, (1 << 20,), device="cuda", dtype=torch.int32, generator=g)
    bitwise = (bt.ReduceOp.BOR, bt.ReduceOp.BAND, bt.ReduceOp.BXOR)
    staged0 = comm.host_staged_bytes
    results = {}
    for op in bt.ReduceOp:
        src = i if op in bitwise else x
        results[op.name] = torch.equal(comm.allreduce(src.clone(), op), src)
    staged = comm.host_staged_bytes - staged0
    log(f"reductions on {torch.distributed.get_backend()} at world "
        f"{comm.nranks()} (f32, int32 for the bitwise ops, 2^20 elements): {results}, "
        f"staged {staged} bytes")
    if not all(results.values()) or staged:
        raise AssertionError(f"reductions on the card: {results}, staged {staged}")


def phase_slice():
    """The port's first path: BaguaTrainer over the long-context LM."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa

    bt.init_process_group()
    check_reductions()
    eager_checks(0, 1, torch.device("cuda"), "slice 1")
    model, trainer, state, batch = build_slice("longctx")
    cfg, tokens = model.cfg, batch["tokens"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice: {n_params} params in {len(trainer.plan.buckets)} buckets, "
        f"world {trainer.world_size} over {torch.distributed.get_backend()}")

    # the observability plane rides the run (on by default): each step's
    # span names are read after it, outside the step times
    from bagua_tpu_torch.obs import ledger as obs_ledger
    from bagua_tpu_torch.obs import spans as obs_spans

    obs_spans.recorder.clear()
    obs_ledger.ledger.reset()
    step_spans = []

    def after_step(state):
        step_spans.append(collections.Counter(
            sp["name"] for sp in obs_spans.recorder.snapshot()
            if sp.get("step") == trainer._step_counter))

    losses, launches, st, state = train_steps(trainer, state, batch,
                                              MAIN["b"] * cfg.max_seq_len, [fa], after_step)
    log_steps("slice", losses, launches, st)
    want = cfg.n_layers * STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, expected {want} each")
    check_slice_obs(trainer, cfg, step_spans)
    efficiency_record(trainer, state, {"slice": "longctx", "family": "gradient_allreduce",
                                       "accum_steps": 1, "steps": STEPS,
                                       "flat_resident": trainer.flat_resident,
                                       "layout": "resident" if trainer._flat_resident
                                       else "leaf"})
    # what the remat phase holds its run against: the losses, the peak, the
    # parameters after the steps and (last) the kernels' device time of one more
    base = {"losses": losses, "stats": st, "params": _params_on_host(model)}

    # the model's logits on a short input against the plain attention path
    plain = slice_model("longctx", attn_fn=lambda q, k, v, dtype:
                        fa.reference_attention(q, k, v, dtype))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        short = tokens[:1, :512]
        got, want_logits = model(short), plain(short)
    err = rel_err(got, want_logits)
    log(f"slice logits vs plain attention (seq 512): rel err {err:.3g}")
    if not (torch.isfinite(got).all() and got.shape == (1, 512, cfg.vocab_size)
            and err <= 5e-2):
        raise AssertionError(f"logits disagree with the plain path: {err}")
    base["kernel_ms"] = kernel_step_ms(trainer, state, batch)
    state, windows = watchdog_cost(trainer, state, batch)
    on, off = statistics.mean(windows["on"]), statistics.mean(windows["off"])
    spread = max(abs(w[0] - w[1]) / statistics.mean(w) for w in (windows["on"], windows["off"]))
    host = windows["host"]
    host_ms = (host["sections"] * host["section_us"] + host["fence_us"]) / 1e3
    log(f"slice: the hang watchdog's cost, A B B A ({WATCHDOG_COST_STEPS} steps a window, "
        f"each ending in loss.item()): on {windows['on'][0]:.3f}, off {windows['off'][0]:.3f}, "
        f"off {windows['off'][1]:.3f}, on {windows['on'][1]:.3f} ms a step; on {on:.3f} against "
        f"off {off:.3f} ms ({(on / off - 1) * 100:+.2f}%); two windows of one setting differ "
        f"by up to {spread * 100:.2f}%; on the host path {host['sections']} watched sections "
        f"a step at {host['section_us']:.2f} us and one fence at {host['fence_us']:.2f} us: "
        f"{host_ms:.4f} ms a step, {host_ms / off * 100:.3f}% of it")
    base["watchdog_ms"] = windows
    return launches, base


# ---------------------------------------------------------------------------
# obs: the observability plane on slice 1's runs
# ---------------------------------------------------------------------------

#: steps of the obs on/off pair (the StepProfiler window 2:5 closes at step
#: 6) and of each window of its A B B A host-cost measure
OBS_STEPS, OBS_COST_STEPS = 6, 20
OBS_PROFILE_STEPS = (2, 5)


def lm_step_flops(cfg, batch: int, seq: int) -> float:
    """Slice 1's model flops of one training step, counted from the
    configuration alone: every dense layer (q, k, v, o, the gated MLP's
    three, the head) ``2 * tokens * fan_in * fan_out`` a forward, causal
    attention ``4 * b * h * head_dim`` a (query, key) pair it sees
    (``s (s + 1) / 2`` a head), and a step three forwards (the weight and
    the input gradients)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    dense = 2 * batch * seq * (L * (4 * d * d + 3 * d * f) + d * v)
    attention = 4 * batch * cfg.n_heads * cfg.head_dim * (seq * (seq + 1) // 2) * L
    return 3.0 * (dense + attention)


def check_slice_obs(trainer, cfg, step_spans):
    """Slice 1's run with the obs plane on: the span names of every step
    (the first the build, every later one a dispatch with one bucket
    collective a bucket), the ledger's ``compile`` for the first step and
    ``productive_step`` after it, ``obs/mfu`` against the analytic count,
    and the live memory poll's peak against ``max_memory_allocated``."""
    from bagua_tpu_torch.obs import export as obs_export
    from bagua_tpu_torch.obs import ledger as obs_ledger
    from bagua_tpu_torch.obs.memory import live_memory_stats

    n = len(trainer.plan.buckets)
    first, later = step_spans[0], step_spans[1:]
    bad = [i for i, c in enumerate(later, 2)
           if c["step/build"] or c["step/dispatch"] != 1 or c["trace/comm_stage"] != 1
           or c["trace/optimizer_apply"] != 1 or c["trace/bucket_collective"] != n]
    if first["step/build"] != 1 or first["step/dispatch"] != 1 or bad:
        raise AssertionError(f"obs: span names per step {step_spans} ({n} buckets; steps {bad})")
    rep = obs_ledger.ledger.report()
    if not (rep["classes"]["compile"] > 0 and rep["classes"]["productive_step"] > 0
            and rep["step_windows"] == STEPS - 1
            and sum(rep["classes"].values()) <= rep["wall_s"] * 1.01 + 1e-6):
        raise AssertionError(f"obs: the ledger after slice 1: {rep}")
    analytic = lm_step_flops(cfg, MAIN["b"], cfg.max_seq_len)
    mfu = obs_export.last_mfu()
    want_mfu = (analytic / mfu["step_dt"] / mfu["peak_flops"]) if mfu.get("available") else None
    live = live_memory_stats()
    peak = torch.cuda.max_memory_allocated()
    polled = obs_export.last_hbm_live()
    log(f"obs, slice 1: spans a step {dict(later[-1])} ({sum(later[-1].values())} spans: the "
        f"{obs_spans_capacity()}-span ring holds {obs_spans_capacity() // sum(later[-1].values())}"
        f" steps); step 1 {dict(first)}; ledger {rep['classes']} of wall {rep['wall_s']:.3f} s "
        f"(goodput {rep['goodput_fraction']}); obs/mfu {mfu} against the analytic "
        f"{analytic:.6g} flops a step ({want_mfu}); live memory {live}, polled {polled}")
    if not (mfu.get("available") and mfu["flops_per_step"] == analytic
            and abs(mfu["mfu"] - want_mfu) <= 1e-4):
        raise AssertionError(f"obs/mfu {mfu}, analytic flops {analytic}")
    if not (live.get("available") and live["peak_bytes_in_use"] == peak
            and polled and polled.get("available")):
        raise AssertionError(f"live memory {live} against max_memory_allocated {peak}; "
                             f"polled {polled}")


def obs_spans_capacity() -> int:
    from bagua_tpu_torch import env

    return env.get_obs_ring_size()


def phase_obs(card):
    """Slice 1's LM twice from the same weights and batch, one trainer built
    with ``BAGUA_OBS`` on (and a ``StepProfiler`` window of steps 2:5 under
    ``BAGUA_PROFILE_DIR``), one with it off, ``OBS_STEPS`` steps each:
    parameters bitwise equal; the profile's op profile names K6a-c with
    ``n_layers`` launches a traced step each; the device attribution of the
    window.  Then the two trainers alternate, A B B A, ``OBS_COST_STEPS``
    steps a window (each step ending in ``loss.item()``), for the plane's
    host cost a step, beside its spans a step times one span's cost."""
    from bagua_tpu_torch import profiling
    from bagua_tpu_torch.obs import export as obs_export
    from bagua_tpu_torch.obs import spans as obs_spans
    from bagua_tpu_torch.ops import flash_attention as fa

    tmp = tempfile.mkdtemp()
    runs = {}
    try:
        for label in ("on", "off"):
            obs_spans.set_enabled(label == "on")
            if label == "on":
                os.environ["BAGUA_PROFILE_DIR"] = tmp
                os.environ["BAGUA_PROFILE_STEPS"] = "%d:%d" % OBS_PROFILE_STEPS
            try:
                model, trainer, state, batch = build_slice("longctx")
            finally:
                os.environ.pop("BAGUA_PROFILE_DIR", None)
                os.environ.pop("BAGUA_PROFILE_STEPS", None)
            fa.reset_launch_counts()
            for i in range(OBS_STEPS):
                state, loss = trainer.train_step(state, batch)
                if label == "on" and i + 1 == HTTP_STEPS:
                    # the plane-off reference of the HTTP check below
                    after_http_steps = [p.detach().clone() for p in model.parameters()]
            loss.item()
            runs[label] = [model, trainer, state, batch]
        obs_spans.set_enabled(True)
        on, off = runs["on"], runs["off"]
        bitwise = all(torch.equal(a, b) for a, b in zip(on[0].parameters(), off[0].parameters()))
        path = on[1]._profiler.path
        prof = profiling.parse_trace_op_profile(path)
        traced = profiling.load_trace(path)["bagua"]["steps"]
        counts = {}
        for rec in prof["ops"].values():
            counts[rec["class"]] = counts.get(rec["class"], 0) + rec["count"]
        flash = {k: counts.get(k, 0) for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        want = on[0].cfg.n_layers * traced
        attribution = None
        for _ in range(600):   # the attribution thread publishes when done
            attribution = obs_export.last_device_attribution()
            if attribution is not None:
                break
            time.sleep(0.1)
        per_bucket = (attribution or {}).get("per_bucket") or []
        log(f"obs: parameters after {OBS_STEPS} steps with BAGUA_OBS on and off "
            f"{'bitwise equal' if bitwise else 'DIFFER'}; the StepProfiler window "
            f"({traced} steps, {os.path.getsize(path) / 1e6:.1f} MB of Chrome trace) names "
            f"{flash} (want {want} each) among {len(prof['ops'])} kernels, device "
            f"{prof['total_time_s'] / traced * 1e3:.3f} ms a step by class "
            f"{ {k: round(v / traced * 1e3, 3) for k, v in sorted(prof['classes'].items())} }; "
            f"device attribution: available {(attribution or {}).get('available')}, "
            f"transport {(attribution or {}).get('transport')}, comm "
            f"{(attribution or {}).get('comm_s_per_step')} s a step over {len(per_bucket)} "
            f"buckets (first {per_bucket[:2]}), rationale "
            f"{(attribution or {}).get('rationale')}")
        if not bitwise or any(n != want for n in flash.values()) or traced != 3 \
                or attribution is None:
            raise AssertionError(f"obs on/off bitwise {bitwise}, flash in the profile {flash} "
                                 f"(want {want}), traced {traced}, attribution {attribution}")
        windows = {"on": [], "off": []}
        for label in ("on", "off", "off", "on"):
            model, trainer, state, batch = runs[label]
            obs_spans.set_enabled(label == "on")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OBS_COST_STEPS):
                state, loss = trainer.train_step(state, batch)
                loss.item()
            windows[label].append((time.perf_counter() - t0) / OBS_COST_STEPS * 1e3)
            runs[label][2] = state
        obs_spans.set_enabled(True)
        obs_spans.recorder.clear()
        state, loss = on[1].train_step(runs["on"][2], on[3])
        loss.item()
        spans_a_step = len(obs_spans.recorder.snapshot())
        t0 = time.perf_counter()
        for _ in range(10000):
            with obs_spans.trace_span("cost", bucket=1):
                pass
        span_us = (time.perf_counter() - t0) / 10000 * 1e6
        a, b = statistics.mean(windows["on"]), statistics.mean(windows["off"])
        log(f"obs ({card}): the step with BAGUA_OBS on against off, A B B A "
            f"({OBS_COST_STEPS} steps a window): on {windows['on'][0]:.3f}, off "
            f"{windows['off'][0]:.3f}, off {windows['off'][1]:.3f}, on {windows['on'][1]:.3f} ms "
            f"a step; on {a:.3f} against off {b:.3f} ms ({(a / b - 1) * 100:+.2f}%); on the host "
            f"path {spans_a_step} spans a step at {span_us:.2f} us: "
            f"{spans_a_step * span_us / 1e3:.4f} ms a step")
        runs.clear()
        release()
        http_check(card, after_http_steps)
    finally:
        obs_spans.set_enabled(None)
        shutil.rmtree(tmp, ignore_errors=True)
        runs.clear()
        release()


HTTP_STEPS = 5


def _prom_series(text):
    return {line.split(" ", 1)[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def http_check(card, reference):
    """The HTTP status plane on the card: slice 1's trainer built with
    ``BAGUA_OBS_HTTP_PORT`` set (the trainer starts the process's plane) runs
    ``HTTP_STEPS`` steps while a thread scrapes ``/metrics``, ``/healthz``
    and ``/ledger``.  ``/metrics`` must parse with a HELP and a TYPE line for
    every series, equal an exporter's ``metrics.prom`` of the same snapshot
    series for series, and the parameters must be bitwise ``reference``
    (the plane-off run after as many steps)."""
    import threading
    import urllib.request

    from bagua_tpu_torch.obs import export as obs_export
    from bagua_tpu_torch.obs import http as obs_http

    def get(path):
        t0 = time.perf_counter()
        with urllib.request.urlopen(srv.url + path, timeout=30) as rsp:
            body = rsp.read().decode()
        return body, (time.perf_counter() - t0) * 1e3

    os.environ["BAGUA_OBS_HTTP_PORT"] = str(_free_port())
    tmp = tempfile.mkdtemp()
    stop, scrapes, errors = threading.Event(), {"/metrics": [], "/healthz": [], "/ledger": []}, []
    try:
        model, trainer, state, batch = build_slice("longctx")
        srv = obs_http._GLOBAL_SERVER
        if srv is None or srv.port != int(os.environ["BAGUA_OBS_HTTP_PORT"]):
            raise AssertionError(f"the trainer started no HTTP plane on the port: {srv}")

        def scraper():
            while not stop.is_set():
                try:
                    for path in scrapes:
                        body, ms = get(path)
                        scrapes[path].append(ms)
                        if path != "/metrics":
                            json.loads(body)
                except Exception as e:  # noqa: BLE001 - collected for the gate
                    errors.append(repr(e))
                    return

        thread = threading.Thread(target=scraper, daemon=True)
        thread.start()
        for _ in range(HTTP_STEPS):
            state, loss = trainer.train_step(state, batch)
        loss.item()
        stop.set()
        thread.join(timeout=30)
        bitwise = all(torch.equal(a, b) for a, b in zip(model.parameters(), reference))
        text, _ = get("/metrics")
        helped = {m.group(2) for m in re.finditer(r"^# (HELP) (\S+)", text, re.M)}
        typed = {m.group(2) for m in re.finditer(r"^# (TYPE) (\S+)", text, re.M)}
        series = _prom_series(text)
        unlabelled = {s.split("{", 1)[0] for s in series}
        exporter = obs_export.MetricsExporter(tmp, interval_s=3600)
        exporter.export_once()
        exporter.export_once()
        scraped, _ = get("/metrics")
        with open(os.path.join(tmp, "metrics.prom")) as f:
            on_disk = f.read()
        health = json.loads(get("/healthz")[0])
        n = {k: len(v) for k, v in scrapes.items()}
        log(f"obs HTTP plane ({card}): {n} scrapes during {HTTP_STEPS} steps of slice 1, "
            f"errors {errors}; a scrape's ms: " + ", ".join(
                f"{k} median {statistics.median(v):.3f} max {max(v):.3f}"
                for k, v in scrapes.items() if v)
            + f"; /metrics {len(series)} series, all with HELP and TYPE "
            f"{unlabelled <= helped and unlabelled <= typed}, equal to metrics.prom "
            f"{_prom_series(scraped) == _prom_series(on_disk)}; /healthz step "
            f"{health.get('step')}; parameters bitwise the plane-off run's: {bitwise}")
        if errors or not all(n.values()) or not (unlabelled <= helped and unlabelled <= typed) \
                or "untyped" in text or _prom_series(scraped) != _prom_series(on_disk) \
                or not bitwise or health.get("step") != trainer._step_counter:
            raise AssertionError(f"HTTP plane: errors {errors}, scrapes {n}, series without "
                                 f"HELP {unlabelled - helped}, without TYPE "
                                 f"{unlabelled - typed}, bitwise {bitwise}, healthz {health}")
    finally:
        stop.set()
        os.environ.pop("BAGUA_OBS_HTTP_PORT", None)
        if obs_http._GLOBAL_SERVER is not None:
            obs_http._GLOBAL_SERVER.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# generate: KV-cache decoding of slice 1's LM, dense and paged
# ---------------------------------------------------------------------------


def phase_generate(card):
    """KV-cache decoding of slice 1's LM at full width (world 1, weights of
    seed 0): the first ``GEN_PROMPT`` tokens of slice 1's batch (2 rows),
    then ``GEN_NEW`` greedy tokens, through ``generate`` (the dense cache)
    and through the page pool of its paged twin (``GEN_PAGE`` positions a
    page, the same modules and parameters).  Gates: the paged tokens and
    logits bitwise equal to the dense ones; every step's logits within ``GEN_LOGITS_RTOL`` of the training forward's (K6a) on the
    prompt and the generated tokens; each greedy token equal to that
    forward's argmax wherever its top-2 margin exceeds the gate (relative to
    the largest logit); no flash launch in the decode loops, one a layer in
    the forward.  Prints tokens/s and ms a step beside the card.  Leaves
    the prompt, tokens and logits at ``GEN_REF_ENV`` for ``tp_generate``."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.models.transformer import RESERVED_PAGES
    from bagua_tpu_torch.ops import flash_attention as fa

    model = slice_model("longctx")
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MAIN["b"], cfg.max_seq_len + 1),
                           device="cuda", generator=g)
    prompt = tokens[:, :GEN_PROMPT]
    steps = GEN_PROMPT + GEN_NEW - 1
    b = prompt.shape[0]
    need = -(-steps // GEN_PAGE)
    paged = bt.decode_model(model, page_size=GEN_PAGE, num_pages=RESERVED_PAGES + b * need)
    out = {}
    for label, twin in (("dense", model), ("paged", paged)):
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks, logits = bt.generate(twin, prompt, GEN_NEW, return_logits=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in fa.KERNELS}
        out[label] = {"tokens": toks, "logits": logits, "seconds": seconds,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"generate {label} ({card}): {steps} decode steps ({GEN_PROMPT} prompt tokens fed "
            f"one a step, then {GEN_NEW} greedy) of {b} rows in {seconds:.3f} s: "
            f"{seconds / steps * 1e3:.3f} ms a step, {b * steps / seconds:.1f} tokens/s "
            f"({b * GEN_NEW / seconds:.1f} generated tokens/s), peak "
            f"{out[label]['peak_gb']:.3f} GB; flash launches {launches}")
        if any(launches.values()):
            raise AssertionError(f"generate {label}: the decode loop launched {launches}")
    dense, pg = out["dense"], out["paged"]
    bitwise = torch.equal(dense["tokens"], pg["tokens"]) and torch.equal(dense["logits"],
                                                                          pg["logits"])
    fa.reset_launch_counts()
    with torch.no_grad():
        seq = torch.cat([prompt, dense["tokens"]], dim=1)[:, :-1]
        forward = model(seq)
    launches = {k.__name__: k.launches for k in fa.KERNELS}
    err = rel_err(dense["logits"], forward)
    gate = GEN_LOGITS_RTOL * forward.abs().max().item()
    tail = forward[:, GEN_PROMPT - 1:]
    top2 = tail.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > gate
    agree = (tail.argmax(-1) == dense["tokens"])
    log(f"generate: paged decode {'bitwise equal to' if bitwise else 'DIFFERS from'} dense "
        f"(tokens and logits); decode logits within {err:.3g} of the training forward's "
        f"(gate {GEN_LOGITS_RTOL}; forward launches {launches}); the greedy token equals the "
        f"forward's argmax at {int((agree & sure).sum())} of the {int(sure.sum())} positions "
        f"whose top-2 margin exceeds {gate:.3g} ({int(agree.sum())} of {agree.numel()} in all)")
    want = {k.__name__: 0 for k in fa.KERNELS}
    want["flash_fwd"] = cfg.n_layers
    if not (bitwise and err <= GEN_LOGITS_RTOL and bool(agree[sure].all())
            and launches == want and bool(torch.isfinite(dense["logits"]).all())):
        raise AssertionError(f"generate: paged bitwise {bitwise}, logits error {err}, "
                             f"disagreements {int((~agree & sure).sum())}, launches {launches}")
    # the two-rank spawn, started before this phase, waits for the file
    path = os.environ[GEN_REF_ENV]
    torch.save({"prompt": prompt.cpu(), "tokens": dense["tokens"].cpu(),
                "logits": dense["logits"].cpu()}, path + ".part")
    os.replace(path + ".part", path)
    del model, paged, out, dense, pg, forward
    release()


# ---------------------------------------------------------------------------
# serve: the continuous-batching engine over slice 1's LM
# ---------------------------------------------------------------------------

#: the serve phase (``longctx-serve-1chip``): slice 1's LM at full width
#: behind ``ServeEngine`` with ``slots`` batch slots, ``page``-token pages and
#: ``chunk``-token prefill chunks; a Poisson-paced trace of ``requests``
#: requests (mean gap ``gap_s``; prompt and output lengths uniform in the
#: ranges; token ids, lengths and gaps from ``seed``); a pool of ``pages``
#: pages beside the reserved ones, fewer than the slots' full demand, so that
#: the engine must preempt; ``compare`` requests held against ``generate()``
SERVE = dict(requests=16, prompt=(128, 1024), new=(32, 256), slots=8, page=64, chunk=256,
             gap_s=0.05, pages=80, seed=0, compare=4)


def serve_trace(vocab, n=None, gap_s=None, seed=None):
    """``(arrival_s, prompt, max_new)`` of the serve phase's trace."""
    n = SERVE["requests"] if n is None else n
    rng = np.random.RandomState(SERVE["seed"] if seed is None else seed)
    gaps = rng.exponential(SERVE["gap_s"] if gap_s is None else gap_s, size=n)
    out, t = [], 0.0
    for i in range(n):
        t += float(gaps[i])
        plen = int(rng.randint(SERVE["prompt"][0], SERVE["prompt"][1] + 1))
        new = int(rng.randint(SERVE["new"][0], SERVE["new"][1] + 1))
        out.append((t, rng.randint(0, vocab, size=plen).astype(np.int32), new))
    return out


def _percentiles(xs):
    xs = sorted(xs)
    return {f"p{q}": xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]
            for q in (50, 90, 99)}


def check_against_generate(model, req, gate=None):
    """One served request against ``generate()`` on its prompt: the tokens
    equal up to the first position where they part, the logits of every
    compared position within ``gate`` of generate's (relative to its
    largest logit), and a parted token accepted only where generate's top-2
    margin there is within twice the two logit sets' gap (a near tie the two
    differently shaped products round apart; the chains differ after it).
    Returns ``(positions equal, parted at, logits error)``."""
    import bagua_tpu_torch as bt

    gate = GEN_LOGITS_RTOL if gate is None else gate
    p = len(req.prompt)
    toks, logits = bt.generate(model, req.prompt[None], req.max_new_tokens, return_logits=True)
    ref_toks, ref = toks[0].tolist(), logits[0, p - 1:]
    got = torch.stack(req.logits)
    parted = next((i for i, (a, b) in enumerate(zip(req.output, ref_toks)) if a != b), None)
    upto = len(ref_toks) if parted is None else parted + 1
    gap = (got[:upto] - ref[:upto]).abs().max().item()
    err = gap / ref[:upto].abs().max().item()
    if err > gate:
        raise AssertionError(f"serve request {req.rid}: logits {err} from generate's")
    if parted is not None:
        row = ref[parted]
        margin = (row[ref_toks[parted]] - row[req.output[parted]]).item()
        if margin > 2 * gap:
            raise AssertionError(f"serve request {req.rid}: token {parted} parts from "
                                 f"generate's with a margin {margin} over the gap {gap}")
    return upto if parted is None else parted, parted, err


#: trials of the serve phase's continuous-against-static pair (the serving
#: bench's smoke trials): interleaved, each trial both modes on the backlog
SERVE_AB_TRIALS = 3


def serve_throughput(model, conf, backlog, continuous):
    """One engine mode's output tokens a second over ``backlog`` submitted
    at once (the serving bench's offered-backlog measurement)."""
    from bagua_tpu_torch.serve import ServeEngine

    eng = ServeEngine(model, None, conf, continuous=continuous)
    cuda = next(model.parameters()).is_cuda
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng.run(backlog)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in got)
    return {"metric": ("serve_continuous_tokens_per_sec" if continuous
                       else "serve_static_tokens_per_sec"),
            "value": round(tokens / dt, 3), "unit": "tokens/s", "timing": "single_window",
            "tokens": int(tokens), "wall_s": round(dt, 6), "n_requests": len(backlog),
            "batching": "continuous" if continuous else "static", "ticks": eng._ticks}


def _seconds_percentiles(values):
    vals = np.asarray(sorted(values), float)
    return {p: round(float(np.percentile(vals, q)), 6)
            for p, q in (("p50", 50), ("p90", 90), ("p99", 99))}


def serve_bench_records(done, ab, ledger_report, conf, cfg, device, trace_meta, smoke=True):
    """A ``bagua-bench-serve-v1`` record list from a serve run's measurements:
    ``done`` the latency trace's completed requests, ``ab`` the
    ``(static, continuous, ratios)`` of :func:`~bagua_tpu_torch.obs.ab.
    interleaved_ab` over :func:`serve_throughput`, ``ledger_report`` the
    goodput ledger's report over the run (the loader's ``weight_load``
    included)."""
    from bagua_tpu_torch.obs.ab import speedup_record
    from bagua_tpu_torch.serve import SERVE_BENCH_SCHEMA, SERVE_SPEEDUP_GATE
    from bagua_tpu_torch.telemetry import counters

    best_static, best_cont, ratios = ab
    latency = {"metric": "serve_latency",
               "ttft_s": _seconds_percentiles([r.ttft_s for r in done if r.ttft_s is not None]),
               "tpot_s": _seconds_percentiles([r.tpot_s for r in done if r.tpot_s is not None]),
               "n_requests": len(done), "trace": "poisson",
               "mean_interarrival_s": trace_meta["mean_interarrival_s"]}
    speedup = speedup_record(
        "serve_continuous_over_static_throughput", ratios, "continuous/static tokens/s",
        gate=SERVE_SPEEDUP_GATE, n_requests=best_cont["n_requests"], max_slots=conf.max_slots,
        provenance=(f"{device.type} single-device measurement: both modes run the same tick "
                    "on the same backlog; only the admission policy differs (static holds "
                    "slots until the whole batch drains).  Gate: >= "
                    f"{SERVE_SPEEDUP_GATE}x median ratio, or noise_bound flagged per the "
                    "interleaved A/B protocol (obs/ab.py)."))
    ledger = {"metric": "serve_ledger_classes",
              "classes": {c: round(v, 6) for c, v in (ledger_report.get("classes") or {}).items()
                          if v > 0},
              "goodput_fraction": ledger_report.get("goodput_fraction"),
              "wall_s": ledger_report.get("wall_s"),
              "note": ("prefill/decode are serving goodput; batch_formation_idle and "
                       "weight_load are serving badput with a name")}
    header = {"metric": "serve_bench_schema", "schema": SERVE_BENCH_SCHEMA,
              "time_unix": time.time(), "platform": device.type,
              "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                              else "cpu"),
              "n_devices": 1, "smoke": bool(smoke),
              "config": {"max_slots": conf.max_slots, "page_size": conf.page_size,
                         "num_pages": conf.num_pages, "prefill_chunk": conf.prefill_chunk,
                         "queue_depth": conf.queue_depth,
                         "model": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                                   "n_heads": cfg.n_heads, "max_seq_len": cfg.max_seq_len,
                                   "vocab_size": cfg.vocab_size}},
              "trace": dict(trace_meta),
              "counters": {k: v for k, v in counters.snapshot().items()
                           if k.startswith("serve/")}}
    return [header, latency, best_cont, best_static, speedup, ledger]


#: ticks of the serve phase's profiled window, after as many warm-up ticks
SERVE_PROFILE_TICKS = 30


def serve_tick_breakdown(model, trace, card):
    """Where a tick's time goes: ``SERVE["slots"]`` requests of the trace as
    one backlog, ``SERVE_PROFILE_TICKS`` warm-up ticks, then as many under
    ``profiling.trace``: the host's ms a tick against the device's busy ms
    (the union of its kernels' intervals) and its kernel ms by class."""
    from bagua_tpu_torch import profiling
    from bagua_tpu_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(model, None, ServeConfig(
        max_slots=SERVE["slots"], page_size=SERVE["page"],
        num_pages=2 + SERVE["slots"] * (model.cfg.max_seq_len // SERVE["page"]),
        queue_depth=256, prefill_chunk=SERVE["chunk"], tick_idle_s=0.001))
    for _, prompt, new in trace[:SERVE["slots"]]:
        eng.submit(prompt, new)
    for _ in range(SERVE_PROFILE_TICKS):
        eng.step()
    tmp = tempfile.mkdtemp()
    try:
        torch.cuda.synchronize()
        with profiling.trace(tmp, steps=SERVE_PROFILE_TICKS) as holder:
            t0 = time.perf_counter()
            for _ in range(SERVE_PROFILE_TICKS):
                eng.step()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / SERVE_PROFILE_TICKS * 1e3
        tr = profiling.load_trace(holder["path"])
        ops = profiling.parse_trace_op_profile(tr) or {"classes": {}, "total_time_s": 0.0}
        spans = sorted((e["t0_s"], e["t0_s"] + e["dur_s"]) for e in profiling.device_events(tr))
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        n = SERVE_PROFILE_TICKS
        log(f"serve ticks ({card}): {n} ticks of {SERVE['slots']} slots profiled (CPU and CUDA "
            f"activities): {host_ms:.3f} ms a tick on the host clock; device busy "
            f"{busy / n * 1e3:.3f} ms a tick, kernels {ops['total_time_s'] / n * 1e3:.3f} ms "
            f"by class { {k: round(v / n * 1e3, 3) for k, v in sorted(ops['classes'].items())} }; "
            f"{len(spans) // n} device events a tick")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del eng
        release()


def phase_serve(card):
    """``longctx-serve-1chip``: slice 1's LM at full width (weights of seed 0)
    published with ``save_serving_artifact`` and loaded back with
    ``load_serving_params`` (bitwise), then served by ``ServeEngine`` over the
    paged pool on a Poisson-paced trace (``SERVE``).  Gates: every request
    completes; at least one joins a running batch and one is preempted and
    recomputed; no page in use at the end; ``SERVE["compare"]`` requests (the
    preempted one among them) against ``generate()``
    (:func:`check_against_generate`); the ledger's ``weight_load``,
    ``prefill``, ``decode`` and ``batch_formation_idle`` fed and their sum
    not above the wall; no flash launch in the ticks.  Prints TTFT and TPOT
    percentiles, tokens/s and the peak, where a tick's time goes
    (:func:`serve_tick_breakdown`), and (no gate on the ratio) continuous
    against static batching on one backlog of the same requests,
    ``SERVE_AB_TRIALS`` interleaved trials; the run's ``bagua-bench-serve-v1``
    record must validate (:func:`serve_bench_records`)."""
    from bagua_tpu_torch.obs import ledger as obs_ledger
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.serve import (ServeConfig, ServeEngine, load_serving_params,
                                       save_serving_artifact)

    model = slice_model("longctx")
    cfg = model.cfg
    tmp = tempfile.mkdtemp()
    try:
        obs_ledger.ledger.reset()
        t0 = time.perf_counter()
        save_serving_artifact(tmp, model, step=1)
        step, params = load_serving_params(tmp, model)
        load_s = time.perf_counter() - t0
        if step != 1 or any(not torch.equal(params[n], p) for n, p in model.named_parameters()):
            raise AssertionError("serve: the artifact did not round-trip bitwise")
        del params
        conf = ServeConfig(max_slots=SERVE["slots"], page_size=SERVE["page"],
                           num_pages=2 + SERVE["pages"], queue_depth=256,
                           prefill_chunk=SERVE["chunk"], tick_idle_s=0.001)
        engine = ServeEngine(model, None, conf, record_logits=True)
        joined = []
        admit = engine._admit

        def watched_admit():
            running = {r.rid for r in engine._slot_req if r is not None}
            admit()
            if running:
                joined.extend(r.rid for r in engine._slot_req
                              if r is not None and r.rid not in running)

        engine._admit = watched_admit
        trace = serve_trace(cfg.vocab_size)
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = engine.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        flash = {k.__name__: k.launches for k in fa.KERNELS}
        rep = obs_ledger.ledger.report()
        done = sorted(done, key=lambda r: r.rid)
        out_tokens = sum(len(r.output) for r in done)
        preempted = [r for r in done if r.preemptions]
        ttft = _percentiles([r.ttft_s * 1e3 for r in done])
        tpot = _percentiles([r.tpot_s * 1e3 for r in done if r.tpot_s is not None])
        log(f"serve longctx-serve-1chip ({card}): {len(done)} of {len(trace)} requests in "
            f"{wall:.3f} s (the trace's last arrival at {trace[-1][0]:.3f} s), "
            f"{engine._ticks} ticks, {out_tokens} output tokens: {out_tokens / wall:.1f} "
            f"tokens/s; TTFT ms {ttft}, TPOT ms {tpot}; peak {peak:.3f} GB; joined mid-batch "
            f"{sorted(set(joined))}; preempted {[(r.rid, r.preemptions) for r in preempted]}; "
            f"pages in use at the end {engine.pool.pages_in_use}; flash launches {flash}; "
            f"ledger {rep['classes']} of wall {rep['wall_s']:.3f} s; the artifact's save and "
            f"load {load_s:.3f} s")
        classes = rep["classes"]
        if not (len(done) == len(trace) and all(len(r.output) == n for r, (_, _, n)
                                                 in zip(done, trace))
                and joined and preempted and engine.pool.pages_in_use == 0
                and not any(flash.values())
                and all(classes[c] > 0 for c in ("weight_load", "prefill", "decode",
                                                 "batch_formation_idle"))
                and sum(classes.values()) <= rep["wall_s"] * 1.01 + 1e-6):
            raise AssertionError("serve: the engine's gates failed (see the line above)")
        # the preempted request and the shortest others against generate()
        chosen = [preempted[0]] + sorted(
            (r for r in done if r is not preempted[0]),
            key=lambda r: len(r.prompt) + r.max_new_tokens)[:SERVE["compare"] - 1]
        for r in chosen:
            equal, parted, err = check_against_generate(model, r)
            log(f"serve request {r.rid} (prompt {len(r.prompt)}, {r.max_new_tokens} new, "
                f"preempted {r.preemptions}x) against generate(): {equal} tokens equal"
                f"{'' if parted is None else f', parted at {parted} (a near tie)'}, logits "
                f"within {err:.3g} (gate {GEN_LOGITS_RTOL})")
        for r in done:
            r.logits = None   # the record keeps their times only
        del engine, chosen, preempted
        release()
        serve_tick_breakdown(model, trace, card)
        # continuous against static batching on one backlog, interleaved
        # (no gate on the ratio: the record is the serving bench's smoke)
        from bagua_tpu_torch.obs.ab import interleaved_ab
        from bagua_tpu_torch.serve import validate_serve_bench

        backlog = [(0.0, p, n) for _, p, n in trace]
        ab_conf = ServeConfig(max_slots=SERVE["slots"], page_size=SERVE["page"],
                              num_pages=2 + SERVE["slots"] * (cfg.max_seq_len // SERVE["page"]),
                              queue_depth=256, prefill_chunk=SERVE["chunk"], tick_idle_s=0.001)

        def measure(continuous):
            rec = serve_throughput(model, ab_conf, backlog, continuous)
            log(f"serve backlog of {len(backlog)} requests, {rec['batching']} batching "
                f"({card}): {rec['wall_s']:.3f} s, {rec['value']:.1f} output tokens/s, "
                f"{rec['ticks']} ticks")
            release()
            return rec

        t_ab = time.perf_counter()
        ab = interleaved_ab(lambda: measure(False), lambda: measure(True),
                            trials=SERVE_AB_TRIALS)
        GROUP_SECONDS["records"]["serve"] = time.perf_counter() - t_ab
        log(f"serve: continuous over static batching on the backlog, per trial: {ab[2]}")
        records = serve_bench_records(
            done, ab, obs_ledger.ledger.report(), conf, cfg, torch.device("cuda"),
            {"seed": SERVE["seed"], "prompt_range": list(SERVE["prompt"]),
             "output_range": list(SERVE["new"]), "mean_interarrival_s": SERVE["gap_s"],
             "n_latency_requests": len(done), "n_throughput_requests": len(backlog)})
        problems = validate_serve_bench(records)
        path = write_record("torch_serve_bench.json", records)
        log(f"records: serve record ({SERVE_AB_TRIALS} interleaved trials, smoke) -> {path}; "
            f"problems {problems}")
        if problems:
            raise AssertionError(f"records: the serve record is invalid: {problems}")
        del done
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del model
        release()


# ---------------------------------------------------------------------------
# vision: ResNet50 and VGG16 through the trainer at world 1, and their
# breakdown of a step
# ---------------------------------------------------------------------------

#: ``bench_family``'s ResNet50 (``bench.py:222-246``: 128 images of 224 px
#: f32, SGD 0.1 with momentum 0.9) and ``bench_vgg16``'s VGG16
#: (``bench.py:479-500``: 256 images in bf16, SGD with momentum 0.9).  VGG16
#: steps at 0.01, not the bench's 0.1: without a norm, 0.1 sends the loss on
#: N(0, 1) images to NaN within 6 steps (VGG16 at 64 px on the CPU; the JAX
#: bench feeds zero images, which never move it), and the step time does not
#: depend on the rate
VISION = dict(size=224, classes=1000, resnet_batch=128, vgg_batch=256, lr=0.1, vgg_lr=0.01)
#: steps of the fused-against-unfused pair, each from the same weights
FUSED_STEPS = 3
#: a step's device kernels by class: the launching op's name (or an
#: enclosing range's) decides, in this order; batch norm is every kernel of
#: a norm module's forward and of the backward nodes its forward made
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution", "aten::_convolution",
            "aten::convolution_backward", "aten::conv2d")
NORM_RANGE = "vision::batch_norm"


def vision_batch(n, dtype=torch.float32, size=None, classes=None, device="cuda"):
    """``n`` images N(0, 1) (NCHW in channels-last memory) and labels
    uniform in ``[0, classes)``, both from seed 1 (not zeros: zero images
    make every batch norm degenerate)."""
    size, classes = size or VISION["size"], classes or VISION["classes"]
    g = torch.Generator(device=device).manual_seed(1)
    images = torch.randn((n, size, size, 3), device=device, generator=g).to(dtype)
    labels = torch.randint(0, classes, (n,), device=device, generator=g)
    return {"images": images.permute(0, 3, 1, 2), "labels": labels}


def model_flops(model, forward, first: str):
    """The convolutions' and dense layers' flops of one forward (a hook on
    each ``Conv``/``Dense`` reads its output's shape during ``forward()``)
    and of a training step: the forward, the weight gradients (as many) and
    the input gradients of every layer but ``first``, whose input needs
    none; and ``forward()``'s output."""
    from bagua_tpu_torch.models.resnet import Conv, Dense

    per = {}

    def hook(name, m, inp, out):
        fan_in = m.weight[0].numel()
        per[name] = 2 * out.numel() * fan_in

    handles = [m.register_forward_hook(functools.partial(hook, n))
               for n, m in model.named_modules() if isinstance(m, (Conv, Dense))]
    try:
        out = forward()
    finally:
        for h in handles:
            h.remove()
    fwd = sum(per.values())
    return {"forward": fwd, "step": 3 * fwd - per[first]}, out


def step_breakdown(trainer, state, batch, norm_type, device_kernels=True):
    """One training step under ``torch.profiler`` (host ops and device
    kernels), its device milliseconds by class: ``convolution`` (kernels of
    the convolution ops and their backward), ``batch norm`` (kernels of
    every ``norm_type`` module's forward, a profiler range a module, and of
    the backward nodes made there, matched by autograd sequence number; at
    world > 1 their allreduce), ``optimizer`` (inside ``Optimizer.step``),
    ``collectives`` (NCCL kernels: the bucket allreduce), ``elementwise and
    other``.  With ``device_kernels`` False (the CPU) each leaf op's own
    host time stands in for its kernels'.  The step's state is dropped."""
    model = state.model
    ranges = []

    def enter(m, args):
        r = torch.autograd.profiler.record_function(NORM_RANGE)
        r.__enter__()
        ranges.append(r)

    def leave(m, args, out):
        ranges.pop().__exit__(None, None, None)

    hooks = [h for m in model.modules() if isinstance(m, norm_type)
             for h in (m.register_forward_pre_hook(enter), m.register_forward_hook(leave))]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_kernels:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            _, loss = trainer.train_step(state, batch)
            loss.item()
            if device_kernels:
                torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    norm_seq = {e.sequence_nr for e in events
                if e.sequence_nr >= 0 and any(a.name == NORM_RANGE for a in ancestors(e))}
    out = {k: 0.0 for k in ("convolution", "batch norm", "optimizer", "collectives",
                            "elementwise and other")}
    for e in events:
        if device_kernels:
            kernels = [(k.name, k.duration / 1e3) for k in e.kernels]
        else:
            kernels = [(e.name, e.self_cpu_time_total / 1e3)] if not e.cpu_children else []
        if not kernels:
            continue
        chain = list(ancestors(e))
        for name, ms in kernels:
            if "nccl" in name.lower():
                cls = "collectives"
            elif any(a.name.startswith("Optimizer.step") for a in chain):
                cls = "optimizer"
            elif any(a.name == NORM_RANGE or (a.name.startswith("autograd::engine::evaluate_function")
                                                and a.sequence_nr in norm_seq) for a in chain):
                cls = "batch norm"
            elif any(a.name in CONV_OPS for a in chain):
                cls = "convolution"
            else:
                cls = "elementwise and other"
            out[cls] += ms
    return out


def busy_share(trainer, state, batch) -> dict:
    """One step's device kernels alone under ``torch.profiler``: their
    milliseconds and the union of their intervals over the span from the
    first kernel's start to the last one's end (the idle share is the
    rest).  The step's state is dropped."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, loss = trainer.train_step(state, batch)
        loss.item()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_start, cur_end = 0.0, None, None
    for s, t in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, t
        else:
            cur_end = max(cur_end, t)
    if cur_end is not None:
        busy += cur_end - cur_start
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return {"kernels_ms": sum(t - s for s, t in spans) / 1e3, "busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "idle_share": 1.0 - busy / span if span else None}


def _renamed(state_dict, old, new):
    return {re.sub(rf"(^|\.){old}_", rf"\g<1>{new}_", k): v for k, v in state_dict.items()}


def vision_run(name, model, loss_fn, opt, algo, batch, card, flops):
    """``STEPS`` steps of ``model`` by ``BaguaTrainer``: the losses finite
    and falling, no Pallas-port kernel launched; prints step ms, img/s, the
    peak and the step's model-flops share of the bf16 dense peak."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    trainer = bt.BaguaTrainer(loss_fn, opt, algo)
    state = trainer.init(model)
    batch = trainer.shard_batch(batch)
    n = batch["labels"].shape[0]
    losses, launches, st, state = train_steps(trainer, state, batch, n, [cd, fa, gm])
    share = flops["step"] / (st["step_ms"] / 1e3) / PEAK_BF16_FLOPS
    log(f"vision {name} ({card}): losses {losses}; step {st['step_ms']:.3f} ms (steps "
        f"2-{STEPS} as one window; median {st['median_ms']:.3f} ms; first "
        f"{st['first_ms']:.3f} ms), {st['tokens_s']:.1f} img/s, peak memory "
        f"{st['peak_gb']:.3f} GB ({st['layout']} layout); model flops a step "
        f"{flops['step']:.6g} (forward {flops['forward']:.6g}) = {share:.2%} of the bf16 "
        f"dense peak {PEAK_BF16_FLOPS:.4g} flop/s; launches of the ported kernels {launches}")
    if any(launches.values()):
        raise AssertionError(f"vision {name}: the path launched ported kernels {launches}")
    st["flops_share"] = share
    return trainer, state, batch, losses, st


def phase_vision(card):
    """(a) ``resnet50-1chip`` and (b) ``vgg16-1chip`` at world 1 over NCCL;
    see the module docstring."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.contrib import SyncBatchNorm, fuse_optimizer
    from bagua_tpu_torch.models.resnet import BatchNorm, ResNet50, classification_loss_fn
    from bagua_tpu_torch.models.vgg import VGG16, vgg_loss_fn

    bt.set_global_mesh(bt.build_mesh({"dp": 1}))
    # cuDNN's autotune for VGG alone: its convolutions are its step, where
    # ResNet50's norms take 87% of its device time and the autotune 13 s of
    # its first step
    cudnn = torch.backends.cudnn
    sgd = functools.partial(torch.optim.SGD, lr=VISION["lr"], momentum=0.9)
    sync = functools.partial(SyncBatchNorm, axis_name="dp")
    out = {}
    try:
        # (a) ResNet50, SyncBN over the world (world 1: the local arithmetic)
        batch = vision_batch(VISION["resnet_batch"])
        model = ResNet50(num_classes=VISION["classes"], norm_cls=sync, seed=0)
        twin = ResNet50(num_classes=VISION["classes"], seed=0)
        twin.load_state_dict(_renamed(model.state_dict(), "SyncBatchNorm", "BatchNorm"))
        with torch.no_grad():
            flops, logits = model_flops(
                model, lambda: model(batch["images"], update_stats=False), "stem_conv")
            twin_logits = twin(batch["images"], update_stats=False)
            twin_loss = classification_loss_fn(twin, batch).item()
        logits_err = rel_err(logits, twin_logits)
        del twin, twin_logits, logits
        fused = fuse_optimizer(sgd)
        trainer, state, batch, losses, st = vision_run(
            "resnet50-1chip", model, classification_loss_fn, fused,
            bt.GradientAllReduceAlgorithm(), batch, card, flops)
        unwrapped = trainer.opt_factory is fused.fused_inner
        loss_err = abs(losses[0] - twin_loss) / abs(twin_loss)
        log(f"vision resnet50-1chip: first loss {losses[0]!r} against {twin_loss!r} of the twin "
            f"with the local norm (rel err {loss_err:.3g}), logits rel err {logits_err:.3g} "
            f"(tolerance {TOL[torch.bfloat16]}); the {st['layout']} layout "
            f"{'unwrapped fused_inner' if unwrapped else 'ran the fused wrapper'}")
        if not (loss_err <= TOL[torch.bfloat16] and logits_err <= TOL[torch.bfloat16]
                and unwrapped == trainer._flat_resident):
            raise AssertionError(f"vision resnet50-1chip: twin loss {loss_err}, logits "
                                 f"{logits_err}, unwrapped {unwrapped}")
        busy = busy_share(trainer, state, batch)
        classes = step_breakdown(trainer, state, batch, SyncBatchNorm)
        log(f"vision resnet50-1chip ({card}): one profiled step's device ms by class "
            f"{json.dumps({k: round(v, 3) for k, v in classes.items()})} (host ops recorded); "
            f"kernels alone: {busy['kernels_ms']:.3f} ms of kernels, busy {busy['busy_ms']:.3f} "
            f"ms of a {busy['span_ms']:.3f} ms span, idle share {busy['idle_share']:.2%}")
        out["resnet50"] = dict(st, losses=losses, breakdown=classes, busy=busy,
                               flops=flops["step"])
        del model, trainer, state
        release()

        # fused against unfused: the same weights, FUSED_STEPS steps each,
        # cuDNN deterministic for this pair alone; the fused wrapper runs on
        # the leaf layout, the plain optimizer on the default one
        cudnn.deterministic, cudnn.benchmark = True, False
        finals = {}
        for label, opt, layout in (("fused (leaf layout)", fused, "off"),
                                   ("plain", sgd, None)):
            m = ResNet50(num_classes=VISION["classes"], norm_cls=sync, seed=0)
            tr = bt.BaguaTrainer(classification_loss_fn, opt, bt.GradientAllReduceAlgorithm(),
                                 flat_resident=layout)
            s = tr.init(m)
            b = tr.shard_batch(batch)
            for _ in range(FUSED_STEPS):
                s, loss = tr.train_step(s, b)
            loss.item()
            finals[label] = (type(s.optimizer).__name__, "resident" if tr._flat_resident
                             else "leaf", _params_on_host(m))
            del m, tr, s, b
            release()
        (fo, fl, fp), (po, pl, pp) = finals.values()
        bitwise = fp.keys() == pp.keys() and all(torch.equal(fp[k], pp[k]) for k in fp)
        log(f"vision resnet50-1chip: {FUSED_STEPS} steps of fuse_optimizer(SGD) ({fo} on the "
            f"{fl} layout) and of plain SGD ({po} on the {pl} layout) from the same weights, "
            f"cuDNN deterministic: parameters {'bitwise equal' if bitwise else 'DIFFER'}")
        if not bitwise or fo != "FusedOptimizer":
            raise AssertionError("vision resnet50-1chip: fused and unfused parameters differ")
        del finals, fp, pp
        cudnn.deterministic, cudnn.benchmark = False, True

        # (b) VGG16, bf16 images
        batch = vision_batch(VISION["vgg_batch"], torch.bfloat16)
        model = VGG16(num_classes=VISION["classes"], image_size=VISION["size"], seed=0)
        with torch.no_grad():
            flops, _ = model_flops(model, lambda: model(batch["images"]), "conv0")
        trainer, state, batch, losses, st = vision_run(
            "vgg16-1chip", model, vgg_loss_fn,
            functools.partial(torch.optim.SGD, lr=VISION["vgg_lr"], momentum=0.9),
            bt.GradientAllReduceAlgorithm(hierarchical=False), batch, card, flops)
        out["vgg16"] = dict(st, losses=losses, flops=flops["step"])
        del model, trainer, state, batch
    finally:
        cudnn.deterministic, cudnn.benchmark = False, False
        bt.set_global_mesh(None)
    release()
    return out


# ---------------------------------------------------------------------------
# slice 2: dropless MoE, the grouped-matmul kernels
# ---------------------------------------------------------------------------


def _gmm_inputs(rows, d, f, groups, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    rhs = (torch.randn(groups, d, f, device="cuda", generator=g) / math.sqrt(d)).to(dtype)
    gout = torch.randn(rows, f, device="cuda", generator=g).to(dtype)
    return lhs, rhs, gout


def check_gmm(lhs, rhs, gout, sizes, label):
    """Both gmm kernels (K7a also in its transposed-rhs d_lhs form) against
    their plain versions on one input; returns the absolute errors."""
    from bagua_tpu_torch.ops import gmm as gm

    n = rhs.shape[0]
    sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    got = {"grouped_matmul": gm.grouped_matmul(lhs, rhs, sizes),
           "grouped_matmul_dlhs": gm.grouped_matmul(gout, rhs, sizes, transpose_rhs=True),
           "grouped_matmul_drhs": gm.grouped_matmul_drhs(lhs, gout, sizes, n)}
    want = {"grouped_matmul": gm.grouped_matmul_plain(lhs, rhs, sizes),
            "grouped_matmul_dlhs": gm.grouped_matmul_plain(gout, rhs, sizes, True),
            "grouped_matmul_drhs": gm.grouped_matmul_drhs_plain(lhs, gout, sizes, n)}
    torch.cuda.synchronize()
    rel = {k: rel_err(got[k], want[k]) for k in got}
    log(f"gmm {label}: " + ", ".join(f"{k} {e:.3g}" for k, e in rel.items()))
    tol = {k: GMM_DRHS_TOL if k == "grouped_matmul_drhs" else GMM_TOL[lhs.dtype] for k in rel}
    bad = {k: e for k, e in rel.items() if not e <= tol[k]}
    if bad:
        raise AssertionError(f"gmm kernel disagrees with its plain version: {bad} "
                             f"(tolerance {tol})")
    errs = {k: abs_err(got[k], want[k]) for k in got}
    return {"grouped_matmul": max(errs["grouped_matmul"], errs["grouped_matmul_dlhs"]),
            "grouped_matmul_drhs": errs["grouped_matmul_drhs"]}


def gmm_bound(name, rows, m, n, groups):
    """Least time on the card of one gmm launch over ``rows`` grouped rows:
    2 rows m n flops over the bf16 tensor-core peak against the bytes (each
    input read once, each output written once) over the memory rate."""
    flops = 2 * rows * m * n
    if name == "grouped_matmul":   # lhs [rows, m], rhs [G, m, n] -> [rows, n] bf16
        nbytes = 2 * (rows * m + groups * m * n + rows * n)
    else:                          # lhs [rows, m], gout [rows, n] -> [G, m, n] f32
        nbytes = 2 * (rows * m + rows * n) + 4 * groups * m * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_moe_no_sync():
    """One MoE layer's forward and backward at the path's shapes with host
    syncs turned into errors."""
    from bagua_tpu_torch.model_parallel.moe import MoEMLP

    layer = MoEMLP(MOE["experts"], MOE["d_ff"], d_model=MOE["d_model"], k=MOE["k"],
                   dropless=True).cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (MOE["b"], MOE["s"], MOE["d_model"])
    x = torch.randn(shape, device="cuda", generator=g).bfloat16().requires_grad_()
    gy = torch.randn(shape, device="cuda", generator=g).bfloat16()
    layer(x).backward(gy)            # warm-up: library loads, allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        layer(x).backward(gy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("gmm: one MoE layer's forward and backward ran under "
        "set_sync_debug_mode('error') with no host sync")


def check_gmm_padded(d, f, dtype, seed):
    """A product whose d and f are not multiples of 8 through ``gmm``, which
    pads its operands (one K7a launch forward, one K7a and one K7b backward),
    against the plain versions on the unpadded operands: output and
    gradients within the product's tolerance."""
    from bagua_tpu_torch.ops import gmm as gm

    lhs, rhs, gout = _gmm_inputs(300, d, f, 3, seed=seed, dtype=dtype)
    sizes = torch.tensor([120, 0, 150], dtype=torch.int32, device="cuda")
    runs = []
    for fn in (gm.gmm, gm.grouped_matmul_plain):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        gm.reset_launch_counts()
        out = fn(a, b, sizes)
        out.backward(gout)
        torch.cuda.synchronize()
        runs.append(([out, a.grad, b.grad], [k.launches for k in gm.KERNELS]))
    (got, launches), (want, _) = runs
    rel = {n: rel_err(x, y) for n, x, y in zip(("out", "d_lhs", "d_rhs"), got, want)}
    tol = GMM_TOL[dtype]
    log(f"gmm ({d}, {f}) {dtype} through gmm (padded to multiples of 8): launches "
        f"{launches}, " + ", ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    if launches != [2, 1] or max(rel.values()) > tol or got[0].shape != (300, f):
        raise AssertionError(f"padded gmm ({d}, {f}): launches {launches}, rel err {rel}")


def phase_gmm_kernels():
    from bagua_tpu_torch.ops import gmm as gm

    rows, G = MOE["b"] * MOE["s"] * MOE["k"], MOE["experts"]
    d, f = MOE["d_model"], MOE["d_ff"]
    balanced = [rows // G] * G
    skewed = [rows // 2] + [rows // (2 * (G - 1))] * (G - 2)
    skewed.append(rows - sum(skewed))             # one group holds half the rows
    empty = [0, rows // 2, 0, rows // 4, rows // 4, 0, 0, 0]
    check_gmm(*_gmm_inputs(300, 128, 256, 4, seed=9), [1, 0, 170, 100], "ragged 300 rows")
    check_gmm(*_gmm_inputs(300, 64, 200, 4, seed=10), [1, 0, 170, 100],
              "ragged 300 rows (64, 200)")
    check_gmm(*_gmm_inputs(300, 200, 64, 4, seed=11, dtype=torch.float32), [1, 0, 170, 100],
              "ragged 300 rows (200, 64) f32")
    check_gmm_padded(100, 200, torch.bfloat16, seed=12)
    check_gmm_padded(200, 100, torch.float16, seed=13)
    errs = {}
    for m, n in ((d, f), (f, d)):
        inputs = _gmm_inputs(rows, m, n, G, seed=m)
        for label, sizes in (("skewed", skewed), ("empty groups", empty),
                             ("balanced", balanced)):
            e = check_gmm(*inputs, sizes, f"rows {rows} ({m}, {n}) {label}")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
    check_gmm(*_gmm_inputs(rows, d, f, G, seed=14, dtype=torch.float16), skewed,
              f"rows {rows} ({d}, {f}) skewed f16")
    # K7b sums a group of more than one chunk in chunk order: two launches on
    # the same inputs are bitwise equal
    lhs, _, gout = _gmm_inputs(rows, d, f, G, seed=15)
    same_bits = {}
    for label, sizes in (("balanced", balanced), ("skewed", skewed)):
        sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        first = gm.grouped_matmul_drhs(lhs, gout, sz, G)
        second = gm.grouped_matmul_drhs(lhs, gout, sz, G)
        torch.cuda.synchronize()
        same_bits[label] = torch.equal(first, second)
    log(f"gmm: two grouped_matmul_drhs launches on the same inputs bitwise equal: {same_bits}")
    if not all(same_bits.values()):
        raise AssertionError(f"grouped_matmul_drhs is not deterministic: {same_bits}")
    del lhs, gout, first, second

    # times at the path's shapes: the four K7a launches of a MoE layer's
    # step ((d, f) and (f, d), each plain and transposed) and its two K7b
    # launches, balanced (hot and cold) and skewed (hot)
    ms, cold_ms, plain_ms, library, bounds, refused = {}, {}, {}, {}, {}, []
    names = ("grouped_matmul", "grouped_matmul_drhs")
    for name in names:
        ms[name], cold_ms[name], plain_ms[name], library[name], bounds[name] = [], [], [], [], []
    sizes = torch.tensor(balanced, dtype=torch.int32, device="cuda")
    sk = torch.tensor(skewed, dtype=torch.int32, device="cuda")
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    for m, n in ((d, f), (f, d)):
        lhs, rhs, gout = _gmm_inputs(rows, m, n, G, seed=m)
        rhs_t = rhs.transpose(1, 2).contiguous()   # [G, n, m]: d_lhs of [rows, n]
        variants = {
            "grouped_matmul": [
                ("plain rhs", lambda sz: gm.grouped_matmul(lhs, rhs, sz),
                 lambda: gm.grouped_matmul_plain(lhs, rhs, sizes),
                 lambda: torch._grouped_mm(lhs, rhs, offs=offs)),
                ("transposed rhs", lambda sz: gm.grouped_matmul(lhs, rhs_t, sz, transpose_rhs=True),
                 lambda: gm.grouped_matmul_plain(lhs, rhs_t, sizes, True),
                 lambda: torch._grouped_mm(lhs, rhs_t.transpose(1, 2), offs=offs)),
            ],
            "grouped_matmul_drhs": [
                ("", lambda sz: gm.grouped_matmul_drhs(lhs, gout, sz, G),
                 lambda: gm.grouped_matmul_drhs_plain(lhs, gout, sizes, G),
                 lambda: torch._grouped_mm(lhs.t(), gout, offs=offs)),
            ],
        }
        for name, runs in variants.items():
            for form, kernel, plain, lib in runs:
                hot, cold = cuda_ms(lambda: kernel(sizes)), cuda_ms_cold(lambda: kernel(sizes))
                skewed_ms = cuda_ms(lambda: kernel(sk))
                ms[name].append(hot)
                cold_ms[name].append(cold)
                plain_ms[name].append(cuda_ms(plain, 3))
                try:   # the yardstick only: a refusal is recorded, not fatal
                    library[name].append(cuda_ms(lib))
                except (RuntimeError, AttributeError, TypeError) as e:
                    library[name].append(None)
                    refused.append(f"{name} {(m, n)}: {str(e).splitlines()[0]}")
                bounds[name].append(gmm_bound(name, rows, m, n, G))
                lib_ms = library[name][-1]
                log(f"gmm timing {name} {form} ({m}, {n}): balanced {hot:.4f} ms hot, "
                    f"{cold:.4f} cold; skewed {skewed_ms:.4f} hot ({skewed_ms / hot:.3f}x); "
                    f"plain {plain_ms[name][-1]:.4f}; torch._grouped_mm "
                    + (f"{lib_ms:.4f}" if lib_ms is not None else "refused")
                    + f"; bound {bounds[name][-1][0]:.4f}")
    # f32 operands run the FMA kernels, f16 the tensor cores: their times at
    # the path's first shape
    for dtype in (torch.float32, torch.float16):
        lhs, rhs, gout = _gmm_inputs(rows, d, f, G, seed=2, dtype=dtype)
        log(f"gmm {dtype} rows {rows} ({d}, {f}) balanced: grouped_matmul "
            f"{cuda_ms(lambda: gm.grouped_matmul(lhs, rhs, sizes)):.4f} ms, grouped_matmul_drhs "
            f"{cuda_ms(lambda: gm.grouped_matmul_drhs(lhs, gout, sizes, G)):.4f} ms (bf16 "
            f"{ms['grouped_matmul'][0]:.4f} and {ms['grouped_matmul_drhs'][0]:.4f}), bound "
            f"{2 * rows * d * f / (PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS) * 1e3:.4f} ms each")
    log(f"gmm timing rows {rows} G {G} balanced, per form: kernels {ms}, cold {cold_ms}, plain "
        f"{plain_ms}, torch._grouped_mm {library}"
        + (f", refused: {refused}" if refused else ""))
    mean = statistics.fmean
    rows_out = {}
    for name in names:
        b_ms = mean(b for b, _ in bounds[name])
        lib = None if None in library[name] else mean(library[name])
        rows_out[name] = {"name": name, "route": "cuda", "source": GMM_SOURCE,
                          "replaces": REPLACES[name], "launches": None,
                          "max_abs_err": errs[name], "ms": mean(ms[name]),
                          "plain_ms": mean(plain_ms[name]), "bound_ms": b_ms,
                          "bound_by": bounds[name][0][1], "library_ms": lib}
    check_moe_no_sync()
    return rows_out


def phase_slice_moe():
    """The port's second path: BaguaTrainer over the dropless MoE LM."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.model_parallel.moe import MoEMLP
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    bt.init_process_group()
    model, trainer, state, batch = build_slice("moe")
    cfg, tokens = model.cfg, batch["tokens"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice 2: {n_params} params in {len(trainer.plan.buckets)} buckets, "
        f"world {trainer.world_size} over {torch.distributed.get_backend()}")

    losses, launches, st, state = train_steps(trainer, state, batch,
                                              MOE["b"] * cfg.max_seq_len, [fa, gm])
    log_steps("slice 2", losses, launches, st)
    base = {"losses": losses, "stats": st, "params": _params_on_host(model)}
    n_moe = cfg.n_layers // 2
    # the rows each expert gets on the training batch after the steps: the
    # skew the gmm kernels meet on this path
    routed = []
    hooks = [m.router.register_forward_hook(
        lambda mod, inp, out: routed.append(torch.bincount(
            torch.topk(out, MOE["k"], dim=-1).indices.reshape(-1),
            minlength=MOE["experts"]).tolist()))
        for m in model.modules() if isinstance(m, MoEMLP)]
    with torch.no_grad():
        model(tokens[:, :cfg.max_seq_len])
    for h in hooks:
        h.remove()
    log(f"slice 2 routing: rows per expert of each MoE layer on the training batch "
        f"after {STEPS} steps: {routed}")
    want = {"flash_fwd": cfg.n_layers * STEPS, "flash_bwd_dkv": cfg.n_layers * STEPS,
            "flash_bwd_dq": cfg.n_layers * STEPS,
            "grouped_matmul": 4 * n_moe * STEPS,       # 2 forward + 2 d_lhs
            "grouped_matmul_drhs": 2 * n_moe * STEPS}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # logits on a short input against the plain gmm and plain attention.  A
    # bf16 ulp of difference before a router can flip a near-tied top-2
    # choice, which moves a token's whole output and, through attention, the
    # tokens after it.  So the plain model routes with the kernel model's
    # router logits (same experts, same gates); the share of tokens whose
    # routing the plain model would have chosen alike is reported and must be
    # at least 95%.  Tolerance: 5e-2 of the largest logit, as slice 1.
    plain = slice_model("moe", gmm_fn=gm.gmm_reference,
                        attn_fn=lambda q, k, v, dtype: fa.reference_attention(q, k, v, dtype))
    plain.load_state_dict(model.state_dict())
    fed, agree = [], []

    def topk(logits):
        return torch.topk(logits, MOE["k"], dim=-1).indices.sort(dim=-1).values

    def record(mod, inp, out):
        fed.append(out)

    def feed(mod, inp, out):
        theirs = fed[len(agree)]
        agree.append((topk(out) == topk(theirs)).all(-1).float().mean().item())
        return theirs

    hooks = [m.router.register_forward_hook(hook)
             for net, hook in ((model, record), (plain, feed))
             for m in net.modules() if isinstance(m, MoEMLP)]
    with torch.no_grad():
        short = tokens[:1, :512]
        got, want_logits = model(short), plain(short)
    for h in hooks:
        h.remove()
    err = rel_err(got, want_logits)
    log(f"slice 2 logits vs plain gmm + plain attention, same routing (seq 512): rel "
        f"err {err:.3g}; the plain model's own routing agrees for {agree} of the "
        f"tokens per MoE layer")
    if not (torch.isfinite(got).all() and got.shape == (1, 512, cfg.vocab_size)
            and err <= 5e-2 and len(agree) == n_moe and min(agree) >= 0.95):
        raise AssertionError(f"logits disagree with the plain path: {err}, routing "
                             f"agreement {agree}")
    base["kernel_ms"] = kernel_step_ms(trainer, state, batch)
    del model, trainer, state, batch, plain
    release()
    base["ep_reference"] = ep_reference()
    return launches, st, base


def ep_batch(device, rows=None, seq=None):
    """The expert-parallel runs' global batch (seed 1): ``MOE["b"]`` rows a
    rank, ``8 * n_dev`` as ``bench_moe_longseq``, of ``MOE["s"]`` tokens
    and a target (``rows`` and ``seq`` for the cut)."""
    rows, seq = rows or MP_WORLD * MOE["b"], seq or MOE["s"]
    g = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, 32768, (rows, seq + 1), device=device, generator=g)


def ep_reference():
    """Slice 2's model at world 1 on the expert-parallel runs' global batch
    (16 rows), Adam 1e-4, ``FULL_STEPS`` steps: the losses the
    ``model_parallel`` phase's EP runs are held to.  Run alone, before the
    ranks start (about 35 GB)."""
    import bagua_tpu_torch as bt

    model = slice_model("moe")
    trainer = bt.BaguaTrainer(bt.moe_lm_loss_fn(aux_loss_weight=0.01),
                              functools.partial(torch.optim.Adam, lr=1e-4),
                              bt.GradientAllReduceAlgorithm(hierarchical=False))
    state = trainer.init(model)
    batch = trainer.shard_batch({"tokens": ep_batch(trainer.device)})
    losses, _, st, _ = train_steps(trainer, state, batch, MP_WORLD * MOE["b"] * MOE["s"], [],
                                   steps=FULL_STEPS)
    log(f"model_parallel reference: slice 2's model at world 1 on the global batch of "
        f"{MP_WORLD * MOE['b']}: losses {losses}, step {st['median_ms']:.3f} ms (median), peak "
        f"{st['peak_gb']:.3f} GB")
    del model, trainer, state, batch
    release()
    return losses


# ---------------------------------------------------------------------------
# remat: slices 1 and 2 under their benches' rematerialization
# ---------------------------------------------------------------------------

#: the flash and gmm kernels by their device names (profiler events)
KERNEL_NAMES = re.compile(r"(?<![A-Za-z0-9_])(fwd|dkv|dq|gmm_drhs|gmm)_"
                          r"(?:wgmma_narrow_|wgmma_|wide_|f32_)?kernel")
KERNEL_OF = {"fwd": "flash_fwd", "dkv": "flash_bwd_dkv", "dq": "flash_bwd_dq",
             "gmm": "grouped_matmul", "gmm_drhs": "grouped_matmul_drhs"}
#: slice -> remat policy, as its bench sets it: ``bench_longctx`` saves the
#: matmuls without batch dimensions (``bench.py:586-590``),
#: ``bench_moe_longseq`` recomputes whole blocks at seq 4096 (``bench.py:294``)
REMAT = {"longctx": "dots_no_batch", "moe": None}


def _params_on_host(model):
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def kernel_step_ms(trainer, state, batch, total=False):
    """Device milliseconds of each flash and gmm kernel in one training step
    (one profiler window over the step), with ``total`` also every device
    kernel's under ``"all kernels"``; the step's state is dropped."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _, loss = trainer.train_step(state, batch)
        loss.item()
        torch.cuda.synchronize()
    out = {"all kernels": 0.0} if total else {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if total:
                out["all kernels"] += e.time_range.elapsed_us() / 1e3
            m = KERNEL_NAMES.search(e.name)
            if m:
                key = KERNEL_OF[m.group(1)]
                out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def phase_remat(bases):
    """Slices 1 and 2 again, each under its bench's remat (``REMAT``), from
    the same weights, batch and optimizer, against the run without remat of
    the same call (``bases``): exact launches (every block's forward runs
    twice, so the flash forward launches ``2 * n_layers`` a step and the gmm
    forward of a MoE layer four times, its backward ones as before), losses
    finite and falling, the first step's loss bitwise equal, the parameters'
    updates within the bf16 tolerance of the kernels' checks (``TOL``; the
    log says whether bitwise), and the peak below.  Prints step time, peak and
    the kernels' device time a step beside the run without remat."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    bt.init_process_group()
    out = {}
    for name, base in bases.items():
        model, trainer, state, batch = build_slice(name, remat=True, remat_policy=REMAT[name])
        cfg = model.cfg
        p0 = _params_on_host(model)
        tokens = (MOE["b"] if name == "moe" else MAIN["b"]) * cfg.max_seq_len
        losses, launches, st, state = train_steps(trainer, state, batch, tokens,
                                                  [fa, gm] if name == "moe" else [fa])
        label = f"remat {name} (policy {REMAT[name]})"
        log_steps(label, losses, launches, st)
        layer_steps = cfg.n_layers * STEPS
        want = {"flash_fwd": 2 * layer_steps, "flash_bwd_dkv": layer_steps,
                "flash_bwd_dq": layer_steps}
        if name == "moe":
            n_moe = cfg.n_layers // 2
            # 2 forward, 2 again in the recompute, 2 d_lhs; d_rhs unchanged
            want.update({"grouped_matmul": 6 * n_moe * STEPS,
                         "grouped_matmul_drhs": 2 * n_moe * STEPS})
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected {want}")
        params = _params_on_host(model)
        bitwise = all(torch.equal(params[n], base["params"][n]) for n in params)
        upd = torch.cat([(params[n] - p0[n]).reshape(-1) for n in params])
        base_upd = torch.cat([(base["params"][n] - p0[n]).reshape(-1) for n in params])
        err = rel_err(upd, base_upd)
        del params, upd, base_upd, p0
        kernel_ms = kernel_step_ms(trainer, state, batch)
        bst = base["stats"]
        log(f"{label}: first loss {losses[0]!r} against {base['losses'][0]!r} without remat "
            f"({'bitwise equal' if losses[0] == base['losses'][0] else 'DIFFERENT'}); "
            f"parameters after {STEPS} steps {'bitwise equal to' if bitwise else 'differ from'} "
            f"the run without remat, updates within {err:.3g} of its largest; step "
            f"{st['step_ms']:.3f} ms against {bst['step_ms']:.3f} ms "
            f"({st['step_ms'] / bst['step_ms'] - 1:+.2%}), peak {st['peak_gb']:.3f} GB against "
            f"{bst['peak_gb']:.3f} GB ({st['peak_gb'] - bst['peak_gb']:+.3f} GB); kernels' "
            f"device ms a step {json.dumps({k: round(v, 4) for k, v in kernel_ms.items()})} "
            f"against {json.dumps({k: round(v, 4) for k, v in base['kernel_ms'].items()})}")
        if not (losses[0] == base["losses"][0] and err <= TOL[torch.bfloat16]
                and st["peak_gb"] < bst["peak_gb"]):
            raise AssertionError(f"{label}: first loss {losses[0]} vs {base['losses'][0]}, "
                                 f"update error {err}, peak {st['peak_gb']} vs {bst['peak_gb']}")
        out[name] = {"launches": launches, "stats": st, "bitwise": bitwise, "update_err": err,
                     "kernel_ms": kernel_ms}
        del model, trainer, state, batch
        release()
    return out


def release():
    """Free what the last phase or run left (objects in reference cycles
    included) and return the cached blocks to the card, so that the next
    run's peak counts its own memory only."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# codec kernels (K1-K3), the compressed path's
# ---------------------------------------------------------------------------


def same(a, b) -> bool:
    """Bitwise equal, any NaN equal to any NaN (its bits are not defined)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = a.isnan()
        if not torch.equal(nan, b.isnan()):
            return False
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return torch.equal(a.view(bits)[~nan], b.view(bits)[~nan])
    return torch.equal(a, b)


def check_codec(x, n, label):
    """K1, K2 and K3 against their plain versions on one input: sidecars,
    payload bytes (of the chunks whose values are all finite: elsewhere the
    grid is NaN and the u8 convert undefined on every side) and decoded
    values exactly equal; returns the largest absolute decode difference
    (0 when exact) by kernel."""
    from bagua_tpu_torch.ops import codec as cd

    mn, mx, p = cd.compress_chunked(x, n)
    pmn, pmx, pp = cd.compress_chunked_plain(x, n)
    y = cd.decompress_chunked(mn, mx, p)
    py = cd.decompress_chunked_plain(pmn, pmx, pp)
    am = cd.absmax_chunked(x, n)
    pam = cd.absmax_chunked_plain(x, n)
    torch.cuda.synchronize()
    finite = torch.isfinite(x.view(n, -1).float()).all(dim=1)
    checks = {"mn": same(mn, pmn), "mx": same(mx, pmx),
              "payload": torch.equal(p[finite], pp[finite]), "decoded": same(y, py),
              "absmax": same(am, pam)}
    log(f"codec {label} ({n} x {x.numel() // n} {x.dtype}): "
        + ", ".join(f"{k} {'equal' if v else 'DIFFERS'}" for k, v in checks.items())
        + f"; {int((~finite).sum())} non-finite chunks")
    if not all(checks.values()):
        raise AssertionError(f"codec kernel disagrees with its plain version on {label}: "
                             f"{checks}")
    ok = torch.isfinite(y) & torch.isfinite(py)
    errs = {"compress_chunked": max(abs_err(mn[finite], pmn[finite]),
                                    abs_err(mx[finite], pmx[finite]),
                                    abs_err(p[finite], pp[finite])),
            "decompress_chunked": abs_err(y[ok], py[ok]),
            "absmax_chunked": abs_err(am[finite], pam[finite])}
    return finite, (mn, y, am), errs


def codec_bound(name, n, m):
    """Least time of one launch: each input byte read once, each output byte
    written once, over the memory rate (K1: f32 in, u8 out; K2: u8 in, f32
    out; K3: f32 in; the per-chunk sidecars are noise)."""
    per_elem = {"compress_chunked": 5, "decompress_chunked": 5, "absmax_chunked": 4}[name]
    return per_elem * n * m / PEAK_BYTES * 1e3, "bytes"


#: the wrappers' launches under each ``trace_op_profile`` window, and the
#: device kernel each one launches
OP_PROFILE_CALLS = 5
CODEC_KERNEL_NAME = {"compress_chunked": "minmax_compress_kernel",
                     "decompress_chunked": "decompress_kernel",
                     "absmax_chunked": "absmax_kernel",
                     "sign_compress_chunked": "sign_compress_kernel",
                     "sign_decompress_chunked": "sign_unpack_kernel"}


def op_profile_check(label, fns, event_ms):
    """``profiling.trace_op_profile`` around ``OP_PROFILE_CALLS`` enqueued
    calls of each codec wrapper of ``fns`` (name -> call): its kernel must
    appear in the trace as many times as the wrapper counted launches, and
    its device time a launch is printed beside the event-timed ``event_ms``."""
    from bagua_tpu_torch import profiling
    from bagua_tpu_torch.ops import codec as cd

    seen = {}
    t0 = time.perf_counter()
    for name, fn in fns.items():
        wrapper = getattr(cd, name)
        torch.cuda.synchronize()
        before = wrapper.launches
        prof = profiling.trace_op_profile(lambda: [fn() for _ in range(OP_PROFILE_CALLS)])
        launched = wrapper.launches - before
        ops = [r for k, r in (prof.get("ops") or {}).items() if CODEC_KERNEL_NAME[name] in k]
        count = sum(r["count"] for r in ops)
        dev_ms = sum(r["time_s"] for r in ops) / max(count, 1) * 1e3
        seen[name] = dev_ms
        log(f"records: trace_op_profile {label} {name}: {CODEC_KERNEL_NAME[name]} "
            f"{count} times in the trace for {launched} launches; device time "
            f"{dev_ms:.5f} ms a launch beside the event-timed {event_ms[name]:.5f} ms")
        if not (count == launched == OP_PROFILE_CALLS):
            raise AssertionError(f"records: trace_op_profile saw {name}'s kernel {count} "
                                 f"times for {launched} launches")
    GROUP_SECONDS["records"][f"trace_op_profile {label}"] = time.perf_counter() - t0
    return seen


def phase_codec_kernels():
    from bagua_tpu_torch.models.transformer import bert_large_config
    from bagua_tpu_torch.ops import codec as cd

    g = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    n = CODEC_WORLD
    path_m = CODEC_BUCKET_BYTES // 4 // n
    embed_m = bert_large_config().vocab_size * bert_large_config().d_model // n
    sizes = {"128 KiB": 32768, "1 MiB": 262144, "8 MiB": 2097152,
             "bucket chunk 5 MiB": path_m}
    errs = {}

    def check(x, label, chunks=n):
        finite, outs, e = check_codec(x, chunks, label)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        return finite, outs

    for label, m in {**sizes, "embedding bucket chunk": embed_m}.items():
        check(randn(n * m), label)
    check(randn(n * 100003) * 1e-3, "ragged")
    check(randn(n * 3), "tiny")
    check(torch.ones(n * 4099, device="cuda"), "constant 1.0")
    check(torch.full((n * 4099,), -3.0, device="cuda"), "constant -3.0")
    check(randn(n * path_m, dtype=torch.bfloat16), "bf16 bucket chunk")
    x = randn(n * 50001)
    x[17], x[50001 + 5] = float("inf"), float("-inf")
    check(x, "±inf")
    x = randn(n * 50001)
    x[123] = float("nan")
    finite, (mn, y, am) = check(x, "NaN")
    if finite.tolist() != [False, True] or not (mn[0].isnan() and y[:50001].isnan().all()
                                               and am[0].isnan()):
        raise AssertionError("a NaN chunk must give a NaN sidecar, a NaN absmax and a "
                             "NaN decode")
    # K3's edges: a chunk of -0.0 (its max is +0.0), and +inf, -inf and a NaN
    # in one chunk of the path's length (NaN) beside ±inf alone (inf)
    x = randn(n * 50001)
    x[:50001] = -0.0
    _, (_, _, am) = check(x, "-0.0")
    if am[0].view(torch.int32).item() != 0:
        raise AssertionError(f"a chunk of -0.0 must give an absmax of +0.0, got {am[0]}")
    x = randn(n * path_m)
    x[5], x[path_m // 2], x[path_m - 1] = float("inf"), float("-inf"), float("nan")
    x[path_m + 9], x[2 * path_m - 3] = float("-inf"), float("inf")
    _, (_, _, am) = check(x, "±inf and NaN")
    if not (am[0].isnan() and am[1].item() == float("inf")):
        raise AssertionError(f"±inf with a NaN must give NaN, ±inf alone inf: {am}")

    # times at each chunk size (f32), kernel against plain, both with the
    # inputs repeated (hot L2: the path's 5 MiB chunk fits in it) and the
    # kernel alone with a cold L2; K3 as the ring encode calls it, one chunk
    times, cold = {}, {}
    for label, m in sizes.items():
        x = randn(n * m)
        mn, mx, p = cd.compress_chunked(x, n)
        x1 = x[:m]
        fns = {"compress_chunked": (lambda: cd.compress_chunked(x, n),
                                    lambda: cd.compress_chunked_plain(x, n)),
               "decompress_chunked": (lambda: cd.decompress_chunked(mn, mx, p),
                                      lambda: cd.decompress_chunked_plain(mn, mx, p)),
               "absmax_chunked": (lambda: cd.absmax_chunked(x1, 1),
                                  lambda: cd.absmax_chunked_plain(x1, 1))}
        times[label] = {k: (cuda_ms(kern, 20), cuda_ms(plain, 5))
                        for k, (kern, plain) in fns.items()}
        cold[label] = {k: cuda_ms_cold(kern) for k, (kern, _) in fns.items()}
        log(f"codec timing chunk {label} ({m} f32): " + ", ".join(
            f"{k} {a:.5f} ms, cold L2 {cold[label][k]:.5f} ms, bound "
            f"{codec_bound(k, 1 if k == 'absmax_chunked' else n, m)[0]:.5f} (plain {b:.4f}, "
            f"{'kernel' if a < b else 'PLAIN'} faster)"
            for k, (a, b) in times[label].items()))
        if label == "bucket chunk 5 MiB":
            kernels_a_call(f"codec chunk {label}", {k: kern for k, (kern, _) in fns.items()},
                           ("compress_chunked", "absmax_chunked"))
            op_profile_check(f"codec chunk {label}", {k: kern for k, (kern, _) in fns.items()},
                             {k: v[0] for k, v in times[label].items()})
    # K1 on the embedding bucket's chunk: more than the grid holds in shared
    # memory, so the part that does not fit is read again
    x = randn(n * embed_m)
    k1 = lambda: cd.compress_chunked(x, n)
    log(f"codec timing embedding chunk ({embed_m} f32): compress_chunked "
        f"{cuda_ms(k1, 5):.5f} ms, cold L2 {cuda_ms_cold(k1, 5):.5f} ms, bound "
        f"{codec_bound('compress_chunked', n, embed_m)[0]:.5f} ms")
    del x
    # the low-precision gossip ring compresses a whole bucket as one chunk
    # (every SM of K1's grid on it): a 10 MiB bucket, and the embedding
    # bucket, more than the grid holds in shared memory
    for label, m in {"one-chunk bucket 10 MiB": CODEC_BUCKET_BYTES // 4,
                     "one-chunk embedding bucket": n * embed_m}.items():
        x = randn(m)
        check(x, label, chunks=1)
        mn, mx, p = cd.compress_chunked(x, 1)
        fns = {"compress_chunked": (lambda: cd.compress_chunked(x, 1),
                                    lambda: cd.compress_chunked_plain(x, 1)),
               "decompress_chunked": (lambda: cd.decompress_chunked(mn, mx, p),
                                      lambda: cd.decompress_chunked_plain(mn, mx, p))}
        log(f"codec timing {label} (1 x {m} f32): " + ", ".join(
            f"{k} {cuda_ms(kern, 10):.5f} ms, cold L2 {cuda_ms_cold(kern, 5):.5f} ms, plain "
            f"{cuda_ms(plain, 3):.4f} ms, bound {codec_bound(k, 1, m)[0]:.5f} ms"
            for k, (kern, plain) in fns.items()))
        del x, mn, mx, p
    # the library yardsticks at the path's chunk: aminmax computes only the
    # reduction half of K1; vector_norm(inf) is K3's whole function
    x = randn(n * path_m)
    x1 = x[:path_m]
    library = {"compress_chunked": cuda_ms(lambda: torch.aminmax(x.view(n, -1), dim=1), 20),
               "decompress_chunked": None,
               "absmax_chunked": cuda_ms(lambda: torch.linalg.vector_norm(
                   x1.view(1, -1), float("inf"), dim=1), 20)}
    log(f"codec library at the bucket chunk: torch.aminmax {library['compress_chunked']:.4f} "
        f"ms (reduction only), vector_norm(inf) {library['absmax_chunked']:.4f} ms")
    rows = {}
    path = times["bucket chunk 5 MiB"]
    for name in ("compress_chunked", "decompress_chunked", "absmax_chunked"):
        b_ms, b_by = codec_bound(name, 1 if name == "absmax_chunked" else n, path_m)
        rows[name] = {"name": name, "route": "cuda", "source": CODEC_SOURCE,
                      "replaces": REPLACES[name], "launches": None, "max_abs_err": errs[name],
                      "ms": path[name][0], "plain_ms": path[name][1], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library[name]}
    return rows


# ---------------------------------------------------------------------------
# sign codec kernels (K4, K5), the 1-bit path's
# ---------------------------------------------------------------------------


def check_sign(x, n, label):
    """K4 and K5 against their plain versions on one input: payload bytes
    exactly equal, the scale (a sum in another order) within ``SIGN_RTOL``
    relative, K5 on the kernel's parts exactly equal to its plain version;
    returns the parts, the decode and the largest absolute differences."""
    from bagua_tpu_torch.ops import codec as cd

    scale, p = cd.sign_compress_chunked(x, n)
    pscale, pp = cd.sign_compress_chunked_plain(x, n)
    y = cd.sign_decompress_chunked(scale, p)
    py = cd.sign_decompress_chunked_plain(scale, p)
    torch.cuda.synchronize()
    finite = torch.isfinite(pscale)
    rel = ((scale - pscale).abs() / pscale.abs().clamp_min(1e-30))[finite]
    checks = {"payload": torch.equal(p, pp),
              "scale": torch.equal(finite, torch.isfinite(scale))
              and torch.equal(scale.isnan(), pscale.isnan())
              and bool((rel <= SIGN_RTOL).all()),
              "decoded": same(y, py)}
    log(f"sign {label} ({n} x {x.numel() // n} {x.dtype}, {p.shape[1]} bytes a chunk): "
        + ", ".join(f"{k} {'equal' if v else 'DIFFERS'}" for k, v in checks.items())
        + f"; scale rel err {rel.max().item() if rel.numel() else 0.0:.3g}; "
        f"{int((~finite).sum())} non-finite chunks")
    if not all(checks.values()):
        raise AssertionError(f"sign kernel disagrees with its plain version on {label}: "
                             f"{checks}")
    ok = torch.isfinite(y) & torch.isfinite(py)
    errs = {"sign_compress_chunked": abs_err(scale[finite], pscale[finite]),
            "sign_decompress_chunked": abs_err(y[ok], py[ok])}
    return (scale, p, y), errs


def sign_bound(name, n, m, itemsize=4):
    """Least time of one launch: each input byte read once, each output byte
    written once, over the memory rate.  K4 reads ``m`` elements and writes
    ``B = ceil(m / 1024) * 128`` bytes and a scale a chunk; K5 reads those and
    writes the padded ``8 B`` f32 elements.  At f32 and m a multiple of 1024,
    4.125 bytes an element each."""
    from bagua_tpu_torch.ops.codec import sign_payload_bytes

    nbytes = sign_payload_bytes(m)
    moved = n * (m * itemsize + nbytes + 4) if name == "sign_compress_chunked" \
        else n * (nbytes + 4 + 32 * nbytes)
    return moved / PEAK_BYTES * 1e3, "bytes"


def phase_sign_kernels():
    from bagua_tpu_torch.models.transformer import bert_large_config
    from bagua_tpu_torch.ops import codec as cd

    g = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    n = CODEC_WORLD
    cfg = bert_large_config()
    path_m = CODEC_BUCKET_BYTES // 4 // n          # the main path's ring chunk
    sizes = {"128 KiB": 32768, "1 MiB": 262144, "8 MiB": 2097152,
             "ring chunk 5 MiB": path_m}
    # the 2 x 2 path's inter-node ring chunk: a quarter of a 10 MiB bucket
    shapes = {**{k: (n, m) for k, m in sizes.items()},
              "2x2 inter chunk 2.5 MiB": (2, CODEC_BUCKET_BYTES // 4 // 4),
              "embedding bucket chunk": (n, cfg.vocab_size * cfg.d_model // n),
              "whole 10 MiB bucket (compensate)": (1, CODEC_BUCKET_BYTES // 4)}
    errs = {}

    def check(x, k, label):
        outs, e = check_sign(x, k, label)
        for key, v in e.items():
            errs[key] = max(errs.get(key, 0.0), v)
        return outs

    for label, (k, m) in shapes.items():
        check(randn(k * m), k, label)
    check(randn(n * 100003) * 1e-3, n, "ragged")
    check(randn(n * 3), n, "tiny")
    scale, p, y = check(torch.zeros(n * 5000, device="cuda"), n, "all-zero")
    if not ((scale == 0).all() and (p == 255).all() and (y == 0).all()):
        raise AssertionError("an all-zero chunk must give scale 0, all sign bits 1, zeros")
    check(randn(n * path_m, dtype=torch.bfloat16), n, "bf16 ring chunk")
    x = randn(n * 50001)
    x[17], x[50001 + 5] = float("inf"), float("-inf")
    scale, _, y = check(x, n, "±inf")
    if torch.isfinite(scale).any() or torch.isfinite(y).any():
        raise AssertionError("an inf in a chunk must make its scale and decode non-finite")
    x = randn(n * 50001)
    x[123] = float("nan")
    scale, _, y = check(x, n, "NaN")
    if not (scale[0].isnan() and y[0].isnan().all() and torch.isfinite(y[1]).all()):
        raise AssertionError("a NaN chunk must give a NaN scale and a NaN decode")

    # times at each chunk size (f32): kernels hot and with a cold L2, plain
    # versions hot
    times, cold = {}, {}
    for label, m in sizes.items():
        x = randn(n * m)
        scale, p = cd.sign_compress_chunked(x, n)
        fns = {"sign_compress_chunked": (lambda: cd.sign_compress_chunked(x, n),
                                         lambda: cd.sign_compress_chunked_plain(x, n)),
               "sign_decompress_chunked": (lambda: cd.sign_decompress_chunked(scale, p),
                                           lambda: cd.sign_decompress_chunked_plain(scale, p))}
        times[label] = {k: (cuda_ms(kern, 20), cuda_ms(plain, 5))
                        for k, (kern, plain) in fns.items()}
        cold[label] = {k: cuda_ms_cold(kern) for k, (kern, _) in fns.items()}
        log(f"sign timing chunk {label} ({m} f32): " + ", ".join(
            f"{k} {a:.5f} ms, cold L2 {cold[label][k]:.5f} ms, bound "
            f"{sign_bound(k, n, m)[0]:.5f} (plain {b:.4f}, "
            f"{'kernel' if a < b else 'PLAIN'} faster)"
            for k, (a, b) in times[label].items()))
        if label == "ring chunk 5 MiB":
            kernels_a_call(f"sign chunk {label}", {k: kern for k, (kern, _) in fns.items()},
                           ("sign_compress_chunked",))
            op_profile_check(f"sign chunk {label}", {k: kern for k, (kern, _) in fns.items()},
                             {k: v[0] for k, v in times[label].items()})
    # the library yardstick of K4 at the path's chunk: its reduction half
    x = randn(n * path_m)
    library = {"sign_compress_chunked": cuda_ms(lambda: x.view(n, -1).abs().sum(dim=1), 20),
               "sign_decompress_chunked": None}
    log(f"sign library at the ring chunk: abs().sum(dim=1) "
        f"{library['sign_compress_chunked']:.4f} ms (reduction only)")
    rows = {}
    path = times["ring chunk 5 MiB"]
    for name in ("sign_compress_chunked", "sign_decompress_chunked"):
        b_ms, b_by = sign_bound(name, n, path_m)
        rows[name] = {"name": name, "route": "cuda", "source": CODEC_SOURCE,
                      "replaces": REPLACES[name], "launches": None, "max_abs_err": errs[name],
                      "ms": path[name][0], "plain_ms": path[name][1], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library[name]}
    return rows


# ---------------------------------------------------------------------------
# narrow and f32 shapes: the kernels widen what is narrower than their tiles
# ---------------------------------------------------------------------------


def phase_narrow_shapes():
    """The tiny SQuAD model (head_dim 32), in bf16 and in f16: one forward
    and backward on the card through the flash kernels, one launch of each a
    layer, the loss and every gradient finite, and the logits on the same
    input within the slices' 5e-2 of the same model with the plain
    attention.  An ``MoEMLP`` with d_model 64 in bf16, one with d_model 128 in
    f32 and one with d_model 128 in f16: one forward and backward each
    through the gmm kernels (four K7a and two K7b launches), against the same
    layer whose gmm is the dense reference (the routing, computed before
    either, is the same): the output within the product's tolerance and
    every gradient within twice it."""
    from bagua_tpu_torch.model_parallel.moe import MoEMLP
    from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM, lm_loss_fn
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    for dtype in (torch.bfloat16, torch.float16):
        cfg = TransformerConfig(**SQUAD_TINY, dtype=dtype)
        model = TransformerLM(cfg, seed=0)
        g = torch.Generator(device="cuda").manual_seed(12)
        tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len + 1), device="cuda",
                               generator=g)
        fa.reset_launch_counts()
        loss = lm_loss_fn(model, {"tokens": tokens})
        loss.backward()
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in fa.KERNELS}
        finite = bool(torch.isfinite(loss)) and all(
            torch.isfinite(p.grad).all() for p in model.parameters())
        plain = TransformerLM(cfg, attn_fn=lambda q, k, v, dtype:
                              fa.reference_attention(q, k, v, dtype))
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            short = tokens[:1, :cfg.max_seq_len]
            got, want = model(short), plain(short)
        err = rel_err(got, want)
        log(f"narrow heads: SQuAD tiny (head_dim {cfg.head_dim}) {dtype} loss "
            f"{loss.item():.4f}, finite {finite}, launches {launches}; logits vs plain "
            f"attention rel err {err:.3g}")
        if not (finite and set(launches.values()) == {cfg.n_layers} and err <= 5e-2):
            raise AssertionError(f"head_dim {cfg.head_dim} {dtype}: launches {launches}, "
                                 f"finite {finite}, logits rel err {err}")

    for d_model, dtype in ((64, torch.bfloat16), (128, torch.float32), (128, torch.float16)):
        g = torch.Generator(device="cuda").manual_seed(d_model)
        x0 = torch.randn(2, SQUAD_TINY["max_seq_len"], d_model, device="cuda",
                         generator=g).to(dtype)
        runs = []
        for gmm_fn in (None, gm.gmm_reference):
            torch.manual_seed(0)
            layer = MoEMLP(MOE["experts"], 256, d_model=d_model, k=MOE["k"], dropless=True,
                           dtype=dtype, gmm_fn=gmm_fn).cuda()
            x = x0.clone().requires_grad_()
            gm.reset_launch_counts()
            y = layer(x)
            (y.float().square().mean() + layer.l_aux).backward()
            torch.cuda.synchronize()
            runs.append((y, [x.grad, *(p.grad for p in layer.parameters())],
                         [k.launches for k in gm.KERNELS]))
        (y, grads, launches), (ref_y, ref_grads, _) = runs
        tol = GMM_TOL[dtype]
        err = rel_err(y, ref_y)
        grad_err = max(rel_err(a, b) for a, b in zip(grads, ref_grads))
        finite = all(torch.isfinite(t).all() for t in (y, *grads))
        log(f"narrow, f16 and f32 gmm: MoEMLP d_model {d_model} {dtype}: launches {launches}, "
            f"output vs dense reference rel err {err:.3g}, gradients {grad_err:.3g}, "
            f"finite {finite}")
        if not (finite and launches == [4, 2] and err <= tol and grad_err <= 2 * tol):
            raise AssertionError(f"MoEMLP d_model {d_model} {dtype}: launches {launches}, "
                                 f"rel err {err}, gradients {grad_err}, finite {finite}")


# ---------------------------------------------------------------------------
# slices 3 and 4: compressed data parallelism, several ranks on one card over
# gloo
# ---------------------------------------------------------------------------

#: steps of the multi-rank runs (a step costs 0.2-6 s through gloo on the
#: shared card); QAdam's run keeps ``STEPS`` for its warmup, the async and
#: features phases' cut runs for their schedules.  The codec runs of slices 3
#: and 4 and the gossip runs at world 2 keep ``CODEC_STEPS``: their checks against the
#: plain codec were set on that state (at 3 steps the 1-bit residual of the
#: embedding bucket read 1.62e-5 of the scale against the 1e-5 gate)
FULL_STEPS, CODEC_STEPS = 3, 5
#: (name, layers, algorithm, BaguaTrainer keywords).  Slice 3, on a 4-layer
#: cut of BERT-Large: (a) ByteGrad (the overlap phase runs it on the full
#: model), (b) the forced int8 and fp8 rings and (c) QAdam
SLICE3_RUNS = (
    ("bytegrad", BERT["cut_layers"], "bytegrad", {"steps": CODEC_STEPS}),
    ("int8", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "int8", "steps": CODEC_STEPS}),
    ("fp8_e4m3", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "fp8_e4m3", "steps": CODEC_STEPS}),
    ("qadam", BERT["cut_layers"], "qadam", {}),
)
#: slice 4 at world 2: (a) the main path, the README quick start with the
#: 1-bit codec, (b) top-k (1%), both on the 4-layer cut (the full BERT-Large
#: would not leave the script room for the obs and serve phases)
SLICE4_RUNS = (
    ("onebit_ef", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "steps": CODEC_STEPS}),
    ("topk", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "topk", "steps": CODEC_STEPS}),
)
#: slice 4 at world 4, two nodes of two ranks, on the 4-layer cut: (a) the
#: two-level allreduce with the 1-bit codec on the inter-node tier, (b)
#: ByteGrad at its default hierarchical=True (MinMaxUInt8 on that tier)
SLICE4_2X2_RUNS = (
    ("hier_onebit_ef", BERT["cut_layers"], "hierarchical",
     {"compress_inter": "onebit_ef", "steps": FULL_STEPS}),
    ("bytegrad_2x2", BERT["cut_layers"], "bytegrad_default", {"steps": FULL_STEPS}),
    ("zero_2x2", BERT["cut_layers"], "zero_hierarchical", {"steps": FULL_STEPS}),
)
#: ZeRO-1 at world 2: (a) the full BERT-Large, its optimizer state sharded,
#: beside (b) the replicated run it must halve that state of; (c) the 4-layer
#: cut through the int8 ring.  (c) runs AdamW at 1e-3: its gather sends the
#: parameters through the codec, and an AdamW step of 1e-4 is below half of
#: the int8 grid step of every chunk of the weights (absmax / 127: 6.7e-4 to
#: 1.3e-3 for 1.3 M draws of N(0, 1 / fan_in), 7.9e-3 where a norm scale of 1
#: shares the chunk), so at 1e-4 the decoded parameters would not move, in
#: the JAX package's ZeRO as in the port
ZERO_RUNS = (
    ("zero", None, "zero", {"steps": FULL_STEPS}),
    ("replicated", None, "gradient_allreduce", {"steps": FULL_STEPS}),
    ("zero_int8", BERT["cut_layers"], "zero", {"compress_intra": "int8", "lr": 1e-3}),
)
#: the gossip families at world 2: (a) full-precision ``all`` with the peer
#: weights tracked (no codec), (b) the low-precision ring, flat (a whole
#: bucket one K1 chunk), both on the 4-layer cut
DECENTRALIZED_RUNS = (
    ("decentralized_all", BERT["cut_layers"], "decentralized_all", {"steps": CODEC_STEPS}),
    ("low_precision", BERT["cut_layers"], "low_precision", {"steps": CODEC_STEPS}),
)
#: the gossip families at world 4, two nodes of two ranks, on the 4-layer
#: cut: (a) ``shift_one`` over the four ranks, the partner rotating with the
#: step, (b) the low-precision ring hierarchical: the intra-node average,
#: then the ring over the two nodes
DECENTRALIZED_4_RUNS = (
    ("shift_one", BERT["cut_layers"], "shift_one", {"steps": FULL_STEPS}),
    ("low_precision_2x2", BERT["cut_layers"], "low_precision_2x2", {"steps": FULL_STEPS}),
)
#: async model average at world 2: (a) the full BERT-Large with the bench's
#: ``AsyncModelAverageAlgorithm(sync_interval_ms=100)`` (``bench.py:88``); on
#: the 4-layer cut, (b) a pinned period of 2 after 2 warmup steps with
#: ``async.partition`` armed on rank 1 alone under a staleness cap of 2, and
#: (c) a period of 1, rank 0 aborting after step ``ASYNC_ABORT_AFTER`` and
#: rank 1 resuming after step ``ASYNC_RESUME_AFTER``
ASYNC_RUNS = (
    ("async", None, "async", {}),
    ("async_partition", BERT["cut_layers"], "async_partition", {}),
    ("async_abort", BERT["cut_layers"], "async_abort", {}),
)
ASYNC_ABORT_AFTER, ASYNC_RESUME_AFTER = 3, 6
#: the trainer's step features at world 2: (a) the full BERT-Large ZeRO on the
#: leaf layout, beside the zero phase's ZeRO, which the default makes
#: resident; on the 4-layer cut, (b) GradientAllReduce with two microbatches
#: of 4 of a rank's 8 rows and the guard on ``skip``, no fault, held against
#: the first steps of (d)'s run without rebucket (it ran on the full
#: BERT-Large until the autotune phase needed the time), (c) the 1-bit ring under
#: the guard: two clean runs of
#: ``POISON_STEPS - 1`` steps and one of ``POISON_STEPS`` with ``grad.poison``
#: at step ``POISON_AT``; (d) full precision, resident, without and with a
#: rebucket from 10 MiB to ``REBUCKET_BYTES`` buckets after step
#: ``REBUCKET_AFTER``, then the same rebucket under the 1-bit ring.  The full
#: BERT-Large run and (b) take ``FULL_STEPS`` steps, (a) held against the
#: first steps of the zero phase's ZeRO run (2-6 s a step through gloo)
POISON_AT, POISON_STEPS = 4, STEPS
REBUCKET_AFTER, REBUCKET_BYTES = 5, 2 * 1024 ** 2
FEATURES_RUNS = (
    ("zero_leaf", None, "zero", {"flat_resident": "off", "steps": FULL_STEPS}),
    ("accum_guard", BERT["cut_layers"], "gradient_allreduce",
     {"accum_steps": 2, "grad_guard": "skip", "steps": FULL_STEPS}),
    ("onebit_clean", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "grad_guard": "skip", "steps": POISON_STEPS - 1}),
    ("onebit_clean_again", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "grad_guard": "skip", "steps": POISON_STEPS - 1}),
    ("onebit_poison", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "grad_guard": "skip", "poison": POISON_AT,
      "steps": POISON_STEPS}),
    ("no_rebucket", BERT["cut_layers"], "gradient_allreduce", {}),
    ("rebucket", BERT["cut_layers"], "gradient_allreduce", {"rebucket": True}),
    ("onebit_rebucket", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "rebucket": True}),
)
#: the overlap phase at world 2 (``OVERLAP_RUNS``): on the 4-layer cut, (a)
#: GradientAllReduce, two microbatches of 4, serialized then overlapped; on
#: the full BERT-Large, (b) ByteGrad overlapped, then serialized on the
#: overlapped run's plan (the readiness rebucket moves the codec's chunks, so
#: a bitwise comparison needs one plan), (c) ZeRO overlapped, against the
#: zero phase's serialized run; on the cut, (d) the fused allreduce, then the chunked rings of
#: ``OVERLAP_CHUNK_BYTES`` sub-rings in full precision, under int8 (K3) and
#: under the 1-bit codec (K4, K5); (e) every eager collective on card tensors
OVERLAP_CHUNK_BYTES = 1 << 20
OVERLAP_RUNS = (
    ("ga_serial", BERT["cut_layers"], "gradient_allreduce",
     {"accum_steps": 2, "overlap": "off", "steps": FULL_STEPS}),
    ("ga_overlap", BERT["cut_layers"], "gradient_allreduce",
     {"accum_steps": 2, "overlap": "on", "steps": FULL_STEPS}),
    ("bytegrad_overlap", None, "bytegrad", {"overlap": "on", "steps": FULL_STEPS}),
    ("bytegrad_serial", None, "bytegrad",
     {"overlap": "off", "steps": FULL_STEPS, "plan_of": "bytegrad_overlap"}),
    ("zero_overlap", None, "zero", {"overlap": "on", "steps": FULL_STEPS}),
    ("ring_fused", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "off", "steps": FULL_STEPS}),
    ("ring_chunked", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "on", "overlap_chunk_bytes": OVERLAP_CHUNK_BYTES, "steps": FULL_STEPS}),
    ("ring_int8", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "on", "overlap_chunk_bytes": OVERLAP_CHUNK_BYTES, "compress_intra": "int8",
      "steps": FULL_STEPS}),
    ("ring_onebit", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "on", "overlap_chunk_bytes": OVERLAP_CHUNK_BYTES,
      "compress_intra": "onebit_ef", "steps": FULL_STEPS}),
    ("eager", None, "eager", {}),
)
#: the chunked ring's losses against the fused allreduce's (relative, every
#: step): at world 2 a sub-ring adds the same two values, so they agree
#: exactly; more ranks would add them in another order
RING_LOSS_RTOL = 1e-5
#: the least drop of the peak from the leaf layout to the resident one, ZeRO
#: on the full BERT-Large (GB): the chunk copy a rank (0.931 GB) that the
#: resident layout does without
RESIDENT_PEAK_DROP_GB = 0.9
#: the features runs' tolerance of the accumulated losses against the cut's
#: full-precision run without rebucket (relative, every step)
ACCUM_LOSS_RTOL = 1e-2
#: the model_parallel phase at world 2, both ranks on the card over gloo, one
#: spawn: (a) expert parallelism on slice 2's model at full width, mesh
#: ``{"ep": 2}``, 4 experts and 8 rows a rank, the dense-slot exchange then
#: the exact-count one, and on a cut (d_model 128, f32) one SGD step against
#: the world-1 step; (b) sequence parallelism on slice 1's model at full
#: width, mesh ``{"sp": 2}``, the attention alone against world-1 flash, then
#: the ring (flash) and Ulysses runs
MP_RUNS = (
    ("ep_dense", None, "ep", {"use_ragged": False}),
    ("ep_ragged", None, "ep", {"use_ragged": True}),
    ("ep_zero", None, "ep", {"use_ragged": False, "algo": "zero"}),
    ("ep_qadam", None, "ep", {"use_ragged": False, "algo": "qadam"}),
    ("ep_cut", None, "ep_cut", {}),
    ("sp_attention", None, "sp_attention", {}),
    ("sp_cut", None, "sp_cut", {}),
    ("sp_ring", None, "sp", {"attn": "ring"}),
    ("sp_ulysses", None, "sp", {"attn": "ulysses"}),
)
#: the rescale gate's cut of slice 2: d_model 128 (8 heads of 16), f32, seq
#: 512, 4 rows a rank, SGD 0.1; its tolerance (relative, every parameter)
MP_CUT = dict(d_model=128, d_ff=512, max_seq_len=512, dtype=torch.float32)
MP_CUT_ROWS, MP_CUT_RTOL = 4, 1e-5
#: the sequence-parallel gate's cut of slice 1: d_model 256 (4 heads of 64),
#: f32, seq 512, slice 1's 2 rows, SGD 0.1; held to ``MP_CUT_RTOL``
SP_CUT = dict(d_model=256, n_heads=4, d_ff=1024, max_seq_len=512, dtype=torch.float32)
#: the expert- and sequence-parallel losses against the world-1 ones
#: (relative, every step): bf16 runs over other batch splits and kernels.
#: (on the H100 the gaps were 3.45e-5 for EP and 1.45e-4 for SP)
MP_LOSS_RTOL = 1e-3
#: the tensor_pipeline phase, two ranks on the card over gloo, one spawn:
#: slice 1's model at full width over ``{"tp": 2}`` (8 heads and d_ff 2048
#: a rank) and over ``{"pp": 2}`` (2 layers a stage, ``PP_MICRO``
#: microbatches of one row), ``FULL_STEPS`` AdamW steps each, from slice
#: 1's world-1 weights; then one SGD step on ``SP_CUT`` at tp 2 and at pp 2
#: against world 1, each with a control that must fail
TPP_RUNS = (
    ("tp_full", None, "full", {"axes": {"tp": 2}}),
    ("pp_full", None, "full", {"axes": {"pp": 2}}),
    ("tp_cut", None, "cut", {"axes": {"tp": 2}}),
    ("pp_cut", None, "cut", {"axes": {"pp": 2}}),
    ("tp_generate", None, "generate", {}),
    ("tp_remesh", None, "remesh", {}),
    ("vision_stack", None, "vision_stack", {}),
    ("vision_cut", None, "vision_cut", {}),
)
#: the 3-D cut, pp 2 x tp 2 on four ranks (dp 1), with its control and a
#: checkpoint resumed after its first step
TPP4_RUNS = (("cut_3d", None, "cut", {"axes": {"pp": 2, "tp": 2}, "ckpt": True}),)
PP_MICRO = 2
#: the multi-rank phases: name -> (label, runs, world, intra-node size)
#: the autotune phase at world 2, in slice 3's spawn, on the 4-layer cut: (a)
#: the live loop against an untuned control, (b) the codec flip that adds and
#: drops the error-feedback residual
AUTOTUNE_RUNS = (
    ("autotune_loop", BERT["cut_layers"], "gradient_allreduce", {}),
    ("codec_flip", BERT["cut_layers"], "gradient_allreduce", {}),
)
#: the sidecar's settings, read by rank 0's ``init_process_group`` in the
#: spawn that runs the autotune phase (with ``BAGUA_SERVICE_PORT``)
AUTOTUNE_SERVICE = {"BAGUA_AUTOTUNE": "1", "BAGUA_AUTOTUNE_MAX_SAMPLES": "2",
                    "BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S": "0",
                    "BAGUA_AUTOTUNE_WARMUP_TIME_S": "0"}
AUTOTUNE_MODEL = "chip_autotune"
#: the live loop's steps between check-ins (the trainer's
#: ``autotune_checkin_steps``, 100 by default as in the JAX package; at world
#: 2 the service decides at the second check-in), its steps at most, and its
#: steps after the first plan change
AUTOTUNE_EVERY = 20
AUTOTUNE_MAX_STEPS, AUTOTUNE_AFTER = 8 * AUTOTUNE_EVERY, 10
#: the codec flip's steps before, with the 1-bit codec and after
FLIP_STEPS = (3, 3, 2)
#: the allocator's drop at the flip back against the residual's bytes,
#: relative: the live tensors between two steps move by about 0.3-1.3 MB
#: (of a 520 MB residual on the cut) from call to call
FLIP_MEM_RTOL = 0.01
#: the chaos matrix's drills of two ranks (in slice 3's spawn) and of the
#: 2 x 2 mesh's four (in slice 4 (2 x 2)'s), ``scripts/torch_chaos_drill.py``
CHAOS_RUNS = (("chaos",),)
CHAOS_4_RUNS = (("chaos_4",),)
MULTI_RANK = {
    "slice3": ("slice 3", SLICE3_RUNS, CODEC_WORLD, None),
    "slice4": ("slice 4", SLICE4_RUNS, CODEC_WORLD, None),
    "slice4_2x2": ("slice 4 (2 x 2)", SLICE4_2X2_RUNS, 4, 2),
    "zero": ("zero", ZERO_RUNS, CODEC_WORLD, None),
    "decentralized": ("decentralized", DECENTRALIZED_RUNS, CODEC_WORLD, None),
    "autotune": ("autotune", AUTOTUNE_RUNS, CODEC_WORLD, None),
    "decentralized_4": ("decentralized (2 x 2)", DECENTRALIZED_4_RUNS, 4, 2),
    "async": ("async", ASYNC_RUNS, CODEC_WORLD, None),
    "features": ("features", FEATURES_RUNS, CODEC_WORLD, None),
    "overlap": ("overlap", OVERLAP_RUNS, CODEC_WORLD, None),
    "model_parallel": ("model_parallel", MP_RUNS, MP_WORLD, None),
    "tensor_pipeline": ("tensor_pipeline", TPP_RUNS, 2, None),
    "tensor_pipeline_4": ("tensor_pipeline (pp 2 x tp 2)", TPP4_RUNS, 4, None),
    "chaos": ("chaos", CHAOS_RUNS, CODEC_WORLD, None),
    "chaos_4": ("chaos (2 x 2)", CHAOS_4_RUNS, 4, 2),
}
#: phases that run in one spawn, in order (the same world and tiers): a spawn
#: costs 15-20 s (the ranks' start: importing torch, then torch._dynamo at the
#: first optimizer, 7-8 s each on the card's host; CUDA and gloo), so the
#: two-rank phases ride in one spawn, but checkpoint (b, c), which runs in a
#: spawn of its own beside it to shorten the run, and the four-rank ones in two
SPAWNS = {"slice3": ("slice3", "slice4", "zero", "decentralized", "autotune", "async",
                     "features", "overlap", "model_parallel", "tensor_pipeline", "chaos"),
          "slice4_2x2": ("slice4_2x2", "decentralized_4", "chaos_4")}
QADAM_WARMUP = 2
#: the generate phase: slice 1's LM, a prompt of its batch's first
#: ``GEN_PROMPT`` tokens, ``GEN_NEW`` greedy tokens, dense and paged
#: (``GEN_PAGE`` positions a page)
GEN_PROMPT, GEN_NEW, GEN_PAGE = 512, 256, 64
#: the generate phase's logits gate: slice 1's logits gate (relative to the
#: largest logit), between the decode logits and the training forward's
GEN_LOGITS_RTOL = 5e-2
#: where the generate phase leaves its tokens and logits for the
#: tensor-parallel decode run (a file in the phase's temporary directory)
GEN_REF_ENV = "CHIP_SMOKE_GENERATE_REF"
#: seconds a multi-rank phase may take before its ranks are killed
WORKER_TIMEOUT = 420
#: the whole run's bound (the card run's limit is 1200 s): past it the run
#: stops every process it started and exits 124
SCRIPT_BOUND_S = 1150
#: the pairs of runs whose collective logs the two-rank spawn records
#: (overlapped, serialized): ByteGrad (K1 and K2) and ZeRO
COLLECTIVE_PAIRS = (("bytegrad_overlap", "bytegrad_serial"), ("zero_overlap", "zero"))
#: the pod simulator's drill (``scripts/scale_drill.py:95-185``) at the first
#: size of BAGUA_SCALE_RANKS, the link shape, seed and inter-node codec of
#: BAGUA_SCALE_SHAPE, _SEED and _DCN_CODEC (their defaults: pod, 0,
#: minmax_uint8) and the drill's own settings
PODSIM = dict(slice_size=8, steps=1, vec_elems=8192, lease_ttl_s=4.0, timeout_s=180.0)
PODSIM_CHECKS = 17
#: the static engines of the lint phase
LINT_ENGINES = "ast,concurrency,trace"


def _adamw(lr=1e-4):
    """``bench_bert``'s AdamW."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _algorithm(name, lr=1e-4):
    import bagua_tpu_torch as bt

    if name in ("zero", "zero_hierarchical"):
        return bt.ZeroOptimizerAlgorithm(_adamw(lr), hierarchical=name == "zero_hierarchical")
    if name in ("decentralized_all", "shift_one"):
        mode = "all" if name == "decentralized_all" else "shift_one"
        return bt.DecentralizedAlgorithm(hierarchical=False, peer_selection_mode=mode,
                                         track_peer_weights=True)
    if name in ("low_precision", "low_precision_2x2"):
        return bt.LowPrecisionDecentralizedAlgorithm(hierarchical=name == "low_precision_2x2")
    if name == "async":
        return bt.AsyncModelAverageAlgorithm(sync_interval_ms=100)
    if name == "async_partition":
        return bt.AsyncModelAverageAlgorithm(warmup_steps=2, period_steps=2,
                                             max_staleness_rounds=2)
    if name == "async_abort":
        return bt.AsyncModelAverageAlgorithm(period_steps=1)
    if name == "async_ckpt":
        return bt.AsyncModelAverageAlgorithm(warmup_steps=1, period_steps=1)
    if name == "bytegrad":
        return bt.ByteGradAlgorithm(hierarchical=False)
    if name == "bytegrad_default":
        return bt.ByteGradAlgorithm()
    if name == "qadam":
        # lr 1e-5: at 1e-4 the second moment frozen after two warmup steps
        # turns grown gradients into steps that make the loss diverge from
        # the third compressed step on, with the codec or without it
        # (compress_intra="off"), in the JAX package's QAdam as in the port
        return bt.QAdamAlgorithm(warmup_steps=QADAM_WARMUP, hierarchical=False, lr=1e-5)
    return bt.GradientAllReduceAlgorithm(hierarchical=name == "hierarchical")


def _want_launches(algo_name, kw, n_layers, n_buckets, steps=STEPS):
    """Each codec and flash kernel's launches in ``steps`` steps.  Per bucket
    and step: ByteGrad's and QAdam's scatter-gather one K1 and two K2; the
    two-level ByteGrad's inter-node ring at n = 2 one hop and the allgather's
    encode, two K1 and two K2; the int8/fp8 rings at world 2 two K3 (the
    allreduce's, and ZeRO's: one on the scatter hop, one on the gather); the
    1-bit codec's error-feedback step one K4 and one K5, its ring at n = 2
    two more of each (one hop, then the allgather's encode and the decode of
    the gathered parts); the low-precision gossip ring one K1 (the bucket's
    ``diff`` as one chunk) and three K2 (from the left, from the right, its
    own); top-k and the full-precision gossip none."""
    from bagua_tpu_torch.ops import codec as cd

    want = {k.__name__: 0 for k in cd.KERNELS}
    want.update({k: n_layers * steps for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
    codec = kw.get("compress_intra") or kw.get("compress_inter")
    if algo_name in ("bytegrad", "qadam"):
        codec_steps = steps - QADAM_WARMUP if algo_name == "qadam" else steps
        want["compress_chunked"] = n_buckets * codec_steps
        want["decompress_chunked"] = 2 * n_buckets * codec_steps
    elif algo_name == "bytegrad_default":
        want["compress_chunked"] = want["decompress_chunked"] = 2 * n_buckets * steps
    elif algo_name in ("low_precision", "low_precision_2x2"):
        want["compress_chunked"] = n_buckets * steps
        want["decompress_chunked"] = 3 * n_buckets * steps
    elif codec in ("int8", "fp8_e4m3"):
        want["absmax_chunked"] = 2 * n_buckets * steps
    elif codec == "onebit_ef":
        want["sign_compress_chunked"] = want["sign_decompress_chunked"] = 3 * n_buckets * steps
    return want


def fwd_bwd_ms(model, batch, reps: int = 3) -> float:
    """Median host time of this rank's forward and backward alone, no
    communication; every rank runs it at once on the one card, as in a step."""
    import bagua_tpu_torch as bt

    times = []
    for _ in range(reps):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt.lm_loss_fn(model, batch).backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def optimizer_state_bytes(opt) -> int:
    """Bytes of an optimizer's per-element state on this rank: every state
    tensor shaped like its parameter (AdamW's two moments), not the step
    counters."""
    return sum(t.numel() * t.element_size() for p, st in opt.state.items()
               for t in st.values() if torch.is_tensor(t) and t.shape == p.shape)


def _flat_digests(trainer, model):
    """sha256 of every bucket flat of the parameters."""
    import hashlib

    with torch.no_grad():
        flats = trainer.plan.flatten(dict(model.named_parameters()))
    return [hashlib.sha256(f.cpu().numpy()).hexdigest() for f in flats]


def _check_plain_bucket(rank, trainer, model, batch, record):
    """One ByteGrad bucket's reduction through the kernels against the same
    collective through the plain codec (CPU tensors take it), on a fresh
    local gradient: byte for byte."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.compression import compressed_scatter_gather_allreduce

    model.zero_grad(set_to_none=True)
    bt.lm_loss_fn(model, batch).backward()
    i = len(trainer.plan.buckets) // 2
    flat = trainer.plan.flatten({n: p.grad for n, p in model.named_parameters()})[i]
    got = compressed_scatter_gather_allreduce(trainer.comm, flat).cpu()
    want_flat = compressed_scatter_gather_allreduce(trainer.comm, flat.cpu())
    record["plain_bucket"] = {"index": i, "numel": flat.numel(),
                              "equal": bool(same(got, want_flat))}
    log(f"[rank {rank}] bucket {i} ({flat.numel()} elements) reduced through the "
        f"kernels vs the plain codec: {'equal' if record['plain_bucket']['equal'] else 'DIFFERS'}")
    if not record["plain_bucket"]["equal"]:
        raise AssertionError(f"[rank {rank}] the kernel path's bucket {i} differs from "
                             f"the plain codec's")


def _check_ef_bucket(rank, trainer, state, model, batch, record):
    """The error-feedback step of the largest bucket through the kernels
    against the plain codec, on a fresh local gradient and the run's
    residual: ``c = g + r`` is the same on both sides, so the payload must be
    equal byte for byte and the new residual ``c - decode(encode(c))`` within
    ``EF_BUCKET_RTOL`` of the scale (the scale's sum runs in another order),
    and each side's scale within it of the f64 mean of ``|c|``."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.compression import get_codec

    model.zero_grad(set_to_none=True)
    bt.lm_loss_fn(model, batch).backward()
    buckets = trainer.plan.buckets
    i = max(range(len(buckets)), key=lambda j: buckets[j].padded_numel)
    flat = trainer.plan.flatten({n: p.grad for n, p in model.named_parameters()})[i]
    c = (flat.float() + state.algo_state["ef"]["buckets"][i])[None]
    codec = get_codec("onebit_ef")
    parts, pparts = codec.encode(c), codec.encode(c.cpu())
    res = (c - codec.decode(parts, c.shape[1])).cpu()
    pres = c.cpu() - codec.decode(pparts, c.shape[1])
    scale = pparts[0].item()
    err = (res - pres).abs().max().item() / scale
    exact = c.double().abs().mean().item()
    scale_err = {"kernel": abs(parts[0].item() / exact - 1), "plain": abs(scale / exact - 1)}
    equal = bool(torch.equal(parts[1].cpu(), pparts[1]))
    record["ef_bucket"] = {"index": i, "numel": c.shape[1], "payload_equal": equal,
                           "residual_err_over_scale": err, "scale_err_vs_f64": scale_err}
    log(f"[rank {rank}] bucket {i} ({c.shape[1]} elements) error-feedback step through the "
        f"kernels vs the plain codec: payload {'equal' if equal else 'DIFFERS'}, new "
        f"residual within {err:.3g} of the scale; scale relative error against the f64 "
        f"mean: kernel {scale_err['kernel']:.3g}, plain {scale_err['plain']:.3g}")
    if not (equal and err <= EF_BUCKET_RTOL and max(scale_err.values()) <= EF_BUCKET_RTOL):
        raise AssertionError(f"[rank {rank}] the kernel path's error-feedback step of bucket "
                             f"{i} differs from the plain codec's: {record['ef_bucket']}")


def fingerprints(groups):
    """64-bit fingerprints of lists of f32 flats, computed on their device:
    the sum, wrapping modulo 2^64, of every element's bits times an odd
    pseudo-random 64-bit weight of its index (the same weights on every
    rank, from a seed; made anew each call, so that they hold no memory
    between calls).  Flats that differ in one element always differ here
    (the difference of the bits times an odd weight is not a multiple of
    2^64); more differences collide with a chance of about 2^-64."""
    flats = [f for fl in groups.values() for f in fl]
    g = torch.Generator(device=flats[0].device).manual_seed(7)
    weights = torch.randint(-2 ** 62, 2 ** 62, (max(f.numel() for f in flats),), generator=g,
                            dtype=torch.int64, device=flats[0].device) | 1
    return {key: torch.stack([(f.view(torch.int32).long() * weights[:f.numel()]).sum()
                              for f in fl]).tolist() for key, fl in groups.items()}


def _gossip_trace(trainer, model):
    """``(trace, after_step)``: ``after_step(state)`` appends the
    fingerprints of every bucket flat of the parameters (``params``) and of
    the gossip state (``peer_weights``; ``left``, ``right``, ``self``) to
    ``trace[key]``, one list of buckets a step."""
    trace = {}

    @torch.no_grad()
    def after_step(state):
        flats = {"params": trainer.plan.flatten(dict(model.named_parameters())),
                 **state.algo_state}
        for key, fp in fingerprints(flats).items():
            trace.setdefault(key, []).append(fp)

    return trace, after_step


def _check_lowprec_bucket(rank, trainer, state, model, record):
    """The low-precision ring's compress and decompress through the kernels
    against the plain codec (CPU tensors take it) on the ``diff`` of the
    run's last state, in a bucket of the middle and in the embedding bucket
    (the largest), each one chunk: sidecars, payload bytes and decoded
    values equal."""
    from bagua_tpu_torch.compression import compress_chunked, decompress_chunked

    buckets, st = trainer.plan.buckets, state.algo_state
    with torch.no_grad():
        params = trainer.plan.flatten(dict(model.named_parameters()))
    record["plain_buckets"] = []
    for i in (len(buckets) // 2, max(range(len(buckets)), key=lambda j: buckets[j].padded_numel)):
        diff = params[i] + st["left"][i] / 3.0 + st["right"][i] / 3.0 - (5.0 / 3.0) * st["self"][i]
        got = compress_chunked(diff, 1)
        got = (*got, decompress_chunked(*got))
        want = compress_chunked(diff.cpu(), 1)
        want = (*want, decompress_chunked(*want))
        equal = all(same(a.cpu(), b) for a, b in zip(got, want))
        record["plain_buckets"].append({"index": i, "numel": diff.numel(), "equal": equal})
        log(f"[rank {rank}] bucket {i} ({diff.numel()} elements as one chunk) compressed and "
            f"decoded through the kernels vs the plain codec: {'equal' if equal else 'DIFFERS'}")
        if not equal:
            raise AssertionError(f"[rank {rank}] the kernels' codec of bucket {i}'s diff "
                                 f"differs from the plain codec's")


def _build_run(rank, world, run, device):
    """A run's BERT-Large (or its cut), algorithm, trainer, initial state and
    this rank's batch; returns them with the run's trainer keywords."""
    import bagua_tpu_torch as bt

    name, layers, algo_name, kw = run
    kw = dict(kw)
    lr = kw.pop("lr", 1e-4)
    cfg = bt.bert_large_config(max_seq_len=BERT["s"],
                               **({} if layers is None else {"n_layers": layers}))
    model = bt.TransformerLM(cfg, device=device, seed=0)
    algo = _algorithm(algo_name, lr)
    trainer = bt.BaguaTrainer(bt.lm_loss_fn, _adamw(lr), algo, device=device, **kw)
    state = trainer.init(model)
    # each rank feeds its own slice of one global batch (seed 1)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (world * BERT["b"], cfg.max_seq_len + 1),
                           device=device, generator=g)
    batch = trainer.shard_batch({"tokens": tokens[rank * BERT["b"]:(rank + 1) * BERT["b"]]})
    return cfg, model, algo, trainer, state, batch, kw


def compressed_run(rank, world, run, device, label):
    """One run of a multi-rank slice on this rank; returns its record."""
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa

    name, layers, algo_name, kw = run
    kw = dict(kw)
    steps = kw.pop("steps", STEPS)
    cfg, model, algo, trainer, state, batch, kw = _build_run(
        rank, world, (name, layers, algo_name, kw), device)
    gossip = not algo.replicated_params
    trace, after_step = _gossip_trace(trainer, model) if gossip else (None, None)
    param_fps = []
    if name == "zero":   # the features phase holds its leaf-layout run against these
        def after_step(state):
            param_fps.append(param_fingerprints(trainer, model))
    staged0 = trainer.host_staged_bytes
    losses, launches, st, state = train_steps(trainer, state, batch,
                                              BERT["b"] * cfg.max_seq_len, [fa, cd], after_step,
                                              steps)
    staged = trainer.host_staged_bytes - staged0
    n_buckets = len(trainer.plan.buckets)
    ef = (state.algo_state or {}).get("ef")
    ef = None if ef is None else ef["buckets"]
    opt = state.opt_state.optimizer if algo.sharded_opt_state else state.optimizer
    record = {"name": name, "layers": cfg.n_layers, "buckets": n_buckets,
              "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets),
              "opt_state_bytes": None if opt is None else optimizer_state_bytes(opt),
              "params": sum(p.numel() for p in model.parameters()), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "ef_norm": None if ef is None else sum(r.abs().sum().item() for r in ef),
              "ef_finite": ef is None or all(bool(r.isfinite().all()) for r in ef),
              # the gossip families' ranks differ by design: their own gates
              # read the per-step fingerprints instead
              "digests": None if gossip else _flat_digests(trainer, model),
              "fingerprints": trace, "hierarchical": algo.hierarchical,
              "peer_selection_mode": getattr(algo, "peer_selection_mode", None),
              "param_fingerprints": param_fps}
    record["fwd_bwd_ms"] = fwd_bwd_ms(model, batch)
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{n_buckets} buckets; losses {losses}; residual L1 {record['ef_norm']}")
    want = _want_launches(algo_name, kw, cfg.n_layers, n_buckets, steps)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    if trainer._ef_active() != (ef is not None) or not record["ef_finite"] or \
            (ef is not None and not record["ef_norm"] > 0):
        raise AssertionError(f"[rank {rank}] {name}: the error-feedback residual is "
                             f"{record['ef_norm']} (finite {record['ef_finite']})")
    if name == "bytegrad":
        _check_plain_bucket(rank, trainer, model, batch, record)
        obs_rank_record(rank, trainer, state, batch, record)
    if name == "onebit_ef":
        _check_ef_bucket(rank, trainer, state, model, batch, record)
    if name == "low_precision":
        _check_lowprec_bucket(rank, trainer, state, model, record)
    return record


def obs_rank_record(rank, trainer, state, batch, record):
    """One step more of the run under a ``torch.profiler`` capture, after
    its timed steps and checks: the device attribution of its bucket
    collectives (``attribute_device_comm``), and this rank's span ring dump
    for the timeline (``dump_span_ring``), both into ``record``."""
    from bagua_tpu_torch import profiling
    from bagua_tpu_torch.obs import attribution, timeline

    tmp = tempfile.mkdtemp()
    try:
        with profiling.trace(tmp, steps=1) as holder:
            state, loss = trainer.train_step(state, batch)
            loss.item()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        record["attribution"] = attribution.attribute_device_comm(holder["path"])
        path = timeline.dump_span_ring(os.path.join(tmp, f"spans_rank{rank}.json"), rank=rank)
        with open(path) as f:
            record["span_dump"] = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_slice3_obs(card, runs):
    """Slice 3's ByteGrad ranks (gloo through host memory): every bucket's
    device work attributed to it, transport ``gloo`` (its staging copies)
    beside the codec kernels of its range; the two ranks' span dumps merged
    by ``assemble_timeline`` into a trace ``validate_timeline`` accepts."""
    from bagua_tpu_torch.obs import timeline

    for r, rec in enumerate(runs):
        att = rec["attribution"]
        rows = att.get("per_bucket") or []
        log(f"obs, slice 3 bytegrad rank {r} ({card}): device attribution available "
            f"{att.get('available')}, transport {att.get('transport')}, comm "
            f"{att.get('comm_s_per_step')} s a step, overlap {att.get('overlap_fraction')}; "
            f"{len(rows)} buckets, first {rows[:2]}, last {rows[-1:]}; rationale "
            f"{att.get('rationale') or att.get('per_bucket_rationale')}")
        if not (att.get("available") and att.get("transport") == "gloo"
                and len(rows) == rec["buckets"]
                and all(row["transport"] == "gloo" and row["device_comm_s"] > 0
                        and row["device_codec_s"] > 0 for row in rows)):
            raise AssertionError(f"slice 3 rank {r}: device attribution {att}")
    trace = timeline.assemble_timeline([rec["span_dump"] for rec in runs])
    problems = timeline.validate_timeline(trace)
    meta = trace["metadata"]["ranks"]
    log(f"obs, slice 3 bytegrad: the two ranks' span dumps merged into "
        f"{len(trace['traceEvents'])} trace events; per rank {meta}; problems {problems}")
    if problems or set(meta) != {str(r) for r in range(len(runs))}:
        raise AssertionError(f"slice 3 timeline: {problems}, ranks {set(meta)}")


# ---------------------------------------------------------------------------
# autotune: the trainer's check-in against the sidecar, and the codec flip
# ---------------------------------------------------------------------------


def _plan_hash(trainer) -> str:
    import hashlib

    return hashlib.sha256(repr(trainer.plan.signature()).encode()).hexdigest()[:16]


def _param_digest(model) -> str:
    """sha256 of every parameter's bytes, in name order (plan-independent)."""
    import hashlib

    h = hashlib.sha256()
    with torch.no_grad():
        for n, p in model.named_parameters():
            h.update(n.encode())
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def autotune_loop_run(rank, world, run, device, label):
    """(a) A trainer at autotune level 1 (legacy space) against rank 0's
    sidecar: steps until the first check-in that changes the plan, then
    ``AUTOTUNE_AFTER`` more, checking in every ``AUTOTUNE_EVERY`` steps; each
    check-in step's state is snapshot before the step (the check-in runs at
    its start) while the plan has not changed.
    Then an untuned trainer restored from the last snapshot runs the same
    steps on the same batch."""
    from bagua_tpu_torch import communication

    from bagua_tpu_torch.obs import anomaly

    name, layers, algo_name, kw = run
    # no step-time anomaly detector, and no hints left by the spawn's earlier
    # runs: a window they taint is measured again (gloo through the host
    # varies 2-3x from step to step), which would take the first decision
    # from the second check-in to the fourth
    anomaly.drain_perf_hints()
    os.environ.update(BAGUA_AUTOTUNE_SPACE="legacy", BAGUA_OBS_ANOMALY="off")
    try:
        cfg, model, algo, trainer, state, batch, _ = _build_run(
            rank, world, (name, layers, algo_name,
                          {**kw, "autotune": True, "model_name": AUTOTUNE_MODEL}), device)
    finally:
        os.environ.pop("BAGUA_AUTOTUNE_SPACE", None)
        os.environ.pop("BAGUA_OBS_ANOMALY", None)
    if not trainer.autotune:
        raise AssertionError(f"[rank {rank}] autotune: the registration failed")
    trainer.autotune_checkin_steps = AUTOTUNE_EVERY
    registered = None
    if rank == 0:
        server = communication._AUTOTUNE_SERVER
        if server is None:
            raise AssertionError("rank 0 serves no autotune sidecar")
        registered = [d.name for d in
                      server.RequestHandlerClass.service._task(AUTOTUNE_MODEL).tensor_list]
    buckets_before, first = len(trainer.plan.buckets), _plan_hash(trainer)
    losses, sigs, times, snap, changed_at = [], [], [], None, None
    while len(losses) < AUTOTUNE_MAX_STEPS:
        step = len(losses) + 1
        if step % AUTOTUNE_EVERY == 0 and changed_at is None:
            snap = None
            snap = (step, {k: v.detach().clone() for k, v in model.state_dict().items()},
                    copy.deepcopy(state.optimizer.state_dict()))
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        times.append(time.perf_counter() - t0)
        losses.append(loss.detach())
        sigs.append(_plan_hash(trainer))
        if changed_at is None and sigs[-1] != first:
            changed_at = step
        if changed_at is not None and step >= changed_at + AUTOTUNE_AFTER:
            break
    losses = [x.item() for x in losses]
    if changed_at is None or snap is None:
        raise AssertionError(f"[rank {rank}] autotune: no check-in changed the plan in "
                             f"{len(losses)} steps: {trainer.autotune_checkins}")
    digest = _param_digest(model)
    start, msd, osd = snap
    _, cmodel, _, control, cstate, cbatch, _ = _build_run(rank, world, run, device)
    if control.autotune:
        raise AssertionError("the control trainer is autotuned")
    with torch.no_grad():
        cmodel.load_state_dict(msd)
    cstate.optimizer.load_state_dict(osd)
    del snap, msd, osd
    control_losses = []
    for _ in range(start, len(losses) + 1):
        cstate, loss = control.train_step(cstate, cbatch)
        control_losses.append(loss.item())
    record = {"name": name, "kind": "autotune", "losses": losses,
              "control_losses": control_losses, "control_from": start, "signatures": sigs,
              "changed_at": changed_at, "checkins": trainer.autotune_checkins,
              "buckets_before": buckets_before,
              "buckets_after": len(trainer.plan.buckets), "bucket_bytes": trainer.bucket_bytes,
              "times_ms": [t * 1e3 for t in times], "registered": registered,
              "named_params": [p.name for p in trainer._named_params],
              "digest": digest, "control_digest": _param_digest(cmodel),
              "completed": trainer._autotune_completed}
    log(f"[rank {rank}] autotune: {len(losses)} steps, the plan changed at step {changed_at} "
        f"({buckets_before} -> {record['buckets_after']} buckets of {trainer.bucket_bytes} "
        f"bytes); control from step {start}")
    return record


def codec_flip_run(rank, world, run, device, label):
    """(b) The codec flip through the recommendation path: ``FLIP_STEPS``
    steps at the default policy, with ``compress_intra="onebit_ef"``, with
    ``"off"``; each migration timed (synchronized) and the residual read
    right after it."""
    from bagua_tpu_torch.define import BaguaHyperparameter
    from bagua_tpu_torch.ops import codec as cd

    cfg, model, algo, trainer, state, batch, _ = _build_run(rank, world, run, device)
    steps, migrations = [], []

    def timed_migration(codec, apply_ms):
        pending = trainer._pending_state_migration
        if pending is None:
            raise AssertionError(f"[rank {rank}] compress_intra={codec} queued no migration")

        def migrate(s):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pending(s)
            torch.cuda.synchronize()
            a = out.algo_state if isinstance(out.algo_state, dict) else {}
            ef = a.get("ef")
            rec = {"to": codec, "apply_ms": apply_ms, "ms": (time.perf_counter() - t0) * 1e3,
                   "ef": ef is not None}
            if ef is not None:
                rec.update(zero=all(not bool(r.any()) for r in ef["buckets"]),
                           f32=all(r.dtype == torch.float32 for r in ef["buckets"]),
                           numel=sum(r.numel() for r in ef["buckets"]),
                           bytes=sum(r.numel() * r.element_size() for r in ef["buckets"]))
            migrations.append(rec)
            return out

        trainer._pending_state_migration = migrate

    for codec, n in zip((None, "onebit_ef", "off"), FLIP_STEPS):
        if codec is not None:
            t0 = time.perf_counter()
            trainer._apply_recommendation(BaguaHyperparameter(compress_intra=codec))
            timed_migration(codec, (time.perf_counter() - t0) * 1e3)
        for _ in range(n):
            cd.reset_launch_counts()
            staged0 = trainer.host_staged_bytes
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, batch)
            value = loss.item()
            ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            a = state.algo_state if isinstance(state.algo_state, dict) else {}
            steps.append({"codec": codec or "default", "loss": value, "ms": ms,
                          "staged": trainer.host_staged_bytes - staged0,
                          "k4": cd.sign_compress_chunked.launches,
                          "k5": cd.sign_decompress_chunked.launches,
                          "ef": "ef" in a, "mem": torch.cuda.memory_allocated(),
                          "digests": _flat_digests(trainer, model)})
    record = {"name": run[0], "kind": "autotune", "steps": steps, "migrations": migrations,
              "buckets": len(trainer.plan.buckets),
              "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets)}
    log(f"[rank {rank}] codec flip: losses {[s['loss'] for s in steps]}; migrations "
        f"{[(m['to'], round(m['ms'], 3)) for m in migrations]}")
    return record


def autotune_run(rank, world, run, device, label):
    return {"autotune_loop": autotune_loop_run, "codec_flip": codec_flip_run}[run[0]](
        rank, world, run, device, label)


def check_autotune(card, runs, onebit):
    """The autotune phase's gates across the ranks (see the module
    docstring, item 15); ``onebit`` is slice 4's 1-bit run on the cut."""
    loop, flip = runs["autotune_loop"], runs["codec_flip"]
    r0 = loop[0]
    if sorted(r0["registered"] or []) != sorted(r0["named_params"]):
        raise AssertionError(f"autotune: the service's task holds {r0['registered']}, "
                             f"the cut has {r0['named_params']}")
    for r, rec in enumerate(loop):
        if not rec["checkins"] or not all(c["speed"] > 0 for c in rec["checkins"]):
            raise AssertionError(f"autotune rank {r}: check-ins {rec['checkins']}")
        start = rec["control_from"]
        if rec["losses"][start - 1:] != rec["control_losses"]:
            raise AssertionError(f"autotune rank {r}: losses from step {start} "
                                 f"{rec['losses'][start - 1:]} against the control's "
                                 f"{rec['control_losses']}")
        if rec["digest"] != rec["control_digest"]:
            raise AssertionError(f"autotune rank {r}: parameters differ from the control's")
    for key in ("signatures", "losses", "digest", "changed_at"):
        if loop[1][key] != r0[key]:
            raise AssertionError(f"autotune: {key} differ between the ranks")
    times = r0["times_ms"]
    at = r0["changed_at"]
    med = statistics.median(times)
    for r, rec in enumerate(loop):
        for c in rec["checkins"]:
            log(f"autotune rank {r} ({card}): check-in at step {c['step']}: speed "
                f"{c['speed']:.3f} samples/s, sync {c['sync_ms']:.3f} ms, report "
                f"{c['report_ms']:.3f} ms, ask {c['ask_ms']:.3f} ms, apply {c['apply_ms']:.3f} ms, "
                f"{c['buckets']} buckets after, completed {c['completed']}")
    log(f"autotune ({card}): {len(times)} steps on both ranks, plan signature equal at every "
        f"step; changed at step {at}: {r0['buckets_before']} -> {r0['buckets_after']} buckets "
        f"({r0['bucket_bytes']} bytes); that step {times[at - 1]:.3f} ms, the next "
        f"{times[at]:.3f} ms, median {med:.3f} ms; losses bitwise the untuned control's from "
        f"step {r0['control_from']} ({len(r0['control_losses'])} steps), parameters bitwise "
        f"equal on the ranks and to the control's")
    per_step = {k: onebit[0]["launches"][k] / len(onebit[0]["losses"])
                for k in ("sign_compress_chunked", "sign_decompress_chunked")}
    onebit_staged = onebit[0]["host_staged_bytes"] / len(onebit[0]["losses"])
    for r, rec in enumerate(flip):
        steps, migs = rec["steps"], rec["migrations"]
        on = [s for s in steps if s["codec"] == "onebit_ef"]
        before = [s for s in steps if s["codec"] == "default"]
        after = [s for s in steps if s["codec"] == "off"]
        add, drop = migs
        if not (add["ef"] and add["zero"] and add["f32"] and add["numel"] == rec["padded_numel"]):
            raise AssertionError(f"codec flip rank {r}: the residual at the flip {add}")
        if any(s["k4"] != per_step["sign_compress_chunked"]
               or s["k5"] != per_step["sign_decompress_chunked"] for s in on):
            raise AssertionError(f"codec flip rank {r}: K4/K5 a step "
                                 f"{[(s['k4'], s['k5']) for s in on]}, slice 4's {per_step}")
        if any(s["k4"] or s["k5"] for s in before + after):
            raise AssertionError(f"codec flip rank {r}: K4/K5 outside the 1-bit steps")
        if any(s["staged"] != onebit_staged for s in on):
            raise AssertionError(f"codec flip rank {r}: staged {[s['staged'] for s in on]} a "
                                 f"1-bit step, slice 4's {onebit_staged}")
        if any(s["staged"] != before[0]["staged"] for s in before + after):
            raise AssertionError(f"codec flip rank {r}: f32 steps staged "
                                 f"{[s['staged'] for s in before + after]}")
        fell = on[-1]["mem"] - after[0]["mem"]
        if drop["ef"] or after[0]["ef"] or abs(fell - add["bytes"]) > FLIP_MEM_RTOL * add["bytes"]:
            raise AssertionError(f"codec flip rank {r}: after the flip back the residual "
                                 f"{drop}, allocated fell {fell} bytes, residual {add['bytes']}")
    for i in range(len(flip[0]["steps"])):
        if flip[1]["steps"][i]["digests"] != flip[0]["steps"][i]["digests"]:
            raise AssertionError(f"codec flip: parameters differ between the ranks at step "
                                 f"{i + 1}")
    rec = flip[0]
    steps, (add, drop) = rec["steps"], rec["migrations"]
    fell = steps[sum(FLIP_STEPS[:2]) - 1]["mem"] - steps[sum(FLIP_STEPS[:2])]["mem"]
    log(f"codec flip ({card}, rank 0): apply {add['apply_ms']:.3f} ms, migration to onebit_ef "
        f"{add['ms']:.3f} ms (zero-filled residual of {add['numel']} f32, {add['bytes']} bytes, "
        f"{rec['buckets']} buckets); apply {drop['apply_ms']:.3f} ms, migration back "
        f"{drop['ms']:.3f} ms, allocated fell {fell} bytes; staged a step {[s['staged'] for s in steps]}; K4/K5 a step "
        f"{[(s['k4'], s['k5']) for s in steps]}; step ms {[round(s['ms'], 3) for s in steps]}; "
        f"losses {[s['loss'] for s in steps]}; parameters bitwise equal on the ranks at every "
        f"step")


def async_run(rank, world, run, device, label):
    """One run of the async phase on this rank; returns its record.  After
    every step (outside the step times) it records the rounds launched and
    applied, the catch-ups, the negotiated status and how long the step's
    apply waited for its round (``async/round_wait_s``); rank 0 aborts and
    rank 1 resumes in the abort run, and ``async.partition`` is armed on
    rank 1 alone in the partition run.  After the window: each bucket's
    digest, the algorithm's ``barrier``, a timed round alone (every
    bucket's sum started at once and waited for, nothing else running), a
    timed ``sync_for_checkpoint`` (one blocking average of every bucket) and
    the digests again; the ranks pass a barrier before each timing.  Each
    catch-up of the staleness bound records the digests right after it."""
    import contextlib

    from bagua_tpu_torch.communication import barrier
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.telemetry import counters

    name, _, algo_name, _ = run
    cfg, model, algo, trainer, state, batch, kw = _build_run(rank, world, run, device)
    per_step = {k: [] for k in ("launched", "applied", "catchups", "status", "wait_s")}
    catchups = []
    catchup_sync = algo._catchup_sync

    def spy(tr, step, reason):
        catchup_sync(tr, step, reason)
        # the checkpoint's catch-up is timed below, and its digests follow it
        catchups.append({"step": step, "reason": reason, "digests": (
            _flat_digests(trainer, model) if reason == "staleness" else None)})

    algo._catchup_sync = spy
    waited = [counters.get("async/round_wait_s")]

    def after_step(state):
        step = len(per_step["status"]) + 1
        per_step["launched"].append(algo._rounds_launched)
        per_step["applied"].append(algo._rounds_applied)
        per_step["catchups"].append(len(catchups))
        per_step["status"].append(algo._status)
        wait = counters.get("async/round_wait_s")
        per_step["wait_s"].append(wait - waited[0])
        waited[0] = wait
        if name == "async_abort" and rank == 0 and step == ASYNC_ABORT_AFTER:
            algo.abort()
        if name == "async_abort" and rank == 1 and step == ASYNC_RESUME_AFTER:
            algo.resume()

    scope = (fault_scope(FaultSpec("async.partition", count=-1))
             if name == "async_partition" and rank == 1 else contextlib.nullcontext())
    staged0 = trainer.host_staged_bytes
    with scope:
        losses, launches, st, state = train_steps(
            trainer, state, batch, BERT["b"] * cfg.max_seq_len, [fa, cd], after_step)
    staged = trainer.host_staged_bytes - staged0
    n_buckets = len(trainer.plan.buckets)
    padded_numel = sum(b.padded_numel for b in trainer.plan.buckets)
    digests_window = _flat_digests(trainer, model)
    algo.barrier(trainer, state)
    # a round alone: the sum of every bucket's copy started at once, as a
    # launch does, and waited for at once, nothing else running
    with torch.no_grad():
        flats = trainer.plan.flatten(trainer._params)
    barrier()   # the ranks start each timed average together
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for work in [algo._avg_comm.allreduce_start(f) for f in flats]:
        work.wait()
    torch.cuda.synchronize(device)
    round_ms = (time.perf_counter() - t0) * 1e3
    del flats
    barrier()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    algo.sync_for_checkpoint(trainer, state)
    torch.cuda.synchronize(device)
    sync_ms = (time.perf_counter() - t0) * 1e3
    record = {"name": name, "layers": cfg.n_layers, "buckets": n_buckets,
              "padded_numel": padded_numel, "params": sum(p.numel() for p in model.parameters()),
              "opt_state_bytes": optimizer_state_bytes(state.optimizer), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "warmup_steps": algo.warmup_steps, "per_step": per_step, "catchups": catchups,
              "period": algo._period, "agreed_dt": algo._agreed_dt,
              "max_staleness_rounds": algo.max_staleness_rounds, "sync_ms": sync_ms,
              "round_ms": round_ms,
              "digests_window": digests_window, "digests": _flat_digests(trainer, model),
              "fingerprints": None, "fwd_bwd_ms": fwd_bwd_ms(model, batch)}
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{n_buckets} buckets; losses {losses}; per step {per_step}")
    want = _want_launches(algo_name, kw, cfg.n_layers, n_buckets)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    return record


def param_fingerprints(trainer, model, chunk=1 << 22):
    """One 64-bit fingerprint a bucket of the parameters, whatever their
    layout: the sum, wrapping modulo 2^64, over the bucket's tensors of each
    element's f32 bits times an odd pseudo-random weight drawn from the
    tensor's name and the element's index, in chunks of ``chunk`` elements
    (so that it holds no copy of a bucket; computed on the tensors'
    device).  A difference in one element always shows (as in
    :func:`fingerprints`)."""
    import zlib

    params = dict(model.named_parameters())
    out = []
    with torch.no_grad():
        for b in trainer.plan.buckets:
            total = torch.zeros((), dtype=torch.int64, device=params[b.tensors[0].name].device)
            for t in b.tensors:
                flat = params[t.name].detach().reshape(-1).view(torch.int32)
                for c, start in enumerate(range(0, flat.numel(), chunk)):
                    part = flat[start:start + chunk]
                    g = torch.Generator(device=part.device).manual_seed(
                        zlib.crc32(t.name.encode()) * 1009 + c)
                    w = torch.randint(-2 ** 62, 2 ** 62, (part.numel(),), generator=g,
                                      dtype=torch.int64, device=part.device) | 1
                    total += (part.long() * w).sum()
            out.append(total.item())
    return out


def features_run(rank, world, run, device, label):
    """One run of the features phase on this rank (``FEATURES_RUNS``);
    returns its record.  After every step (outside the step times) it takes
    the guard's verdict, the parameters' fingerprints (``zero_leaf``) and
    the rebucket (after step ``REBUCKET_AFTER``).  The cut's runs keep their
    final parameters (and residual) in this process, so that the later runs
    are compared with them here: ``onebit_clean_again`` and
    ``onebit_poison`` with ``onebit_clean``, ``rebucket`` with
    ``no_rebucket``.  ``accum_guard`` times the guard's own work (the
    verdict on the reduced gradient flats and its host read) after the
    run."""
    import contextlib

    from bagua_tpu_torch.bucket import split_bucket_by_bucket_size
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.telemetry import counters

    name, layers, algo_name, kw = run
    kw = dict(kw)
    steps, poison = kw.pop("steps", STEPS), kw.pop("poison", None)
    rebucket = kw.pop("rebucket", False)
    cfg, model, algo, trainer, state, batch, kw = _build_run(
        rank, world, (name, layers, algo_name, kw), device)
    healthy, param_fps, buckets_per_step = [], [], []

    def after_step(state):
        buckets_per_step.append(len(trainer.plan.buckets))
        if trainer.grad_guard != "off":
            healthy.append(trainer.step_metrics["grad_healthy"].item())
        if name == "zero_leaf":
            param_fps.append(param_fingerprints(trainer, model))
        if rebucket and len(buckets_per_step) == REBUCKET_AFTER:
            decls = [t.declaration() for b in trainer.plan.buckets for t in b.tensors]
            trainer.rebucket(split_bucket_by_bucket_size(decls, REBUCKET_BYTES))

    scope = (fault_scope(FaultSpec("grad.poison", step=poison)) if poison is not None
             else contextlib.nullcontext())
    before = counters.snapshot()
    staged0 = trainer.host_staged_bytes
    with scope:
        losses, launches, st, state = train_steps(
            trainer, state, batch, BERT["b"] * cfg.max_seq_len, [fa, cd], after_step, steps)
        trainer.flush_grad_health()
    staged = trainer.host_staged_bytes - staged0
    guard_ms = None
    if name == "accum_guard":
        # the guard's own work on the last step's reduced gradient flats,
        # both ranks at once after a barrier, as in a step
        grads = trainer._stage_grads()
        times = []
        for _ in range(5):
            torch.distributed.barrier()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            trainer._healthy(trainer._grad_health_vec(grads))
            times.append(time.perf_counter() - t0)
        guard_ms = statistics.median(times) * 1e3
        del grads
    ef = (state.algo_state or {}).get("ef")
    ef = None if ef is None else list(ef["buckets"])
    opt = state.opt_state.optimizer if algo.sharded_opt_state else state.optimizer
    record = {"name": name, "layers": cfg.n_layers, "buckets": len(trainer.plan.buckets),
              "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets),
              "opt_state_bytes": optimizer_state_bytes(opt),
              "params": sum(p.numel() for p in model.parameters()), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "digests": _flat_digests(trainer, model), "fingerprints": None,
              "healthy": healthy, "param_fingerprints": param_fps,
              "counters": {k: counters.get(k) - before.get(k, 0) for k in (
                  "grad_guard/skipped_steps", "grad_guard/unhealthy_steps",
                  "faults/grad.poison/fired")},
              "ef_sizes": None if ef is None else [r.numel() for r in ef],
              "ef_finite": ef is None or all(bool(r.isfinite().all()) for r in ef),
              "ef_norm": None if ef is None else sum(r.abs().sum().item() for r in ef),
              "plan_sizes": [b.padded_numel for b in trainer.plan.buckets],
              "guard_ms": guard_ms}
    if rebucket and trainer._flat_resident:
        # AdamW's state is keyed by the new plan's flats and shaped like them
        group = opt.param_groups[0]["params"]
        record["opt_on_new_plan"] = (
            len(group) == len(trainer._flats)
            and all(a is b for a, b in zip(group, trainer._flats))
            and all(opt.state[f]["exp_avg"].shape == opt.state[f]["exp_avg_sq"].shape
                    == (b.padded_numel,) for f, b in zip(trainer._flats, trainer.plan.buckets)))
    keep = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    keep_ef = None if ef is None else [r.cpu() for r in ef]
    against = {"onebit_clean_again": "onebit_clean", "onebit_poison": "onebit_clean",
               "rebucket": "no_rebucket"}.get(name)
    if against is not None:
        other, other_ef = _FEATURES_KEPT[against]
        diff = max((keep[n] - other[n]).abs().max().item() for n in keep)
        record["against"] = {
            "run": against, "params_equal": all(torch.equal(keep[n], other[n]) for n in keep),
            "params_max_abs": diff,
            "ef_equal": None if keep_ef is None else all(
                torch.equal(a, b) for a, b in zip(keep_ef, other_ef)),
            "ef_max_abs": None if keep_ef is None else max(
                (a - b).abs().max().item() for a, b in zip(keep_ef, other_ef))}
    _FEATURES_KEPT[name] = (keep, keep_ef)
    record["fwd_bwd_ms"] = fwd_bwd_ms(model, batch)
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{record['buckets']} buckets ({st['layout']} layout); losses {losses}; healthy "
        f"{healthy}; counters {record['counters']}; against {record.get('against')}")
    accum = trainer.accum_steps
    want = {k.__name__: 0 for k in cd.KERNELS}
    want.update({k: cfg.n_layers * steps * accum
                 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
    if kw.get("compress_intra") == "onebit_ef":
        # the error-feedback step and the ring at n = 2: 3 K4 and 3 K5 a
        # bucket and step, on the plan each step ran
        want["sign_compress_chunked"] = want["sign_decompress_chunked"] = 3 * sum(
            buckets_per_step)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    return record


#: a features run's final parameters and residual on the host, by run name,
#: for the runs after it in the same rank process
_FEATURES_KEPT = {}
#: an overlap run's plan (its buckets' tensor names) by run name, for the
#: serialized run held against it on the same plan
_OVERLAP_PLANS = {}


def _stage_timers(trainer):
    """Host milliseconds of each step's backward (to the end of the main
    stream's work) and of its communication stage: ``process_grads``
    (serialized), or the main thread's wait for the buckets after the
    backward (overlapped), each to the end of the main stream's work, which
    then follows the comm stream's.  Wraps the trainer's own methods."""
    times = {"backward_ms": [], "comm_ms": []}

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.current_stream().synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    trainer._forward_backward = timed("backward_ms", trainer._forward_backward)
    if trainer._ctx.overlap:
        trainer._wait_overlap = timed("comm_ms", trainer._wait_overlap)
    else:
        algo = trainer.algorithm
        algo.process_grads = timed("comm_ms", functools.partial(type(algo).process_grads, algo))
    return times


def _tap_launches(taps):
    """Record every kernel launch as (launcher, stream handle, thread name);
    returns the undo."""
    import threading

    from bagua_tpu_torch.ops import _build

    orig = _build.launch

    def launch(fn, *args):
        taps.append((fn.__name__, torch.cuda.current_stream().cuda_stream,
                     threading.current_thread().name))
        return orig(fn, *args)

    _build.launch = launch
    return lambda: setattr(_build, "launch", orig)


def _capture(obj, attr, armed, store):
    """Wrap ``obj.attr`` so that its first call while ``armed()`` stores
    copies of its tensor arguments and outputs in ``store`` (on the calling
    stream, after the call); returns the undo."""
    orig, own = getattr(obj, attr), attr in vars(obj)

    def wrapper(*args):
        out = orig(*args)
        if armed() and not store:
            outs = out if isinstance(out, tuple) else (out,)
            store["args"] = [a.detach().clone() if torch.is_tensor(a) else a for a in args]
            store["outs"] = [o.detach().clone() for o in outs]
        return out

    setattr(obj, attr, wrapper)
    return lambda: setattr(obj, attr, orig) if own else delattr(obj, attr)


def _captured_against_plain(store, fn, label, rank, scale_rtol=None):
    """The captured kernel call's outputs against ``fn`` on the captured
    inputs moved to the host (the plain version): byte for byte, except a
    first output (K4's scale, a sum in another order) within ``scale_rtol``
    where given."""
    torch.cuda.synchronize()
    if not store:
        raise AssertionError(f"[rank {rank}] {label}: no call was captured in the run")
    args = [a.cpu() if torch.is_tensor(a) else a for a in store["args"]]
    want = fn(*args)
    want = want if isinstance(want, tuple) else (want,)
    got = [g.cpu() for g in store["outs"]]
    checks = [same(g, w) for g, w in zip(got, want)]
    scale_err = None
    if scale_rtol is not None:
        scale_err = ((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-30)).max().item()
        checks[0] = scale_err <= scale_rtol
    equal = len(want) == len(got) and all(checks)
    numel = store["args"][0].numel()
    log(f"[rank {rank}] {label}: a call of {numel} elements from the run, through the "
        f"kernels vs plain: {'equal' if equal else 'DIFFERS'} (outputs {checks}"
        + (f", scale within {scale_err:.3g} relative)" if scale_err is not None else ")"))
    if not equal:
        raise AssertionError(f"[rank {rank}] {label}: the kernels' output differs from plain")
    return {"numel": numel, "equal": equal, "scale_err": scale_err}


def k1_beside_backward(trainer, state, batch):
    """One more ByteGrad step under a profiler window: K1's launches on the
    comm stream against the flash backward kernels on the main stream, as
    device intervals: how many K1 ran while a K6b or K6c kernel did, and
    while any kernel of another stream did, K1's device ms, and the span of
    the backward's flash kernels.  The step's state is dropped."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _, loss = trainer.train_step(state, batch)
        loss.item()
        torch.cuda.synchronize()
    k1, bwd, other = [], [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("Mem"):
            continue
        span = (e.time_range.start, e.time_range.end)
        if "minmax_compress" in e.name:
            k1.append(span)
            k1_stream = e.device_resource_id
            continue
        other.append((span, e.device_resource_id))
        m = KERNEL_NAMES.search(e.name)
        if m and m.group(1) in ("dkv", "dq"):
            bwd.append(span)
    beside = sum(any(s < be and bs < e for bs, be in bwd) for s, e in k1)
    # any kernel of another stream (the backward's GEMMs and elementwise work)
    beside_any = sum(any(s < be and bs < e for (bs, be), sid in other if sid != k1_stream)
                     for s, e in k1) if k1 else 0
    first_k1 = min(s for s, _ in k1) if k1 else None
    return {"k1_launches": len(k1), "k1_beside_backward": beside,
            "k1_beside_any_other_stream": beside_any,
            "k1_ms": sum(e - s for s, e in k1) / 1e3,
            "k1_median_us": statistics.median(e - s for s, e in k1) if k1 else None,
            "backward_kernels": len(bwd),
            "backward_span_ms": (max(e for _, e in bwd) - min(s for s, _ in bwd)) / 1e3
            if bwd else None,
            "k1_before_backward_end": sum(s < max(e for _, e in bwd) for s, _ in k1)
            if bwd else None,
            "first_k1_after_backward_start_ms": (first_k1 - min(s for s, _ in bwd)) / 1e3
            if bwd and k1 else None}


def _ring_ks(trainer):
    """The sub-rings of each bucket's allreduce under the trainer's plan."""
    ctx = trainer._ctx
    return [ctx._ring_chunks(b.padded_numel, b.dtype.itemsize) for b in trainer.plan.buckets]


def overlap_run(rank, world, run, device, label):
    """One run of the overlap phase on this rank (``OVERLAP_RUNS``);
    returns its record: the losses, launches and statistics, the per-step
    parameter fingerprints, the backward's and the communication's times a
    step (``_stage_timers``), the stream and thread of every codec launch,
    and the checks of the kernels' output from the run against plain."""
    import threading

    from bagua_tpu_torch.bucket import split_bucket_by_bucket_size
    from bagua_tpu_torch.compression import get_codec, minmax_uint8
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa

    name, layers, algo_name, kw = run
    if algo_name == "eager":
        return eager_checks(rank, world, device, label)
    kw = dict(kw)
    steps, plan_of = kw.pop("steps", STEPS), kw.pop("plan_of", None)
    cfg, model, algo, trainer, state, batch, kw = _build_run(
        rank, world, (name, layers, algo_name, kw), device)
    times = _stage_timers(trainer)
    param_fps, buckets_per_step, ks_per_step = [], [], [_ring_ks(trainer)]
    plan_names = None if plan_of is None else _OVERLAP_PLANS[plan_of]

    def after_step(state):
        buckets_per_step.append(len(trainer.plan.buckets))
        param_fps.append(param_fingerprints(trainer, model))
        if plan_names is not None and len(buckets_per_step) == 1:
            decls = {p.name: p.declaration() for p in trainer._named_params}
            trainer.rebucket([[decls[n] for n in b] for b in plan_names])
        ks_per_step.append(_ring_ks(trainer))

    last = {"step": False}
    store, undo = {}, []
    if name == "bytegrad_overlap":
        # one real bucket's K1 call of the last step, from the comm stream
        undo.append(_capture(minmax_uint8, "compress_chunked", lambda: last["step"], store))
    codec_name = kw.get("compress_intra")
    if codec_name is not None:
        # the first encode of the last step on the comm worker: a sub-ring's
        # (the error-feedback step encodes whole buckets on the backward's)
        undo.append(_capture(get_codec(codec_name), "encode", lambda: last["step"] and (
            threading.current_thread().name == "bagua-comm-worker"), store))
    taps = []
    undo.append(_tap_launches(taps))

    def arm_last(state):
        after_step(state)
        last["step"] = len(buckets_per_step) == steps - 1

    staged0 = trainer.host_staged_bytes
    try:
        losses, launches, st, state = train_steps(
            trainer, state, batch, BERT["b"] * cfg.max_seq_len, [fa, cd], arm_last, steps)
    finally:
        for u in undo:
            u()
    staged = trainer.host_staged_bytes - staged0
    times = {k: list(v) for k, v in times.items()}   # the run's steps alone
    overlapped = trainer._ctx.overlap
    worker = trainer._worker
    comm_stream = None if worker is None or worker.stream is None else worker.stream.cuda_stream
    codec_taps = {}
    for fn_name, stream, thread in taps:
        if fn_name.startswith(("bagua_minmax", "bagua_absmax", "bagua_sign")):
            where = ("comm stream" if stream == comm_stream else "other stream") + \
                f", {'comm worker' if thread == 'bagua-comm-worker' else 'thread ' + thread}"
            codec_taps.setdefault(fn_name, {}).setdefault(where, 0)
            codec_taps[fn_name][where] += 1
    opt = state.opt_state.optimizer if algo.sharded_opt_state else state.optimizer
    record = {"name": name, "layers": cfg.n_layers, "buckets": len(trainer.plan.buckets),
              "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets),
              "opt_state_bytes": optimizer_state_bytes(opt),
              "params": sum(p.numel() for p in model.parameters()), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "digests": _flat_digests(trainer, model), "fingerprints": None,
              "param_fingerprints": param_fps, "overlap": overlapped,
              "times": times, "codec_launches": codec_taps,
              "plan_sizes": [b.padded_numel for b in trainer.plan.buckets],
              "buckets_per_step": buckets_per_step, "ks_per_step": ks_per_step[:steps],
              "threads": sorted({t.name for t in threading.enumerate()})}
    if overlapped:
        _OVERLAP_PLANS[name] = [[t.name for t in b.tensors] for b in trainer.plan.buckets]
    if name == "bytegrad_overlap":
        record["k1_payload"] = _captured_against_plain(
            store, lambda x, n: cd.compress_chunked(x, n), "ByteGrad's K1 in the overlapped "
            "step", rank)
        record["k1_beside_backward"] = (k1_beside_backward(trainer, state, batch)
                                        if device.type == "cuda" else None)
        log(f"[rank {rank}] {label} {name}: K1 beside the backward: "
            f"{record['k1_beside_backward']}")
    if codec_name is not None:
        record["sub_chunk"] = _captured_against_plain(
            store, get_codec(codec_name).encode, f"the {codec_name} ring's first encode of "
            "the last step on the comm worker (a real sub-chunk)", rank,
            SIGN_RTOL if codec_name == "onebit_ef" else None)
    record["fwd_bwd_ms"] = fwd_bwd_ms(model, batch)
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{record['buckets']} buckets (per step {buckets_per_step}), overlap {overlapped}; "
        f"losses {losses}; backward ms {[round(t, 3) for t in times['backward_ms']]}; "
        f"communication ms {[round(t, 3) for t in times['comm_ms']]}; codec launches "
        f"{codec_taps}")
    accum = trainer.accum_steps
    want = {k.__name__: 0 for k in cd.KERNELS}
    want.update({k: cfg.n_layers * steps * accum
                 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
    # each step on the plan it ran: the first on the initial one, a readiness
    # rebucket after it
    ks = ks_per_step[:steps]
    if algo_name == "bytegrad":
        want["compress_chunked"] = sum(len(k) for k in ks)
        want["decompress_chunked"] = 2 * sum(len(k) for k in ks)
    if codec_name == "int8":
        # one encode on the reduce-scatter hop, one on the gather, a sub-ring
        want["absmax_chunked"] = 2 * sum(sum(k) for k in ks)
    if codec_name == "onebit_ef":
        # the error-feedback step of each bucket, then 2 encodes and 2
        # decodes a sub-ring
        want["sign_compress_chunked"] = want["sign_decompress_chunked"] = sum(
            len(k) + 2 * sum(k) for k in ks)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    if name == "bytegrad_overlap":
        # after every read of the run: extra steps move none of its gates
        record["trace_overlap"] = overlap_trace(rank, trainer, state, batch, device)
    return record


#: steps of the overlapped ByteGrad run under ``profiling.trace_overlap``
TRACE_OVERLAP_STEPS = 3


def overlap_trace(rank, trainer, state, batch, device):
    """``TRACE_OVERLAP_STEPS`` more steps of the run, on rank 0 under
    ``profiling.trace_overlap`` (the other ranks step alike, untraced);
    returns rank 0's overlap fields."""
    from bagua_tpu_torch import profiling

    box = {"state": state}

    def step():
        box["state"], _ = trainer.train_step(box["state"], batch)

    t0 = time.perf_counter()
    if rank == 0 and device.type == "cuda":
        out = profiling.trace_overlap(step, steps=TRACE_OVERLAP_STEPS)
    else:
        for _ in range(TRACE_OVERLAP_STEPS):
            step()
        out = None
    return {"fields": out, "seconds": time.perf_counter() - t0}


def check_trace_overlap(card, rec):
    """``trace_overlap``'s fields of the overlapped ByteGrad run: non-empty,
    communication on the device, a bounded overlap fraction."""
    out = rec["trace_overlap"]["fields"] or {}
    GROUP_SECONDS["records"]["trace_overlap"] = rec["trace_overlap"]["seconds"]
    log(f"records: trace_overlap over {TRACE_OVERLAP_STEPS} steps of the overlapped ByteGrad "
        f"run on rank 0 ({card}), {rec['trace_overlap']['seconds']:.1f} s: {out}")
    if not (out and out["comm_s_per_step"] > 0 and 0.0 <= out["overlap_fraction"] <= 1.0):
        raise AssertionError(f"records: trace_overlap returned {out}")


def eager_checks(rank, world, device, label, comm=None):
    """Every eager collective of ``bagua_tpu_torch`` on card tensors, each
    against a plain torch computation on every rank's inputs (drawn from one
    seed on the host, so that each rank knows them all): exact, since two
    ranks' sums take either order exactly.  Then an abort makes a dispatch
    raise, and a reset lets the next one through.  Returns the record."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.communication import BaguaAborted

    g = torch.Generator().manual_seed(11)
    xs = torch.randn((world, 4 * world, 6), generator=g)
    mine = xs[rank].to(device)
    blocks = xs.reshape(world, world, 4, 6)   # [src, dst, rows, 6]
    # ragged counts: rank s sends (s + d) % 3 + 1 rows to rank d
    counts = [[(s + d) % 3 + 1 for d in range(world)] for s in range(world)]
    need = max(sum(counts[s][d] for s in range(world)) for d in range(world))
    ragged_want = torch.zeros((need, 6))
    pos = 0
    for s in range(world):
        start = sum(counts[s][:rank])
        ragged_want[pos:pos + counts[s][rank]] = xs[s][start:start + counts[s][rank]]
        pos += counts[s][rank]
    inplace = mine.clone()
    got = {
        "allreduce_avg": (bt.allreduce(mine), xs.sum(0) / world),
        "allreduce_inplace_sum": (bt.allreduce_inplace(inplace, bt.ReduceOp.SUM), xs.sum(0)),
        "allgather": (bt.allgather(mine), xs.reshape(-1, 6)),
        "reduce_scatter_sum": (bt.reduce_scatter(mine, bt.ReduceOp.SUM),
                               xs.sum(0).reshape(world, 4, 6)[rank]),
        "alltoall": (bt.alltoall(mine), blocks[:, rank].reshape(-1, 6)),
        "alltoall_v": (bt.alltoall_v(mine, counts), ragged_want),
        "broadcast": (bt.broadcast(mine, src=world - 1), xs[world - 1]),
        "reduce_max": (bt.reduce(mine, dst=0, op=bt.ReduceOp.MAX),
                       xs.max(0).values if rank == 0 else torch.zeros_like(xs[0])),
        "gather": (bt.gather(mine, dst=world - 1),
                   xs.reshape(-1, 6) if rank == world - 1 else torch.zeros(4 * world * world, 6)),
        "scatter": (bt.scatter(mine, src=0), xs[0].reshape(world, 4, 6)[rank]),
        "send_recv": (bt.send_recv(mine, [(i, (i + 1) % world) for i in range(world)]),
                      xs[(rank - 1) % world]),
    }
    results = {op: bool(g.device.type == device.type and same(g.cpu(), w))
               for op, (g, w) in got.items()}
    results["allreduce_inplace_in_place"] = got["allreduce_inplace_sum"][0] is inplace
    bt.abort("chip smoke: an eager dispatch after an abort")
    try:
        bt.allreduce(mine)
        results["refused_after_abort"] = False
    except BaguaAborted:
        results["refused_after_abort"] = True
    finally:
        bt.reset_abort()
    results["after_reset"] = bool(same(bt.allreduce(mine).cpu(), xs.sum(0) / world))
    backend = torch.distributed.get_backend()
    log(f"[rank {rank}] {label} eager collectives at world {world} over {backend} on card "
        f"tensors against plain torch: {results}")
    if not all(results.values()):
        raise AssertionError(f"[rank {rank}] eager collectives: {results}")
    return {"name": "eager", "kind": "eager", "results": results, "backend": backend}


# ---------------------------------------------------------------------------
# checkpoint: save, restore and resume around the kernels
# ---------------------------------------------------------------------------

#: steps of a checkpoint run, and the step its save follows
CKPT_STEPS, CKPT_SAVE_AT = 4, 2
#: the multi-rank checkpoint runs at world 2, on the 4-layer cut (the full
#: BERT-Large's 7.5 GB saves and 14 s restores leave the script too close to
#: its time limit): (b) the 1-bit ring (K4, K5) with its residual, its newest
#: save corrupted on rank 1; (c) ZeRO, the low-precision ring (K1, K2) with
#: its replicas, async model average after ``sync_for_checkpoint``, and a flat
#: GradientAllReduce checkpoint restored into a leaf trainer
CKPT_RUNS = (
    ("ckpt_onebit", BERT["cut_layers"], "gradient_allreduce", {"compress_intra": "onebit_ef"}),
    ("ckpt_zero", BERT["cut_layers"], "zero", {}),
    ("ckpt_lowprec", BERT["cut_layers"], "low_precision", {}),
    ("ckpt_async", BERT["cut_layers"], "async_ckpt", {}),
    ("ckpt_flat_to_leaf", BERT["cut_layers"], "gradient_allreduce", {}),
)
MULTI_RANK["checkpoint"] = ("checkpoint", CKPT_RUNS, CODEC_WORLD, None)
#: where this process's checkpoint runs write: a directory under the phase's
#: temporary directory, deleted when the phase ends
_CKPT_DIR = {}


def state_digest(trainer, state) -> str:
    """sha256 of everything a checkpoint of ``state`` holds: parameters,
    optimizer state, the algorithm's optimizer and algorithm state, step."""
    from bagua_tpu_torch.checkpoint import compute_state_digest

    torch.cuda.synchronize()
    return compute_state_digest(trainer._checkpoint_state(state))["digest"]


def _prepare_save(trainer, state):
    """Right before a save: async model average's blocking average (the
    resize-portable protocol); nothing for the other families."""
    sync = getattr(trainer.algorithm, "sync_for_checkpoint", None)
    return sync(trainer, state) if sync is not None else state


def _timed_steps(trainer, state, batch, n):
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())   # synchronizes
        times.append(time.perf_counter() - t0)
    return state, losses, times


def _free_gb(path) -> float:
    import shutil

    return shutil.disk_usage(path).free / 1e9


def resume_check(label, build, modules, directory, second_save=False, fault=None, rank=0):
    """The checkpoint gate of one path: an uninterrupted run of
    ``CKPT_STEPS`` steps against a run of ``CKPT_SAVE_AT`` steps, an async
    save, one step while it is in flight (before ``wait()``: the snapshot
    must hold the state at the save), the rest of the steps, with
    ``second_save`` a save of step ``CKPT_STEPS`` damaged by ``fault`` (armed
    on the ranks that pass it), then a fresh trainer and manager restoring
    the newest verified step, which must be ``CKPT_SAVE_AT`` (after one
    fallback where the newest was damaged), and running the rest.
    ``build()`` returns ``(trainer, state, batch)``.  Gates: the restored
    step and fallbacks, the final state's digest (parameters, optimizer
    state, the algorithm's state) and the resumed losses bitwise the
    uninterrupted run's, and the launches of ``modules``' kernels after the
    restore those of as many steps of the uninterrupted run.  Returns the
    record, with the save's and the restore's times."""
    import contextlib

    import bagua_tpu_torch as bt
    from bagua_tpu_torch.faults.inject import fault_scope
    from bagua_tpu_torch.telemetry import counters

    trainer, state, batch = build()
    for mod in modules:
        mod.reset_launch_counts()
    state, head_u, times_u = _timed_steps(trainer, state, batch, CKPT_SAVE_AT)
    state = _prepare_save(trainer, state)
    trainer.algorithm.on_restore(trainer)   # what the restore below does
    state, tail_u, t = _timed_steps(trainer, state, batch, CKPT_STEPS - CKPT_SAVE_AT)
    times_u += t
    launches_u = {k.__name__: k.launches for mod in modules for k in mod.KERNELS}
    want = state_digest(trainer, state)
    del trainer, state, batch
    release()

    trainer, state, batch = build()
    state, head, _ = _timed_steps(trainer, state, batch, CKPT_SAVE_AT)
    state = _prepare_save(trainer, state)
    mgr = bt.BaguaCheckpointManager(directory, max_to_keep=2, async_save=True)
    t0 = time.perf_counter()
    if not trainer.save_checkpoint(mgr, CKPT_SAVE_AT, state):
        raise AssertionError(f"checkpoint {label}: the save of step {CKPT_SAVE_AT} was skipped")
    save_call_s = time.perf_counter() - t0
    first = dict(mgr.last_save)
    state, _, t_flight = _timed_steps(trainer, state, batch, 1)
    t0 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t0
    first.update(mgr.last_save)
    state, _, _ = _timed_steps(trainer, state, batch, CKPT_STEPS - CKPT_SAVE_AT - 1)
    second = {}
    if second_save:
        with (fault_scope(fault) if fault is not None else contextlib.nullcontext()):
            if not trainer.save_checkpoint(mgr, CKPT_STEPS, state):
                raise AssertionError(f"checkpoint {label}: the save of step {CKPT_STEPS} was skipped")
            mgr.wait()   # durable: an armed fault lands here
        second = dict(mgr.last_save)
    mgr.close()
    del trainer, state, batch, mgr
    release()

    trainer, state, batch = build()
    for mod in modules:
        mod.reset_launch_counts()
    before = counters.snapshot()
    mgr = bt.BaguaCheckpointManager(directory, max_to_keep=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, state = trainer.restore_checkpoint(mgr, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    fallbacks = counters.get("ckpt/fallback_restores") - before.get("ckpt/fallback_restores", 0)
    state, tail, _ = _timed_steps(trainer, state, batch, CKPT_STEPS - CKPT_SAVE_AT)
    launches = {k.__name__: k.launches for mod in modules for k in mod.KERNELS}
    got = state_digest(trainer, state)
    mgr.close()
    record = {"name": label, "kind": "checkpoint", "step": step, "fallbacks": fallbacks,
              "losses_u": head_u + tail_u, "losses": head + tail, "digest_equal": got == want,
              "launches_u": launches_u, "launches_resumed": launches,
              "stall_s": first["stall_s"], "save_call_s": save_call_s,
              "durable_s": first["durable_s"], "digest_s": first["digest_s"],
              "wait_s": wait_s, "bytes": first["bytes"],
              "second_stall_s": second.get("stall_s"),
              "second_durable_s": second.get("durable_s"),
              "restore_s": restore_s, "step_ms_in_flight": t_flight[0] * 1e3,
              "step_ms_same_step_u": times_u[CKPT_SAVE_AT] * 1e3}
    second_txt = ("" if not second else
                  f" (the second save: stall {second['stall_s'] * 1e3:.1f} ms, durable after "
                  f"{second['durable_s']:.3f} s)")
    log(f"[rank {rank}] checkpoint {label}: restored step {step} after {fallbacks} "
        f"fallback(s); losses {head + tail} against {head_u + tail_u}; final state digest "
        f"equal {got == want}; save stall {first['stall_s'] * 1e3:.1f} ms{second_txt}, save() "
        f"{save_call_s * 1e3:.1f} ms, durable after {first['durable_s']:.3f} s, digest "
        f"{first['digest_s']:.3f} s, wait() {wait_s:.3f} s, restore {restore_s:.3f} s, "
        f"{first['bytes']} bytes on disk for this rank; the step with the save in flight "
        f"{t_flight[0] * 1e3:.1f} ms against {times_u[CKPT_SAVE_AT] * 1e3:.1f} ms without; "
        f"launches {launches_u} uninterrupted, {launches} after the restore")
    if step != CKPT_SAVE_AT or fallbacks != int(second_save):
        raise AssertionError(f"checkpoint {label}: restored step {step} after {fallbacks} "
                             f"fallbacks, expected step {CKPT_SAVE_AT} after {int(second_save)}")
    if head + tail != head_u + tail_u or got != want:
        raise AssertionError(f"checkpoint {label}: the resumed run is not the uninterrupted "
                             f"one (losses {head + tail} against {head_u + tail_u}, final "
                             f"state digest equal {got == want})")
    half = {k: v * (CKPT_STEPS - CKPT_SAVE_AT) // CKPT_STEPS for k, v in launches_u.items()}
    if torch.cuda.is_available() and (launches != half or not any(launches_u.values())):
        raise AssertionError(f"checkpoint {label}: launches {launches} after the restore, "
                             f"{launches_u} in the uninterrupted run")
    return record


def flat_to_leaf_check(rank, build, directory):
    """A flat-resident checkpoint of the replicated family restored into a
    leaf trainer (``flat_resident="off"``): the parameters right after the
    restore bitwise those of the flat run at its save, then two finite
    steps.  ``build(**kw)`` returns ``(trainer, state, batch)``."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.checkpoint import compute_state_digest

    def params(state):
        torch.cuda.synchronize()
        return compute_state_digest({n: p.detach() for n, p in
                                     state.model.named_parameters()})["digest"]

    trainer, state, batch = build()
    flat = trainer._flat_resident
    state, _, _ = _timed_steps(trainer, state, batch, CKPT_SAVE_AT)
    mgr = bt.BaguaCheckpointManager(directory, async_save=False)
    if not trainer.save_checkpoint(mgr, CKPT_SAVE_AT, state):
        raise AssertionError("checkpoint flat -> leaf: the save was skipped")
    want = params(state)
    del trainer, state, batch
    release()
    trainer, state, batch = build(flat_resident="off")
    step, state = trainer.restore_checkpoint(mgr, state)
    got = params(state)
    state, losses, _ = _timed_steps(trainer, state, batch, 2)
    mgr.close()
    log(f"[rank {rank}] checkpoint flat -> leaf: a {'resident' if flat else 'leaf'} "
        f"checkpoint restored at step {step} into the "
        f"{'resident' if trainer._flat_resident else 'leaf'} layout, parameters equal to the "
        f"saved run's {got == want}, then losses {losses}")
    if (not flat or step != CKPT_SAVE_AT or trainer._flat_resident or got != want
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"checkpoint flat -> leaf: step {step}, parameters equal "
                             f"{got == want}, losses {losses}")
    return {"name": "ckpt_flat_to_leaf", "kind": "checkpoint", "step": step,
            "params_equal": got == want, "losses": losses}


def checkpoint_run(rank, world, run, device, label):
    """One run of the checkpoint phase on this rank (``CKPT_RUNS``)."""
    from bagua_tpu_torch.faults.inject import FaultSpec
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa

    name = run[0]
    directory = os.path.join(_CKPT_DIR["root"], name)
    if rank == 0:
        os.makedirs(_CKPT_DIR["root"], exist_ok=True)
        log(f"checkpoint {name}: {_free_gb(_CKPT_DIR['root']):.1f} GB free under "
            f"{_CKPT_DIR['root']}")

    def build(**extra):
        spec = (run[0], run[1], run[2], {**run[3], **extra})
        _, _, _, trainer, state, batch, _ = _build_run(rank, world, spec, device)
        return trainer, state, batch

    if name == "ckpt_flat_to_leaf":
        return flat_to_leaf_check(rank, build, directory)
    onebit = name == "ckpt_onebit"
    # (b): the newest save corrupted on rank 1 alone
    fault = (FaultSpec("ckpt.write", step=CKPT_STEPS, kind="corrupt", seed=5)
             if onebit and rank == 1 else None)
    return resume_check(name, build, [fa, cd], directory, second_save=onebit, fault=fault,
                        rank=rank)


def phase_checkpoint():
    """(a): slice 1's long-context LM at world 1 over NCCL through the flash
    kernels, its newest step torn (``resume_check``)."""
    from bagua_tpu_torch.faults.inject import FaultSpec
    from bagua_tpu_torch.ops import flash_attention as fa

    with tempfile.TemporaryDirectory(prefix="bagua_ckpt_") as tmp:
        log(f"checkpoint: {_free_gb(tmp):.1f} GB free under {tmp}")

        def build():
            _, trainer, state, batch = build_slice("longctx")
            return trainer, state, batch

        record = resume_check("slice 1 (long-context LM, world 1, NCCL)", build, [fa],
                              os.path.join(tmp, "a"), second_save=True,
                              fault=FaultSpec("ckpt.write", step=CKPT_STEPS, kind="torn"))
    release()
    return record


def check_checkpoint(card, single, multi):
    """The checkpoint phase's gates across the ranks (the same restored
    step, the same losses), and its numbers beside the card's name and
    power limit."""
    for name, recs in multi.items():
        if any(r["step"] != recs[0]["step"] for r in recs):
            raise AssertionError(f"checkpoint {name}: the ranks restored different steps "
                                 f"{[r['step'] for r in recs]}")
        if any(r["losses"] != recs[0]["losses"] for r in recs):
            raise AssertionError(f"checkpoint {name}: losses differ between the ranks")
    rows = [("(a) " + single["name"], [single])] + [
        (f"({'b' if name == 'ckpt_onebit' else 'c'}) {name}", recs)
        for name, recs in multi.items() if "stall_s" in recs[0]]
    for label, recs in rows:
        for r, rec in enumerate(recs):
            log(f"checkpoint {label} rank {r} on {card}: save stall {rec['stall_s'] * 1e3:.3f} "
                f"ms, durable after {rec['durable_s'] * 1e3:.3f} ms, digest "
                f"{rec['digest_s'] * 1e3:.3f} ms, restore {rec['restore_s'] * 1e3:.3f} ms, "
                f"{rec['bytes']} bytes on disk; step with the save in flight "
                f"{rec['step_ms_in_flight']:.3f} ms against {rec['step_ms_same_step_u']:.3f} "
                f"ms without")


# ---------------------------------------------------------------------------
# model_parallel: expert and sequence parallelism (MP_RUNS)
# ---------------------------------------------------------------------------

_MP_MESHES = {}


def _mp_mesh(axes):
    """A multi-rank phase's mesh: ``{axes: MP_WORLD}`` for an axis name
    (``"ep"``, ``"sp"``), else the axis sizes ``axes`` (``{"tp": 2}``,
    ``{"pp": 2, "tp": 2}``); built at first use (collective: every rank runs
    the runs in one order) and set as the global mesh."""
    import bagua_tpu_torch as bt

    sizes = {axes: MP_WORLD} if isinstance(axes, str) else dict(axes)
    key = tuple(sizes.items())
    if key not in _MP_MESHES:
        _MP_MESHES[key] = bt.build_mesh(sizes)
    bt.set_global_mesh(_MP_MESHES[key])
    return _MP_MESHES[key]


def _exchange_timer(comm):
    """Host milliseconds in ``comm``'s all-to-alls (each to the end of the
    device's work before and after it): wraps the communicator's methods;
    returns the list the times go to and the undo.  The synchronizations
    slow the step, so only a step of its own runs under it."""
    spent = []
    orig = comm.alltoall, comm.alltoall_packed

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    comm.alltoall, comm.alltoall_packed = timed(comm.alltoall), timed(comm.alltoall_packed)

    def undo():
        comm.alltoall, comm.alltoall_packed = orig

    return spent, undo


def _expert_digest(model):
    import hashlib

    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if "expert_" in n:
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _full_weights(name, **kw):
    """A world-1 model's weights (seed 0): what the sharded runs start from."""
    model = slice_model(name, **kw)
    sd = {n: t.clone() for n, t in model.state_dict().items()}
    del model
    return sd


def _ep_algorithm(algo):
    """An expert-parallel run's algorithm and torch optimizer: the
    replicated Adam 1e-4 (``ga``), ZeRO over that Adam, or QAdam through its
    switch (``_algorithm("qadam")``: two warmup steps, lr 1e-5)."""
    import bagua_tpu_torch as bt

    adam = functools.partial(torch.optim.Adam, lr=1e-4)
    if algo == "zero":
        return bt.ZeroOptimizerAlgorithm(adam), None
    if algo == "qadam":
        return _algorithm("qadam"), None
    return bt.GradientAllReduceAlgorithm(hierarchical=False), adam


def _opt_state_split(trainer, state):
    """This rank's optimizer-state bytes of the dense leaves and of the
    expert tables (the moments; step counts left out): ZeRO's chunk
    optimizer and its local one, QAdam's moments, or the torch optimizer's
    state by parameter."""
    from bagua_tpu_torch.algorithms.zero import ZeroOptState

    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts
                            if torch.is_tensor(t) and t.dim())
    opt = state.opt_state
    if isinstance(opt, ZeroOptState):
        return (nbytes(v for st in opt.optimizer.state.values() for v in st.values()),
                nbytes(v for st in opt.local.state.values() for v in st.values()))
    params = dict(state.model.named_parameters())
    if opt is not None:   # QAdam's moments by name
        by_name = {n: (opt.exp_avg[n], opt.exp_avg_sq[n]) for n in params}
    else:
        by_name = {n: tuple(state.optimizer.state.get(p, {}).values())
                   for n, p in params.items()}
    expert = set(trainer._expert_names())
    return (nbytes(t for n, ts in by_name.items() if n not in expert for t in ts),
            nbytes(t for n, ts in by_name.items() if n in expert for t in ts))


def ep_run(rank, world, name, device, label, use_ragged, algo="ga"):
    """Slice 2's model at full width, expert-parallel over ``{"ep": 2}``
    (4 experts and 8 rows a rank), from the world-1 model's weights:
    ``FULL_STEPS`` steps in one exchange form (the losses, the parameters,
    the optimizer state's bytes and the step times) of Adam 1e-4 replicated
    (``ga``), ZeRO over it, or QAdam through its switch (K1 and K2 counted
    too); the replicated runs then take one step more with the exchange
    timed (``_exchange_timer``)."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.model_parallel.moe import MoEMLP, shard_expert_state
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    mesh = _mp_mesh("ep")
    model = slice_model("moe", ep_size=world, use_ragged=use_ragged)
    model.load_state_dict(shard_expert_state(_full_weights("moe"), model))
    algorithm, optimizer = _ep_algorithm(algo)
    trainer = bt.BaguaTrainer(bt.moe_lm_loss_fn(aux_loss_weight=0.01), optimizer, algorithm,
                              device=device, mesh=mesh, expert_axis="ep")
    state = trainer.init(model)
    batch = trainer.shard_batch({"tokens": ep_batch(device)}, global_batch=True)
    comm = mesh.comm("ep")
    # the grouped products' shapes of the first MoE layer's first forward
    shapes = []
    layer = next(m for m in model.modules() if isinstance(m, MoEMLP))
    inner = layer.gmm_fn

    def record_shape(lhs, rhs, sizes):
        if len(shapes) < 2:
            shapes.append({"rows": lhs.shape[0], "m": rhs.shape[1], "n": rhs.shape[2],
                           "sizes": sizes.tolist()})
        return inner(lhs, rhs, sizes)

    layer.gmm_fn = record_shape
    exch0, staged0 = comm.host_staged_bytes, trainer.host_staged_bytes
    losses, launches, st, state = train_steps(trainer, state, batch, MOE["b"] * MOE["s"],
                                              [fa, gm, cd], steps=FULL_STEPS)
    exch_bytes = (comm.host_staged_bytes - exch0) / FULL_STEPS
    staged_bytes = (trainer.host_staged_bytes - staged0) / FULL_STEPS
    digests, expert_digest = _flat_digests(trainer, model), _expert_digest(model)
    dense_opt_bytes, expert_opt_bytes = _opt_state_split(trainer, state)
    cfg, n_moe = model.cfg, model.cfg.n_layers // 2
    n_buckets = len(trainer.plan.buckets)
    want = {k.__name__: 0 for k in cd.KERNELS}
    if algo == "qadam":
        codec_steps = FULL_STEPS - QADAM_WARMUP
        want.update(compress_chunked=n_buckets * codec_steps,
                    decompress_chunked=2 * n_buckets * codec_steps)
    want.update({"flash_fwd": cfg.n_layers * FULL_STEPS,
                 "flash_bwd_dkv": cfg.n_layers * FULL_STEPS,
                 "flash_bwd_dq": cfg.n_layers * FULL_STEPS,
                 "grouped_matmul": 4 * n_moe * FULL_STEPS,
                 "grouped_matmul_drhs": 2 * n_moe * FULL_STEPS})
    if launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    record = {"name": name, "kind": "model_parallel", "losses": losses, "launches": launches,
              "stats": st, "digests": digests, "expert_digest": expert_digest,
              "layout": st["layout"], "exchange_bytes_step": exch_bytes,
              "staged_bytes_step": staged_bytes, "shapes": shapes, "algo": algo,
              "dense_opt_bytes": dense_opt_bytes, "expert_opt_bytes": expert_opt_bytes,
              "plan_numel": sum(b.padded_numel for b in trainer.plan.buckets),
              "dense_numel": sum(t.numel for b in trainer.plan.buckets for t in b.tensors),
              "buckets": n_buckets}
    if algo == "ga":
        spent, undo = _exchange_timer(comm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        loss.item()
        record.update(exchange_ms_step=sum(spent), exchange_calls_step=len(spent),
                      timed_step_ms=(time.perf_counter() - t0) * 1e3)
        undo()
    log(f"[rank {rank}] {label} {name}: losses {losses}; launches {launches}; optimizer "
        f"state {dense_opt_bytes} bytes dense, {expert_opt_bytes} bytes expert tables")
    return record


def ep_cut_run(rank, world, name, device, label):
    """The rescale gate: on the cut (``MP_CUT``: f32, SGD 0.1, no
    load-balancing term, which is not linear in the batch), one
    expert-parallel step equals one world-1 step on the global batch within
    ``MP_CUT_RTOL`` of every parameter.  A missing ``1 / ep`` rescale would
    double every expert table's update, which Adam would hide."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.model_parallel.moe import shard_expert_state

    mesh = _mp_mesh("ep")
    tokens = ep_batch(device, rows=world * MP_CUT_ROWS, seq=MP_CUT["max_seq_len"])
    loss_fn = bt.moe_lm_loss_fn(aux_loss_weight=0.0)
    full = slice_model("moe", **MP_CUT)
    before = {n: p.detach().clone() for n, p in full.named_parameters()}
    loss_fn(full, {"tokens": tokens}).backward()
    with torch.no_grad():
        want = {n: p - 0.1 * p.grad for n, p in full.named_parameters()}
    del full
    model = slice_model("moe", ep_size=world, **MP_CUT)
    model.load_state_dict(shard_expert_state(before, model))
    trainer = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(hierarchical=False), device=device,
                              mesh=mesh, expert_axis="ep")
    state = trainer.init(model)
    batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
    state, _ = trainer.train_step(state, batch)
    got = trainer.unstack_params(state)
    err = {n: rel_err(got[n], want[n]) for n in want}
    upd = {n: rel_err(got[n] - before[n], want[n] - before[n]) for n in want}
    # what the gate would see without the rescale: every expert update doubled
    doubled = max(rel_err(2 * got[n] - before[n], want[n]) for n in want if "expert_" in n)
    worst = max(err, key=err.get)
    log(f"[rank {rank}] {label} {name}: one SGD step at ep {world} against world 1 on the "
        f"global batch: largest parameter error {err[worst]:.3g} ({worst}), largest update "
        f"error {max(upd.values()):.3g}; with the expert updates doubled (no 1/ep rescale) "
        f"the largest parameter error would be {doubled:.3g}")
    if not (err[worst] <= MP_CUT_RTOL < doubled):
        raise AssertionError(f"[rank {rank}] {name}: the expert-parallel SGD step differs "
                             f"from world 1 ({err}), or the gate could not see a missing "
                             f"rescale ({doubled})")
    return {"name": name, "kind": "model_parallel", "param_err": err[worst],
            "update_err": max(upd.values()), "doubled_err": doubled}


def sp_attention_check(rank, world, name, device, label):
    """The attention alone at slice 1's shape (b 2, seq 4096, 16 heads of
    64, bf16), sharded over ``{"sp": 2}``: ring (flash), ring (the plain
    loop) and Ulysses outputs and q/k/v gradients, gathered over sp, against
    world-1 ``flash_attention`` on the whole sequence (``TOL``)."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa

    mesh = _mp_mesh("sp")
    comm = mesh.comm("sp")
    b, S, h, d = MAIN["b"], MAIN["s"], MAIN["h"], MAIN["d"]
    s = S // world
    g = torch.Generator(device=device).manual_seed(40)
    q, k, v, do = (torch.randn(b, S, h, d, device=device, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    full = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out = fa.flash_attention(*full, torch.bfloat16)
    ref = [ref_out.detach()] + list(torch.autograd.grad(ref_out, full, do))
    part = slice(rank * s, (rank + 1) * s)
    errs = {}
    for kind, attn in (("ring", bt.make_ring_attention(world)),
                       ("ring_plain", bt.make_ring_attention(world, use_flash="never")),
                       ("ulysses", bt.make_ulysses_attention(world))):
        mine = [x[:, part].contiguous().requires_grad_() for x in (q, k, v)]
        out = attn(*mine, torch.bfloat16)
        grads = torch.autograd.grad(out, mine, do[:, part].contiguous())
        got = [comm.allgather(t.detach().contiguous(), axis=1) for t in (out, *grads)]
        errs[kind] = {n: rel_err(a, w) for n, a, w in zip(("out", "dq", "dk", "dv"), got, ref)}
        del mine, out, grads, got
    log(f"[rank {rank}] {label} attention alone b={b} seq {S} over sp {world}, against world-1 "
        f"flash: " + "; ".join(f"{k} " + ", ".join(f"{n} {e:.3g}" for n, e in v.items())
                               for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if max(v.values()) > TOL[torch.bfloat16]}
    if bad:
        raise AssertionError(f"[rank {rank}] sequence-parallel attention disagrees with world-1 "
                             f"flash: {bad} (tolerance {TOL[torch.bfloat16]})")
    return {"name": name, "kind": "model_parallel", "errs": errs}


def sp_cut_run(rank, world, name, device, label):
    """The sequence-parallel counterpart of the rescale gate: on a cut of
    slice 1 (``SP_CUT``: f32, SGD 0.1), one step with ring (flash) attention
    and one with Ulysses equal one world-1 step on the whole sequence within
    ``MP_CUT_RTOL`` of every parameter.  The control, the ring run with the
    model's position offset left at 0 (``sp_axis`` None: every shard at
    positions from 0), must fail that tolerance: the gate sees a wrong
    offset, which a loss at random init hides."""
    import bagua_tpu_torch as bt

    mesh = _mp_mesh("sp")
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, 32768, (MAIN["b"], SP_CUT["max_seq_len"] + 1), device=device,
                           generator=g)
    full = slice_model("longctx", **SP_CUT)
    before = {n: p.detach().clone() for n, p in full.named_parameters()}
    bt.lm_loss_fn(full, {"tokens": tokens}).backward()
    with torch.no_grad():
        want = {n: p - 0.1 * p.grad for n, p in full.named_parameters()}
    del full
    errs = {}
    for kind, attn, sp_axis in (("ring", bt.make_ring_attention(world), "sp"),
                                ("ulysses", bt.make_ulysses_attention(world), "sp"),
                                ("control: ring at offset 0", bt.make_ring_attention(world),
                                 None)):
        model = slice_model("longctx", attn_fn=attn, sp_axis=sp_axis, **SP_CUT)
        model.load_state_dict(before)
        trainer = bt.BaguaTrainer(bt.sp_lm_loss_fn(world),
                                  functools.partial(torch.optim.SGD, lr=0.1),
                                  bt.GradientAllReduceAlgorithm(hierarchical=False),
                                  device=device, mesh=mesh, seq_axis="sp")
        state = trainer.init(model)
        batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
        state, _ = trainer.train_step(state, batch)
        got = trainer.unstack_params(state)
        err = {n: rel_err(got[n], want[n]) for n in want}
        worst = max(err, key=err.get)
        errs[kind] = (err[worst], worst)
        del model, trainer, state, got
    control = errs.pop("control: ring at offset 0")
    log(f"[rank {rank}] {label} {name}: one SGD step at sp {world} against world 1 on the "
        f"whole sequence, largest parameter error: "
        + ", ".join(f"{k} {e:.3g} ({n})" for k, (e, n) in errs.items())
        + f"; the control (ring, position offset 0) {control[0]:.3g} ({control[1]})")
    if not (max(e for e, _ in errs.values()) <= MP_CUT_RTOL < control[0]):
        raise AssertionError(f"[rank {rank}] {name}: the sequence-parallel SGD step differs "
                             f"from world 1 ({errs}), or the gate could not see a wrong "
                             f"position offset ({control})")
    return {"name": name, "kind": "model_parallel",
            "param_err": {k: e for k, (e, _) in errs.items()}, "control_err": control[0]}


def sp_run(rank, world, name, device, label, attn):
    """Slice 1's model at full width, sequence-parallel over ``{"sp": 2}``
    with ring (flash) or Ulysses attention: ``FULL_STEPS`` AdamW steps of
    ``sp_lm_loss_fn`` on slice 1's batch, the same on both ranks."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa

    mesh = _mp_mesh("sp")
    attn_fn = (bt.make_ring_attention(world) if attn == "ring"
               else bt.make_ulysses_attention(world))
    model = slice_model("longctx", attn_fn=attn_fn, sp_axis="sp")
    opt = functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    trainer = bt.BaguaTrainer(bt.sp_lm_loss_fn(world), opt,
                              bt.GradientAllReduceAlgorithm(hierarchical=False), device=device,
                              mesh=mesh, seq_axis="sp")
    state = trainer.init(model)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab_size, (MAIN["b"], MAIN["s"] + 1), device=device,
                           generator=g)
    batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
    comm = mesh.comm("sp")
    exch0, staged0 = comm.host_staged_bytes, trainer.host_staged_bytes
    losses, launches, st, state = train_steps(trainer, state, batch, MAIN["b"] * MAIN["s"],
                                              [fa], steps=FULL_STEPS)
    per_step = model.cfg.n_layers * (world if attn == "ring" else 1) * FULL_STEPS
    want = {k.__name__: per_step for k in fa.KERNELS}
    if launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    log(f"[rank {rank}] {label} {name}: losses {losses}; launches {launches}")
    return {"name": name, "kind": "model_parallel", "losses": losses, "launches": launches,
            "stats": st, "digests": _flat_digests(trainer, model), "layout": st["layout"],
            "exchange_bytes_step": (comm.host_staged_bytes - exch0) / FULL_STEPS,
            "staged_bytes_step": (trainer.host_staged_bytes - staged0) / FULL_STEPS}


def model_parallel_run(rank, world, run, device, label):
    """One run of the model_parallel phase on this rank; returns its record."""
    name, _, kind, kw = run
    fn = {"ep": ep_run, "ep_cut": ep_cut_run, "sp_attention": sp_attention_check,
          "sp_cut": sp_cut_run, "sp": sp_run}[kind]
    return fn(rank, world, name, device, label, **kw)


def time_ep_gmm(shapes):
    """K7a and K7b at the expert-parallel rank's shapes (the first MoE
    layer's two products, in each exchange form: the dense-slot form's rows
    past the last group included), each held against its plain version on
    the same inputs (``check_gmm``: ``GMM_TOL``, ``GMM_DRHS_TOL``), then
    timed beside the plain versions, their bounds (the routed rows only) and
    ``torch._grouped_mm`` on the routed rows, on the card alone.  Returns
    each kernel's largest absolute error at these shapes."""
    from bagua_tpu_torch.ops import gmm as gm

    errs = {"grouped_matmul": 0.0, "grouped_matmul_drhs": 0.0}
    for form, products in shapes.items():
        for sh in products:
            rows, m, n, sizes = sh["rows"], sh["m"], sh["n"], sh["sizes"]
            routed = sum(sizes)
            lhs, rhs, gout = _gmm_inputs(rows, m, n, len(sizes), seed=m + n)
            got = check_gmm(lhs, rhs, gout, sizes, f"at the EP rank's shape, {form} exchange, "
                            f"rows {rows} (routed {routed}) ({m}, {n})")
            errs = {k: max(e, got[k]) for k, e in errs.items()}
            sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            offs = torch.cumsum(sz, 0, dtype=torch.int32)
            k7a = cuda_ms(lambda: gm.grouped_matmul(lhs, rhs, sz))
            k7b = cuda_ms(lambda: gm.grouped_matmul_drhs(lhs, gout, sz, len(sizes)))
            plain_a = cuda_ms(lambda: gm.grouped_matmul_plain(lhs, rhs, sz), 3)
            plain_b = cuda_ms(lambda: gm.grouped_matmul_drhs_plain(lhs, gout, sz, len(sizes)), 3)
            try:
                lib_a = cuda_ms(lambda: torch._grouped_mm(lhs[:routed], rhs, offs=offs))
                lib_b = cuda_ms(lambda: torch._grouped_mm(lhs[:routed].t(), gout[:routed],
                                                          offs=offs))
            except (RuntimeError, AttributeError, TypeError):
                lib_a = lib_b = None
            ba, bb = gmm_bound("grouped_matmul", routed, m, n, len(sizes)), \
                gmm_bound("grouped_matmul_drhs", routed, m, n, len(sizes))
            log(f"model_parallel gmm at the EP rank's shape, {form} exchange, rows {rows} "
                f"(routed {routed}, sizes {sizes}) ({m}, {n}): grouped_matmul {k7a:.4f} ms "
                f"(plain {plain_a:.4f}, bound {ba[0]:.4f}, {ba[1]}), grouped_matmul_drhs "
                f"{k7b:.4f} ms (plain {plain_b:.4f}, bound {bb[0]:.4f}, {bb[1]}); "
                f"torch._grouped_mm on the routed rows "
                + ("refused" if lib_a is None else f"{lib_a:.4f} and {lib_b:.4f} ms"))
            del lhs, rhs, gout
    log(f"model_parallel gmm at the EP rank's shapes: largest absolute errors {errs}")
    return errs


def check_ep_optimizers(card, mp):
    """ZeRO and QAdam at ep 2: the dense parameters bitwise equal on both
    ranks; ZeRO's losses within ``MP_LOSS_RTOL`` of the replicated EP run's
    (ZeRO over Adam is Adam), its dense optimizer state a rank exactly half
    of that run's (the plan's alignment pad aside), its expert tables' state
    the same; QAdam's losses finite (its launches of K1/K2, exact as the
    compressed phase's buckets say, were held in the run)."""
    full = mp["ep_dense"][0]
    for name in ("ep_zero", "ep_qadam"):
        recs = mp[name]
        if any(r["digests"] != recs[0]["digests"] or r["losses"] != recs[0]["losses"]
               for r in recs):
            raise AssertionError(f"model_parallel {name}: dense parameters or losses differ "
                                 "between ranks")
        if not all(math.isfinite(x) for x in recs[0]["losses"]):
            raise AssertionError(f"model_parallel {name}: non-finite loss {recs[0]['losses']}")
        for r, rec in enumerate(recs):
            st = rec["stats"]
            log(f"model_parallel {name} rank {r} ({card}; gloo through host memory, "
                f"{MP_WORLD} ranks on one card): losses {rec['losses']}, median step "
                f"{st['median_ms']:.3f} ms (steps 2-{FULL_STEPS}), {st['tokens_s']:.1f} "
                f"tokens/s, peak {st['peak_gb']:.3f} GB, optimizer state "
                f"{rec['dense_opt_bytes']} bytes dense ({rec['buckets']} buckets) and "
                f"{rec['expert_opt_bytes']} bytes expert tables against the replicated run's "
                f"{full['dense_opt_bytes']} and {full['expert_opt_bytes']}; host-staged "
                f"{rec['staged_bytes_step']:.0f} bytes a step; launches {rec['launches']}")
    zero = mp["ep_zero"][0]
    gap = [abs(a - b) / abs(b) for a, b in zip(zero["losses"], full["losses"])]
    pad = zero["plan_numel"] - zero["dense_numel"]
    half = all(r["dense_opt_bytes"] * MP_WORLD == full["dense_opt_bytes"] + 8 * pad
               and r["expert_opt_bytes"] == full["expert_opt_bytes"] for r in mp["ep_zero"])
    log(f"model_parallel ep_zero: losses within {max(gap):.3g} of the replicated EP run's; "
        f"dense optimizer state a rank {zero['dense_opt_bytes']} bytes, "
        f"{'exactly' if half else 'NOT'} half of the replicated {full['dense_opt_bytes']} "
        f"with the {pad}-element alignment pad")
    if not (max(gap) <= MP_LOSS_RTOL and half):
        raise AssertionError(f"model_parallel ep_zero: loss gap {gap}, half {half}")


def check_model_parallel(card, mp, slice1_losses, ep_losses):
    """The phase's gates across ranks and against the world-1 runs: the
    dense parameters bitwise equal on both ranks; the two exchange forms'
    losses and parameters bitwise equal on each rank; each step's loss
    within ``MP_LOSS_RTOL`` of the world-1 run's (slice 2's model on the
    global batch; slice 1's losses); then prints the runs' numbers beside the
    card and checks K7a/K7b at the EP rank's shapes (``time_ep_gmm``, whose
    errors it returns)."""
    for name in ("ep_dense", "ep_ragged", "sp_ring", "sp_ulysses"):
        recs = mp[name]
        if any(r["digests"] != recs[0]["digests"] for r in recs):
            raise AssertionError(f"model_parallel {name}: dense parameters differ between ranks")
        if any(r["losses"] != recs[0]["losses"] for r in recs):
            raise AssertionError(f"model_parallel {name}: losses differ between ranks")
        want = ep_losses if name.startswith("ep") else slice1_losses[:FULL_STEPS]
        gap = [abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"], want)]
        log(f"model_parallel {name}: losses {recs[0]['losses']} against world 1 {want}: "
            f"largest relative gap {max(gap):.3g}")
        if not max(gap) <= MP_LOSS_RTOL:
            raise AssertionError(f"model_parallel {name}: losses off the world-1 run's by "
                                 f"{gap} (tolerance {MP_LOSS_RTOL})")
        for r, rec in enumerate(recs):
            st = rec["stats"]
            log(f"model_parallel {name} rank {r} ({card}; gloo through host memory, "
                f"{MP_WORLD} ranks on one card): median step {st['median_ms']:.3f} ms (steps "
                f"2-{FULL_STEPS}), {st['tokens_s']:.1f} tokens/s, peak {st['peak_gb']:.3f} GB "
                f"({rec['layout']} layout), host-staged {rec['staged_bytes_step']:.0f} bytes a "
                f"step, of them the mesh axis's collectives {rec['exchange_bytes_step']:.0f}"
                + (f"; in a step of its own with the exchange timed (a synchronization "
                   f"before and after each of its {rec['exchange_calls_step']} all-to-alls): "
                   f"{rec['exchange_ms_step']:.3f} ms in the exchange of a "
                   f"{rec['timed_step_ms']:.3f} ms step" if "exchange_ms_step" in rec else ""))
    check_ep_optimizers(card, mp)
    for r, (a, b) in enumerate(zip(mp["ep_dense"], mp["ep_ragged"])):
        same = (a["losses"] == b["losses"] and a["digests"] == b["digests"]
                and a["expert_digest"] == b["expert_digest"])
        log(f"model_parallel rank {r}: dense-slot and exact-count exchanges "
            f"{'bitwise equal' if same else 'DIFFER'} (losses, dense and expert parameters)")
        if not same:
            raise AssertionError(f"model_parallel rank {r}: the two exchange forms differ: "
                                 f"{a['losses']} against {b['losses']}")
    shapes = {"dense-slot": mp["ep_dense"][0]["shapes"],
              "exact-count": mp["ep_ragged"][0]["shapes"]}
    return time_ep_gmm(shapes)


# ---------------------------------------------------------------------------
# tensor_pipeline: tensor and pipeline parallelism on slice 1's model
# ---------------------------------------------------------------------------

def tpp_model(axes, **widths):
    """Slice 1's model (``widths`` replacing its configuration's) on the
    mesh ``axes``: a ``TransformerLM`` holding ``n_heads / tp`` heads and
    ``d_ff / tp`` rows, or with a ``pp`` axis a ``PipelinedTransformerLM``
    holding ``n_layers / pp`` stacked layers, ``PP_MICRO`` microbatches.
    Random weights (seed 0): the caller loads slice 1's."""
    import bagua_tpu_torch as bt

    tp, pp = axes.get("tp", 1), axes.get("pp", 1)
    cfg = slice_config("longctx", **widths, tp_axis="tp" if tp > 1 else None, tp_size=tp)
    if pp > 1:
        return bt.PipelinedTransformerLM(cfg, pp, n_microbatches=PP_MICRO, seed=0)
    return bt.TransformerLM(cfg, seed=0)


def _tpp_trainer(axes, model, optimizer, device):
    import bagua_tpu_torch as bt

    kw = {f"{a}_axis": a for a in ("tp", "pp") if axes.get(a, 1) > 1}
    loss_fn = bt.pp_lm_loss_fn if "pp" in axes else bt.lm_loss_fn
    return bt.BaguaTrainer(loss_fn, optimizer, bt.GradientAllReduceAlgorithm(hierarchical=False),
                           device=device, mesh=_mp_mesh(axes), **kw)


def _sharded_digest(trainer, model):
    """sha256 of every tensor- or pipeline-sharded leaf of this rank."""
    import hashlib

    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if trainer._is_sharded(n):
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def tpp_full_run(rank, world, name, device, label, axes):
    """Slice 1's model at full width over ``axes`` from slice 1's world-1
    weights (each rank's slice cut by ``shard_state_dict``): ``FULL_STEPS``
    AdamW 1e-4 steps on slice 1's batch (both ranks the whole batch: there
    is no data axis).  Launches exact: each flash kernel ``n_layers`` a step
    at tp (a rank's 8 heads, b·h 16), ``n_layers / pp`` a tick over
    ``PP_MICRO + pp - 1`` ticks at pp (bubble ticks included; a
    microbatch's one row, b·h 16).  Records the losses, the digests of the
    dense and the sharded leaves, the step times, the peak and the bytes
    staged a step: the mesh axis's collectives (tp's activation allreduces,
    pp's hops) and the bucket collectives apart."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.models.convert import shard_state_dict
    from bagua_tpu_torch.ops import flash_attention as fa

    mesh = _mp_mesh(axes)
    model = tpp_model(axes)
    model.load_state_dict(shard_state_dict(_full_weights("longctx"), model))
    trainer = _tpp_trainer(axes, model, _adamw(), device)
    state = trainer.init(model)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab_size, (MAIN["b"], MAIN["s"] + 1), device=device,
                           generator=g)
    batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
    axis = "pp" if "pp" in axes else "tp"
    comm, buckets = mesh.comm(axis), trainer.backend.global_communicator
    axis0, buckets0, staged0 = (comm.host_staged_bytes, buckets.host_staged_bytes,
                                trainer.host_staged_bytes)
    losses, launches, st, state = train_steps(trainer, state, batch, MAIN["b"] * MAIN["s"],
                                              [fa], steps=FULL_STEPS)
    cfg = model.cfg
    per_step = (cfg.n_layers if axis == "tp"
                else cfg.n_layers // axes["pp"] * (PP_MICRO + axes["pp"] - 1))
    want = {k.__name__: per_step * FULL_STEPS for k in fa.KERNELS}
    if launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    log(f"[rank {rank}] {label} {name}: losses {losses}; launches {launches}")
    record = {"name": name, "kind": "tensor_pipeline", "losses": losses, "launches": launches,
              "stats": st, "digests": _flat_digests(trainer, model), "layout": st["layout"],
              "sharded_digest": _sharded_digest(trainer, model),
              "plan": trainer.plan.tensor_names, "world": trainer.world_size,
              "axis_bytes_step": (comm.host_staged_bytes - axis0) / FULL_STEPS,
              "bucket_bytes_step": (buckets.host_staged_bytes - buckets0) / FULL_STEPS,
              "staged_bytes_step": (trainer.host_staged_bytes - staged0) / FULL_STEPS}
    # one step more under the profiler: this rank's device kernel time
    record["kernel_ms"] = kernel_step_ms(trainer, state, batch, total=True)
    return record


class _AllReduceBothWays(torch.autograd.Function):
    """The tensor-parallel cut's control: the row-parallel sum as a raw
    allreduce, whose backward is an allreduce too (each block's cotangent
    scaled by tp)."""

    @staticmethod
    def forward(ctx, x, comm):
        import bagua_tpu_torch as bt

        ctx.comm = comm
        return comm.allreduce(x.clone(), bt.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        import bagua_tpu_torch as bt

        return ctx.comm.allreduce(grad.clone(), bt.ReduceOp.SUM), None


def tpp_cut_run(rank, world, name, device, label, axes, ckpt=False):
    """One SGD step (0.1) on a cut of slice 1 (``SP_CUT``: f32, d_model 256,
    4 heads, seq 512, slice 1's 2 rows) over ``axes`` against the world-1
    step on the whole batch, within ``MP_CUT_RTOL`` of every parameter; its
    control must fail that tolerance: under tp ``tp_reduce`` as an allreduce
    with an allreduce backward, under pp the dense gradients without the
    ``pp_size`` prescale.  With ``ckpt`` the step's state is saved, one more
    step taken, and a fresh trainer restoring the save and taking that step
    must end bitwise equal."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.models import transformer as tm
    from bagua_tpu_torch.models.convert import shard_state_dict, stack_blocks

    _mp_mesh(axes)
    cfg = slice_config("longctx", **SP_CUT)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MAIN["b"], cfg.max_seq_len + 1), device=device,
                           generator=g)
    full = slice_model("longctx", **SP_CUT)
    before = {n: p.detach().clone() for n, p in full.named_parameters()}
    bt.lm_loss_fn(full, {"tokens": tokens}).backward()
    with torch.no_grad():
        want = {n: p - 0.1 * p.grad for n, p in full.named_parameters()}
    del full
    if "pp" in axes:
        want = stack_blocks(want, cfg.n_layers)
    sgd = functools.partial(torch.optim.SGD, lr=0.1)

    def fresh():
        model = tpp_model(axes, **SP_CUT)
        model.load_state_dict(shard_state_dict(before, model))
        trainer = _tpp_trainer(axes, model, sgd, device)
        return model, trainer, trainer.init(model)

    errs, record = {}, {"name": name, "kind": "tensor_pipeline"}
    tp_reduce = tm.tp_reduce
    for kind in ("step", "control"):
        model, trainer, state = fresh()
        if kind == "control" and "pp" in axes:
            trainer._prescale_partial_grads = lambda grads: None
        elif kind == "control":
            tm.tp_reduce = _AllReduceBothWays.apply
        batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
        try:
            state, _ = trainer.train_step(state, batch)
        finally:
            tm.tp_reduce = tp_reduce
        got = trainer.unstack_params(state)
        err = {n: rel_err(got[n], want[n]) for n in want}
        worst = max(err, key=err.get)
        errs[kind] = (err[worst], worst)
        if ckpt and kind == "step":
            record["resume_bitwise"] = _tpp_resume(trainer, state, batch, fresh)
        del model, trainer, state, got
    control = "no pp_size prescale" if "pp" in axes else "tp_reduce with an allreduce backward"
    log(f"[rank {rank}] {label} {name}: one SGD step over {axes} against world 1 on the whole "
        f"batch, largest parameter error {errs['step'][0]:.3g} ({errs['step'][1]}); the "
        f"control ({control}) {errs['control'][0]:.3g} ({errs['control'][1]})"
        + (f"; resumed from a checkpoint after step 1: "
           f"{'bitwise' if record['resume_bitwise'] else 'DIFFERS'}" if ckpt else ""))
    if not errs["step"][0] <= MP_CUT_RTOL < errs["control"][0]:
        raise AssertionError(f"[rank {rank}] {name}: the step differs from world 1 ({errs}), or "
                             f"the gate could not see the control")
    if ckpt and not record["resume_bitwise"]:
        raise AssertionError(f"[rank {rank}] {name}: the resumed step differs")
    record.update(param_err=errs["step"][0], control_err=errs["control"][0], control=control)
    return record


def _tpp_resume(trainer, state, batch, fresh):
    """Save ``state`` (after its first step), take one step more; a fresh
    trainer restores the save and takes the same step: bitwise equal
    parameters and loss."""
    import bagua_tpu_torch as bt

    directory = os.path.join(_CKPT_DIR["root"], "tpp")
    mgr = bt.BaguaCheckpointManager(directory, async_save=False)
    trainer.save_checkpoint(mgr, 1, state)
    mgr.wait()
    state, loss = trainer.train_step(state, batch)
    want = trainer.unstack_params(state)
    _, trainer2, state2 = fresh()
    step, state2 = trainer2.restore_checkpoint(mgr, state2)
    state2, loss2 = trainer2.train_step(state2, batch)
    got = trainer2.unstack_params(state2)
    mgr.close()
    return bool(step == 1 and loss.item() == loss2.item()
                and all(torch.equal(got[n], want[n]) for n in want))


def tpp_generate_run(rank, world, name, device, label):
    """``generate_tp`` of slice 1's LM at full width over ``{"tp": 2}``
    from slice 1's world-1 weights (GLOBAL, each rank slicing its heads and
    rows), on the generate phase's prompt and budget: the tokens and the
    logits of both ranks against the generate phase's (``GEN_REF_ENV``)."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa

    path, deadline = os.environ[GEN_REF_ENV], time.monotonic() + WORKER_TIMEOUT
    while not os.path.exists(path):   # the generate phase runs beside this spawn
        if time.monotonic() > deadline:
            raise AssertionError(f"tp_generate: no generate reference at {path}")
        time.sleep(0.5)
    ref = torch.load(path)
    mesh = _mp_mesh({"tp": 2})
    model = tpp_model({"tp": 2})
    weights = _full_weights("longctx")
    prompt = ref["prompt"].to(device)
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = bt.generate_tp(model, weights, prompt, GEN_NEW, mesh, return_logits=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in fa.KERNELS}
    steps = GEN_PROMPT + GEN_NEW - 1
    # a bf16 near tie can send the greedy chains apart: the logits compare
    # on the steps fed the same tokens (the prompt and the generated tokens
    # up to the first that differs, whose step must be such a tie)
    want, got = ref["logits"], logits.cpu()
    errs, ties = [], []
    for r in range(prompt.shape[0]):
        differ = (toks[r].cpu() != ref["tokens"][r]).nonzero()
        j = int(differ[0]) if differ.numel() else GEN_NEW
        fed = GEN_PROMPT + min(j, GEN_NEW - 1)
        errs.append(rel_err(got[r, :fed], want[r, :fed]))
        if j < GEN_NEW:
            step = GEN_PROMPT - 1 + j
            top2 = want[r, step].topk(2).values
            ties.append({"row": r, "token": j, "margin": float(top2[0] - top2[1]),
                         "gap": abs_err(got[r, step], want[r, step])})
    record = {"name": name, "kind": "tensor_pipeline", "tokens": toks.cpu().tolist(),
              "logits_digest": _digest(logits), "logits_rel_err": max(errs), "ties": ties,
              "same_tokens_as_dense": not ties, "seconds": seconds,
              "ms_step": seconds / steps * 1e3, "tokens_s": prompt.shape[0] * steps / seconds,
              "launches": launches}
    log(f"[rank {rank}] {label} {name}: {steps} decode steps in {seconds:.3f} s, logits "
        f"within {max(errs):.3g} of the dense decode's on the steps fed the same tokens; "
        f"greedy tokens {'equal to the dense decode' if not ties else 'part at ' + str(ties)}")
    return record


def _digest(t):
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def tpp_remesh_run(rank, world, name, device, label):
    """A restore across meshes that the JAX package completes (its case
    ``{dp 2, tp 4} -> {dp 4, tp 2}`` cut to two ranks): on the cut
    (``SP_CUT``, AdamW 1e-4, slice 1's 2 rows), 4 steps straight over
    ``{"tp": 2}``, against 2 steps there, a save, and a trainer over
    ``{"dp": 2}`` (whole heads, every leaf in the plan) restoring it and
    taking 2 more: those losses within ``MP_CUT_RTOL`` of the straight
    run's."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.models.convert import shard_state_dict

    cfg = slice_config("longctx", **SP_CUT)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MAIN["b"], cfg.max_seq_len + 1), device=device,
                           generator=g)
    weights = _full_weights("longctx", **SP_CUT)

    def fresh(axes):
        model = tpp_model(axes, **SP_CUT)
        model.load_state_dict(shard_state_dict(weights, model))
        trainer = _tpp_trainer(axes, model, _adamw(), device)
        state = trainer.init(model)
        return trainer, state, trainer.shard_batch({"tokens": tokens}, global_batch=True)

    def steps(trainer, state, batch, n):
        losses = []
        for _ in range(n):
            state, loss = trainer.train_step(state, batch)
            losses.append(loss.item())
        return state, losses

    trainer, state, batch = fresh({"tp": 2})
    _, straight = steps(trainer, state, batch, 4)
    trainer, state, batch = fresh({"tp": 2})
    state, first = steps(trainer, state, batch, 2)
    directory = os.path.join(_CKPT_DIR["root"], "remesh")
    mgr = bt.BaguaCheckpointManager(directory, async_save=False)
    trainer.save_checkpoint(mgr, 2, state)
    mgr.wait()
    trainer, state, batch = fresh({"dp": 2})
    t0 = time.perf_counter()
    step, state = trainer.restore_checkpoint(mgr, state)
    restore_s = time.perf_counter() - t0
    _, rest = steps(trainer, state, batch, 2)
    mgr.close()
    gap = max(abs(a - b) / abs(b) for a, b in zip(rest, straight[2:]))
    log(f"[rank {rank}] {label} {name}: saved over {{'tp': 2}} after 2 steps, restored over "
        f"{{'dp': 2}} in {restore_s:.3f} s and 2 steps taken: losses {rest} against the "
        f"straight run's {straight[2:]}, largest relative gap {gap:.3g}")
    if not (step == 2 and gap <= MP_CUT_RTOL):
        raise AssertionError(f"[rank {rank}] {name}: restored step {step}, losses {rest} "
                             f"against {straight[2:]}")
    return {"name": name, "kind": "tensor_pipeline", "straight": straight,
            "resumed": first + rest, "remesh_gap": gap, "restore_s": restore_s}


def tensor_pipeline_run(rank, world, run, device, label):
    """One run of the tensor_pipeline phases on this rank; returns its
    record."""
    name, _, kind, kw = run
    return {"full": tpp_full_run, "cut": tpp_cut_run, "generate": tpp_generate_run,
            "remesh": tpp_remesh_run, "vision_stack": vision_stack_run,
            "vision_cut": vision_cut_run}[kind](rank, world, name, device, label, **kw)


def check_tp_generate_remesh(card, tpp):
    """``tp_generate``: tokens and logits bitwise equal on both ranks, the
    logits within ``GEN_LOGITS_RTOL`` of the generate phase's dense decode;
    ``tp_remesh`` (its gate held in the run): prints its gap and restore."""
    gen = tpp["tp_generate"]
    same = all(r["tokens"] == gen[0]["tokens"] and r["logits_digest"] == gen[0]["logits_digest"]
               for r in gen)
    worst = max(r["logits_rel_err"] for r in gen)
    ties = gen[0]["ties"]
    # where the chains part, the dense decode's top-2 margin is within twice
    # the two decodes' gap at that step: a tie the bf16 sums may break
    # either way
    tied = all(t["margin"] <= 2 * t["gap"] for t in ties)
    log(f"tensor_pipeline tp_generate ({card}; gloo through host memory, 2 ranks on one "
        f"card): tokens and logits {'bitwise equal' if same else 'DIFFERENT'} on both ranks, "
        f"logits within {worst:.3g} of the dense decode's on the steps fed the same tokens "
        f"(gate {GEN_LOGITS_RTOL}); greedy tokens "
        + ("equal to the dense decode's" if not ties else
           f"part from the dense decode's at {ties} (each a near tie: "
           f"{'yes' if tied else 'NO'})")
        + f"; {gen[0]['ms_step']:.3f} ms a decode step, {gen[0]['tokens_s']:.1f} tokens/s "
        f"(rank 0; rank 1 {gen[1]['ms_step']:.3f} ms); flash launches {gen[0]['launches']}")
    if not (same and worst <= GEN_LOGITS_RTOL and tied
            and not any(gen[0]["launches"].values())):
        raise AssertionError(f"tensor_pipeline tp_generate: ranks equal {same}, logits error "
                             f"{worst}, ties {ties}")
    rem = tpp["tp_remesh"]
    log(f"tensor_pipeline tp_remesh ({card}): restored across meshes, largest loss gap "
        f"{max(r['remesh_gap'] for r in rem):.3g} (tolerance {MP_CUT_RTOL}), restore "
        f"{max(r['restore_s'] for r in rem):.3f} s")


# ---------------------------------------------------------------------------
# vision (2 ranks): the contrib stack and the SyncBN cut, in the
# tensor_pipeline spawn
# ---------------------------------------------------------------------------

#: (c) ``examples/imagenet_resnet.py``'s stack on a one-block cut of ResNet50
#: (its widths, 1000 classes, 224 px), 16 images a rank drawn from a cached
#: synthetic dataset of 64 samples, ``FULL_STEPS`` steps
VISION_STACK = dict(stage_sizes=(1, 1, 1, 1), per_rank=16, samples=64, lr=0.05)
#: (d) one f32 SGD step of a small cut at world 2 against world 1 (held to
#: ``MP_CUT_RTOL``)
VISION_CUT = dict(stage_sizes=(1, 1), num_filters=16, size=32, per_rank=4, lr=0.1)


class CountingImages:
    """ImageNet-shaped samples (HWC f32 N(0, 1) from the index's seed, and a
    label) whose decodes are counted."""

    def __init__(self, n, size, classes):
        self.size, self.classes = size, classes
        self.decodes = [0] * n

    def __len__(self):
        return len(self.decodes)

    def __getitem__(self, i):
        self.decodes[i] += 1
        img = np.random.default_rng(i).standard_normal((self.size, self.size, 3), np.float32)
        return img, i % self.classes


def _bn_digests(model, norm_type):
    """sha256 of every ``norm_type`` layer's last batch mean and variance."""
    import hashlib

    return {n: hashlib.sha256(torch.cat(m.batch_stats).cpu().numpy().tobytes()).hexdigest()
            for n, m in model.named_modules() if isinstance(m, norm_type)}


def vision_stack_run(rank, world, name, device, label):
    """(c): ``CachedDataset(backend="tcp", num_shards=2)`` (the native
    store server) over 64 counted samples, ``LoadBalancingDistributedSampler``
    shards, batches through ``prefetch_to_device``, ``SyncBatchNorm`` over
    dp, ByteGrad (K1, K2), ``fuse_optimizer(SGD)``; the record the gates of
    :func:`check_vision_ranks` read."""

    import bagua_tpu_torch as bt
    from bagua_tpu_torch.contrib import (CachedDataset, LoadBalancingDistributedSampler,
                                         SyncBatchNorm, fuse_optimizer, prefetch_to_device)
    from bagua_tpu_torch.models.resnet import BatchNorm, ResNet, classification_loss_fn
    from bagua_tpu_torch.ops import codec as cd

    t0 = time.perf_counter()
    cfg = VISION_STACK
    _mp_mesh({"dp": world})
    data = CountingImages(cfg["samples"], VISION["size"], VISION["classes"])
    cached = CachedDataset(data, backend="tcp", dataset_name="imagenet", writer_buffer_size=8,
                           num_shards=2)
    native = all(s.is_native for s in cached.cache_loader.store._servers)
    # the sampler reads each sample's complexity from its metadata (a
    # loader's file sizes), so building it decodes nothing
    sizes = np.random.default_rng(0).integers(1, 1000, cfg["samples"]).tolist()
    sampler = LoadBalancingDistributedSampler(sizes, complexity_fn=int, num_replicas=world,
                                              rank=rank)
    order, epoch = [], 0
    while len(order) < FULL_STEPS * cfg["per_rank"]:
        sampler.set_epoch(epoch)
        order += list(sampler)
        epoch += 1
    order = order[:FULL_STEPS * cfg["per_rank"]]
    misses = []

    def batches():
        for s in range(FULL_STEPS):
            imgs, labels = [], []
            for i in order[s * cfg["per_rank"]:(s + 1) * cfg["per_rank"]]:
                before = data.decodes[i]
                img, lab = cached[i]
                misses.append(data.decodes[i] > before)
                imgs.append(img)
                labels.append(lab)
            yield {"images": torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2),
                   "labels": torch.tensor(labels)}

    model = ResNet(stage_sizes=cfg["stage_sizes"], num_classes=VISION["classes"],
                   norm_cls=functools.partial(SyncBatchNorm, axis_name="dp"), device=device,
                   seed=0)
    opt = fuse_optimizer(functools.partial(torch.optim.SGD, lr=cfg["lr"], momentum=0.9))
    trainer = bt.BaguaTrainer(classification_loss_fn, opt, bt.ByteGradAlgorithm(hierarchical=False),
                              device=device)
    state = trainer.init(model)
    cd.reset_launch_counts()
    staged0 = trainer.host_staged_bytes
    losses, times, last = [], [], None
    t_step = time.perf_counter()
    for batch in prefetch_to_device(batches(), trainer=trainer):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
        times.append(time.perf_counter() - t_step)
        t_step, last = time.perf_counter(), batch
    launches = {k.__name__: k.launches for k in cd.KERNELS}
    bn = _bn_digests(model, SyncBatchNorm)
    twin = ResNet(stage_sizes=cfg["stage_sizes"], num_classes=VISION["classes"], device=device,
                  seed=0)
    twin.load_state_dict(_renamed(model.state_dict(), "SyncBatchNorm", "BatchNorm"))
    with torch.no_grad():
        twin(last["images"], update_stats=False)
    control = _bn_digests(twin, BatchNorm)
    cached.cache_loader.fetcher.flush_write_map()
    num_keys = cached.cache_loader.num_keys()
    cached.cache_loader.store.shutdown()
    record = {
        "name": name, "kind": "vision", "losses": losses, "launches": launches,
        "buckets": len(trainer.plan.buckets), "digests": _flat_digests(trainer, model),
        "bn": [bn[n] for n in sorted(bn)],
        "control": [control[n.replace("SyncBatchNorm_", "BatchNorm_")] for n in sorted(bn)],
        "native": native, "shard": sorted(set(order)), "reads": len(order),
        "first_pass_misses": sum(misses[:len(set(order))]),
        "later_misses": sum(misses[len(set(order)):]),
        "decodes": {str(i): n for i, n in enumerate(data.decodes) if n},
        "num_keys": num_keys, "step_ms": [t * 1e3 for t in times],
        "layout": "resident" if trainer._flat_resident else "leaf",
        "unwrapped": trainer.opt_factory is opt.fused_inner,
        "staged": trainer.host_staged_bytes - staged0, "seconds": time.perf_counter() - t0}
    log(f"[rank {rank}] {label} {name}: losses {losses}, launches {launches} "
        f"({record['buckets']} buckets), cache keys {num_keys}, native store {native}")
    del model, twin, trainer, state, last
    return record


def vision_cut_run(rank, world, name, device, label):
    """(d): one f32 SGD step of ``VISION_CUT`` over ``{"dp": world}`` with
    SyncBN against the world-1 step on the whole batch (every parameter
    within ``MP_CUT_RTOL``); the control, the local norm at world 2, must
    miss that gate.  cuDNN's TF32 is off for the run."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.contrib import SyncBatchNorm
    from bagua_tpu_torch.models.resnet import ResNet, classification_loss_fn

    t0 = time.perf_counter()
    cfg = VISION_CUT
    cudnn = torch.backends.cudnn
    tf32, cudnn.allow_tf32 = cudnn.allow_tf32, False
    sync = functools.partial(SyncBatchNorm, axis_name="dp")

    def make(norm):
        return ResNet(stage_sizes=cfg["stage_sizes"], num_filters=cfg["num_filters"],
                      dtype=torch.float32, norm_dtype=torch.float32, norm_cls=norm,
                      device=device, seed=0)

    try:
        batch = vision_batch(world * cfg["per_rank"], size=cfg["size"], device=device)
        bt.set_global_mesh(None)   # world 1: the whole batch here, the local arithmetic
        full = make(sync)
        before = {n: p.detach().clone() for n, p in full.named_parameters()}
        classification_loss_fn(full, batch).backward()
        with torch.no_grad():
            want = {n: p - cfg["lr"] * p.grad for n, p in full.named_parameters()}
        del full
        _mp_mesh({"dp": world})
        errs = {}
        for kind, norm in (("step", sync), ("control", None)):
            model = make(norm)
            own = before if norm else _renamed(before, "SyncBatchNorm", "BatchNorm")
            model.load_state_dict(own, strict=False)
            trainer = bt.BaguaTrainer(classification_loss_fn,
                                      functools.partial(torch.optim.SGD, lr=cfg["lr"]),
                                      bt.GradientAllReduceAlgorithm(), device=device)
            state = trainer.init(model)
            state, _ = trainer.train_step(state, trainer.shard_batch(batch, global_batch=True))
            got = trainer.unstack_params(state)
            if norm is None:
                got = _renamed(got, "BatchNorm", "SyncBatchNorm")
            err = {n: rel_err(got[n], want[n]) for n in want}
            worst = max(err, key=err.get)
            errs[kind] = (err[worst], worst)
            del model, trainer, state
    finally:
        cudnn.allow_tf32 = tf32
    log(f"[rank {rank}] {label} {name}: one f32 SGD step at world {world} with SyncBN against "
        f"world 1 on the {world * cfg['per_rank']} images, largest parameter error "
        f"{errs['step'][0]:.3g} ({errs['step'][1]}); the control (the local norm) "
        f"{errs['control'][0]:.3g} ({errs['control'][1]})")
    if not errs["step"][0] <= MP_CUT_RTOL < errs["control"][0]:
        raise AssertionError(f"[rank {rank}] {name}: the step differs from world 1 ({errs}), or "
                             f"the gate could not see the control")
    return {"name": name, "kind": "vision", "cut_err": errs["step"][0],
            "cut_control_err": errs["control"][0], "seconds": time.perf_counter() - t0}


def check_vision_ranks(card, tpp):
    """(c)'s gates across the ranks: losses finite, parameters bitwise equal,
    K1 = buckets x steps and K2 twice that on each rank, every SyncBN
    layer's last batch mean and variance bitwise equal on both ranks and the
    local-norm control's different, the sampler shards disjoint and covering
    the dataset, every drawn sample decoded once and every read after a
    rank's first pass a hit, the cache's keys the distinct samples drawn,
    the native store server; prints (c)'s and (d)'s results."""
    recs, cut = tpp["vision_stack"], tpp["vision_cut"]
    r0 = recs[0]
    want = {"compress_chunked": r0["buckets"] * FULL_STEPS,
            "decompress_chunked": 2 * r0["buckets"] * FULL_STEPS}
    shards = [set(r["shard"]) for r in recs]
    problems = []
    if not all(math.isfinite(x) for r in recs for x in r["losses"]):
        problems.append("non-finite losses")
    if any(r["digests"] != r0["digests"] for r in recs):
        problems.append("parameters differ between the ranks")
    for r, rec in enumerate(recs):
        got = {k: rec["launches"][k] for k in want}
        others = {k: v for k, v in rec["launches"].items() if k not in want and v}
        if got != want or others:
            problems.append(f"rank {r} launches {rec['launches']}, expected {want}")
        decoded = {int(i): n for i, n in rec["decodes"].items()}
        if not (set(decoded) == set(rec["shard"]) and set(decoded.values()) == {1}
                and rec["later_misses"] == 0 and rec["first_pass_misses"] == len(rec["shard"])
                and rec["num_keys"] == len(rec["shard"]) and rec["native"]):
            problems.append(f"rank {r} cache: decodes {rec['decodes']}, misses "
                            f"{rec['first_pass_misses']} + {rec['later_misses']}, keys "
                            f"{rec['num_keys']}, native {rec['native']}")
    if any(r["bn"] != r0["bn"] for r in recs):
        problems.append("SyncBN batch statistics differ between the ranks")
    if any(a == b for a, b in zip(r0["control"], recs[1]["control"])):
        problems.append("the local-norm control's statistics agree between the ranks")
    if shards[0] & shards[1] or shards[0] | shards[1] != set(range(VISION_STACK["samples"])):
        problems.append(f"sampler shards overlap or miss samples: {shards}")
    log(f"vision (2 ranks) (c) {card}: ResNet{VISION_STACK['stage_sizes']} (one block a "
        f"stage, ResNet50's widths), {VISION_STACK['per_rank']} images a rank, {FULL_STEPS} "
        f"steps of ByteGrad "
        f"with SyncBN over dp and fuse_optimizer(SGD) ({r0['layout']} layout, "
        f"{'fused_inner unwrapped' if r0['unwrapped'] else 'wrapper'}): losses {r0['losses']}; "
        f"parameters bitwise equal on both ranks; launches K1 "
        f"{r0['launches']['compress_chunked']}, K2 {r0['launches']['decompress_chunked']} "
        f"({r0['buckets']} buckets); {len(r0['bn'])} SyncBN layers' last batch statistics "
        f"bitwise equal on both ranks, the local-norm control's differing in "
        f"{sum(a != b for a, b in zip(r0['control'], recs[1]['control']))}; shards of "
        f"{[len(s) for s in shards]} samples, disjoint; each rank decoded each of its samples "
        f"once in {r0['reads']} reads, cache keys {[r['num_keys'] for r in recs]}, native "
        f"store {[r['native'] for r in recs]}; step ms (host, rank 0) "
        f"{[round(t, 3) for t in r0['step_ms']]}; host-staged {r0['staged']} bytes; "
        f"{r0['seconds']:.1f} s")
    log(f"vision (2 ranks) (d) {card}: one f32 SGD step at world 2 with SyncBN against world "
        f"1, largest parameter error {max(r['cut_err'] for r in cut):.3g} (tolerance "
        f"{MP_CUT_RTOL}); the control (the local norm) "
        f"{min(r['cut_control_err'] for r in cut):.3g}; {cut[0]['seconds']:.1f} s")
    if problems:
        raise AssertionError(f"vision (2 ranks): {problems}")


def check_tensor_pipeline(card, tpp, tpp4, slice1_losses):
    """The phase's gates across ranks and against slice 1: each full-width
    run's losses equal on both ranks and within ``MP_LOSS_RTOL`` of slice
    1's world-1 losses, its dense leaves bitwise equal on both ranks, its
    sharded leaves different (each rank its own slice); prints the runs'
    steps, bytes and peaks and the cuts' errors beside the card."""
    for name in ("tp_full", "pp_full"):
        recs = tpp[name]
        if any(r["digests"] != recs[0]["digests"] or r["losses"] != recs[0]["losses"]
               for r in recs):
            raise AssertionError(f"tensor_pipeline {name}: dense parameters or losses differ "
                                 "between ranks")
        if len({r["sharded_digest"] for r in recs}) != len(recs):
            raise AssertionError(f"tensor_pipeline {name}: two ranks hold the same slice")
        want = slice1_losses[:FULL_STEPS]
        gap = [abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"], want)]
        log(f"tensor_pipeline {name}: losses {recs[0]['losses']} against world 1 {want}: "
            f"largest relative gap {max(gap):.3g}; dense parameters bitwise equal on both "
            f"ranks, sharded ones different; plan {len(recs[0]['plan'])} tensors over a world "
            f"of {recs[0]['world']}")
        if not max(gap) <= MP_LOSS_RTOL:
            raise AssertionError(f"tensor_pipeline {name}: losses off slice 1's by {gap} "
                                 f"(tolerance {MP_LOSS_RTOL})")
        for r, rec in enumerate(recs):
            st = rec["stats"]
            log(f"tensor_pipeline {name} rank {r} ({card}; gloo through host memory, 2 ranks "
                f"on one card): median step {st['median_ms']:.3f} ms (steps 2-{FULL_STEPS}), "
                f"{st['tokens_s']:.1f} tokens/s, peak {st['peak_gb']:.3f} GB "
                f"({rec['layout']} layout), host-staged {rec['staged_bytes_step']:.0f} bytes a "
                f"step: the axis's collectives {rec['axis_bytes_step']:.0f}, the bucket "
                f"collectives {rec['bucket_bytes_step']:.0f}; one profiled step's device ms "
                f"{json.dumps({k: round(v, 3) for k, v in rec['kernel_ms'].items()})}")
    check_tp_generate_remesh(card, tpp)
    for name, recs in list(tpp.items()) + list(tpp4.items()):
        if "param_err" in recs[0]:
            log(f"tensor_pipeline {name} ({card}): one SGD step against world 1, largest "
                f"parameter error {max(r['param_err'] for r in recs):.3g} (tolerance "
                f"{MP_CUT_RTOL}); the control ({recs[0]['control']}) "
                f"{min(r['control_err'] for r in recs):.3g}"
                + ("; the checkpoint resumed bitwise on every rank"
                   if "resume_bitwise" in recs[0] else ""))


def recording_collectives(run_fn, rank, world, run, device, label):
    """``run_fn``'s record with the collective log of its run
    (``record["collectives"]``): every blocking communicator call, its group's
    mesh axes, dtype, shape and tag, and the span of the log each
    ``train_step`` made, with the plan's bucket sizes then.  The trainer's ``train_step`` is wrapped for
    the run to mark the steps (and to learn the trainer's communicators at
    its first step); recording reads metadata only."""
    from bagua_tpu_torch.analysis import collective_check as cc
    from bagua_tpu_torch.core.backend import BaguaTrainer

    rec = cc.CollectiveRecorder()
    spans, plans, mesh = [], [], []
    plain = BaguaTrainer.train_step

    def train_step(self, state, batch):
        if not spans:
            rec.axes_of.update(cc.communicator_axes(self))
            mesh.extend(self.mesh.axis_names if self.mesh is not None else ("dp",))
        plans.append([[b.padded_numel, str(b.dtype).replace("torch.", "")]
                      for b in self.plan.buckets])
        start = len(rec.log)
        out = plain(self, state, batch)
        spans.append((start, len(rec.log)))
        return out

    BaguaTrainer.train_step = train_step
    try:
        with rec:
            record = run_fn(rank, world, run, device, label)
    finally:
        BaguaTrainer.train_step = plain
    record["collectives"] = {"log": [c.to_json() for c in rec.log], "tags": rec.buckets,
                             "spans": spans, "plans": plans, "mesh_axes": mesh,
                             "world": world}
    return record


def check_collectives(both):
    """(f) of the overlap phase: each pair of ``COLLECTIVE_PAIRS``, every rank,
    the first ``FULL_STEPS`` steps: the multiset of the overlapped step's
    collectives equal to the serialized one's (the plan's upkeep apart),
    every collective's axes bound on the mesh, every bucket of the step's
    plan with at least one collective; the ranks' logs the same sequence a
    group of axes."""
    from bagua_tpu_torch.analysis import collective_check as cc

    def steps_of(rec):
        c = rec["collectives"]
        out = []
        for (lo, hi), plan in list(zip(c["spans"], c["plans"]))[:FULL_STEPS]:
            out.append({"log": [cc.Collective.from_json(x) for x in c["log"][lo:hi]],
                        "buckets": c["tags"][lo:hi], "mesh_axes": c["mesh_axes"],
                        "plan": cc.PlanRows(plan), "world": c["world"]})
        return out

    findings, summary = [], []
    for ovl_name, ser_name in COLLECTIVE_PAIRS:
        for r in range(len(both[ovl_name])):
            ovl, ser = steps_of(both[ovl_name][r]), steps_of(both[ser_name][r])
            if len(ovl) != FULL_STEPS or len(ser) != FULL_STEPS:
                raise AssertionError(f"collectives: {ovl_name}/{ser_name} rank {r} recorded "
                                     f"{len(ovl)} and {len(ser)} steps, not {FULL_STEPS}")
            for s in range(FULL_STEPS):
                f, report = cc.check_equivalence(f"{ovl_name}/{ser_name}:step{s}", 1,
                                                 {"off": ser[s], "on": ovl[s]})
                findings.extend(f)
                for side in ("serialized", "overlap"):
                    rows = [row for row in report[side]["buckets"]
                            if isinstance(row["bucket"], int)]
                    empty = [row["bucket"] for row in rows if not row["collectives"]]
                    if not rows or empty:
                        raise AssertionError(f"collectives: {ovl_name}/{ser_name} rank {r} "
                                             f"step {s} {side}: buckets without a "
                                             f"collective {empty}")
                if r == 0:
                    summary.append(
                        f"{ovl_name}/{ser_name} step {s}: {len(report['overlap']['collectives'])}"
                        f" collectives over {len(ovl[s]['plan'].buckets)} buckets, "
                        f"{'equal' if report['equal'] else 'DIFFER'}, "
                        f"{report['overlap']['total_wire_bytes']} wire bytes, plan upkeep "
                        f"{len(report['overlap']['plan_collectives'])}")
        for name in (ovl_name, ser_name):
            findings.extend(cc.check_rank_agreement(
                [[x for s in steps_of(rec) for x in s["log"]] for rec in both[name]],
                context=name))
    log("overlap (f), the collective log: " + "; ".join(summary))
    if findings:
        raise AssertionError("collectives: " + "\n".join(f.render() for f in findings))


def multi_rank_worker(phase, rank, init_method, out_path, device="cuda"):
    """One rank of a multi-rank spawn: every run of the phase of
    ``MULTI_RANK`` (and of those ``SPAWNS`` joins to it), records to
    ``out_path`` as JSON."""
    import bagua_tpu_torch as bt

    _, _, world, intra = MULTI_RANK[phase]
    device = torch.device(device)
    bt.init_process_group(init_method, world_size=world, rank=rank, device=device,
                          backend="gloo", intra_size=intra)
    # the sidecar (rank 0, where the spawn set BAGUA_SERVICE_PORT) read its
    # settings at the init above; the phases' other trainers stay untuned
    os.environ.pop("BAGUA_AUTOTUNE", None)
    _CKPT_DIR["root"] = os.path.join(os.path.dirname(os.path.abspath(out_path)), "ckpt")
    _CKPT_DIR["chaos"] = os.path.join(os.path.dirname(os.path.abspath(out_path)), "chaos")
    records = []
    for sub in SPAWNS.get(phase, (phase,)):
        label, runs = MULTI_RANK[sub][:2]
        run_fn = {"async": async_run, "features": features_run, "overlap": overlap_run,
                  "autotune": autotune_run,
                  "checkpoint": checkpoint_run, "model_parallel": model_parallel_run,
                  "tensor_pipeline": tensor_pipeline_run,
                  "tensor_pipeline_4": tensor_pipeline_run, "chaos": chaos_run,
                  "chaos_4": chaos_run}.get(sub, compressed_run)
        for run in runs:
            t0 = time.perf_counter()
            if any(run[0] in pair for pair in COLLECTIVE_PAIRS):
                records.append(recording_collectives(run_fn, rank, world, run, device, label))
            else:
                records.append(run_fn(rank, world, run, device, label))
            records[-1].setdefault("seconds", time.perf_counter() - t0)
            records[-1]["label"] = label
            if device.type == "cuda":
                release()
    with open(out_path, "w") as f:
        json.dump(records, f)
    torch.distributed.destroy_process_group()


def phase_multi_rank(phase):
    """Start the phase's ranks (with the phases ``SPAWNS`` joins to it) as
    processes of this script on the one card and check them; fails if any
    rank fails or the spawn outlasts ``WORKER_TIMEOUT``.  Returns every
    rank's record by run name."""
    label, _, world, intra = MULTI_RANK[phase]
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        env = dict(os.environ)
        if "autotune" in SPAWNS.get(phase, (phase,)):
            # rank 0's init_process_group serves the autotune sidecar
            env.update(AUTOTUNE_SERVICE, BAGUA_SERVICE_PORT=str(_free_port()),
                       MASTER_ADDR="127.0.0.1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--worker", phase, str(r), init, outs[r]], env=env)
                 for r in range(world)]
        deadline = time.monotonic() + WORKER_TIMEOUT * len(SPAWNS.get(phase, (phase,)))
        try:
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if codes != [0] * world:
            raise AssertionError(f"{label} ranks exited with {codes}")
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    for runs in zip(*ranks):
        name, label = runs[0]["name"], runs[0]["label"]
        if runs[0].get("kind") in ("eager", "checkpoint", "model_parallel", "tensor_pipeline",
                                   "vision", "autotune", "chaos"):
            continue
        if runs[0]["fingerprints"] is not None:
            check_gossip(label, runs, intra or 1)
        elif any(r["digests"] != runs[0]["digests"] for r in runs):
            raise AssertionError(f"{label} {name}: parameters differ between the ranks")
        if any(r["losses"] != runs[0]["losses"] for r in runs):
            raise AssertionError(f"{label} {name}: losses differ between the ranks")
        for r, rec in enumerate(runs):
            st = rec["stats"]
            log(f"{label} {name} rank {r} (gloo through host memory, {world} ranks on one "
                f"card): step {st['step_ms']:.3f} ms (steps 2-{len(rec['losses'])} as one "
                f"window; median "
                f"{st['median_ms']:.3f} ms; first {st['first_ms']:.3f} ms), "
                f"{st['tokens_s']:.1f} tokens/s, peak memory {st['peak_gb']:.3f} GB "
                f"({st['layout']} layout), host-staged {rec['host_staged_bytes']} bytes in "
                f"{len(rec['losses'])} steps, "
                f"optimizer state {rec['opt_state_bytes']} bytes, "
                f"{rec['buckets']} buckets, launches {rec['launches']}; forward+backward "
                f"alone (no communication) {rec['fwd_bwd_ms']:.3f} ms; the run "
                f"{rec['seconds']:.1f} s")
        if runs[0]["digests"] is not None:
            log(f"{label} {name}: parameters bitwise equal on all {world} ranks "
                f"({len(runs[0]['digests'])} bucket digests)")
    log(f"{label} spawn ({', '.join(SPAWNS.get(phase, (phase,)))}): seconds by run on rank 0 "
        + str({runs[0]["name"]: round(runs[0]["seconds"], 1) for runs in zip(*ranks)}))
    return {runs[0]["name"]: list(runs) for runs in zip(*ranks)}


def check_gossip(label, runs, intra):
    """The gossip families' gates on every rank's per-step fingerprints of
    every bucket.  ``all``: the peer weights equal on every rank after every
    step; ``shift_one``: rank r's equal those of ``shift_one_peer(r, world,
    step)``; the low-precision ring: rank r's ``left`` replica equal to its
    left ring neighbour's ``self``, ``right`` to its right neighbour's, its
    parameters to its own ``self`` (the ring runs over the inter-node tier
    where hierarchical: the ranks of r's local index, ``intra`` apart).  In
    each, the parameters of the first and the last rank differ after the
    last step (at 2 x 2 the two ranks of a node hold the same average)."""
    from bagua_tpu_torch.algorithms.decentralized import shift_one_peer

    name, world = runs[0]["name"], len(runs)
    fp = [r["fingerprints"] for r in runs]
    mode = runs[0]["peer_selection_mode"]
    n_buckets, steps = len(fp[0]["params"][0]), len(fp[0]["params"])
    bad = []
    for step in range(steps):
        for r in range(world):
            if mode == "all":
                pairs = [("peer_weights", r, "peer_weights", 0)]
            elif mode == "shift_one":
                pairs = [("peer_weights", r, "peer_weights", shift_one_peer(r, world, step))]
            else:
                ring = intra if runs[0]["hierarchical"] else 1
                n, i, local = world // ring, r // ring, r % ring
                pairs = [("left", r, "self", ((i - 1) % n) * ring + local),
                         ("right", r, "self", ((i + 1) % n) * ring + local),
                         ("params", r, "self", r)]
            bad += [(step, a, p, b, q) for a, p, b, q in pairs
                    if fp[p][a][step] != fp[q][b][step]]
    differ = fp[0]["params"][-1] != fp[-1]["params"][-1]
    what = {"all": "peer weights equal on every rank",
            "shift_one": "peer weights equal to those of the step's shift_one partner"}.get(
        mode, "left == left neighbour's self, right == right neighbour's self, "
        "params == self")
    log(f"{label} {name}: {what} after each of the {steps} steps in all {n_buckets} buckets "
        f"on all {world} ranks: {'yes' if not bad else f'NO at {bad[:5]}'}; parameters of "
        f"ranks 0 and {world - 1} {'differ' if differ else 'EQUAL'} after the last step")
    if bad or not differ:
        raise AssertionError(f"{label} {name}: gossip gate failed: mismatches "
                             f"(step, key, rank, key, rank) {bad[:10]}; ranks differ {differ}")


def check_async(runs, replicated, gossip):
    """The async phase's gates on every rank's record: the same period,
    launches, catch-ups and status after every step on both ranks (applies
    are local: a partitioned rank drops its rounds);
    the ranks' parameters differ after the window and are bitwise equal
    after ``barrier`` and ``sync_for_checkpoint``; the staged bytes exactly
    two copies (to the host and back) of the f32 weights a round, a warmup
    step or a catch-up, plus 8 bytes a step for the loss.  The full run must
    have launched and applied a round inside the window; the partition run
    catches up at the same step on both ranks, bitwise equal right after it,
    its lag within the cap; the abort run's status turns at the same step on
    both ranks.  Logs each run's schedule, step times and waits beside the
    replicated and ``all`` gossip runs of BERT-Large from the same call."""
    for name, recs in runs.items():
        r0 = recs[0]
        ps = [r["per_step"] for r in recs]
        for key in ("launched", "catchups", "status"):
            if any(p[key] != ps[0][key] for p in ps):
                raise AssertionError(f"async {name}: {key} differs between the ranks: "
                                     f"{[p[key] for p in ps]}")
        if any(r["period"] != r0["period"] for r in recs):
            raise AssertionError(f"async {name}: periods {[r['period'] for r in recs]}")
        if r0["digests_window"] == recs[-1]["digests_window"]:
            raise AssertionError(f"async {name}: the ranks' parameters are equal after the "
                                 f"window")
        launched, applied = ps[0]["launched"][-1], ps[0]["applied"][-1]
        warm = min(r0["warmup_steps"], STEPS)
        for r, rec in enumerate(recs):
            want = ((launched + warm + len([c for c in rec["catchups"]
                                             if c["reason"] == "staleness"]))
                    * 2 * 4 * rec["padded_numel"] + STEPS * 8)
            if rec["host_staged_bytes"] != want:
                raise AssertionError(f"async {name} rank {r}: staged {rec['host_staged_bytes']} "
                                     f"bytes, expected {want}")
        waits = [[round(w * 1e3, 3) for w in p["wait_s"]] for p in ps]
        st = r0["stats"]
        log(f"async {name}: period {r0['period']} steps (agreed step time "
            f"{None if r0['agreed_dt'] is None else round(r0['agreed_dt'] * 1e3, 3)} ms), "
            f"{launched} rounds launched and {applied} applied in {STEPS} steps (launched "
            f"after each step {ps[0]['launched']}, status {ps[0]['status']}); step "
            f"{st['step_ms']:.3f} ms (median {st['median_ms']:.3f}), {st['tokens_s']:.1f} "
            f"tokens/s, peak {st['peak_gb']:.3f} GB; staged {r0['host_staged_bytes']} bytes "
            f"(exact); wait in work.wait() after each step (ms, rank by rank) {waits}; "
            f"a round alone {r0['round_ms']:.3f} ms; one blocking average of every bucket "
            f"(sync_for_checkpoint) {r0['sync_ms']:.3f} ms; digests equal on both ranks "
            f"after it")
        if name == "async":
            if not (applied >= 1 and r0["period"] is not None):
                raise AssertionError(f"async: no round applied in the window ({applied})")
            times = [round(t, 3) for t in r0["stats"]["times_ms"]]
            log(f"async: step times (ms) {times}; peak {st['peak_gb']:.3f} GB against the "
                f"replicated run's {replicated['stats']['peak_gb']:.3f} "
                f"({st['peak_gb'] - replicated['stats']['peak_gb']:+.3f}); step "
                f"{st['step_ms']:.3f} ms (median {st['median_ms']:.3f}) against the replicated "
                f"run's {replicated['stats']['step_ms']:.3f} (median "
                f"{replicated['stats']['median_ms']:.3f}) and decentralized all's on "
                f"{gossip['layers']} layers {gossip['stats']['step_ms']:.3f} (median "
                f"{gossip['stats']['median_ms']:.3f}); "
                f"{st['tokens_s']:.1f} tokens/s against {replicated['stats']['tokens_s']:.1f} "
                f"and {gossip['stats']['tokens_s']:.1f}; forward+backward alone "
                f"{r0['fwd_bwd_ms']:.3f} ms")
        if name == "async_partition":
            steps = [[c["step"] for c in r["catchups"] if c["reason"] == "staleness"]
                     for r in recs]
            lag = max(a - b for a, b in zip(ps[0]["launched"], ps[-1]["applied"]))
            equal = all(c["digests"] == recs[0]["catchups"][i]["digests"]
                        for r in recs for i, c in enumerate(r["catchups"]))
            log(f"async_partition: catch-ups at steps {steps} (rank by rank), digests equal "
                f"right after each: {equal}; largest lag {lag} (cap "
                f"{r0['max_staleness_rounds']})")
            if not (steps[0] and all(s == steps[0] for s in steps) and equal
                    and lag <= r0["max_staleness_rounds"]):
                raise AssertionError(f"async_partition: catch-ups {steps}, equal {equal}, "
                                     f"lag {lag}")
        if name == "async_abort":
            status = ps[0]["status"]
            want = ([0] * ASYNC_ABORT_AFTER + [1] * (ASYNC_RESUME_AFTER - ASYNC_ABORT_AFTER)
                    + [0] * (STEPS - ASYNC_RESUME_AFTER))
            if status != want:
                raise AssertionError(f"async_abort: status {status}, expected {want}")


def check_zero(zero):
    """ZeRO's full BERT-Large run against the replicated one of the same
    call: its optimizer state a rank exactly half (``1 / world``; BERT-Large's
    buckets need no padding at world 2), its peak memory below."""
    sharded, full = zero["zero"], zero["replicated"]
    log(f"zero: optimizer state {sharded['opt_state_bytes']} bytes a rank against the "
        f"replicated run's {full['opt_state_bytes']} (ratio "
        f"{sharded['opt_state_bytes'] / full['opt_state_bytes']:.6f}); peak memory "
        f"{sharded['stats']['peak_gb']:.3f} GB against {full['stats']['peak_gb']:.3f} GB; step "
        f"{sharded['stats']['step_ms']:.3f} ms against {full['stats']['step_ms']:.3f} ms; "
        f"staged {sharded['host_staged_bytes']} bytes against {full['host_staged_bytes']}")
    if not (sharded["padded_numel"] == full["params"]
            and CODEC_WORLD * sharded["opt_state_bytes"] == full["opt_state_bytes"]
            and sharded["stats"]["peak_gb"] < full["stats"]["peak_gb"]):
        raise AssertionError(f"ZeRO's state or peak: {sharded['opt_state_bytes']} bytes, "
                             f"{sharded['stats']['peak_gb']} GB against "
                             f"{full['opt_state_bytes']}, {full['stats']['peak_gb']}")


def check_features(feat, zero):
    """The features phase's gates on every rank's record (see
    ``FEATURES_RUNS``): (a) the leaf-layout ZeRO's per-step fingerprints of
    every bucket equal to the resident ZeRO's of the zero phase over its first
    ``FULL_STEPS`` steps on each rank (one chunk update in either layout), and
    the resident peak at least ``RESIDENT_PEAK_DROP_GB`` below; (b) the
    accumulated, guarded losses within ``ACCUM_LOSS_RTOL`` of the cut's
    ``no_rebucket`` run at every step, every verdict healthy; (c) the two clean 1-bit runs bitwise equal, and then the
    poisoned run's parameters and residual bitwise equal to the clean run's
    (else within ten times the clean runs' own difference), one skipped step
    and one fire on each rank; (d) the rebucketed run's parameters bitwise
    equal to the run without it, AdamW's state on the new plan, and the 1-bit
    residual carried onto the new plan, finite and nonzero."""
    ranks = range(len(feat["zero_leaf"]))
    leaf, res = feat["zero_leaf"], zero["zero"]
    fp_equal = all(leaf[r]["param_fingerprints"] == res[r]["param_fingerprints"][:FULL_STEPS]
                   for r in ranks)
    drop = [leaf[r]["stats"]["peak_gb"] - res[r]["stats"]["peak_gb"] for r in ranks]
    log(f"features (a): ZeRO on BERT-Large, leaf layout peak "
        f"{[round(r['stats']['peak_gb'], 3) for r in leaf]} GB and step "
        f"{[round(r['stats']['step_ms'], 3) for r in leaf]} ms against the zero phase's "
        f"resident run's {[round(r['stats']['peak_gb'], 3) for r in res]} GB and "
        f"{[round(r['stats']['step_ms'], 3) for r in res]} ms (rank by rank; drop "
        f"{[round(d, 3) for d in drop]} GB); per-step bucket fingerprints "
        f"{'equal' if fp_equal else 'DIFFER'} over {len(leaf[0]['param_fingerprints'])} steps")
    if not (fp_equal and len(leaf[0]["param_fingerprints"]) == FULL_STEPS
            and min(drop) >= RESIDENT_PEAK_DROP_GB):
        raise AssertionError(f"features (a): fingerprints equal {fp_equal}, peak drop {drop}")
    acc, rep = feat["accum_guard"][0], feat["no_rebucket"][0]
    gap = max(abs(a - b) / abs(b) for a, b in zip(acc["losses"], rep["losses"]))
    st = acc["stats"]
    log(f"features (b): GradientAllReduce on the cut, 2 microbatches of 4, guard skip: "
        f"losses within {gap:.3g} of the run without accumulation; verdicts {acc['healthy']}; "
        f"step {st['step_ms']:.3f} ms (median {st['median_ms']:.3f}) against that run's "
        f"{rep['stats']['step_ms']:.3f}, peak {st['peak_gb']:.3f} GB ({st['layout']} layout) "
        f"against {rep['stats']['peak_gb']:.3f} GB; the guard's verdict and host read "
        f"{acc['guard_ms']:.3f} ms, {acc['guard_ms'] / st['step_ms']:.3%} of the step")
    if not (gap <= ACCUM_LOSS_RTOL and acc["healthy"] == [1.0] * FULL_STEPS
            and len(acc["losses"]) == FULL_STEPS):
        raise AssertionError(f"features (b): loss gap {gap}, verdicts {acc['healthy']}")
    for r in ranks:
        again, poisoned = feat["onebit_clean_again"][r], feat["onebit_poison"][r]
        exact = again["against"]["params_equal"] and again["against"]["ef_equal"]
        tol = 10 * max(again["against"]["params_max_abs"], again["against"]["ef_max_abs"])
        got = poisoned["against"]
        same = (got["params_equal"] and got["ef_equal"] if exact else
                max(got["params_max_abs"], got["ef_max_abs"]) <= tol)
        log(f"features (c) rank {r}: two clean 1-bit runs "
            f"{'bitwise equal' if exact else 'DIFFER'} "
            f"({again['against']}); the run poisoned at step {POISON_AT} against the clean run "
            f"of {POISON_STEPS - 1} steps: {got}; counters {poisoned['counters']}; verdicts "
            f"{poisoned['healthy']}")
        if not (same and poisoned["counters"]["grad_guard/skipped_steps"] == 1
                and poisoned["counters"]["faults/grad.poison/fired"] == 1
                and poisoned["healthy"][POISON_AT] == 0.0 and poisoned["ef_finite"]):
            raise AssertionError(f"features (c) rank {r}: {got}, {poisoned['counters']}")
        reb, onebit = feat["rebucket"][r], feat["onebit_rebucket"][r]
        log(f"features (d) rank {r}: rebucket after step {REBUCKET_AFTER} to "
            f"{len(reb['plan_sizes'])} buckets: parameters against the run without it "
            f"{reb['against']}; AdamW on the new plan {reb['opt_on_new_plan']}; the 1-bit run's "
            f"residual on {onebit['ef_sizes'] == onebit['plan_sizes']} the new plan "
            f"({len(onebit['plan_sizes'])} buckets), L1 {onebit['ef_norm']}, finite "
            f"{onebit['ef_finite']}; steps {reb['stats']['step_ms']:.3f} ms and "
            f"{onebit['stats']['step_ms']:.3f} ms")
        if not (reb["against"]["params_equal"] and reb["opt_on_new_plan"]
                and len(reb["plan_sizes"]) > len(feat["no_rebucket"][r]["plan_sizes"])
                and onebit["ef_sizes"] == onebit["plan_sizes"] and onebit["ef_finite"]
                and onebit["ef_norm"] > 0):
            raise AssertionError(f"features (d) rank {r}: {reb['against']}, "
                                 f"{reb['opt_on_new_plan']}, {onebit['ef_sizes']}")


def _fp_total(fps):
    """A step's fingerprint of all parameters whatever the plan: the sum of
    its buckets' fingerprints modulo 2^64 (each a wrapping sum over its
    tensors' elements)."""
    return sum(fps) % 2 ** 64


def check_overlap(ov, zero):
    """The overlap phase's gates on every rank's record (``OVERLAP_RUNS``):
    (a) the overlapped GradientAllReduce's parameters bitwise equal to the
    serialized run's after every step; (b) every K1 and K2 launch of the
    overlapped ByteGrad made on the comm stream by the comm worker, its
    parameters bitwise equal to the serialized run on the same plan after
    every step; (c) the overlapped ZeRO's per-step fingerprints equal to the
    zero phase's serialized run's, its state exactly ``1 / world`` of the
    replicated run's, the peak of the bytes it requests from the allocator
    no higher than the serialized run's (``requested_peak_bytes``: the
    allocated peak adds the caching allocator's rounding of each block, which
    depends on the process's history and, overlapped, on the two threads'
    interleaving; the same run has read 0.1-0.5 MB apart there); (d) the
    chunked ring's losses within ``RING_LOSS_RTOL`` of the fused run's.
    Launches, the captured kernel calls against plain and the eager
    collectives were checked in the ranks.  Logs the step times, the wait
    after the backward and the share of the serialized communication that
    the overlap hides."""
    ranks = range(len(ov["ga_serial"]))
    totals = {name: [[_fp_total(fp) for fp in ov[name][r]["param_fingerprints"]] for r in ranks]
              for name in ov if ov[name][0].get("kind") != "eager"}
    for a, b in (("ga_overlap", "ga_serial"), ("bytegrad_overlap", "bytegrad_serial")):
        equal = totals[a] == totals[b] and len(totals[a][0]) == FULL_STEPS
        log(f"overlap: {a} against {b}: parameters after every step "
            f"{'bitwise equal' if equal else 'DIFFER'} ({totals[a][0]} / {totals[b][0]})")
        if not equal:
            raise AssertionError(f"overlap: {a}'s parameters differ from {b}'s")
    for name in ("ga_serial", "ga_overlap", "bytegrad_overlap", "bytegrad_serial", "zero_overlap",
                 "ring_fused", "ring_chunked", "ring_int8", "ring_onebit"):
        for r in ranks:
            rec = ov[name][r]
            t = rec["times"]
            log(f"overlap {name} rank {r}: step {rec['stats']['step_ms']:.3f} ms (median "
                f"{rec['stats']['median_ms']:.3f}), backward to the end of the main stream "
                f"{statistics.median(t['backward_ms'][1:]):.3f} ms, "
                f"{'wait after the backward' if rec['overlap'] else 'communication'} "
                f"{statistics.median(t['comm_ms'][1:]):.3f} ms (medians of steps 2-"
                f"{len(t['comm_ms'])}), forward+backward alone {rec['fwd_bwd_ms']:.3f} ms, "
                f"peak {rec['stats']['peak_gb']:.3f} GB, staged {rec['host_staged_bytes']} bytes")
    for a, b in (("ga_overlap", "ga_serial"), ("bytegrad_overlap", "bytegrad_serial")):
        for r in ranks:
            wait = statistics.median(ov[a][r]["times"]["comm_ms"][1:])
            comm = statistics.median(ov[b][r]["times"]["comm_ms"][1:])
            log(f"overlap: {a} rank {r}: the wait after the backward {wait:.3f} ms against "
                f"{b}'s communication {comm:.3f} ms: {1 - wait / comm:.2%} of it hidden; step "
                f"{ov[a][r]['stats']['step_ms']:.3f} ms against {ov[b][r]['stats']['step_ms']:.3f}")
    for r in ranks:
        taps = ov["bytegrad_overlap"][r]["codec_launches"]
        n = sum(len(k) for k in ov["bytegrad_overlap"][r]["ks_per_step"])
        log(f"overlap: bytegrad_overlap rank {r}: codec launches by stream and thread {taps}")
        if not (taps.get("bagua_minmax_compress") == {"comm stream, comm worker": n}
                and taps.get("bagua_minmax_decompress") == {"comm stream, comm worker": 2 * n}):
            raise AssertionError(f"overlap: ByteGrad's K1/K2 launches {taps}, expected {n} and "
                                 f"{2 * n} on the comm stream")
    z, ser, rep = ov["zero_overlap"], zero["zero"], zero["replicated"]
    for r in ranks:
        want = [_fp_total(fp) for fp in ser[r]["param_fingerprints"][:FULL_STEPS]]
        zst, sst = z[r]["stats"], ser[r]["stats"]
        gates = {
            "fingerprints": totals["zero_overlap"][r] == want,
            "state": CODEC_WORLD * z[r]["opt_state_bytes"] == rep[r]["opt_state_bytes"],
            "padding": z[r]["padded_numel"] == rep[r]["params"],
            "requested peak": (zst["requested_peak_bytes"] is not None
                               and zst["requested_peak_bytes"] <= sst["requested_peak_bytes"]),
        }
        log(f"overlap: zero_overlap rank {r}: per-step fingerprints "
            f"{'equal' if gates['fingerprints'] else 'DIFFER'} to the zero phase's "
            f"serialized run; optimizer state {z[r]['opt_state_bytes']} bytes against the "
            f"replicated {rep[r]['opt_state_bytes']}; peak requested "
            f"{zst['requested_peak_bytes']} bytes against the serialized "
            f"{sst['requested_peak_bytes']} (allocated {zst['peak_gb'] * 1e9:.0f} against "
            f"{sst['peak_gb'] * 1e9:.0f}); step {zst['step_ms']:.3f} ms against "
            f"{sst['step_ms']:.3f}")
        failed = [name for name, ok in gates.items() if not ok]
        if failed:
            raise AssertionError(f"overlap: ZeRO rank {r} fails its gates: {failed}")
    fused, chunked = ov["ring_fused"][0]["losses"], ov["ring_chunked"][0]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(chunked, fused))
    log(f"overlap (d): the chunked ring ({OVERLAP_CHUNK_BYTES} bytes a sub-ring; sub-rings a "
        f"bucket {ov['ring_chunked'][0]['ks_per_step'][-1]}) against the fused allreduce: losses "
        f"within {gap:.3g} ({chunked} / {fused}); int8 sub-chunk "
        f"{ov['ring_int8'][0]['sub_chunk']}, 1-bit sub-chunk {ov['ring_onebit'][0]['sub_chunk']}")
    if gap > RING_LOSS_RTOL:
        raise AssertionError(f"overlap: the chunked ring's losses are {gap} from the fused run's")


# ---------------------------------------------------------------------------
# robustness: the watchdog and elastic drills through the port's launcher
# ---------------------------------------------------------------------------

DRILL_TIMEOUT_S = 5          # BAGUA_COMM_TIMEOUT_S of the watchdog drill
CYCLES_PER_S = SLEEP_CYCLES / 25e-3   # torch.cuda._sleep's cycles a second, about
WEDGE_S = 120                # the device wedge: bounded, whatever tears the context down
WATCHDOG_DRILL = dict(save_at=3, wedge_at=4)
#: the elastic drill: its steps, a pause after each, the global batch's rows,
#: the lease's TTL and the join window (s), node 1's world-2 steps before its
#: kill, and the last steps that world 1 leaves to world 2 (it waits there
#: for the resize, so that a standby slow to start cannot let the run end at
#: world 1)
ELASTIC_DRILL = dict(steps=40, delay_s=0.3, rows=4, lease_ttl=3, join_window=4, kill_after=3,
                     hold=5)
ELASTIC_RERUN_RTOL = 1e-5
DRILL_BOUND_S = 240          # each drill's wall-clock bound
WATCHDOG_COST_STEPS = 100
LAUNCHER = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--monitor_interval",
            "0.2"]


def watchdog_cost(trainer, state, batch):
    """Slice 1's step with the hang watchdog on (the default) against off
    (what ``BAGUA_COMM_TIMEOUT_S=off`` gives a process: no watchdog, neither
    the trainer's fence nor the communicator's watched sections), A B B A,
    ``WATCHDOG_COST_STEPS`` steps a window, each step ending in
    ``loss.item()``.  Returns the state and each window's ms a step."""
    import bagua_tpu_torch.watchdog as wdmod

    on = trainer._watchdog
    if on is None or wdmod.active() is not on:
        raise AssertionError("the hang watchdog is not on by default")
    windows = {"on": [], "off": []}
    try:
        for label in ("on", "off", "off", "on"):
            trainer._watchdog = wdmod._GLOBAL = on if label == "on" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(WATCHDOG_COST_STEPS):
                state, loss = trainer.train_step(state, batch)
                loss.item()
            windows[label].append((time.perf_counter() - t0) / WATCHDOG_COST_STEPS * 1e3)
    finally:
        trainer._watchdog = wdmod._GLOBAL = on
    # what the watchdog adds to the step's host path, measured directly: one
    # watched section a blocking communicator call, one fence a step
    calls, active = [0], wdmod.active

    def counting():
        calls[0] += 1
        return active()

    wdmod.active = counting
    try:
        state, loss = trainer.train_step(state, batch)
        loss.item()
    finally:
        wdmod.active = active
    t0 = time.perf_counter()
    for _ in range(10000):
        with on.watch("cost"):
            pass
    section_us = (time.perf_counter() - t0) / 10000 * 1e6
    t0 = time.perf_counter()
    for _ in range(1000):
        wdmod._fence_of(loss)
    fence_us = (time.perf_counter() - t0) / 1000 * 1e6
    windows["host"] = {"sections": calls[0], "section_us": section_us, "fence_us": fence_us}
    return state, windows


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def adopt_orphans() -> None:
    """Make this process the subreaper of every process it starts, so that
    one which outlives its parent (a launcher's server, a worker's child)
    is reparented here rather than to init, where :func:`stop_leftovers`
    finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:   # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _children():
    """``(pid, state, command line)`` of every child of this process."""
    me, out = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:   # gone meanwhile
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == me:
            out.append((int(name), state, cmd))
    return out


def stop_leftovers(where):
    """Kill and reap every child of this script still alive after
    ``where`` (zombies are only reaped), and whatever they leave in turn;
    returns the ``pid command`` of each one that was alive."""
    import signal

    left = []
    for _ in range(20):   # a killed child's own children come back here
        children = _children()
        if not children:
            break
        for pid, state, cmd in children:
            if state != "Z":
                left.append(f"{pid} {cmd}")
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
    if left:
        log(f"processes left after {where}, now stopped: {left}")
    return left


def _write_json(path, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _startup(rec) -> None:
    """A drill worker's start-up stamps (wall clock): its exec (from
    ``/proc``), this script's first line, and ``torch``'s import done."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    rec["t_exec"] = boot + start_ticks / os.sysconf("SC_CLK_TCK")
    rec["t_import"] = _T_IMPORT
    rec["t_torch"] = _T_TORCH


def _startup_line(rec) -> str:
    stamps = [("exec", "t_exec"), ("script", "t_import"), ("torch imported", "t_torch"),
              ("process group", "t_pg"), ("model and trainer", "t_model"),
              ("restore", "t_restore"), ("first step", "first_step_end")]
    have = [(name, rec[key]) for name, key in stamps if rec.get(key) is not None]
    return ", ".join(f"{name} +{t - have[0][1]:.2f}" for name, t in have)


def drill_watchdog_worker(out_dir):
    """One attempt of the watchdog drill, a worker of the port's launcher:
    slice 1's LM at full width (``build_slice``), ``BaguaCheckpointManager``
    in ``out_dir``, resumed from its newest step if there is one; an async
    save of step ``save_at``; on the first attempt (a marker file) a real
    device wedge before step ``wedge_at``'s forward, ``torch.cuda._sleep`` of
    about ``WEDGE_S`` on the step's stream, which the trainer's watchdog
    fence must catch.  Records the attempt in ``attempt<k>.json``."""
    attempt = len([f for f in os.listdir(out_dir) if f.startswith("attempt")])
    if os.environ.get("BAGUA_LOCKDEP"):
        # each attempt's own witness (the package installs the shim at import)
        os.environ["BAGUA_LOCKDEP_OUT"] = os.path.join(out_dir, f"lockdep_worker{attempt}.json")
    import bagua_tpu_torch as bt

    path = os.path.join(out_dir, f"attempt{attempt}.json")
    rec = {"attempt": attempt, "start": time.time(), "losses": {}}
    _startup(rec)
    bt.init_process_group()
    rec["t_pg"] = time.time()
    _, trainer, state, batch = build_slice("longctx")
    torch.cuda.synchronize()
    rec["t_model"] = time.time()
    mgr = bt.BaguaCheckpointManager(os.path.join(out_dir, "ckpt"), async_save=True)
    rec["resumed_from"] = None
    if mgr.latest_step() is not None:
        t0 = time.perf_counter()
        rec["resumed_from"], state = trainer.restore_checkpoint(mgr, state)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
        rec["t_restore"] = time.time()
        log(f"resumed from checkpoint step {rec['resumed_from']}")
    marker = os.path.join(out_dir, "wedged")
    while state.step < STEPS:
        i = state.step
        if i == WATCHDOG_DRILL["wedge_at"] and not os.path.exists(marker):
            open(marker, "w").close()
            torch.cuda.synchronize()
            rec["wedge_t"] = time.time()
            _write_json(path, rec)
            log(f"injecting a device wedge at step {i}: torch.cuda._sleep of {WEDGE_S} s")
            torch.cuda._sleep(int(WEDGE_S * CYCLES_PER_S))
        state, loss = trainer.train_step(state, batch)
        rec["losses"][i] = loss.item()
        rec.setdefault("first_step_end", time.time())
        if state.step == WATCHDOG_DRILL["save_at"]:
            trainer.save_checkpoint(mgr, state.step, state)
        _write_json(path, rec)
    mgr.close()
    rec["end"] = time.time()
    _write_json(path, rec)


def drill_elastic_worker(out_dir):
    """One attempt of the elastic drill on one node, a worker of the port's
    launcher: slice 1's model cut to ``SP_CUT``'s widths on ``cuda:0`` over
    gloo (ranks of several launchers share the card), ByteGrad, SGD 0.1, the
    global batch (``ELASTIC_DRILL["rows"]`` rows of seed 1) split by the
    world, resumed from the newest checkpoint, a save every step; at world 1
    it stops ``ELASTIC_DRILL["hold"]`` steps short of the end and waits for
    the resize that ends its gang.  Each step appends its world, node, loss
    and K1/K2 launches to
    ``steps_node<id>.jsonl``; the last parameters' digest goes to
    ``final_node<id>.json``."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.checkpoint import compute_state_digest
    from bagua_tpu_torch.elastic import ElasticContext
    from bagua_tpu_torch.ops import codec as cd

    boot = {}
    _startup(boot)
    ctx = ElasticContext.from_env()
    ctx.init_process_group(device="cuda:0", backend="gloo")
    boot["t_pg"] = time.time()
    rank, world = bt.get_rank(), bt.get_world_size()
    log(f"elastic worker: node {ctx.node_id}, rank {rank}, world {world}, epoch {ctx.epoch}")
    trainer = bt.BaguaTrainer(bt.lm_loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.ByteGradAlgorithm(hierarchical=False), device="cuda:0")
    state = trainer.init(slice_model("longctx", **SP_CUT))
    torch.cuda.synchronize()
    boot["t_model"] = time.time()
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 32768, (ELASTIC_DRILL["rows"], SP_CUT["max_seq_len"] + 1),
                           device="cuda", generator=g)
    batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
    mgr = bt.BaguaCheckpointManager(os.path.join(out_dir, "ckpt"), async_save=True)
    if mgr.latest_step() is not None:
        step, state = trainer.restore_checkpoint(mgr, state)
        boot["t_restore"] = time.time()
        log(f"resumed from checkpoint step {step}")
    steps_path = os.path.join(out_dir, f"steps_node{ctx.node_id}.jsonl")
    while state.step < ELASTIC_DRILL["steps"]:
        if world == 1 and state.step >= ELASTIC_DRILL["steps"] - ELASTIC_DRILL["hold"]:
            time.sleep(0.1)   # the standby's resize stops this gang
            continue
        i = state.step
        cd.reset_launch_counts()
        state, loss = trainer.train_step(state, batch)
        rec = {"world": world, "rank": rank, "node": ctx.node_id, "epoch": ctx.epoch,
               "step": i, "loss": loss.item(), "t": time.time(),
               "buckets": len(trainer.plan.buckets),
               "launches": {k.__name__: k.launches for k in cd.KERNELS}}
        if boot is not None:
            rec["startup"] = _startup_line({**boot, "first_step_end": rec["t"]})
            boot = None
        with open(steps_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        trainer.save_checkpoint(mgr, state.step, state)
        time.sleep(ELASTIC_DRILL["delay_s"])
    mgr.close()
    torch.cuda.synchronize()
    digest = compute_state_digest({n: p.detach() for n, p in state.model.named_parameters()})
    _write_json(os.path.join(out_dir, f"final_node{ctx.node_id}.json"),
                {"digest": digest["digest"], "world": world, "rank": rank})
    torch.distributed.destroy_process_group()


def _log_time(text, needle):
    """The wall time of the launcher's first log line holding ``needle``."""
    import datetime

    for line in text.splitlines():
        if needle in line:
            stamp = " ".join(line.split()[:2])
            return datetime.datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp()
    raise AssertionError(f"no launcher line holds {needle!r}")


def _drill_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BAGUA_ELASTIC")}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _wait_bounded(procs, t0, what):
    """Wait for ``procs`` within ``DRILL_BOUND_S`` of ``t0``; a run past its
    bound fails the script (its process groups are killed first)."""
    import signal

    try:
        return [p.wait(timeout=max(1.0, t0 + DRILL_BOUND_S - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{what} outlasted its {DRILL_BOUND_S} s bound") from None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def watchdog_drill(card, slice1_losses, tmp):
    """(a) slice 1's LM at full width wedged on the card, through the
    launcher: the watchdog's exit 3, one gang restart, the resume from the
    async save of step ``save_at``, and the resumed losses bitwise equal to
    slice 1's."""
    log_path = os.path.join(tmp, "watchdog.log")
    cmd = LAUNCHER + ["--nproc_per_node", "1", "--max_restarts", "1", "--master_port",
                      str(_free_port()), os.path.abspath(__file__), "--drill", "watchdog", tmp]
    t0, wall0 = time.monotonic(), time.time()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                env=_drill_env(BAGUA_COMM_TIMEOUT_S=DRILL_TIMEOUT_S,
                                               BAGUA_OBS_DUMP_DIR=os.path.join(tmp, "flight"),
                                               BAGUA_LOCKDEP="on",
                                               BAGUA_LOCKDEP_OUT=os.path.join(
                                                   tmp, "lockdep_launcher.json")),
                                start_new_session=True)
        rc = _wait_bounded([proc], t0, "the watchdog drill")[0]
    run_s = time.monotonic() - t0
    text = open(log_path).read()
    try:
        first = json.load(open(os.path.join(tmp, "attempt0.json")))
        second = json.load(open(os.path.join(tmp, "attempt1.json")))
        restarts = text.count("gang restart")
        if rc != 0 or restarts != 1 or "worker failed (exit 3); gang restart 1/1" not in text:
            raise AssertionError(f"the launcher exited {rc} after {restarts} restart(s); the "
                                 "first worker must exit 3 and be restarted once")
        if "watchdog: section" not in text or "most recent call first" not in text:
            raise AssertionError("the first worker's watchdog stacks are not in the log")
        if second["resumed_from"] != WATCHDOG_DRILL["save_at"]:
            raise AssertionError(f"resumed from step {second['resumed_from']}, not "
                                 f"{WATCHDOG_DRILL['save_at']}")
        got = {int(k): v for k, v in second["losses"].items()}
        got.update({int(k): v for k, v in first["losses"].items()
                    if int(k) < WATCHDOG_DRILL["save_at"]})
        if [got.get(i) for i in range(STEPS)] != slice1_losses:
            raise AssertionError(f"the drill's losses {got} are not slice 1's {slice1_losses}")
        check_watchdog_flight_record(os.path.join(tmp, "flight"))
        check_lockdep_witness(tmp)
    except Exception:
        log(text[-6000:])
        raise
    exit_t = _log_time(text, "worker failed (exit 3)")
    done = [int(k) for k in first["losses"]]
    lost = max(done) + 1 - second["resumed_from"]
    res = {"wedge_to_exit_s": exit_t - first["wedge_t"],
           "exit_to_first_step_s": second["first_step_end"] - exit_t,
           "restore_s": second["restore_s"], "steps_lost": lost, "run_s": run_s,
           "launcher_start_to_first_step_s": first["first_step_end"] - wall0}
    log(f"robustness (a) watchdog drill, longctx-watchdog-1chip ({card}): the launcher exited "
        f"0 after 1 restart; the first worker exited 3 from the watchdog (stacks in the log) "
        f"{res['wedge_to_exit_s']:.2f} s after the wedge's enqueue (timeout "
        f"{DRILL_TIMEOUT_S} s, the monitor's 1 s tick, the flush; seen by the launcher's 0.2 s "
        f"poll); the restarted worker's first step {res['exit_to_first_step_s']:.2f} s after "
        f"that exit (respawn, CUDA's start, the kernels' load, the model, the restore of "
        f"{res['restore_s']:.2f} s); resumed from step {second['resumed_from']}, {lost} "
        f"completed step(s) lost; steps {WATCHDOG_DRILL['save_at']}-{STEPS - 1} bitwise "
        f"equal to slice 1's; the run {run_s:.1f} s (the first worker's first step "
        f"{res['launcher_start_to_first_step_s']:.2f} s after the launch); start-up of the "
        f"first worker (s from its exec): {_startup_line(first)}; of the restarted one: "
        f"{_startup_line(second)}")
    return res


def check_watchdog_flight_record(dump_dir):
    """The watchdog drill's post-mortem: the first worker's
    ``watchdog_abort`` flight record, valid, naming the wedged section,
    which is still in flight (a ``watchdog/`` span among its active
    spans)."""
    from bagua_tpu_torch.obs.recorder import validate_flight_record

    paths = glob.glob(os.path.join(dump_dir, "flight_watchdog_abort_*.json"))
    if len(paths) != 1:
        raise AssertionError(f"watchdog drill: flight records {os.listdir(dump_dir)}")
    with open(paths[0]) as f:
        rec = json.load(f)
    problems = validate_flight_record(rec)
    active = [sp["name"] for sp in rec["active_spans"]]
    log(f"robustness (a): the watchdog_abort flight record {os.path.basename(paths[0])}: "
        f"reason {rec['reason']!r}, active spans {active}, {len(rec['spans'])} spans, "
        f"ledger {rec['ledger'] and rec['ledger']['classes']}; problems {problems}")
    if problems or not any(n.startswith("watchdog/") for n in active):
        raise AssertionError(f"watchdog drill: flight record problems {problems}, "
                             f"active spans {active}")
    return rec


def elastic_drill(card, tmp):
    """(b) 2 -> 1 -> 2 on a cut with ByteGrad: two launchers (``--nnodes
    1:2``), node 0 hosting the store; node 1's launcher and worker killed as
    a process group, node 0's coordinator expiring its lease and resuming at
    world 1, node 1 relaunched as a standby, a coordinated resize to world 2,
    the run finished."""
    import signal

    master, coord = _free_port(), _free_port()
    d = ELASTIC_DRILL

    def launch(node):
        log_path = os.path.join(tmp, f"node{node}.log")
        cmd = LAUNCHER + ["--nnodes", "1:2", "--node_rank", str(node), "--nproc_per_node", "1",
                          "--master_port", str(master), "--restart_coordinator_port",
                          str(coord), "--max_restarts", "3", "--join_window",
                          str(d["join_window"]), "--lease_ttl", str(d["lease_ttl"]),
                          os.path.abspath(__file__), "--drill", "elastic", tmp]
        env = _drill_env(BAGUA_ELASTIC_TELEMETRY_OUT=os.path.join(tmp, f"telemetry{node}.json"))
        return subprocess.Popen(cmd, stdout=open(log_path, "a"), stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)

    def records():
        out = []
        for node in (0, 1):
            path = os.path.join(tmp, f"steps_node{node}.jsonl")
            if os.path.exists(path):
                for ln in open(path):
                    try:
                        out.append(json.loads(ln))
                    except ValueError:   # a line still being written
                        pass
        return out

    def until(pred, t0, what):
        while not pred():
            if time.monotonic() > t0 + DRILL_BOUND_S:
                raise AssertionError(f"the elastic drill outlasted its bound waiting for {what}")
            time.sleep(0.05)

    t0 = time.monotonic()
    procs = [launch(0)]
    time.sleep(0.5)
    procs.append(launch(1))
    try:
        until(lambda: sum(r["world"] == 2 and r["node"] == 1 for r in records())
              >= d["kill_after"], t0, "world 2's steps")
        kill_t = time.time()
        os.killpg(procs[1].pid, signal.SIGKILL)
        procs[1].wait()
        until(lambda: any(r["world"] == 1 for r in records()), t0, "world 1's first step")
        n2 = sum(r["world"] == 2 for r in records())
        relaunch_t = time.time()
        procs[1] = launch(1)
        until(lambda: sum(r["world"] == 2 for r in records()) > n2, t0, "the resize to world 2")
        rcs = _wait_bounded(procs, t0, "the elastic drill")
    except Exception:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for node in (0, 1):
            path = os.path.join(tmp, f"node{node}.log")
            if os.path.exists(path):
                log(f"node {node}:\n" + open(path).read()[-4000:])
        raise
    run_s = time.monotonic() - t0
    log0 = open(os.path.join(tmp, "node0.log")).read()
    recs = records()
    tel = json.load(open(os.path.join(tmp, "telemetry0.json")))
    worlds = [t["nnodes"] for t in tel["transitions"]]
    counts = tel["counters"]
    finals = [json.load(open(os.path.join(tmp, f"final_node{n}.json"))) for n in (0, 1)]
    by_step = {}
    for r in recs:
        by_step.setdefault(r["step"], []).append(r)
    rerun = {s: [r["loss"] for r in rs] for s, rs in by_step.items()
             if len({r["epoch"] for r in rs}) > 1}
    worst = max((max(abs(x - v[0]) / abs(v[0]) for x in v) for v in rerun.values()),
                default=None)
    want = _want_launches("bytegrad", {}, 0, 1, steps=1)
    bad = [r for r in recs if r["world"] == 2 and (
        r["launches"]["compress_chunked"] != want["compress_chunked"] * r["buckets"]
        or r["launches"]["decompress_chunked"] != want["decompress_chunked"] * r["buckets"])]
    problems = []
    if rcs != [0, 0]:
        problems.append(f"the launchers exited {rcs}")
    if worlds != [2, 1, 2]:
        problems.append(f"worlds {worlds}")
    if counts.get("elastic/lease_expired") != 1 or counts.get("elastic/resizes", 0) < 1:
        problems.append(f"counters {counts}")
    if not rerun or worst > ELASTIC_RERUN_RTOL:
        problems.append(f"steps run twice {rerun}")
    if finals[0]["digest"] != finals[1]["digest"] or finals[0]["world"] != 2:
        problems.append(f"last parameters {finals}")
    if bad:
        problems.append(f"K1/K2 launches at world-2 steps {bad[:2]}")
    if problems:
        log(log0[-4000:])
        raise AssertionError("elastic drill: " + "; ".join(problems))
    lease_t = _log_time(log0, "(lease_expired from node")
    first_w1 = min(r["t"] for r in recs if r["world"] == 1)
    first_w2b = min(r["t"] for r in recs if r["world"] == 2 and r["epoch"] == max(
        rr["epoch"] for rr in recs))
    w2 = [r for r in recs if r["world"] == 2]
    res = {"kill_to_lease_expiry_s": lease_t - kill_t, "kill_to_world1_step_s": first_w1 - kill_t,
           "relaunch_to_world2_step_s": first_w2b - relaunch_t, "run_s": run_s,
           "k1": sum(r["launches"]["compress_chunked"] for r in w2),
           "k2": sum(r["launches"]["decompress_chunked"] for r in w2),
           "world2_steps": len(w2), "buckets": w2[0]["buckets"]}
    log(f"robustness (b) elastic drill, elastic-cut-2to1to2-1chip ({card}): worlds {worlds}, "
        f"counters {counts}; both launchers exited 0; {len(rerun)} step(s) ran twice, largest "
        f"relative loss difference {worst:.3g}; last parameters bitwise equal on both ranks; "
        f"K1 {res['k1']} and K2 {res['k2']} in {res['world2_steps']} world-2 step-ranks of "
        f"{res['buckets']} buckets (K1 = buckets, K2 = 2 x buckets a step); node 1 killed: "
        f"the lease expired {res['kill_to_lease_expiry_s']:.2f} s later (TTL "
        f"{d['lease_ttl']} s), the first step at world 1 {res['kill_to_world1_step_s']:.2f} s "
        f"after the kill; node 1 relaunched: the first step at world 2 "
        f"{res['relaunch_to_world2_step_s']:.2f} s later; the drill {run_s:.1f} s; each "
        f"worker's start-up (s from its exec): "
        + "; ".join(f"epoch {r['epoch']} node {r['node']}: {r['startup']}"
                    for r in recs if "startup" in r))
    return res


def phase_podsim(card):
    """26. the pod simulator's full drill at the first size of
    ``BAGUA_SCALE_RANKS`` (``PODSIM``); all 17 checks must hold.  Returns
    its metrics."""
    from bagua_tpu_torch import env
    from bagua_tpu_torch.podsim.orchestrator import full_scenario

    world = env.get_scale_ranks()[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        checks, metrics = full_scenario(
            world, tmp, shape=env.get_scale_shape(), seed=env.get_scale_seed(),
            dcn_codec=env.get_scale_dcn_codec(), **PODSIM)
        failed = sorted(k for k, ok in checks.items() if not ok)
        if failed or len(checks) != PODSIM_CHECKS:
            for name in sorted(os.listdir(tmp))[:4]:
                with open(os.path.join(tmp, name), errors="replace") as f:
                    log(f"podsim {name}: ...{f.read()[-1500:]}")
            raise AssertionError(f"podsim at world {world}: {len(checks)} checks, failed "
                                 f"{failed}")
    log(f"podsim ({card}; world {world}, slice {PODSIM['slice_size']}, shape "
        f"{env.get_scale_shape()}, seed {env.get_scale_seed()}, codec "
        f"{env.get_scale_dcn_codec()}, {PODSIM['steps']} step of {PODSIM['vec_elems']} "
        f"elements, lease TTL {PODSIM['lease_ttl_s']} s): all {len(checks)} checks true "
        f"({', '.join(checks)}); wall {metrics['wall_s']} s (phase "
        f"{time.perf_counter() - t0:.1f} s), cold-start rendezvous "
        f"{metrics['cold_start_rendezvous_s']} s, rendezvous {metrics['rendezvous_s']} s, "
        f"monitor tick p50 {metrics['monitor_tick_p50_ms']} ms p99 "
        f"{metrics['monitor_tick_p99_ms']} ms, decide p99 {metrics['decide_p99_ms']} ms, "
        f"ingest p99 {metrics['ingest_p99_ms']} ms; the slowest node's imports "
        f"{metrics['node_import_s_max']} s; the largest node resident set "
        f"{metrics['node_peak_rss_mb_max']} MiB (VmRSS after the imports and after the data plane)")
    return metrics


def phase_lint():
    """27. the port's static engines over its package (``LINT_ENGINES``),
    which must exit 0 against the package's baseline."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "bagua_tpu_torch.analysis", "bagua_tpu_torch/",
                          "--engine", LINT_ENGINES],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    log(f"lint ({LINT_ENGINES}): exit {out.returncode} in {time.perf_counter() - t0:.1f} s; "
        + "; ".join(ln for ln in lines if ln.startswith("bagua-lint")))
    if out.returncode != 0:
        log(out.stdout[-6000:] + out.stderr[-3000:])
        raise AssertionError(f"lint exited {out.returncode}")


def check_lockdep_witness(tmp):
    """(a)'s lockdep witnesses (``lockdep*.json``, the launcher's and each
    worker's) against the static lock graph of the package: no runtime
    inversion, no witnessed edge among the package's locks that the static
    graph lacks."""
    from bagua_tpu_torch.analysis.concurrency import build_program, static_lock_graph
    from bagua_tpu_torch.analysis.lockdep import cross_check, load_witness

    paths = sorted(glob.glob(os.path.join(tmp, "lockdep*.json")))
    root = os.path.dirname(os.path.abspath(__file__))
    graph = static_lock_graph(build_program([os.path.join(root, "bagua_tpu_torch")],
                                            rel_to=root))
    known = set(graph["locks"])
    problems, summary = [], []
    for path in paths:
        w = load_witness(path)
        problems.extend(cross_check(w, graph))
        among = [e for e in w["edges"]
                 if tuple(e["from"]) in known and tuple(e["to"]) in known]
        summary.append(f"{os.path.basename(path)}: {len(w['sites'])} lock sites, "
                       f"{sum(s['count'] for s in w['sites'])} acquisitions, "
                       f"{len(w['edges'])} edges ({len(among)} among the static graph's "
                       f"locks), {len(w['inversions'])} inversions")
    log(f"robustness (a) lockdep witness against the static graph ({len(graph['locks'])} "
        f"locks, {len(graph['edges'])} edges): " + "; ".join(summary))
    if len(paths) < 2 or problems:
        raise AssertionError(f"lockdep: witnesses {paths}; problems "
                             + "; ".join(f.render() for f in problems))


def phase_robustness(card, slice1_losses, sequential=False):
    """The watchdog drill (a) and the elastic drill (b), each through
    ``python -m bagua_tpu_torch.distributed.run`` as subprocesses with a free
    port and a wall-clock bound: at once (one thread each), which keeps the
    phase near its 100 s share of the script's time, so each one's times
    hold the other's start-up load; with ``sequential`` (``--sequential``)
    one after the other, whose times are each drill's own."""
    import threading

    out, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "a"))
        os.makedirs(os.path.join(tmp, "b"))

        def drill(name, fn, *args):
            try:
                out[name] = fn(*args)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        t = threading.Thread(target=drill, args=("watchdog", watchdog_drill, card,
                                                  slice1_losses, os.path.join(tmp, "a")))
        t.start()
        if sequential:
            t.join()
        drill("elastic", elastic_drill, card, os.path.join(tmp, "b"))
        t.join()
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# records: the efficiency, serve and bench-trend records the port makes;
# chaos: the fault matrix of scripts/torch_chaos_drill.py
# ---------------------------------------------------------------------------

#: seconds of the records and chaos groups, by piece (the parent's own and
#: the spawns' records)
GROUP_SECONDS = {"records": {}, "chaos": {}}
#: interleaved trials of each of the regress phase's two probes
REGRESS_TRIALS = 2


def efficiency_record(trainer, state, config):
    """A ``bagua-efficiency-v1`` record of a trainer's run (its ledger
    report, static footprint and MFU record), validated and written to
    ``RECORDS_DIR``; returns it."""
    from bagua_tpu_torch.obs import export as obs_export
    from bagua_tpu_torch.obs import ledger as obs_ledger
    from bagua_tpu_torch.obs.memory import static_footprint
    from bagua_tpu_torch.obs.regress import build_efficiency_record

    t0 = time.perf_counter()
    raw = {"ledger": obs_ledger.ledger.report(), "footprint": static_footprint(trainer, state),
           "mfu": obs_export.last_mfu() or {"available": False,
                                            "rationale": "the trainer published no MFU"},
           "steps": config["steps"], "platform": trainer.device.type,
           "device_kind": torch.cuda.get_device_name(trainer.device),
           "n_devices": trainer.world_size, "config": config}
    record = build_efficiency_record(raw)
    problems = obs_ledger.validate_efficiency(record)
    path = write_record("torch_efficiency.json", record)
    GROUP_SECONDS["records"]["efficiency"] = time.perf_counter() - t0
    led = record["ledger"]
    log(f"records: efficiency record of {config['slice']} -> {path}: goodput "
        f"{led['goodput_fraction']}, classes { {k: v for k, v in led['classes'].items() if v} }, "
        f"footprint {record['footprint']['total_bytes']} bytes, mfu {record['mfu']}; "
        f"problems {problems}")
    if problems:
        raise AssertionError(f"records: the efficiency record is invalid: {problems}")
    return record


def phase_regress(card):
    """The bench-trend sentinel's card probe (``obs.regress``: ResNet50,
    flat-resident off against on, ``REGRESS_TRIALS`` interleaved trials, and
    the efficiency trend records) twice, the second compared with the first
    through the CLI's file mode; the trend record must validate.  The
    verdicts are printed, not gated: the ratios are taken beside the
    two-rank spawn."""
    from bagua_tpu_torch.obs import regress

    paths = []
    for i in (1, 2):
        t0 = time.perf_counter()
        recs = regress.run_quick_probe(trials=REGRESS_TRIALS, device="cuda")
        paths.append(write_record(f"torch_probe_{i}.json", recs))
        log(f"records: regress probe {i} ({card}) in {time.perf_counter() - t0:.1f} s: " +
            "; ".join(f"{r['metric']} {r['value']} {r.get('unit', '')}"
                      + (f" {r['per_trial_ratios']}" if "per_trial_ratios" in r else "")
                      for r in recs) + f"; config {recs[0]['config']}")
    out = os.path.join(RECORDS_DIR, "torch_bench_trend.json")
    rc = regress.main(["--fresh", paths[1], "--against", paths[0], "--out", out])
    with open(out) as f:
        trend = json.load(f)
    problems = regress.validate_bench_trend(trend)
    log(f"records: bench trend (probe 2 against probe 1) -> {out}: rc {rc}, verdicts "
        f"{ {c['metric']: (c['verdict'], c['ratio']) for c in trend['comparisons']} }, "
        f"problems {problems}")
    if rc != 0 or problems or trend["mode"] != "files":
        raise AssertionError(f"records: the bench-trend record failed: rc {rc}, {problems}")


def _chaos_drill():
    """``scripts/torch_chaos_drill.py`` as a module."""
    import importlib.util

    path = os.path.join(REPO_DIR, "scripts", "torch_chaos_drill.py")
    spec = importlib.util.spec_from_file_location("torch_chaos_drill", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chaos_run(rank, world, run, device, label):
    """The chaos matrix's drills of this spawn's world, on every rank."""
    from bagua_tpu_torch.ops import codec as cd

    drill = _chaos_drill()
    t0 = time.perf_counter()
    before = {k.__name__: k.launches for k in cd.KERNELS}
    results = drill.run_rank_drills(drill.DRILL_NAMES, rank, world, device,
                                    os.path.join(_CKPT_DIR["chaos"], str(world)))
    # the codec kernels the drills launched (the compress_dcn drill's
    # compressed inter-node ring runs K1 and K2)
    launches = {k.__name__: k.launches - before[k.__name__] for k in cd.KERNELS}
    return {"name": run[0], "kind": "chaos", "results": results, "codec_launches": launches,
            "seconds": time.perf_counter() - t0}


def phase_chaos(card):
    """The chaos matrix's drills of one process, on the card at world 1."""
    from bagua_tpu_torch.telemetry import counters

    drill = _chaos_drill()
    t0 = time.perf_counter()
    before = counters.snapshot()
    results = drill.run_in_process(drill.IN_PROCESS, device="cuda")
    GROUP_SECONDS["chaos"]["in process"] = time.perf_counter() - t0
    GROUP_SECONDS["chaos_counters"] = drill._counter_deltas(before)
    for name, r in results.items():
        log(f"chaos {name} ({card}, world 1): {'PASS' if drill.drill_passed(r) else 'FAIL'} "
            f"in {r['seconds']} s: {r['details']}")
    return results


def check_chaos(card, in_process, two, four):
    """The whole matrix: every drill injected, detected and recovered, with
    its flight record and its badput class; the record to ``RECORDS_DIR``."""
    drill = _chaos_drill()
    results = dict(in_process)
    for recs, world in ((two, 2), (four, 4)):
        results.update(recs[0]["results"])
        GROUP_SECONDS["chaos"][f"{world} ranks"] = recs[0]["seconds"]
        log(f"chaos ({world} ranks): codec kernel launches on each rank "
            f"{[r['codec_launches'] for r in recs]}")
        for name, r in recs[0]["results"].items():
            log(f"chaos {name} ({card}, {world} ranks): "
                f"{'PASS' if drill.drill_passed(r) else 'FAIL'} in {r['seconds']} s: "
                f"{r['details']}")
    results = {n: results[n] for n in drill.DRILL_NAMES if n in results}
    record = drill.build_record(results, "cuda", max(r["world"] for r in results.values()),
                                sum(GROUP_SECONDS["chaos"].values()),
                                GROUP_SECONDS.pop("chaos_counters", {}))
    path = write_record("torch_chaos_drill.json", record)
    failed = [n for n, r in results.items() if not drill.drill_passed(r)]
    log(f"chaos: {len(results)} drills -> {path}; seconds by drill "
        f"{ {n: r['seconds'] for n, r in results.items()} }; failed {failed}")
    if failed or len(results) != len(drill.DRILL_NAMES):
        raise AssertionError(f"chaos: drills failed {failed} (of {len(results)})")


def _die_with_parent() -> None:
    """A worker's end when the process that started it ends, however it
    ends (``PR_SET_PDEATHSIG``): a killed script leaves no rank behind."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL, 0, 0, 0)


def _guard_the_run() -> None:
    """Stop every process of the run and exit non-zero on SIGTERM, SIGINT or
    SIGHUP, and once the run has lasted ``SCRIPT_BOUND_S`` seconds."""
    import signal
    import threading

    def end(why, code):
        log(f"chip_smoke: {why}; stopping every process of the run")
        stop_leftovers(why)
        sys.stdout.flush()
        os._exit(code)

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, lambda signum, _frame: end(
            f"ended by {signal.Signals(signum).name}", 128 + signum))
    timer = threading.Timer(SCRIPT_BOUND_S, end,
                            (f"the run outlasted its {SCRIPT_BOUND_S} s bound", 124))
    timer.daemon = True
    timer.start()


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--worker"]:
        _die_with_parent()
        phase, rank, init, out = sys.argv[2:6]
        multi_rank_worker(phase, int(rank), init, out)
        return
    if sys.argv[1:2] == ["--drill"]:
        _die_with_parent()
        {"watchdog": drill_watchdog_worker, "elastic": drill_elastic_worker}[sys.argv[2]](
            sys.argv[3])
        return
    script_t0 = time.perf_counter()
    seconds, leftovers = {}, {}
    adopt_orphans()
    _guard_the_run()

    def stop(name):
        left = stop_leftovers(name)
        if left:
            leftovers[name] = left

    def timed(name, fn, *args, alone=True):
        """``fn(*args)``, its seconds kept under ``name``; ``alone``: nothing
        runs beside it, so every process left after it is stopped."""
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        finally:
            if alone:
                stop(name)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    card = timed("device", phase_device)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    rows.update(timed("gmm kernels", phase_gmm_kernels))
    rows.update(timed("codec kernels", phase_codec_kernels))
    rows.update(timed("sign kernels", phase_sign_kernels))
    timed("narrow shapes", phase_narrow_shapes)
    release()
    # every two-rank phase in one spawn, started now; beside it on the card,
    # the in-process phases from slice 1 on, the four-rank spawns and the
    # robustness drills (none of their gates is a time; the kernels' times
    # above were taken alone)
    gen_dir = tempfile.mkdtemp()
    os.environ[GEN_REF_ENV] = os.path.join(gen_dir, "generate_ref.pt")
    spawn, errors = {}, []

    def two_ranks():
        try:
            spawn["both"] = timed(", ".join(SPAWNS["slice3"]), phase_multi_rank, "slice3",
                                  alone=False)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    import threading

    thread = threading.Thread(target=two_ranks, name="chip-smoke-two-ranks")
    thread.start()
    streams, stream_t0 = {}, time.perf_counter()
    try:
        launches, base = timed("slice 1", phase_slice, alone=False)
        timed("obs", phase_obs, card, alone=False)
        release()
        launches_moe, _, base_moe = timed("slice 2", phase_slice_moe, alone=False)
        release()
        timed("remat", phase_remat, {"longctx": base, "moe": base_moe}, alone=False)
        slice1_losses, ep_losses = base["losses"], base_moe["ep_reference"]
        del base, base_moe
        ckpt_single = timed("checkpoint (a)", phase_checkpoint, alone=False)
        timed("podsim", phase_podsim, card, alone=False)
        timed("lint", phase_lint, alone=False)
        timed("generate", phase_generate, card, alone=False)
        timed("serve", phase_serve, card, alone=False)
        timed("regress", phase_regress, card, alone=False)
        GROUP_SECONDS["records"]["regress"] = seconds["regress"]
        chaos_in = timed("chaos", phase_chaos, card, alone=False)
        timed("vision", phase_vision, card, alone=False)
        torch.distributed.destroy_process_group()
        release()
        four = timed("slice 4 (2 x 2), decentralized (2 x 2)", phase_multi_rank, "slice4_2x2",
                     alone=False)
        tpp4 = timed("tensor_pipeline (pp 2 x tp 2)", phase_multi_rank, "tensor_pipeline_4",
                     alone=False)
        timed("robustness", phase_robustness, card, slice1_losses,
              "--sequential" in sys.argv[1:], alone=False)
        ckpt_multi = timed("checkpoint (b, c)", phase_multi_rank, "checkpoint", alone=False)
        streams["in process"] = time.perf_counter() - stream_t0
    except BaseException:
        stop("a failed phase beside the two-rank spawn")   # ends that spawn too
        raise
    finally:
        thread.join()
        stop("the phases beside the two-rank spawn")
        shutil.rmtree(gen_dir, ignore_errors=True)
        os.environ.pop(GEN_REF_ENV, None)
    if errors:
        raise errors[0]
    slice3 = slice4 = both = spawn["both"]
    check_slice3_obs(card, slice3["bytegrad"])
    check_autotune(card, {name: both[name] for name, *_ in AUTOTUNE_RUNS},
                   slice4["onebit_ef"])
    zero = {name: both[name] for name, *_ in ZERO_RUNS}
    check_zero({name: recs[0] for name, recs in zero.items()})
    gossip = {name: both[name] for name, *_ in DECENTRALIZED_RUNS}
    gossip.update({name: four[name] for name, *_ in DECENTRALIZED_4_RUNS})
    full = zero["replicated"][0]
    by_phase = {sub: {name: both[name] for name, *_ in MULTI_RANK[sub][1]}
                for sub in ("async", "features", "overlap")}
    by_phase["checkpoint"] = ckpt_multi
    check_async(by_phase["async"], full, gossip["decentralized_all"][0])
    check_features(by_phase["features"], zero)
    check_overlap(by_phase["overlap"], zero)
    check_collectives(both)
    check_trace_overlap(card, both["bytegrad_overlap"][0])
    check_chaos(card, chaos_in, both["chaos"], four["chaos_4"])
    check_checkpoint(card, ckpt_single, by_phase["checkpoint"])
    del by_phase
    mp = {name: both[name] for name, *_ in MP_RUNS}
    for name, err in check_model_parallel(card, mp, slice1_losses, ep_losses).items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    tpp = {name: both[name] for name, *_ in TPP_RUNS}
    check_tensor_pipeline(card, tpp, tpp4, slice1_losses)
    check_vision_ranks(card, tpp)
    log(f"seconds by phase: {seconds} (from slice 1 to checkpoint (b, c) beside the "
        f"two-rank spawn); the script's total {time.perf_counter() - script_t0:.1f} s")
    for group in ("records", "chaos"):
        pieces = {k: round(v, 1) for k, v in GROUP_SECONDS[group].items()}
        log(f"seconds of the {group} group: {sum(pieces.values()):.1f} ({pieces})")
    log(f"seconds of the streams: in-process {streams['in process']:.1f}, two-rank spawn "
        f"{seconds[', '.join(SPAWNS['slice3'])]:.1f}")
    if leftovers:
        raise AssertionError(f"phases left processes running: {leftovers}")
    # each kernel's launches come from its own path: flash from slice 1, gmm
    # from slice 2, K1 and K2 from slice 3's ByteGrad run, K3 from its int8
    # ring, K4 and K5 from slice 4's main path (the other slices checked the
    # flash counts too, and slice 4's 2 x 2 runs K1, K2, K4 and K5)
    own = {"compress_chunked": slice3["bytegrad"][0]["launches"],
           "decompress_chunked": slice3["bytegrad"][0]["launches"],
           "absmax_chunked": slice3["int8"][0]["launches"],
           "sign_compress_chunked": slice4["onebit_ef"][0]["launches"],
           "sign_decompress_chunked": slice4["onebit_ef"][0]["launches"]}
    for name, row in rows.items():
        row["launches"] = (own[name][name] if name in own else launches[name]
                           if name in launches else launches_moe[name])
    log(card)
    log(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
