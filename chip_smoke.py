#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py [--out results.json]

Run from the repository root. Phases (any failure exits non-zero):

1. the card's name and power limit; build every CUDA kernel of the port
   from ``vqa_transfer_externaldata_torch/csrc`` with nvcc (one process per
   source, all started together), timed, with each nvcc's own time;
2. K1 ``gru_fwd`` against its plain PyTorch version on the card
   (B=64, T=26, H=512, random lengths, forward and reverse);
3. K2 ``attention_fwd`` against its plain version on the card
   (B=64, N=196, C=2048, H=512, bf16, normalize on and off), two calls
   bit-equal, and its alpha and r bit-equal to K4's on the identity store
   (store v, rows 0..B-1: the same score tile of ``score_tile.cuh`` on the
   same rows);
4. K1 ``gru_fwd`` and K3 ``gru_bwd`` against their plain versions at the
   training shape (B=256, T=26, H=512, lengths 1..26, forward and
   reverse), both versions of K3 fed K1's hseq; the grid, resident blocks
   per SM and shared memory of K3's persistent step launch (against
   ``kernels.gru_bwd_plan``'s), and K1's
   persistent launch at the training and the serving batch (the grid that
   the C side derives from the plan's rows against
   ``kernels.gru_fwd_plan``'s);
5. K4 ``attention_resident_fwd`` and K5 ``attention_resident_bwd`` against
   their plain versions at the training shape (a 512-image store of
   200x2048 bf16 cells, 196 valid, B=256 with repeated rows, H=512),
   normalize on and off, K5 fed the same saved h; the shape of K4's score
   launch (tile, ring stages, shared memory, grid) and its nvcc time, of
   K5's dW_v launch (the same, and the split) against
   ``kernels.dwv_plan``, and of K5's rows launch (grid, threads, shared
   memory, the second pass's lanes at G=1 and G=8) against
   ``kernels.rows_plan``; then
   both at G=2 and G=8 glimpses on the same store;
6. K6 ``bigru_fwd`` and K7 ``bigru_bwd`` against their plain versions at
   the stage-1 shape (B=256, T=26, H=512, lengths 1..26), and against two
   K1 calls and two K3 calls on the same inputs (K7 fed K6's hseqs); K6's
   persistent launch (grid, launches, resident blocks per SM, shared
   memory) against ``kernels.gru_fwd_plan``'s with two directions, and
   K7's against ``kernels.gru_bwd_plan``'s; what ptxas reports for the
   persistent forward kernel of K1's and K6's builds and for the
   persistent step kernel of K3's and K7's (registers, spills, warnings);
7. K2's checks of phase 3 at the gathered training shape (B=256, N=196,
   C=2048, H=512); K8 ``attention_bwd`` against its plain version there
   (normalize on and off, both fed the same ds and K2's r), and the
   gathered op's gradients under K8 against the explicit backward;
8. full-width ``vqa_attention`` serving through ``Predictor`` at batch 64:
   host-feature requests, a padded short request, and ids-only requests
   against a staged 256-image store; launch counts of K1 and K2 over that
   run; logits against the plain path on the card;
9. full-width stage-2 training through ``Trainer.fit_resident`` at batch
   256 on ``synthetic_vqa_joined`` (4096 questions over 512 images, a
   0.42 GB bf16 store) with the lagged in-loop evaluation of a
   1024-question val split every 10 steps and a checkpoint every 10 (2
   kept): the first step's loss and gradients against the plain path on
   the card, launch counts of K1 and K3-K5 over the run, finite losses,
   median step time and questions/s, the val records, the checkpoints
   kept, a profiler window over 5 more steps of ``fit_resident``; then the
   resident evaluator (K4) against the streamed ``evaluate`` (K2),
   ``cli.eval`` on the run directory (its ``results_val.json`` and its
   ``vqa_accuracy`` against ``evaluate_split``), and the trained
   ``params_final.pt`` served by ``Predictor``;
10. the same training on the gathered resident path
   (``train.resident_fused_attention`` false: K1, K2, K3, K8): first step
   against the plain path, launch counts, step times, a profiler window,
   then 10 steps with the explicit backward and 10 with K8 (the A/B);
11. streamed training through ``cli.train`` (``train.device_data_cache``
   false, the flat layout, 1024 questions of float32 grids, 10 steps):
   finite losses, launch counts, step times;
12. full-width stage-1 training of ``vlmap_description`` with the
   bidirectional phrase encoder through ``Trainer.fit_resident`` at batch
   256 on ``synthetic_vlmap_desc`` (4096 regions, 512 candidates): the
   first step's loss and gradients against the plain path on the card,
   launch counts of K6 (one a step) and K7 (and none of K1/K3) over the
   run, finite
   losses, median step time and regions/s and a profiler window over 5
   more steps; then 10 steps with the dense candidate loss (finite
   losses, first-step loss against the plain path, launch counts);
13. the transfer: stage 1's ``params_final.pt`` through ``cli.train
   --train.pretrained_param_path`` into full-width stage-2 training of
   ``vqa_attention`` (1024 questions, 10 steps, the transferred tables
   frozen): the word table arrives bit for bit and every answer row is
   its word's row; finite losses; launch counts of K1 and K3-K5;
14. ``vqa_attention2`` (two glimpses) at full width through
   ``Trainer.fit_resident`` at batch 256 on the gather-free store (K1, K3,
   K4 and K5 at G=2), 30 steps: the first step against the plain path,
   launch counts, finite losses, step times, a profiler window over 5
   more steps; the resident evaluator (K4 at G=2) against the gathered one
   (``spatial_attention_multi``) on the 1024-question val split; requests
   served through ``Predictor``;
15. ``vqa_baseline`` through ``cli.train`` (resident, pool5 on the device,
   no grid; 1024 questions, 10 steps) transfer-initialized from stage 1's
   parameters with the word table frozen: the table arrives bit for bit
   and the warning that the answer-space half does not apply is logged;
   no kernel launches; a profiler window over 5 steps of
   ``fit_resident``; ``cli.eval`` on the run; requests served with pool5
   through ``cli.predict`` from a feature store file;
16. K4 and K5 on int8 rows (the codes of phase 5's store, normalized
   per cell and quantized with one global scale) at G=1, 2 and 8 against
   their plain versions on the same codes, and the op on the int8 store
   against the op on the bf16 store of the same normalized grid (v_att's
   relative quantization error);
17. stage-2 training with ``train.store_quantize int8`` at full width
   through ``Trainer.fit_resident`` (the main path's corpus, steps and
   lagged in-loop evaluation): the first step against the plain path on
   the same int8 store, launch counts of K1, K3 and the int8 K4/K5,
   finite losses, step times, a profiler window over 5 more steps, the
   uploaded store's bytes against the bf16 store's; then the resident
   evaluator on the int8 val store against the one on a bf16 store;
18. the H100 probes P1 (``tools.probe_mxu_rows``, Q = 1..4) and P2
   (``tools.probe_bwd_ceiling``) through their ``run()`` entries: each
   against its plain version, its time, TFLOP/s and cuBLAS's time;
19. times: each kernel, its plain version and the PyTorch library call
   where there is one (median of CUDA-event timings after warm-up, L2
   flushed between runs), and the bound from this run's shapes; K1 at
   the training batch and at the serving batch, each also at T=1 for its
   time a step, and K1's two tilings (16 and 64 rows a block) against each
   other at B = 1, 8, 64 and 256 (bit-equal), and K6's at B = 8, 64 and
   256 (bit-equal); K4 and K5 at G=1 and
   G=2 on bf16 rows and at G=1 on int8 rows, and K4's score launch alone
   at G=1 (its device time from the profiler) with its TFLOP/s; the dW_v
   launch alone (``attention_dwv.cuh``) inside K5 at G=1 on bf16 and int8
   rows and inside K8, with its TFLOP/s, beside cuBLAS on the same product
   (the rows gathered apart, the gather timed); K8's dz launch alone (the
   recomputed score GEMM on ``score_gemm.cuh``'s mainloop with a dense row
   source) with its TFLOP/s and bound, beside cuBLAS on the same [B*N, C]
   x [C, H] product; K2 at B=8 (the Predictor's default batch), 64 and
   256 (phase 7's inputs), with its bound, its score launch alone (the
   score tile of ``score_tile.cuh``) at each batch, and at B=256 its
   TFLOP/s and bound beside cuBLAS on the same product (the dz launch's)
   and its wsum launch alone beside its bytes bound; the rows launch alone
   (``attention_rows.cuh``) inside K5 at G=1, 2 and 8 on bf16 rows and at
   G=1 on int8 rows and inside P2, each beside its bytes bound; the
   gathered op's whole backward with K8 and with the explicit math; K6
   against two K1 calls and K7 against two K3 calls on phase 6's inputs,
   each in turns in one call (each pair runs one persistent body, K6 and
   K7 both chains in one launch);
20. the real-data path at full width through the port's entry points:
   official-schema VQA v2 JSON (4096 train and 1024 val questions over
   512 COCO-like image ids, more than 2000 distinct answers, 10% of the
   answer table held out of training), Visual Genome region descriptions
   (4096 regions over the same images), a 300-d GloVe text file for every
   other word, and two raw feature stores (512 images of 14x14x2048 f16
   grids; 4096 regions, pool5 with a 1x1 grid), all written from a seed;
   the three ``cli.preprocess`` subcommands (timed); ``cli.train`` stage 1
   (``vlmap_description``, bidirectional, streamed with resampled
   negatives: K6/K7) and stage 2 transfer-initialized from it (gather-free
   resident with its lagged in-loop evaluation: K1/K3/K4/K5), each with
   its first step against the plain path, launch counts and median step;
   ``cli.eval`` on host batches (K1/K2: ``results_val.json`` answers every
   val question, the per-type and OOV accuracies, the types' weighted mix
   equal to the overall accuracy) and ``cli.predict`` on three val
   questions by image id (K1/K2) against ``Predictor``;
21. the paper's OOV-answer claim (the CPU test's protocol) at OOV_WIDTHS,
   where it was measured on the card: stage 1 ``vlmap``, the transfer,
   stage 2 from the transferred and from a fresh answer table (frozen;
   K1/K3/K2/K8), launch counts, JAX's thresholds;
22. the raw-image model ``vqa_end2end`` at full width (ResNet-101 at 448
   pixels, bf16, config.py's head), its weights from a seeded
   torchvision-format checkpoint the phase writes: the backbone alone at
   batch 32 against the same weights in float32 on the card, its time,
   images/s, conv MACs and bound; ``cli.train`` on 512 synthetic uint8
   images held on the card (``train.device_data_cache``, batch 32, 10
   steps; the checkpoint grafted by ``load_resnet_backbone``) with its
   first step against the plain path, launch counts (K1, K3, K2, K8), the
   backbone's parameters and BatchNorm statistics unchanged, a profiler
   window over 5 steps; ``cli.eval`` on the run (the resident evaluator:
   K1/K2) and ``Predictor`` on 8 uint8 images (K1/K2, logits against the
   plain path, p50); then, where PIL imports, seeded JPEGs through
   ``cli.extract`` (whole images and ``--regions`` crops, read back with
   ``FeatureStore``), ``cli.train`` streamed through
   ``ImageQuestionDataset`` and ``cli.predict --image``; and the model at
   ``train.steps_per_call`` 2 against eager (the backbone in the captured
   steps), 8 steps each from one initialization, dropout 0: parameters,
   wall ms a step, a profiler window over 2 more steps;
23. ``train.steps_per_call``: k training steps captured in one CUDA graph
   and replayed once a call, at full width on the main corpus. The main
   path (gather-free, K1/K3/K4/K5) eager (k = 1) and at k = 4 and 8 from
   one initialization, dropout 0, 32 steps each: the graphed runs'
   parameters against the eager run's (bit-equal, or within 2^-9 of the
   largest change), the wall ms a step on CUDA events over steps 8-24,
   and the Trainer's own profiler window over steps 24-32 read by
   ``tools/trace_summary`` (device busy and idle share, checked against
   CUDA events); dropout on at k = 4: 16 steps with a checkpoint at step 8,
   resumed from it, bit-equal to the unbroken run, and at learning rate 0
   two replays on one batch give different losses (equal at dropout 0);
   stage 1 (K6/K7), the gathered path (K1/K2/K3/K8) and the streamed loop
   (``Trainer.fit`` on host batches of the flat layout's float32 grids,
   K1/K2/K3/K8) at k = 4 against eager, 12 timed steps and a profiler
   window over 8 more; ``train.remat`` on against off (dropout on, the
   peak device memory of each) and ``train.sort_batch_by_image`` on
   against off (losses within 1e-2, parameter changes at cosine 0.999).
   Launches are counted at each graph's warm-up and capture (k steps'
   worth each); every profiler window (eager and graphed) must hold each
   of its path's kernels' device records launches-a-step times its steps,
   and the launches a graphed path ran are the warm-up's plus, each
   replay, a replay's records in its trace. A window that lost device
   records (``tools/trace_summary``'s check) is taken again once, then
   fails the phase;
24. multi-device training on the one card (``parallel/mesh.py``), the
   main path at full width, dropout 0: (a) this process in a one-rank
   NCCL group (every collective of the distributed step runs) against
   the same runs without a group, 12 steps eagerly and at k = 4 (the
   graph holds the NCCL all-reduce): parameters bit-equal, the wall ms a
   step on CUDA events over steps 4-8 and a profiler window over 8-12
   (its NCCL kernels' device time); (b) two ranks spawned on the card
   (gloo: NCCL refuses two ranks on one card), 6 steps each on data
   whose <unk> answers fall unevenly between the ranks, for the
   replicated store against one process, ``train.store_sharded`` against
   one process's replicated store fed the same per-shard stream, and a
   1x2 tensor-parallel mesh (``shard_params answer_embedding,word_emb``)
   against the 2x1 replicated run: logged losses within MD_TOL_LOSS and
   parameter changes at cosine MD_GRAD_COS, each rank's K1/K3/K4/K5
   launches launches-a-step x steps and its evaluation's, its wall ms a
   step (two processes on one card's SMs: no scaling figure), the
   resident evaluator's predictions equal to one process's on the same
   parameters at a rank's batch, and steps_per_call 2 under gloo on
   CUDA raising. A rank that fails or outlives its join timeout fails
   the phase, and the rest are killed.
25. float32 (``model.dtype float32``) on the main path: the float32
   kernels K1f ``gru_fwd_f32`` and K3f ``gru_bwd_f32`` at the training
   shape (B=256, T=26, H=512, both directions) and K4f
   ``attention_resident_fwd_f32`` and K5f ``attention_resident_bwd_f32``
   at the main path's (a 512-image store of 200x2048 cells, 196 valid,
   B=256 with repeated rows, H=512) on float32, float16 and int8 rows at
   G=1, 2 and 8, normalize on and off on float rows, each against its
   plain float32 version within TOL_F32_REL of each output's largest value
   (G times that for K5f's dqh and dW_v), K1f and K3f there in their
   persistent forms (``csrc/gru_seq_f32.cuh``) and bit-equal to their
   step forms, each timed with its plain version, its library yardstick
   (cuDNN's GRU in float32 for K1f/K3f, cuBLAS's f32 GEMM for K4f's
   score and K5f's dW_v stage) and its bound at the FP32 FFMA peak, K1f
   and K3f in turns with their step forms and cuDNN (library, kernel,
   step, step, kernel, library) and K3f's four launches (gh, chain, dU_h,
   db_hn) apart, K4f's score and K5f's dW_v launch (the products
   of ``csrc/fp32_ring.cuh``) alone on the device beside torch.matmul f32
   on the same product, in turns (matmul, launch, launch, matmul), in ms
   and TFLOP/s with the FFMA bound; ``fit_resident`` at full width in
   float32 on the
   synthetic corpus's float16 store (K1f, K3f, K4f on f16 rows widened on
   load, K5f) for F32_STEPS steps, the first against the plain path (loss
   to TOL_F32_LOSS, gradients to cosine F32_GRAD_COS), launch counts, step
   times; the resident evaluator;
26. ``model.fidelity_mode`` at full width: the forward (TF1 GRU, float32,
   the plain gathered attention, no kernel) on the card against the
   port's float64 numpy oracle (``utils/fidelity.py``) at B=8, atol 5e-4
   and rtol 1e-4, TF32 off; ``cli.train`` (the resident path: K4f/K5f on
   the float16 store, and no K1, K2, K3 or K8), ``cli.eval`` (K4f) and
   ``cli.predict`` (no kernel) on the run;
27. float32 on the gathered attention and the bidirectional GRU: K2f
   ``attention_fwd_f32`` and K8f ``attention_bwd_f32`` at the gathered
   training batch (B=256, N=196, C=2048, H=512), the serving batch (64)
   and F32_ODD_SHAPE (C and H off the bf16 kernels' tiles), normalize on
   and off, each against its plain float32 version within TOL_F32_REL of
   each output's largest value (K2f's r within TOL_R_REL; K8f's dqh and
   dW_v also within what units whose recomputed z lies within rounding of
   0 can move them, as K8's), K8f fed the same ds and K2f's r, two calls
   of each bit-equal; K6f ``bigru_fwd_f32`` and K7f ``bigru_bwd_f32`` at
   the stage-1 shape (B=256, T=26, H=512, lengths 1..26) in their
   persistent forms on ``kernels.gru_f32_plan``'s grid (the C side's too;
   1 and 4 launches a call, both chains in each; K6f on 128-row b-tiles),
   bit-equal to two K1f / K3f calls, to their one-launch-a-chain form (2
   and 5), to K6f on 64-row b-tiles and to their step form (T and 2T +
   1), within TOL_F32_REL of their plain versions,
   two calls bit-equal; each timed with its plain version, its library
   yardstick (cuBLAS's f32 GEMM on K2f's score and K8f's dW_v product,
   ``nn.GRU(bidirectional=True)`` in float32 for K6f/K7f) and its bound at
   the FP32 FFMA peak, K6f/K7f in turns with two K1f/K3f calls, their step
   forms and the library (library, kernel, pair, step, step, pair,
   kernel, library; K6f's 64-row tiling twice between its step forms),
   K7f's four launches (gh, chains, dU_h, db_hn) apart,
   K2f's score and K8f's dz and dW_v launch alone beside torch.matmul f32
   in turns, as phase 25's; then
   ``fit_resident`` in float32 on the gathered store
   (``train.resident_fused_attention`` false: K1f, K2f, K3f, K8f) for
   F32_STEPS steps, its first step against the plain path, launch counts,
   step times, and its gathered evaluator on the 1024-question val split;
   the float32 ``Predictor`` on that run's parameters at batch 8 and 64
   with host features (K1f, K2f), its logits against the same
   ``Predictor`` with ``model.use_pallas`` false (the plain path) within
   TOL_F32_LOGITS, launch counts and p50; and stage-1
   ``vlmap_description`` (bidirectional) in float32 through
   ``fit_resident`` (K6f, K7f) for F32_STEPS steps, its first step against
   the plain path, launch counts (the plan's a call) and step times;
28. float16 (``model.dtype float16``) on the main path: the float16
   kernels K1h ``gru_fwd_f16`` and K3h ``gru_bwd_f16`` (K1's and K3's
   bodies with float16 as their element type) at the training and the
   serving batch (B=256 and 64, T=26, H=512, both directions) and K4h
   ``attention_resident_fwd_f16`` and K5h ``attention_resident_bwd_f16``
   at the main path's store (512 images of 196 valid cells, C=2048,
   H=512) at both batches, G=1, 2 and 8, on float16 rows (normalize on
   and off) and int8 codes, each against its plain float16 version within
   its bf16 limit scaled by float16's step (TOL_F16_*); each timed beside
   its bf16 kernel on the same inputs in turns (bf16, f16, f16, bf16),
   with its plain version, the library's float16 call (cuDNN's GRU,
   cuBLAS's GEMM on K4h's score and K5h's dW_v product) and the bf16
   kernel's bound; ``fit_resident`` at full width in float16 for
   F16_STEPS steps on the corpus's float16 store, then on its int8
   store, each with its first step against the plain path (loss to
   TOL_F16_LOSS, gradients to cosine F16_GRAD_COS, or where the plain path
   with v_att perturbed by F16_PERTURB moves a gradient further, to
   F16_SENSITIVITY times that), launch counts that
   show the float16 kernels alone, step times, and the resident
   evaluator;
29. float16 off the main path: K2h ``attention_fwd_f16`` and K8h
   ``attention_bwd_f16`` at the gathered training and the serving batch
   (B=256 and 64, N=196, C=2048, H=512; one cell holding 300, whose
   float16 square overflows, so its r is 0 in both versions), normalize
   on and off, and K6h ``bigru_fwd_f16`` and K7h ``bigru_bwd_f16`` at
   both batches (T=26, H=512, lengths 1..26), each against its plain
   float16 version (K2h as K2 with TOL_F16_VATT_REL, K8h to TOL_F16_K8_REL
   plus K8's ReLU-flip room, K6h TOL_F16_GRU, K7h TOL_F16_K3_REL), K6h and
   K7h bit-equal to two K1h / K3h calls, two calls of each bit-equal; each
   timed beside its bf16 kernel in turns, with its plain version, the
   library's float16 call and the bf16 row's bound; then ``fit_resident``
   in float16 on the gathered store (K1h, K2h, K3h, K8h) for F16_STEPS
   steps, its first step against the plain path (phase 28's bounds, the
   gathered op's v_att perturbed), launch counts, step times, its
   gathered evaluator, and the float16 ``Predictor`` on its parameters at
   batch 8 and 64 (K1h, K2h; logits against the plain path within
   TOL_F16_LOGITS, launch counts, p50); F16_STREAM_STEPS steps of the
   streamed ``cli.train`` in float16 on the flat layout; stage-1
   ``vlmap_description`` (bidirectional) in float16 for F16_STEPS steps
   (K6h, K7h; first step, launch counts, step times) and its transfer
   through ``cli.train`` into float16 stage 2 (K1h, K3h, K4h, K5h; the
   word table bit for bit);
30. widths: every 16-bit kernel (K1-K8 in bf16 and float16, K4/K5 on int8
   codes) at H of 8, 24, 40, 100 and 600 units and C of 16, 48, 100 and
   300 channels, which the wrappers zero-pad to their multiples, against
   its plain version (K6/K7 bit-equal to two K1/K3 calls); the GRU's step
   form (``csrc/gru_wide_step.cuh``: ``wgmma`` tiles with U_h read through
   L2, one launch a step forward; backward every step's gh up front, then
   one launch a step) past the forward's crossover and where the persistent
   BPTT's shared memory ends: K1/K3 at 1024 and 2400 units (B=256, T=26)
   against their plain versions, timed beside ``nn.GRU``'s packed forward
   and backward at the same width (the forward's device ms a step, the
   BPTT's by launch), K6/K7 at 1024 beside two K1/K3 calls; the forward's
   two forms across CROSSOVER_H at B=256 and 64 (the route's crossover);
   the padding's cost for K2, K4, K5 and K8 at (C, H) = (2048, 500) and
   (2000, 512) against (2048, 512); stage-2 gather-free ``vqa_attention`` at
   ``model.rnn_dim`` 1024 and 2400 in bf16 (8 steps each, the first
   against the plain path, the resident evaluator on the 1024-question
   val split), float16 at 2400, stage 1 at 1024 in bf16 (8 steps, first
   step) and at 2400 in bf16 and float16; ``tools/oov_claim.py``'s TINY
   config in bf16 through ``cli.train`` (stage 1, the transfer into stage
   2), ``cli.eval`` and the ``Predictor`` (logits against the plain path);
31. the input modules (``--seed`` draws the store and fixtures), each part
   where the machine has what it needs, found with
   ``importlib.util.find_spec`` and printed first; what it lacks is printed
   as ``{"input": {<module>: "not installed on this machine"}}``: (a) a
   raw store of 1024 images in the COCO grid's layout (14x14x2048 f16,
   822 MB, and f32 pool5), the native gathers (``data/native.py``, built
   with g++; a failed build fails the phase) of a 256-row batch, widened
   and not, and of pool5 bit-equal to numpy's fancy indexing, with their
   median host ms on the host's CPU beside numpy's; (b) where the
   native decoder can build (libjpeg's headers exist, or Pillow ships a
   libjpeg and the port's header copies are there; it prints the route
   that built it, and a failed build fails the phase), 32 seeded JPEGs
   (448 x 448 and 640 x 480) and a CMYK file through
   ``ImageQuestionDataset.take``: each pixel within one 8-bit step of
   PIL's (equal at the file's own size), the CMYK file PIL's; (c)
   stage-2 ``vqa_attention`` at full width through
   ``cli.train`` on the store (a ``JoinedDataset``: the native gather
   feeds every batch; K1, K2, K3, K8 at their exact counts), 8 steps with
   a checkpoint every 4, fed by ``--data.input_pipeline grain`` where
   grain and dm-tree import, and then stopped at 4 and resumed to 8, its
   parameters bit-equal to the uninterrupted run's; otherwise by the
   threads pipeline, once;
32. the ported paths no earlier phase ran, at full width, cut in depth
   only, each checked three ways (its first step against the plain path
   at its dtype's limits, graphed against eager bit-equal or within
   SPC_PARAM_REL, exact launch counts): (f) the main path graphed at
   k = 4 against eager in float32 (K1f, K3f, K4f, K5f), float16 and on
   the int8 store, each replay's launches read from a profiler window;
   (c) stage 2 at ``model.rnn_dim`` 2400 in bf16 graphed (the GRU's
   step-form cluster launches captured), a float32 model at 2400 (stage
   2 with its resident evaluator, stage 1: K1f, K3f, K6f and K7f in their
   step forms), and K6/K7's bf16 step forms and the float32 step forms
   at 2400 timed beside ``nn.GRU``; (b) the streamed loop through
   ``cli.train`` in float32 (the uploader staging float32; K1f, K3f, K2f,
   K8f); (a) ``vqa_end2end`` in float32 and float16 (the float16
   backbone against float32, ``cli.train``, ``cli.eval``, the
   ``Predictor``); (d) phase 24's one-rank NCCL runs in float32 and
   float16 against no group, and its two gloo ranks on the replicated
   store in float32 against one process.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores
# and HBM3 bandwidth. The bound of a kernel is the larger of its bytes over
# the memory rate and its operations over the peak for their type.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# FP32 outside the tensor cores (FFMA), the float32 kernels' pipes.
PEAK_FP32_FLOPS = 67e12

# Tolerances (max abs error, kernel vs its plain version on the card):
# K1: h in (-1, 1). Sums of 512 products run in another order, and when the
#     f32 state differs in its last bit its bf16 rounding ahead of the
#     hidden matmul can flip, moving one product by one bf16 ulp.
TOL_GRU = 2e-3
# K2 alpha (~1/196 each): f32 sums of 2048 products in another order.
TOL_ALPHA = 1e-5
# K2 v_att, relative to max|v_att| of the plain version, in each normalize
#     mode: the weights w = p*r are rounded to bf16, and where the f32 p*r
#     differ in their last bit a weight may round the other way, moving its
#     term w*v/d by one bf16 ulp, at most 2^-7 of the term. As v >= 0 every
#     term is at most v_att; the limit lets flipped terms carry 1/8 of it.
TOL_VATT_REL = 2.0 ** -10
# K2's per-cell norm r (the residual K8 reuses), relative to max|r|: the
#     same bf16 squares summed in f32 in another order.
TOL_R_REL = 1e-6
# Logits (cos * 10 + bias): activations are bf16 between layers, so a last-
#     bit difference out of a kernel can flip a bf16 rounding (2^-8) that the
#     following layers carry to the logits.
TOL_LOGITS = 5e-2

# K3 (dgx, dU_h, db_hn), relative to the largest |value| of each plain
#     output: the step recomputes gh with sums in another order, so a gate
#     cotangent may round to the other bf16 neighbour (2^-8 of itself)
#     ahead of the U_h^T product and dU_h, and the carried dh picks such
#     flips up step after step. A wrong step, gate or mask moves an output
#     by a large share of the largest value.
TOL_K3_REL = 2.0 ** -8
# K4's saved h, relative to max|h|: h is stored in bf16, and where the f32
#     z differs in its last bits h rounds to the neighbouring bf16 value,
#     at most 2^-8 of itself. (v_att and alpha as K2's.)
TOL_K4_H_REL = 2.0 ** -7
# K5 (dqh, dW_v, dws), relative to the largest |value| of each plain
#     output, both fed the same saved h and alpha: dalpha differs by the
#     order of 2048-term sums, and dz * r is rounded to bf16 ahead of the
#     dW_v product, where a last-bit difference flips one rounding (2^-8 of
#     one of the 50176 terms of a sum).
TOL_K5_REL = 2.0 ** -9
# K4/K5 with G glimpses. Each glimpse's softmax and weighted sum is the
#     single glimpse's computation with its own score column, and h does not
#     depend on G: alpha, h and each glimpse's v_att (relative to its own
#     max|v_att_g|) keep K4's limits, and each column of dws K5's 2^-9. dz
#     sums G glimpse terms before dqh and the one bf16(dz * r) ahead of
#     dW_v: each term may carry its own last-bit differences while the
#     largest value grows more slowly than their sum, so dqh and dW_v get G
#     times K5's limit (2^-6 at G=8; a wrong glimpse moves them by a large
#     share of their largest value).
GLIMPSE_CHECKS = (2, 8)
# K8 (dqh, dW_v, dws) against its plain version, fed the same ds and r:
#     K5's 2^-9 of each output's largest value, plus, entry by entry, what
#     units whose recomputed z lies within rounding of 0 can move it (each
#     version may put such a unit on the other side of the ReLU:
#     k8_allowance).
TOL_K8_REL = 2.0 ** -9
# Training, first step, kernels against the plain path on the card (same
#     dropout mask): the loss (about ln 2000 = 7.6) to 1e-2 absolute, as
#     last-bit differences out of the kernels ride through bf16 activations
#     and average over 256 questions; each parameter's gradient to cosine
#     0.999 (bf16 rounding flips move single entries by 2^-8 of themselves
#     and a ReLU unit at 0 may take the other side), the scalar
#     logit_scale to 1e-2 relative.
TOL_LOSS = 1e-2
GRAD_COS = 0.999
TOL_SCALAR_REL = 1e-2

B, T, H, D = 64, 26, 512, 300
GRID, C = 14, 2048
N = GRID * GRID
STORE_ROWS = 256
RUNS = 25
# Training: batch, synthetic corpus, and steps (warm-up, then timed).
B_TRAIN = 256
TRAIN_QUESTIONS, TRAIN_IMAGES = 4096, 512
WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = 5, 25, 5
# Stage 1: regions of synthetic_vlmap_desc (bench_all.py's size), steps of
# the dense-loss run; the transfer's stage-2 run: questions and steps.
STAGE1_REGIONS, DENSE_STEPS = 4096, 10
TRANSFER_QUESTIONS, TRANSFER_STEPS = 1024, 10
# Stage-2 evaluation: the val split, the in-loop cadence and the checkpoints
# kept; the gathered path's backward A/B (steps each way); streamed
# training (questions of the flat layout, ~1.6 GB of float32 grids, steps).
VAL_QUESTIONS, EVAL_EVERY, KEEP_CHECKPOINTS = 1024, 10, 2
AB_STEPS = 10
STREAM_QUESTIONS, STREAM_STEPS = 1024, 10
# The probes' timed launches (the TPU probes' count).
PROBE_ITERS = 96
# vqa_baseline: questions of its corpus, its steps, and the images of the
# feature store file cli.predict reads.
BASELINE_QUESTIONS, BASELINE_STEPS, PREDICT_IMAGES = 1024, 10, 8
# Config overrides of the serving and training runs: none, the full width
# of config.py. (A rehearsal on the CPU shrinks the shapes above and here.)
MODEL_OVERRIDES: dict = {}
STAGE1_MODEL = {"model.model": "vlmap_description",
                "model.bidirectional_desc": True}
KERNELS = ["gru_fwd", "attention_fwd", "gru_bwd", "attention_resident_fwd",
           "attention_resident_bwd", "bigru_fwd", "bigru_bwd",
           "attention_bwd", "probe_mxu_rows", "probe_bwd_ceiling",
           "gru_fwd_f32", "gru_bwd_f32", "attention_resident_fwd_f32",
           "attention_resident_bwd_f32", "attention_fwd_f32",
           "attention_bwd_f32", "bigru_fwd_f32", "bigru_bwd_f32",
           "gru_fwd_f16", "gru_bwd_f16", "attention_resident_fwd_f16",
           "attention_resident_bwd_f16", "attention_fwd_f16",
           "attention_bwd_f16", "bigru_fwd_f16", "bigru_bwd_f16",
           "gru_fwd_wide", "gru_bwd_wide", "gru_fwd_wide_f16",
           "gru_bwd_wide_f16"]
# K4 and K5 on int8 rows: the glimpse counts checked against the plain
# versions (the limits are the bf16 rows', as the codes widen exactly to
# bf16), and the bound on v_att's relative quantization error against the
# bf16 store of the same grid (JAX's tests hold it under 1%; its config
# expects about 0.4%).
INT8_GLIMPSES = (1, 2, 8)
INT8_VATT_REL = 1e-2
# The profiler's name of the score tile of score_tile.cuh: K2's score
# launch and K4's.
SCORE_KERNEL = "score_tile::kernel"
# K2's whole call is also timed at the Predictor's default batch.
B_PREDICT = 8
# The real-data phase: VQA v2 questions (train, val) over COCO-like image
# ids, Visual Genome regions over the same images, the words the fixtures
# draw from and the distinct "other" answers of the train split (with
# yes/no and 0-10, more than REAL_TOP_K, so the answer table fills), the
# answers held out of training, each stage's steps, the in-loop cadence of
# stage 2 and the questions cli.predict answers.
REAL_TRAIN_QUESTIONS, REAL_VAL_QUESTIONS = 4096, 1024
REAL_IMAGES, REAL_REGIONS = 512, 4096
REAL_WORDS, REAL_OTHER_ANSWERS = 2400, 2300
REAL_TOP_K, REAL_HOLDOUT = 2000, 0.1
REAL_STAGE1_STEPS, REAL_STAGE2_STEPS, REAL_EVAL_EVERY = 10, 20, 10
REAL_PREDICT = 3
# The OOV phase: tools/oov_claim.py's protocol (the JAX tests' tiny config,
# 200 steps at batch 64 a stage) at OOV_WIDTHS: GRU 64, attention hidden
# 128, 128 channels, where the claim was measured on the card (PERF.md
# §6). Every kernel wrapper now takes the tiny config's own widths too
# (phase 30 runs them), zero-padding them to these multiples. The corpus
# is drawn at the tiny config's 32 channels and zero-padded: drawn at 128,
# its 21 in-vocabulary concepts span a sixth of the space, and no map
# learned from them reaches the held-out answers (PERF.md §6).
OOV_WIDTHS = {"data.feature_dim": 128, "data.pool5_dim": 128,
              "model.rnn_dim": 64, "model.att_hidden": 128,
              "model.dtype": "bfloat16"}
OOV_CONCEPT_DIM = 32
# The raw-image phase (vqa_end2end): ResNet-101 (stages, stem width) at 448
# pixels in bf16 (a 14x14x2048 grid), the backbone's batch and its seed;
# the synthetic corpus (one uint8 image a question: 512 x 448 x 448 x 3 =
# 308 MB on the card), the training batch and steps, the serving batch;
# and the JPEG fixtures (if PIL imports on the card): images, region
# crops, streamed training steps.
E2E_STAGES, E2E_WIDTH, E2E_SIZE = "3,4,23,3", 64, 448
E2E_BATCH, E2E_IMAGES, E2E_STEPS, E2E_PREDICT = 32, 512, 10, 8
E2E_JPEGS, E2E_REGIONS, E2E_JPEG_STEPS = 64, 96, 4
# The backbone's bf16 grid and pool5 against the same weights in float32
#     on the card (TF32 off). Each of the 104 convolutions rounds its
#     output to bf16 (an error up to 2^-9 of a value, either sign), and the
#     residual chain carries these like a random walk: about sqrt(104) x
#     2^-9 / sqrt(3) = 1.2% of a value (measured on the CPU at 128 pixels:
#     0.85% in the mean, 1.1% of the largest entry, cosine 0.99996). The
#     limits are twice that and more: the mean |error| 2^-5 of the mean
#     |value|, the largest 2^-4 of the largest |value|, cosine 0.999. A
#     wrong layer (a dropped BatchNorm, a stride, a stem tap) moves the grid
#     by a large share of itself.
TOL_BACKBONE_MEAN, TOL_BACKBONE_MAX, BACKBONE_COS = 2.0 ** -5, 2.0 ** -4, 0.999
# Phase 23, train.steps_per_call: the graphed step (a CUDA graph of k steps,
# replayed once a call) at each k of SPC_KS against the eager step (k = 1)
# on the main path, SPC_STEPS steps a run, the wall time a step on CUDA
# events between the call boundaries SPC_TIMED (past the capture) and a
# profiler window over the SPC_PROFILE_STEPS after them; stage 1, the
# gathered path, remat and sort_batch_by_image over SPC_SIDE_STEPS steps
# (timed between SPC_SIDE_TIMED); a dropout run of SPC_RESUME_STEPS with
# a checkpoint at SPC_RESUME_AT, resumed from it.
SPC_KS = (4, 8)
SPC_STEPS, SPC_TIMED, SPC_PROFILE_STEPS = 32, (8, 24), 8
SPC_SIDE_STEPS, SPC_SIDE_TIMED = 12, (4, 12)
SPC_RESUME_STEPS, SPC_RESUME_AT = 16, 8
# The raw-image model at k = E2E_SPC_K against eager (phase 22):
# E2E_SPC_STEPS steps, timed between E2E_SPC_TIMED, then a profiler window
# over 2 more.
E2E_SPC_K, E2E_SPC_STEPS, E2E_SPC_TIMED = 2, 8, (2, 6)
# The port's kernels in a profiler trace by the wrapper whose counter
# counts their launches: the prefixes of their names as
# tools/trace_summary.py::kernel_name gives them. No two wrappers of one
# training path share a kernel.
TRACE_KERNELS = {
    "gru_fwd": ("gru_seq_kernel",), "bigru_fwd": ("gru_seq_kernel",),
    "gru_bwd": ("gru_bptt_kernel", "gru_duh_pipe_kernel", "gru_dbhn_kernel"),
    "bigru_bwd": ("gru_bptt_kernel", "gru_duh_pipe_kernel",
                  "gru_dbhn_kernel"),
    "attention_fwd": ("score_tile::kernel", "attn_wsum_kernel"),
    "attention_bwd": ("attn_bwd_dz_kernel", "attn_bwd_fold_kernel",
                      "attn_dwv::"),
    "attention_resident_fwd": ("score_tile::kernel", "attn_res_wsum_kernel"),
    "attention_resident_bwd": ("attn_res_bwd_rows_kernel", "attn_dwv::"),
    # Phase 32's graphed paths: the float16 builds and the int8 rows run
    # the bf16 kernels' bodies under their names; the float32 main path's
    # kernels of csrc/gru_seq_f32.cuh, fp32_ring.cuh and attention_f32.cuh
    # (K1f and K3f in their persistent forms).
    "gru_fwd_f16": ("gru_seq_kernel",),
    "gru_bwd_f16": ("gru_bptt_kernel", "gru_duh_pipe_kernel",
                    "gru_dbhn_kernel"),
    "attention_resident_fwd_f16": ("score_tile::kernel",
                                   "attn_res_wsum_kernel"),
    "attention_resident_bwd_f16": ("attn_res_bwd_rows_kernel", "attn_dwv::"),
    "attention_resident_fwd[int8]": ("score_tile::kernel",
                                     "attn_res_wsum_kernel"),
    "attention_resident_bwd[int8]": ("attn_res_bwd_rows_kernel",
                                     "attn_dwv::"),
    "gru_fwd_f32": ("gru_seq_f32::gru_f32_seq_kernel",),
    "gru_bwd_f32": ("gru_seq_f32::gru_f32_gh_kernel",
                    "gru_seq_f32::gru_f32_bptt_kernel",
                    "gru_seq_f32::gru_f32_duh_kernel",
                    "gru_f32::gru_f32_dbhn_kernel"),
    "attention_resident_fwd_f32": ("attn_f32_score_ring_kernel",
                                   "attn_f32_wsum_kernel",
                                   "attn_f32_rnorm_kernel"),
    "attention_resident_bwd_f32": ("attn_f32_bwd_rows_kernel",
                                   "fp32_ring::product_kernel",
                                   "attn_f32_bwd_reduce_kernel"),
}
# Phase 24, multi-device on the one card. (a) World 1 under NCCL against no
# group: MD_STEPS steps eagerly and at k = MD_K, the wall time a step on
# CUDA events between MD_TIMED and a profiler window over MD_PROFILE. (b)
# MD_WORLD gloo ranks spawned on the card, MD_RANK_STEPS steps each (timed
# between MD_RANK_TIMED), each run joined within MD_JOIN_S seconds, on
# data whose <unk> answers fall unevenly between the ranks (md_dataset).
# Its comparisons of two runs hold the logged losses to MD_TOL_LOSS and
#     the parameter changes (one vector) to cosine MD_GRAD_COS: the ranks'
#     halves of a batch are summed in f32 after their bf16 products, in
#     another order than one process's sums, and Adam turns that rounding
#     into update differences where a gradient entry is near zero. On an
#     H100 the sound runs read at most 4.85e-4 and at least 0.99984; runs
#     with a fault planted (the sharded store's global row for row // n,
#     the gradient bucket or the step's weight not summed, the row
#     product's cotangent not summed over the model group) read at least
#     0.0396 and at most 0.808 (PERF.md, PR 20). Each limit sits about 6x
#     from the sound runs' worst and far from the faults' nearest.
MD_TOL_LOSS, MD_GRAD_COS = 3e-3, 0.999
MD_K, MD_STEPS, MD_TIMED, MD_PROFILE = 4, 12, (4, 8), (8, 12)
MD_WORLD, MD_RANK_STEPS, MD_RANK_TIMED, MD_JOIN_S = 2, 6, (2, 6), 420
MD_CASES = {
    "replicated": {},
    "sharded": {"train.store_sharded": True},
    "tp": {"mesh.num_model": 2,
           "mesh.shard_params": "answer_embedding,word_emb"},
}
# Graphed against eager parameters (and remat against none): expected bit
#     for bit, the same deterministic kernels in the same order on the same
#     inputs. Should cuBLAS take another algorithm on the capture stream,
#     a GEMM's sums change order, and a last-bit difference flips a bf16
#     rounding (2^-8 of a value) ahead of later layers; Adam turns that
#     into update differences well below a step's size, so the largest
#     parameter difference is held to 2^-9 of the largest parameter change
#     of the run (a wrong step, batch or mask moves a parameter by a whole
#     update).
SPC_PARAM_REL = 2.0 ** -9
# Phase 25, float32. The float32 kernels K1f, K3f, K4f and K5f take FFMA
#     products with f32 sums and round to no narrower type, so each output
#     differs from its plain version (cuBLAS's f32 GEMMs and PyTorch's f32
#     ops, TF32 off) only by the order of f32 sums: a sum of n terms in
#     another order moves by about sqrt(n) 2^-24 of its terms' scale, under
#     1e-6 of the largest value of an output at the main path's sums (512
#     to 50176 terms). Each output is held to TOL_F32_REL of its largest
#     value, and K5f's dqh and dW_v, whose dz sums G glimpse terms, to G
#     times that (as GLIMPSE_CHECKS reasons for K5). A wrong step, gate,
#     mask, row or glimpse moves an output by a large share of its largest
#     value. The store holds F32_IMAGES images; K4f/K5f run at
#     F32_GLIMPSES on each of F32_ROWS.
TOL_F32_REL = 1e-5
F32_IMAGES, F32_GLIMPSES = 512, (1, 2, 8)
# K1f's and K3f's launches a call at the main path's width (H = 512): the
#     persistent forms of csrc/gru_seq_f32.cuh (phase 25 checks the route),
#     K1f one cooperative launch, K3f every step's gh, the chain, dU_h and
#     db_hn.
K1F_LAUNCHES, K3F_LAUNCHES = 1, 4
F32_ROWS = ("float32", "float16", "int8")
# The float32 main path's first step against the plain path on the card:
#     no bf16 rounding anywhere, so the loss (about 7.6) moves by the f32
#     sums' order alone; held to 1e-5 and every gradient to cosine 0.99999.
#     F32_STEPS steps of fit_resident, the first F32_WARMUP untimed, so
#     the step time is a median of at least 10 timed steps (one epoch of
#     the corpus; host noise moved medians of 2 to 4 steps by 2x).
TOL_F32_LOSS, F32_GRAD_COS = 1e-5, 0.99999
F32_STEPS, F32_WARMUP = 16, 3
# Phase 27, float32 on the gathered attention (K2f, K8f) and the
#     bidirectional GRU (K6f, K7f), held as phase 25's kernels are: each
#     output to TOL_F32_REL of its largest value, K2f's r to TOL_R_REL. K8f
#     recomputes z = (v . W_v) r + qh with its own order of f32 sums, which
#     differs from the plain version's (cuBLAS) by less than 2^-12 of the
#     sum of the terms' magnitudes (C u <= 2^-13 at C=2048 for each order),
#     so a unit whose z lies that close to 0 may take the other side of the
#     ReLU in one version: K8f's dqh and dW_v also get k8_allowance's room,
#     entry by entry, as K8's do. K6f and K7f run K1f's and K3f's
#     persistent kernels (or their step forms) with both chains in each
#     launch: bit-equal to two K1f / K3f calls, every form to the others.
#     F32_ODD_SHAPE (B, N, C, H) lies off every tile of the bf16 kernels.
#     The float32 Predictor's logits (10 cos + bias, |logit| about 10)
#     against its plain path: only the order of f32 sums differs, which
#     moves each layer's outputs by about 1e-7 of their scale and the
#     logits by about 1e-6; TOL_F32_LOGITS leaves a hundredfold margin, and
#     a wrong kernel moves logits by a share of their spread. The
#     Predictor runs at F32_PREDICT_BATCHES.
F32_ODD_SHAPE = (8, N, 2000, 500)
TOL_F32_LOGITS = 1e-4
F32_PREDICT_BATCHES = (B_PREDICT, B)
# Phase 26, model.fidelity_mode: the forward at FID_BATCH questions from
#     seed FID_SEED against the float64 oracle at the JAX package's own
#     tolerance for it (atol 5e-4, rtol 1e-4: its tests/test_fidelity.py),
#     then FID_STEPS steps through cli.train (timed as float32's).
FID_SEED, FID_BATCH, FID_STEPS = 0, 8, 16
FID_ATOL, FID_RTOL = 5e-4, 1e-4
# Phase 28, float16. K1h, K3h, K4h and K5h are K1's, K3's, K4's and K5's
#     bodies with float16 as their element type: the same products, sums
#     and rounding points, each rounding to float16's 11 significant bits
#     (a step of 2^-11 of a value) where bf16 keeps 8 (2^-8). Each limit is
#     the bf16 kernel's with that step: K1h's h TOL_GRU / 8 (a flipped
#     rounding of the state moves one product by a float16 step), K3h
#     2^-11 of each output's largest value (TOL_K3_REL / 8), K4h's saved h
#     2^-10 (one float16 step of the largest |h|; TOL_K4_H_REL / 8), K5h
#     2^-12 (TOL_K5_REL / 8; G times that for dqh and dW_v, as
#     GLIMPSE_CHECKS reasons), alpha TOL_ALPHA (f32 sums). v_att keeps
#     TOL_VATT_REL (2^-10): its weights alpha * r are rounded to float16,
#     and the two versions' alpha differ by up to ~4e-5 of themselves, in
#     one direction within a question (the softmax's sum): a tenth of a
#     float16 step, so many weights land one step apart at once, where
#     bf16's coarser step leaves few; each moves its term by at most 2^-10
#     of it (v >= 0), so v_att moves by at most 2^-10 of itself (3.7e-4
#     read on an H100 at G=8). No limit is looser than the bf16 kernel's.
#     The first training step against the plain path: the loss to
#     TOL_LOSS / 8 (the activations are normal float16 numbers, a flip
#     moves one by 2^-11), every gradient to bf16's cosine 0.999 where the
#     model allows it. A float16 model's cotangents are float16 too, and
#     small ones fall below float16's smallest normal value 2^-14, where
#     it keeps fewer significant bits: on the int8 store the v_att
#     cotangent is multiplied by the store's scale before the backward
#     rounds it to float16 (JAX's B4 does the same), and at full width it
#     is ~2e-6, all of it below 2^-14 (bf16 keeps it normal). There the
#     plain path alone, with its v_att perturbed by 1e-5 of itself (less
#     than K4h's and its plain version's v_att differ), moves
#     att_q.weight's gradient to cosine 0.99881, and the kernels' path
#     reads 0.99881 against it (H100, PR 23): a property of the float16
#     model, not of a kernel. So each run first measures that cosine for
#     every parameter (f16_grad_bounds) and holds the kernels to bf16's
#     0.999, or, where the perturbed plain path moves a gradient further,
#     to F16_SENSITIVITY times its distance (1 - cosine); a wrong kernel
#     moves gradients to cosines far below either. F16_STEPS steps of
#     fit_resident a store, the first F16_WARMUP untimed; the kernel
#     checks run at each of F16_BATCHES and F16_GLIMPSES.
TOL_F16_GRU = TOL_GRU / 8
TOL_F16_K3_REL = TOL_K3_REL / 8
TOL_F16_K4_H_REL = TOL_K4_H_REL / 8
TOL_F16_VATT_REL = TOL_VATT_REL
TOL_F16_K5_REL = TOL_K5_REL / 8
TOL_F16_LOSS, F16_GRAD_COS = TOL_LOSS / 8, GRAD_COS
F16_PERTURB, F16_SENSITIVITY = 1e-5, 4
F16_STEPS, F16_WARMUP = 16, 3
F16_BATCHES, F16_GLIMPSES = (B_TRAIN, B), (1, 2, 8)
# Phase 29, float16 off the main path. K2h, K8h, K6h and K7h are K2's,
#     K8's, K6's and K7's bodies with float16 as their element type, held
#     as phase 28 holds K1h-K5h: K2h's alpha TOL_ALPHA, v_att
#     TOL_F16_VATT_REL, r TOL_R_REL; K8h 2^-12 of each output's largest
#     value (TOL_K8_REL / 8) plus k8_allowance's room for ReLU flips (the
#     products of two float16 values are exact in f32, as bf16's are, so
#     the room is K8's); K6h's h TOL_F16_GRU and K7h TOL_F16_K3_REL, each
#     bit-equal to two K1h / K3h calls. The float16 Predictor's logits
#     against the plain path: TOL_LOGITS / 8 (its activations between
#     layers are float16, a flip moves one by 2^-11 where bf16's moves it
#     by 2^-8), at F16_PREDICT_BATCHES. The gathered training and stage 1
#     run F16_STEPS steps (first against the plain path as phase 28's);
#     the streamed loop F16_STREAM_STEPS on F16_STREAM_QUESTIONS
#     questions of the flat layout, the transfer F16_TRANSFER_STEPS.
TOL_F16_K8_REL = TOL_K8_REL / 8
TOL_F16_LOGITS = TOL_LOGITS / 8
F16_PREDICT_BATCHES = (B_PREDICT, B)
F16_STREAM_QUESTIONS, F16_STREAM_STEPS, F16_TRANSFER_STEPS = 512, 4, 4
# Phase 30, widths. Every 16-bit kernel (K1-K8, their float16 builds, K4/K5
#     on int8 codes) at widths off its multiples, WIDTH_H units and WIDTH_C
#     channels, which its wrapper zero-pads (a padded unit or channel adds
#     exact zeros), held to its plain version at the limits of its own
#     phase (float16's scaled by its step, 1/8). The GRU's step form
#     (csrc/gru_wide_step.cuh) runs past the forward's crossover
#     (kernels.GRU_FWD_STEP_ABOVE, 832 units) and where the persistent
#     BPTT's shared memory ends (above 576 units): stage 2
#     gather-free at each of WIDE_RNN (a 1024-unit question GRU; the
#     2400 units of Skip-Thought's uni-skip encoder, which MUTAN encodes
#     questions with) in bf16 for WIDE_STEPS steps, its first step against
#     the plain path at phase 9's bounds and the resident evaluator; stage 1
#     at WIDE_RNN[0] in bf16 the same; float16 stage 2 and bf16 and float16
#     stage 1 at WIDE_RNN[-1] for WIDE_F16_STEPS steps (the step forms'
#     remaining builds on a training path); oov_claim's TINY (GRU 16,
#     attention 16, 32 channels) in bf16 for TINY_STEPS steps a stage
#     through cli.train, cli.eval and the Predictor. The step forms and the
#     padding are timed: K1's and K3's step forms at B = 256, T = 26 at
#     each of WIDE_RNN (the BPTT's split by launch from one profile),
#     K6's and K7's at WIDE_RNN[0], the forward's two forms across
#     CROSSOVER_H, and K2, K4, K5, K8 at each (C, H) of PAD_SHAPES in
#     turns. The phase's wall is held to
#     WIDTHS_BUDGET_S seconds in its report.
WIDTH_H = (8, 24, 40, 100, 600)
WIDTH_C = (16, 48, 100, 300)
WIDE_RNN = (1024, 2400)
WIDE_STEPS, WIDE_F16_STEPS, TINY_STEPS = 8, 4, 20
# The forward's crossover sweep (widths_gru_crossover): the route keeps
# the persistent K1 while it is no more than CROSSOVER_ROOM times the step
# form's time at both batches (the two are within turn-to-turn noise
# there).
CROSSOVER_H = (512, 576, 640, 704, 768, 832, 896, 1024)
CROSSOVER_ROOM = 1.01
# The step form's BPTT by launch, as a profile names its kernels.
STEP_BPTT_PARTS = {"copy": "wide::gru_wide_round_kernel",
                   "gh": "wide::gru_wide_gh_kernel",
                   "carry": "wide::gru_wide_carry_kernel",
                   "duh": "attn_dwv::dwv_kernel",
                   "dbhn": "gru_dbhn_kernel"}
PAD_SHAPES = ((2048, 512), (2048, 500), (2000, 512))
WIDTHS_BUDGET_S = 120
# sort_batch_by_image permutes each batch: every reduction over it is the
#     same sum in another order, so the runs differ by rounding that Adam
#     amplifies where a gradient entry is near zero. The logged losses are
#     held to TOL_LOSS and the runs' parameter changes (every parameter as
#     one vector) to cosine GRAD_COS; a batch trained on other questions
#     moves them far apart.


# Phase 31, the input modules: a raw feature store of INPUT_IMAGES rows in
# the COCO grid's layout (14x14x2048 f16, 822 MB, and 2048 f32 pool5) and
# INPUT_QUESTIONS questions over it, drawn from --seed; the native gathers
# of an INPUT_GATHER-row batch against numpy (bit for bit), timed over
# INPUT_RUNS on the host; INPUT_JPEGS seeded JPEGs (half at the model's
# 448 pixels, half COCO's 640 x 480) and one CMYK file through
# ImageQuestionDataset where libjpeg's headers exist; stage-2 training on
# the store through cli.train for INPUT_STEPS steps with a checkpoint
# every INPUT_CKPT_EVERY, fed by grain (and resumed from its checkpoint)
# where grain imports.
INPUT_IMAGES, INPUT_QUESTIONS, INPUT_GATHER, INPUT_RUNS = 1024, 4096, 256, 5
INPUT_JPEGS, INPUT_STEPS, INPUT_CKPT_EVERY = 32, 8, 4
# The native decoder against PIL after a resize: the same triangle filter,
# in float against PIL's 8-bit fixed point (JAX's and the CPU tests' rule).
INPUT_DECODE_STEP = 1

# Phase 32, the ported paths no earlier phase ran, at config.py's full
# width, cut in depth only. (f) The main path (the gather-free store) at
# train.steps_per_call UNRUN_K against eager from one initialization,
# dropout 0, in float32, float16 and on the int8 store: UNRUN_STEPS steps,
# wall ms between UNRUN_TIMED, a profiler window over the last
# UNRUN_PROFILE (one replay). (c) The same at model.rnn_dim UNRUN_WIDE in
# bf16 (the GRU's step forms); a float32 model at that width, stage 2
# with its evaluator and stage 1, UNRUN_WIDE_STEPS steps each. (b) The
# streamed loop in float32 for UNRUN_STREAM_STEPS steps on
# STREAM_QUESTIONS questions of the flat layout. (a) vqa_end2end in
# float32 and float16: cli.train for UNRUN_E2E_STEPS steps at E2E_BATCH on
# UNRUN_E2E_IMAGES images, cli.eval, the Predictor at E2E_PREDICT. (d)
# Phase 24's world-1 runs in float32 and float16, and its two gloo ranks
# on the replicated store in float32. The phase's wall is printed beside
# UNRUN_BUDGET_S.
UNRUN_K = 4
UNRUN_STEPS, UNRUN_TIMED, UNRUN_PROFILE = 12, (4, 8), 4
UNRUN_WIDE, UNRUN_WIDE_STEPS = 2400, 4
UNRUN_STREAM_STEPS = 6
UNRUN_E2E_STEPS, UNRUN_E2E_IMAGES = 4, 128
UNRUN_BUDGET_S = 180
# The float16 backbone against float32 on the card: phase 22's bf16 limits
#     scaled by float16's step (each convolution rounds its output to 11
#     significant bits where bf16 keeps 8: 2^-3 of bf16's error), the
#     cosine's distance from 1 the same.
TOL_F16_BACKBONE_MEAN = TOL_BACKBONE_MEAN / 8
TOL_F16_BACKBONE_MAX = TOL_BACKBONE_MAX / 8
F16_BACKBONE_COS = 1 - (1 - BACKBONE_COS) / 8
# Two gloo ranks against one process in float32 (phase 32 (d)): the ranks'
#     halves of a batch are summed in another order than one process's
#     sums, with no bf16 rounding after them, so the runs differ by f32
#     summation order, which Adam turns into update differences only where
#     a gradient entry is near zero. md_fault_check.py in float32 on the
#     CPU read the sound runs at most 4.8e-7 (losses) and at least
#     1 - 2.5e-11 (change cosine), the planted faults at least 0.315 and at
#     most 0.839; on an H100 the sound float32 run read 1.43e-6 and a
#     cosine that rounds to 1 at nine places (PERF.md §6). Each limit
#     sits about 70x from the sound runs' worst and far from the faults.
MD_TOL_LOSS_F32, MD_GRAD_COS_F32 = 1e-4, 0.9999


class PhaseError(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def flush_l2(buf) -> None:
    buf.zero_()  # 128 MB write: evicts the 50 MB L2 between timed runs


def time_cuda(fn, buf, runs: int = RUNS, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``runs`` CUDA-event timings."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush_l2(buf)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def carried_steps(lens) -> int:
    """The row-steps of a GRU chain that take a product with the carried
    state: each row's live steps after its first. At a row's first step
    the carry is zero, so its h_prev @ U_h, its share of dU_h and the
    U_h^T product into the zero start need no work."""
    return int((lens.long() - 1).clamp_min(0).sum().item())


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions (for the reference
    runs of the whole model on the card)."""
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru)

    saved = (attention.attention_fwd, gru.gru_fwd, gru.gru_bwd,
             ar.attention_resident_fwd, ar.attention_resident_bwd,
             gru.bigru_fwd, gru.bigru_bwd, attention.attention_bwd)
    attention.attention_fwd = (
        lambda v, qh, wv, ws, *, normalize:
        attention.attention_fwd_reference(v, qh, wv, ws, normalize))
    attention.attention_bwd = attention.attention_bwd_reference
    gru.gru_fwd = gru.gru_reference
    gru.gru_bwd = gru.gru_bwd_reference
    ar.attention_resident_fwd = ar.attention_resident_fwd_reference
    ar.attention_resident_bwd = ar.attention_resident_bwd_reference
    gru.bigru_fwd = gru.bigru_reference
    gru.bigru_bwd = gru.bigru_bwd_reference
    try:
        yield
    finally:
        (attention.attention_fwd, gru.gru_fwd, gru.gru_bwd,
         ar.attention_resident_fwd, ar.attention_resident_bwd,
         gru.bigru_fwd, gru.bigru_bwd, attention.attention_bwd) = saved


def launch_counters():
    """{kernel name: (its wrapper, the wrapper's count attribute)}. K4 and
    K5 (and K4h and K5h) count their launches on int8 rows apart."""
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru)
    from vqa_transfer_externaldata_torch.tools import (
        probe_bwd_ceiling as p2, probe_mxu_rows as p1)

    plain = {"gru_fwd": gru.gru_fwd, "attention_fwd": attention.attention_fwd,
             "gru_bwd": gru.gru_bwd,
             "attention_resident_fwd": ar.attention_resident_fwd,
             "attention_resident_bwd": ar.attention_resident_bwd,
             "bigru_fwd": gru.bigru_fwd, "bigru_bwd": gru.bigru_bwd,
             "attention_bwd": attention.attention_bwd,
             "probe_mxu_rows": p1.probe_mxu_rows,
             "probe_bwd_ceiling": p2.probe_bwd_ceiling,
             "gru_fwd_f32": gru.gru_fwd_f32, "gru_bwd_f32": gru.gru_bwd_f32,
             "attention_resident_fwd_f32": ar.attention_resident_fwd_f32,
             "attention_resident_bwd_f32": ar.attention_resident_bwd_f32,
             "attention_fwd_f32": attention.attention_fwd_f32,
             "attention_bwd_f32": attention.attention_bwd_f32,
             "bigru_fwd_f32": gru.bigru_fwd_f32,
             "bigru_bwd_f32": gru.bigru_bwd_f32,
             "gru_fwd_f16": gru.gru_fwd_f16, "gru_bwd_f16": gru.gru_bwd_f16,
             "attention_resident_fwd_f16": ar.attention_resident_fwd_f16,
             "attention_resident_bwd_f16": ar.attention_resident_bwd_f16,
             "attention_fwd_f16": attention.attention_fwd_f16,
             "attention_bwd_f16": attention.attention_bwd_f16,
             "bigru_fwd_f16": gru.bigru_fwd_f16,
             "bigru_bwd_f16": gru.bigru_bwd_f16,
             **{name: getattr(gru, name) for name in (
                 "gru_fwd_wide", "gru_bwd_wide", "bigru_fwd_wide",
                 "bigru_bwd_wide", "gru_fwd_wide_f16", "gru_bwd_wide_f16",
                 "bigru_fwd_wide_f16", "bigru_bwd_wide_f16")}}
    out = {name: (fn, "launches") for name, fn in plain.items()}
    for name in ("attention_resident_fwd", "attention_resident_bwd",
                 "attention_resident_fwd_f16", "attention_resident_bwd_f16"):
        out[f"{name}[int8]"] = (plain[name], "launches_int8")
    return out


def reset_counts() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def check_launches(launches: dict, expected: dict, what: str) -> None:
    """``expected`` lists the kernels that ``what`` must launch, with their
    counts; every other kernel must not have launched."""
    want = {name: expected.get(name, 0) for name in launches}
    print(f"{what} launches: {launches}")
    check(launches == want, f"{what}: expected launches {want}, got "
          f"{launches}")


def rel_err(got, want) -> float:
    return ((got - want).abs().max().item()
            / max(want.abs().max().item(), 1e-30))


def phase_build(report: dict) -> None:
    from vqa_transfer_externaldata_torch.ops import kernels

    t0 = time.perf_counter()
    built = kernels.build(KERNELS)
    report["build_s"] = time.perf_counter() - t0
    for name, (text, _) in built.items():
        print(f"--- nvcc {name}.cu ---\n{text.strip()}", file=sys.stderr)
    report["ptxas"] = {name: text for name, (text, _) in built.items()}
    report["nvcc_s"] = {name: s for name, (_, s) in built.items()}
    print(f"built kernels in {report['build_s']:.1f} s (nvcc per source, "
          "all started together: " + ", ".join(
              f"{name} {s:.1f} s" for name, s in report["nvcc_s"].items())
          + ")")


def bptt_launch(config, batch: int, dev, what: str) -> dict:
    """The persistent BPTT step launch of K3 or K7 at ``batch`` x H
    (``kernels.gru_bwd_plan`` on the blocks per SM that the C side
    reports), printed."""
    launch = config(batch, H, dev)
    print(f"{what} persistent step launch at B={batch}, H={H}: grid "
          + " x ".join(map(str, launch["grid"])) + " blocks of 256 threads "
          f"(j-tiles x rows x directions) over {launch['b_tiles']} b-tiles, "
          f"{launch['blocks_per_sm']} resident per SM, "
          f"{launch['smem_bytes']} B of dynamic shared memory, H <= "
          f"{launch['max_width']}")
    return launch


def ptxas_entry(text: str, kernel: str) -> list:
    """The lines of an ``nvcc -Xptxas -v`` report about the entry function
    whose mangled name holds ``kernel`` (registers, spills, warnings)."""
    out, inside = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        if inside or (kernel in line and "warning" in line.lower()):
            out.append(line.strip())
    return out


def phase_gru(report: dict, dev, gen) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import gru

    gx = torch.randn(T, B, 3 * H, generator=gen, device=dev) * 0.5
    lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    uh = ((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    bhn = torch.randn(H, generator=gen, device=dev) * 0.1
    err = 0.0
    for reverse in (False, True):
        hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
        rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
        torch.cuda.synchronize()
        e = max((hT - rT).abs().max().item(), (hseq - rseq).abs().max().item())
        print(f"K1 gru_fwd reverse={reverse}: max abs err {e:.3e} "
              f"(tol {TOL_GRU})")
        check(bool(torch.isfinite(hseq).all()), "K1 output not finite")
        check(e <= TOL_GRU, f"K1 reverse={reverse} err {e} > {TOL_GRU}")
        err = max(err, e)
    return {"gx": gx, "lens": lens, "uh": uh, "bhn": bhn, "err": err}


def k2_checks(v, qh, wv, ws) -> list:
    """K2 against its plain version on v [B, N, C], normalize on and off;
    a second call bit-equal to the first; and K4 on the identity store
    (store v, rows 0..B-1, every cell valid, one glimpse), which runs the
    same score tile of score_tile.cuh on the same rows in the same order,
    giving K2's alpha and r bit for bit."""
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar)

    Bq, Nq = v.shape[:2]
    rows = torch.arange(Bq, dtype=torch.int32, device=v.device)
    checks = []
    for normalize in (True, False):
        va, al, r = attention.attention_fwd(v, qh, wv, ws,
                                            normalize=normalize)
        again = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
        _, al4, _, r4 = ar._launch_fwd(v, rows, qh, wv, ws, Nq, normalize,
                                       False)
        rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws,
                                                       normalize)
        torch.cuda.synchronize()
        ev = (va - rv).abs().max().item()
        ea = (al - ra).abs().max().item()
        er = rel_err(r, rr)
        tol_v = TOL_VATT_REL * rv.abs().max().item()
        same = all(torch.equal(a, b) for a, b in zip((va, al, r), again))
        k4_alpha, k4_r = torch.equal(al, al4), torch.equal(r.reshape(-1), r4)
        print(f"K2 attention_fwd B={Bq} normalize={normalize}: max abs err "
              f"v_att {ev:.3e} (tol {tol_v:.3e} = 2^-10 * max|v_att|), "
              f"alpha {ea:.3e} (tol {TOL_ALPHA}), r {er:.3e} of max|r| (tol "
              f"{TOL_R_REL:.0e}); two calls bit-equal {same}; alpha and r "
              f"bit-equal to K4's on the identity store {k4_alpha} {k4_r}")
        check(er <= TOL_R_REL, f"K2 normalize={normalize} r err {er}")
        check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
              "K2 output not finite")
        check(ev <= tol_v, f"K2 normalize={normalize} v_att err {ev} > "
              f"{tol_v}")
        check(ea <= TOL_ALPHA, f"K2 normalize={normalize} alpha err {ea} > "
              f"{TOL_ALPHA}")
        check(same, f"K2 B={Bq} normalize={normalize}: two calls differ")
        check(k4_alpha and k4_r, f"K2 B={Bq} normalize={normalize}: alpha "
              f"({k4_alpha}) or r ({k4_r}) differs from K4's on the "
              "identity store")
        checks.append({"batch": Bq, "normalize": normalize, "v_att_err": ev,
                       "v_att_tol": tol_v, "alpha_err": ea,
                       "alpha_tol": TOL_ALPHA, "r_rel_err": er,
                       "r_rel_tol": TOL_R_REL, "two_calls_bit_equal": same,
                       "k4_identity_store_alpha_bit_equal": k4_alpha,
                       "k4_identity_store_r_bit_equal": k4_r})
    return checks


def phase_attention(report: dict, dev, gen) -> dict:
    import torch

    # Post-ReLU grid features, each cell scaled by its own factor in
    # [1/4, 4], so that the cells' norms differ as real ones do and a
    # weight taken with another cell's norm shows in v_att.
    scale = torch.exp2(torch.rand(B, N, 1, generator=gen, device=dev) * 4 - 2)
    v = (torch.randn(B, N, C, generator=gen, device=dev).relu_() * scale).to(
        torch.bfloat16)
    qh = torch.randn(B, H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (C + H)) ** 0.5
    wv = ((torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    checks = k2_checks(v, qh, wv, ws)
    return {"v": v, "qh": qh, "wv": wv, "ws": ws, "checks": checks}


def phase_gru_bwd(report: dict, dev, gen) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    Bt = B_TRAIN
    gx = torch.randn(T, Bt, 3 * H, generator=gen, device=dev) * 0.5
    lens = torch.randint(1, T + 1, (Bt,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[1] = T, 1  # the longest and the shortest question
    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    uh = ((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    bhn = torch.randn(H, generator=gen, device=dev) * 0.1
    ghT = torch.randn(Bt, H, generator=gen, device=dev) * 0.05
    err, checks, hseq_fwd, err1 = 0.0, [], None, 0.0
    for reverse in (False, True):
        # K1 at the training batch against its plain version; both K3 and
        # its plain version then take K1's hseq, as on the training path.
        hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
        rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
        torch.cuda.synchronize()
        e1 = max((hT - rT).abs().max().item(),
                 (hseq - rseq).abs().max().item())
        print(f"K1 gru_fwd B={Bt} reverse={reverse}: max abs err {e1:.3e} "
              f"(tol {TOL_GRU})")
        check(bool(torch.isfinite(hseq).all()), "K1 output not finite")
        check(e1 <= TOL_GRU, f"K1 B={Bt} reverse={reverse} err {e1} > "
              f"{TOL_GRU}")
        err1 = max(err1, e1)
        got = gru.gru_bwd(gx, hseq, lens, uh, bhn, ghT, reverse=reverse)
        want = gru.gru_bwd_reference(gx, hseq, lens, uh, bhn, ghT,
                                     reverse=reverse)
        torch.cuda.synchronize()
        for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
            e, rel = (a - b).abs().max().item(), rel_err(a, b)
            print(f"K3 gru_bwd reverse={reverse} {name}: max abs err "
                  f"{e:.3e}, {rel:.3e} of max|{name}| (tol {TOL_K3_REL:.3e})")
            check(bool(torch.isfinite(a).all()), f"K3 {name} not finite")
            check(rel <= TOL_K3_REL, f"K3 reverse={reverse} {name} relative "
                  f"err {rel} > {TOL_K3_REL}")
            checks.append({"reverse": reverse, "output": name,
                           "max_abs_err": e, "rel_err": rel,
                           "rel_tol": TOL_K3_REL})
            err = max(err, e)
        if not reverse:
            hseq_fwd = hseq
    launch = bptt_launch(gru.gru_bwd_launch_config, Bt, dev, "K3")
    report["gru_bwd_launch"] = launch
    # K1's persistent launch at the training and the serving batch: the
    # grid that the C side derives from the plan's rows and its occupancy
    # query, against the plan's on the same blocks per SM.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1_launch = {}
    for batch in (Bt, B):
        lk = gru.gru_fwd_launch_config(batch, H, dev)
        plan = kernels.gru_fwd_plan(batch, H, sms, lk["per_sm_by_rows"])
        print(f"K1 persistent launch at B={batch}, H={H}: 16 units x "
              f"{lk['rows']} rows a block, grid {lk['grid'][0]} x "
              f"{lk['grid'][1]} blocks of 256 threads, "
              f"{lk['blocks_per_sm']} resident per SM, "
              f"{lk['smem_bytes']} B of dynamic shared memory")
        check(lk["rows"] == plan["rows"] and lk["grid"] == plan["grid"],
              f"K1 launch {lk} differs from kernels.gru_fwd_plan {plan}")
        k1_launch[str(batch)] = lk
    report["gru_fwd_launch"] = k1_launch
    return {"gx": gx, "hseq": hseq_fwd, "lens": lens, "uh": uh, "bhn": bhn,
            "ghT": ghT, "err": err, "checks": checks, "k1_err": err1,
            "launch": launch, "k1_launch": k1_launch}


def phase_resident(report: dict, dev, gen) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention_resident as ar, kernels)

    M, Bt, n_valid = TRAIN_IMAGES, B_TRAIN, N
    Np = n_valid + (-n_valid) % 8
    # Post-ReLU cells, each scaled by its own factor in [1/4, 4] (a norm
    # taken from another cell shows), zero past n_valid as the padded store.
    store = torch.zeros(M, Np, C, dtype=torch.bfloat16, device=dev)
    for lo in range(0, M, 64):
        m = min(64, M - lo)
        scale = torch.exp2(torch.rand(m, n_valid, 1, generator=gen,
                                      device=dev) * 4 - 2)
        store[lo:lo + m, :n_valid] = (torch.randn(
            m, n_valid, C, generator=gen, device=dev).relu_() * scale).to(
                torch.bfloat16)
    rows = torch.randint(0, M, (Bt,), generator=gen, device=dev,
                         dtype=torch.int32)
    rows[1] = rows[2] = rows[0]  # questions that share an image
    qh = torch.randn(Bt, H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (C + H)) ** 0.5
    wv = ((torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    g = torch.randn(Bt, C, generator=gen, device=dev) * 0.01
    sga = torch.randn(Bt, Np, generator=gen, device=dev) * 0.1
    checks4, checks5 = [], []
    for normalize in (True, False):
        kw = dict(n_valid=n_valid, normalize=normalize)
        va, al, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                              save_h=True, **kw)
        rv, ra, rh = ar.attention_resident_fwd_reference(
            store, rows, qh, wv, ws, save_h=True, **kw)
        torch.cuda.synchronize()
        ev = (va - rv).abs().max().item()
        ea = (al - ra).abs().max().item()
        eh = (h.float() - rh.float()).abs().max().item()
        rh_err = rel_err(h.float(), rh.float())
        tol_v = TOL_VATT_REL * rv.abs().max().item()
        print(f"K4 attention_resident_fwd normalize={normalize}: v_att "
              f"{ev:.3e} (tol {tol_v:.3e}), alpha {ea:.3e} (tol "
              f"{TOL_ALPHA}), h {eh:.3e} = {rh_err:.3e} of max|h| (tol "
              f"{TOL_K4_H_REL:.3e})")
        check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
              "K4 output not finite")
        check(ev <= tol_v, f"K4 normalize={normalize} v_att err {ev}")
        check(ea <= TOL_ALPHA, f"K4 normalize={normalize} alpha err {ea}")
        check(rh_err <= TOL_K4_H_REL, f"K4 normalize={normalize} h err "
              f"{rh_err}")
        check(al[:, n_valid:].abs().max().item() == 0.0,
              "K4 gave padded cells weight")
        checks4.append({"normalize": normalize, "v_att_err": ev,
                        "v_att_tol": tol_v, "alpha_err": ea,
                        "alpha_tol": TOL_ALPHA, "h_err": eh,
                        "h_rel_err": rh_err, "h_rel_tol": TOL_K4_H_REL})
        # K5 and its plain version from the same saved h and alpha.
        got = ar.attention_resident_bwd(store, rows, rh, ws, ra, g, sga, **kw)
        want = ar.attention_resident_bwd_reference(store, rows, rh, ws, ra, g,
                                                   sga, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
            e, rel = (a - b).abs().max().item(), rel_err(a, b)
            print(f"K5 attention_resident_bwd normalize={normalize} {name}: "
                  f"max abs err {e:.3e}, {rel:.3e} of max|{name}| (tol "
                  f"{TOL_K5_REL:.3e})")
            check(bool(torch.isfinite(a).all()), f"K5 {name} not finite")
            check(rel <= TOL_K5_REL, f"K5 normalize={normalize} {name} "
                  f"relative err {rel} > {TOL_K5_REL}")
            checks5.append({"normalize": normalize, "output": name,
                            "max_abs_err": e, "rel_err": rel,
                            "rel_tol": TOL_K5_REL})
    # The score launch's shape at this batch (bf16 rows; int8 codes add a
    # slot of raw codes to each ring stage).
    cells = Bt * Np
    launch = ar.score_launch_config(cells, H, False)
    smem8 = ar.score_launch_config(cells, H, True)["smem_bytes"]
    launch["smem_bytes_int8"] = smem8
    launch["nvcc_s"] = report.get("nvcc_s", {}).get("attention_resident_fwd")
    nvcc = launch["nvcc_s"]
    print(f"K4 score launch at B={Bt}, Np={Np}, C={C}, H={H}: tiles of "
          f"{launch['tile'][0]} cells x {launch['tile'][1]} columns (BN "
          f"{launch['tile'][1]}), 256 threads, a ring of {launch['stages']} "
          f"stages of 64 channels, {launch['smem_bytes']} B of dynamic shared "
          f"memory ({smem8} B on int8 rows), grid {launch['grid'][0]} x "
          f"{launch['grid'][1]} (column tiles fastest); nvcc "
          f"attention_resident_fwd.cu "
          + ("already built" if nvcc is None else f"{nvcc:.1f} s"))
    report["score_launch"] = launch
    # K5's dW_v launch at this batch as the C side sets it, held against
    # the split that the wrappers take from kernels.dwv_plan.
    K = Bt * n_valid
    plan = kernels.dwv_plan(K, C, H, kernels.sm_count(dev))
    dwv = ar.dwv_launch_config(K, C, H, False, plan["splits"])
    check(dwv == plan, f"K5's dW_v launch {dwv} is not dwv_plan's {plan}")
    dwv["smem_bytes_int8"] = ar.dwv_launch_config(
        K, C, H, True, plan["splits"])["smem_bytes"]
    print(f"K5 dW_v launch over {K} cells, C={C}, H={H}: tiles of "
          f"{dwv['tile'][0]} channels x {dwv['tile'][1]} units, a ring of "
          f"{dwv['stages']} stages of 64 cells, {dwv['smem_bytes']} B of "
          f"dynamic shared memory ({dwv['smem_bytes_int8']} B on int8 rows), "
          f"{dwv['splits']} splits of {dwv['chunks_per_split']} chunks, grid "
          f"{' x '.join(map(str, dwv['grid']))}")
    report["dwv_launch"] = dwv
    # K5's rows launch (the per-question pass) as the C side sets it,
    # held against kernels.rows_plan.
    rows_launch = {}
    for G in (1, 8):
        plan = kernels.rows_plan(Bt, n_valid, G, C, H)
        got = ar.rows_launch_config(Bt, n_valid, G, C, H)
        check(got == plan, f"K5's rows launch at G={G} {got} is not "
              f"rows_plan's {plan}")
        print(f"K5 rows launch at B={Bt}, {n_valid} cells, G={G}: one "
              f"block a question, grid {plan['grid'][0]} x "
              f"{plan['threads']} threads, {plan['smem_bytes']} B of dynamic "
              f"shared memory, {plan['cell_lanes']} cell lanes, "
              f"{plan['unit_passes']} unit pass(es)")
        rows_launch[f"g{G}"] = plan
    report["rows_launch"] = rows_launch
    return {"store": store, "rows": rows, "qh": qh, "wv": wv, "ws": ws,
            "h": rh, "alpha": ra, "g": g, "sga": sga, "n_valid": n_valid,
            "checks4": checks4, "checks5": checks5,
            "err4": max(max(c["v_att_err"], c["alpha_err"], c["h_err"])
                        for c in checks4),
            "err5": max(c["max_abs_err"] for c in checks5)}


def phase_resident_multi(report: dict, dev, gen, k45: dict) -> dict:
    """K4 and K5 at G glimpses (GLIMPSE_CHECKS) against their plain
    versions on phase_resident's store and rows, normalize on and off, K5
    fed the plain version's saved h and alpha."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar

    store, rows, qh, wv = k45["store"], k45["rows"], k45["qh"], k45["wv"]
    n_valid = k45["n_valid"]
    Bt, Np = rows.shape[0], store.shape[1]
    checks4, checks5, keep = [], [], {}
    for G in GLIMPSE_CHECKS:
        ws = (torch.randn(H, G, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16).float()
        g = torch.randn(Bt, G * C, generator=gen, device=dev) * 0.01
        sga = torch.randn(Bt, Np, G, generator=gen, device=dev) * 0.1
        for normalize in (True, False):
            kw = dict(n_valid=n_valid, normalize=normalize)
            va, al, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                                  save_h=True, **kw)
            rv, ra, rh = ar.attention_resident_fwd_reference(
                store, rows, qh, wv, ws, save_h=True, **kw)
            torch.cuda.synchronize()
            check(tuple(va.shape) == (Bt, G * C) and tuple(al.shape) ==
                  (Bt, Np, G), f"K4 G={G} shapes {va.shape}, {al.shape}")
            # Each glimpse's v_att against its own largest value.
            d3 = (va - rv).abs().reshape(Bt, G, C).amax(dim=(0, 2))
            m3 = rv.abs().reshape(Bt, G, C).amax(dim=(0, 2))
            v_share = (d3 / (TOL_VATT_REL * m3)).max().item()
            ev = (va - rv).abs().max().item()
            ea = (al - ra).abs().max().item()
            eh = (h.float() - rh.float()).abs().max().item()
            rh_err = rel_err(h.float(), rh.float())
            print(f"K4 attention_resident_fwd G={G} normalize={normalize}: "
                  f"v_att {ev:.3e} (worst glimpse at {v_share:.3f} of 2^-10 "
                  f"* its max|v_att_g|), alpha {ea:.3e} (tol {TOL_ALPHA}), "
                  f"h {rh_err:.3e} of max|h| (tol {TOL_K4_H_REL:.3e})")
            check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
                  f"K4 G={G} output not finite")
            check(v_share <= 1.0, f"K4 G={G} normalize={normalize} v_att "
                  f"at {v_share} of its limit")
            check(ea <= TOL_ALPHA, f"K4 G={G} normalize={normalize} alpha "
                  f"err {ea}")
            check(rh_err <= TOL_K4_H_REL, f"K4 G={G} normalize={normalize} "
                  f"h err {rh_err}")
            check(al[:, n_valid:].abs().max().item() == 0.0,
                  f"K4 G={G} gave padded cells weight")
            checks4.append({"glimpses": G, "normalize": normalize,
                            "v_att_err": ev, "v_att_share_of_limit": v_share,
                            "alpha_err": ea, "alpha_tol": TOL_ALPHA,
                            "h_err": eh, "h_rel_err": rh_err,
                            "h_rel_tol": TOL_K4_H_REL})
            got = ar.attention_resident_bwd(store, rows, rh, ws, ra, g, sga,
                                            **kw)
            want = ar.attention_resident_bwd_reference(store, rows, rh, ws,
                                                       ra, g, sga, **kw)
            torch.cuda.synchronize()
            check(tuple(got[2].shape) == (H, G), f"K5 G={G} dws shape")
            for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
                if name == "dws":  # each glimpse's column on its own
                    rel = ((a - b).abs().amax(0) / b.abs().amax(0).clamp_min(
                        1e-30)).max().item()
                    tol = TOL_K5_REL
                else:
                    rel, tol = rel_err(a, b), G * TOL_K5_REL
                e = (a - b).abs().max().item()
                print(f"K5 attention_resident_bwd G={G} normalize="
                      f"{normalize} {name}: max abs err {e:.3e}, {rel:.3e} "
                      f"of max|{name}| (tol {tol:.3e})")
                check(bool(torch.isfinite(a).all()), f"K5 G={G} {name} not "
                      "finite")
                check(rel <= tol, f"K5 G={G} normalize={normalize} {name} "
                      f"relative err {rel} > {tol}")
                checks5.append({"glimpses": G, "normalize": normalize,
                                "output": name, "max_abs_err": e,
                                "rel_err": rel, "rel_tol": tol})
        if G == 2:  # the glimpses2 path's count, kept for the times
            keep.update(ws=ws, h=rh, alpha=ra, g=g, sga=sga)
        else:  # kept for the rows launch's time at G=8
            keep["g8"] = {"ws": ws, "h": rh, "alpha": ra, "g": g, "sga": sga}
    return {**keep, "checks4": checks4, "checks5": checks5,
            "err4": max(max(c["v_att_err"], c["alpha_err"], c["h_err"])
                        for c in checks4),
            "err5": max(c["max_abs_err"] for c in checks5)}


def int8_codes(store):
    """The int8 codes of ``store`` normalized per cell with one global
    scale, as ``prenormalize_store(quantize="int8")`` makes them (here on
    the card): (codes, scale, the bf16 store of the same normalized
    grid)."""
    import torch

    f = store.float()
    f = f * (1.0 / torch.sqrt((f * f).sum(-1, keepdim=True) + 1e-12))
    scale = (f.abs().max().item() or 1.0) / 127.0
    codes = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return codes, scale, f.to(store.dtype)


def phase_resident_int8(report: dict, dev, gen, k45: dict) -> dict:
    """K4 and K5 on int8 rows at G in INT8_GLIMPSES against their plain
    versions on the same codes (normalize off: an int8 store is
    prenormalized), under the bf16 rows' limits; then the op on the int8
    store with its scale against the op on the bf16 store of the same
    normalized grid."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar

    rows, qh, n_valid = k45["rows"], k45["qh"], k45["n_valid"]
    codes, scale, normed = int8_codes(k45["store"])
    # The op hands the kernels W_v with the store's scale folded in
    # (bf16(W_v * scale)), so z has the normalized store's size.
    wv = (k45["wv"].float() * scale).to(torch.bfloat16)
    Bt, Np = rows.shape[0], codes.shape[1]
    kw = dict(n_valid=n_valid, normalize=False)
    checks4, checks5, keep = [], [], {}
    for G in INT8_GLIMPSES:
        ws = (torch.randn(H, G, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16).float()
        if G == 1:
            ws = ws[:, 0].contiguous()
        g = torch.randn(Bt, G * C, generator=gen, device=dev) * 0.01
        sga = torch.randn(Bt, Np, G, generator=gen, device=dev) * 0.1
        if G == 1:
            sga = sga[:, :, 0].contiguous()
        va, al, h = ar.attention_resident_fwd(codes, rows, qh, wv, ws,
                                              save_h=True, **kw)
        rv, ra, rh = ar.attention_resident_fwd_reference(
            codes, rows, qh, wv, ws, save_h=True, **kw)
        torch.cuda.synchronize()
        d3 = (va - rv).abs().reshape(Bt, G, C).amax(dim=(0, 2))
        m3 = rv.abs().reshape(Bt, G, C).amax(dim=(0, 2))
        v_share = (d3 / (TOL_VATT_REL * m3)).max().item()
        ev = (va - rv).abs().max().item()
        ea = (al - ra).abs().max().item()
        eh = (h.float() - rh.float()).abs().max().item()
        rh_err = rel_err(h.float(), rh.float())
        print(f"K4[int8] attention_resident_fwd G={G}: v_att {ev:.3e} (worst "
              f"glimpse at {v_share:.3f} of 2^-10 * its max|v_att_g|), alpha "
              f"{ea:.3e} (tol {TOL_ALPHA}), h {rh_err:.3e} of max|h| (tol "
              f"{TOL_K4_H_REL:.3e})")
        check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
              f"K4[int8] G={G} output not finite")
        check(v_share <= 1.0, f"K4[int8] G={G} v_att at {v_share} of its "
              "limit")
        check(ea <= TOL_ALPHA, f"K4[int8] G={G} alpha err {ea}")
        check(rh_err <= TOL_K4_H_REL, f"K4[int8] G={G} h err {rh_err}")
        check(al[:, n_valid:].abs().max().item() == 0.0,
              f"K4[int8] G={G} gave padded cells weight")
        checks4.append({"glimpses": G, "v_att_err": ev,
                        "v_att_share_of_limit": v_share, "alpha_err": ea,
                        "alpha_tol": TOL_ALPHA, "h_err": eh,
                        "h_rel_err": rh_err, "h_rel_tol": TOL_K4_H_REL})
        got = ar.attention_resident_bwd(codes, rows, rh, ws, ra, g, sga, **kw)
        want = ar.attention_resident_bwd_reference(codes, rows, rh, ws, ra, g,
                                                   sga, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
            if name == "dws":  # each glimpse's column on its own
                a2, b2 = a.reshape(H, G), b.reshape(H, G)
                rel = ((a2 - b2).abs().amax(0) / b2.abs().amax(0).clamp_min(
                    1e-30)).max().item()
                tol = TOL_K5_REL
            else:
                rel, tol = rel_err(a, b), G * TOL_K5_REL
            e = (a - b).abs().max().item()
            print(f"K5[int8] attention_resident_bwd G={G} {name}: max abs "
                  f"err {e:.3e}, {rel:.3e} of max|{name}| (tol {tol:.3e})")
            check(bool(torch.isfinite(a).all()), f"K5[int8] G={G} {name} not "
                  "finite")
            check(rel <= tol, f"K5[int8] G={G} {name} relative err {rel} > "
                  f"{tol}")
            checks5.append({"glimpses": G, "output": name, "max_abs_err": e,
                            "rel_err": rel, "rel_tol": tol})
        if G == 1:  # the int8 training path's count, kept for the times
            keep = {"ws": ws, "h": rh, "alpha": ra, "g": g, "sga": sga}
    # The op on the codes with their scale against the op on the bf16
    # store of the same normalized grid, from the same parameters.
    wvf = k45["wv"].float()
    ws1 = keep["ws"]
    with torch.no_grad():
        va_q, _ = ar.spatial_attention_resident(
            codes, rows, qh.to(torch.bfloat16), wvf, ws1, n_valid=n_valid,
            store_scale=scale)
        va_f, _ = ar.spatial_attention_resident(
            normed, rows, qh.to(torch.bfloat16), wvf, ws1, n_valid=n_valid)
    quant = (torch.linalg.vector_norm(va_q - va_f)
             / torch.linalg.vector_norm(va_f)).item()
    row_mb = {"int8": codes.numel() / 1e6, "bf16": normed.numel() * 2 / 1e6}
    print(f"int8 store (scale {scale:.6g}): v_att against the bf16 store of "
          f"the same grid, relative error {quant:.4%} (bound "
          f"{INT8_VATT_REL:.0%}); store {row_mb['int8']:.1f} MB against "
          f"{row_mb['bf16']:.1f} MB in bf16")
    check(quant <= INT8_VATT_REL, f"int8 v_att quantization error {quant}")
    return {**keep, "codes": codes, "scale": scale, "wv": wv,
            "checks4": checks4,
            "checks5": checks5, "vatt_quant_rel_err": quant,
            "store_mb": row_mb,
            "err4": max(max(c["v_att_err"], c["alpha_err"], c["h_err"])
                        for c in checks4),
            "err5": max(c["max_abs_err"] for c in checks5)}


def k8_allowance(v, qh, wv, ws, ds, r, normalize: bool) -> tuple:
    """What ReLU flips may move K8's outputs against its plain version, per
    entry. Both recompute z = (v . W_v) r + qh with f32 sums of the same
    exact bf16 products in another order, which differ by less than 2^-12
    of the sum of the terms' magnitudes (C u <= 2^-13 for each order, at
    C=2048). A unit whose plain |z| is within that may take the other side
    of the ReLU in one version: it moves dqh_bk by at most |ds_n ws_k| and
    dW_v[:, k] by |v_n| |ds_n ws_k| r_n, and dws not at all (relu(z) is
    ~0 there). Returns (dqh allowance [B, H], dW_v allowance [C, H],
    number of such units)."""
    import torch

    vf = v.float()
    z = vf @ wv.float()
    mag = vf.abs() @ wv.float().abs()
    if normalize:
        z, mag = z * r[:, :, None], mag * r[:, :, None]
    z = z + qh[:, None, :]
    unsure = (z.abs() <= 2.0 ** -12 * (mag + qh.abs()[:, None, :])).float()
    del z, mag
    flip = unsure * (ds[:, :, None] * ws).abs()
    rr = r if normalize else torch.ones_like(r)
    return (flip.sum(1),
            torch.einsum("bnc,bnh->ch", vf.abs(), flip * rr[:, :, None]),
            int(unsure.sum().item()))


def phase_attention_bwd(report: dict, dev, gen) -> dict:
    """K2's checks (``k2_checks``) at the gathered training shape; K8
    against its plain version there, fed the same ds and K2's r; then the
    op's parameter gradients under K8 against those under the explicit
    backward (bwd_kernel=False)."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention

    Bt = B_TRAIN
    scale = torch.exp2(torch.rand(Bt, N, 1, generator=gen, device=dev) * 4
                       - 2)
    v = (torch.randn(Bt, N, C, generator=gen, device=dev).relu_() * scale
         ).to(torch.bfloat16)
    del scale
    qh = torch.randn(Bt, H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (C + H)) ** 0.5
    wv = ((torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    k2 = k2_checks(v, qh, wv, ws)  # K2 at the training batch, which K8 reads
    checks, err, keep = [], 0.0, {}
    for normalize in (True, False):
        va, al, r = attention.attention_fwd(v, qh, wv, ws,
                                            normalize=normalize)
        ds = (torch.randn(Bt, N, generator=gen, device=dev) * al
              ).contiguous()
        got = attention.attention_bwd(v, qh, wv, ws, ds, r, normalize)
        want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r,
                                                 normalize)
        torch.cuda.synchronize()
        a_dqh, a_dwv, unsure = k8_allowance(v, qh, wv, ws, ds, r, normalize)
        for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                     (a_dqh, a_dwv, 0.0)):
            e, rel = (a - b).abs().max().item(), rel_err(a, b)
            limit = TOL_K8_REL * b.abs().max().item() + allow
            worst = ((a - b).abs() / limit).max().item()
            print(f"K8 attention_bwd normalize={normalize} {name}: max abs "
                  f"err {e:.3e} ({rel:.3e} of max|{name}|); worst entry at "
                  f"{worst:.3f} of its limit (2^-9 of max|{name}| + what "
                  f"{unsure} units near z=0 can move it)")
            check(bool(torch.isfinite(a).all()), f"K8 {name} not finite")
            check(worst <= 1.0, f"K8 normalize={normalize} {name}: an "
                  f"entry at {worst} of its limit")
            checks.append({"normalize": normalize, "output": name,
                           "max_abs_err": e, "rel_err": rel,
                           "rel_tol": TOL_K8_REL, "units_near_zero": unsure,
                           "worst_share_of_limit": worst})
            err = max(err, e)
        if normalize:  # the main path's mode, kept for the times
            keep = {"v_att": va, "alpha": al, "r": r, "ds": ds}
    # The op's gradients, K8 against the explicit backward, under a loss
    # that drives v_att and alpha along random directions.
    wa = torch.randn(Bt, C, generator=gen, device=dev)
    wb = torch.randn(Bt, N, generator=gen, device=dev)
    grads = []
    for bwd_kernel in (True, False):
        ins = [t.clone().requires_grad_() for t in (qh, wv.float(), ws)]
        o, a2 = attention.spatial_attention(v, *ins, normalize=True,
                                            bwd_kernel=bwd_kernel,
                                            feature_grad=False)
        ((o * wa).sum() + (a2 * wb).sum()).backward()
        grads.append([t.grad for t in ins])
    cos = {name: torch.nn.functional.cosine_similarity(
        a.flatten(), b.flatten(), 0).item()
        for name, a, b in zip(("dqh", "dwv", "dws"), *grads)}
    print(f"gathered op grads, K8 vs the explicit backward: cosines {cos} "
          f"(bound {GRAD_COS})")
    check(min(cos.values()) >= GRAD_COS, f"op grads K8 vs explicit {cos}")
    g = (wa * 0.01).contiguous()
    ga = (wb * 0.01).contiguous()
    return {"v": v, "qh": qh, "wv": wv, "ws": ws, **keep, "g": g, "ga": ga,
            "checks": checks, "err": err, "op_grad_cos": cos,
            "k2_checks": k2}


def phase_bigru(report: dict, dev, gen) -> dict:
    """K6 and K7 against their plain versions at the stage-1 shape, and
    against K1 and K3 run once per direction on the same inputs: the same
    persistent kernels with a direction axis, so the same bits."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    Bt = B_TRAIN
    lens = torch.randint(1, T + 1, (Bt,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[1] = T, 1  # the longest and the shortest phrase
    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    gx, uh, bhn, ghT = [], [], [], []
    for _ in range(2):  # forward chain, then backward chain
        gx.append(torch.randn(T, Bt, 3 * H, generator=gen, device=dev) * 0.5)
        uh.append(((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1)
                   * lim).to(torch.bfloat16))
        bhn.append(torch.randn(H, generator=gen, device=dev) * 0.1)
        ghT.append(torch.randn(Bt, H, generator=gen, device=dev) * 0.05)
    args = (gx[0], gx[1], lens, uh[0], uh[1], bhn[0], bhn[1])
    got = gru.bigru_fwd(*args)
    want = gru.bigru_reference(*args)
    (hTf, hsf), (hTb, hsb) = (gru.gru_fwd(gx[0], lens, uh[0], bhn[0]),
                              gru.gru_fwd(gx[1], lens, uh[1], bhn[1],
                                          reverse=True))
    torch.cuda.synchronize()
    names6 = ("hTf", "hTb", "hseqf", "hseqb")
    err6 = max((a - b).abs().max().item() for a, b in zip(got, want))
    diff6 = max((a - b).abs().max().item()
                for a, b in zip(got, (hTf, hTb, hsf, hsb)))
    print(f"K6 bigru_fwd B={Bt}: max abs err {err6:.3e} (tol {TOL_GRU}) "
          f"over {names6}; against two K1 calls {diff6:.3e} (must be 0)")
    check(all(bool(torch.isfinite(a).all()) for a in got),
          "K6 output not finite")
    check(err6 <= TOL_GRU, f"K6 err {err6} > {TOL_GRU}")
    check(diff6 == 0.0, f"K6 differs from two K1 calls by {diff6}")
    # K6's persistent launch: the grid and launches that the C side derives
    # from the plan's rows and its own instance's occupancy, against the
    # plan's with two directions on the same blocks per SM.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch6 = gru.bigru_fwd_launch_config(Bt, H, dev)
    plan6 = kernels.gru_fwd_plan(Bt, H, sms, launch6["per_sm_by_rows"], 2)
    print(f"K6 persistent launch at B={Bt}, H={H}: 16 units x "
          f"{launch6['rows']} rows a block, grid "
          + " x ".join(map(str, launch6["grid"])) + " blocks of 256 threads "
          f"(j-tiles x rows x directions), {launch6['launches']} launch(es) "
          f"a call over {launch6['b_tiles']} b-tiles, "
          f"{launch6['blocks_per_sm']} resident per SM, "
          f"{launch6['smem_bytes']} B of dynamic shared memory")
    check(all(launch6[k] == plan6[k] for k in ("rows", "grid", "launches")),
          f"K6 launch {launch6} differs from kernels.gru_fwd_plan {plan6}")

    # K7 and its plain version, both fed K6's state sequences.
    hseqf, hseqb = got[2], got[3]
    bargs = (gx[0], gx[1], hseqf, hseqb, lens, uh[0], uh[1], bhn[0], bhn[1],
             ghT[0], ghT[1])
    got7 = gru.bigru_bwd(*bargs)
    want7 = gru.bigru_bwd_reference(*bargs)
    one_f = gru.gru_bwd(gx[0], hseqf, lens, uh[0], bhn[0], ghT[0])
    one_b = gru.gru_bwd(gx[1], hseqb, lens, uh[1], bhn[1], ghT[1],
                        reverse=True)
    torch.cuda.synchronize()
    ones = (one_f[0], one_b[0], one_f[1], one_b[1], one_f[2], one_b[2])
    checks, err7, diff7 = [], 0.0, 0.0
    for name, a, b, c in zip(("dgxf", "dgxb", "duhf", "duhb", "dbhnf",
                              "dbhnb"), got7, want7, ones):
        e, rel = (a - b).abs().max().item(), rel_err(a, b)
        d = (a - c).abs().max().item()
        print(f"K7 bigru_bwd {name}: max abs err {e:.3e}, {rel:.3e} of "
              f"max|{name}| (tol {TOL_K3_REL:.3e}); against K3 {d:.3e} "
              "(must be 0)")
        check(bool(torch.isfinite(a).all()), f"K7 {name} not finite")
        check(rel <= TOL_K3_REL, f"K7 {name} relative err {rel} > "
              f"{TOL_K3_REL}")
        check(d == 0.0, f"K7 {name} differs from K3 by {d}")
        checks.append({"output": name, "max_abs_err": e, "rel_err": rel,
                       "rel_tol": TOL_K3_REL, "diff_vs_k3": d})
        err7, diff7 = max(err7, e), max(diff7, d)
    launch = bptt_launch(gru.bigru_bwd_launch_config, Bt, dev, "K7")
    # What ptxas says of the persistent kernels in each build: every
    # instance picks its direction's arguments at run time.
    ptxas = {kernel: {name: ptxas_entry(report["ptxas"].get(name, ""),
                                        kernel) for name in names}
             for kernel, names in (("gru_seq_kernel", ("gru_fwd",
                                                       "bigru_fwd")),
                                   ("gru_bptt_kernel", ("gru_bwd",
                                                        "bigru_bwd")))}
    for kernel, by_name in ptxas.items():
        for name, lines in by_name.items():
            print(f"ptxas on {kernel} in {name}.cu: " + " | ".join(lines))
    return {"args": args, "bargs": bargs, "err6": err6, "diff6": diff6,
            "err7": err7, "diff7": diff7, "checks7": checks,
            "launch6": launch6, "launch7": launch,
            "ptxas_seq": ptxas["gru_seq_kernel"],
            "ptxas_bptt": ptxas["gru_bptt_kernel"]}


def write_run(train_dir: str) -> None:
    """A synthetic full-width run: config.json + a seeded random init."""
    import torch
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    cfg = Config().replace_flat({"data.synthetic": True, **MODEL_OVERRIDES})
    with open(os.path.join(train_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    gen = torch.Generator().manual_seed(123)
    save_params(os.path.join(train_dir, "params_final.pt"),
                build_model(cfg, generator=gen).module.state_dict())


def phase_serving(report: dict, dev) -> dict:
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.serving import Predictor

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_run(tmp)
        pred = Predictor(tmp, batch_size=B)  # default device: CUDA
    check(pred.device.type == dev.type, f"Predictor picked {pred.device}")
    vocab = len(pred.word_vocab) - 4
    questions = [" ".join(f"w{w}" for w in rng.integers(0, vocab, n))
                 for n in rng.integers(1, T + 1, B)]
    feats = np.maximum(rng.standard_normal((B, N, C), np.float32), 0)
    store = np.maximum(rng.standard_normal((STORE_ROWS, GRID, GRID, C),
                                           np.float32), 0).astype(np.float16)
    pred.stage_store(store)
    idx = rng.integers(0, STORE_ROWS, B)
    short = 5 * B // 8  # a request shorter than the batch: padded, trimmed

    # --- the main path: counts from 0 -----------------------------------
    reset_counts()
    ans_host = pred.answer(feats, questions)
    ans_short = pred.answer(feats[:short], questions[:short])
    ans_idx = pred.answer_indexed(idx, questions)
    launches = read_counts()
    # Three forwards: K1 one persistent launch each, K2 two; the training
    # kernels do not run.
    check_launches(launches, {"gru_fwd": 3, "attention_fwd": 3 * 2},
                   "serving")
    check(len(ans_host) == B and len(ans_short) == short
          and len(ans_idx) == B, "wrong number of answers")
    check(ans_short == ans_host[:short], "padding changed the answers")
    direct = pred.answer(store.reshape(STORE_ROWS, N, C)[idx], questions)
    check(ans_idx == direct, "answer_indexed differs from answer()")
    try:
        pred.answer_indexed(np.array([0, STORE_ROWS]), questions[:2])
        raise PhaseError("answer_indexed accepted an out-of-range row")
    except IndexError:
        pass

    # --- logits against the plain path on the card -----------------------
    v = torch.from_numpy(feats).to(torch.bfloat16).to(dev)
    q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
    with torch.inference_mode():
        out = pred.model(v, q)
        with plain_kernels():
            ref = pred.model(v, q)
    lk, lr = out["logits"], ref["logits"]
    check(tuple(lk.shape) == (B, pred.cfg.data.num_answers),
          f"logits shape {tuple(lk.shape)}")
    check(bool(torch.isfinite(lk).all()), "logits not finite")
    err = (lk - lr).abs().max().item()
    top2 = lr.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS
    agree = (lk.argmax(-1) == lr.argmax(-1)) | ~decided
    print(f"logits vs plain path: max abs err {err:.3e} (tol {TOL_LOGITS}); "
          f"argmax agrees on {int(decided.sum())} decided rows: "
          f"{bool(agree.all())}")
    check(err <= TOL_LOGITS, f"logits err {err} > {TOL_LOGITS}")
    check(bool(agree.all()), "argmax differs where the margin is decided")
    preds = [pred.answer_vocab.tokens[int(i)] for i in lr.argmax(-1)]
    check(all(a == p for a, p, d in zip(ans_host, preds, decided.tolist())
              if d), "Predictor answers differ from the plain path")

    # --- request latency -------------------------------------------------
    def p50(fn) -> float:
        for _ in range(3):
            fn()
        ts = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            fn()  # ends in a device->host copy of the predictions
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    report["predictor_p50_ms"] = {
        "answer_host_features": p50(lambda: pred.answer(feats, questions)),
        "answer_indexed": p50(lambda: pred.answer_indexed(idx, questions)),
    }
    print(f"Predictor p50 at batch {B}: {report['predictor_p50_ms']}")
    report["logits_max_abs_err"] = err
    report["profile"] = {
        "answer_host_features": profile_calls(
            lambda: pred.answer(feats, questions)),
        "answer_indexed": profile_calls(
            lambda: pred.answer_indexed(idx, questions)),
    }
    return launches


def first_step_grads(spec, state, batch, dev) -> tuple:
    """The loss and every parameter's gradient (None where the loss does
    not reach it) of ``spec``'s model on ``batch`` under one fixed
    dropout mask."""
    import torch

    names = list(state.params)
    gen = torch.Generator(device=dev).manual_seed(7)
    outs = spec.module(*spec.inputs(batch), train=True, generator=gen)
    loss, _ = spec.loss(outs, batch)
    # A frozen backbone run under no_grad gets no gradient; the callers
    # check the others.
    grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                allow_unused=True)
    return loss.item(), dict(zip(names, grads))


def check_first_step(spec, state, batch, dev, what: str,
                     frozen=lambda name: False, loss_tol: float = TOL_LOSS,
                     grad_cos: float = GRAD_COS,
                     grad_cos_by_param: Optional[dict] = None) -> dict:
    """The first training step of ``spec``'s model on ``batch`` with the
    kernels and with their plain versions on the card, under one dropout
    mask: the loss to ``loss_tol``, each gradient to cosine ``grad_cos``
    (or the parameter's own bound in ``grad_cos_by_param``; a scalar to
    TOL_SCALAR_REL relative). Only a parameter that ``frozen`` names may
    go without a gradient, and then on both paths."""
    import torch

    names = list(state.params)
    lk, gk = first_step_grads(spec, state, batch, dev)
    with plain_kernels():
        lp, gp = first_step_grads(spec, state, batch, dev)
    bounds = grad_cos_by_param or {}
    grad_checks = {}
    for k in names:
        if gk[k] is None or gp[k] is None:
            check(frozen(k), f"{what}: the loss does not reach the live "
                  f"parameter {k}")
            check(gk[k] is None and gp[k] is None,
                  f"{what}: grad {k} reaches the loss on one path only")
            continue
        a, b = gk[k].flatten().float(), gp[k].flatten().float()
        if a.numel() == 1:
            rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).item()
            grad_checks[k] = {"rel_err": rel}
            check(rel <= TOL_SCALAR_REL, f"{what}: grad {k} rel err {rel}")
        else:
            cos = torch.nn.functional.cosine_similarity(a, b, 0).item()
            bound_k = bounds.get(k, grad_cos)
            grad_checks[k] = {"cos": cos}
            if bound_k != grad_cos:
                grad_checks[k]["bound"] = bound_k
            check(cos >= bound_k, f"{what}: grad {k} cosine {cos} < "
                  f"{bound_k}")
    worst = min(v.get("cos", 1.0) for v in grad_checks.values())
    frozen = len(names) - len(grad_checks)
    own = {k: v["bound"] for k, v in grad_checks.items() if "bound" in v}
    print(f"{what} first step: loss {lk:.7f} (kernels) vs {lp:.7f} "
          f"(plain), tol {loss_tol}; lowest gradient cosine {worst:.7f} "
          f"(bound {grad_cos}"
          + (f"; own bounds {own}" if own else "") + ")"
          + (f"; {frozen} frozen parameters get no gradient" if frozen
             else ""))
    check(abs(lk - lp) <= loss_tol, f"{what}: loss {lk} vs plain {lp}")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_tol": loss_tol,
            "grad_cos_bound": grad_cos, "grads": grad_checks,
            "params_without_grad": frozen}


def read_steps(train_dir: str, steps: int, what: str, unit: str,
               warmup: Optional[int] = None, first: int = 0,
               batch: int = B_TRAIN) -> dict:
    """Losses (all finite) and step times of a run logged every step: each
    record's rate spans the steps since the last one (one, or two at the
    final drain), on the host clock between waits for the device to
    finish each step. The median over the steps after ``warmup`` (counted
    from ``first``, the step the run started from); ``batch`` rows a
    step."""
    import numpy as np

    warmup = WARMUP_STEPS if warmup is None else warmup
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [r for r in map(json.loads, fh)
                if "train/loss" in r and r["step"] > first]
    losses = [r["train/loss"] for r in recs]
    check(len(recs) == steps and all(np.isfinite(losses)),
          f"{what}: {len(recs)} records, losses {losses}")
    step_ms = [1e3 / r["train/steps_per_sec"] for r in recs
               if r["step"] > first + warmup and "train/steps_per_sec" in r]
    check(len(step_ms) >= (steps - warmup) * 4 // 5,
          f"{what}: only {len(step_ms)} timed steps")
    med = statistics.median(step_ms)
    print(f"{what}: median step {med:.3f} ms over {len(step_ms)} steps = "
          f"{batch * 1e3 / med:.1f} {unit}/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return {"losses": losses, "timed_steps": len(step_ms),
            "step_ms_median": med, f"{unit}_per_sec": batch * 1e3 / med,
            "step_ms_all": step_ms}


def stage2_config(train_dir: str, steps: int, **over):
    from vqa_transfer_externaldata_torch.config import Config

    return Config().replace_flat({
        "data.synthetic": True, "data.synthetic_layout": "joined",
        "data.synthetic_size": TRAIN_QUESTIONS,
        "train.device_data_cache": True, "train.batch_size": B_TRAIN,
        "train.max_steps": steps, "train.log_every": 1,
        "train.train_dir": train_dir, **over, **MODEL_OVERRIDES})


def phase_training(report: dict, dev) -> dict:
    """Stage-2 training at full width through Trainer.fit_resident on the
    gather-free store, with the lagged in-loop evaluation of a 1024-question
    val split every EVAL_EVERY steps and periodic checkpoints; then the
    evaluators and cli.eval on the run."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        cfg = stage2_config(tmp, steps, **{
            "train.eval_every": EVAL_EVERY,
            "train.checkpoint_every": EVAL_EVERY,
            "train.keep_checkpoints": KEEP_CHECKPOINTS})
        t0 = time.perf_counter()
        ds = load_dataset(cfg, "train")
        val_cfg = cfg.replace_flat({"data.synthetic_size": VAL_QUESTIONS})
        val = load_dataset(val_cfg, "val")
        grid = ds.store.grid
        check(grid.shape == (TRAIN_IMAGES, N, C) and ds.size ==
              TRAIN_QUESTIONS and val.size == VAL_QUESTIONS,
              f"corpus {grid.shape}, {ds.size} questions, val {val.size}")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        model = spec.module
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        check(trainer.device.type == dev.type, f"Trainer on {trainer.device}")
        state = trainer.init_state()
        out["setup_s"] = time.perf_counter() - t0

        # --- the first step against the plain path (same dropout mask) ---
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        out["store_gb"] = data["grid"].numel() * 2 / 1e9
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "stage 2")
        del data, make_batch, batch  # free this copy of the store

        # --- the main path: counts from 0 --------------------------------
        reset_counts()
        t0 = time.perf_counter()
        state = trainer.fit_resident(ds, state, eval_ds=val)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        launches = read_counts()
        # A step: K1 one persistent launch, K3 three (the persistent
        # step kernel, the dU_h GEMM, the db_hn sum), K4 two, K5 three. An
        # evaluation: K1 and K4 over each of the val split's batches.
        evals = steps // EVAL_EVERY
        eval_batches = evals * -(-VAL_QUESTIONS // B_TRAIN)
        check_launches(launches, {
            "gru_fwd": steps + eval_batches,
            "gru_bwd": 3 * steps,
            "attention_resident_fwd": 2 * (steps + eval_batches),
            "attention_resident_bwd": 3 * steps},
            f"stage-2 training over {steps} steps with {evals} evaluations")
        check(state.step == steps, f"trained {state.step} steps")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "stage-2 training", "questions"))
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            val_recs = [r for r in map(json.loads, fh) if "val/loss" in r]
        check([r["step"] for r in val_recs] ==
              list(range(EVAL_EVERY, steps + 1, EVAL_EVERY)) and
              all(np.isfinite(r["val/loss"]) for r in val_recs),
              f"in-loop evaluations: {val_recs}")
        print(f"in-loop evaluations (lagged): {val_recs}")
        out["val_records"] = val_recs
        kept = trainer.ckpt.all_steps()
        print(f"checkpoints kept: {kept} (every {EVAL_EVERY} steps, keep "
              f"{KEEP_CHECKPOINTS})")
        check(kept == [steps - EVAL_EVERY, steps],
              f"checkpoints kept {kept}")
        out["checkpoints_kept"] = kept

        # --- a profiler window of PROFILE_STEPS more steps ---------------
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)

        # --- evaluation: the evaluators and the eval CLI (which restores
        # the latest checkpoint: this state's) -----------------------------
        trainer.ckpt.save(state.step, state, force=True)
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
        out["evaluation"] = check_evaluation(trainer, state, val, tmp, dev)

        # --- serve the trained run ---------------------------------------
        save_params(os.path.join(tmp, PARAMS_FILE), model.state_dict())
        pred = Predictor(tmp, batch_size=64)
        check(pred.device.type == dev.type, f"Predictor picked {pred.device}")
        sel = np.arange(64)
        qs = [" ".join(pred.word_vocab.tokens[i] for i in row if i)
              for row in ds.arrays["q_ids"][sel]]
        pred.stage_store(grid)
        answers = pred.answer_indexed(ds.arrays["image_index"][sel], qs)
        check(len(answers) == 64 and all(a in pred.answer_vocab.tokens
                                         for a in answers),
              "the trained run's answers are not answer tokens")
        v = torch.from_numpy(np.asarray(grid[ds.arrays["image_index"][sel]],
                                        np.float32)).to(dev)
        q = torch.from_numpy(pred._encode_questions(qs)).to(dev)
        with torch.inference_mode():
            served = pred.model(v, q)["logits"]
            trained = model(v, q)["logits"]
        e = (served - trained).abs().max().item()
        print(f"served the trained run: {len(answers)} answers, logits of "
              f"the served model vs the trainer's {e:.3e}")
        check(bool(torch.isfinite(served).all()) and e == 0.0,
              f"served logits differ from the trained model's by {e}")
        trainer.close()
    return out


def check_evaluation(trainer, state, val, run_dir: Optional[str], dev,
                     streamed_kernels: Optional[dict] = None) -> dict:
    """On the trained run: the resident evaluator (K4) against the streamed
    evaluate() (K2 over host batches, or ``streamed_kernels`` a batch) on
    the same parameters, and, given ``run_dir``, cli.eval on the run
    directory against evaluate_split. The two evaluators' logits differ in
    their last bits (K4 reads the store normalized at upload, the gathered
    attention normalizes the grid itself), so predictions must agree
    wherever the top two logits are more than TOL_LOGITS apart, and the
    accuracies may differ by the share of rows where they are not."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.parallel.evaler import (
        evaluate_split, padded_batches)

    out = {}
    reset_counts()
    t0 = time.perf_counter()
    m_res, p_res = trainer.evaluate_resident(state, val)
    out["resident_s"] = time.perf_counter() - t0
    res_launches = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    m_str, p_str = trainer.evaluate(state,
                                    padded_batches(val, B_TRAIN)[0])
    out["streamed_s"] = time.perf_counter() - t0
    str_launches = read_counts()
    n_batches = -(-VAL_QUESTIONS // B_TRAIN)
    check_launches(res_launches, {"gru_fwd": n_batches,
                                  "attention_resident_fwd": 2 * n_batches},
                   "resident evaluation")
    per_batch = streamed_kernels or {"gru_fwd": 1, "attention_fwd": 2}
    check_launches(str_launches, {k: n * n_batches
                                  for k, n in per_batch.items()},
                   "streamed evaluation")
    p_str = p_str[:VAL_QUESTIONS]
    t0 = time.perf_counter()
    val.take(np.arange(B_TRAIN))  # one host batch: store rows to float32
    out["streamed_take_ms_per_batch"] = (time.perf_counter() - t0) * 1e3
    # Margins of the top two logits, from the resident path.
    data, make_batch, _ = trainer._prepare_resident(val)
    margins = []
    with torch.no_grad():
        for lo in range(0, VAL_QUESTIONS, B_TRAIN):
            idx = torch.arange(lo, min(lo + B_TRAIN, VAL_QUESTIONS),
                               device=dev)
            b = make_batch(idx)
            top2 = trainer.model(*trainer.spec.inputs(b))["logits"].topk(
                2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
    del data, make_batch
    margin = torch.cat(margins).numpy()
    differ = p_res != p_str
    undecided = int((margin <= TOL_LOGITS).sum())
    print(f"evaluators: resident {m_res} vs streamed {m_str}; "
          f"{int(differ.sum())} of {VAL_QUESTIONS} predictions differ, "
          f"{undecided} rows have top-2 logits within {TOL_LOGITS}")
    check(bool((margin[differ] <= TOL_LOGITS).all()),
          "the evaluators disagree on a decided row")
    check(abs(m_res["loss"] - m_str["loss"]) <= TOL_LOSS,
          f"eval loss {m_res['loss']} vs {m_str['loss']}")
    for k in ("accuracy", "vqa_accuracy"):
        check(abs(m_res[k] - m_str[k]) <= undecided / VAL_QUESTIONS + 1e-9,
              f"eval {k} {m_res[k]} vs {m_str[k]}")
    out.update(resident=m_res, streamed=m_str, preds_differ=int(
        differ.sum()), undecided_rows=undecided,
        resident_launches=res_launches, streamed_launches=str_launches)
    if run_dir is None:
        return out

    # --- cli.eval on the run directory ----------------------------------
    want, _ = evaluate_split(trainer, state, val)
    t0 = time.perf_counter()
    got = eval_cli.main(["--train.train_dir", run_dir,
                         "--data.synthetic_size", str(VAL_QUESTIONS)])
    out["cli_eval_s"] = time.perf_counter() - t0
    with open(os.path.join(run_dir, "results_val.json")) as fh:
        rows = json.load(fh)
    print(f"cli.eval: {got}; results_val.json holds {len(rows)} rows; "
          f"evaluate_split's vqa_accuracy {want['vqa_accuracy']}")
    check(len(rows) == VAL_QUESTIONS, f"results_val.json: {len(rows)} rows")
    check(got["vqa_accuracy"] == want["vqa_accuracy"],
          f"cli.eval vqa_accuracy {got['vqa_accuracy']} vs evaluate_split "
          f"{want['vqa_accuracy']}")
    out.update(cli_eval=got, evaluate_split=want, results_rows=len(rows))
    return out


def phase_gathered(report: dict, dev) -> dict:
    """Stage-2 training on the gathered resident path
    (``train.resident_fused_attention`` false): the store is kept as it is
    and each step gathers its [B, N, C] grid, so the attention runs K2
    forward and K8 backward. First step against the plain path, launch
    counts, step times, a profiler window; then the step with the explicit
    backward in place of K8 (bwd_kernel=False) and with K8 again."""
    import functools

    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models import vqa_attention
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.ops import attention, kernels
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gathered_") as tmp:
        cfg = stage2_config(tmp, steps,
                            **{"train.resident_fused_attention": False})
        ds = load_dataset(cfg, "train")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        check(not spec.module.store_prenormalized, "gathered store changed")
        state = trainer.init_state()
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        check(tuple(data["grid"].shape) == (TRAIN_IMAGES, N, C) and
              data["grid"].dtype == torch.bfloat16,
              f"gathered store {tuple(data['grid'].shape)}")
        out["store_gb"] = data["grid"].numel() * 2 / 1e9
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(tuple(batch["features"].shape) == (B_TRAIN, N, C),
              "gathered batch shape")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "stage 2 (gathered)")
        del data, make_batch, batch

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        # A step: K1 and K3 as on the main path, K2 two launches, K8 its
        # four (kernels.ATTENTION_BWD_LAUNCHES).
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_fwd": 2 * steps,
            "attention_bwd": kernels.ATTENTION_BWD_LAUNCHES * steps},
            f"gathered stage-2 training over {steps} steps")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "gathered stage-2 training",
                                "questions"))
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)

        # --- the backward A/B: explicit math, then K8 --------------------
        ab = {}
        for tag, bwd_kernel in (("explicit", False), ("k8", True)):
            first = state.step
            saved = vqa_attention.spatial_attention
            vqa_attention.spatial_attention = functools.partial(
                attention.spatial_attention, bwd_kernel=bwd_kernel)
            try:
                before = attention.attention_bwd.launches
                state = trainer.fit_resident(ds, state,
                                             max_steps=first + AB_STEPS)
                torch.cuda.synchronize()
                k8 = attention.attention_bwd.launches - before
            finally:
                vqa_attention.spatial_attention = saved
            check(k8 == (kernels.ATTENTION_BWD_LAUNCHES * AB_STEPS
                         if bwd_kernel else 0),
                  f"A/B {tag}: {k8} K8 launches")
            ab[tag] = read_steps(tmp, AB_STEPS, f"gathered step, {tag} "
                                 "backward", "questions", warmup=2,
                                 first=first)
        out["ab"] = ab
        trainer.close()
    return out


def phase_streamed(report: dict, dev) -> dict:
    """Stage-2 training through cli.train on streamed host batches
    (``train.device_data_cache`` false, the flat layout: a float32 grid per
    question): each step's [B, N, C] batch is cast to bf16 into a pinned
    buffer and copied to the card; the attention runs K2 and K8."""
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.ops import kernels

    steps = STREAM_STEPS
    flags = {"data.synthetic": True, "data.synthetic_layout": "flat",
             "data.synthetic_size": STREAM_QUESTIONS,
             "train.device_data_cache": False, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             **MODEL_OVERRIDES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_streamed_") as tmp:
        argv = ["--train.train_dir", tmp] + cli_argv(flags)
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        train_dir = train_cli.main(argv)  # default device: CUDA
        torch.cuda.synchronize()
        out = {"cli_s": time.perf_counter() - t0}
        launches = read_counts()
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_fwd": 2 * steps,
            "attention_bwd": kernels.ATTENTION_BWD_LAUNCHES * steps},
            f"streamed stage-2 training over {steps} steps")
        out["launches"] = launches
        out.update(read_steps(train_dir, steps, "streamed stage-2 training",
                              "questions", warmup=2))
        out["batch_mb_to_device"] = B_TRAIN * N * C * 2 / 1e6
    out["host_breakdown_ms"] = streamed_breakdown(flags, dev)
    return out


def streamed_breakdown(flags: dict, dev) -> dict:
    """Where a streamed step's host time goes, one batch at a time (medians
    of 3 after one warm-up batch): the dataset's gather of the batch rows
    (numpy, a fresh float32 array), the bf16 cast into the pinned staging
    buffer with the copy to the card enqueued, and the wait for that copy
    to finish."""
    import torch
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.parallel.trainer import _Uploader

    ds = load_dataset(Config().replace_flat(flags), "train")
    upload = _Uploader(dev, torch.bfloat16)
    batches = ds.index_batches(B_TRAIN, seed=1)
    parts = {"take": [], "cast_and_enqueue": [], "copy_wait": []}
    for i in range(4):
        idx = next(batches)
        t0 = time.perf_counter()
        batch = ds.take(idx)
        t1 = time.perf_counter()
        upload(batch)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:
            for k, a, b in (("take", t0, t1), ("cast_and_enqueue", t1, t2),
                            ("copy_wait", t2, t3)):
                parts[k].append((b - a) * 1e3)
    out = {k: statistics.median(v) for k, v in parts.items()}
    print(f"streamed batch on the host, ms: {out}")
    return out


def stage1_config(train_dir: str, steps: int, dense: bool = False):
    from vqa_transfer_externaldata_torch.config import Config

    return Config().replace_flat({
        **STAGE1_MODEL, "model.dense_candidate_loss": dense,
        "data.synthetic": True, "data.synthetic_size": STAGE1_REGIONS,
        "train.device_data_cache": True, "train.batch_size": B_TRAIN,
        "train.max_steps": steps, "train.log_every": 1,
        "train.train_dir": train_dir, **MODEL_OVERRIDES})


def phase_stage1(report: dict, dev, root: str) -> dict:
    """Stage-1 training of vlmap_description (bidirectional encoder, K6/K7)
    at full width through Trainer.fit_resident, then with the dense
    candidate loss. The first run's parameters are saved under ``root`` for
    the transfer phase."""
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    for tag, dense, n_steps in (("gathered", False, steps),
                                ("dense", True, DENSE_STEPS)):
        run_dir = os.path.join(root, tag)
        cfg = stage1_config(run_dir, n_steps, dense)
        t0 = time.perf_counter()
        ds = load_dataset(cfg, "train", stage="vlmap_desc")
        out[f"data_s_{tag}"] = time.perf_counter() - t0
        check(ds.size == STAGE1_REGIONS and
              ds.arrays["candidates"].shape[1] == cfg.model.num_candidates,
              f"stage-1 corpus: {ds.size} regions")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=run_dir)  # default: CUDA
        check(trainer.device.type == dev.type, f"Trainer on {trainer.device}")
        state = trainer.init_state()
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        run = {"uploaded_gb": nbytes / 1e9, "first_step": check_first_step(
            spec, state, batch, dev, f"stage 1 ({tag})")}
        del data, make_batch, batch

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        run["fit_s"] = time.perf_counter() - t0
        launches = read_counts()
        # K6: one persistent launch for all timesteps of both chains; K7:
        # the persistent step kernel, the dU_h GEMM and the db_hn sum, both
        # chains each.
        check_launches(launches, {"bigru_fwd": n_steps,
                                  "bigru_bwd": 3 * n_steps},
                       f"stage-1 training ({tag}) over {n_steps} steps")
        check(state.step == n_steps, f"stage 1 ({tag}): {state.step} steps")
        run["launches"] = launches
        run.update(read_steps(run_dir, n_steps, f"stage-1 training ({tag})",
                              "regions", warmup=2 if dense else None))
        if not dense:
            state, run["profile"] = profile_fit(trainer, ds, state,
                                                PROFILE_STEPS)
            out["params_path"] = os.path.join(run_dir, PARAMS_FILE)
            save_params(out["params_path"], spec.module.state_dict())
        trainer.close()
        out[tag] = run
    return out


def phase_transfer(report: dict, dev, stage1_params: str) -> dict:
    """Stage 1's parameters through ``cli.train --train.pretrained_param_path``
    into full-width stage-2 training, the transferred tables frozen so that
    the run's final parameters show what arrived."""
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import synthetic_vocabs
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params
    from vqa_transfer_externaldata_torch.utils.vocab import tokenize

    steps = TRANSFER_STEPS
    flags = {"data.synthetic": True, "data.synthetic_layout": "joined",
             "data.synthetic_size": TRANSFER_QUESTIONS,
             "train.device_data_cache": True, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             "train.freeze_params": "word_emb,answer_embedding",
             "train.pretrained_param_path": stage1_params, **MODEL_OVERRIDES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_transfer_") as tmp:
        argv = ["--train.train_dir", tmp] + cli_argv(flags)
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        train_dir = train_cli.main(argv)  # default device: CUDA
        torch.cuda.synchronize()
        out = {"cli_s": time.perf_counter() - t0}
        launches = read_counts()
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_resident_fwd": 2 * steps,
            "attention_resident_bwd": 3 * steps},
            f"stage-2 training after the transfer over {steps} steps")
        out["launches"] = launches
        out.update(read_steps(train_dir, steps, "stage-2 training after the "
                              "transfer", "questions", warmup=2))
        s1 = load_params(stage1_params)
        s2 = load_params(os.path.join(train_dir, PARAMS_FILE))
    words, ans = s1["word_emb.embedding"], s2["answer_embedding"]
    check(torch.equal(s2["word_emb.embedding"], words),
          "the word table did not arrive bit for bit")
    cfg = Config().replace_flat(flags)
    wv, av = synthetic_vocabs(cfg)
    seeded = 0
    for a, answer in enumerate(av.tokens):
        ids = [wv.token_to_id[t] for t in tokenize(answer)
               if t in wv.token_to_id]
        if ids:
            row = words[ids].mean(dim=0)
            check(torch.equal(ans[a], row),
                  f"answer row {a} ({answer!r}) is not its words' mean")
            seeded += 1
    print(f"transfer: word table {tuple(words.shape)} arrived bit for bit; "
          f"{seeded} of {len(av)} answer rows equal their words' mean (the "
          f"rest are specials with no word)")
    check(seeded >= len(av) - 4, f"only {seeded} answer rows seeded")
    out.update(word_table_exact=True, answer_rows_seeded=seeded,
               answer_rows=len(av))
    return out


def phase_glimpses2(report: dict, dev) -> dict:
    """vqa_attention2 (two glimpses) at full width through fit_resident on
    the gather-free store: K4 and K5 at G=2. First step against the plain
    path, launch counts, step times; the resident evaluator against the
    gathered one; requests served through Predictor (the gathered
    spatial_attention_multi, as in the JAX package)."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_g2_") as tmp:
        cfg = stage2_config(tmp, steps, **{"model.model": "vqa_attention2"})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        model = spec.module
        check(model.glimpses == 2 and tuple(model.att_ws.shape) == (H, 2),
              f"vqa_attention2 att_ws {tuple(model.att_ws.shape)}")
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(isinstance(batch["features"], tuple), "vqa_attention2 did not "
              "take the gather-free path")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "vqa_attention2")
        del data, make_batch, batch

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        # A step: K1 and K3 as on the main path, K4 two launches and K5
        # three, each covering both glimpses.
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_resident_fwd": 2 * steps,
            "attention_resident_bwd": 3 * steps},
            f"vqa_attention2 training over {steps} steps")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "vqa_attention2 training",
                                "questions"))
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)
        # The gathered evaluator: K1, then spatial_attention_multi.
        out["evaluation"] = check_evaluation(
            trainer, state, val, None, dev, streamed_kernels={"gru_fwd": 1})

        # --- requests served through Predictor ---------------------------
        save_params(os.path.join(tmp, PARAMS_FILE), model.state_dict())
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
        pred = Predictor(tmp, batch_size=B)  # the serving batch
        sel = np.arange(B)
        qs = [" ".join(pred.word_vocab.tokens[i] for i in row if i)
              for row in val.arrays["q_ids"][sel]]
        feats = np.asarray(val.store.grid[val.arrays["image_index"][sel]],
                           np.float32).reshape(B, N, C)
        reset_counts()
        answers = pred.answer(feats, qs)
        check_launches(read_counts(), {"gru_fwd": 1}, "vqa_attention2 serving")
        v = torch.from_numpy(feats).to(dev)
        q = torch.from_numpy(pred._encode_questions(qs)).to(dev)
        with torch.inference_mode():
            served = pred.model(v, q)["logits"]
            trained = model(v, q)["logits"]
        e = (served - trained).abs().max().item()
        check(len(answers) == B and all(a in pred.answer_vocab.tokens
                                         for a in answers)
              and bool(torch.isfinite(served).all()) and e == 0.0,
              f"vqa_attention2 served: {len(answers)} answers, logits "
              f"{e} from the trainer's")
        print(f"vqa_attention2 served {len(answers)} answers; logits equal "
              "the trained model's")
        out["served_answers"] = len(answers)
        trainer.close()
    return out


def phase_training_int8(report: dict, dev) -> dict:
    """The main path with ``train.store_quantize int8``: stage-2 training at
    full width through fit_resident on the int8 store (K1, K3, and K4/K5 on
    int8 rows), with the lagged in-loop evaluation of the val split, which
    reads its own int8 store. First step against the plain path on the same
    int8 store, launch counts, step times, a profiler window, the stores'
    bytes; then the resident evaluator on the int8 val store against the
    one on a bf16 store, on the same parameters."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        cfg = stage2_config(tmp, steps, **{
            "train.store_quantize": "int8", "train.eval_every": EVAL_EVERY,
            "train.checkpoint_every": 10 * steps})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        state = trainer.init_state()
        t0 = time.perf_counter()
        data, make_batch, _ = trainer._prepare_resident(ds)
        out["upload_s"] = time.perf_counter() - t0
        store = data["grid"]
        Np = store.shape[1]
        check(store.dtype == torch.int8 and tuple(store.shape) ==
              (TRAIN_IMAGES, Np, C), f"int8 store {store.dtype} "
              f"{tuple(store.shape)}")
        out["store_bytes"] = {"int8": store.numel(),
                              "bf16": store.numel() * 2}
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(len(batch["features"]) == 3, "the int8 batch carries no scale")
        out["scale"] = scale = batch["features"][2]
        print(f"int8 store uploaded in {out['upload_s']:.2f} s: "
              f"{out['store_bytes']['int8'] / 1e6:.1f} MB (bf16: "
              f"{out['store_bytes']['bf16'] / 1e6:.1f} MB), scale {scale:.6g}")
        check(0.0 < scale < 1.0, f"int8 scale {scale}")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "stage 2 (int8 store)")
        del data, make_batch, batch, store

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state, eval_ds=val)
        torch.cuda.synchronize()
        launches = read_counts()
        evals = steps // EVAL_EVERY
        n_batches = -(-VAL_QUESTIONS // B_TRAIN)
        check_launches(launches, {
            "gru_fwd": steps + evals * n_batches,
            "gru_bwd": 3 * steps,
            "attention_resident_fwd[int8]": 2 * (steps + evals * n_batches),
            "attention_resident_bwd[int8]": 3 * steps},
            f"int8-store training over {steps} steps with {evals} "
            "evaluations")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "int8-store training",
                                "questions"))
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            val_recs = [r for r in map(json.loads, fh) if "val/loss" in r]
        check(len(val_recs) == evals and all(np.isfinite(r["val/loss"])
                                             for r in val_recs),
              f"int8 in-loop evaluations: {val_recs}")
        out["val_records"] = val_recs
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)

        # --- the resident evaluator: int8 val store, then a bf16 one -----
        reset_counts()
        t0 = time.perf_counter()
        m_q, p_q = trainer.evaluate_resident(state, val)
        out["eval_int8_s"] = time.perf_counter() - t0
        check_launches(read_counts(), {
            "gru_fwd": n_batches,
            "attention_resident_fwd[int8]": 2 * n_batches},
            "int8 resident evaluation")
        bf16 = Trainer(cfg.replace_flat({"train.store_quantize": ""}), spec,
                       train_dir=os.path.join(tmp, "bf16_eval"))
        reset_counts()
        m_f, p_f = bf16.evaluate_resident(state, val)
        check_launches(read_counts(), {
            "gru_fwd": n_batches,
            "attention_resident_fwd": 2 * n_batches},
            "bf16 resident evaluation")
        bf16.close()
        agree = float((p_q == p_f).mean())
        print(f"resident evaluation, int8 val store {m_q} vs bf16 {m_f}: "
              f"{agree:.4f} of the predictions agree")
        check(np.isfinite(m_q["loss"]) and abs(m_q["loss"] - m_f["loss"])
              <= 0.05 * abs(m_f["loss"]), f"int8 eval loss {m_q['loss']} vs "
              f"bf16 {m_f['loss']}")
        out["evaluation"] = {"int8": m_q, "bf16": m_f,
                             "predictions_agree": agree}
        trainer.close()
    return out


def cli_argv(flags: dict) -> list:
    """``--section.field value`` for each of ``flags``."""
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return argv


def real_data_words(n: int) -> list:
    """``n`` distinct two-syllable words (a seeded permutation of the 4900
    pairs of 70 syllables), each its own normalized answer."""
    import numpy as np
    from vqa_transfer_externaldata_torch.utils.metrics import normalize_answer

    syllables = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    pairs = [a + b for a in syllables for b in syllables]
    order = np.random.default_rng(17).permutation(len(pairs))
    words = [pairs[i] for i in order if normalize_answer(pairs[i])
             == pairs[i]]
    check(len(words) >= n, f"only {len(words)} words for {n}")
    return words[:n]


def write_real_data(root: str, word_dim: int) -> dict:
    """The real-data fixtures, written from a seed in the official schemas:
    VQA v2 questions and annotations (train and val) over REAL_IMAGES
    COCO-like image ids, with yes/no, number and other answers, the train
    split cycling through REAL_OTHER_ANSWERS other answers; Visual Genome
    region descriptions over the same images, whose words are the
    questions' and the answers'; a GloVe text file of ``word_dim``
    vectors for every other word. Returns their paths and the image ids."""
    import numpy as np

    rng = np.random.default_rng(23)
    words = real_data_words(REAL_WORDS)
    answers = words[:REAL_OTHER_ANSWERS]
    image_ids = 100000 + 37 * np.arange(REAL_IMAGES, dtype=np.int64)

    def word() -> str:
        return words[int(rng.integers(len(words)))]

    def split(n: int, qid0: int, cycle: bool) -> tuple:
        questions, annotations, other = [], [], 0
        for i in range(n):
            a, b = word(), word()
            kind = i % 8
            if kind == 0:
                q, qt, at = f"is the {a} {b}?", "is the", "yes/no"
                ans, alt = ("yes", "no")[::1 if rng.integers(2) else -1]
            elif kind == 1:
                q, qt, at = (f"how many {a} are there near the {b}?",
                             "how many", "number")
                ans, alt = (str(k) for k in rng.integers(0, 11, 2))
            else:
                q, qt = ((f"what color is the {a}?", "what color is the")
                         if kind == 2 else
                         (f"what is the {a} near the {b}?", "what is the"))
                at = "other"
                ans = answers[other % len(answers) if cycle
                              else int(rng.integers(len(answers)))]
                alt = answers[int(rng.integers(len(answers)))]
                other += 1
            qid = qid0 + i
            image = int(image_ids[rng.integers(REAL_IMAGES)])
            questions.append({"question_id": qid, "image_id": image,
                              "question": q})
            annotations.append({
                "question_id": qid, "image_id": image,
                "multiple_choice_answer": ans, "question_type": qt,
                "answer_type": at,
                "answers": [{"answer": ans}] * 7 + [{"answer": alt}] * 3})
        return {"questions": questions}, {"annotations": annotations}

    paths = {}
    for name, n, qid0, cycle in (("train", REAL_TRAIN_QUESTIONS, 1, True),
                                 ("val", REAL_VAL_QUESTIONS, 10 ** 7, False)):
        qs, anns = split(n, qid0, cycle)
        for kind, obj in (("questions", qs), ("annotations", anns)):
            paths[f"{name}_{kind}"] = os.path.join(root, f"{name}_{kind}.json")
            with open(paths[f"{name}_{kind}"], "w") as fh:
                json.dump(obj, fh)
    by_image: dict = {}
    for r in range(REAL_REGIONS):
        a, b, c = word(), word(), word()
        phrase = (f"a {a} {b}", f"{a} {b} on the {c}",
                  f"the {a} near a {b}")[r % 3]
        x, y, w, h = (int(v) for v in rng.integers(1, 300, 4))
        by_image.setdefault(int(image_ids[r % REAL_IMAGES]), []).append(
            {"region_id": r, "phrase": phrase, "x": x, "y": y, "width": w,
             "height": h})
    paths["regions"] = os.path.join(root, "region_descriptions.json")
    with open(paths["regions"], "w") as fh:
        json.dump([{"id": i, "regions": regs}
                   for i, regs in by_image.items()], fh)
    paths["glove"] = os.path.join(root, "glove.txt")
    glove_words = words[::2] + ["what", "is", "the", "color", "how", "many"]
    vectors = rng.normal(0.0, 0.4, (len(glove_words), word_dim))
    with open(paths["glove"], "w") as fh:
        for w, vec in zip(glove_words, vectors):
            fh.write(w + " " + " ".join(f"{x:.5f}" for x in vec) + "\n")
    paths["image_ids"] = image_ids
    return paths


def write_raw_store(path: str, ids, grid_hw: int, channels: int,
                    seed: int) -> None:
    """A feature store as the extractor's raw directory (``meta.json``,
    f16 [M, g, g, C] ``grid.f16.bin``, f32 [M, C] ``pool5.f32.bin``,
    ``image_ids.npy``), filled from a seed in chunks of 64 rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = len(ids)
    os.makedirs(path)
    grid = np.memmap(os.path.join(path, "grid.f16.bin"), dtype=np.float16,
                     mode="w+", shape=(m, grid_hw, grid_hw, channels))
    pool5 = np.memmap(os.path.join(path, "pool5.f32.bin"), dtype=np.float32,
                      mode="w+", shape=(m, channels))
    for lo in range(0, m, 64):
        hi = min(m, lo + 64)
        grid[lo:hi] = np.maximum(rng.standard_normal(
            (hi - lo, grid_hw, grid_hw, channels), np.float32), 0)
        pool5[lo:hi] = rng.standard_normal((hi - lo, channels), np.float32)
    grid.flush()
    pool5.flush()
    del grid, pool5
    np.save(os.path.join(path, "image_ids.npy"), np.asarray(ids, np.int64))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump({"grid_shape": [m, grid_hw, grid_hw, channels],
                   "pool5_dim": channels}, fh)


def phase_real_data(report: dict, dev) -> dict:
    """The real-data path at the full width of config.py, through the
    port's entry points: fixtures in the official schemas and two raw
    feature stores written from a seed, the three ``cli.preprocess``
    subcommands, ``cli.train`` stage 1 (``vlmap_description``,
    bidirectional, on the region store with resampled negatives: streamed,
    K6/K7), ``cli.train`` stage 2 transfer-initialized from it (gather-free
    resident, K1/K3/K4/K5, with the lagged in-loop evaluation), ``cli.eval``
    on host batches (the lazy join, K1/K2) and ``cli.predict`` by image id
    (K1/K2). Each stage's first step is held against the plain path."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import predict as predict_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.cli.common import build_spec
    from vqa_transfer_externaldata_torch.cli.preprocess import (
        main as preprocess)
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.data.features import (
        FeatureStore, JoinedDataset)
    from vqa_transfer_externaldata_torch.data.visualgenome import (
        CandidateResampler)
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.vocab import Vocab

    widths = Config().replace_flat(MODEL_OVERRIDES)
    d, m = widths.data, widths.model
    device = ["--device", str(dev)]
    out: dict = {"sizes": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as root:
        t0 = time.perf_counter()
        fx = write_real_data(root, m.word_dim)
        out["fixtures_s"] = time.perf_counter() - t0
        images = os.path.join(root, "image_store")
        regions = os.path.join(root, "region_store")
        rng = np.random.default_rng(29)
        t0 = time.perf_counter()
        write_raw_store(images, rng.permutation(fx["image_ids"]), d.grid_h,
                        d.feature_dim, seed=31)
        write_raw_store(regions, np.arange(REAL_REGIONS), 1, d.pool5_dim,
                        seed=37)
        out["store_write_s"] = time.perf_counter() - t0
        out["sizes"]["store_bytes"] = {
            name: sum(os.path.getsize(os.path.join(p, f))
                      for f in os.listdir(p))
            for name, p in (("images", images), ("regions", regions))}

        # --- the three preprocessing subcommands -------------------------
        pre, vg = os.path.join(root, "vqa_v2"), os.path.join(root, "vg")
        glove = os.path.join(root, "glove_vocab.npz")
        vocab_json = os.path.join(pre, "vocab.json")
        secs = {}
        for tool, argv in (
                ("vqa_v2", ["--out_dir", pre,
                            "--train_questions", fx["train_questions"],
                            "--train_annotations", fx["train_annotations"],
                            "--val_questions", fx["val_questions"],
                            "--val_annotations", fx["val_annotations"],
                            "--top_k", str(REAL_TOP_K),
                            "--vocab_pad_to", str(d.vocab_size),
                            "--max_question_len", str(d.max_question_len),
                            "--answer_holdout_fraction", str(REAL_HOLDOUT),
                            "--feature_path", images]),
                ("visualgenome", ["--out_dir", vg, "--region_descriptions",
                                  fx["regions"], "--vocab", vocab_json,
                                  "--num_tasks", str(m.num_tasks),
                                  "--num_candidates", str(m.num_candidates),
                                  "--min_word_count", "2",
                                  "--max_desc_len", str(d.max_question_len)]),
                ("glove", ["--out", glove, "--glove_txt", fx["glove"],
                           "--vocab", vocab_json, "--dim", str(m.word_dim),
                           "--pad_to", str(d.vocab_size)])):
            t0 = time.perf_counter()
            preprocess([tool] + argv)
            secs[tool] = time.perf_counter() - t0
        out["preprocess_s"] = secs
        print("real data: preprocessing " + ", ".join(
            f"{k} {v:.2f} s" for k, v in secs.items())
            + f"; fixtures {out['fixtures_s']:.2f} s, feature stores "
            f"{out['store_write_s']:.2f} s ({out['sizes']['store_bytes']} "
            "bytes)")
        answer_vocab = Vocab.load(os.path.join(pre, "answer_vocab.json"))
        word_vocab = Vocab.load(vocab_json)
        num_answers = len(answer_vocab)
        with open(os.path.join(pre, "oov_split.json")) as fh:
            oov_ids = json.load(fh)["oov_ids"]
        with open(os.path.join(vg, "vlmap_desc_meta.json")) as fh:
            vg_meta = json.load(fh)
        with open(fx["val_questions"]) as fh:
            val_questions = json.load(fh)["questions"]
        store = FeatureStore(images)
        val_arrays = np.load(os.path.join(pre, "vqa_val.npz"))
        check(num_answers == REAL_TOP_K + 4
              and len(word_vocab) <= d.vocab_size and len(oov_ids) ==
              round(REAL_HOLDOUT * REAL_TOP_K) and np.array_equal(
                  val_arrays["image_index"],
                  [store.index_of[q["image_id"]] for q in val_questions]),
              f"artifacts: {num_answers} answers, {len(word_vocab)} words, "
              f"{len(oov_ids)} held out")
        held = np.isin(val_arrays["answer_id"], oov_ids)
        out["sizes"].update(
            train_questions=REAL_TRAIN_QUESTIONS,
            val_questions=REAL_VAL_QUESTIONS, images=REAL_IMAGES,
            regions=REAL_REGIONS, words=len(word_vocab),
            answers=num_answers, held_out_answers=len(oov_ids),
            val_questions_held_out=int(held.sum()),
            blanks=vg_meta["num_examples"],
            visual_words=vg_meta["num_words"],
            tasks=vg_meta["task_names"][:2] + ["..."])
        print(f"real data: {out['sizes']}")

        # --- stage 1: vlmap_description on the region store --------------
        steps1 = REAL_STAGE1_STEPS
        s1 = {**MODEL_OVERRIDES, **STAGE1_MODEL,
              "data.dataset_dir": vg, "data.feature_path": regions,
              "data.vocab_path": vocab_json, "data.glove_path": glove,
              "train.batch_size": B_TRAIN, "train.max_steps": steps1,
              "train.log_every": 1, "train.eval_every": steps1,
              "train.checkpoint_every": steps1}
        cfg1 = Config().replace_flat(s1)
        ds1 = load_dataset(cfg1, "train", stage="vlmap_desc")
        val1 = load_dataset(cfg1, "val", stage="vlmap_desc")
        check(isinstance(ds1, CandidateResampler)
              and isinstance(ds1.base, JoinedDataset),
              f"stage-1 split {type(ds1).__name__}")
        spec, _, _ = build_spec(cfg1, generator=torch.Generator().manual_seed(
            cfg1.train.seed))
        trainer = Trainer(cfg1, spec, train_dir=os.path.join(root, "chk1"),
                          device=str(dev))
        state = trainer.init_state()
        batch = trainer._uploader()(next(ds1.batches(
            B_TRAIN, seed=cfg1.train.seed)))
        check(tuple(batch["feature"].shape) == (B_TRAIN, d.pool5_dim),
              f"stage-1 feature {tuple(batch['feature'].shape)}")
        out["stage1_first_step"] = check_first_step(
            spec, state, batch, dev, "real-data stage 1")
        trainer.close()
        del trainer, state, batch, spec

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        s1_dir = train_cli.main(device + cli_argv(s1) + [
            "--train.train_dir", os.path.join(root, "stage1")])
        torch.cuda.synchronize()
        out["stage1_cli_s"] = time.perf_counter() - t0
        eval1 = -(-len(val1) // B_TRAIN)
        out["stage1_launches"] = launches = read_counts()
        # K6 one launch a step and one an evaluation batch; K7 three a step.
        check_launches(launches, {"bigru_fwd": steps1 + eval1,
                                  "bigru_bwd": 3 * steps1},
                       f"real-data stage 1 over {steps1} steps and "
                       f"{eval1} evaluation batches")
        out["stage1"] = read_steps(s1_dir, steps1, "real-data stage 1 "
                                   "(streamed, resampled)", "regions",
                                   warmup=2)

        # --- stage 2: vqa_attention, transferred, gather-free ------------
        steps2, every = REAL_STAGE2_STEPS, REAL_EVAL_EVERY
        s2 = {**MODEL_OVERRIDES, "data.dataset_dir": pre,
              "data.feature_path": images, "data.vocab_path": vocab_json,
              "data.answer_vocab_path": os.path.join(pre, "answer_vocab.json"),
              "data.num_answers": num_answers,
              "train.device_data_cache": True, "train.batch_size": B_TRAIN,
              "train.max_steps": steps2, "train.log_every": 1,
              "train.eval_every": every, "train.checkpoint_every": steps2}
        cfg2 = Config().replace_flat(s2)
        ds2 = load_dataset(cfg2, "train")
        check(isinstance(ds2, JoinedDataset) and ds2.size ==
              REAL_TRAIN_QUESTIONS and ds2.store.grid.shape[0] ==
              REAL_IMAGES, f"stage-2 split {type(ds2).__name__}")
        spec, _, _ = build_spec(cfg2, generator=torch.Generator().manual_seed(
            cfg2.train.seed))
        trainer = Trainer(cfg2, spec, train_dir=os.path.join(root, "chk2"),
                          device=str(dev))
        state = trainer.init_state()
        _, make_batch, nbytes = trainer._prepare_resident(ds2)
        out["stage2_uploaded_gb"] = nbytes / 1e9
        idx0 = next(ds2.index_batches(B_TRAIN, seed=cfg2.train.seed))
        out["stage2_first_step"] = check_first_step(
            spec, state, make_batch(torch.from_numpy(idx0).to(dev)), dev,
            "real-data stage 2")
        trainer.close()
        del trainer, state, make_batch, spec

        reset_counts()
        t0 = time.perf_counter()
        s2_dir = train_cli.main(device + cli_argv(s2) + [
            "--train.pretrained_param_path",
            os.path.join(s1_dir, PARAMS_FILE),
            "--train.train_dir", os.path.join(root, "stage2")])
        torch.cuda.synchronize()
        out["stage2_cli_s"] = time.perf_counter() - t0
        eval2 = (steps2 // every) * -(-REAL_VAL_QUESTIONS // B_TRAIN)
        out["stage2_launches"] = launches = read_counts()
        check_launches(launches, {
            "gru_fwd": steps2 + eval2, "gru_bwd": 3 * steps2,
            "attention_resident_fwd": 2 * (steps2 + eval2),
            "attention_resident_bwd": 3 * steps2},
            f"real-data stage 2 over {steps2} steps and {eval2} evaluation "
            "batches")
        out["stage2"] = read_steps(s2_dir, steps2, "real-data stage 2 "
                                   "(gather-free, transferred)", "questions")
        with open(os.path.join(s2_dir, "metrics.jsonl")) as fh:
            recs = [r for r in map(json.loads, fh) if "val/loss" in r]
        check([r["step"] for r in recs] == list(range(every, steps2 + 1,
                                                      every))
              and all(np.isfinite(r["val/vqa_accuracy"]) for r in recs),
              f"in-loop evaluations: {recs}")

        # --- cli.eval on host batches: the lazy join, K1/K2 ---------------
        reset_counts()
        t0 = time.perf_counter()
        metrics = eval_cli.main(device + ["--train.train_dir", s2_dir,
                                          "--train.device_data_cache",
                                          "false"])
        out["eval_cli_s"] = time.perf_counter() - t0
        batches = -(-REAL_VAL_QUESTIONS // B_TRAIN)
        out["eval_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": batches,
                                  "attention_fwd": 2 * batches},
                       f"real-data cli.eval over {batches} batches")
        with open(os.path.join(s2_dir, "results_val.json")) as fh:
            results = json.load(fh)
        check(sorted(r["question_id"] for r in results) == sorted(
            q["question_id"] for q in val_questions)
              and all(r["answer"] in answer_vocab.token_to_id
                      for r in results),
              f"results_val.json: {len(results)} rows")
        types = json.load(open(os.path.join(pre, "types.json")))
        counts = np.bincount(val_arrays["answer_type_id"],
                             minlength=len(types["answer_types"]))
        mix = sum(int(counts[t]) * metrics[
            "vqa_accuracy_answer_type/" + name.replace("/", "_")]
            for t, name in enumerate(types["answer_types"]) if counts[t])
        check({"vqa_accuracy_answer_type/yes_no",
               "vqa_accuracy_answer_type/number",
               "vqa_accuracy_answer_type/other",
               "vqa_accuracy_oov_answers",
               "vqa_accuracy_in_vocab_answers"} <= set(metrics)
              and abs(mix / counts.sum() - metrics["vqa_accuracy"]) < 1e-6
              and all(np.isfinite(v) for v in metrics.values()),
              f"cli.eval metrics: {metrics}")
        out["eval_metrics"] = metrics
        print(f"real-data cli.eval: {len(results)} results; {metrics}")

        # --- cli.predict by image id --------------------------------------
        picked = val_questions[:REAL_PREDICT]
        argv = device + ["--train_dir", s2_dir, "--feature_path", images]
        for q in picked:
            argv += ["--image_id", str(q["image_id"]), "--question",
                     q["question"]]
        reset_counts()
        answers = predict_cli.main(argv)
        out["predict_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": 1, "attention_fwd": 2},
                       "real-data cli.predict")
        pred = Predictor(s2_dir, device=str(dev))
        rows = np.asarray([store.index_of[q["image_id"]] for q in picked])
        direct = pred.answer(store.gather(rows)["features"],
                             [q["question"] for q in picked])
        check(answers == direct and len(answers) == REAL_PREDICT,
              f"cli.predict answers {answers} vs Predictor {direct}")
        print(f"real-data cli.predict: {answers}")
        out["predict_answers"] = answers
        store.close()
    return out


def phase_oov(report: dict, dev) -> dict:
    """The paper's claim on the card: ``tools/oov_claim.py``'s protocol
    (the CPU test's, the JAX package's ``test_transfer_beats_scratch_on_
    oov_answers``) at OOV_WIDTHS, the smallest widths every kernel wrapper
    takes in bf16, the corpus drawn at OOV_CONCEPT_DIM channels and
    zero-padded: stage 1 ``vlmap`` (no kernel), the transfer, stage 2 from
    the transferred and from a fresh answer table (frozen; K1/K3, K2/K8 on
    streamed batches, K1/K2 in the evaluations); JAX's thresholds."""
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.tools import oov_claim

    cfg = Config().replace_flat({**oov_claim.TINY, **OOV_WIDTHS})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_oov_") as tmp:
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        out = oov_claim.run(cfg, device=dev, train_dir=tmp,
                            concept_dim=OOV_CONCEPT_DIM)
        out["launches"] = launches = read_counts()
    steps, B = cfg.train.max_steps, cfg.train.batch_size
    evals = 2 * -(-oov_claim.CORPUS["n_val"] // B)
    check_launches(launches, {
        "gru_fwd": 2 * steps + evals, "gru_bwd": 6 * steps,
        "attention_fwd": 2 * (2 * steps + evals),
        "attention_bwd": 8 * steps},
        f"the OOV claim: stage 1, then two stage-2 runs of {steps} steps "
        "and their evaluations")
    out["widths"] = OOV_WIDTHS
    print(f"OOV claim on the card: OOV answers transfer "
          f"{out['oov_transfer']:.4f}, scratch {out['oov_scratch']:.4f}; "
          f"in-vocabulary transfer {out['in_vocab_transfer']:.4f}, scratch "
          f"{out['in_vocab_scratch']:.4f} (thresholds: in-vocab > 0.5, OOV "
          f"transfer > 0.3 and > 3 x max(scratch, "
          f"1/{cfg.data.num_answers})); seconds {out['seconds']}")
    check(out["meets_thresholds"],
          f"the OOV claim misses JAX's thresholds: {out}")
    return out


def e2e_grid_errors(got, want) -> dict:
    """Mean and largest |error| of ``got`` against ``want`` (float32),
    relative to the mean and the largest |value| of ``want``, and the
    cosine of the flattened tensors."""
    import torch

    a, b = got.float().flatten(), want.float().flatten()
    d = (a - b).abs()
    return {"mean_rel": (d.mean() / b.abs().mean()).item(),
            "max_rel": (d.max() / b.abs().max()).item(),
            "cos": torch.nn.functional.cosine_similarity(a, b, 0).item()}


def write_jpegs(root: str, n: int, seed: int) -> tuple:
    """``n`` seeded COCO-named JPEGs (train2014) of 480 x 640 pixels (the
    decoder resizes them) and the ids in their names."""
    import numpy as np
    from PIL import Image
    from vqa_transfer_externaldata_torch.data.ingest import coco_image_path

    rng = np.random.default_rng(seed)
    image_dir = os.path.join(root, "coco")
    os.makedirs(image_dir, exist_ok=True)
    ids = np.sort(rng.choice(np.arange(1, 600000), n, replace=False))
    # Smooth images (a coarse field upsampled), as photographs are: JPEG
    # keeps them close to what was drawn.
    for i in ids:
        coarse = rng.integers(0, 256, (15, 20, 3)).astype(np.uint8)
        Image.fromarray(coarse).resize((640, 480), Image.BILINEAR).save(
            coco_image_path(image_dir, "train2014", int(i)), quality=90)
    return image_dir, ids


def e2e_head_kernels(v, dev, buf) -> dict:
    """The end2end head's K2 and K8 on the backbone's bf16 grid ``v`` [B,
    196, 2048] (a view of its channels_last activations) at the training
    batch and at the serving one (its first E2E_PREDICT rows): K2's checks
    (``k2_checks``), K8 against its plain version in the path's mode
    (normalize on; K8's limits), and both times beside their plain
    versions' and their bounds."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(67)
    Cv = v.shape[-1]
    qh_all = torch.randn(v.shape[0], H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (Cv + H)) ** 0.5
    wv = ((torch.rand(Cv, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    out = {}
    for Bq in (v.shape[0], E2E_PREDICT):
        vb, qh = v[:Bq], qh_all[:Bq]
        Nq = vb.shape[1]
        k2 = k2_checks(vb, qh, wv, ws)
        va, al, r = attention.attention_fwd(vb, qh, wv, ws, normalize=True)
        ds = (torch.randn(Bq, Nq, generator=gen, device=dev) * al
              ).contiguous()
        got = attention.attention_bwd(vb, qh, wv, ws, ds, r, True)
        want = attention.attention_bwd_reference(vb, qh, wv, ws, ds, r, True)
        torch.cuda.synchronize()
        a_dqh, a_dwv, unsure = k8_allowance(vb, qh, wv, ws, ds, r, True)
        k8 = []
        for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                     (a_dqh, a_dwv, 0.0)):
            limit = TOL_K8_REL * b.abs().max().item() + allow
            worst = ((a - b).abs() / limit).max().item()
            check(bool(torch.isfinite(a).all()) and worst <= 1.0,
                  f"K8 on the ResNet grid B={Bq} {name}: an entry at "
                  f"{worst} of its limit")
            k8.append({"output": name,
                       "max_abs_err": (a - b).abs().max().item(),
                       "rel_err": rel_err(a, b), "units_near_zero": unsure,
                       "worst_share_of_limit": worst})
        # The bounds: the grid once and W_v once; K2 its score GEMM and
        # weighted sum, K8 its two [B*N, C] x [C, H] GEMMs.
        nbytes = vb.numel() * 2 + wv.numel() * 2
        gemm = 2.0 * Bq * Nq * Cv * H
        b2, b8 = bound(nbytes, gemm + 2.0 * Bq * Nq * Cv), bound(nbytes,
                                                                  2 * gemm)
        t = {"k2": time_cuda(lambda: attention.attention_fwd(
                 vb, qh, wv, ws, normalize=True), buf),
             "k2_plain": time_cuda(lambda: attention.attention_fwd_reference(
                 vb, qh, wv, ws, True), buf),
             "k8": time_cuda(lambda: attention.attention_bwd(
                 vb, qh, wv, ws, ds, r, True), buf),
             "k8_plain": time_cuda(lambda: attention.attention_bwd_reference(
                 vb, qh, wv, ws, ds, r, True), buf)}
        out[Bq] = {"k2_checks": k2, "k8_checks": k8,
                   "k2": {"ms": t["k2"], "plain_ms": t["k2_plain"],
                          "bound_ms": b2[0], "bound_by": b2[1]},
                   "k8": {"ms": t["k8"], "plain_ms": t["k8_plain"],
                          "bound_ms": b8[0], "bound_by": b8[1]}}
        print(f"end2end head on the ResNet grid at B={Bq}: K2 {t['k2']:.4f} "
              f"ms (plain {t['k2_plain']:.4f}, bound {b2[0]:.4f}), K8 "
              f"{t['k8']:.4f} ms (plain {t['k8_plain']:.4f}, bound "
              f"{b8[0]:.4f}); K8's worst entry at "
              f"{max(c['worst_share_of_limit'] for c in k8):.3f} of its "
              "limit")
    return out


def e2e_checkpoint(root: str) -> str:
    """A seeded torchvision-format ResNet-101 checkpoint (E2E_STAGES,
    E2E_WIDTH; BatchNorm statistics drawn too) written under ``root``:
    its path."""
    import torch
    from vqa_transfer_externaldata_torch.ops import resnet

    pth = os.path.join(root, "resnet101.pth")
    stages = tuple(int(x) for x in E2E_STAGES.split(","))
    src = resnet.ResNetV1(stages, E2E_WIDTH, dtype=torch.float32,
                          stem="conv",
                          generator=torch.Generator().manual_seed(41))
    g = torch.Generator().manual_seed(43)
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, resnet.BatchNorm):
                m.mean.normal_(0.0, 0.5, generator=g)
                m.var.uniform_(0.5, 1.5, generator=g)
    torch.save(resnet.torchvision_state_dict(src), pth)
    return pth


def phase_end2end(report: dict, dev) -> dict:
    """The raw-image model at the full width of config.py (phase 22; see
    the module docstring)."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.cli.common import (
        build_spec, load_resnet_backbone)
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.end2end import (
        VQAEnd2EndModel)
    from vqa_transfer_externaldata_torch.ops import resnet
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

    t_phase = time.perf_counter()
    device = ["--device", str(dev)]
    stages = tuple(int(x) for x in E2E_STAGES.split(","))
    out: dict = {"sizes": {"batch": E2E_BATCH, "image_size": E2E_SIZE,
                           "images": E2E_IMAGES, "stages": E2E_STAGES,
                           "width": E2E_WIDTH}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as root:
        pth = e2e_checkpoint(root)
        flags = {**MODEL_OVERRIDES, "model.model": "vqa_end2end",
                 "model.resnet_checkpoint": pth,
                 "model.resnet_stages": E2E_STAGES,
                 "model.resnet_width": E2E_WIDTH,
                 "data.image_size": E2E_SIZE, "data.synthetic": True,
                 "data.synthetic_size": E2E_IMAGES,
                 "train.device_data_cache": True,
                 "train.batch_size": E2E_BATCH,
                 "train.max_steps": E2E_STEPS, "train.log_every": 1,
                 "train.eval_every": 10 ** 6,
                 "train.checkpoint_every": E2E_STEPS}
        cfg = Config().replace_flat(flags)
        backbone = load_resnet_backbone(cfg)

        # --- 1. the backbone alone: bf16 against float32 on the card ------
        nets = {}
        for dt in (torch.bfloat16, torch.float32):
            with torch.device("meta"):
                net = resnet.ResNetV1(stages, E2E_WIDTH, dtype=dt,
                                      stem=VQAEnd2EndModel.stem)
            net.load_state_dict(backbone, assign=True)
            nets[dt] = net.to(dev).eval()
        gen = torch.Generator(device=dev).manual_seed(47)
        images = torch.randint(0, 256, (E2E_BATCH, E2E_SIZE, E2E_SIZE, 3),
                               generator=gen, device=dev, dtype=torch.uint8)
        with torch.inference_mode():
            x = resnet.preprocess_images(images, E2E_SIZE)
            ob, of = nets[torch.bfloat16](x), nets[torch.float32](x)
        check(tuple(ob["grid"].shape) == (E2E_BATCH, E2E_SIZE // 32,
                                          E2E_SIZE // 32, 32 * E2E_WIDTH)
              and ob["grid"].dtype == torch.bfloat16
              and ob["grid"].is_contiguous(),
              f"backbone grid {tuple(ob['grid'].shape)} {ob['grid'].dtype}")
        errs = {k: e2e_grid_errors(ob[k], of[k]) for k in ("grid", "pool5")}
        out["backbone_vs_f32"] = errs
        print(f"end2end backbone at B={E2E_BATCH}, {E2E_SIZE}px: bf16 vs "
              f"float32 on the card {errs} (limits: mean "
              f"{TOL_BACKBONE_MEAN}, max {TOL_BACKBONE_MAX}, cosine "
              f"{BACKBONE_COS})")
        for k, e in errs.items():
            check(e["mean_rel"] <= TOL_BACKBONE_MEAN
                  and e["max_rel"] <= TOL_BACKBONE_MAX
                  and e["cos"] >= BACKBONE_COS
                  and bool(torch.isfinite(ob[k]).all()),
                  f"backbone {k} vs float32: {e}")
        buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
        v = ob["grid"].reshape(E2E_BATCH, -1, ob["grid"].shape[-1])
        check(v.is_contiguous() and v.data_ptr() == ob["grid"].data_ptr(),
              "the backbone's grid rows are not a view of its activations")
        out["head_kernels"] = e2e_head_kernels(v, dev, buf)
        del v
        macs = resnet.conv_macs(nets[torch.bfloat16], E2E_SIZE)
        with torch.inference_mode():
            ms = time_cuda(lambda: nets[torch.bfloat16](x), buf)
            ms_f32 = time_cuda(lambda: nets[torch.float32](x), buf)
            model_ms = time_cuda(
                lambda: nets[torch.bfloat16](resnet.preprocess_images(
                    images, E2E_SIZE)), buf)
        bound_ms = 2 * macs * E2E_BATCH / PEAK_BF16_FLOPS * 1e3
        out["backbone"] = {
            "ms": ms, "images_per_s": E2E_BATCH * 1e3 / ms,
            "with_preprocess_ms": model_ms, "f32_ms": ms_f32,
            "conv_gmac_per_image": macs / 1e9, "bound_ms": bound_ms,
            "bound_by": "operations",
            "tflops": 2 * macs * E2E_BATCH / ms / 1e9}
        print(f"end2end backbone bf16 at B={E2E_BATCH}: {ms:.3f} ms "
              f"({E2E_BATCH * 1e3 / ms:.1f} images/s; with the uint8 "
              f"resize/normalize {model_ms:.3f} ms; float32 {ms_f32:.3f} ms);"
              f" conv MACs {macs / 1e9:.2f} G an image; bound at "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 {bound_ms:.3f} ms "
              f"= {out['backbone']['tflops']:.1f} TFLOP/s achieved")
        del nets, ob, of, x, buf

        # --- 2. cli.train on synthetic pixels held on the card -----------
        spec, _, _ = build_spec(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        spec.module.resnet.load_state_dict(backbone)
        trainer = Trainer(cfg, spec, train_dir=os.path.join(root, "chk"),
                          device=str(dev))
        state = trainer.init_state()
        check(not any(k.startswith("resnet.") for k in state.opt_state.mu),
              "the frozen backbone carries Adam moments")
        ds = load_dataset(cfg, "train")
        check(ds.arrays["images"].shape == (E2E_IMAGES, E2E_SIZE, E2E_SIZE,
                                            3)
              and ds.arrays["images"].dtype == np.uint8,
              f"synthetic images {ds.arrays['images'].shape}")
        _, make_batch, nbytes = trainer._prepare_resident(ds)
        out["uploaded_gb"] = nbytes / 1e9
        idx0 = next(ds.index_batches(E2E_BATCH, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(batch["images"].dtype == torch.uint8,
              f"resident images {batch['images'].dtype}")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "end2end", trainer.tx.frozen)
        del batch, make_batch

        reset_counts()
        t0 = time.perf_counter()
        run_dir = train_cli.main(device + cli_argv(flags) + [
            "--train.train_dir", os.path.join(root, "run")])
        torch.cuda.synchronize()
        out["train_cli_s"] = time.perf_counter() - t0
        out["train_launches"] = launches = read_counts()
        # A step: K1 1, K3 3 (its launches a call), K2 2, K8 4.
        check_launches(launches, {
            "gru_fwd": E2E_STEPS, "gru_bwd": 3 * E2E_STEPS,
            "attention_fwd": 2 * E2E_STEPS,
            "attention_bwd": 4 * E2E_STEPS},
            f"end2end cli.train over {E2E_STEPS} steps")
        out["train"] = read_steps(run_dir, E2E_STEPS, "end2end cli.train "
                                  "(resident synthetic images)", "images",
                                  warmup=2, batch=E2E_BATCH)
        final = load_params(os.path.join(run_dir, PARAMS_FILE))
        same = all(torch.equal(final[f"resnet.{k}"], v)
                   for k, v in backbone.items())
        check(same and len(backbone) == sum(k.startswith("resnet.")
                                            for k in final),
              "the backbone's parameters or statistics changed in training")
        print(f"end2end: the backbone's {len(backbone)} parameters and "
              "BatchNorm statistics are bit-equal after training")
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)
        trainer.close()
        del trainer, state

        # --- 2b. train.steps_per_call: graphed against eager --------------
        # The backbone runs in the captured steps: preprocess_images, the
        # 104 convolutions (cuDNN) and BatchNorm/ReLU passes under no_grad.
        def e2e_spec(c):
            sp, _, _ = build_spec(c, generator=torch.Generator().manual_seed(
                c.train.seed))
            sp.module.resnet.load_state_dict(backbone)
            return sp

        e2e_step = {"gru_fwd": 1, "gru_bwd": 3, "attention_fwd": 2,
                    "attention_bwd": 4}
        pair = {k: spc_run(cfg.replace_flat({
            "model.dropout": 0.0, "train.steps_per_call": k,
            "train.train_dir": os.path.join(root, f"spc_k{k}"),
            "train.max_steps": E2E_SPC_STEPS + 2,
            "train.log_every": E2E_SPC_K,
            "train.profile_start": E2E_SPC_STEPS,
            "train.profile_steps": 2}), ds, "end2end", e2e_step,
            timed=E2E_SPC_TIMED, build=e2e_spec) for k in (1, E2E_SPC_K)}
        out["steps_per_call"] = {
            "k": E2E_SPC_K,
            "wall_ms_per_step": {k: r["wall_ms_per_step"]
                                 for k, r in pair.items()},
            "launches": {k: r["launches"] for k, r in pair.items()},
            "window_records": {k: r["window_records"]
                               for k, r in pair.items()},
            "against_eager": spc_compare(pair[1], pair[E2E_SPC_K],
                                         f"end2end k={E2E_SPC_K} against "
                                         "eager")}
        del pair, ds, spec

        # --- 3. cli.eval, then Predictor on uint8 images -----------------
        reset_counts()
        t0 = time.perf_counter()
        metrics = eval_cli.main(device + ["--train.train_dir", run_dir])
        torch.cuda.synchronize()
        out["eval_cli_s"] = time.perf_counter() - t0
        batches = -(-E2E_IMAGES // E2E_BATCH)
        out["eval_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": batches,
                                  "attention_fwd": 2 * batches},
                       f"end2end cli.eval over {batches} batches")
        check(all(np.isfinite(v) for v in metrics.values())
              and 0.0 <= metrics["vqa_accuracy"] <= 1.0,
              f"end2end cli.eval metrics {metrics}")
        out["eval_metrics"] = metrics
        print(f"end2end cli.eval of {E2E_IMAGES} images in "
              f"{out['eval_cli_s']:.2f} s: {metrics}")

        pred = Predictor(run_dir, batch_size=E2E_PREDICT, device=str(dev))
        check(pred.visual_key == "images", f"Predictor reads "
              f"{pred.visual_key}")
        rng = np.random.default_rng(53)
        pix = rng.integers(0, 256, (E2E_PREDICT, E2E_SIZE, E2E_SIZE, 3)
                           ).astype(np.uint8)
        words = len(pred.word_vocab) - 4
        questions = [" ".join(f"w{w}" for w in rng.integers(0, words, n))
                     for n in rng.integers(1, T + 1, E2E_PREDICT)]
        reset_counts()
        answers = pred.answer(pix, questions)
        out["predict_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": 1, "attention_fwd": 2},
                       f"end2end Predictor at batch {E2E_PREDICT}")
        v = torch.from_numpy(pix).to(dev)
        q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
        with torch.inference_mode():
            lk = pred.model(v, q)["logits"]
            with plain_kernels():
                lr = pred.model(v, q)["logits"]
        err = (lk - lr).abs().max().item()
        top2 = lr.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS
        plain = [pred.answer_vocab.tokens[int(i)] for i in lr.argmax(-1)]
        check(err <= TOL_LOGITS and all(
            a == p for a, p, d in zip(answers, plain, decided.tolist())
            if d), f"end2end serving logits err {err}, answers {answers} "
            f"vs plain {plain}")
        ts = []
        for i in range(3 + RUNS):
            t0 = time.perf_counter()
            pred.answer(pix, questions)  # ends in a device->host copy
            if i >= 3:
                ts.append((time.perf_counter() - t0) * 1e3)
        out["predict_p50_ms"] = statistics.median(ts)
        out["predict_logits_err"] = err
        print(f"end2end Predictor: {E2E_PREDICT} uint8 images p50 "
              f"{out['predict_p50_ms']:.3f} ms; logits vs plain {err:.3e} "
              f"(tol {TOL_LOGITS}); {answers}")
        del pred

        # --- 4. JPEGs: host decode through PIL, where it imports ---------
        try:
            import PIL  # noqa: F401
            out["pil"] = True
        except ImportError:
            out["pil"] = False
        if not out["pil"]:
            print("end2end JPEG steps: PIL does not import on this machine; "
                  "cli.extract, ImageQuestionDataset and cli.predict --image "
                  "stay CPU-tested (tests/test_torch_extract.py, "
                  "tests/test_torch_end2end.py)")
        else:
            out.update(e2e_jpeg_steps(root, dev, flags, device))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"end2end phase: {out['seconds']:.1f} s")
    return out


def e2e_jpeg_steps(root: str, dev, flags: dict, device: list) -> dict:
    """Phase 22's host-decode steps on seeded JPEGs: ``cli.extract`` of
    whole images and of region crops, ``cli.train`` streamed through
    ``ImageQuestionDataset``, ``cli.predict --image``."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import extract as extract_cli
    from vqa_transfer_externaldata_torch.cli import predict as predict_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import (
        synthetic_vocabs)
    from vqa_transfer_externaldata_torch.data.features import FeatureStore
    from vqa_transfer_externaldata_torch.data.ingest import (
        _decode, _decode_pil, coco_image_path)
    from vqa_transfer_externaldata_torch.serving import Predictor

    out: dict = {}
    t0 = time.perf_counter()
    image_dir, ids = write_jpegs(root, E2E_JPEGS, seed=59)
    out["jpegs_write_s"] = time.perf_counter() - t0
    pth = flags["model.resnet_checkpoint"]
    g = E2E_SIZE // 32

    # --- cli.extract: whole images, then region crops ------------------
    rng = np.random.default_rng(61)
    regions = os.path.join(root, "region_meta.npz")
    xy = rng.integers(0, 400, (E2E_REGIONS, 2))
    wh = rng.integers(0, 240, (E2E_REGIONS, 2))
    np.savez(regions, image_id=rng.choice(ids, E2E_REGIONS).astype(np.int64),
             bbox=np.concatenate([xy, wh], 1).astype(np.int32))
    secs = {}
    for tag, extra, rows, want_ids in (
            ("images", [], E2E_JPEGS, ids),
            ("regions", ["--regions", regions], E2E_REGIONS,
             np.arange(E2E_REGIONS))):
        reset_counts()
        t0 = time.perf_counter()
        path = extract_cli.main(device + [
            "--image_dir", image_dir, "--out", os.path.join(root, tag),
            "--format", "raw", "--image_size", str(E2E_SIZE),
            "--batch_size", str(E2E_BATCH), "--torch_checkpoint", pth]
            + extra)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        check_launches(read_counts(), {}, f"end2end cli.extract ({tag})")
        store = FeatureStore(path)
        check(np.array_equal(store.image_ids, want_ids)
              and store.grid.shape == (rows, g, g, 32 * E2E_WIDTH)
              and store.pool5.shape == (rows, 32 * E2E_WIDTH)
              and np.isfinite(np.asarray(store.pool5)).all()
              and np.isfinite(store.gather(np.arange(min(rows, 8)))[
                  "features"]).all(),
              f"cli.extract {tag}: ids {store.image_ids[:4]}..., grid "
              f"{store.grid.shape}")
        store.close()
    out["extract_s"] = secs
    print(f"end2end cli.extract: {E2E_JPEGS} JPEGs {secs['images']:.2f} s, "
          f"{E2E_REGIONS} region crops {secs['regions']:.2f} s (raw stores "
          f"read back through FeatureStore)")

    # --- cli.train streamed through ImageQuestionDataset ---------------
    data_dir = os.path.join(root, "pre")
    os.makedirs(data_dir)
    cfg = Config().replace_flat(flags)
    words, answers = synthetic_vocabs(cfg)
    words.save(os.path.join(data_dir, "vocab.json"))
    answers.save(os.path.join(data_dir, "answer_vocab.json"))
    np.save(os.path.join(data_dir, "image_ids.npy"), ids.astype(np.int64))
    n_q, T_q = 4 * E2E_JPEGS, cfg.data.max_question_len
    q_ids = rng.integers(4, cfg.data.vocab_size, (n_q, T_q)).astype(np.int32)
    q_ids[:, 8:] = 0
    np.savez(os.path.join(data_dir, "vqa_train.npz"), q_ids=q_ids,
             image_index=rng.integers(0, E2E_JPEGS, n_q).astype(np.int32),
             answer_id=rng.integers(4, cfg.data.num_answers, n_q).astype(
                 np.int32))
    jflags = {**flags, "data.synthetic": False, "data.dataset_dir": data_dir,
              "data.image_dir": image_dir,
              "data.vocab_path": os.path.join(data_dir, "vocab.json"),
              "data.answer_vocab_path": os.path.join(data_dir,
                                                     "answer_vocab.json"),
              "train.max_steps": E2E_JPEG_STEPS,
              "train.checkpoint_every": E2E_JPEG_STEPS}
    reset_counts()
    t0 = time.perf_counter()
    run_dir = train_cli.main(device + cli_argv(jflags) + [
        "--train.train_dir", os.path.join(root, "jpeg_run")])
    torch.cuda.synchronize()
    out["jpeg_train_cli_s"] = time.perf_counter() - t0
    out["jpeg_train_launches"] = launches = read_counts()
    check_launches(launches, {
        "gru_fwd": E2E_JPEG_STEPS, "gru_bwd": 3 * E2E_JPEG_STEPS,
        "attention_fwd": 2 * E2E_JPEG_STEPS,
        "attention_bwd": 4 * E2E_JPEG_STEPS},
        f"end2end cli.train on JPEGs over {E2E_JPEG_STEPS} steps")
    out["jpeg_train"] = read_steps(run_dir, E2E_JPEG_STEPS, "end2end "
                                   "cli.train (streamed JPEGs)", "images",
                                   warmup=1, batch=E2E_BATCH)

    # --- cli.predict --image ---------------------------------------------
    paths = [coco_image_path(image_dir, "train2014", int(i)) for i in ids[:3]]
    argv = device + ["--train_dir", run_dir]
    for p in paths:
        argv += ["--image", p, "--question", "w5 w6 w7"]
    reset_counts()
    got = predict_cli.main(argv)
    out["jpeg_predict_launches"] = launches = read_counts()
    check_launches(launches, {"gru_fwd": 1, "attention_fwd": 2},
                   "end2end cli.predict --image")
    # cli.predict decodes as training does (ingest._decode: the native
    # library where it is built, within one 8-bit step of PIL's pixels).
    pixels = np.stack([_decode(p, E2E_SIZE) for p in paths])
    step = int(np.abs(pixels.astype(np.int16) - np.stack(
        [_decode_pil(p, E2E_SIZE) for p in paths])).max())
    check(step <= INPUT_DECODE_STEP,
          f"cli.predict's pixels {step} steps from PIL's")
    direct = Predictor(run_dir, batch_size=8, device=str(dev)).answer(
        pixels, ["w5 w6 w7"] * 3)
    check(got == direct and len(got) == 3,
          f"cli.predict --image {got} vs Predictor {direct}")
    print(f"end2end cli.predict --image: {got}")
    out["jpeg_predict_answers"] = got
    return out


@contextlib.contextmanager
def port_log_records():
    """(level name, message) of everything the port's logger says inside
    the block."""
    import logging

    seen = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda r: seen.append((r.levelname, r.getMessage()))
    logger = logging.getLogger("vqa_torch")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)


def phase_baseline(report: dict, dev, stage1_params: str) -> dict:
    """vqa_baseline (no attention, no kernel) through cli.train on the
    resident store, transfer-initialized from stage 1 with the word table
    frozen, then cli.eval on the run and cli.predict on pool5."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import predict as predict_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

    steps = BASELINE_STEPS
    flags = {"model.model": "vqa_baseline", "data.synthetic": True,
             "data.synthetic_layout": "joined",
             "data.synthetic_size": BASELINE_QUESTIONS,
             "train.device_data_cache": True, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             "train.freeze_params": "word_emb",
             "train.pretrained_param_path": stage1_params, **MODEL_OVERRIDES}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_baseline_") as tmp:
        # What the resident upload holds: pool5 on the card, no grid.
        cfg = Config().replace_flat({**flags, "train.train_dir": tmp})
        trainer = Trainer(cfg, build_model(cfg), train_dir=tmp)
        ds = load_dataset(cfg, "train")
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        batch = make_batch(torch.arange(B_TRAIN, device=dev))
        check("grid" not in data and data["store_pool5"].is_cuda
              and tuple(batch["pool5"].shape) == (B_TRAIN, C)
              and "features" not in batch,
              f"vqa_baseline's resident data: {sorted(data)}")
        out["uploaded_mb"] = nbytes / 1e6
        del data, make_batch, batch
        # A profiler window of PROFILE_STEPS steps from a fresh init.
        _, out["profile"] = profile_fit(trainer, ds, trainer.init_state(),
                                        PROFILE_STEPS)
        trainer.close()

        argv = ["--train.train_dir", os.path.join(tmp, "run")] + \
            cli_argv(flags)
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        with port_log_records() as seen:
            t0 = time.perf_counter()
            train_dir = train_cli.main(argv)  # default device: CUDA
            torch.cuda.synchronize()
            out["cli_s"] = time.perf_counter() - t0
        check_launches(read_counts(), {}, "vqa_baseline training")
        warned = [m for lv, m in seen if lv == "WARNING"
                  and "no 'answer_embedding'" in m]
        check(len(warned) == 1, "the transfer into vqa_baseline did not warn")
        out.update(read_steps(train_dir, steps, "vqa_baseline training",
                              "questions", warmup=2))
        words = load_params(stage1_params)["word_emb.embedding"]
        trained = load_params(os.path.join(train_dir, PARAMS_FILE))
        check(torch.equal(trained["word_emb.embedding"], words),
              "the word table did not arrive bit for bit")
        print(f"vqa_baseline transfer: word table {tuple(words.shape)} "
              f"arrived bit for bit; warned: {warned[0]!r}")

        # --- cli.eval on the run -----------------------------------------
        t0 = time.perf_counter()
        got = eval_cli.main(["--train.train_dir", train_dir])
        out["cli_eval_s"] = time.perf_counter() - t0
        with open(os.path.join(train_dir, "results_val.json")) as fh:
            rows = json.load(fh)
        check(len(rows) == BASELINE_QUESTIONS and
              0.0 <= got["vqa_accuracy"] <= 1.0,
              f"cli.eval: {got}, {len(rows)} result rows")
        print(f"vqa_baseline cli.eval: {got}")

        # --- requests served with pool5 through cli.predict --------------
        rng = np.random.default_rng(3)
        store_path = os.path.join(tmp, "store.npz")
        ids = np.arange(100, 100 + PREDICT_IMAGES)
        pool5 = rng.standard_normal((PREDICT_IMAGES, C), np.float32)
        np.savez(store_path, image_ids=ids, pool5=pool5,
                 grid=np.zeros((PREDICT_IMAGES, GRID, GRID, C), np.float16))
        qs = ["w5 w6 w7", "w8", "w9 w10", "w11 w12 w13 w14"]
        pick = [3, 0, 7, 3]
        argv = ["--train_dir", train_dir, "--feature_path", store_path]
        for i, q in zip(pick, qs):
            argv += ["--image_id", str(ids[i]), "--question", q]
        reset_counts()
        answers = predict_cli.main(argv)
        check_launches(read_counts(), {}, "vqa_baseline serving")
        pred = Predictor(train_dir)
        direct = pred.answer(pool5[pick], qs)
        check(answers == direct and all(a in pred.answer_vocab.tokens
                                        for a in answers),
              f"cli.predict answers {answers} vs Predictor {direct}")
        print(f"vqa_baseline cli.predict on pool5: {answers}")
        out.update(cli_eval=got, predict_answers=answers,
                   word_table_exact=True, transfer_warning=warned[0])
    return out


def phase_probes(report: dict, dev) -> dict:
    """The H100 probes through their entries: P1 at Q = 1..4 and P2, each
    checked against its plain version inside ``run()`` (which raises on a
    disagreement), timed over PROBE_ITERS launches, with cuBLAS beside."""
    from vqa_transfer_externaldata_torch.tools import (
        probe_bwd_ceiling as p2, probe_mxu_rows as p1)

    reset_counts()
    try:
        r1 = p1.run(PROBE_ITERS)
        r2 = p2.run(PROBE_ITERS)
    except RuntimeError as e:
        raise PhaseError(str(e)) from e
    # Each Q of P1: its check, one warm-up and PROBE_ITERS timed launches;
    # P2 the same calls, three launches each.
    check_launches(read_counts(), {
        "probe_mxu_rows": len(p1.QS) * (PROBE_ITERS + 2),
        "probe_bwd_ceiling": 3 * (PROBE_ITERS + 2)}, "the probes")
    for q, t in r1["by_q"].items():
        print(f"P1 probe_mxu_rows Q={q}: {t['ms']:.4f} ms a call, "
              f"{t['us_per_question']:.3f} us/question, {t['tflops']:.1f} "
              f"TFLOP/s, {t['tiles_per_group']} tiles a group "
              f"({t['useful_rows']:.0%} useful rows)")
    print(f"P1 plain {r1['plain_ms']:.4f} ms; cuBLAS {r1['cublas_ms']:.4f} ms "
          f"+ gather {r1['cublas_gather_ms']:.4f} ms; Q=1 vs plain "
          f"{r1['rel_err_vs_plain']:.3e} of max|out|")
    print(f"P2 probe_bwd_ceiling: {r2['ms']:.4f} ms a call, "
          f"{r2['tflops']:.1f} TFLOP/s; plain {r2['plain_ms']:.4f} ms; "
          f"cuBLAS {r2['cublas_ms']:.4f} ms; dW_v {r2['dwv_rel_err']:.3e}, "
          f"dal {r2['dal_rel_err']:.3e} of their max")
    return {"probe_mxu_rows": r1, "probe_bwd_ceiling": r2,
            "launches": read_counts()}


def trace_launches(res: dict, per_step: dict,
                   trace: Optional[dict] = None) -> dict:
    """The device records, in a profiler window's summary (all its
    kernels: ``top=None``), of the kernels each wrapper of ``per_step``
    launches (TRACE_KERNELS, with ``trace``'s entries in their place)."""
    names = {**TRACE_KERNELS, **(trace or {})}
    return {op: sum(c for name, c in res["kernel_records"].items()
                    if name.startswith(names[op]))
            for op in per_step}


def spc_run(cfg, ds, what: str, per_step: dict, timed=None,
            ckpt: bool = False, restore_at: Optional[int] = None,
            streamed: bool = False, build=None,
            trace: Optional[dict] = None) -> dict:
    """One run of ``cfg`` (``train.steps_per_call`` k) from its model's
    seeded initialization (``build(cfg)`` gives the spec; default
    ``build_model``): ``Trainer.fit_resident`` on ``ds``, or with
    ``streamed`` ``Trainer.fit`` on its host batches; the launch counts
    from 0. At k = 1 every step is eager and counts ``per_step``; at k > 1
    the run's calls are whole graphs of k steps: the graph's warm-up and
    its capture each count k steps' launches, and each replay runs them
    uncounted. Where the config has a profiler window, the window's trace
    must hold every kernel of ``per_step`` ``per_step`` times a step (at
    k > 1 that is what the replays in it ran), and the launches the path
    ran are the warm-up's plus, for each replay, the records a replay has
    in the trace; a window that lost device records takes the run again,
    once. Returns the initial and final parameters (host copies), the
    logged losses, the counts, the launches, the replays, the wall ms a
    step between the call boundaries ``timed`` (CUDA events recorded after
    each call), the peak device memory of the run and, from the first call
    boundary on, what the steps allocate above what stays allocated
    between them (``step_peak_gb``: the dataset's upload and the first
    capture come before it), and the window's summary. ``ckpt`` keeps the
    checkpoint policy (else no checkpoint is written); ``restore_at``
    restores that step's checkpoint of the run directory first. ``trace``
    names a wrapper's kernels where TRACE_KERNELS' prefixes would count
    another wrapper's launches of the path (:func:`trace_launches`)."""
    for last_try in (False, True):
        out = spc_attempt(cfg, ds, what, per_step, timed, ckpt, restore_at,
                          streamed, build, last_try, trace)
        if out is not None:
            return out


def spc_attempt(cfg, ds, what, per_step, timed, ckpt, restore_at, streamed,
                build, last_try, trace=None) -> Optional[dict]:
    """One try of :func:`spc_run`; None when its window lost records."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.tools import trace_summary

    t = cfg.train
    k = max(1, t.steps_per_call)
    spec = (build(cfg) if build is not None else build_model(
        cfg, generator=torch.Generator().manual_seed(t.seed)))
    trainer = Trainer(cfg, spec, train_dir=t.train_dir)
    state = trainer.init_state()
    if restore_at is not None:
        state = trainer.restore(state, restore_at)
    host = lambda: {n: v.detach().cpu().clone()
                    for n, v in spec.module.state_dict().items()}
    out = {"k": k, "init": host()}
    marks, save = {}, trainer.ckpt.save

    def mark(step, st, force=False):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if not marks:
            torch.cuda.synchronize()
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out["resident_gb"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        marks[step] = ev
        return save(step, st, force=force) if ckpt else False

    trainer.ckpt.save = mark
    start = state.step
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if streamed:
        state = trainer.fit(ds.batches(t.batch_size, seed=t.seed), state)
    else:
        state = trainer.fit_resident(ds, state)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    out["peak_gb"] = max(out["peak_gb"], peak)
    out["step_peak_gb"] = peak - out["resident_gb"]
    counts = read_counts()
    steps = state.step - start
    check(state.step == t.max_steps and steps % k == 0,
          f"{what}: trained to step {state.step}")
    label = (f"{what}, k={k}: " + ("eager steps" if k == 1 else
                                   "the graph's warm-up and capture"))
    check_launches(counts, {n: c * (steps if k == 1 else 2 * k)
                            for n, c in per_step.items()}, label)
    replays = trainer.graph_replays[k]
    check((k == 1 and not trainer.graph_replays) or (
        dict(trainer.graph_captures) == {k: 1} and replays == steps // k),
        f"{what}: {dict(trainer.graph_captures)} captures, "
        f"{dict(trainer.graph_replays)} replays")
    out["counted"] = counts
    out["replays"] = replays
    out["launches"] = counts if k == 1 else None
    if t.profile_steps:
        n = t.profile_steps
        res = trace_summary.summarize(os.path.join(t.train_dir, "profile"),
                                      top=None)
        if not window_ok(res, n, f"{what}, k={k}", last_try):
            trainer.close()
            return None
        out["profile"] = summarize(res, n, f"{what} steps (k={k})")
        out["kernels_ms"] = res["kernels_ms"]
        out["kernel_records"] = res["kernel_records"]
        out["profile_by_kind"] = res["device_ms_by_kind"]
        records = trace_launches(res, per_step, trace)
        want = {op: c * n for op, c in per_step.items()}
        port = {name: c for name, c in res["kernel_records"].items()
                if name.startswith(tuple(
                    p for ps in {**TRACE_KERNELS, **(trace or {})}.values()
                    for p in ps))}
        print(f"{what}, k={k}: the profiler window over {n} steps holds "
              f"{records} records of the path's kernels (expected {want})")
        check(records == want and n % k == 0,
              f"{what}, k={k}: the window's records {records}, expected "
              f"{want}; the port's kernels in it: {port}")
        out["window_records"] = records
        if k > 1:
            # The warm-up ran k steps' launches (half of those counted);
            # each replay ran what a replay has in the trace.
            out["launches"] = {op: counts[op] // 2 + replays * (
                records.get(op, 0) * k // n) for op in counts}
    if timed is not None:
        a, b = timed
        out["wall_ms_per_step"] = marks[a].elapsed_time(marks[b]) / (b - a)
    with open(os.path.join(t.train_dir, "metrics.jsonl")) as fh:
        out["losses"] = {r["step"]: r["train/loss"] for r in map(json.loads, fh)
                         if "train/loss" in r}
    check(all(np.isfinite(list(out["losses"].values()))),
          f"{what}: losses {out['losses']}")
    out["params"] = host()
    print(f"{what}, k={k}: {steps} steps in {out['seconds']:.2f} s, "
          f"{replays} replays, wall "
          + (f"{out['wall_ms_per_step']:.3f} ms a step over steps "
             f"{timed[0]}-{timed[1]}" if timed else "not timed")
          + f", peak {out['peak_gb']:.2f} GB, steps' own peak "
          f"{out['step_peak_gb']:.3f} GB; losses {out['losses']}")
    trainer.close()
    return out


def spc_compare(a: dict, b: dict, what: str) -> dict:
    """The parameters of two runs from one initialization: bit-equal, or
    the largest difference within SPC_PARAM_REL of the largest change of
    ``a``'s run."""
    import torch

    pa, pb, p0 = a["params"], b["params"], a["init"]
    equal = all(torch.equal(pa[n], pb[n]) for n in pa)
    diff = max((pa[n].float() - pb[n].float()).abs().max().item()
               for n in pa)
    change = max((pa[n].float() - p0[n].float()).abs().max().item()
                 for n in pa)
    out = {"bit_equal": equal, "max_abs_diff": diff, "max_change": change,
           "limit": SPC_PARAM_REL * change}
    print(f"{what}: parameters {'bit-equal' if equal else 'differ'}; "
          f"largest difference {diff:.3e}, largest change {change:.3e}, "
          f"limit {out['limit']:.3e}")
    check(equal or diff <= out["limit"], f"{what}: {out}")
    return out


def phase_steps_per_call(report: dict, dev) -> dict:
    """``train.steps_per_call``: k training steps captured in one CUDA
    graph and replayed once a call, at full width. The main path (the
    gather-free store, K1/K3/K4/K5) eager and at each k of SPC_KS from one
    initialization, dropout 0: parameters against the eager run's, wall
    ms a step on CUDA events, a profiler window (device busy and idle
    share, checked against CUDA events); dropout on at k = 4: a checkpoint
    resumed equals the unbroken run bit for bit, and with the learning rate
    at 0 two replays on one batch give different losses (fresh masks),
    equal ones with dropout 0; ``train.remat`` on against off (dropout on,
    peak memory of each) and ``train.sort_batch_by_image`` on against off;
    stage 1 (K6/K7), the gathered path (K2/K3/K8) and the streamed loop
    (``Trainer.fit``, K1/K2/K3/K8) at k = 4 against eager, each with a
    profiler window. Launches are counted at each graph's warm-up and
    capture; a replay's launches are read from the window's trace
    (:func:`spc_run`)."""
    import itertools

    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset

    main_step = {"gru_fwd": 1, "gru_bwd": 3, "attention_resident_fwd": 2,
                 "attention_resident_bwd": 3}
    out = {}
    rate = Config().model.dropout
    k4 = SPC_KS[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spc_") as tmp:
        def cfg_of(tag, steps, **over):
            return stage2_config(os.path.join(tmp, tag), steps, **{
                "model.dropout": 0.0, "train.log_every": 4, **over})

        ds = load_dataset(cfg_of("data", SPC_STEPS), "train")

        # --- the main path: eager and graphed ------------------------------
        main = {}
        for k in (1, *SPC_KS):
            main[k] = spc_run(cfg_of(f"main_k{k}", SPC_STEPS, **{
                "train.steps_per_call": k,
                "train.profile_start": SPC_TIMED[1],
                "train.profile_steps": SPC_PROFILE_STEPS}), ds,
                "main path", main_step, timed=SPC_TIMED)
        out["main"] = {}
        for k, run in main.items():
            out["main"][k] = {key: run[key] for key in (
                "wall_ms_per_step", "launches", "counted", "replays",
                "losses", "profile", "peak_gb", "step_peak_gb", "seconds")}
            if k > 1:
                out["main"][k]["against_eager"] = spc_compare(
                    main[1], run, f"main path k={k} against eager")
        del main

        # --- dropout on, k = 4: resume across a graphed checkpoint ---------
        drop = {"train.steps_per_call": k4, "model.dropout": rate,
                "train.checkpoint_every": SPC_RESUME_AT}
        full = spc_run(cfg_of("dropout", SPC_RESUME_STEPS, **drop), ds,
                       "dropout", main_step, ckpt=True)
        resumed_dir = os.path.join(tmp, "dropout_resumed")
        os.makedirs(os.path.join(resumed_dir, "ckpt"))
        name = f"ckpt_{SPC_RESUME_AT}.pt"
        with open(os.path.join(tmp, "dropout", "ckpt", name), "rb") as src, \
                open(os.path.join(resumed_dir, "ckpt", name), "wb") as dst:
            dst.write(src.read())
        stream = ds.index_batches
        ds.index_batches = lambda *a, **kw: itertools.islice(
            stream(*a, **kw), SPC_RESUME_AT, None)
        try:
            resumed = spc_run(cfg_of("dropout_resumed", SPC_RESUME_STEPS,
                                     **drop), ds, "dropout, resumed",
                              main_step, ckpt=True, restore_at=SPC_RESUME_AT)
        finally:
            del ds.index_batches
        same = all(torch.equal(full["params"][n], resumed["params"][n])
                   for n in full["params"])
        later = {s: v for s, v in full["losses"].items() if s > SPC_RESUME_AT}
        print(f"dropout {rate}, k={k4}: resumed from step {SPC_RESUME_AT}, "
              f"parameters {'bit-equal' if same else 'DIFFER'} to the "
              f"unbroken run; losses {resumed['losses']} against {later}")
        check(same and resumed["losses"] == later,
              "a run resumed from a graphed checkpoint differs from the "
              "unbroken run")
        out["dropout_resume"] = {"bit_equal": True, "losses": full["losses"],
                                 "resumed_losses": resumed["losses"],
                                 "counted": full["counted"]}
        del full, resumed

        # --- fresh masks a replay: one batch, learning rate 0 --------------
        one = next(stream(B_TRAIN, seed=Config().train.seed))
        ds.index_batches = lambda *a, **kw: itertools.repeat(one)
        masks = {}
        try:
            for r in (rate, 0.0):
                run = spc_run(cfg_of(f"masks_{r}", 2 * k4, **{
                    "train.steps_per_call": k4, "model.dropout": r,
                    "train.learning_rate": 0.0}), ds,
                    f"one batch at lr 0, dropout {r}", main_step)
                masks[r] = [run["losses"][k4], run["losses"][2 * k4]]
        finally:
            del ds.index_batches
        print(f"two replays on one batch at lr 0: losses {masks[rate]} with "
              f"dropout {rate}, {masks[0.0]} without")
        check(masks[rate][0] != masks[rate][1]
              and masks[0.0][0] == masks[0.0][1],
              f"replays do not draw fresh masks: {masks}")
        out["replay_masks"] = {str(r): v for r, v in masks.items()}

        # --- remat on against off, k = 1, dropout on -----------------------
        remat = {}
        for on in (False, True):
            # The recompute in the backward pass launches the forward's
            # kernels (K1, K4) a second time.
            remat[on] = spc_run(cfg_of(f"remat_{on}", SPC_SIDE_STEPS, **{
                "model.dropout": rate, "train.remat": on}), ds,
                f"remat {on}", dict(main_step, **({
                    "gru_fwd": 2, "attention_resident_fwd": 4} if on
                    else {})), timed=SPC_SIDE_TIMED)
        out["remat"] = {
            "peak_gb": {str(on): remat[on]["peak_gb"] for on in remat},
            "step_peak_gb": {str(on): remat[on]["step_peak_gb"]
                             for on in remat},
            "wall_ms_per_step": {str(on): remat[on]["wall_ms_per_step"]
                                 for on in remat},
            "against_off": spc_compare(remat[False], remat[True],
                                       "remat on against off")}
        print(f"remat: peak device memory {remat[True]['peak_gb']:.3f} GB "
              f"on, {remat[False]['peak_gb']:.3f} GB off (the upload's); "
              f"the steps' own peak {remat[True]['step_peak_gb']:.3f} GB "
              f"on, {remat[False]['step_peak_gb']:.3f} GB off")
        del remat

        # --- sort_batch_by_image on against off, dropout 0 -----------------
        runs = {}
        for on in (False, True):
            runs[on] = spc_run(cfg_of(f"sort_{on}", SPC_SIDE_STEPS, **{
                "train.sort_batch_by_image": on}), ds,
                f"sort_batch_by_image {on}", main_step,
                timed=SPC_SIDE_TIMED)
        loss_diff = max(abs(runs[True]["losses"][s] - runs[False]["losses"][s])
                        for s in runs[False]["losses"])
        delta = [torch.cat([(r["params"][n] - r["init"][n]).double()
                            .flatten() for n in sorted(r["params"])])
                 for r in (runs[False], runs[True])]
        cos = torch.nn.functional.cosine_similarity(delta[0], delta[1],
                                                    0).item()
        print(f"sort_batch_by_image: losses within {loss_diff:.3e} (limit "
              f"{TOL_LOSS}), parameter changes at cosine {cos:.6f} (bound "
              f"{GRAD_COS})")
        check(loss_diff <= TOL_LOSS and cos >= GRAD_COS,
              "sort_batch_by_image changes training")
        out["sort_batch_by_image"] = {
            "loss_max_abs_diff": loss_diff, "change_cos": cos,
            "wall_ms_per_step": {str(on): runs[on]["wall_ms_per_step"]
                                 for on in runs}}
        del runs

        # --- stage 1, the gathered path and the streamed loop at k = 4 ----
        # Each run: SPC_SIDE_STEPS steps (timed between SPC_SIDE_TIMED),
        # then a profiler window over SPC_PROFILE_STEPS more.
        side = {"model.dropout": 0.0, "train.log_every": 4,
                "train.max_steps": SPC_SIDE_STEPS + SPC_PROFILE_STEPS,
                "train.profile_start": SPC_SIDE_STEPS,
                "train.profile_steps": SPC_PROFILE_STEPS}
        gathered_step = {"gru_fwd": 1, "attention_fwd": 2, "gru_bwd": 3,
                         "attention_bwd": 4}
        for tag, per_step, make, streamed in (
                ("stage1", {"bigru_fwd": 1, "bigru_bwd": 3},
                 lambda k: stage1_config(os.path.join(tmp, f"s1_k{k}"),
                                         1).replace_flat({
                     **side, "train.steps_per_call": k}), False),
                ("gathered", gathered_step,
                 lambda k: cfg_of(f"gathered_k{k}", 1, **{
                     **side, "train.resident_fused_attention": False,
                     "train.steps_per_call": k}), False),
                # Trainer.fit on host batches of the flat layout (a
                # float32 grid a question, cast to bf16 as it is staged):
                # the stacked batches go into the graph's static inputs.
                ("streamed", gathered_step,
                 lambda k: cfg_of(f"streamed_k{k}", 1, **{
                     **side, "data.synthetic_layout": "flat",
                     "data.synthetic_size": STREAM_QUESTIONS,
                     "train.device_data_cache": False,
                     "train.steps_per_call": k}), True)):
            side_ds = (load_dataset(make(1), "train", stage="vlmap_desc")
                       if tag == "stage1" else
                       load_dataset(make(1), "train") if streamed else ds)
            pair = {k: spc_run(make(k), side_ds, tag, per_step,
                               timed=SPC_SIDE_TIMED, streamed=streamed)
                    for k in (1, k4)}
            out[tag] = {
                "wall_ms_per_step": {k: r["wall_ms_per_step"]
                                     for k, r in pair.items()},
                "launches": {k: r["launches"] for k, r in pair.items()},
                "window_records": {k: r["window_records"]
                                   for k, r in pair.items()},
                "profile": {k: r["profile"] for k, r in pair.items()},
                "replays": {k: r["replays"] for k, r in pair.items()},
                "against_eager": spc_compare(pair[1], pair[k4],
                                             f"{tag} k={k4} against eager")}
            del pair, side_ds
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def md_config(tag: str, root: str, **over):
    """The main path's config for phase 24: dropout 0, the val split's
    evaluation outside the loop, a metric record every 2 steps."""
    return stage2_config(os.path.join(root, tag), MD_RANK_STEPS, **{
        "model.dropout": 0.0, "train.log_every": 2, **over})


def md_dataset(cfg, case: str):
    """Phase 24's training split with its <unk> answers (weight 0 in the
    loss) put unevenly between the data ranks, so that a mean of the
    ranks' means is not the global batch's mean: for the replicated and
    tensor-parallel runs on 3/4 of rank 0's half of each of the run's
    batches and on none of rank 1's half; for the sharded store on 70% of
    the questions whose image shard 0 holds (owner = row % MD_WORLD) and
    on none of the others."""
    import numpy as np
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.utils.vocab import UNK_ID

    ds = load_dataset(cfg, "train")
    ans = np.array(ds.arrays["answer_id"])
    known = UNK_ID + 4  # an answer in the vocabulary
    if case == "sharded":
        owner = np.asarray(ds.arrays[ds.index_key]) % MD_WORLD
        rng = np.random.default_rng(cfg.train.seed)
        ans = np.where(ans == UNK_ID, known, ans)
        ans[(owner == 0) & (rng.random(ans.size) < 0.7)] = UNK_ID
    else:
        batches = ds.index_batches(cfg.train.batch_size, seed=cfg.train.seed)
        half = cfg.train.batch_size // MD_WORLD
        for _ in range(MD_RANK_STEPS):
            b = next(batches)
            ans[b[:3 * half // 4]] = UNK_ID
            ans[b[half:]] = np.where(ans[b[half:]] == UNK_ID, known,
                                     ans[b[half:]])
    ds.arrays["answer_id"] = ans
    return ds


def md_fit(cfg, ds, val, device=None, index_batches=None) -> dict:
    """``Trainer.fit_resident`` of ``cfg`` from its seeded model on this
    process's mesh (a rank's, or one card's without a group), then the
    resident evaluator on ``val``: the launches of each (counts from 0),
    the wall ms a step between steps MD_RANK_TIMED (CUDA events), the
    losses, the whole tables' parameters, the predictions and metrics."""
    import torch
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    t = cfg.train
    spec = build_model(cfg, generator=torch.Generator().manual_seed(t.seed))
    trainer = Trainer(cfg, spec, train_dir=t.train_dir, device=device)
    state = trainer.init_state()
    init = {n: v.detach().cpu().clone()
            for n, v in trainer.full_state_dict().items()}
    marks = {}

    def mark(step, st, force=False):
        if trainer.device.type == "cuda":
            marks[step] = torch.cuda.Event(enable_timing=True)
            marks[step].record()
        return False

    trainer.ckpt.save = mark
    if index_batches is not None:
        ds.index_batches = index_batches
    reset_counts()
    try:
        state = trainer.fit_resident(ds, state)
    finally:
        if index_batches is not None:
            del ds.index_batches
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    out = {"launches": read_counts(), "mesh": str(trainer.mesh),
           "steps": state.step, "init": init}
    a, b = MD_RANK_TIMED
    out["ms_per_step"] = (marks[a].elapsed_time(marks[b]) / (b - a)
                          if marks else None)
    reset_counts()
    out["eval_metrics"], out["preds"] = trainer.evaluate_resident(state, val)
    out["eval_launches"] = read_counts()
    out["params"] = {n: v.detach().cpu().clone()
                     for n, v in trainer.full_state_dict().items()}
    if trainer.mesh.is_writer:
        with open(os.path.join(t.train_dir, "metrics.jsonl")) as fh:
            out["losses"] = {r["step"]: r["train/loss"]
                             for r in map(json.loads, fh)
                             if "train/loss" in r}
    trainer.close()
    return out


def md_rank(rank: int, world: int, port: int, case: str, device: str,
            root: str, settings: dict) -> None:
    """One rank of a phase-24 run, in a process of its own (spawned): it
    joins the gloo group on the card it shares with the other rank, runs
    ``case`` (``MD_CASES``) through :func:`md_fit` and writes its result
    under ``root``. The replicated case then checks that steps_per_call 2
    with gloo on CUDA raises ValueError naming the backend."""
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.parallel.mesh import (
        maybe_initialize_distributed)
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    globals().update(settings)  # a rehearsal's sizes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed("on", f"localhost:{port}", world, rank,
                                 backend="gloo")
    try:
        cfg = md_config(case, root, **MD_CASES[case])
        ds = md_dataset(cfg, case)
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        res = md_fit(cfg, ds, val, device=device)
        res["preds"] = res["preds"].tolist()
        if case == "replicated" and torch.device(device).type == "cuda":
            from vqa_transfer_externaldata_torch.models.zoo import (
                build_model)

            k2 = cfg.replace_flat({"train.steps_per_call": 2,
                                   "train.max_steps": 2})
            trainer = Trainer(k2, build_model(k2), device=device,
                              train_dir=os.path.join(root, "k2"))
            try:
                trainer.fit_resident(ds, trainer.init_state())
                res["gloo_k2"] = "ran"
            except ValueError as e:
                res["gloo_k2"] = str(e)
            trainer.close()
        torch.save(res, os.path.join(root, f"{case}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def md_spawn(case: str, device: str, root: str,
             settings_over: Optional[dict] = None) -> list:
    """Run ``case`` on MD_WORLD ranks (``torch.multiprocessing``, spawn);
    a rank that exits non-zero or outlives MD_JOIN_S fails the phase, and
    every rank still running is killed. ``settings_over`` replaces module
    settings in the ranks (phase 32: a float32 MODEL_OVERRIDES). Returns
    each rank's result."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    settings = {name: globals()[name] for name in (
        "B_TRAIN", "TRAIN_QUESTIONS", "VAL_QUESTIONS", "MODEL_OVERRIDES",
        "MD_RANK_STEPS", "MD_RANK_TIMED")}
    settings.update(settings_over or {})
    procs = [ctx.Process(target=md_rank, args=(
        r, MD_WORLD, port, case, device, root, settings))
        for r in range(MD_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MD_JOIN_S
    failed = None
    try:
        while failed is None:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
            elif time.monotonic() > deadline:
                failed = f"ranks still running after {MD_JOIN_S} s"
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    check(failed is None, f"multi-device {case}: {failed}")
    return [torch.load(os.path.join(root, f"{case}_rank{r}.pt"))
            for r in range(MD_WORLD)]


def md_agree(got: dict, want: dict, what: str,
             limits: tuple = (MD_TOL_LOSS, MD_GRAD_COS)) -> dict:
    """Two runs of one initialization on the same batches whose sums ran in
    another order: their logged losses within ``limits``' loss (MD_TOL_LOSS)
    and their parameter changes (all parameters as one vector) at its
    cosine (MD_GRAD_COS) or more."""
    tol_loss, grad_cos = limits
    import torch

    loss_diff = max(abs(got["losses"][s] - want["losses"][s])
                    for s in want["losses"])
    delta = [torch.cat([(r["params"][n] - r["init"][n]).double().flatten()
                        for n in sorted(r["params"])]) for r in (got, want)]
    cos = torch.nn.functional.cosine_similarity(delta[0], delta[1], 0).item()
    diff = max((got["params"][n].float() - want["params"][n].float())
               .abs().max().item() for n in want["params"])
    print(f"{what}: losses within {loss_diff:.3e} (limit {tol_loss}), "
          f"parameter changes at cosine {cos:.9f} (bound {grad_cos}), "
          f"largest parameter difference {diff:.3e}")
    check(sorted(got["losses"]) == sorted(want["losses"])
          and loss_diff <= tol_loss and cos >= grad_cos,
          f"{what}: the runs disagree")
    return {"loss_max_abs_diff": loss_diff, "change_cos": cos,
            "param_max_abs_diff": diff, "limits": list(limits)}


def md_eval_reference(params: dict, val, root: str, tag: str,
                      batch: int, device) -> list:
    """The resident evaluator of one process (no group) on ``params`` at
    ``batch`` questions a batch: a data rank's shapes, so each question's
    forward is the same computation as on the ranks."""
    import torch
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    cfg = md_config(tag, root, **{"train.batch_size": batch})
    trainer = Trainer(cfg, build_model(cfg), train_dir=cfg.train.train_dir,
                      device=device)
    state = trainer.init_state(params)
    _, preds = trainer.evaluate_resident(state, val)
    trainer.close()
    return preds.tolist()


def phase_multi_device(report: dict, dev) -> dict:
    """Multi-device training on the one card (ROADMAP item 12), at full
    width on the main corpus (batch 256, the gather-free path: K1, K3, K4,
    K5), dropout 0.

    (a) World 1 under NCCL: this process joins a one-rank group, so every
    collective of the distributed path runs (the weight and gradient
    all-reduces, the broadcast); ``fit_resident`` eagerly and at
    ``steps_per_call`` MD_K (the graph holds the NCCL all-reduce), each
    against the same run without a group: parameters bit-equal; the wall
    ms a step and a profiler window whose records are checked and whose
    NCCL kernels give the all-reduce's device time a step.

    (b) World 2 sharing the card under gloo (NCCL refuses two ranks on one
    card): two spawned ranks on it, MD_RANK_STEPS steps at k = 1, for the
    replicated store (against one process), ``train.store_sharded``
    (against one process's replicated store fed the same per-shard index
    stream) and a 1x2 tensor-parallel mesh with ``shard_params
    answer_embedding,word_emb`` (against the 2x1 replicated run): losses
    and parameter changes as :func:`md_agree`, each rank's launches
    launches-a-step x steps (and its evaluation's), its wall ms a step
    (two processes on one card's SMs: no scaling figure), and the resident
    evaluator's predictions equal to one process's on the same parameters
    at a rank's batch shape. steps_per_call 2 with gloo on CUDA raises."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_md_") as tmp:
        out = {"world1": md_world1(tmp), "world2": md_world2(tmp, dev)}
    out["launches"] = {
        f"multi_device_world1_k{k}": out["world1"][f"k{k}"]["launches"]
        for k in (1, MD_K)}
    for case in MD_CASES:
        for r, counts in enumerate(out["world2"][case]["launches"]):
            out["launches"][f"multi_device_{case}_rank{r}"] = counts
    return out


MD_MAIN_STEP = {"gru_fwd": 1, "gru_bwd": 3, "attention_resident_fwd": 2,
                "attention_resident_bwd": 3}


def md_world1(tmp: str, over: Optional[dict] = None,
              per_step: dict = MD_MAIN_STEP) -> dict:
    """Phase 24 (a): the main path in a one-rank NCCL group against the
    same runs without a group, eagerly and at k = MD_K; ``over`` changes
    the config (phase 32: the model's dtype), whose path launches
    ``per_step`` a step."""
    import torch
    import torch.distributed as dist
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.parallel.mesh import (
        maybe_initialize_distributed)

    out = {}

    def w1_cfg(tag, k):
        return stage2_config(os.path.join(tmp, tag), MD_STEPS, **{
            **(over or {}), "model.dropout": 0.0, "train.log_every": 4,
            "train.steps_per_call": k,
            "train.profile_start": MD_PROFILE[0],
            "train.profile_steps": MD_PROFILE[1] - MD_PROFILE[0]})

    ds = load_dataset(w1_cfg("data", 1), "train")
    runs = {}
    for group in (False, True):
        if group:
            check(maybe_initialize_distributed(
                "on", f"localhost:{free_port()}", 1, 0, backend="nccl"),
                "the NCCL group did not start")
        for k in (1, MD_K):
            what = f"world 1, {'NCCL group' if group else 'no group'}"
            runs[group, k] = spc_run(w1_cfg(f"w1_{group}_{k}", k), ds,
                                     what, per_step, timed=MD_TIMED)
    dist.destroy_process_group()
    for k in (1, MD_K):
        a, b = runs[False, k], runs[True, k]
        equal = all(torch.equal(a["params"][n], b["params"][n])
                    for n in a["params"])
        nccl = {n: ms for n, ms in b["kernels_ms"].items()
                if "nccl" in n.lower()}
        n_win = MD_PROFILE[1] - MD_PROFILE[0]
        res = {"bit_equal": equal,
               "wall_ms_per_step": {"no_group": a["wall_ms_per_step"],
                                    "nccl_world1": b["wall_ms_per_step"]},
               "allreduce_device_ms_per_step": sum(nccl.values()) / n_win,
               "nccl_kernels_ms": nccl,
               "device_ms_by_kind": b["profile_by_kind"],
               "nccl_records": {n: c for n, c in
                                b["kernel_records"].items()
                                if "nccl" in n.lower()},
               "profile": {"no_group": a["profile"],
                           "nccl_world1": b["profile"]},
               "launches": b["launches"], "losses": b["losses"]}
        print(f"world 1, k={k}: NCCL group against none: parameters "
              f"{'bit-equal' if equal else 'DIFFER'}; wall "
              f"{b['wall_ms_per_step']:.3f} ms a step against "
              f"{a['wall_ms_per_step']:.3f}; all-reduce device time "
              f"{res['allreduce_device_ms_per_step']:.4f} ms a step "
              f"({nccl})")
        check(equal and b["losses"] == a["losses"],
              f"world 1 under NCCL, k={k}: parameters or losses differ "
              "from the run without a group")
        out[f"k{k}"] = res
    return out


def md_world2(tmp: str, dev) -> dict:
    """Phase 24 (b): the replicated, sharded and tensor-parallel runs on
    MD_WORLD gloo ranks sharing the card, each against its one-process
    reference."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.parallel.trainer import (
        sharded_index_batches)

    out = {}
    device = str(torch.device(dev.type, 0) if dev.type == "cuda" else dev)
    ref_cfg = md_config("ref_data", tmp)
    ds, ds_sh = md_dataset(ref_cfg, "replicated"), md_dataset(ref_cfg,
                                                               "sharded")
    val = load_dataset(ref_cfg.replace_flat(
        {"data.synthetic_size": VAL_QUESTIONS}), "val")
    owner = np.asarray(ds_sh.arrays[ds_sh.index_key]) % MD_WORLD
    eval_batches = {
        "replicated": -(-VAL_QUESTIONS // B_TRAIN),
        "tp": -(-VAL_QUESTIONS // B_TRAIN),
        "sharded": max(-(-int((np.asarray(val.arrays[val.index_key])
                               % MD_WORLD == d).sum())
                         // (B_TRAIN // MD_WORLD))
                       for d in range(MD_WORLD))}
    results = {}
    for case in MD_CASES:
        ranks = md_spawn(case, device, tmp)
        results[case] = ranks[0]
        for r, res in enumerate(ranks):
            want = {op: c * MD_RANK_STEPS for op, c in MD_MAIN_STEP.items()}
            check_launches(res["launches"], want,
                           f"{case}, rank {r} of {MD_WORLD}")
            check_launches(res["eval_launches"], {
                "gru_fwd": eval_batches[case],
                "attention_resident_fwd": 2 * eval_batches[case]},
                f"{case} evaluation, rank {r}")
            check(res["preds"] == ranks[0]["preds"],
                  f"{case}: the ranks' predictions differ")
        out[case] = {
            "mesh": [res["mesh"] for res in ranks],
            "ms_per_step": [res["ms_per_step"] for res in ranks],
            "launches": [res["launches"] for res in ranks],
            "eval_launches": [res["eval_launches"] for res in ranks],
            "losses": ranks[0]["losses"],
            "eval_metrics": ranks[0]["eval_metrics"]}
        print(f"{case} on {MD_WORLD} ranks sharing the card: "
              f"{[res['mesh'] for res in ranks]}, wall ms a step "
              f"{[res['ms_per_step'] for res in ranks]}, losses "
              f"{ranks[0]['losses']}")
        if case == "replicated" and dev.type == "cuda":
            msg = ranks[0]["gloo_k2"]
            print(f"steps_per_call 2 under gloo on CUDA: {msg}")
            check("gloo" in msg and msg != "ran",
                  f"steps_per_call 2 under gloo on CUDA: {msg}")
            out["gloo_k2_raises"] = msg
    # One process: the replicated run, and the replicated store fed
    # the sharded run's per-shard stream.
    one = md_fit(md_config("one", tmp), ds, val, device=dev)
    fed = md_fit(md_config("one_fed", tmp), ds_sh, val, device=dev,
                 index_batches=lambda bs, seed=0, **kw:
                 sharded_index_batches(owner, MD_WORLD, bs // MD_WORLD,
                                       seed))
    for case, ref, what in (
            ("replicated", one, "one process"),
            ("sharded", fed, "one process's replicated store fed the "
             "same per-shard stream"),
            ("tp", results["replicated"], "the 2x1 replicated run")):
        got = results[case]
        out[case]["against"] = what
        out[case].update(md_agree(
            got, ref, f"{case} on {MD_WORLD} ranks against {what}"))
        batch = B_TRAIN if case == "tp" else B_TRAIN // MD_WORLD
        want = md_eval_reference(got["params"], val, tmp,
                                 f"eval_{case}", batch, dev)
        same = got["preds"] == want
        print(f"{case}: the resident evaluator's predictions "
              f"{'equal' if same else 'DIFFER from'} one process's on "
              f"the same parameters at batch {batch} "
              f"({sum(a != b for a, b in zip(got['preds'], want))} of "
              f"{len(want)} differ)")
        check(same, f"{case}: resident evaluation differs")
        out[case]["preds_equal"] = same
    out["one_process_ms_per_step"] = one["ms_per_step"]
    return out


def profiled(fn, runs: int, top: Optional[int] = 20) -> dict:
    """``fn()`` (``runs`` calls' worth of work) in a
    ``utils.tracing.TraceWindow`` (torch.profiler, CUDA events around it):
    its trace written to a temporary directory and read by the port's
    ``tools/trace_summary`` (the one reader of traces), with the events'
    time for its check of lost device records."""
    import torch
    from vqa_transfer_externaldata_torch.tools import trace_summary
    from vqa_transfer_externaldata_torch.utils import tracing

    window = tracing.TraceWindow(
        torch.device("cuda", torch.cuda.current_device()))
    window.open()
    fn()
    event_ms = window.close()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = tracing.write_trace(window.prof, tmp, "calls")
        return trace_summary.summarize(path, steps=runs, top=top,
                                       cuda_event_ms=event_ms)


def summarize(res: dict, n: int, what: str) -> dict:
    """A trace summary (``tools/trace_summary``) of ``n`` calls or steps a
    call at a time: wall (the trace's window), device busy and idle share,
    the top kernels and host ops by self time, and the check of lost
    device events against CUDA events."""
    lost = res["lost_events"]
    busy = res["device_busy_ms"]
    out = {"calls": n, "wall_ms_per_call": res["window_ms"] / n,
           "kernel_ms_per_call": None if busy is None else busy / n,
           "device_idle_share": res["device_idle_share"],
           "top_kernels_us_per_call": {
               k: v * 1e3 / n for k, v in list(res["kernels_ms"].items())[:20]},
           "top_host_ops_self_us_per_call": {
               k: v * 1e3 / n
               for k, v in list(res["host_ops_self_ms"].items())[:8]},
           "cuda_event_ms_per_call": (None if res["cuda_event_ms"] is None
                                      else res["cuda_event_ms"] / n),
           "lost_events": lost,
           "unmatched_launches": res["unmatched_by_op"],
           "unmatched_at_ms": res["unmatched_at_ms"],
           "clock_gap_ms": res["clock_gap_ms"],
           "lost_before_window": res["lost_before_window"]}
    print(f"profile of {n} {what}: {json.dumps(out)}")
    return out


def profile_calls(fn, n: int = 5, what: str = "requests") -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler,
    read by ``tools/trace_summary``), and the share of the window in which
    no kernel ran; a window that lost device records is taken again,
    once."""
    fn()

    def calls():
        for _ in range(n):
            fn()

    for last_try in (False, True):
        res = profiled(calls, n)
        if window_ok(res, n, what, last_try):
            break
    return summarize(res, n, what)


def kernel_device_ms(fn, prefix: str, buf, runs: int = RUNS) -> float:
    """Device ms a call of ``fn`` spends in the kernels whose name starts
    with ``prefix`` (torch.profiler, read by ``tools/trace_summary``), L2
    flushed before each of ``runs`` calls, after warm-up."""
    return split_device_ms(fn, {prefix: prefix}, buf, runs)[prefix]


def split_device_ms(fn, parts: dict, buf, runs: int = RUNS) -> dict:
    """Device ms a call of ``fn`` spends in each of ``parts`` ({label:
    kernel-name prefix}), from one profile of ``runs`` calls, L2 flushed
    before each, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(runs):
            flush_l2(buf)
            fn()

    for last_try in (False, True):
        res = profiled(calls, runs, top=None)
        names = {label: [k for k in res["kernels_ms"] if k.startswith(pre)]
                 for label, pre in parts.items()}
        records = {label: sum(res["kernel_records"][k] for k in ks)
                   for label, ks in names.items()}
        # Each call's launches of a part's kernels have their records: the
        # same number a call (a lost record elsewhere in the window does
        # not touch these sums; one of its own does). A window that lost
        # some is taken again, once.
        msg = (f"the profile of {list(parts.values())} holds {records} "
               f"records over {runs} calls (lost: {res['unmatched_by_op']} "
               f"at {res['unmatched_at_ms']} ms of a {res['window_ms']:.3f} "
               f"ms window, clock gap {res['clock_gap_ms']} ms, "
               f"{res['lost_before_window']} settling launches lost)")
        if all(n and n % runs == 0 for n in records.values()):
            print(f"profile of {list(parts.values())}: {records} records "
                  f"over {runs} calls, clock gap {res['clock_gap_ms']} ms, "
                  f"{res['lost_before_window']} settling launches lost")
            break
        print(msg + ("" if last_try else "; profiling again"))
        check(not last_try, msg + ", twice")
    return {label: sum(res["kernels_ms"][k] for k in ks) / runs
            for label, ks in names.items()}


def window_ok(res: dict, steps: int, what: str, last_try: bool) -> bool:
    """Whether a profiler window's summary holds ``steps`` steps of device
    work with no lost device record. A window that lost records is
    reported, and fails the phase on its last try."""
    check(res["steps"] == steps and (res["lost_events"]
                                     or res["device_busy_ms"] is not None),
          f"{what}: the profile holds {res['steps']} steps and no device "
          f"work: {res}")
    if not res["lost_events"]:
        return True
    print(f"{what}: the profiler window lost device records "
          f"({res['unmatched_launches']} launches without one, "
          f"{res['unmatched_by_op']}; window {res['window_ms']:.3f} ms "
          f"against {res['cuda_event_ms']} ms on CUDA events, clock gap "
          f"{res['clock_gap_ms']} ms, {res['lost_before_window']} settling "
          "launches lost)"
          + ("" if last_try else "; profiling again"))
    check(not last_try, f"{what}: the profiler window lost device records "
          "twice")
    return False


def profile_fit(trainer, ds, state, steps: int) -> tuple:
    """Profile ``Trainer.fit_resident`` over ``steps`` more steps through
    its own profiler window (``train.profile_start`` at the run's first
    step, ``train.profile_steps`` = ``steps``), read by
    ``tools/trace_summary`` with its check against CUDA events. The upload
    of the store comes first and is left out: the window opens at the
    first step's dispatch boundary, after the device has drained, and
    closes when the last step's work is done. The run's closing
    checkpoint write is left out (not a step's work). A window that lost
    device records is taken again over the next ``steps`` steps, once."""
    from vqa_transfer_externaldata_torch.tools import trace_summary

    cfg, save = trainer.cfg, trainer.ckpt.save
    trainer.ckpt.save = lambda *a, **kw: False
    try:
        for last_try in (False, True):
            trainer.cfg = cfg.replace_flat({
                "train.profile_start": state.step,
                "train.profile_steps": steps})
            state = trainer.fit_resident(ds, state,
                                         max_steps=state.step + steps)
            res = trace_summary.summarize(
                os.path.join(trainer.train_dir, "profile"), top=None)
            if window_ok(res, steps, "fit_resident steps", last_try):
                break
    finally:
        trainer.cfg, trainer.ckpt.save = cfg, save
    return state, summarize(res, steps, "fit_resident steps")


def k1_bound(lens) -> tuple:
    """K1's (and K1h's) bound at this run's lengths, and its live
    row-steps: the row-steps that the lengths need read gx once; hseq
    [T, B, H] and hT are written once; one [H] x [H, 3H] product a carried
    row-step."""
    nlen, nb = int(lens.sum().item()), lens.shape[0]
    return bound(nlen * 3 * H * 4 + nb * 4 + H * 3 * H * 2 + H * 4
                 + T * nb * H * 4 + nb * H * 4,
                 2 * carried_steps(lens) * H * 3 * H), nlen


def k3_bound(lens) -> tuple:
    """K3's (and K3h's) bound: the live row-steps of this run's lengths
    read gx and hseq once; dgx [T, B, 3H] and dU_h are written once. Each
    carried row-step takes three [H] x [H, 3H] products: the recomputed
    gh, the U_h^T product and its share of dU_h."""
    nl, nb = int(lens.sum().item()), lens.shape[0]
    return bound(nl * 4 * H * 4 + nb * 4 + H * 3 * H * 2 + H * 4
                 + nb * H * 4 + T * nb * 3 * H * 4 + H * 3 * H * 4 + H * 4,
                 3 * 2 * carried_steps(lens) * H * 3 * H)


def k45_bounds(G: int, Bt: int, Np: int, nv: int, row_bytes: int) -> tuple:
    """K4's and K5's (and K4h's and K5h's) bounds with G glimpses over Bt
    questions of nv valid cells (Np a store row): each store row that the
    batch names is read once (``row_bytes``: rows repeat), and the GEMMs
    run over the valid cells only: the score GEMM (or dW_v) once,
    2 B n C H, then per glimpse the weighted sum (or dalpha), 2 B n C, and
    the score (or dz and dws), 2 (4) B n H."""
    k4_bytes = (row_bytes + Bt * 4 + Bt * H * 4 + C * H * 2 + G * H * 4
                + Bt * G * C * 4 + Bt * Np * G * 4 + Bt * Np * H * 2)
    k4_flops = 2 * Bt * nv * C * (H + G) + 2 * G * Bt * nv * H
    k5_bytes = (row_bytes + Bt * 4 + Bt * Np * H * 2 + G * H * 4
                + 2 * Bt * Np * G * 4 + Bt * G * C * 4 + Bt * H * 4
                + C * H * 4 + G * H * 4)
    k5_flops = 2 * Bt * nv * C * (H + G) + 4 * G * Bt * nv * H
    return bound(k4_bytes, k4_flops), bound(k5_bytes, k5_flops)


def k2_bound(batch: int) -> tuple:
    """K2's (and K2h's) bound over ``batch`` questions of N cells: v, qh,
    W_v and ws read once, v_att and alpha written once; the score GEMM and
    the weighted sum."""
    return bound(batch * N * C * 2 + batch * H * 4 + C * H * 2 + H * 4
                 + batch * C * 4 + batch * N * 4,
                 2 * batch * N * C * H + 2 * batch * N * C)


def k8_bound(batch: int) -> tuple:
    """K8's (and K8h's) bound: each input read once (v, qh, W_v, ws, ds,
    r), each output written once; z recomputed and the dW_v GEMM, 2 B N C
    H operations each, plus the elementwise dz, dqh and dws (a few per
    unit)."""
    return bound(batch * N * C * 2 + batch * H * 4 + C * H * 2 + H * 4
                 + 2 * batch * N * 4 + batch * H * 4 + C * H * 4 + H * 4,
                 2 * 2 * batch * N * C * H + 6 * batch * N * H)


def k67_bounds(lens) -> tuple:
    """K6's and K7's (and K6h's and K7h's) bounds at this run's lengths,
    both chains: each reads its live rows of gx and U_h, b_hn once and
    writes its hseq and hT (K6), or reads gx and hseq over its live rows
    and writes dgx, dU_h and db_hn (K7); lens is read once. Operations as
    K1's and K3's for each direction, over its carried row-steps."""
    nb, nl, nc = lens.shape[0], int(lens.sum().item()), carried_steps(lens)
    k6_bytes = nb * 4 + 2 * (nl * 3 * H * 4 + H * 3 * H * 2 + H * 4
                             + T * nb * H * 4 + nb * H * 4)
    k7_bytes = nb * 4 + 2 * (nl * 4 * H * 4 + H * 3 * H * 2 + H * 4
                             + nb * H * 4 + T * nb * 3 * H * 4
                             + H * 3 * H * 4 + H * 4)
    return (bound(k6_bytes, 2 * 2 * nc * H * 3 * H),
            bound(k7_bytes, 2 * 3 * 2 * nc * H * 3 * H))


def phase_times(report: dict, k1: dict, k2: dict, k3: dict, k45: dict,
                k45g: dict, k45q: dict, k67: dict, k8: dict, dev) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru, kernels)

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    times = {}
    # Library yardstick of K1: cuDNN GRU over packed sequences. It also does
    # the input projection x @ W_x, which the kernel receives done.
    lib_gru = torch.nn.GRU(D, H).to(dev, torch.bfloat16)
    lib_gru.flatten_parameters()

    def time_k1(k: dict) -> dict:
        gx, lens, uh, bhn = k["gx"], k["lens"], k["uh"], k["bhn"]
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            torch.randn(T, lens.shape[0], D, device=dev,
                        dtype=torch.bfloat16), lens.cpu(),
            enforce_sorted=False)
        with torch.inference_mode():
            lib_ms = time_cuda(lambda: lib_gru(packed), buf)
        # One step alone (the launch, U_h's load, one step): what the other
        # T - 1 steps add is the time of a step.
        ms = time_cuda(lambda: gru.gru_fwd(gx, lens, uh, bhn), buf)
        ms1 = time_cuda(lambda: gru.gru_fwd(gx[:1], lens, uh, bhn), buf)
        return {
            "kernel": ms, "one_step_ms": ms1,
            "step_us": (ms - ms1) / (T - 1) * 1e3,
            "plain": time_cuda(lambda: gru.gru_reference(gx, lens, uh, bhn),
                               buf),
            "library": lib_ms,
            "library_call": f"torch.nn.GRU({D}, {H}) in bfloat16 over a "
                            "packed sequence, input projection included",
        }

    # K1 at the training batch (the path that launches it most), and at the
    # serving batch.
    times["gru_fwd"] = time_k1(k3)
    k1_serving = time_k1(k1)
    # K1's two tilings at a single request, cli.predict's batch, the
    # serving and the training batch: the plan's rows against the other's,
    # which must give the same bits.
    tilings = {}
    for batch in (1, 8, B, B_TRAIN):
        gxb = torch.randn(T, batch, 3 * H, device=dev) * 0.5
        lensb = torch.randint(1, T + 1, (batch,), device=dev,
                              dtype=torch.int32)
        plan = gru.gru_fwd_launch_config(batch, H, dev)
        row = {"plan_rows": plan["rows"]}
        outs = {}
        for rows in kernels.GRU_FWD_ROWS:
            if plan["per_sm_by_rows"][rows] < 1:
                continue
            outs[rows] = gru._launch_fwd(gxb, lensb, k3["uh"], k3["bhn"],
                                         False, rows)[1]
            row[str(rows)] = time_cuda(
                lambda: gru._launch_fwd(gxb, lensb, k3["uh"], k3["bhn"],
                                        False, rows), buf)
        check(all(torch.equal(o, outs[plan["rows"]]) for o in outs.values()),
              f"K1's tilings disagree at B={batch}")
        tilings[str(batch)] = row
    times["gru_fwd"]["tilings_ms"] = tilings

    v, qh, wv, ws = k2["v"], k2["qh"], k2["wv"], k2["ws"]
    times["attention_fwd"] = {
        "kernel": time_cuda(
            lambda: attention.attention_fwd(v, qh, wv, ws, normalize=True),
            buf),
        "plain": time_cuda(
            lambda: attention.attention_fwd_reference(v, qh, wv, ws, True),
            buf),
        "library": None,
        "score_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v, qh, wv, ws, normalize=True), SCORE_KERNEL, buf),
    }
    # K2 at the Predictor's default batch: the first questions of the same
    # inputs.
    v1, qh1 = v[:B_PREDICT].contiguous(), qh[:B_PREDICT].contiguous()
    times["attention_fwd"]["at_predict_batch"] = {
        "batch": B_PREDICT,
        "ms": time_cuda(lambda: attention.attention_fwd(
            v1, qh1, wv, ws, normalize=True), buf),
        "score_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v1, qh1, wv, ws, normalize=True), SCORE_KERNEL, buf)}

    # K3 at the training shape, forward direction.
    gx3, hseq3, lens3 = k3["gx"], k3["hseq"], k3["lens"]
    uh3, bhn3, ghT3 = k3["uh"], k3["bhn"], k3["ghT"]
    times["gru_bwd"] = {
        "kernel": time_cuda(
            lambda: gru.gru_bwd(gx3, hseq3, lens3, uh3, bhn3, ghT3), buf),
        "plain": time_cuda(
            lambda: gru.gru_bwd_reference(gx3, hseq3, lens3, uh3, bhn3, ghT3),
            buf),
    }
    # Library yardstick: the backward of cuDNN's GRU over the same packed
    # lengths, which also takes the input projection's gradients (dx,
    # dW_x, db_x) that K3 leaves to the caller.
    lib3 = torch.nn.GRU(D, H).to(dev, torch.bfloat16)
    lib3.flatten_parameters()
    x3 = torch.randn(T, B_TRAIN, D, device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    _, h_n = lib3(torch.nn.utils.rnn.pack_padded_sequence(
        x3, lens3.cpu(), enforce_sorted=False))
    wrt = [x3, *lib3.parameters()]
    g_n = torch.randn_like(h_n)
    times["gru_bwd"]["library"] = time_cuda(
        lambda: torch.autograd.grad(h_n, wrt, g_n, retain_graph=True), buf)
    times["gru_bwd"]["library_call"] = (
        f"backward of torch.nn.GRU({D}, {H}) in bfloat16 over a packed "
        "sequence, input-projection gradients included")
    st, rows, nv = k45["store"], k45["rows"], k45["n_valid"]
    qh4, wv4, ws4 = k45["qh"], k45["wv"], k45["ws"]
    h5, al5, g5, sga5 = k45["h"], k45["alpha"], k45["g"], k45["sga"]
    kw = dict(n_valid=nv, normalize=False)  # the main path's mode
    times["attention_resident_fwd"] = {
        "kernel": time_cuda(lambda: ar.attention_resident_fwd(
            st, rows, qh4, wv4, ws4, save_h=True, **kw), buf),
        "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
            st, rows, qh4, wv4, ws4, save_h=True, **kw), buf),
        "library": None,
    }
    # The score launch alone, from the profiler over the same calls.
    times["attention_resident_fwd"]["score"] = kernel_device_ms(
        lambda: ar.attention_resident_fwd(st, rows, qh4, wv4, ws4,
                                          save_h=True, **kw),
        SCORE_KERNEL, buf)
    times["attention_resident_bwd"] = {
        "kernel": time_cuda(lambda: ar.attention_resident_bwd(
            st, rows, h5, ws4, al5, g5, sga5, **kw), buf),
        "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
            st, rows, h5, ws4, al5, g5, sga5, **kw), buf),
        "library": None,
    }

    # K4/K5 at G=2 (the glimpses2 path) on the same store and rows.
    ws2, h2, al2, g2, sga2 = (k45g[k] for k in ("ws", "h", "alpha", "g",
                                                "sga"))
    g2_times = {
        "attention_resident_fwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_fwd(
                st, rows, qh4, wv4, ws2, save_h=True, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
                st, rows, qh4, wv4, ws2, save_h=True, **kw), buf),
            "library": None},
        "attention_resident_bwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_bwd(
                st, rows, h2, ws2, al2, g2, sga2, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
                st, rows, h2, ws2, al2, g2, sga2, **kw), buf),
            "library": None},
    }

    times["gru_fwd"]["bound"], nlen = k1_bound(k3["lens"])
    k1_serving["bound"], nlen_serving = k1_bound(k1["lens"])
    times["gru_fwd"]["at_serving_batch"] = k1_serving

    times["attention_fwd"]["bound"] = k2_bound(B)
    Bt, nl3 = B_TRAIN, int(lens3.sum().item())
    times["gru_bwd"]["bound"] = k3_bound(lens3)
    # K4/K5 with G glimpses: each store row that the batch names is read
    # once (rows repeat), and the GEMMs run over the valid cells only: the
    # score GEMM (or dW_v) once, 2 B n C H, then per glimpse the weighted
    # sum (or dalpha), 2 B n C, and the score (or dz and dws), 2 (4) B n H.
    Np = st.shape[1]
    uniq = int(torch.unique(rows).numel())
    row_bytes = uniq * Np * C * 2

    # K4/K5 at G=1 on int8 rows: the codes of the same store, same rows.
    cq, wvq = k45q["codes"], k45q["wv"]
    wsq, hq, alq, gq, sgaq = (k45q[k] for k in ("ws", "h", "alpha", "g",
                                                "sga"))
    q_times = {
        "attention_resident_fwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_fwd(
                cq, rows, qh4, wvq, wsq, save_h=True, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
                cq, rows, qh4, wvq, wsq, save_h=True, **kw), buf),
            "score": kernel_device_ms(lambda: ar.attention_resident_fwd(
                cq, rows, qh4, wvq, wsq, save_h=True, **kw),
                SCORE_KERNEL, buf),
            "library": None},
        "attention_resident_bwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_bwd(
                cq, rows, hq, wsq, alq, gq, sgaq, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
                cq, rows, hq, wsq, alq, gq, sgaq, **kw), buf),
            "library": None},
    }

    (times["attention_resident_fwd"]["bound"],
     times["attention_resident_bwd"]["bound"]) = k45_bounds(1, Bt, Np, nv,
                                                            row_bytes)
    (g2_times["attention_resident_fwd"]["bound"],
     g2_times["attention_resident_bwd"]["bound"]) = k45_bounds(2, Bt, Np, nv,
                                                               row_bytes)
    (q_times["attention_resident_fwd"]["bound"],
     q_times["attention_resident_bwd"]["bound"]) = k45_bounds(
         1, Bt, Np, nv, uniq * Np * C)  # one byte a code
    for name, t in g2_times.items():
        times[name]["at_g2"] = t
        times[f"{name}[int8]"] = q_times[name]
    # The score GEMM's rate: 2 B n C H operations over the valid cells.
    score_flops = 2 * Bt * nv * C * H
    for name in ("attention_resident_fwd", "attention_resident_fwd[int8]"):
        times[name]["score_tflops"] = (
            score_flops / (times[name]["score"] * 1e-3) / 1e12)
        print(f"{name} score launch at G=1: {times[name]['score']:.4f} ms, "
              f"{times[name]['score_tflops']:.1f} TFLOP/s")

    # K6/K7 at the stage-1 shape. Library yardstick: cuDNN's bidirectional
    # GRU over the same packed lengths, forward, and the backward with the
    # input projection's gradients, which the kernels leave to the caller.
    args, bargs = k67["args"], k67["bargs"]
    lens6 = args[2]
    lib6 = torch.nn.GRU(D, H, bidirectional=True).to(dev, torch.bfloat16)
    lib6.flatten_parameters()
    x6 = torch.randn(T, B_TRAIN, D, device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    packed6 = torch.nn.utils.rnn.pack_padded_sequence(
        x6, lens6.cpu(), enforce_sorted=False)
    with torch.inference_mode():
        lib6_ms = time_cuda(lambda: lib6(packed6), buf)
    _, h6 = lib6(packed6)
    wrt6 = [x6, *lib6.parameters()]
    g6 = torch.randn_like(h6)
    # K6 beside two K1 calls on the same inputs, in turns (K6, two K1, two
    # K1, K6): both run the persistent forward body, K6 both chains in one
    # launch of 2 b-tiles a block, K1 one chain a launch of 1.
    gxf6, gxb6, _, uhf6, uhb6, bhnf6, bhnb6 = args

    def k6_call():
        gru.bigru_fwd(*args)

    def two_k1():
        gru.gru_fwd(gxf6, lens6, uhf6, bhnf6)
        gru.gru_fwd(gxb6, lens6, uhb6, bhnb6, reverse=True)

    turns6 = [time_cuda(f, buf) for f in (k6_call, two_k1, two_k1, k6_call)]
    # K6's two tilings at cli.predict's batch, the serving and the stage-1
    # batch: the plan's rows against the other's, which must give the same
    # bits.
    tilings6 = {}
    for batch in (8, B, B_TRAIN):
        bargs6 = [torch.randn(T, batch, 3 * H, device=dev) * 0.5
                  for _ in range(2)]
        lensb = torch.randint(1, T + 1, (batch,), device=dev,
                              dtype=torch.int32)
        args_b = (bargs6[0], bargs6[1], lensb, uhf6, uhb6, bhnf6, bhnb6)
        plan = gru.bigru_fwd_launch_config(batch, H, dev)
        row = {"plan_rows": plan["rows"]}
        outs = {}
        for tiling in kernels.GRU_FWD_ROWS:
            if plan["per_sm_by_rows"][tiling] < 1:
                continue
            outs[tiling] = gru._launch_bigru_fwd(*args_b, tiling)
            row[str(tiling)] = time_cuda(
                lambda: gru._launch_bigru_fwd(*args_b, tiling), buf)
        check(all(torch.equal(a, b) for o in outs.values()
                  for a, b in zip(o, outs[plan["rows"]])),
              f"K6's tilings disagree at B={batch}")
        tilings6[str(batch)] = row
    times["bigru_fwd"] = {
        "kernel": (turns6[0] + turns6[3]) / 2,
        "two_k1": (turns6[1] + turns6[2]) / 2,
        "tilings_ms": tilings6,
        "plain": time_cuda(lambda: gru.bigru_reference(*args), buf),
        "library": lib6_ms,
        "library_call": f"torch.nn.GRU({D}, {H}, bidirectional=True) in "
                        "bfloat16 over a packed sequence, input projection "
                        "included",
    }
    # K7 beside two K3 calls on the same inputs, in turns (K7, two K3, two
    # K3, K7): both run the persistent BPTT body, K7 both chains in one
    # launch of 2 b-tiles a block, K3 one chain a launch of 1.
    (gxf, gxb, hsf, hsb, lens7, uhf, uhb, bhnf, bhnb, ghTf, ghTb) = bargs

    def k7_call():
        gru.bigru_bwd(*bargs)

    def two_k3():
        gru.gru_bwd(gxf, hsf, lens7, uhf, bhnf, ghTf)
        gru.gru_bwd(gxb, hsb, lens7, uhb, bhnb, ghTb, reverse=True)

    turns = [time_cuda(f, buf) for f in (k7_call, two_k3, two_k3, k7_call)]
    times["bigru_bwd"] = {
        "kernel": (turns[0] + turns[3]) / 2,
        "two_k3": (turns[1] + turns[2]) / 2,
        "plain": time_cuda(lambda: gru.bigru_bwd_reference(*bargs), buf),
        "library": time_cuda(lambda: torch.autograd.grad(
            h6, wrt6, g6, retain_graph=True), buf),
        "library_call": f"backward of torch.nn.GRU({D}, {H}, "
                        "bidirectional=True) in bfloat16 over a packed "
                        "sequence, input-projection gradients included",
    }
    times["bigru_fwd"]["bound"], times["bigru_bwd"]["bound"] = k67_bounds(
        lens6)
    # K8 at the gathered training shape (normalize on, the main path's
    # mode). Beside it: the op's whole backward with K8 (the score
    # cotangent from one bf16 batched GEMV, then K8) and with the explicit
    # math instead (bwd_kernel=False): the H100 A/B of the default.
    v8, qh8, wv8, ws8 = k8["v"], k8["qh"], k8["wv"], k8["ws"]
    ds8, r8, al8, va8 = k8["ds"], k8["r"], k8["alpha"], k8["v_att"]
    g8, ga8 = k8["g"], k8["ga"]

    def k8_backward():
        dalpha = attention._score_dot(v8, g8) * r8
        s8 = (g8 * va8).sum(-1) + (al8 * ga8).sum(-1)
        ds = (al8 * (dalpha + ga8 - s8[:, None])).contiguous()
        return attention.attention_bwd(v8, qh8, wv8, ws8, ds, r8, True)

    times["attention_bwd"] = {
        "kernel": time_cuda(lambda: attention.attention_bwd(
            v8, qh8, wv8, ws8, ds8, r8, True), buf),
        "plain": time_cuda(lambda: attention.attention_bwd_reference(
            v8, qh8, wv8, ws8, ds8, r8, True), buf),
        "op_backward_with_kernel": time_cuda(k8_backward, buf),
        "explicit_backward": time_cuda(lambda: attention.attention_bwd_math(
            v8, qh8, wv8, ws8, al8, va8, g8, ga8, normalize=True,
            feature_grad=False), buf),
        "library": None,
    }
    Bt = B_TRAIN
    times["attention_bwd"]["bound"] = k8_bound(Bt)
    # K8's dz launch alone (the recomputed score GEMM on score_gemm.cuh's
    # mainloop and its epilogue), from the profiler over whole calls, L2
    # flushed before each, with its TFLOP/s and its bound: 2 B N C H
    # operations against the grid and W_v read once and dzr and the
    # partials written once. Beside it cuBLAS on the same product,
    # v [B N, C] @ W_v [C, H] in bf16.
    dz_plan = kernels.dz_plan(Bt, N, C, H)
    dz_flops = 2 * Bt * N * C * H  # K2's score GEMM at Bt does the same
    dz_ms = kernel_device_ms(lambda: attention.attention_bwd(
        v8, qh8, wv8, ws8, ds8, r8, True), "attn_bwd_dz_kernel", buf)
    v8_rows = v8.view(Bt * N, C)
    dz_bound = bound(Bt * N * C * 2 + C * H * 2 + Bt * H * 4 + H * 4
                     + 2 * Bt * N * 4 + Bt * N * H * 2
                     + 2 * 4 * dz_plan["partials"][0]
                     * dz_plan["partials"][1] * H, dz_flops)
    times["attention_bwd"]["dz_stage"] = {
        "ms": dz_ms, "tflops": dz_flops / (dz_ms * 1e-3) / 1e12,
        "bound_ms": dz_bound[0], "bound_by": dz_bound[1],
        "launch": {k: dz_plan[k] for k in ("tile", "stages", "smem_bytes",
                                            "grid", "slots")},
        "library_ms": time_cuda(lambda: torch.matmul(v8_rows, wv8), buf),
        "library_call": f"torch.matmul([{Bt * N}, {C}] bf16, [{C}, {H}] "
                        "bf16) -> bf16"}
    # K2 at the gathered training batch on phase 7's inputs (normalize on):
    # the whole call, its plain version, its bound; its score launch alone
    # (the profiler over whole calls, L2 flushed before each) with its
    # TFLOP/s and its bound (the same product as K8's dz launch: the grid,
    # W_v, qh and ws read once, the partial scores and r written once), and
    # cuBLAS on that product (dz_stage's); its wsum launch alone beside its
    # bytes bound: v, the partial scores and r read once, v_att and alpha
    # written once.
    k2_plan = kernels.score_plan(Bt, N, C, H)
    k2t = {
        "kernel": time_cuda(lambda: attention.attention_fwd(
            v8, qh8, wv8, ws8, normalize=True), buf),
        "plain": time_cuda(lambda: attention.attention_fwd_reference(
            v8, qh8, wv8, ws8, True), buf),
        "score_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v8, qh8, wv8, ws8, normalize=True), SCORE_KERNEL, buf),
        "score_bound": bound(Bt * N * C * 2 + C * H * 2 + Bt * H * 4 + H * 4
                             + (k2_plan["n_part"] + 1) * Bt * N * 4,
                             dz_flops),
        "score_library_ms": times["attention_bwd"]["dz_stage"]["library_ms"],
        "score_launch": k2_plan,
        "wsum_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v8, qh8, wv8, ws8, normalize=True), "attn_wsum_kernel", buf),
        "wsum_bound": bound(Bt * N * C * 2 + (k2_plan["n_part"] + 2) * Bt * N
                            * 4 + Bt * C * 4, 2 * Bt * N * C),
        "bound": k2_bound(Bt)}
    k2t["score_tflops"] = dz_flops / (k2t["score_ms"] * 1e-3) / 1e12
    times["attention_fwd"]["at_training_batch"] = k2t
    # The dW_v launch alone (attention_dwv.cuh, shared by K5, K8 and P2),
    # from the profiler over whole calls, L2 flushed before each: K5 at G=1
    # on bf16 rows and on int8 codes, K8. Beside it cuBLAS on the same
    # product, v^T dzr over the valid cells: torch.matmul of the gathered
    # rows (transposed view) and a bf16 [K, H], the gather timed apart.
    dwv_flops = 2 * Bt * nv * C * H
    dwv = {}
    for key, fn in (
            ("attention_resident_bwd", lambda: ar.attention_resident_bwd(
                st, rows, h5, ws4, al5, g5, sga5, **kw)),
            ("attention_resident_bwd[int8]",
             lambda: ar.attention_resident_bwd(cq, rows, hq, wsq, alq, gq,
                                               sgaq, **kw)),
            ("attention_bwd", lambda: attention.attention_bwd(
                v8, qh8, wv8, ws8, ds8, r8, True))):
        ms = kernel_device_ms(fn, "attn_dwv::dwv_kernel", buf)
        dwv[key] = {"ms": ms, "tflops": dwv_flops / (ms * 1e-3) / 1e12}
    rows_l = rows.long()
    v_all = st[rows_l, :nv].reshape(Bt * nv, C)
    dz_all = h5[:, :nv].reshape(Bt * nv, H)
    lib_dwv = {
        "library_ms": time_cuda(lambda: torch.matmul(v_all.t(), dz_all),
                                buf),
        "library_gather_ms": time_cuda(
            lambda: st[rows_l, :nv].reshape(Bt * nv, C), buf),
        "library_call": f"torch.matmul([{C}, {Bt * nv}] bf16 (the gathered "
                        f"rows, transposed), [{Bt * nv}, {H}] bf16) -> bf16",
    }
    for key, t in dwv.items():
        t.update(lib_dwv)
        times[key]["dwv_stage"] = t
        print(f"{key} dW_v launch at G=1: {t['ms']:.4f} ms, "
              f"{t['tflops']:.1f} TFLOP/s; cuBLAS {t['library_ms']:.4f} ms "
              f"+ gather {t['library_gather_ms']:.4f} ms")
    # K4's score launch alone (bf16 rows, and int8 codes of the same
    # cells) beside cuBLAS on its product, the gathered rows of the valid
    # cells by W_v in bf16, the gather timed apart (as phase 28 times
    # K4h's).
    lib_score = {
        "library_ms": time_cuda(lambda: torch.matmul(v_all, wv4), buf),
        "library_gather_ms": lib_dwv["library_gather_ms"],
        "library_call": f"torch.matmul([{Bt * nv}, {C}] bf16 (the gathered "
                        f"rows), [{C}, {H}] bf16) -> bf16"}
    for key in ("attention_resident_fwd", "attention_resident_fwd[int8]"):
        times[key]["score_stage"] = {"ms": times[key]["score"], **lib_score}
        print(f"{key} score launch at G=1: {times[key]['score']:.4f} ms; "
              f"cuBLAS {lib_score['library_ms']:.4f} ms + gather "
              f"{lib_score['library_gather_ms']:.4f} ms")
    report["rows_stage"] = rows_stage_times(k45, k45g, k45q, buf)
    report["bound_inputs"] = {"k1_live_steps": nlen,
                              "k1_live_steps_serving": nlen_serving,
                              "k3_live_steps": nl3, "k45_unique_rows": uniq,
                              "k67_live_steps_per_direction":
                              int(k67["args"][2].sum().item())}
    for name, t in [*times.items(), ("gru_fwd at the serving batch",
                                     k1_serving),
                    *((f"{k} at G=2", t) for k, t in g2_times.items())]:
        print(f"{name}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, library {t['library']}, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
    for batch, t in ((B_TRAIN, times["gru_fwd"]), (B, k1_serving)):
        print(f"K1 at B={batch}: T={T} {t['kernel']:.4f} ms, T=1 "
              f"{t['one_step_ms']:.4f} ms, {t['step_us']:.2f} us a step")
    for batch, row in times["gru_fwd"]["tilings_ms"].items():
        print(f"K1 tilings at B={batch}, T={T}: " + ", ".join(
            f"{r} rows {row[str(r)]:.4f} ms" for r in (16, 64)
            if str(r) in row) + f" (the plan takes {row['plan_rows']})")
    print(f"K6 against two K1 calls in turns (both directions): K6 "
          f"{times['bigru_fwd']['kernel']:.4f} ms, two K1 calls "
          f"{times['bigru_fwd']['two_k1']:.4f} ms")
    for batch, row in times["bigru_fwd"]["tilings_ms"].items():
        print(f"K6 tilings at B={batch}, T={T}: " + ", ".join(
            f"{r} rows {row[str(r)]:.4f} ms" for r in (16, 64)
            if str(r) in row) + f" (the plan takes {row['plan_rows']})")
    print(f"K7 against two K3 calls in turns (both directions): K7 "
          f"{times['bigru_bwd']['kernel']:.4f} ms, two K3 calls "
          f"{times['bigru_bwd']['two_k3']:.4f} ms")
    t = times["attention_bwd"]["dz_stage"]
    print(f"K8 dz launch at B={Bt}, N={N}: {t['ms']:.4f} ms, "
          f"{t['tflops']:.1f} TFLOP/s, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}); cuBLAS on the same product "
          f"{t['library_ms']:.4f} ms")
    print(f"K2 at B={Bt}: {k2t['kernel']:.4f} ms (plain {k2t['plain']:.4f}), "
          f"bound {k2t['bound'][0]:.4f} ms ({k2t['bound'][1]}); its score "
          f"launch {k2t['score_ms']:.4f} ms, {k2t['score_tflops']:.1f} "
          f"TFLOP/s, bound {k2t['score_bound'][0]:.4f} ms "
          f"({k2t['score_bound'][1]}), cuBLAS on the same product "
          f"{k2t['score_library_ms']:.4f} ms; its wsum launch "
          f"{k2t['wsum_ms']:.4f} ms, bound {k2t['wsum_bound'][0]:.4f} ms "
          f"({k2t['wsum_bound'][1]})")
    k2b = times["attention_fwd"]
    print(f"K2 by batch: B={B_PREDICT} "
          f"{k2b['at_predict_batch']['ms']:.4f} ms (score launch "
          f"{k2b['at_predict_batch']['score_ms']:.4f}), B={B} "
          f"{k2b['kernel']:.4f} ms (score launch {k2b['score_ms']:.4f}), "
          f"B={Bt} {k2t['kernel']:.4f} ms (score launch "
          f"{k2t['score_ms']:.4f})")
    print(f"gathered backward A/B: with K8 "
          f"{times['attention_bwd']['op_backward_with_kernel']:.4f} ms, "
          f"explicit {times['attention_bwd']['explicit_backward']:.4f} ms")
    return times


def rows_stage_times(k45: dict, k45g: dict, k45q: dict, buf) -> dict:
    """The rows launch alone (``attention_rows.cuh``), from the profiler
    over whole calls, L2 flushed before each: K5 at G=1, 2 and 8 on bf16
    rows and at G=1 on int8 codes (the main path's mode, normalize off),
    and P2's; each beside its bytes bound: every distinct store row's valid
    cells read once, h once, the cotangent dzr written once, and the small
    inputs (g, alpha, sga, rows) and outputs (dqh, dws partials; P2's dal)
    once."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar
    from vqa_transfer_externaldata_torch.tools import probe_bwd_ceiling as p2

    st, rows, nv = k45["store"], k45["rows"], k45["n_valid"]
    Bt = rows.shape[0]
    uniq = int(torch.unique(rows).numel())
    kw = dict(n_valid=nv, normalize=False)
    out = {}
    for key, store, k, G, row_bytes in (
            ("k5_g1", st, k45, 1, 2), ("k5_g2", st, k45g, 2, 2),
            ("k5_g8", st, k45g["g8"], 8, 2),
            ("k5_int8_g1", k45q["codes"], k45q, 1, 1)):
        args = (store, rows, k["h"], k["ws"], k["alpha"], k["g"], k["sga"])
        ms = kernel_device_ms(lambda: ar.attention_resident_bwd(*args, **kw),
                              "attn_res_bwd_rows_kernel", buf)
        nbytes = (uniq * nv * C * row_bytes + Bt * 4 + 2 * Bt * nv * H * 2
                  + G * H * 4 + Bt * G * C * 4 + 2 * Bt * nv * G * 4
                  + Bt * H * 4 + Bt * G * H * 4)
        flops = 2 * G * Bt * nv * C + 4 * G * Bt * nv * H
        b_ms, b_by = bound(nbytes, flops)
        out[key] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "bytes": nbytes, "share_of_bound": b_ms / ms}
    # P2 at its own sizes (p2.B questions of all p2.Np cells): dal and
    # bf16(h * 0.5).
    x = p2.make_inputs(torch.device("cuda", 0))
    ms = kernel_device_ms(lambda: p2.probe_bwd_ceiling(
        x["store"], x["rows"], x["h"], x["g"]), "probe_bwd_rows_kernel", buf)
    uniq2 = int(torch.unique(x["rows"]).numel())
    cells = p2.B * p2.Np
    nbytes = (uniq2 * p2.Np * p2.C * 2 + p2.B * 4 + 2 * cells * p2.H * 2
              + p2.B * p2.C * 2 + cells * 4)
    b_ms, b_by = bound(nbytes, 2 * cells * p2.C + cells * p2.H)
    out["p2"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                 "bytes": nbytes, "share_of_bound": b_ms / ms}
    for key, t in out.items():
        print(f"{key} rows launch alone: {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B), "
              f"{t['share_of_bound']:.1%} of it")
    return out


# ---------------------------------------------------------------------------
# Phase 25: float32. Phase 26: the checkpoint-fidelity path.
# ---------------------------------------------------------------------------


def bound_f32(nbytes: float, flops: float) -> tuple:
    """:func:`bound` for float32 work: its operations over the FP32 FFMA
    peak (the float32 kernels take no tensor-core pass)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The profiler names of K3f's four launches (csrc/gru_bwd_f32.cu): every
# step's gh, the chain, dU_h and db_hn.
K3F_LAUNCH_KERNELS = {"gh": "gru_seq_f32::gru_f32_gh_kernel",
                      "chain": "gru_seq_f32::gru_f32_bptt_kernel",
                      "duh": "gru_seq_f32::gru_f32_duh_kernel",
                      "dbhn": "gru_f32::gru_f32_dbhn_kernel"}
# The profiler name of K6f's launch and of K7f's four launches
# (csrc/bigru_{fwd,bwd}_f32.cu), each taking both chains.
K6F_KERNEL = "gru_seq_f32::gru_f32_seq_kernel"
K7F_LAUNCH_KERNELS = {"gh": "gru_seq_f32::gru_f32_gh_kernel",
                      "chain": "gru_seq_f32::gru_f32_bptt_kernel",
                      "duh": "gru_seq_f32::gru_f32_duh_kernel",
                      "dbhn": "gru_f32::gru_f32_dbhn_kernel"}
# The profiler names of the float32 BPTT's step form (K3f's and K7f's,
# csrc/gru_bptt_f32.cuh): the lists, every live row-step's gh, the T fused
# carries, dU_h and db_hn.
F32_STEP_BWD_PARTS = {"lists": "gru_bptt_f32::gru_f32_lists_kernel",
                      "gh": "gru_seq_f32::gru_f32_gh_kernel",
                      "carry": "gru_bptt_f32::gru_f32_carry_kernel",
                      "duh": "gru_seq_f32::gru_f32_duh_kernel",
                      "dbhn": "gru_f32::gru_f32_dbhn_kernel"}
# The profiler names of the float32 products on fp32_ring.cuh's loop.
F32_SCORE_KERNEL = "attn_f32_score_ring_kernel"  # K4f's and K2f's score
F32_DZ_KERNEL = "attn_f32_bwd_dz_ring_kernel"  # K8f's dz launch
F32_DWV_KERNEL = "fp32_ring::product_kernel"  # K5f's and K8f's dW_v


def f32_launch_turns(label: str, fn, prefix: str, matmul, flops: float,
                     buf) -> dict:
    """One float32 product launch (the kernels named ``prefix`` in a call of
    ``fn``, device ms from a profile) beside ``matmul`` (one torch.matmul
    in f32, TF32 off, on the same product; CUDA events) in turns: matmul,
    launch, launch, matmul. Prints both in ms and TFLOP/s over ``flops``
    and the FFMA bound; returns the four times."""
    turns = [time_cuda(matmul, buf), kernel_device_ms(fn, prefix, buf),
             kernel_device_ms(fn, prefix, buf), time_cuda(matmul, buf)]
    rate = [flops / t / 1e9 for t in turns]
    print(f"{label}: launch {turns[1]:.4f} / {turns[2]:.4f} ms "
          f"({rate[1]:.1f} / {rate[2]:.1f} TFLOP/s) beside torch.matmul f32 "
          f"{turns[0]:.4f} / {turns[3]:.4f} ms ({rate[0]:.1f} / {rate[3]:.1f} "
          f"TFLOP/s), in turns; FFMA bound "
          f"{flops / PEAK_FP32_FLOPS * 1e3:.4f} ms")
    return {"turns_ms": turns, "launch_ms": turns[1],
            "launch_tflops": rate[1], "matmul_ms": [turns[0], turns[3]],
            "matmul_tflops": [rate[0], rate[3]],
            "ffma_bound_ms": flops / PEAK_FP32_FLOPS * 1e3}


def f32_errors(got: dict, want: dict, limits: dict) -> dict:
    """Each output's largest error relative to its plain version's largest
    |value|, checked against its limit."""
    import torch

    out = {}
    for name, limit in limits.items():
        check(bool(torch.isfinite(got[name]).all()), f"{name} not finite")
        e = rel_err(got[name].float(), want[name].float())
        check(e <= limit, f"{name}: relative error {e} > {limit}")
        out[name] = {"rel_err": e, "limit": limit,
                     "max_abs_err": (got[name] - want[name]).abs().max()
                     .item()}
    return out


def f32_gru_checks(dev, gen) -> dict:
    """K1f and K3f against their plain float32 versions at the training
    shape (B_TRAIN, T, H), lengths 1..T, both directions, K3f fed the plain
    version's hseq; the route there is the persistent form of each, and
    every output equals the step form's bit for bit."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru

    gx = torch.randn(T, B_TRAIN, 3 * H, generator=gen, device=dev) * 0.5
    lens = torch.randint(1, T + 1, (B_TRAIN,), generator=gen, device=dev,
                         dtype=torch.int32)
    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    uh = (torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1) * lim
    bhn = torch.randn(H, generator=gen, device=dev) * 0.1
    ghT = torch.randn(B_TRAIN, H, generator=gen, device=dev)
    routes = {n: gru._f32_route(n, B_TRAIN, H, dev)
              for n in ("gru_fwd_f32", "gru_bwd_f32")}
    check(set(routes.values()) == {"persistent"},
          f"K1f/K3f at the training shape take {routes}")
    checks, err = [], 0.0
    for reverse in (False, True):
        hT, hseq = gru.gru_fwd_f32(gx, lens, uh, bhn, reverse=reverse)
        rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
        got = dict(zip(("dgx", "duh", "dbhn"), gru.gru_bwd_f32(
            gx, rseq, lens, uh, bhn, ghT, reverse=reverse)))
        want = dict(zip(("dgx", "duh", "dbhn"), gru.gru_bwd_reference(
            gx, rseq, lens, uh, bhn, ghT, reverse=reverse)))
        # The step form of each on the same inputs: bit for bit.
        step = dict(zip(("hT", "hseq"), gru._gru_fwd32(
            gx, lens, uh, bhn, reverse, "step")))
        step.update(zip(("dgx", "duh", "dbhn"), gru._gru_bwd32(
            gx, rseq, lens, uh, bhn, ghT, reverse, "step")))
        torch.cuda.synchronize()
        e1 = f32_errors({"hT": hT, "hseq": hseq}, {"hT": rT, "hseq": rseq},
                        {"hT": TOL_F32_REL, "hseq": TOL_F32_REL})
        e3 = f32_errors(got, want, {k: TOL_F32_REL for k in got})
        diff = {k: (v - step[k]).abs().max().item()
                for k, v in {"hT": hT, "hseq": hseq, **got}.items()}
        check(all(torch.equal(v, step[k]) for k, v in
                  {"hT": hT, "hseq": hseq, **got}.items()),
              f"K1f/K3f reverse={reverse}: the persistent form differs "
              f"from the step form by {diff}")
        print(f"K1f reverse={reverse}: " + ", ".join(
            f"{k} {v['rel_err']:.3e}" for k, v in e1.items())
            + f"; K3f: " + ", ".join(f"{k} {v['rel_err']:.3e}"
                                      for k, v in e3.items())
            + f" (limit {TOL_F32_REL} of each output's largest value); "
            "persistent form bit-equal to the step form")
        checks.append({"reverse": reverse, "k1f": e1, "k3f": e3,
                       "diff_vs_step_form": diff})
        err = max(err, *(v["max_abs_err"] for v in e1.values()))
    err3 = max(v["max_abs_err"] for c in checks for v in c["k3f"].values())
    return {"gx": gx, "lens": lens, "uh": uh, "bhn": bhn, "ghT": ghT,
            "hseq": rseq, "checks": checks, "err1": err, "err3": err3,
            "routes": routes}


def f32_store(dev, gen, rows_dtype: str) -> tuple:
    """The main path's store at F32_IMAGES images of N cells (padded to
    8) of C channels and its dequantization scale: float32 rows, their
    float16 copy (the synthetic corpus's rows), or the int8 codes of the
    L2-normalized rows with one global scale."""
    import torch

    Np = N + (-N) % 8
    grid = torch.zeros(F32_IMAGES, Np, C, device=dev)
    grid[:, :N] = torch.randn(F32_IMAGES, N, C, generator=gen,
                              device=dev).relu()
    if rows_dtype == "int8":
        grid = grid / grid.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        scale = grid.abs().max().item() / 127
        return (grid / scale).round().to(torch.int8), scale
    return grid.to(getattr(torch, rows_dtype)), 1.0


def f32_resident_checks(dev, gen) -> dict:
    """K4f and K5f against their plain float32 versions at the main path's
    shapes (B_TRAIN questions with repeated rows over F32_IMAGES images of
    196 cells, C=2048, H=512) on float32, float16 and int8 rows at
    F32_GLIMPSES glimpses, normalize on and off on float rows, K5f fed the
    plain version's saved h and alpha. On int8 codes W_v is scaled as the
    op scales it (``wv * scale``), so the scores keep the float rows'
    magnitude."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar

    rows = torch.randint(0, F32_IMAGES, (B_TRAIN,), generator=gen,
                         device=dev, dtype=torch.int32)
    rows[1::7] = rows[0]  # questions about one image
    qh = torch.randn(B_TRAIN, H, generator=gen, device=dev) * 0.5
    wv = (torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * (
        6.0 / (C + H)) ** 0.5
    ws8 = torch.randn(H, 8, generator=gen, device=dev) * 0.05
    checks, keep = [], {}
    err4 = err5 = 0.0
    wv_rows = wv
    for rows_dtype in F32_ROWS:
        store, scale = f32_store(dev, gen, rows_dtype)
        wv = wv_rows * scale if scale != 1.0 else wv_rows
        for G in F32_GLIMPSES:
            ws = ws8[:, :G].contiguous() if G > 1 else ws8[:, 0].contiguous()
            for normalize in ((False,) if rows_dtype == "int8"
                              else (False, True)):
                kw = dict(n_valid=N, normalize=normalize)
                v, a, h = ar.attention_resident_fwd_f32(
                    store, rows, qh, wv, ws, save_h=True, **kw)
                rv, ra, rh = ar.attention_resident_fwd_reference(
                    store, rows, qh, wv, ws, save_h=True, **kw)
                g = torch.randn(B_TRAIN, G * C, generator=gen, device=dev)
                sga = torch.randn(ra.shape, generator=gen, device=dev) * 0.1
                got5 = dict(zip(("dqh", "dwv", "dws"),
                                ar.attention_resident_bwd_f32(
                                    store, rows, rh, ws, ra, g, sga, **kw)))
                want5 = dict(zip(("dqh", "dwv", "dws"),
                                 ar.attention_resident_bwd_reference(
                                     store, rows, rh, ws, ra, g, sga, **kw)))
                torch.cuda.synchronize()
                got4 = {"alpha": a, "h": h}
                want4 = {"alpha": ra, "h": rh}
                for k in range(G):
                    got4[f"v_att_{k}"] = v[:, k * C:(k + 1) * C]
                    want4[f"v_att_{k}"] = rv[:, k * C:(k + 1) * C]
                e4 = f32_errors(got4, want4,
                                {k: TOL_F32_REL for k in got4})
                e5 = f32_errors(got5, want5, {"dqh": G * TOL_F32_REL,
                                              "dwv": G * TOL_F32_REL,
                                              "dws": TOL_F32_REL})
                vatt = max(x["rel_err"] for k, x in e4.items()
                           if k.startswith("v_att"))
                print(f"K4f/K5f {rows_dtype} rows, G={G}, normalize="
                      f"{normalize}: v_att {vatt:.3e}, "
                      f"alpha {e4['alpha']['rel_err']:.3e}, h "
                      f"{e4['h']['rel_err']:.3e}; dqh "
                      f"{e5['dqh']['rel_err']:.3e}, dwv "
                      f"{e5['dwv']['rel_err']:.3e}, dws "
                      f"{e5['dws']['rel_err']:.3e}")
                checks.append({"rows": rows_dtype, "glimpses": G,
                               "normalize": normalize, "k4f": e4,
                               "k5f": e5})
                err4 = max(err4, *(x["max_abs_err"] for x in e4.values()))
                err5 = max(err5, *(x["max_abs_err"] for x in e5.values()))
                if G == 1 and not normalize:
                    keep[rows_dtype] = dict(store=store, ws=ws, h=rh,
                                            alpha=ra, g=g, sga=sga)
        del store
    return {"rows": rows, "qh": qh, "wv": wv_rows, "by_rows": keep,
            "checks": checks, "err4": err4, "err5": err5}


def f32_times(k13: dict, k45: dict, dev) -> dict:
    """Each float32 kernel at the main path's shapes (K4f/K5f at G=1 on
    the synthetic corpus's float16 rows, normalize off: the prenormalized
    store): its time, its plain version's, the library yardstick's and
    the bound from this run's inputs; K1f and K3f in turns with their
    step form and cuDNN's GRU, and K3f's four launches apart."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar
    from vqa_transfer_externaldata_torch.ops import gru

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    gx, lens, uh, bhn = k13["gx"], k13["lens"], k13["uh"], k13["bhn"]
    hseq, ghT = k13["hseq"], k13["ghT"]
    Bt, nl, nc = B_TRAIN, int(lens.sum().item()), carried_steps(lens)
    times = {}
    # Library yardstick of K1f and K3f: cuDNN's GRU in float32 (TF32 off)
    # over the packed lengths; it also takes the input projection.
    lib = torch.nn.GRU(D, H).to(dev)
    lib.flatten_parameters()
    x = torch.randn(T, Bt, D, device=dev, requires_grad=True)
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens.cpu(),
                                                     enforce_sorted=False)
    _, h_n = lib(packed)
    wrt, g_n = [x, *lib.parameters()], torch.randn_like(h_n)

    def lib_fwd():
        with torch.inference_mode():
            lib(packed)

    def lib_bwd():
        torch.autograd.grad(h_n, wrt, g_n, retain_graph=True)

    def k1f(form=None):
        return lambda: gru._gru_fwd32(gx, lens, uh, bhn, False, form)

    def k3f(form=None):
        return lambda: gru._gru_bwd32(gx, hseq, lens, uh, bhn, ghT, False,
                                      form)

    # Each kernel, its step form and cuDNN in the same call, in turns:
    # library, kernel, step form, step form, kernel, library.
    turns = {}
    for name, kern, lib_call in (("gru_fwd_f32", k1f, lib_fwd),
                                 ("gru_bwd_f32", k3f, lib_bwd)):
        t = [time_cuda(lib_call, buf), time_cuda(kern(), buf),
             time_cuda(kern("step"), buf), time_cuda(kern("step"), buf),
             time_cuda(kern(), buf), time_cuda(lib_call, buf)]
        turns[name] = {"turns_ms": t, "library_turns": [t[0], t[5]],
                       "kernel_turns": [t[1], t[4]],
                       "step_form": [t[2], t[3]]}
        print(f"{name}: persistent {t[1]:.4f} / {t[4]:.4f} ms, step form "
              f"{t[2]:.4f} / {t[3]:.4f} ms, library {t[0]:.4f} / "
              f"{t[5]:.4f} ms, in turns")
    # K3f's four launches apart: device ms a call, from one profile.
    k3_launch_ms = split_device_ms(k3f(), K3F_LAUNCH_KERNELS, buf)
    print("K3f launches (ms a call): " + ", ".join(
        f"{k} {v:.4f}" for k, v in k3_launch_ms.items()))
    times["gru_fwd_f32"] = {
        "kernel": turns["gru_fwd_f32"]["kernel_turns"][0],
        "plain": time_cuda(lambda: gru.gru_reference(gx, lens, uh, bhn), buf),
        "library": turns["gru_fwd_f32"]["library_turns"][0],
        "library_call": f"torch.nn.GRU({D}, {H}) in float32 (TF32 off) "
                        "over a packed sequence, input projection included",
        **turns["gru_fwd_f32"],
        # The live row-steps read gx once, U_h and bhn once; hseq and hT
        # are written once; one [H] x [H, 3H] product a carried
        # row-step.
        "bound": bound_f32(nl * 3 * H * 4 + Bt * 4 + 3 * H * H * 4 + H * 4
                           + T * Bt * H * 4 + Bt * H * 4,
                           2 * nc * H * 3 * H)}
    times["gru_bwd_f32"] = {
        "kernel": turns["gru_bwd_f32"]["kernel_turns"][0],
        "plain": time_cuda(lambda: gru.gru_bwd_reference(
            gx, hseq, lens, uh, bhn, ghT), buf),
        "library": turns["gru_bwd_f32"]["library_turns"][0],
        "library_call": f"backward of torch.nn.GRU({D}, {H}) in float32 "
                        "(TF32 off) over a packed sequence, "
                        "input-projection gradients included",
        **turns["gru_bwd_f32"], "launch_ms": k3_launch_ms,
        # gx and hseq read once for the live row-steps, dgx, dU_h and
        # db_hn written once; three products a carried row-step (the
        # recomputed gh, the U_h^T product, the share of dU_h).
        "bound": bound_f32(nl * 4 * H * 4 + Bt * 4 + 3 * H * H * 4 + H * 4
                           + Bt * H * 4 + T * Bt * 3 * H * 4
                           + 3 * H * H * 4 + H * 4,
                           3 * 2 * nc * H * 3 * H)}
    rows, qh, wv = k45["rows"], k45["qh"], k45["wv"]
    f16 = k45["by_rows"]["float16"]
    st, ws, h, al, g, sga = (f16[k] for k in ("store", "ws", "h", "alpha",
                                              "g", "sga"))
    kw = dict(n_valid=N, normalize=False)
    Np = st.shape[1]
    uniq = int(torch.unique(rows).numel())
    row_bytes = uniq * Np * C * 2
    # The score stage's yardstick: cuBLAS's f32 GEMM on the gathered rows
    # (the gather timed apart); the dW_v stage's: the same on its operands.
    cells = Bt * Np
    v32 = st[rows.long()].float().reshape(cells, C)
    dzr = torch.randn(Bt * N, H, device=dev)
    vt = st[rows.long()][:, :N].float().reshape(Bt * N, C).t()
    times["attention_resident_fwd_f32"] = {
        "kernel": time_cuda(lambda: ar.attention_resident_fwd_f32(
            st, rows, qh, wv, ws, save_h=True, **kw), buf),
        "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
            st, rows, qh, wv, ws, save_h=True, **kw), buf),
        "library": time_cuda(lambda: torch.matmul(v32, wv), buf),
        "library_call": f"torch.matmul([{cells}, {C}] f32, [{C}, {H}] f32) "
                        "(TF32 off): the score stage alone, on rows "
                        "gathered apart",
        "library_gather_ms": time_cuda(
            lambda: st[rows.long()].float(), buf),
        # Each named store row read once (rows repeat), W_v, qh and ws
        # once; v_att, alpha and the saved f32 h written once; the score
        # product, the scores and the weighted sum over the valid cells
        # (K4's bound counts the same).
        "bound": bound_f32(row_bytes + Bt * 4 + Bt * H * 4 + C * H * 4
                           + H * 4 + Bt * C * 4 + cells * 4 + cells * H * 4,
                           2 * Bt * N * C * (H + 1) + 2 * Bt * N * H)}
    times["attention_resident_bwd_f32"] = {
        "kernel": time_cuda(lambda: ar.attention_resident_bwd_f32(
            st, rows, h, ws, al, g, sga, **kw), buf),
        "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
            st, rows, h, ws, al, g, sga, **kw), buf),
        "library": time_cuda(lambda: torch.matmul(vt, dzr), buf),
        "library_call": f"torch.matmul([{C}, {Bt * N}] f32, [{Bt * N}, "
                        f"{H}] f32) (TF32 off): the dW_v stage alone, on "
                        "rows gathered apart",
        # The rows read once, h, alpha, sga and g once; dqh, dW_v and dws
        # written once; dW_v and the dalpha dots over the valid cells, dz
        # and dws.
        "bound": bound_f32(row_bytes + Bt * 4 + cells * H * 4 + H * 4
                           + 2 * cells * 4 + Bt * C * 4 + Bt * H * 4
                           + C * H * 4 + H * 4,
                           2 * Bt * N * C * (H + 1) + 4 * Bt * N * H)}
    # The two redesigned launches beside the same product in torch.matmul,
    # in turns; each rate over the work its valid cells need.
    flops = 2 * Bt * N * C * H
    t4 = times["attention_resident_fwd_f32"]
    t5 = times["attention_resident_bwd_f32"]
    t4["score_launch"] = f32_launch_turns(
        "K4f score launch", lambda: ar.attention_resident_fwd_f32(
            st, rows, qh, wv, ws, save_h=True, **kw), F32_SCORE_KERNEL,
        lambda: torch.matmul(v32, wv), flops, buf)
    t5["dwv_launch"] = f32_launch_turns(
        "K5f dW_v launch", lambda: ar.attention_resident_bwd_f32(
            st, rows, h, ws, al, g, sga, **kw), F32_DWV_KERNEL,
        lambda: torch.matmul(vt, dzr), flops, buf)
    t4["score_ms"] = t4["score_launch"]["launch_ms"]
    t4["score_tflops"] = t4["score_launch"]["launch_tflops"]
    t5["dwv_ms"] = t5["dwv_launch"]["launch_ms"]
    t5["dwv_tflops"] = t5["dwv_launch"]["launch_tflops"]
    for name, t in times.items():
        print(f"{name}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, library {t['library']:.4f} ms "
              f"({t['library_call']}), bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]})")
    return times


def phase_float32(report: dict, dev, gen) -> dict:
    """Phase 25, model.dtype float32 on the main path: the float32 kernels
    K1f, K3f, K4f and K5f against their plain versions at the main path's
    shapes and timed beside their bounds; fit_resident at full width in
    float32 on the synthetic corpus's float16 store (K1f, K3f, K4f on f16
    rows, K5f), its first step against the plain path, launch counts, step
    times, then the resident evaluator. (The float32 Predictor, on K1f
    and K2f, is phase 27's.)"""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    out = {"k13": f32_gru_checks(dev, gen)}
    out["k45"] = f32_resident_checks(dev, gen)
    out["times"] = f32_times(out["k13"], out["k45"], dev)
    steps = F32_STEPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f32_") as tmp:
        cfg = stage2_config(tmp, steps, **{"model.dtype": "float32"})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        check(data["grid"].dtype == torch.float16,
              f"float32 store uploaded as {data['grid'].dtype}")
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        out["first_step"] = check_first_step(
            spec, state, batch, dev, "float32 stage 2",
            loss_tol=TOL_F32_LOSS, grad_cos=F32_GRAD_COS)
        del data, make_batch, batch

        # --- this path: counts from 0 ------------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        check_launches(launches, {
            "gru_fwd_f32": K1F_LAUNCHES * steps,
            "gru_bwd_f32": K3F_LAUNCHES * steps,
            "attention_resident_fwd_f32": 2 * steps,
            "attention_resident_bwd_f32": 3 * steps},
            f"float32 stage-2 training over {steps} steps")
        out.update(launches=launches, **read_steps(
            tmp, steps, "float32 stage-2 training", "questions",
            warmup=F32_WARMUP))
        reset_counts()
        metrics, preds = trainer.evaluate_resident(state, val)
        torch.cuda.synchronize()
        batches = -(-VAL_QUESTIONS // B_TRAIN)
        out["eval_launches"] = read_counts()
        check_launches(out["eval_launches"], {
            "gru_fwd_f32": K1F_LAUNCHES * batches,
            "attention_resident_fwd_f32": 2 * batches},
            "float32 resident evaluation")
        check(np.isfinite(metrics["loss"]) and len(preds) == VAL_QUESTIONS,
              f"float32 evaluation: {metrics}, {len(preds)} predictions")
        print(f"float32 resident evaluation: {metrics}")
        out["eval_metrics"] = {k: float(v) for k, v in metrics.items()}
        trainer.close()
    return out


def phase_fidelity(report: dict, dev) -> dict:
    """Phase 26, model.fidelity_mode at full width: the forward on the card
    (TF1 GRU, float32, the plain gathered attention: no kernel) against the
    port's float64 numpy oracle at FID_BATCH questions, at JAX's own
    tolerance; then cli.train (the gather-free resident path: K4f/K5f on
    the float16 store, no K1, K2, K3 or K8), cli.eval (the resident
    evaluator: K4f) and cli.predict (the plain gathered attention: no
    kernel) on the run."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import predict as predict_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.serving import Predictor
    from vqa_transfer_externaldata_torch.utils import fidelity

    out = {}
    cfg = Config().replace_flat({"data.synthetic": True,
                                 "model.fidelity_mode": True,
                                 **MODEL_OVERRIDES})
    model = build_model(cfg, generator=torch.Generator().manual_seed(
        FID_SEED)).module
    check((model.dtype, model.rnn_variant, model.use_pallas,
           model.glimpses) == (torch.float32, "tf", False, 1),
          "fidelity_mode did not assemble the reference convention")
    # Move every parameter off its initial value (zero biases, tiny
    # tables), as the JAX package's fidelity test does.
    rng = np.random.default_rng(FID_SEED)
    params = {k: np.asarray(v.numpy() + rng.normal(
        scale=0.05, size=tuple(v.shape)), np.float32)
        for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           params.items()})
    model.to(dev).eval()
    feats = np.maximum(rng.standard_normal((FID_BATCH, N, C), np.float32), 0)
    q = rng.integers(4, cfg.data.vocab_size, (FID_BATCH, T)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, T + 1, FID_BATCH)):
        q[i, n:] = 0
    reset_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(feats).to(dev),
                    torch.from_numpy(q).to(dev))["logits"]
    torch.cuda.synchronize()
    check_launches(read_counts(), {}, "the fidelity forward")
    t0 = time.perf_counter()
    want = fidelity.reference_forward_numpy(params, feats, q)
    out["oracle_s"] = time.perf_counter() - t0
    got = got.double().cpu().numpy()
    err = float(np.abs(got - want).max())
    ok = bool(np.allclose(got, want, atol=FID_ATOL, rtol=FID_RTOL))
    print(f"fidelity forward at B={FID_BATCH} vs the float64 oracle: max "
          f"abs err {err:.3e} (atol {FID_ATOL}, rtol {FID_RTOL}), logits "
          f"in [{want.min():.3f}, {want.max():.3f}]")
    check(ok and got.shape == want.shape,
          f"fidelity forward vs oracle: max abs err {err}")
    out["oracle"] = {"max_abs_err": err, "atol": FID_ATOL, "rtol": FID_RTOL,
                     "batch": FID_BATCH}
    del model

    steps = FID_STEPS
    flags = {"model.fidelity_mode": True, "data.synthetic": True,
             "data.synthetic_layout": "joined",
             "data.synthetic_size": TRAIN_QUESTIONS,
             "train.device_data_cache": True, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             **MODEL_OVERRIDES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fidelity_") as tmp:
        reset_counts()
        train_dir = train_cli.main(["--train.train_dir",
                                    os.path.join(tmp, "run")]
                                   + cli_argv(flags))
        torch.cuda.synchronize()
        out["train_launches"] = read_counts()
        check_launches(out["train_launches"], {
            "attention_resident_fwd_f32": 2 * steps,
            "attention_resident_bwd_f32": 3 * steps},
            f"fidelity-mode training over {steps} steps")
        out.update(read_steps(train_dir, steps, "fidelity-mode training",
                              "questions", warmup=F32_WARMUP))

        reset_counts()
        got = eval_cli.main(["--train.train_dir", train_dir])
        torch.cuda.synchronize()
        out["eval_launches"] = read_counts()
        with open(os.path.join(train_dir, "results_val.json")) as fh:
            rows = json.load(fh)
        batches = -(-len(rows) // B_TRAIN)
        check_launches(out["eval_launches"],
                       {"attention_resident_fwd_f32": 2 * batches},
                       "fidelity-mode cli.eval")
        check(len(rows) == TRAIN_QUESTIONS
              and 0.0 <= got["vqa_accuracy"] <= 1.0,
              f"cli.eval: {got}, {len(rows)} result rows")
        print(f"fidelity-mode cli.eval: {got}")
        out["cli_eval"] = got

        store_path = os.path.join(tmp, "store.npz")
        ids = np.arange(100, 100 + PREDICT_IMAGES)
        grid = np.maximum(rng.standard_normal((PREDICT_IMAGES, N, C),
                                              np.float32), 0)
        np.savez(store_path, image_ids=ids, grid=grid.astype(np.float16),
                 pool5=grid.mean(1))
        qs = ["w5 w6 w7", "w8", "w9 w10", "w11 w12 w13 w14"]
        pick = [3, 0, 7 % PREDICT_IMAGES, 3]
        argv = ["--train_dir", train_dir, "--feature_path", store_path]
        for i, qq in zip(pick, qs):
            argv += ["--image_id", str(ids[i]), "--question", qq]
        reset_counts()
        answers = predict_cli.main(argv)
        torch.cuda.synchronize()
        out["predict_launches"] = read_counts()
        check_launches(out["predict_launches"], {},
                       "fidelity-mode cli.predict")
        pred = Predictor(train_dir)
        direct = pred.answer(grid.astype(np.float16)[pick].astype(
            np.float32), qs)
        check(answers == direct and all(a in pred.answer_vocab.tokens
                                        for a in answers),
              f"cli.predict answers {answers} vs Predictor {direct}")
        print(f"fidelity-mode cli.predict: {answers}")
        out["predict_answers"] = answers
    return out


# ---------------------------------------------------------------------------
# Phase 27: float32 on the gathered attention (K2f, K8f) and the
# bidirectional GRU (K6f, K7f).
# ---------------------------------------------------------------------------


def f32_grid_inputs(dev, gen, Bq: int, Nq: int, Cq: int, Hq: int) -> tuple:
    """A float32 grid [Bq, Nq, Cq] (ReLU of normals, cells scaled by
    factors in [1/4, 4] so that their norms differ), qh, a glorot W_v, w_s
    and a score cotangent ds."""
    import torch

    scale = torch.exp2(torch.rand(Bq, Nq, 1, generator=gen, device=dev) * 4
                       - 2)
    v = torch.randn(Bq, Nq, Cq, generator=gen, device=dev).relu() * scale
    qh = torch.randn(Bq, Hq, generator=gen, device=dev) * 0.5
    wv = (torch.rand(Cq, Hq, generator=gen, device=dev) * 2 - 1) * (
        6.0 / (Cq + Hq)) ** 0.5
    ws = torch.randn(Hq, generator=gen, device=dev) * 0.05
    ds = torch.randn(Bq, Nq, generator=gen, device=dev) * 0.01
    return v, qh, wv, ws, ds


def f32_gathered_checks(dev, gen) -> dict:
    """K2f and K8f against their plain float32 versions at the gathered
    training batch, the serving batch and F32_ODD_SHAPE, normalize off and
    on, K8f fed the same ds and K2f's r (module comment of F32_ODD_SHAPE:
    the limits); two calls of each bit-equal at the training batch."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention

    checks, keep = [], {}
    err2 = err8 = 0.0
    for Bq, Nq, Cq, Hq in ((B_TRAIN, N, C, H), (B, N, C, H), F32_ODD_SHAPE):
        v, qh, wv, ws, ds = f32_grid_inputs(dev, gen, Bq, Nq, Cq, Hq)
        for normalize in (False, True):
            va, al, r = attention.attention_fwd_f32(v, qh, wv, ws,
                                                    normalize=normalize)
            rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws,
                                                           normalize)
            got8 = dict(zip(("dqh", "dwv", "dws"), attention.attention_bwd_f32(
                v, qh, wv, ws, ds, r, normalize)))
            want8 = dict(zip(("dqh", "dwv", "dws"),
                             attention.attention_bwd_reference(
                                 v, qh, wv, ws, ds, r, normalize)))
            torch.cuda.synchronize()
            e2 = f32_errors({"v_att": va, "alpha": al},
                            {"v_att": rv, "alpha": ra},
                            {"v_att": TOL_F32_REL, "alpha": TOL_F32_REL})
            r_err = rel_err(r, rr)
            check(r_err <= TOL_R_REL, f"K2f r: relative error {r_err} > "
                  f"{TOL_R_REL}")
            e2["r"] = {"rel_err": r_err, "limit": TOL_R_REL,
                       "max_abs_err": (r - rr).abs().max().item()}
            a_dqh, a_dwv, unsure = k8_allowance(v, qh, wv, ws, ds, r,
                                                normalize)
            e8 = {}
            for name, allow in (("dqh", a_dqh), ("dwv", a_dwv),
                                ("dws", 0.0)):
                a, b = got8[name], want8[name]
                check(bool(torch.isfinite(a).all()), f"K8f {name} not finite")
                excess = ((a - b).abs() - TOL_F32_REL * b.abs().max()
                          - allow).max().item()
                check(excess <= 0, f"K8f {name}: {excess} past its limit "
                      f"({TOL_F32_REL} of its largest value plus the ReLU "
                      f"flips' room) at B={Bq}, normalize={normalize}")
                e8[name] = {"rel_err": rel_err(a, b), "limit": TOL_F32_REL,
                            "max_abs_err": (a - b).abs().max().item()}
            print(f"K2f/K8f B={Bq} N={Nq} C={Cq} H={Hq} normalize="
                  f"{normalize}: v_att {e2['v_att']['rel_err']:.3e}, alpha "
                  f"{e2['alpha']['rel_err']:.3e}, r {r_err:.3e}; dqh "
                  f"{e8['dqh']['rel_err']:.3e}, dwv "
                  f"{e8['dwv']['rel_err']:.3e}, dws "
                  f"{e8['dws']['rel_err']:.3e} ({unsure} units within "
                  f"rounding of z = 0)")
            checks.append({"shape": [Bq, Nq, Cq, Hq], "normalize": normalize,
                           "k2f": e2, "k8f": e8, "units_near_zero": unsure})
            err2 = max(err2, *(x["max_abs_err"] for x in e2.values()))
            err8 = max(err8, *(x["max_abs_err"] for x in e8.values()))
        if Bq in (B_TRAIN, B) and (Cq, Hq) == (C, H):
            keep[Bq] = (v, qh, wv, ws, ds)
        if Bq == B_TRAIN:  # two calls of each, the model's normalize
            a = attention.attention_fwd_f32(v, qh, wv, ws, normalize=True)
            b = attention.attention_fwd_f32(v, qh, wv, ws, normalize=True)
            c = attention.attention_bwd_f32(v, qh, wv, ws, ds, a[2], True)
            d = attention.attention_bwd_f32(v, qh, wv, ws, ds, a[2], True)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(a + c, b + d)),
                  "K2f or K8f: two calls differ")
        del v
    return {"checks": checks, "inputs": keep, "err2": err2, "err8": err8}


def f32_bigru_checks(dev, gen) -> dict:
    """K6f and K7f at the stage-1 shape (B_TRAIN, T, H, lengths 1..T)
    against their plain float32 versions and bit-equal to two K1f / K3f
    calls, K7f fed K6f's hseqs; the route there is the persistent form of
    each on the plan's grid (the C side's too), with the plan's launches,
    and every form (the route's, one launch a chain, the step form) gives
    the same bits; two calls of each bit-equal."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    gxf, gxb = (torch.randn(T, B_TRAIN, 3 * H, generator=gen, device=dev)
                * 0.5 for _ in "fb")
    uhf, uhb = ((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1)
                * lim for _ in "fb")
    bhnf, bhnb = (torch.randn(H, generator=gen, device=dev) * 0.1
                  for _ in "fb")
    lens = torch.randint(1, T + 1, (B_TRAIN,), generator=gen, device=dev,
                         dtype=torch.int32)
    ghTf, ghTb = (torch.randn(B_TRAIN, H, generator=gen, device=dev)
                  for _ in "fb")
    plans = {n: gru._f32_launch_config(n, B_TRAIN, H, dev)
             for n in ("bigru_fwd_f32", "bigru_bwd_f32")}
    for n, plan in plans.items():
        check(gru._f32_route(n, B_TRAIN, H, dev) == "persistent"
              and plan["grid"] == plan["c_grid"],
              f"{n} at the stage-1 shape: route "
              f"{gru._f32_route(n, B_TRAIN, H, dev)}, plan grid "
              f"{plan['grid']}, C grid {plan['c_grid']}")
    args = (gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    counts = (gru.bigru_fwd_f32.launches, gru.bigru_bwd_f32.launches)
    got6 = gru.bigru_fwd_f32(*args)
    hsf, hsb = got6[2], got6[3]
    bwd_args = (gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf, bhnb, ghTf, ghTb)
    got7 = gru.bigru_bwd_f32(*bwd_args)
    launched = (gru.bigru_fwd_f32.launches - counts[0],
                gru.bigru_bwd_f32.launches - counts[1])
    want6 = gru.bigru_reference(*args)
    hTf1, hsf1 = gru.gru_fwd_f32(gxf, lens, uhf, bhnf)
    hTb1, hsb1 = gru.gru_fwd_f32(gxb, lens, uhb, bhnb, reverse=True)
    one6 = (hTf1, hTb1, hsf1, hsb1)
    want7 = gru.bigru_bwd_reference(*bwd_args)
    f3 = gru.gru_bwd_f32(gxf, hsf, lens, uhf, bhnf, ghTf)
    b3 = gru.gru_bwd_f32(gxb, hsb, lens, uhb, bhnb, ghTb, reverse=True)
    one7 = (f3[0], b3[0], f3[1], b3[1], f3[2], b3[2])
    again6 = gru.bigru_fwd_f32(*args)
    again7 = gru.bigru_bwd_f32(*bwd_args)
    # The other forms on the same inputs, with their launches a call (K6f's
    # 64-row tiling has no K7f twin: the route's K7f call stands there).
    forms = {}
    for form, want in (("per_chain", (2, 5)), ("persistent64", (1, 4)),
                       ("step", (T, T + kernels.GRU_F32_STEP_BWD_LAUNCHES))):
        counts = (gru.bigru_fwd_f32.launches, gru.bigru_bwd_f32.launches)
        out = (gru.bigru_fwd_f32(*args, form=form),
               gru.bigru_bwd_f32(*bwd_args, form=None if form ==
                                 "persistent64" else form))
        forms[form] = {"out": out, "want_launches": want, "launches": (
            gru.bigru_fwd_f32.launches - counts[0],
            gru.bigru_bwd_f32.launches - counts[1])}
    torch.cuda.synchronize()
    check(launched == (plans["bigru_fwd_f32"]["launches"],
                       plans["bigru_bwd_f32"]["launches"]),
          f"K6f/K7f took {launched} launches a call, the plan "
          f"{plans['bigru_fwd_f32']['launches']} and "
          f"{plans['bigru_bwd_f32']['launches']}")
    n6, n7 = ("hTf", "hTb", "hseqf", "hseqb"), ("dgxf", "dgxb", "duhf",
                                                 "duhb", "dbhnf", "dbhnb")
    e6 = f32_errors(dict(zip(n6, got6)), dict(zip(n6, want6)),
                    {k: TOL_F32_REL for k in n6})
    e7 = f32_errors(dict(zip(n7, got7)), dict(zip(n7, want7)),
                    {k: TOL_F32_REL for k in n7})
    diff6 = max((a - b).abs().max().item() for a, b in zip(got6, one6))
    diff7 = max((a - b).abs().max().item() for a, b in zip(got7, one7))
    check(diff6 == 0.0, f"K6f differs from two K1f calls by {diff6}")
    check(diff7 == 0.0, f"K7f differs from two K3f calls by {diff7}")
    check(all(torch.equal(a, b) for a, b in zip(got6 + got7,
                                                again6 + again7)),
          "K6f or K7f: two calls differ")
    diff_forms = {}
    for form, f in forms.items():
        check(f["launches"] == f["want_launches"],
              f"K6f/K7f's {form} form took {f['launches']} launches a call, "
              f"not {f['want_launches']}")
        diff_forms[form] = max((a - b).abs().max().item() for a, b in zip(
            f["out"][0] + f["out"][1], got6 + got7))
        check(diff_forms[form] == 0.0, f"K6f/K7f's {form} form differs from "
              f"the route's by {diff_forms[form]}")
    print("K6f: " + ", ".join(f"{k} {v['rel_err']:.3e}" for k, v in
                              e6.items())
          + f"; K7f: " + ", ".join(f"{k} {v['rel_err']:.3e}" for k, v in
                                   e7.items())
          + f" (limit {TOL_F32_REL}); bit-equal to two K1f / K3f calls; "
          f"grids {plans['bigru_fwd_f32']['grid']} "
          f"({plans['bigru_fwd_f32']['rows']}-row b-tiles) and "
          f"{plans['bigru_bwd_f32']['grid']} "
          f"({plans['bigru_bwd_f32']['rows']}), {launched[0]} and "
          f"{launched[1]} launches a call; the per-chain "
          f"({forms['per_chain']['launches']}), K6f's 64-row and step "
          f"({forms['step']['launches']}) forms bit-equal")
    return {"args": args, "bwd_args": bwd_args, "k6f": e6, "k7f": e7,
            "diff_vs_two_k1f": diff6, "diff_vs_two_k3f": diff7,
            "diff_vs_other_forms": diff_forms,
            "launches_a_call": {"persistent": launched, **{
                f: v["launches"] for f, v in forms.items()}},
            "plans": {n: {k: p[k] for k in ("grid", "c_grid", "rows",
                                             "launches", "blocks_per_sm",
                                             "smem_bytes")}
                      for n, p in plans.items()},
            "err6": max(v["max_abs_err"] for v in e6.values()),
            "err7": max(v["max_abs_err"] for v in e7.values())}


def f32_gathered_times(k28: dict, k67: dict, dev) -> dict:
    """K2f at the training and the serving batch (normalize on: the model's
    op), K8f at the training batch, K6f and K7f at the stage-1 shape: each
    kernel's time, its plain version's, the library yardstick's and the
    bound from this run's inputs at the FP32 FFMA peak; K6f and K7f in
    turns with two K1f / K3f calls."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention, gru

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    times = {}
    for Bq in (B_TRAIN, B):
        v, qh, wv, ws, _ = k28["inputs"][Bq]
        cells = Bq * N
        t = {"kernel": time_cuda(lambda: attention.attention_fwd_f32(
                 v, qh, wv, ws, normalize=True), buf),
             "plain": time_cuda(lambda: attention.attention_fwd_reference(
                 v, qh, wv, ws, True), buf),
             "library": time_cuda(lambda: torch.matmul(
                 v.reshape(cells, C), wv), buf),
             "library_call": f"torch.matmul([{cells}, {C}] f32, [{C}, {H}] "
                             "f32) (TF32 off): the score product alone",
             # v, W_v, qh and w_s read once; v_att, alpha and r written
             # once; the norms, the score product, h . w_s and the weighted
             # sum.
             "bound": bound_f32(cells * C * 4 + C * H * 4 + Bq * H * 4
                                + H * 4 + Bq * C * 4 + 2 * cells * 4,
                                2 * cells * C * (H + 2) + 2 * cells * H)}
        if Bq == B_TRAIN:
            t["score_launch"] = f32_launch_turns(
                "K2f score launch", lambda: attention.attention_fwd_f32(
                    v, qh, wv, ws, normalize=True), F32_SCORE_KERNEL,
                lambda: torch.matmul(v.reshape(cells, C), wv),
                2 * cells * C * H, buf)
            t["score_ms"] = t["score_launch"]["launch_ms"]
            t["score_tflops"] = t["score_launch"]["launch_tflops"]
        times["attention_fwd_f32" if Bq == B_TRAIN
              else "attention_fwd_f32_serving"] = t
    v, qh, wv, ws, ds = k28["inputs"][B_TRAIN]
    cells = B_TRAIN * N
    r = attention.attention_fwd_f32(v, qh, wv, ws, normalize=True)[2]
    vt = v.reshape(cells, C).t()
    dzr = torch.randn(cells, H, device=dev)
    times["attention_bwd_f32"] = {
        "kernel": time_cuda(lambda: attention.attention_bwd_f32(
            v, qh, wv, ws, ds, r, True), buf),
        "plain": time_cuda(lambda: attention.attention_bwd_reference(
            v, qh, wv, ws, ds, r, True), buf),
        "library": time_cuda(lambda: torch.matmul(vt, dzr), buf),
        "library_call": f"torch.matmul([{C}, {cells}] f32, [{cells}, {H}] "
                        "f32) (TF32 off): the dW_v product alone",
        "library_dz_ms": time_cuda(lambda: torch.matmul(
            v.reshape(cells, C), wv), buf),
        # v, W_v, qh, w_s, ds and r read once; dqh, dW_v and dws written
        # once; the recomputed z and dW_v products, dz and dws.
        "bound": bound_f32(cells * C * 4 + C * H * 4 + B_TRAIN * H * 4
                           + H * 4 + 2 * cells * 4 + B_TRAIN * H * 4
                           + C * H * 4 + H * 4,
                           2 * 2 * cells * C * H + 4 * cells * H)}
    t8 = times["attention_bwd_f32"]
    for part, prefix, mm in (
            ("dz", F32_DZ_KERNEL, lambda: torch.matmul(v.reshape(cells, C),
                                                       wv)),
            ("dwv", F32_DWV_KERNEL, lambda: torch.matmul(vt, dzr))):
        t8[part + "_launch"] = f32_launch_turns(
            f"K8f {part} launch", lambda: attention.attention_bwd_f32(
                v, qh, wv, ws, ds, r, True), prefix, mm, 2 * cells * C * H,
            buf)
        t8[part + "_ms"] = t8[part + "_launch"]["launch_ms"]
        t8[part + "_tflops"] = t8[part + "_launch"]["launch_tflops"]
    del vt, dzr

    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = k67["args"]
    bwd_args = k67["bwd_args"]
    Bt, nl, nc = B_TRAIN, int(lens.sum().item()), carried_steps(lens)
    lib = torch.nn.GRU(D, H, bidirectional=True).to(dev)
    lib.flatten_parameters()
    x = torch.randn(T, Bt, D, device=dev, requires_grad=True)
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens.cpu(),
                                                     enforce_sorted=False)
    _, h_n = lib(packed)
    wrt, g_n = [x, *lib.parameters()], torch.randn_like(h_n)

    def lib_fwd():
        with torch.inference_mode():
            lib(packed)

    def lib_bwd():
        torch.autograd.grad(h_n, wrt, g_n, retain_graph=True)

    def two_k1f():
        gru.gru_fwd_f32(gxf, lens, uhf, bhnf)
        gru.gru_fwd_f32(gxb, lens, uhb, bhnb, reverse=True)

    def two_k3f():
        gru.gru_bwd_f32(gxf, bwd_args[2], lens, uhf, bhnf, bwd_args[9])
        gru.gru_bwd_f32(gxb, bwd_args[3], lens, uhb, bhnb, bwd_args[10],
                        reverse=True)

    def k6f(form=None):
        return lambda: gru.bigru_fwd_f32(*k67["args"], form=form)

    def k7f(form=None):
        return lambda: gru.bigru_bwd_f32(*bwd_args, form=form)

    # In turns, in one call: the library, the kernel, the pair, the step
    # form, the step form, the pair, the kernel, the library; K6f's 64-row
    # tiling (both chains a launch) in the middle of its turns.
    turns6 = [time_cuda(fn, buf) for fn in (
        lib_fwd, k6f(), two_k1f, k6f("step"), k6f("persistent64"),
        k6f("persistent64"), k6f("step"), two_k1f, k6f(), lib_fwd)]
    turns7 = [time_cuda(fn, buf) for fn in (
        lib_bwd, k7f(), two_k3f, k7f("step"), k7f("step"), two_k3f, k7f(),
        lib_bwd)]
    # K6f's two tilings on the device alone (its one launch, from a
    # profile), in turns: 128-row, 64-row, 64-row, 128-row b-tiles.
    k6_device_ms = [kernel_device_ms(k6f(form), K6F_KERNEL, buf) for form in (
        None, "persistent64", "persistent64", None)]
    print("K6f device ms a call on 128-row / 64-row b-tiles, in turns: "
          + ", ".join(f"{t:.4f}" for t in k6_device_ms))
    # K7f's four launches apart: device ms a call, from one profile.
    k7_launch_ms = split_device_ms(k7f(), K7F_LAUNCH_KERNELS, buf)
    print("K7f launches (ms a call, both chains each): " + ", ".join(
        f"{k} {v:.4f}" for k, v in k7_launch_ms.items()))
    lib_fwd_ms, lib_bwd_ms = min(turns6[0], turns6[9]), min(turns7[0],
                                                            turns7[7])
    times["bigru_fwd_f32"] = {
        "kernel": min(turns6[1], turns6[8]),
        "turns_ms": turns6, "two_k1f": min(turns6[2], turns6[7]),
        "step_form": min(turns6[3], turns6[6]),
        "rows64": min(turns6[4], turns6[5]),
        "device_ms": {"rows128": min(k6_device_ms[0], k6_device_ms[3]),
                      "rows64": min(k6_device_ms[1], k6_device_ms[2]),
                      "turns": k6_device_ms},
        "plain": time_cuda(lambda: gru.bigru_reference(*k67["args"]), buf),
        "library": lib_fwd_ms,
        "library_call": f"torch.nn.GRU({D}, {H}, bidirectional=True) in "
                        "float32 (TF32 off) over a packed sequence, input "
                        "projection included",
        # Twice K1f's bound (phase 25): each chain's live row-steps read
        # gx once, U_h and bhn once, write hseq and hT once, one [H] x
        # [H, 3H] product a carried row-step.
        "bound": bound_f32(2 * (nl * 3 * H * 4 + 3 * H * H * 4 + H * 4
                                + T * Bt * H * 4 + Bt * H * 4) + Bt * 4,
                           2 * 2 * nc * H * 3 * H)}
    times["bigru_bwd_f32"] = {
        "kernel": min(turns7[1], turns7[6]),
        "turns_ms": turns7, "two_k3f": min(turns7[2], turns7[5]),
        "step_form": min(turns7[3], turns7[4]),
        "launch_ms": k7_launch_ms,
        "plain": time_cuda(lambda: gru.bigru_bwd_reference(*bwd_args), buf),
        "library": lib_bwd_ms,
        "library_call": f"backward of torch.nn.GRU({D}, {H}, "
                        "bidirectional=True) in float32 (TF32 off) over a "
                        "packed sequence, input-projection gradients "
                        "included",
        # Twice K3f's bound: three products a carried row-step a chain.
        "bound": bound_f32(2 * (nl * 4 * H * 4 + 3 * H * H * 4 + H * 4
                                + Bt * H * 4 + T * Bt * 3 * H * 4
                                + 3 * H * H * 4 + H * 4) + Bt * 4,
                           2 * 3 * 2 * nc * H * 3 * H)}
    for name, t in times.items():
        print(f"{name}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, library {t['library']:.4f} ms "
              f"({t['library_call']}), bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]})")
    t2 = times["attention_fwd_f32"]
    print(f"K2f score launch {t2['score_ms']:.4f} ms "
          f"({t2['score_tflops']:.1f} TFLOP/s); K8f dz launch "
          f"{t8['dz_ms']:.4f} ms ({t8['dz_tflops']:.1f} TFLOP/s), dW_v "
          f"launch {t8['dwv_ms']:.4f} ms ({t8['dwv_tflops']:.1f} TFLOP/s); "
          f"K6f {times['bigru_fwd_f32']['kernel']:.4f} ms vs two K1f "
          f"{times['bigru_fwd_f32']['two_k1f']:.4f}, its step form "
          f"{times['bigru_fwd_f32']['step_form']:.4f}, on 64-row b-tiles "
          f"{times['bigru_fwd_f32']['rows64']:.4f}; K7f "
          f"{times['bigru_bwd_f32']['kernel']:.4f} ms vs two K3f "
          f"{times['bigru_bwd_f32']['two_k3f']:.4f}, its step form "
          f"{times['bigru_bwd_f32']['step_form']:.4f} (turns: library, "
          "kernel, pair, step, [K6f: 64-row, 64-row,] step, pair, kernel, "
          "library)")
    return times


def f32_predictor(run_dir: str, plain_dir: str, dev) -> dict:
    """The float32 Predictor on ``run_dir`` (use_pallas on: K1f, K2f) at
    F32_PREDICT_BATCHES with host features: launch counts, answers and
    logits against the Predictor on ``plain_dir`` (the same parameters,
    model.use_pallas false: the plain path on the card), p50."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.serving import Predictor

    rng = np.random.default_rng(27)
    out = {}
    for bq in F32_PREDICT_BATCHES:
        pred = Predictor(run_dir, batch_size=bq)  # default device: CUDA
        plain = Predictor(plain_dir, batch_size=bq)
        check(pred.model.dtype == torch.float32 and pred.model.use_pallas
              and not plain.model.use_pallas, "float32 Predictors' flags")
        vocab = len(pred.word_vocab) - 4
        questions = [" ".join(f"w{w}" for w in rng.integers(0, vocab, n))
                     for n in rng.integers(1, T + 1, bq)]
        feats = np.maximum(rng.standard_normal((bq, N, C), np.float32), 0)
        reset_counts()
        answers = pred.answer(feats, questions)
        torch.cuda.synchronize()
        launches = read_counts()
        check_launches(launches, {"gru_fwd_f32": K1F_LAUNCHES,
                                  "attention_fwd_f32": 3},
                       f"float32 Predictor at batch {bq}")
        reset_counts()
        plain_answers = plain.answer(feats, questions)
        torch.cuda.synchronize()
        check_launches(read_counts(), {},
                       f"float32 Predictor at batch {bq}, use_pallas off")
        v = torch.from_numpy(feats).to(dev)
        q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
        with torch.inference_mode():
            lk = pred.model(v, q)["logits"]
            lr = plain.model(v, q)["logits"]
        check(tuple(lk.shape) == (bq, pred.cfg.data.num_answers)
              and bool(torch.isfinite(lk).all()), "float32 logits")
        err = (lk - lr).abs().max().item()
        top2 = lr.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOL_F32_LOGITS
        agree = all(a == b or not d for a, b, d in zip(
            answers, plain_answers, decided.tolist()))
        print(f"float32 Predictor at batch {bq}: logits vs the plain path "
              f"max abs err {err:.3e} (tol {TOL_F32_LOGITS}), answers agree "
              f"on {int(decided.sum())} decided rows: {agree}")
        check(err <= TOL_F32_LOGITS, f"float32 logits err {err}")
        check(agree, "float32 Predictor answers differ from the plain path")
        ts = []
        for i in range(RUNS + 3):
            t0 = time.perf_counter()
            pred.answer(feats, questions)  # ends in a device->host copy
            if i >= 3:
                ts.append((time.perf_counter() - t0) * 1e3)
        out[str(bq)] = {"launches": launches, "logits_max_abs_err": err,
                        "decided_rows": int(decided.sum()),
                        "p50_ms": statistics.median(ts)}
        print(f"float32 Predictor p50 at batch {bq}: "
              f"{out[str(bq)]['p50_ms']:.3f} ms")
        del pred, plain
    return out


def phase_float32_gathered(report: dict, dev, gen) -> dict:
    """Phase 27, float32 on the gathered attention and the bidirectional
    GRU: K2f, K8f, K6f and K7f against their plain versions and timed;
    fit_resident in float32 on the gathered store (K1f, K2f, K3f, K8f) and
    its gathered evaluator; the float32 Predictor (K1f, K2f); stage-1
    vlmap_description in float32 (K6f, K7f)."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.ops import gru
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    out = {"k28": f32_gathered_checks(dev, gen),
           "k67": f32_bigru_checks(dev, gen)}
    out["times"] = f32_gathered_times(out["k28"], out["k67"], dev)
    steps = F32_STEPS
    f32 = {"model.dtype": "float32"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f32g_") as tmp:
        run_dir, plain_dir = (os.path.join(tmp, d) for d in ("run", "plain"))
        os.makedirs(plain_dir)
        cfg = stage2_config(run_dir, steps, **f32,
                            **{"train.resident_fused_attention": False})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=run_dir)
        check(not spec.module.store_prenormalized, "gathered store changed")
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(tuple(batch["features"].shape) == (B_TRAIN, N, C),
              "gathered batch shape")
        out["first_step"] = check_first_step(
            spec, state, batch, dev, "float32 stage 2 (gathered)",
            loss_tol=TOL_F32_LOSS, grad_cos=F32_GRAD_COS)
        del data, make_batch, batch

        # --- this path: counts from 0 ------------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        # A step: K1f 1, K3f 4, K2f 3 (the op normalizes the grid), K8f 3;
        # no bf16 kernel.
        check_launches(launches, {
            "gru_fwd_f32": K1F_LAUNCHES * steps,
            "gru_bwd_f32": K3F_LAUNCHES * steps,
            "attention_fwd_f32": 3 * steps, "attention_bwd_f32": 3 * steps},
            f"float32 gathered stage-2 training over {steps} steps")
        out.update(launches=launches, **read_steps(
            run_dir, steps, "float32 gathered stage-2 training", "questions",
            warmup=F32_WARMUP))
        reset_counts()
        t0 = time.perf_counter()
        metrics, preds = trainer.evaluate_resident(state, val)
        torch.cuda.synchronize()
        out["eval_s"] = time.perf_counter() - t0
        batches = -(-VAL_QUESTIONS // B_TRAIN)
        out["eval_launches"] = read_counts()
        check_launches(out["eval_launches"], {
            "gru_fwd_f32": K1F_LAUNCHES * batches,
            "attention_fwd_f32": 3 * batches},
            "float32 gathered evaluation")
        check(np.isfinite(metrics["loss"]) and len(preds) == VAL_QUESTIONS,
              f"float32 gathered evaluation: {metrics}, {len(preds)} "
              "predictions")
        print(f"float32 gathered evaluation of {VAL_QUESTIONS} questions in "
              f"{out['eval_s']:.3f} s: {metrics}")
        out["eval_metrics"] = {k: float(v) for k, v in metrics.items()}

        # --- the float32 Predictor on this run's parameters --------------
        for d, over in ((run_dir, {}), (plain_dir,
                                        {"model.use_pallas": False})):
            with open(os.path.join(d, "config.json"), "w") as fh:
                fh.write(cfg.replace_flat(over).to_json())
            save_params(os.path.join(d, PARAMS_FILE),
                        spec.module.state_dict())
        trainer.close()
        out["predictor"] = f32_predictor(run_dir, plain_dir, dev)

    # --- stage 1, bidirectional, in float32 --------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f32s1_") as tmp:
        cfg = stage1_config(tmp, steps).replace_flat(f32)
        ds = load_dataset(cfg, "train", stage="vlmap_desc")
        Td = ds.arrays["desc_ids"].shape[1]
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        s1 = {"first_step": check_first_step(
            spec, state, batch, dev, "float32 stage 1",
            loss_tol=TOL_F32_LOSS, grad_cos=F32_GRAD_COS)}
        del data, make_batch, batch
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        s1["launches"] = read_counts()
        # K6f and K7f: the plan's launches a call at the stage-1 batch and
        # width (1 and 4: both chains in each launch).
        per_call = {n: gru._f32_launch_config(
            n, cfg.train.batch_size, cfg.model.rnn_dim, dev)["launches"]
            for n in ("bigru_fwd_f32", "bigru_bwd_f32")}
        check_launches(s1["launches"],
                       {n: c * steps for n, c in per_call.items()},
                       f"float32 stage-1 training over {steps} steps "
                       f"(phrases of {Td} words)")
        s1.update(read_steps(tmp, steps, "float32 stage-1 training",
                             "regions", warmup=F32_WARMUP))
        trainer.close()
        out["stage1"] = s1
    return out


def f16_gru_checks(dev, gen) -> dict:
    """K1h and K3h against their plain float16 versions at F16_BATCHES
    (B_TRAIN, then the serving batch), T and H of the main path, lengths
    1..T, both directions, K3h fed the plain version's hseq. The training
    batch's inputs are kept for the times."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru

    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    uh = ((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1)
          * lim).half()
    bhn = torch.randn(H, generator=gen, device=dev) * 0.1
    checks, keep = [], {}
    err1 = err3 = 0.0
    for batch in F16_BATCHES:
        gx = torch.randn(T, batch, 3 * H, generator=gen, device=dev) * 0.5
        lens = torch.randint(1, T + 1, (batch,), generator=gen, device=dev,
                             dtype=torch.int32)
        ghT = torch.randn(batch, H, generator=gen, device=dev)
        for reverse in (False, True):
            hT, hseq = gru.gru_fwd_f16(gx, lens, uh, bhn, reverse=reverse)
            rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
            got = dict(zip(("dgx", "duh", "dbhn"), gru.gru_bwd_f16(
                gx, rseq, lens, uh, bhn, ghT, reverse=reverse)))
            want = dict(zip(("dgx", "duh", "dbhn"), gru.gru_bwd_reference(
                gx, rseq, lens, uh, bhn, ghT, reverse=reverse)))
            torch.cuda.synchronize()
            e1 = (hseq - rseq).abs().max().item()
            check(bool(torch.isfinite(hseq).all()) and e1 <= TOL_F16_GRU,
                  f"K1h B={batch} reverse={reverse}: h error {e1} > "
                  f"{TOL_F16_GRU}")
            e3 = f32_errors(got, want, {k: TOL_F16_K3_REL for k in got})
            print(f"K1h B={batch} reverse={reverse}: h {e1:.3e} (limit "
                  f"{TOL_F16_GRU}); K3h: " + ", ".join(
                      f"{k} {v['rel_err']:.3e}" for k, v in e3.items())
                  + f" (limit {TOL_F16_K3_REL} of each output's largest)")
            checks.append({"batch": batch, "reverse": reverse,
                           "k1h_abs_err": e1, "k3h": e3})
            err1 = max(err1, e1)
            err3 = max(err3, *(v["max_abs_err"] for v in e3.values()))
        if batch == B_TRAIN:
            keep = {"gx": gx, "lens": lens, "ghT": ghT, "hseq": rseq}
    return {**keep, "uh": uh, "bhn": bhn, "checks": checks, "err1": err1,
            "err3": err3}


def f16_resident_checks(dev, gen) -> dict:
    """K4h and K5h against their plain float16 versions at the main path's
    shapes (F32_IMAGES images of 196 valid cells, C=2048, H=512) at each of
    F16_BATCHES (rows repeat), on float16 rows (normalize on and off) and
    int8 codes (off) at F16_GLIMPSES glimpses, K5h fed the plain version's
    saved h and alpha. The float16 and int8 stores of one grid are kept
    for the times."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar

    store16, _ = f32_store(dev, gen, "float16")
    g32 = store16.float()
    g32 = g32 / g32.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    scale = g32.abs().max().item() / 127
    stores = {"float16": (store16, 1.0),
              "int8": ((g32 / scale).round().to(torch.int8), scale)}
    del g32
    rows = torch.randint(0, F32_IMAGES, (B_TRAIN,), generator=gen,
                         device=dev, dtype=torch.int32)
    rows[1::7] = rows[0]  # questions about one image
    qh = torch.randn(B_TRAIN, H, generator=gen, device=dev) * 0.5
    wv = (torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * (
        6.0 / (C + H)) ** 0.5
    ws8 = torch.randn(H, 8, generator=gen, device=dev) * 0.05
    checks = []
    err4 = err5 = 0.0
    for rows_dtype, (store, sc) in stores.items():
        wv16 = (wv * sc).half()
        for batch in F16_BATCHES:
            rb, qb = rows[:batch].contiguous(), qh[:batch].contiguous()
            for G in F16_GLIMPSES:
                ws = (ws8[:, :G].contiguous() if G > 1
                      else ws8[:, 0].contiguous())
                for normalize in ((False,) if rows_dtype == "int8"
                                  else (False, True)):
                    kw = dict(n_valid=N, normalize=normalize)
                    v, a, h = ar.attention_resident_fwd_f16(
                        store, rb, qb, wv16, ws, save_h=True, **kw)
                    rv, ra, rh = ar.attention_resident_fwd_reference(
                        store, rb, qb, wv16, ws, save_h=True, **kw)
                    g = torch.randn(batch, G * C, generator=gen, device=dev)
                    sga = torch.randn(ra.shape, generator=gen,
                                      device=dev) * 0.1
                    got5 = dict(zip(("dqh", "dwv", "dws"),
                                    ar.attention_resident_bwd_f16(
                                        store, rb, rh, ws, ra, g, sga,
                                        **kw)))
                    want5 = dict(zip(("dqh", "dwv", "dws"),
                                     ar.attention_resident_bwd_reference(
                                         store, rb, rh, ws, ra, g, sga,
                                         **kw)))
                    torch.cuda.synchronize()
                    check(h.dtype == torch.float16, f"K4h saved h {h.dtype}")
                    ea = (a - ra).abs().max().item()
                    check(ea <= TOL_ALPHA, f"K4h alpha error {ea}")
                    got4, want4 = {"h": h}, {"h": rh}
                    lim4 = {"h": TOL_F16_K4_H_REL}
                    for k in range(G):
                        got4[f"v_att_{k}"] = v[:, k * C:(k + 1) * C]
                        want4[f"v_att_{k}"] = rv[:, k * C:(k + 1) * C]
                        lim4[f"v_att_{k}"] = TOL_F16_VATT_REL
                    e4 = f32_errors(got4, want4, lim4)
                    e5 = f32_errors(got5, want5, {
                        "dqh": G * TOL_F16_K5_REL, "dwv": G * TOL_F16_K5_REL,
                        "dws": TOL_F16_K5_REL})
                    vatt = max(x["rel_err"] for k, x in e4.items()
                               if k.startswith("v_att"))
                    print(f"K4h/K5h {rows_dtype} rows, B={batch}, G={G}, "
                          f"normalize={normalize}: v_att {vatt:.3e}, alpha "
                          f"{ea:.3e}, h {e4['h']['rel_err']:.3e}; dqh "
                          f"{e5['dqh']['rel_err']:.3e}, dwv "
                          f"{e5['dwv']['rel_err']:.3e}, dws "
                          f"{e5['dws']['rel_err']:.3e}")
                    checks.append({"rows": rows_dtype, "batch": batch,
                                   "glimpses": G, "normalize": normalize,
                                   "alpha_abs_err": ea, "k4h": e4,
                                   "k5h": e5})
                    err4 = max(err4, ea,
                               *(x["max_abs_err"] for x in e4.values()))
                    err5 = max(err5, *(x["max_abs_err"] for x in e5.values()))
    return {"stores": stores, "rows": rows, "qh": qh, "wv": wv,
            "ws": ws8[:, 0].contiguous(), "checks": checks, "err4": err4,
            "err5": err5}


def f16_times(k13: dict, k45: dict, dev) -> dict:
    """Each float16 kernel at the main path's shapes (K4h/K5h at G=1,
    normalize off, as the prenormalized store runs) beside its bf16
    counterpart on the same inputs (bf16 U_h, W_v and rows: the same work
    and bytes), in turns (bf16, f16, f16, bf16), each the median of RUNS
    timings; its plain version's time, the library call's (cuDNN's GRU
    and cuBLAS's GEMM in float16) and the bf16 row's bound."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar
    from vqa_transfer_externaldata_torch.ops import gru

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    gx, lens, uh, bhn = k13["gx"], k13["lens"], k13["uh"], k13["bhn"]
    hseq, ghT = k13["hseq"], k13["ghT"]
    uhb = uh.to(torch.bfloat16)
    Bt = lens.shape[0]

    def turns(bf16, f16) -> dict:
        t = [time_cuda(f, buf) for f in (bf16, f16, f16, bf16)]
        return {"kernel": (t[1] + t[2]) / 2, "bf16_ms": (t[0] + t[3]) / 2,
                "turns_ms": t}

    times = {}
    # Library yardstick of K1h and K3h: cuDNN's GRU in float16 over the
    # packed lengths; it also takes the input projection.
    lib = torch.nn.GRU(D, H).to(dev, torch.float16)
    lib.flatten_parameters()
    x = torch.randn(T, Bt, D, device=dev, dtype=torch.float16,
                    requires_grad=True)
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens.cpu(),
                                                     enforce_sorted=False)
    with torch.inference_mode():
        lib_fwd = time_cuda(lambda: lib(packed), buf)
    _, h_n = lib(packed)
    wrt, g_n = [x, *lib.parameters()], torch.randn_like(h_n)
    lib_bwd = time_cuda(
        lambda: torch.autograd.grad(h_n, wrt, g_n, retain_graph=True), buf)
    times["gru_fwd_f16"] = {
        **turns(lambda: gru.gru_fwd(gx, lens, uhb, bhn),
                lambda: gru.gru_fwd_f16(gx, lens, uh, bhn)),
        "plain": time_cuda(lambda: gru.gru_reference(gx, lens, uh, bhn), buf),
        "library": lib_fwd,
        "library_call": f"torch.nn.GRU({D}, {H}) in float16 over a packed "
                        "sequence, input projection included",
        "bound": k1_bound(lens)[0]}
    times["gru_bwd_f16"] = {
        **turns(lambda: gru.gru_bwd(gx, hseq, lens, uhb, bhn, ghT),
                lambda: gru.gru_bwd_f16(gx, hseq, lens, uh, bhn, ghT)),
        "plain": time_cuda(lambda: gru.gru_bwd_reference(
            gx, hseq, lens, uh, bhn, ghT), buf),
        "library": lib_bwd,
        "library_call": f"backward of torch.nn.GRU({D}, {H}) in float16 "
                        "over a packed sequence, input-projection gradients "
                        "included",
        "bound": k3_bound(lens)}
    rows, qh, ws = k45["rows"], k45["qh"], k45["ws"]
    kw = dict(n_valid=N, normalize=False)
    uniq = int(torch.unique(rows).numel())
    for rows_dtype, (st, sc) in k45["stores"].items():
        int8 = rows_dtype == "int8"
        sfx = "[int8]" if int8 else ""
        wv16 = (k45["wv"] * sc).half()
        wvb = (k45["wv"] * sc).to(torch.bfloat16)
        stb = st if int8 else st.to(torch.bfloat16)
        Np = st.shape[1]
        v16, a16, h16 = ar.attention_resident_fwd_f16(st, rows, qh, wv16, ws,
                                                      save_h=True, **kw)
        _, ab, hb = ar.attention_resident_fwd(stb, rows, qh, wvb, ws,
                                              save_h=True, **kw)
        g = torch.randn(Bt, C, device=dev)
        sga = torch.randn(a16.shape, device=dev) * 0.1
        # The library's products in float16 on rows gathered apart: the
        # score GEMM [B*Np, C] x [C, H] and the dW_v GEMM [C, B*n] x
        # [B*n, H].
        v16g = st[rows.long()].half().reshape(Bt * Np, C)
        vt16 = st[rows.long()][:, :N].half().reshape(Bt * N, C).t()
        dzr = torch.randn(Bt * N, H, device=dev, dtype=torch.float16)
        b4, b5 = k45_bounds(1, Bt, Np, N, uniq * Np * C * (1 if int8 else 2))
        times[f"attention_resident_fwd_f16{sfx}"] = {
            **turns(lambda: ar.attention_resident_fwd(
                stb, rows, qh, wvb, ws, save_h=True, **kw),
                lambda: ar.attention_resident_fwd_f16(
                    st, rows, qh, wv16, ws, save_h=True, **kw)),
            "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
                st, rows, qh, wv16, ws, save_h=True, **kw), buf),
            "library": time_cuda(lambda: torch.matmul(v16g, wv16), buf),
            "library_call": f"torch.matmul([{Bt * Np}, {C}] f16, [{C}, {H}] "
                            "f16): the score product alone, on rows "
                            "gathered apart",
            "library_gather_ms": time_cuda(
                lambda: st[rows.long()].half(), buf),
            "bound": b4}
        times[f"attention_resident_bwd_f16{sfx}"] = {
            **turns(lambda: ar.attention_resident_bwd(
                stb, rows, hb, ws, ab, g, sga, **kw),
                lambda: ar.attention_resident_bwd_f16(
                    st, rows, h16, ws, a16, g, sga, **kw)),
            "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
                st, rows, h16, ws, a16, g, sga, **kw), buf),
            "library": time_cuda(lambda: torch.matmul(vt16, dzr), buf),
            "library_call": f"torch.matmul([{C}, {Bt * N}] f16, [{Bt * N}, "
                            f"{H}] f16): the dW_v product alone, on rows "
                            "gathered apart",
            "bound": b5}
    for name, t in times.items():
        print(f"{name}: kernel {t['kernel']:.4f} ms beside bf16 "
              f"{t['bf16_ms']:.4f} ms (turns bf16, f16, f16, bf16: "
              + ", ".join(f"{x:.4f}" for x in t["turns_ms"])
              + f"), plain {t['plain']:.4f} ms, library "
              f"{t['library']:.4f} ms ({t['library_call']}), bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
    return times


def f16_grad_bounds(spec, state, batch, dev, gathered: bool = False
                    ) -> dict:
    """Each parameter's first-step gradient bound of a float16 run: bf16's
    GRAD_COS, unless the plain path itself moves that gradient further
    when the attention op's v_att (the resident op's, or with ``gathered``
    the gathered op's) is perturbed by F16_PERTURB of itself (what a
    kernel's order of sums does): then 1 - F16_SENSITIVITY x (1 - that
    cosine). Returns {parameter: bound} and prints the cosines under the
    perturbation."""
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar)

    mod, name = ((attention, "attention_fwd") if gathered
                 else (ar, "attention_resident_fwd"))
    with plain_kernels():  # puts the wrappers back on the way out
        _, base = first_step_grads(spec, state, batch, dev)
        plain_fwd = getattr(mod, name)
        gen = torch.Generator(device=dev).manual_seed(11)

        def perturbed(*args, **kw):
            v, *rest = plain_fwd(*args, **kw)
            noise = torch.randn(v.shape, generator=gen, device=dev)
            return (v * (1 + F16_PERTURB * noise), *rest)

        setattr(mod, name, perturbed)
        _, moved = first_step_grads(spec, state, batch, dev)
    cos = {k: torch.nn.functional.cosine_similarity(
        moved[k].flatten().float(), base[k].flatten().float(), 0).item()
        for k in base if base[k] is not None and base[k].numel() > 1}
    low = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    print(f"plain path with v_att x (1 + {F16_PERTURB} N(0, 1)): lowest "
          f"gradient cosines {low}")
    return {k: min(F16_GRAD_COS, 1 - F16_SENSITIVITY * (1 - c))
            for k, c in cos.items()}


def f16_training(dev, quantize: str) -> dict:
    """fit_resident at full width in float16 on the main corpus for
    F16_STEPS steps, on its float16 store or (``quantize`` "int8") the int8
    codes of it: the store's dtype, the first step against the plain path,
    launch counts (the float16 kernels alone), step times; then the
    resident evaluator."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    steps = F16_STEPS
    what = "float16 stage 2" + (" (int8 store)" if quantize else "")
    sfx = "[int8]" if quantize else ""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f16_") as tmp:
        cfg = stage2_config(tmp, steps, **{
            "model.dtype": "float16", "train.store_quantize": quantize})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        check(spec.module.dtype == torch.float16,
              f"{what}: model dtype {spec.module.dtype}")
        trainer = Trainer(cfg, spec, train_dir=tmp)
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        want = torch.int8 if quantize else torch.float16
        check(data["grid"].dtype == want,
              f"{what}: store uploaded as {data['grid'].dtype}")
        out["store_dtype"] = str(data["grid"].dtype)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        bounds = f16_grad_bounds(spec, state, batch, dev)
        out["first_step"] = check_first_step(
            spec, state, batch, dev, what, loss_tol=TOL_F16_LOSS,
            grad_cos=F16_GRAD_COS, grad_cos_by_param=bounds)
        del data, make_batch, batch

        # --- this path: counts from 0 ------------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        check_launches(launches, {
            "gru_fwd_f16": steps, "gru_bwd_f16": 3 * steps,
            f"attention_resident_fwd_f16{sfx}": 2 * steps,
            f"attention_resident_bwd_f16{sfx}": 3 * steps},
            f"{what} training over {steps} steps")
        out.update(launches=launches, **read_steps(
            tmp, steps, what, "questions", warmup=F16_WARMUP))
        reset_counts()
        metrics, preds = trainer.evaluate_resident(state, val)
        torch.cuda.synchronize()
        batches = -(-VAL_QUESTIONS // B_TRAIN)
        out["eval_launches"] = read_counts()
        check_launches(out["eval_launches"], {
            "gru_fwd_f16": batches,
            f"attention_resident_fwd_f16{sfx}": 2 * batches},
            f"{what} resident evaluation")
        check(np.isfinite(metrics["loss"]) and len(preds) == VAL_QUESTIONS,
              f"{what} evaluation: {metrics}, {len(preds)} predictions")
        print(f"{what} resident evaluation: {metrics}")
        out["eval_metrics"] = {k: float(v) for k, v in metrics.items()}
        trainer.close()
    return out


def phase_float16(report: dict, dev, gen) -> dict:
    """Phase 28, model.dtype float16 on the main path: the float16 kernels
    K1h, K3h, K4h and K5h against their plain versions at the main path's
    shapes and timed beside their bf16 counterparts; fit_resident at full
    width in float16 on the float16 store and on the int8 store, each
    with its first step against the plain path, launch counts and step
    times, then the resident evaluator."""
    out = {"k13": f16_gru_checks(dev, gen)}
    out["k45"] = f16_resident_checks(dev, gen)
    out["times"] = f16_times(out["k13"], out["k45"], dev)
    out["k45"].pop("stores")
    out["training"] = f16_training(dev, "")
    out["training_int8"] = f16_training(dev, "int8")
    return out


def f16_grid_inputs(dev, gen, Bq: int) -> tuple:
    """A float16 grid [Bq, N, C] (ReLU of normals, cells scaled by factors
    in [1/4, 4]) with one cell holding 300, whose square overflows float16
    so that its norm r is 0 in the kernel and in the plain version (JAX's
    square(v) in dt does the same); qh, a glorot W_v in float16 and w_s
    rounded to float16, as the op hands them to K2h and K8h."""
    import torch

    scale = torch.exp2(torch.rand(Bq, N, 1, generator=gen, device=dev) * 4
                       - 2)
    v = (torch.randn(Bq, N, C, generator=gen, device=dev).relu_() * scale
         ).half()
    v[0, 3, 5] = 300.0
    qh = torch.randn(Bq, H, generator=gen, device=dev) * 0.5
    wv = ((torch.rand(C, H, generator=gen, device=dev) * 2 - 1)
          * (6.0 / (C + H)) ** 0.5).half()
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).half().float()
    return v, qh, wv, ws


def f16_gathered_checks(dev, gen) -> dict:
    """K2h and K8h against their plain float16 versions at F16_BATCHES
    (N=196, C=2048, H=512), normalize on and off, K8h fed the same ds and
    K2h's r; the planted cell's r is 0 on both sides; two calls of each
    bit-equal at the training batch. The inputs of both batches are kept
    for the times."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention

    checks, keep = [], {}
    err2 = err8 = 0.0
    for Bq in F16_BATCHES:
        v, qh, wv, ws = f16_grid_inputs(dev, gen, Bq)
        for normalize in (True, False):
            va, al, r = attention.attention_fwd_f16(v, qh, wv, ws,
                                                    normalize=normalize)
            rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws,
                                                           normalize)
            ds = (torch.randn(Bq, N, generator=gen, device=dev) * ra
                  ).contiguous()
            got8 = attention.attention_bwd_f16(v, qh, wv, ws, ds, r,
                                               normalize)
            want8 = attention.attention_bwd_reference(v, qh, wv, ws, ds, r,
                                                      normalize)
            torch.cuda.synchronize()
            ev = (va - rv).abs().max().item()
            ea = (al - ra).abs().max().item()
            er = rel_err(r, rr)
            tol_v = TOL_F16_VATT_REL * rv.abs().max().item()
            check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
                  "K2h output not finite")
            check(ev <= tol_v, f"K2h B={Bq} normalize={normalize}: v_att "
                  f"error {ev} > {tol_v}")
            check(ea <= TOL_ALPHA, f"K2h B={Bq} normalize={normalize}: "
                  f"alpha error {ea} > {TOL_ALPHA}")
            check(er <= TOL_R_REL, f"K2h B={Bq}: r relative error {er}")
            if normalize:
                check(r[0, 3].item() == 0.0 and rr[0, 3].item() == 0.0,
                      f"K2h: the planted cell's r is {r[0, 3].item()} "
                      f"(plain {rr[0, 3].item()}), not 0")
            a_dqh, a_dwv, unsure = k8_allowance(v, qh, wv, ws, ds, r,
                                                normalize)
            e8 = {}
            for name, a, b, allow in zip(("dqh", "dwv", "dws"), got8, want8,
                                         (a_dqh, a_dwv, 0.0)):
                limit = TOL_F16_K8_REL * b.abs().max().item() + allow
                worst = ((a - b).abs() / limit).max().item()
                check(bool(torch.isfinite(a).all()), f"K8h {name} not finite")
                check(worst <= 1.0, f"K8h B={Bq} normalize={normalize} "
                      f"{name}: an entry at {worst} of its limit")
                e8[name] = {"rel_err": rel_err(a, b), "limit": TOL_F16_K8_REL,
                            "max_abs_err": (a - b).abs().max().item(),
                            "worst_share_of_limit": worst}
            print(f"K2h/K8h B={Bq} normalize={normalize}: v_att {ev:.3e} "
                  f"(tol {tol_v:.3e}), alpha {ea:.3e}, r {er:.3e}; dqh "
                  f"{e8['dqh']['rel_err']:.3e}, dwv {e8['dwv']['rel_err']:.3e}"
                  f", dws {e8['dws']['rel_err']:.3e} of each largest (limit "
                  f"{TOL_F16_K8_REL:.3e} + the flips' room, {unsure} units "
                  "within rounding of z = 0)")
            checks.append({"batch": Bq, "normalize": normalize,
                           "v_att_err": ev, "v_att_tol": tol_v,
                           "alpha_err": ea, "r_rel_err": er, "k8h": e8,
                           "units_near_zero": unsure})
            err2 = max(err2, ev, ea)
            err8 = max(err8, *(x["max_abs_err"] for x in e8.values()))
        keep[Bq] = (v, qh, wv, ws, ds)
    v, qh, wv, ws, ds = keep[B_TRAIN]
    a = attention.attention_fwd_f16(v, qh, wv, ws, normalize=True)
    b = attention.attention_fwd_f16(v, qh, wv, ws, normalize=True)
    c = attention.attention_bwd_f16(v, qh, wv, ws, ds, a[2], True)
    d = attention.attention_bwd_f16(v, qh, wv, ws, ds, a[2], True)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a + c, b + d)),
          "K2h or K8h: two calls differ")
    return {"checks": checks, "inputs": keep, "err2": err2, "err8": err8}


def f16_bigru_checks(dev, gen) -> dict:
    """K6h and K7h at F16_BATCHES (T, H of stage 1, lengths 1..T) against
    their plain float16 versions and bit-equal to two K1h / K3h calls, K7h
    fed K6h's hseqs; two calls of each bit-equal. The training batch's
    inputs are kept for the times."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru

    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    uhf, uhb = ((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1)
                * lim).half(), ((torch.rand(H, 3 * H, generator=gen,
                                            device=dev) * 2 - 1) * lim).half()
    bhnf, bhnb = (torch.randn(H, generator=gen, device=dev) * 0.1
                  for _ in "fb")
    n6, n7 = ("hTf", "hTb", "hseqf", "hseqb"), ("dgxf", "dgxb", "duhf",
                                                 "duhb", "dbhnf", "dbhnb")
    checks, keep = [], {}
    err6 = err7 = 0.0
    for Bq in F16_BATCHES:
        gxf, gxb = (torch.randn(T, Bq, 3 * H, generator=gen, device=dev)
                    * 0.5 for _ in "fb")
        lens = torch.randint(1, T + 1, (Bq,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[0], lens[1] = T, 1  # the longest and the shortest phrase
        ghTf, ghTb = (torch.randn(Bq, H, generator=gen, device=dev) * 0.05
                      for _ in "fb")
        args = (gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
        got6 = gru.bigru_fwd_f16(*args)
        want6 = gru.bigru_reference(*args)
        hTf, hsf = gru.gru_fwd_f16(gxf, lens, uhf, bhnf)
        hTb, hsb = gru.gru_fwd_f16(gxb, lens, uhb, bhnb, reverse=True)
        bwd_args = (gxf, gxb, got6[2], got6[3], lens, uhf, uhb, bhnf, bhnb,
                    ghTf, ghTb)
        got7 = gru.bigru_bwd_f16(*bwd_args)
        want7 = gru.bigru_bwd_reference(*bwd_args)
        f3 = gru.gru_bwd_f16(gxf, got6[2], lens, uhf, bhnf, ghTf)
        b3 = gru.gru_bwd_f16(gxb, got6[3], lens, uhb, bhnb, ghTb,
                             reverse=True)
        again6 = gru.bigru_fwd_f16(*args)
        again7 = gru.bigru_bwd_f16(*bwd_args)
        torch.cuda.synchronize()
        e6 = max((a - b).abs().max().item() for a, b in zip(got6, want6))
        check(all(bool(torch.isfinite(a).all()) for a in got6 + got7),
              "K6h or K7h output not finite")
        check(e6 <= TOL_F16_GRU, f"K6h B={Bq}: h error {e6} > "
              f"{TOL_F16_GRU}")
        e7 = f32_errors(dict(zip(n7, got7)), dict(zip(n7, want7)),
                        {k: TOL_F16_K3_REL for k in n7})
        diff6 = max((a - b).abs().max().item()
                    for a, b in zip(got6, (hTf, hTb, hsf, hsb)))
        diff7 = max((a - b).abs().max().item() for a, b in zip(
            got7, (f3[0], b3[0], f3[1], b3[1], f3[2], b3[2])))
        check(diff6 == 0.0, f"K6h differs from two K1h calls by {diff6}")
        check(diff7 == 0.0, f"K7h differs from two K3h calls by {diff7}")
        check(all(torch.equal(a, b) for a, b in zip(got6 + got7,
                                                    again6 + again7)),
              "K6h or K7h: two calls differ")
        print(f"K6h B={Bq}: h {e6:.3e} (limit {TOL_F16_GRU}); K7h: "
              + ", ".join(f"{k} {x['rel_err']:.3e}" for k, x in e7.items())
              + f" (limit {TOL_F16_K3_REL} of each largest); bit-equal to "
              "two K1h / K3h calls")
        checks.append({"batch": Bq, "k6h_abs_err": e6, "k7h": e7,
                       "diff_vs_two_k1h_calls": diff6,
                       "diff_vs_two_k3h_calls": diff7})
        err6 = max(err6, e6)
        err7 = max(err7, *(x["max_abs_err"] for x in e7.values()))
        if Bq == B_TRAIN:
            keep = {"args": args, "bwd_args": bwd_args}
    return {**keep, "checks": checks, "err6": err6, "err7": err7}


def f16_gathered_times(k28: dict, k67: dict, dev) -> dict:
    """K2h at the training and the serving batch (normalize on, the
    model's op), K8h at the training batch, K6h and K7h at stage 1's
    shape, each beside its bf16 kernel on the same inputs (bf16 copies:
    the same work and bytes) in turns (bf16, f16, f16, bf16), each the
    median of RUNS timings; its plain version's time, the library call's
    in float16 (cuBLAS's score and dW_v GEMMs, cuDNN's bidirectional GRU)
    and the bf16 row's bound from this run's inputs."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention, gru

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    bf = torch.bfloat16

    def turns(bf16, f16) -> dict:
        t = [time_cuda(f, buf) for f in (bf16, f16, f16, bf16)]
        return {"kernel": (t[1] + t[2]) / 2, "bf16_ms": (t[0] + t[3]) / 2,
                "turns_ms": t}

    times = {}
    for Bq in F16_BATCHES:
        v, qh, wv, ws, _ = k28["inputs"][Bq]
        vb, wvb = v.to(bf), wv.to(bf)
        cells = Bq * N
        times["attention_fwd_f16" + ("" if Bq == B_TRAIN else "_serving")] = {
            **turns(lambda: attention.attention_fwd(vb, qh, wvb, ws,
                                                    normalize=True),
                    lambda: attention.attention_fwd_f16(v, qh, wv, ws,
                                                        normalize=True)),
            "plain": time_cuda(lambda: attention.attention_fwd_reference(
                v, qh, wv, ws, True), buf),
            "library": time_cuda(lambda: torch.matmul(
                v.view(cells, C), wv), buf),
            "library_call": f"torch.matmul([{cells}, {C}] f16, [{C}, {H}] "
                            "f16): the score product alone",
            "bound": k2_bound(Bq)}
    v, qh, wv, ws, ds = k28["inputs"][B_TRAIN]
    vb, wvb = v.to(bf), wv.to(bf)
    cells = B_TRAIN * N
    r = attention.attention_fwd_f16(v, qh, wv, ws, normalize=True)[2]
    dzr = torch.randn(cells, H, device=dev, dtype=torch.float16)
    times["attention_bwd_f16"] = {
        **turns(lambda: attention.attention_bwd(vb, qh, wvb, ws, ds, r, True),
                lambda: attention.attention_bwd_f16(v, qh, wv, ws, ds, r,
                                                    True)),
        "plain": time_cuda(lambda: attention.attention_bwd_reference(
            v, qh, wv, ws, ds, r, True), buf),
        "library": time_cuda(lambda: torch.matmul(v.view(cells, C).t(), dzr),
                             buf),
        "library_call": f"torch.matmul([{C}, {cells}] f16 (the grid, "
                        f"transposed), [{cells}, {H}] f16): the dW_v product "
                        "alone",
        "bound": k8_bound(B_TRAIN)}
    del dzr, vb

    args, bwd_args = k67["args"], k67["bwd_args"]
    lens = args[2]
    args_b = (*args[:3], args[3].to(bf), args[4].to(bf), *args[5:])
    bwd_b = (*bwd_args[:5], bwd_args[5].to(bf), bwd_args[6].to(bf),
             *bwd_args[7:])
    lib = torch.nn.GRU(D, H, bidirectional=True).to(dev, torch.float16)
    lib.flatten_parameters()
    x = torch.randn(T, B_TRAIN, D, device=dev, dtype=torch.float16,
                    requires_grad=True)
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens.cpu(),
                                                     enforce_sorted=False)
    with torch.inference_mode():
        lib_fwd = time_cuda(lambda: lib(packed), buf)
    _, h_n = lib(packed)
    wrt, g_n = [x, *lib.parameters()], torch.randn_like(h_n)
    lib_bwd = time_cuda(
        lambda: torch.autograd.grad(h_n, wrt, g_n, retain_graph=True), buf)
    b6, b7 = k67_bounds(lens)
    times["bigru_fwd_f16"] = {
        **turns(lambda: gru.bigru_fwd(*args_b),
                lambda: gru.bigru_fwd_f16(*args)),
        "plain": time_cuda(lambda: gru.bigru_reference(*args), buf),
        "library": lib_fwd,
        "library_call": f"torch.nn.GRU({D}, {H}, bidirectional=True) in "
                        "float16 over a packed sequence, input projection "
                        "included",
        "bound": b6}
    times["bigru_bwd_f16"] = {
        **turns(lambda: gru.bigru_bwd(*bwd_b),
                lambda: gru.bigru_bwd_f16(*bwd_args)),
        "plain": time_cuda(lambda: gru.bigru_bwd_reference(*bwd_args), buf),
        "library": lib_bwd,
        "library_call": f"backward of torch.nn.GRU({D}, {H}, "
                        "bidirectional=True) in float16 over a packed "
                        "sequence, input-projection gradients included",
        "bound": b7}
    for name, t in times.items():
        print(f"{name}: kernel {t['kernel']:.4f} ms beside bf16 "
              f"{t['bf16_ms']:.4f} ms (turns bf16, f16, f16, bf16: "
              + ", ".join(f"{x:.4f}" for x in t["turns_ms"])
              + f"), plain {t['plain']:.4f} ms, library "
              f"{t['library']:.4f} ms ({t['library_call']}), bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
    return times


def f16_predictor(run_dir: str, dev) -> dict:
    """The float16 Predictor on ``run_dir`` (K1h, K2h) at
    F16_PREDICT_BATCHES with host features: launch counts, the model's
    logits against the plain path on the card within TOL_F16_LOGITS, its
    answers where the plain path's top two logits are further apart than
    that, p50."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.serving import Predictor

    rng = np.random.default_rng(29)
    out = {}
    for bq in F16_PREDICT_BATCHES:
        pred = Predictor(run_dir, batch_size=bq)  # default device: CUDA
        check(pred.model.dtype == torch.float16, "float16 Predictor dtype")
        vocab = len(pred.word_vocab) - 4
        questions = [" ".join(f"w{w}" for w in rng.integers(0, vocab, n))
                     for n in rng.integers(1, T + 1, bq)]
        feats = np.maximum(rng.standard_normal((bq, N, C), np.float32), 0)
        reset_counts()
        answers = pred.answer(feats, questions)
        torch.cuda.synchronize()
        launches = read_counts()
        check_launches(launches, {"gru_fwd_f16": 1, "attention_fwd_f16": 2},
                       f"float16 Predictor at batch {bq}")
        v = torch.from_numpy(feats).to(dev)
        q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
        with torch.inference_mode():
            lk = pred.model(v, q)["logits"]
            with plain_kernels():
                lr = pred.model(v, q)["logits"]
        check(tuple(lk.shape) == (bq, pred.cfg.data.num_answers)
              and bool(torch.isfinite(lk).all()), "float16 logits")
        err = (lk - lr).abs().max().item()
        top2 = lr.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOL_F16_LOGITS
        plain_answers = [pred.answer_vocab.tokens[int(i)]
                         for i in lr.argmax(-1)]
        agree = all(a == b or not d for a, b, d in zip(
            answers, plain_answers, decided.tolist()))
        print(f"float16 Predictor at batch {bq}: logits vs the plain path "
              f"max abs err {err:.3e} (tol {TOL_F16_LOGITS}), answers agree "
              f"on {int(decided.sum())} decided rows: {agree}")
        check(err <= TOL_F16_LOGITS, f"float16 logits err {err}")
        check(agree, "float16 Predictor answers differ from the plain path")
        ts = []
        for i in range(RUNS + 3):
            t0 = time.perf_counter()
            pred.answer(feats, questions)  # ends in a device->host copy
            if i >= 3:
                ts.append((time.perf_counter() - t0) * 1e3)
        out[str(bq)] = {"launches": launches, "logits_max_abs_err": err,
                        "decided_rows": int(decided.sum()),
                        "p50_ms": statistics.median(ts)}
        print(f"float16 Predictor p50 at batch {bq}: "
              f"{out[str(bq)]['p50_ms']:.3f} ms")
        del pred
    return out


def f16_gathered_training(dev) -> dict:
    """fit_resident at full width in float16 on the gathered store
    (train.resident_fused_attention false: K1h, K2h, K3h, K8h) for
    F16_STEPS steps, its first step against the plain path (phase 28's
    bounds, the gathered op's v_att perturbed), launch counts, step times;
    its gathered evaluator; the float16 Predictor on its parameters."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    steps = F16_STEPS
    what = "float16 gathered stage 2"
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f16g_") as tmp:
        cfg = stage2_config(tmp, steps, **{
            "model.dtype": "float16",
            "train.resident_fused_attention": False})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        check(spec.module.dtype == torch.float16,
              f"{what}: model dtype {spec.module.dtype}")
        trainer = Trainer(cfg, spec, train_dir=tmp)
        check(not spec.module.store_prenormalized, "gathered store changed")
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        check(data["grid"].dtype == torch.float16,
              f"{what}: store uploaded as {data['grid'].dtype}")
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(tuple(batch["features"].shape) == (B_TRAIN, N, C),
              "gathered batch shape")
        bounds = f16_grad_bounds(spec, state, batch, dev, gathered=True)
        out["first_step"] = check_first_step(
            spec, state, batch, dev, what, loss_tol=TOL_F16_LOSS,
            grad_cos=F16_GRAD_COS, grad_cos_by_param=bounds)
        del data, make_batch, batch

        # --- this path: counts from 0 ------------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        # A step: K1h 1, K3h 3, K2h 2, K8h 4; no bf16 or float32 kernel.
        check_launches(launches, {
            "gru_fwd_f16": steps, "gru_bwd_f16": 3 * steps,
            "attention_fwd_f16": 2 * steps, "attention_bwd_f16": 4 * steps},
            f"{what} training over {steps} steps")
        out.update(launches=launches, **read_steps(
            tmp, steps, what, "questions", warmup=F16_WARMUP))
        reset_counts()
        t0 = time.perf_counter()
        metrics, preds = trainer.evaluate_resident(state, val)
        torch.cuda.synchronize()
        out["eval_s"] = time.perf_counter() - t0
        batches = -(-VAL_QUESTIONS // B_TRAIN)
        out["eval_launches"] = read_counts()
        check_launches(out["eval_launches"], {
            "gru_fwd_f16": batches, "attention_fwd_f16": 2 * batches},
            f"{what} gathered evaluation")
        check(np.isfinite(metrics["loss"]) and len(preds) == VAL_QUESTIONS,
              f"{what} evaluation: {metrics}, {len(preds)} predictions")
        print(f"{what} gathered evaluation of {VAL_QUESTIONS} questions in "
              f"{out['eval_s']:.3f} s: {metrics}")
        out["eval_metrics"] = {k: float(v) for k, v in metrics.items()}
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
        save_params(os.path.join(tmp, PARAMS_FILE), spec.module.state_dict())
        trainer.close()
        out["predictor"] = f16_predictor(tmp, dev)
    return out


def f16_streamed(dev) -> dict:
    """Stage-2 training in float16 through cli.train on streamed host
    batches of the flat layout (train.device_data_cache false):
    F16_STREAM_STEPS steps over F16_STREAM_QUESTIONS questions, each
    batch's grid cast to float16 on its way to the card; K1h, K2h, K3h,
    K8h."""
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli

    steps = F16_STREAM_STEPS
    flags = {"data.synthetic": True, "data.synthetic_layout": "flat",
             "data.synthetic_size": F16_STREAM_QUESTIONS,
             "train.device_data_cache": False, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             "model.dtype": "float16", **MODEL_OVERRIDES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f16s_") as tmp:
        argv = ["--train.train_dir", tmp] + cli_argv(flags)
        # --- this path: counts from 0 ------------------------------------
        reset_counts()
        t0 = time.perf_counter()
        train_dir = train_cli.main(argv)  # default device: CUDA
        torch.cuda.synchronize()
        out = {"cli_s": time.perf_counter() - t0, "launches": read_counts()}
        check_launches(out["launches"], {
            "gru_fwd_f16": steps, "gru_bwd_f16": 3 * steps,
            "attention_fwd_f16": 2 * steps, "attention_bwd_f16": 4 * steps},
            f"float16 streamed stage-2 training over {steps} steps")
        out.update(read_steps(train_dir, steps,
                              "float16 streamed stage-2 training",
                              "questions", warmup=2))
    return out


def f16_stage1_transfer(dev) -> dict:
    """Stage-1 vlmap_description with the bidirectional encoder in float16
    through fit_resident (K6h, K7h) for F16_STEPS steps, its first step
    against the plain path, launch counts, step times; then its parameters
    through cli.train --train.pretrained_param_path into float16 stage-2
    training (gather-free: K1h, K3h, K4h, K5h) for F16_TRANSFER_STEPS
    steps, the word table frozen: it arrives bit for bit."""
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import (
        load_params, save_params)

    steps, f16 = F16_STEPS, {"model.dtype": "float16"}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f16s1_") as root:
        s1_dir = os.path.join(root, "stage1")
        cfg = stage1_config(s1_dir, steps).replace_flat(f16)
        ds = load_dataset(cfg, "train", stage="vlmap_desc")
        Td = ds.arrays["desc_ids"].shape[1]
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        check(spec.module.dtype == torch.float16, "float16 stage-1 dtype")
        trainer = Trainer(cfg, spec, train_dir=s1_dir)
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        out["first_step"] = check_first_step(
            spec, state, batch, dev, "float16 stage 1",
            loss_tol=TOL_F16_LOSS, grad_cos=F16_GRAD_COS)
        del data, make_batch, batch
        # --- this path: counts from 0 ------------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        out["launches"] = read_counts()
        # K6h: one persistent launch for both chains' Td steps; K7h 3.
        check_launches(out["launches"], {"bigru_fwd_f16": steps,
                                         "bigru_bwd_f16": 3 * steps},
                       f"float16 stage-1 training over {steps} steps "
                       f"(phrases of {Td} words)")
        out.update(read_steps(s1_dir, steps, "float16 stage-1 training",
                              "regions", warmup=F16_WARMUP))
        params = os.path.join(s1_dir, PARAMS_FILE)
        save_params(params, spec.module.state_dict())
        trainer.close()

        t_steps = F16_TRANSFER_STEPS
        flags = {"data.synthetic": True, "data.synthetic_layout": "joined",
                 "data.synthetic_size": TRANSFER_QUESTIONS,
                 "train.device_data_cache": True,
                 "train.batch_size": B_TRAIN, "train.max_steps": t_steps,
                 "train.log_every": 1,
                 "train.freeze_params": "word_emb,answer_embedding",
                 "train.pretrained_param_path": params, **f16,
                 **MODEL_OVERRIDES}
        argv = ["--train.train_dir", os.path.join(root, "stage2")] + \
            cli_argv(flags)
        reset_counts()
        train_dir = train_cli.main(argv)  # default device: CUDA
        torch.cuda.synchronize()
        out["transfer_launches"] = read_counts()
        check_launches(out["transfer_launches"], {
            "gru_fwd_f16": t_steps, "gru_bwd_f16": 3 * t_steps,
            "attention_resident_fwd_f16": 2 * t_steps,
            "attention_resident_bwd_f16": 3 * t_steps},
            f"float16 stage-2 training after the transfer over {t_steps} "
            "steps")
        out["transfer"] = read_steps(train_dir, t_steps,
                                     "float16 stage-2 training after the "
                                     "transfer", "questions", warmup=2)
        words = load_params(params)["word_emb.embedding"]
        got = load_params(os.path.join(train_dir, PARAMS_FILE))
        check(torch.equal(got["word_emb.embedding"], words),
              "float16 transfer: the word table did not arrive bit for bit")
        print(f"float16 transfer: word table {tuple(words.shape)} arrived "
              "bit for bit")
    return out


def phase_float16_gathered(report: dict, dev, gen) -> dict:
    """Phase 29, model.dtype float16 off the main path: K2h, K8h, K6h and
    K7h against their plain versions at the main path's shapes and timed
    beside their bf16 kernels; fit_resident in float16 on the gathered
    store with its evaluator and the float16 Predictor on its parameters;
    the streamed loop; stage 1 with the bidirectional encoder and its
    transfer into a float16 stage 2."""
    out = {"k28": f16_gathered_checks(dev, gen),
           "k67": f16_bigru_checks(dev, gen)}
    out["times"] = f16_gathered_times(out["k28"], out["k67"], dev)
    out["k28"].pop("inputs")
    for k in ("args", "bwd_args"):
        out["k67"].pop(k)
    t0 = time.perf_counter()
    out["gathered"] = f16_gathered_training(dev)
    out["streamed"] = f16_streamed(dev)
    out["stage1"] = f16_stage1_transfer(dev)
    out["paths_s"] = time.perf_counter() - t0
    return out


def gru_width_bounds(lens, Hh: int, f32: bool = False) -> tuple:
    """K1's and K3's bounds (k1_bound's and k3_bound's counts) at width
    ``Hh`` and this run's lengths: the step form does the same work, so
    its bound is the same. With ``f32``, K1f's and K3f's: U_h in float32,
    the products at the FFMA peak."""
    nl, nb, nc = int(lens.sum().item()), lens.shape[0], carried_steps(lens)
    uh, at = (4, bound_f32) if f32 else (2, bound)
    k1 = at(nl * 3 * Hh * 4 + nb * 4 + Hh * 3 * Hh * uh + Hh * 4
            + T * nb * Hh * 4 + nb * Hh * 4, 2 * nc * Hh * 3 * Hh)
    k3 = at(nl * 4 * Hh * 4 + nb * 4 + Hh * 3 * Hh * uh + Hh * 4
            + nb * Hh * 4 + T * nb * 3 * Hh * 4 + Hh * 3 * Hh * 4
            + Hh * 4, 3 * 2 * nc * Hh * 3 * Hh)
    return k1, k3


def widths_gru_inputs(dev, Tt: int, Bt: int, Hh: int, dtype, seed: int):
    """GRU inputs at (Tt, Bt, Hh): gx, lengths 1..Tt (the first row Tt),
    U_h in ``dtype`` at Glorot-like scale, b_hn, a final-state cotangent."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    gx = torch.randn(Tt, Bt, 3 * Hh, generator=g, device=dev) * 0.5
    lens = torch.randint(1, Tt + 1, (Bt,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0] = Tt
    uh = (torch.randn(Hh, 3 * Hh, generator=g, device=dev)
          * Hh ** -0.5).to(dtype)
    bhn = torch.randn(Hh, generator=g, device=dev) * 0.1
    ghT = torch.randn(Bt, Hh, generator=g, device=dev)
    return gx, lens, uh, bhn, ghT


def width_name(base: str, dtype, form: str = "persistent") -> str:
    """The wrapper that counts a launch: ``base`` ("gru_fwd", "bigru_bwd",
    ...), its step form's "_wide", its float16 build's "_f16"."""
    import torch

    return (base + ("_wide" if form == "step" else "")
            + ("_f16" if dtype == torch.float16 else ""))


class WidthErrors:
    """Each wrapper's largest error against its plain version over the
    sweep (``err``: the largest, ``ratio``: of error to limit), and every
    check."""

    def __init__(self) -> None:
        self.err, self.ratio, self.checks = {}, {}, []

    def note(self, name: str, err: float, limit: float, **where) -> None:
        self.checks.append({"kernel": name, "err": err, "limit": limit,
                            **where})
        check(err <= limit, f"widths: {name} at {where}: error {err} over "
              f"{limit}")
        self.err[name] = max(self.err.get(name, 0.0), err)
        self.ratio[name] = max(self.ratio.get(name, 0.0), err / limit)


def widths_gru_checks(dev, errs: WidthErrors) -> None:
    """K1/K3/K6/K7 and their float16 builds at WIDTH_H units (T=7, B=20)
    and at WIDE_RNN (the training shape) against their plain versions,
    on the form each route takes (the step form past the persistent
    kernels' shared memory); K6/K7 bit-equal to two K1/K3 calls."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    for dtype in (torch.bfloat16, torch.float16):
        step = 1.0 if dtype == torch.bfloat16 else 0.125
        for Hh in WIDTH_H + WIDE_RNN:
            Tt, Bt = (7, 20) if Hh in WIDTH_H else (T, B_TRAIN)
            f = widths_gru_inputs(dev, Tt, Bt, Hh, dtype, Hh)
            b = widths_gru_inputs(dev, Tt, Bt, Hh, dtype, Hh + 1)
            lens = f[1]
            Hf = kernels.round_up(Hh, kernels.GRU_FWD_PAD)
            Hb = kernels.round_up(Hh, kernels.GRU_BWD_PAD)
            fwd = width_name("gru_fwd", dtype, gru._fwd_route(
                width_name("gru_fwd", dtype), Bt, Hf, dev))
            bwd = width_name("gru_bwd", dtype, gru._bwd_route(
                width_name("gru_bwd", dtype), Bt, Hb, dev, 1))
            outs, e1, e3 = [], 0.0, 0.0
            for d, (gx, _, uh, bhn, ghT) in enumerate((f, b)):
                rev = bool(d)
                hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=rev)
                _, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=rev)
                e1 = max(e1, (hseq - rseq).abs().max().item())
                got = gru.gru_bwd(gx, rseq, lens, uh, bhn, ghT, reverse=rev)
                want = gru.gru_bwd_reference(gx, rseq, lens, uh, bhn, ghT,
                                             reverse=rev)
                e3 = max([e3] + [rel_err(a, w) for a, w in zip(got, want)])
                outs.append((hT, hseq, rseq, got))
            errs.note(fwd, e1, TOL_GRU * step, H=Hh)
            errs.note(bwd, e3, TOL_K3_REL * step, H=Hh)
            k6 = gru.bigru_fwd(f[0], b[0], lens, f[2], b[2], f[3], b[3])
            k7 = gru.bigru_bwd(f[0], b[0], outs[0][2], outs[1][2], lens,
                               f[2], b[2], f[3], b[3], f[4], b[4])
            torch.cuda.synchronize()
            two = (outs[0][0], outs[1][0], outs[0][1], outs[1][1])
            check(all(torch.equal(x, y) for x, y in zip(k6, two)),
                  f"widths: K6 at H={Hh} ({dtype}) differs from two K1 calls")
            check(all(torch.equal(x, outs[i % 2][3][i // 2])
                      for i, x in enumerate(k7)),
                  f"widths: K7 at H={Hh} ({dtype}) differs from two K3 calls")
            # K6/K7 equal two K1/K3 calls, so their errors against their
            # plain versions are those; each takes its own route.
            f6 = width_name("bigru_fwd", dtype, gru._fwd_route(
                width_name("bigru_fwd", dtype), Bt, Hf, dev))
            f7 = width_name("bigru_bwd", dtype, gru._bwd_route(
                width_name("bigru_bwd", dtype), Bt, Hb, dev, 2))
            errs.note(f6, e1, TOL_GRU * step, H=Hh,
                      equal_to_two_one_direction_calls=True)
            errs.note(f7, e3, TOL_K3_REL * step, H=Hh,
                      equal_to_two_one_direction_calls=True)


def widths_attention_checks(dev, errs: WidthErrors) -> None:
    """K2/K8 and K4/K5 (their float16 builds, and K4/K5 on int8 codes) at
    every (C, H) of WIDTH_C x WIDTH_H against their plain versions: the
    gathered pair at B=3, N=13 with the per-cell norm (the model's mode),
    the resident pair on a 5-image store of 13 valid cells at G = 1 and 2
    without it (the prenormalized main path)."""
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar)

    g = torch.Generator(device=dev).manual_seed(30)
    for dtype in (torch.bfloat16, torch.float16):
        step = 1.0 if dtype == torch.bfloat16 else 0.125
        for Cc in WIDTH_C:
            for Hh in WIDTH_H:
                where = {"C": Cc, "H": Hh}
                v = (torch.randn(3, 13, Cc, generator=g, device=dev).relu()
                     * torch.exp2(torch.rand(3, 13, 1, generator=g,
                                             device=dev) * 4 - 2)).to(dtype)
                qh = torch.randn(3, Hh, generator=g, device=dev) * 0.5
                wv = (torch.randn(Cc, Hh, generator=g, device=dev)
                      * (6.0 / (Cc + Hh)) ** 0.5).to(dtype)
                ws = (torch.randn(Hh, generator=g, device=dev) * 0.1).to(
                    dtype).float()
                va, al, r = attention.attention_fwd(v, qh, wv, ws,
                                                    normalize=True)
                rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws,
                                                               True)
                name = width_name("attention_fwd", dtype)
                errs.note(name, rel_err(va, rv), TOL_VATT_REL, **where)
                errs.note(name, (al - ra).abs().max().item(), TOL_ALPHA,
                          **where)
                errs.note(name, rel_err(r, rr), TOL_R_REL, **where)
                ds = (torch.randn(3, 13, generator=g, device=dev)
                      * ra).contiguous()
                got = attention.attention_bwd(v, qh, wv, ws, ds, rr, True)
                want = attention.attention_bwd_reference(v, qh, wv, ws, ds,
                                                         rr, True)
                a_dqh, a_dwv, _ = k8_allowance(v, qh, wv, ws, ds, rr, True)
                worst = 0.0
                for a, w, allow in zip(got, want, (a_dqh, a_dwv, 0.0)):
                    over = (a - w).abs() - allow
                    worst = max(worst, over.max().item()
                                / max(w.abs().max().item(), 1e-30))
                errs.note(width_name("attention_bwd", dtype), max(worst, 0.0),
                          TOL_K8_REL * step, **where)
                store = (torch.randn(5, 16, Cc, generator=g, device=dev)
                         .relu())
                store[:, 13:] = 0
                rows = torch.randint(0, 5, (8,), generator=g, device=dev,
                                     dtype=torch.int32)
                qr = torch.randn(8, Hh, generator=g, device=dev) * 0.5
                for rows_type in ("float", "int8"):
                    st = (int8_codes(store)[0] if rows_type == "int8"
                          else store.to(dtype))
                    sfx = "[int8]" if rows_type == "int8" else ""
                    for G in (1, 2):
                        wsg = torch.randn(Hh, G, generator=g, device=dev) * 0.1
                        wsg = wsg if G > 1 else wsg[:, 0].contiguous()
                        kw = dict(n_valid=13, normalize=False)
                        va, al, h = ar.attention_resident_fwd(
                            st, rows, qr, wv, wsg, save_h=True, **kw)
                        rv, ra, rh = ar.attention_resident_fwd_reference(
                            st, rows, qr, wv, wsg, save_h=True, **kw)
                        name = width_name("attention_resident_fwd",
                                          dtype) + sfx
                        for k in range(G):
                            sl = slice(k * Cc, (k + 1) * Cc)
                            errs.note(name, rel_err(va[:, sl], rv[:, sl]),
                                      TOL_VATT_REL, G=G, **where)
                        errs.note(name, (al - ra).abs().max().item(),
                                  TOL_ALPHA, G=G, **where)
                        errs.note(name, rel_err(h.float(), rh.float()),
                                  TOL_K4_H_REL * step, G=G, **where)
                        gv = torch.randn(8, G * Cc, generator=g, device=dev)
                        sga = torch.randn(ra.shape, generator=g, device=dev)
                        got = ar.attention_resident_bwd(
                            st, rows, rh, wsg, ra, gv, sga, **kw)
                        want = ar.attention_resident_bwd_reference(
                            st, rows, rh, wsg, ra, gv, sga, **kw)
                        name = width_name("attention_resident_bwd",
                                          dtype) + sfx
                        for i, (a, w) in enumerate(zip(got, want)):
                            errs.note(name, rel_err(a, w),
                                      TOL_K5_REL * step * (G if i < 2
                                                           else 1),
                                      G=G, output=("dqh", "dwv", "dws")[i],
                                      **where)
    torch.cuda.synchronize()


def widths_gru_times(dev) -> dict:
    """K1's and K3's step forms at the training batch (B=256, T=26) at
    each of WIDE_RNN (their float16 builds too), called directly (at 1024
    the persistent K1 is timed too), each beside its plain version,
    torch.nn.GRU's packed forward or backward in the same dtype at the
    same width (its input projection from D=300 included) and the bound;
    the forward's device ms a step and the BPTT's device ms by launch (the
    copy of the states, every step's gh, the carry steps, dU_h, db_hn);
    K6's and K7's step forms at 1024 beside two K1/K3 step-form calls.
    Launches of one call each."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        for Hh in WIDE_RNN:
            gx, lens, uh, bhn, ghT = widths_gru_inputs(dev, T, B_TRAIN, Hh,
                                                       dtype, 7)
            _, hseq = gru.gru_reference(gx, lens, uh, bhn)
            (b1, b3) = gru_width_bounds(lens, Hh)
            fw, bw = width_name("gru_fwd", dtype, "step"), width_name(
                "gru_bwd", dtype, "step")
            fwd = getattr(gru, fw)
            bwd = getattr(gru, bw)
            reset_counts()
            fwd(gx, lens, uh, bhn)
            bwd(gx, hseq, lens, uh, bhn, ghT)
            torch.cuda.synchronize()
            calls = read_counts()
            lib = torch.nn.GRU(D, Hh).to(dev, dtype)
            lib.flatten_parameters()
            x = torch.randn(T, B_TRAIN, D, device=dev, dtype=dtype,
                            requires_grad=True)
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x, lens.cpu(), enforce_sorted=False)
            with torch.inference_mode():
                lib_f = time_cuda(lambda: lib(packed), buf)
            _, h_n = lib(packed)
            g_n = torch.randn_like(h_n)
            wrt = [x, *lib.parameters()]
            lib_b = time_cuda(lambda: torch.autograd.grad(
                h_n, wrt, g_n, retain_graph=True), buf)
            key = f"H{Hh}"
            out[fw + "@" + key] = {
                "kernel": time_cuda(lambda: fwd(gx, lens, uh, bhn), buf),
                "plain": time_cuda(
                    lambda: gru.gru_reference(gx, lens, uh, bhn), buf),
                "library": lib_f, "bound": b1, "launches_a_call": calls[fw],
                "library_call": f"torch.nn.GRU({D}, {Hh}) in {dtype} over a "
                                "packed sequence, input projection included",
                "device_ms_a_step": split_device_ms(
                    lambda: fwd(gx, lens, uh, bhn),
                    {"step": "wide::gru_wide_fwd_kernel"}, buf)["step"] / T}
            if Hh <= 1568:  # where the persistent kernel fits
                out[fw + "@" + key]["persistent_ms"] = time_cuda(
                    lambda: gru._gru_fwd16(gx, lens, uh, bhn, False, dtype,
                                           "persistent"), buf)
            out[bw + "@" + key] = {
                "kernel": time_cuda(
                    lambda: bwd(gx, hseq, lens, uh, bhn, ghT), buf),
                "plain": time_cuda(lambda: gru.gru_bwd_reference(
                    gx, hseq, lens, uh, bhn, ghT), buf),
                "library": lib_b, "bound": b3, "launches_a_call": calls[bw],
                "library_call": f"backward of torch.nn.GRU({D}, {Hh}) in "
                                f"{dtype} over a packed sequence, "
                                "input-projection gradients included",
                "split_ms": split_device_ms(
                    lambda: bwd(gx, hseq, lens, uh, bhn, ghT),
                    STEP_BPTT_PARTS, buf),
                # a carry launch's clusters against those the card holds
                # at once: more would run in turns
                "carry_clusters": [
                    math.prod(kernels.gru_step_plan(T, B_TRAIN, Hh, True)[
                        "grid"]) // kernels.GRU_STEP_CLUSTER,
                    gru.gru_step_clusters(B_TRAIN, Hh, dev, dtype)]}
            del lib, x, packed, h_n
        # K6's and K7's step forms at 1024: both chains in each launch.
        Hh = WIDE_RNN[0]
        f = widths_gru_inputs(dev, T, B_TRAIN, Hh, dtype, 8)
        b = widths_gru_inputs(dev, T, B_TRAIN, Hh, dtype, 9)
        lens = f[1]
        _, _, hsf, hsb = gru.bigru_reference(f[0], b[0], lens, f[2], b[2],
                                             f[3], b[3])
        b1, b3 = gru_width_bounds(lens, Hh)
        f6, f7 = (width_name("bigru_fwd", dtype, "step"),
                  width_name("bigru_bwd", dtype, "step"))
        k6, k7 = getattr(gru, f6), getattr(gru, f7)
        one_f = getattr(gru, width_name("gru_fwd", dtype, "step"))
        one_b = getattr(gru, width_name("gru_bwd", dtype, "step"))
        reset_counts()
        k6(f[0], b[0], lens, f[2], b[2], f[3], b[3])
        k7(f[0], b[0], hsf, hsb, lens, f[2], b[2], f[3], b[3], f[4], b[4])
        torch.cuda.synchronize()
        calls = read_counts()
        lib = torch.nn.GRU(D, Hh, bidirectional=True).to(dev, dtype)
        lib.flatten_parameters()
        x = torch.randn(T, B_TRAIN, D, device=dev, dtype=dtype,
                        requires_grad=True)
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, lens.cpu(), enforce_sorted=False)
        with torch.inference_mode():
            lib_f = time_cuda(lambda: lib(packed), buf)
        _, h_n = lib(packed)
        g_n = torch.randn_like(h_n)
        wrt = [x, *lib.parameters()]
        lib_b = time_cuda(lambda: torch.autograd.grad(
            h_n, wrt, g_n, retain_graph=True), buf)

        def two_fwd():
            one_f(f[0], lens, f[2], f[3])
            one_f(b[0], lens, b[2], b[3], reverse=True)

        def two_bwd():
            one_b(f[0], hsf, lens, f[2], f[3], f[4])
            one_b(b[0], hsb, lens, b[2], b[3], b[4], reverse=True)

        key = f"H{Hh}"
        out[f6 + "@" + key] = {
            "kernel": time_cuda(lambda: k6(f[0], b[0], lens, f[2], b[2],
                                           f[3], b[3]), buf),
            "two_k1_ms": time_cuda(two_fwd, buf),
            "plain": time_cuda(lambda: gru.bigru_reference(
                f[0], b[0], lens, f[2], b[2], f[3], b[3]), buf),
            "library": lib_f, "bound": (2 * b1[0], b1[1]),
            "launches_a_call": calls[f6],
            "library_call": f"torch.nn.GRU({D}, {Hh}, bidirectional=True) "
                            f"in {dtype} over a packed sequence"}
        out[f7 + "@" + key] = {
            "kernel": time_cuda(lambda: k7(f[0], b[0], hsf, hsb, lens, f[2],
                                           b[2], f[3], b[3], f[4], b[4]),
                                buf),
            "two_k3_ms": time_cuda(two_bwd, buf),
            "plain": time_cuda(lambda: gru.bigru_bwd_reference(
                f[0], b[0], hsf, hsb, lens, f[2], b[2], f[3], b[3], f[4],
                b[4]), buf),
            "library": lib_b, "bound": (2 * b3[0], b3[1]),
            "launches_a_call": calls[f7],
            "library_call": f"backward of torch.nn.GRU({D}, {Hh}, "
                            f"bidirectional=True) in {dtype} over a packed "
                            "sequence"}
        del lib, x, packed, h_n
    # At 512 units both forms run: each step form against the persistent
    # kernel the route takes there, in turns (persistent, step, step,
    # persistent).
    gx, lens, uh, bhn, ghT = widths_gru_inputs(dev, T, B_TRAIN, H,
                                               torch.bfloat16, 6)
    _, hseq = gru.gru_reference(gx, lens, uh, bhn)
    pairs = {"forward": (lambda: gru.gru_fwd(gx, lens, uh, bhn),
                         lambda: gru.gru_fwd_wide(gx, lens, uh, bhn)),
             "backward": (lambda: gru.gru_bwd(gx, hseq, lens, uh, bhn, ghT),
                          lambda: gru.gru_bwd_wide(gx, hseq, lens, uh, bhn,
                                                   ghT))}
    both = {}
    for what, (persistent, step) in pairs.items():
        turns = [time_cuda(f, buf) for f in (persistent, step, step,
                                             persistent)]
        both[what] = {"persistent_ms": (turns[0] + turns[3]) / 2,
                      "step_ms": (turns[1] + turns[2]) / 2,
                      "turns_ms": turns}
        print(f"at H={H}, B={B_TRAIN}, {what}: persistent "
              f"{both[what]['persistent_ms']:.4f} ms, step form "
              f"{both[what]['step_ms']:.4f} ms (turns {turns})")
    for k, t in out.items():
        print(f"{k}: {t['kernel']:.3f} ms (plain {t['plain']:.3f}, library "
              f"{t['library']:.3f}, bound {t['bound'][0]:.4f} by "
              f"{t['bound'][1]}; {t['launches_a_call']} launches a call)"
              + (f"; device ms a step {t['device_ms_a_step']:.4f}"
                 if "device_ms_a_step" in t else "")
              + (f"; split {t['split_ms']}, carry clusters (a launch's, "
                 f"the card's at once) {t['carry_clusters']}"
                 if "split_ms" in t else ""))
    out[f"both_forms@H{H}"] = both
    return out


def widths_gru_crossover(dev) -> dict:
    """The forward's two forms at B = 256 and at the serving batch B, T =
    26, in bf16 across CROSSOVER_H, in turns (persistent, step, step,
    persistent): at each batch the widest swept width up to which the
    persistent K1 is the faster, and up to which it is within
    CROSSOVER_ROOM of the step form, at every swept width; the crossover,
    the narrower of the two batches' latter, beside
    kernels.GRU_FWD_STEP_ABOVE, the route's."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    out = {"route_step_above": kernels.GRU_FWD_STEP_ABOVE}
    for Bt in (B_TRAIN, B):
        rows = {}
        for Hh in CROSSOVER_H:
            gx, lens, uh, bhn, _ = widths_gru_inputs(dev, T, Bt, Hh,
                                                     torch.bfloat16, 11)
            forms = [lambda f=f: gru._gru_fwd16(gx, lens, uh, bhn, False,
                                                torch.bfloat16, f)
                     for f in ("persistent", "step")]
            turns = [time_cuda(forms[i], buf) for i in (0, 1, 1, 0)]
            rows[Hh] = {"persistent_ms": (turns[0] + turns[3]) / 2,
                        "step_ms": (turns[1] + turns[2]) / 2,
                        "turns_ms": turns}
        def up_to(room):
            widest = 0
            for Hh in CROSSOVER_H:
                if rows[Hh]["persistent_ms"] > room * rows[Hh]["step_ms"]:
                    break
                widest = Hh
            return widest

        out[f"B{Bt}"] = {"by_width": rows,
                         "persistent_faster_up_to": up_to(1.0),
                         "persistent_within_room_up_to": up_to(
                             CROSSOVER_ROOM)}
        print(f"forward forms at B={Bt}, T={T} (bf16): " + ", ".join(
            f"H={Hh} {r['persistent_ms']:.4f}/{r['step_ms']:.4f}"
            for Hh, r in rows.items()) + " ms persistent/step; the "
            f"persistent K1 faster up to H={up_to(1.0)}, within "
            f"{CROSSOVER_ROOM} up to H={up_to(CROSSOVER_ROOM)}")
    out["crossover"] = min(out[f"B{Bt}"]["persistent_within_room_up_to"]
                           for Bt in (B_TRAIN, B))
    print(f"the forward's crossover: H={out['crossover']} (the route's "
          f"kernels.GRU_FWD_STEP_ABOVE: {kernels.GRU_FWD_STEP_ABOVE})")
    return out


def widths_pad_times(dev) -> dict:
    """What padding costs: K2, K8 (B=256, N=196) and K4, K5 (a 512-image
    store of 196 valid cells, B=256, G=1) at each (C, H) of PAD_SHAPES,
    timed in turns (the multiple, the others, then again in reverse);
    (2048, 500) pads H to 512 (W_v, qh, ws and, for K5, the saved h), and
    (2000, 512) pads C: a copy of v a call for K2/K8, of the batch's store
    rows for K4/K5 on a store not padded at upload."""
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar)

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(31)
    calls = {}
    for Cc, Hh in PAD_SHAPES:
        v = (torch.randn(B_TRAIN, N, Cc, generator=g, device=dev).relu()
             ).to(torch.bfloat16)
        qh = torch.randn(B_TRAIN, Hh, generator=g, device=dev) * 0.5
        wv = (torch.randn(Cc, Hh, generator=g, device=dev)
              * (6.0 / (Cc + Hh)) ** 0.5).to(torch.bfloat16)
        ws = (torch.randn(Hh, generator=g, device=dev) * 0.1).bfloat16(
            ).float()
        _, al, r = attention.attention_fwd(v, qh, wv, ws, normalize=True)
        ds = (torch.randn(B_TRAIN, N, generator=g, device=dev)
              * al).contiguous()
        store = torch.zeros(512, 200, Cc, device=dev, dtype=torch.bfloat16)
        store[:, :N] = torch.randn(512, N, Cc, generator=g, device=dev
                                   ).relu().bfloat16()
        rows = torch.randint(0, 512, (B_TRAIN,), generator=g, device=dev,
                             dtype=torch.int32)
        kw = dict(n_valid=N, normalize=False)
        _, ra, rh = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                              save_h=True, **kw)
        gv = torch.randn(B_TRAIN, Cc, generator=g, device=dev)
        sga = torch.randn(ra.shape, generator=g, device=dev)
        calls[(Cc, Hh)] = {
            "attention_fwd": lambda v=v, qh=qh, wv=wv, ws=ws:
                attention.attention_fwd(v, qh, wv, ws, normalize=True),
            "attention_bwd": lambda v=v, qh=qh, wv=wv, ws=ws, ds=ds, r=r:
                attention.attention_bwd(v, qh, wv, ws, ds, r, True),
            "attention_resident_fwd": lambda s=store, rw=rows, qh=qh, wv=wv,
                ws=ws: ar.attention_resident_fwd(s, rw, qh, wv, ws,
                                                  save_h=True, **kw),
            "attention_resident_bwd": lambda s=store, rw=rows, h=rh, ws=ws,
                a=ra, gv=gv, sga=sga: ar.attention_resident_bwd(
                    s, rw, h, ws, a, gv, sga, **kw)}
    order = list(PAD_SHAPES) + list(reversed(PAD_SHAPES))
    out = {}
    for name in ("attention_fwd", "attention_bwd", "attention_resident_fwd",
                 "attention_resident_bwd"):
        runs = {shape: [] for shape in PAD_SHAPES}
        for shape in order:
            runs[shape].append(time_cuda(calls[shape][name], buf))
        base = statistics.mean(runs[PAD_SHAPES[0]])
        out[name] = {f"{c}x{h}": {"ms": statistics.mean(runs[(c, h)]),
                                  "turns_ms": runs[(c, h)],
                                  "over_multiple_ms":
                                  statistics.mean(runs[(c, h)]) - base}
                     for c, h in PAD_SHAPES}
        print(f"padding's cost, {name}: " + ", ".join(
            f"{k} {t['ms']:.3f} ms ({t['over_multiple_ms']:+.3f})"
            for k, t in out[name].items()))
    return out


def widths_stage2(dev, rnn: int, dtype: str, steps: int,
                  first_step: bool) -> dict:
    """fit_resident at full width but ``model.rnn_dim`` ``rnn`` in
    ``dtype`` on the main corpus for ``steps`` steps, gather-free: with
    ``first_step`` its first step against the plain path (phase 9's
    bounds) and, after training, the resident evaluator on the
    VAL_QUESTIONS split; launch counts on each GRU form's route, finite
    losses, step times."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.ops import gru, kernels
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    what = f"stage 2 at rnn_dim {rnn} in {dtype}"
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_widths_") as tmp:
        cfg = stage2_config(tmp, steps, **{"model.rnn_dim": rnn,
                                           "model.dtype": dtype})
        dt = getattr(torch, dtype)
        ds = load_dataset(cfg, "train")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)
        state = trainer.init_state()
        if first_step:
            data, make_batch, _ = trainer._prepare_resident(ds)
            idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
            batch = make_batch(torch.from_numpy(idx0).to(dev))
            out["first_step"] = check_first_step(spec, state, batch, dev,
                                                 what)
            del data, make_batch, batch
        Tq = cfg.data.max_question_len
        fwd_form = gru._fwd_route(width_name("gru_fwd", dt), B_TRAIN,
                                  kernels.round_up(rnn, kernels.GRU_FWD_PAD),
                                  dev)
        bwd_form = gru._bwd_route(width_name("gru_bwd", dt), B_TRAIN,
                                  kernels.round_up(rnn, kernels.GRU_BWD_PAD),
                                  dev, 1)
        Hs = kernels.round_up(rnn, kernels.GRU_STEP_PAD)
        fwd_n = (1 if fwd_form == "persistent" else kernels.gru_step_plan(
            Tq, B_TRAIN, Hs, False)["launches"])
        bwd_n = (3 if bwd_form == "persistent" else kernels.gru_step_plan(
            Tq, B_TRAIN, Hs, True)["launches"])
        fwd = width_name("gru_fwd", dt, fwd_form)
        # --- this path: counts from 0 ------------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        out["launches"] = read_counts()
        check_launches(out["launches"], {
            fwd: fwd_n * steps,
            width_name("gru_bwd", dt, bwd_form): bwd_n * steps,
            width_name("attention_resident_fwd", dt): 2 * steps,
            width_name("attention_resident_bwd", dt): 3 * steps},
            f"{what} over {steps} steps")
        out.update(forms={"forward": fwd_form, "backward": bwd_form},
                   **read_steps(tmp, steps, what, "questions", warmup=2))
        if first_step:
            val = load_dataset(cfg.replace_flat(
                {"data.synthetic_size": VAL_QUESTIONS}), "val")
            reset_counts()
            metrics, preds = trainer.evaluate_resident(state, val)
            torch.cuda.synchronize()
            n = -(-VAL_QUESTIONS // B_TRAIN)
            out["eval_launches"] = read_counts()
            check_launches(out["eval_launches"], {
                fwd: fwd_n * n,
                width_name("attention_resident_fwd", dt): 2 * n},
                f"{what}: the resident evaluator")
            check(np.isfinite(metrics["loss"])
                  and len(preds) == VAL_QUESTIONS,
                  f"{what} evaluation: {metrics}, {len(preds)} predictions")
            print(f"{what} resident evaluation: {metrics}")
            out["eval_metrics"] = {k: float(v) for k, v in metrics.items()}
        trainer.close()
    return out


def widths_stage1(dev, rnn: int, dtype: str, steps: int,
                  first_step: bool) -> dict:
    """Stage-1 vlmap_description with the bidirectional encoder at
    ``model.rnn_dim`` ``rnn`` in ``dtype`` through fit_resident for
    ``steps`` steps: with ``first_step`` its first step against the plain
    path; launch counts of K6 and K7 on their routes, finite losses, step
    times."""
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.ops import gru, kernels
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    what = f"stage 1 at rnn_dim {rnn} in {dtype}"
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_widths_s1_") as tmp:
        cfg = stage1_config(tmp, steps).replace_flat(
            {"model.rnn_dim": rnn, "model.dtype": dtype})
        dt = getattr(torch, dtype)
        ds = load_dataset(cfg, "train", stage="vlmap_desc")
        Td = ds.arrays["desc_ids"].shape[1]
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)
        state = trainer.init_state()
        if first_step:
            data, make_batch, _ = trainer._prepare_resident(ds)
            idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
            batch = make_batch(torch.from_numpy(idx0).to(dev))
            out["first_step"] = check_first_step(spec, state, batch, dev,
                                                 what)
            del data, make_batch, batch
        Hf = kernels.round_up(rnn, kernels.GRU_FWD_PAD)
        fwd_form = gru._fwd_route(width_name("bigru_fwd", dt), B_TRAIN, Hf,
                                  dev)
        Hb = kernels.round_up(rnn, kernels.GRU_BWD_PAD)
        bwd_form = gru._bwd_route(width_name("bigru_bwd", dt), B_TRAIN, Hb,
                                  dev, 2)
        fwd_n = (gru.bigru_fwd_launch_config(B_TRAIN, Hf, dev, dt)[
            "launches"] if fwd_form == "persistent" else
            kernels.gru_step_plan(Td, B_TRAIN, Hf, False, 2)["launches"])
        bwd_n = (3 if bwd_form == "persistent" else
                 kernels.gru_step_plan(Td, B_TRAIN, Hb, True, 2)["launches"])
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        out["launches"] = read_counts()
        check_launches(out["launches"], {
            width_name("bigru_fwd", dt, fwd_form): fwd_n * steps,
            width_name("bigru_bwd", dt, bwd_form): bwd_n * steps},
            f"{what} over {steps} steps (phrases of {Td} words)")
        out.update(forms={"forward": fwd_form, "backward": bwd_form},
                   **read_steps(tmp, steps, what, "regions", warmup=2))
        trainer.close()
    return out


def widths_tiny(dev) -> dict:
    """tools/oov_claim.py's TINY config (the JAX tests' tiny widths: GRU
    16, attention 16, 32 channels) in bf16 through the entry points:
    cli.train stage 1 (vlmap), cli.train stage 2 transfer-initialized from
    it with the word table frozen (streamed gathered batches: K1, K3, K2,
    K8 at widths their kernels pad), cli.eval on the run and the
    Predictor on its parameters (logits against the plain path)."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.serving import (PARAMS_FILE,
                                                         Predictor)
    from vqa_transfer_externaldata_torch.tools import oov_claim
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

    steps = TINY_STEPS
    flags = {**oov_claim.TINY, "model.dtype": "bfloat16",
             "train.max_steps": steps, "train.log_every": 1}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiny_") as root:
        s1, s2 = os.path.join(root, "vlmap"), os.path.join(root, "vqa")
        reset_counts()
        train_cli.main(["--train.train_dir", s1] + cli_argv(
            {**flags, "model.model": "vlmap"}))
        torch.cuda.synchronize()
        out["stage1_launches"] = read_counts()
        check_launches(out["stage1_launches"], {},
                       "TINY stage 1 (vlmap: no kernel)")
        params1 = os.path.join(s1, PARAMS_FILE)
        reset_counts()
        train_cli.main(["--train.train_dir", s2] + cli_argv({
            **flags, "model.model": "vqa_attention",
            "train.pretrained_param_path": params1,
            "train.freeze_params": "word_emb,answer_embedding"}))
        torch.cuda.synchronize()
        out["stage2_launches"] = read_counts()
        check_launches(out["stage2_launches"], {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_fwd": 2 * steps, "attention_bwd": 4 * steps},
            f"TINY stage 2 in bf16 over {steps} steps")
        out["stage2"] = read_steps(s2, steps, "TINY stage 2 in bf16",
                                   "questions", warmup=2,
                                   batch=flags["train.batch_size"])
        words = load_params(params1)["word_emb.embedding"]
        got = load_params(os.path.join(s2, PARAMS_FILE))
        check(torch.equal(got["word_emb.embedding"], words),
              "TINY transfer: the word table did not arrive bit for bit")
        reset_counts()
        res = eval_cli.main(["--train.train_dir", s2])
        torch.cuda.synchronize()
        out["eval_launches"] = read_counts()
        check(out["eval_launches"]["gru_fwd"] >= 1
              and out["eval_launches"]["attention_fwd"]
              == 2 * out["eval_launches"]["gru_fwd"]
              and np.isfinite(res["loss"]),
              f"TINY cli.eval: {res}, launches {out['eval_launches']}")
        out["cli_eval"] = res
        pred = Predictor(s2, batch_size=B_PREDICT)
        rng = np.random.default_rng(30)
        vocab = len(pred.word_vocab) - 4
        Tq, Cq = flags["data.max_question_len"], flags["data.feature_dim"]
        Nq = flags["data.grid_h"] * flags["data.grid_w"]
        questions = [" ".join(f"w{w}" for w in rng.integers(0, vocab, n))
                     for n in rng.integers(1, Tq + 1, B_PREDICT)]
        feats = np.maximum(rng.standard_normal((B_PREDICT, Nq, Cq),
                                               np.float32), 0)
        reset_counts()
        answers = pred.answer(feats, questions)
        torch.cuda.synchronize()
        out["predict_launches"] = read_counts()
        check_launches(out["predict_launches"], {"gru_fwd": 1,
                                                 "attention_fwd": 2},
                       "TINY Predictor")
        v = torch.from_numpy(feats).to(dev)
        q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
        with torch.inference_mode():
            lk = pred.model(v, q)["logits"]
            with plain_kernels():
                lr = pred.model(v, q)["logits"]
        err = (lk - lr).abs().max().item()
        check(len(answers) == B_PREDICT and err <= TOL_LOGITS,
              f"TINY Predictor: logits against the plain path {err}")
        out["predict_logits_max_abs_err"] = err
        print(f"TINY in bf16: cli.eval {res}; Predictor logits against the "
              f"plain path {err:.3e} (tol {TOL_LOGITS})")
    return out


def phase_widths(report: dict, dev) -> dict:
    """Phase 30, widths: every 16-bit kernel at the width sweep against its
    plain version (widths_gru_checks, widths_attention_checks); the GRU's
    step forms and the padding timed (widths_gru_times,
    widths_pad_times); stage 2 at each of WIDE_RNN and stage 1 at
    WIDE_RNN[0] in bf16 (first steps against the plain path, the resident
    evaluator), their float16 twins at WIDE_RNN[-1] for a few steps; and
    oov_claim's TINY in bf16 through both stages, the transfer, cli.eval
    and the Predictor. Within WIDTHS_BUDGET_S."""
    t0 = time.perf_counter()
    errs = WidthErrors()
    widths_gru_checks(dev, errs)
    widths_attention_checks(dev, errs)
    out = {"errors": errs.err, "error_to_limit": errs.ratio,
           "checks": len(errs.checks)}
    print(f"widths: {len(errs.checks)} checks; each wrapper's largest "
          f"error to its limit: {errs.ratio}")
    out["gru_times"] = widths_gru_times(dev)
    out["gru_crossover"] = widths_gru_crossover(dev)
    out["pad_times"] = widths_pad_times(dev)
    wide = WIDE_RNN[-1]
    for rnn in WIDE_RNN:
        out[f"stage2_rnn{rnn}"] = widths_stage2(dev, rnn, "bfloat16",
                                                WIDE_STEPS, True)
    out[f"stage2_rnn{wide}_f16"] = widths_stage2(dev, wide, "float16",
                                                 WIDE_F16_STEPS, False)
    out[f"stage1_rnn{WIDE_RNN[0]}"] = widths_stage1(
        dev, WIDE_RNN[0], "bfloat16", WIDE_STEPS, True)
    for dtype, tag in (("bfloat16", ""), ("float16", "_f16")):
        out[f"stage1_rnn{wide}{tag}"] = widths_stage1(
            dev, wide, dtype, WIDE_F16_STEPS, False)
    out["tiny"] = widths_tiny(dev)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 30 took {out['phase_s']:.1f} s (budget {WIDTHS_BUDGET_S} "
          "s)")
    return out


def input_modules() -> dict:
    """What phase 31 can run here: whether ``grain`` and ``dm-tree``
    (grain's tree library where JAX is not loaded) import, whether
    libjpeg's headers exist, which libjpeg Pillow ships and whether the
    port's header copies are there (the decoder's second route), printed
    before the phase."""
    import importlib.util
    import shutil

    from vqa_transfer_externaldata_torch.data import native

    found = {"grain": importlib.util.find_spec("grain") is not None,
             "dm-tree": importlib.util.find_spec("tree") is not None,
             "jpeglib.h": os.path.exists("/usr/include/jpeglib.h"),
             "pillow_libjpeg": native.pillow_libjpeg(),
             "port_jpeg_headers": (native.INCLUDE_DIR / "jpeglib.h").exists(),
             "g++": shutil.which("g++") is not None,
             "cpu_count": os.cpu_count()}
    print(f"phase 31 finds: {json.dumps(found)}")
    return found


def input_gathers(root: str, seed: int) -> dict:
    """(a) The native gathers on a raw store in the COCO grid's layout,
    bit for bit against numpy's fancy indexing, and their host times on
    this machine's CPU (the store was just written: warm in the page
    cache)."""
    import numpy as np
    from vqa_transfer_externaldata_torch.data import native
    from vqa_transfer_externaldata_torch.data.features import FeatureStore

    path = os.path.join(root, "store")
    t0 = time.perf_counter()
    write_raw_store(path, np.arange(INPUT_IMAGES), GRID, C, seed)
    out = {"store_write_s": time.perf_counter() - t0,
           "store_mb": INPUT_IMAGES * (N + 2) * C * 2 / 1e6}
    check(native.available(), "the native IO library did not build")
    store = FeatureStore(path)
    idx = np.random.default_rng(seed + 1).integers(
        0, INPUT_IMAGES, INPUT_GATHER).astype(np.int32)
    runs = {
        "gather_f16_widen": lambda: native.gather_f16(store.grid, idx),
        "gather_f16": lambda: native.gather_f16(store.grid, idx,
                                                widen=False),
        "gather_f32": lambda: native.gather_f32(store.pool5, idx),
        "numpy_f16_widen": lambda: store.grid[idx].astype(np.float32),
        "numpy_f32": lambda: store.pool5[idx]}
    want = {"gather_f16_widen": runs["numpy_f16_widen"](),
            "gather_f16": store.grid[idx], "gather_f32": store.pool5[idx]}
    for name, ref in want.items():
        got = runs[name]()
        check(got.shape == ref.shape and got.dtype == ref.dtype
              and np.array_equal(got.view(np.uint8), np.ascontiguousarray(
                  ref).view(np.uint8)),
              f"native {name} of {INPUT_GATHER} rows differs from numpy's")
    ms = {}
    for name, fn in runs.items():
        times = []
        for _ in range(INPUT_RUNS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
    out.update({"bit_equal": True, "rows": INPUT_GATHER,
                "host_ms_median": ms, "threads": native._threads(),
                "cpu_count": os.cpu_count()})
    print(f"native gathers of {INPUT_GATHER} rows of {GRID}x{GRID}x{C} f16 "
          f"(bit-equal to numpy), host ms on this machine's CPU "
          f"({os.cpu_count()} cores, {native._threads()} threads): "
          f"{json.dumps(ms)}")
    return out


def input_decode(root: str, seed: int) -> dict:
    """(b) Seeded JPEGs (half at 448 x 448, half 640 x 480) and a CMYK
    file through ``ImageQuestionDataset.take``: one native call a batch,
    each pixel within INPUT_DECODE_STEP of PIL's (equal at the file's own
    size), the CMYK file decoded by PIL; host times of the batch."""
    import numpy as np
    from PIL import Image
    from vqa_transfer_externaldata_torch.data import ingest, native

    check(native.jpeg_available(), "the native JPEG library did not build "
          "by either route (the system's libjpeg, Pillow's)")
    route = native.jpeg_route()
    print(f"native JPEG decoder built by the {route} route")
    size, rng = 32 * GRID, np.random.default_rng(seed + 2)
    paths = []
    for i in range(INPUT_JPEGS):
        h, w = (size, size) if i % 2 else (480, 640)
        coarse = rng.integers(0, 256, (15, 20, 3)).astype(np.uint8)
        paths.append(os.path.join(root, f"img{i}.jpg"))
        Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
            paths[-1], quality=90)
    paths.append(os.path.join(root, "cmyk.jpg"))
    Image.open(paths[0]).convert("CMYK").save(paths[-1], quality=90)
    rows = {"image_index": np.arange(len(paths), dtype=np.int32)}
    ds = ingest.ImageQuestionDataset(rows, paths, image_size=size)
    t0 = time.perf_counter()
    images = ds.take(np.arange(len(paths)))["images"]
    take_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pil = np.stack([ingest._decode_pil(p, size) for p in paths])
    pil_ms = (time.perf_counter() - t0) * 1e3
    ds.close()
    diff = np.abs(images.astype(np.int16) - pil.astype(np.int16))
    own = diff[1:-1:2].max()
    resized = diff[0:-1:2].max()
    check(own == 0 and resized <= INPUT_DECODE_STEP
          and np.array_equal(images[-1], pil[-1]),
          f"native decode: {own} at the file's size, {resized} resized "
          f"(limit {INPUT_DECODE_STEP}), CMYK row equal to PIL's: "
          f"{np.array_equal(images[-1], pil[-1])}")
    out = {"route": route, "images": len(paths),
           "max_step_own_size": int(own),
           "max_step_resized": int(resized), "cmyk_equal_pil": True,
           "take_host_ms": take_ms, "pil_one_thread_host_ms": pil_ms}
    print(f"native decode of {len(paths)} JPEGs through "
          f"ImageQuestionDataset.take: {json.dumps(out)}")
    return out


def input_training(root: str, grain: bool) -> dict:
    """(c) Stage-2 ``vqa_attention`` at full width trained by ``cli.train``
    on the raw store of (a) (a ``JoinedDataset``: each batch gathered by
    the native library, K1/K2/K3/K8), INPUT_STEPS steps, a checkpoint
    every INPUT_CKPT_EVERY. With ``grain``: ``--data.input_pipeline
    grain``, and a second run stopped at INPUT_CKPT_EVERY and resumed to
    INPUT_STEPS, whose parameters must equal the uninterrupted run's bit
    for bit; otherwise the threads pipeline, once."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.ops import kernels
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

    data_dir = os.path.join(root, "pre")
    os.makedirs(data_dir)
    cfg = Config().replace_flat(MODEL_OVERRIDES)
    rng = np.random.default_rng(71)
    q_ids = rng.integers(4, cfg.data.vocab_size, (
        INPUT_QUESTIONS, cfg.data.max_question_len)).astype(np.int32)
    q_ids[:, 8:] = 0
    np.savez(os.path.join(data_dir, "vqa_train.npz"), q_ids=q_ids,
             image_index=rng.integers(0, INPUT_IMAGES,
                                      INPUT_QUESTIONS).astype(np.int32),
             answer_id=rng.integers(4, cfg.data.num_answers,
                                    INPUT_QUESTIONS).astype(np.int32))
    flags = {"data.synthetic": False, "data.dataset_dir": data_dir,
             "data.feature_path": os.path.join(root, "store"),
             "data.input_pipeline": "grain" if grain else "threads",
             "train.batch_size": B_TRAIN, "train.log_every": 1,
             "train.checkpoint_every": INPUT_CKPT_EVERY, **MODEL_OVERRIDES}

    def run(tag: str, steps: int, first: int) -> tuple:
        reset_counts()
        t0 = time.perf_counter()
        run_dir = train_cli.main(cli_argv(dict(flags, **{
            "train.max_steps": steps})) + [
            "--train.train_dir", os.path.join(root, tag)])
        torch.cuda.synchronize()
        n = steps - first
        check_launches(read_counts(), {
            "gru_fwd": n, "gru_bwd": 3 * n, "attention_fwd": 2 * n,
            "attention_bwd": kernels.ATTENTION_BWD_LAUNCHES * n},
            f"input phase cli.train ({tag}, steps {first}-{steps})")
        res = read_steps(run_dir, n, f"input phase cli.train ({tag})",
                         "questions", warmup=min(2, n - 2), first=first)
        res["cli_s"] = time.perf_counter() - t0
        return run_dir, res

    pipeline = flags["data.input_pipeline"]
    whole_dir, out = run("whole", INPUT_STEPS, 0)
    out = {"pipeline": pipeline, "whole": out}
    if grain:
        part_dir, out["part"] = run("part", INPUT_CKPT_EVERY, 0)
        check(os.path.exists(os.path.join(
            part_dir, "ckpt", f"data_iter_{INPUT_CKPT_EVERY}.json")),
            "grain run: no iterator state beside its checkpoint")
        _, out["resumed"] = run("part", INPUT_STEPS, INPUT_CKPT_EVERY)
        whole = load_params(os.path.join(whole_dir, PARAMS_FILE))
        resumed = load_params(os.path.join(part_dir, PARAMS_FILE))
        differ = sorted(k for k in whole
                        if not torch.equal(whole[k], resumed[k]))
        check(sorted(whole) == sorted(resumed) and not differ,
              f"grain resume at step {INPUT_CKPT_EVERY}: parameters "
              f"{differ[:5]} differ from the uninterrupted run's")
        out["resume_bit_equal"] = True
        print(f"grain: {INPUT_CKPT_EVERY} + {INPUT_STEPS - INPUT_CKPT_EVERY}"
              f" resumed steps bit-equal to {INPUT_STEPS} uninterrupted")
    return out


def phase_input(report: dict, dev, seed: int) -> dict:
    """Phase 31: the native IO library, the native decoder and the grain
    pipeline, each part where this machine has what it needs; a part it
    cannot run is printed as ``{"input": {<module>: "not installed on
    this machine"}}``."""
    found = input_modules()
    out: dict = {"found": found}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_input_") as root:
        out["gathers"] = input_gathers(root, seed)
        # The decoder builds against the system's libjpeg, else against
        # the port's header copies and the libjpeg Pillow ships: where
        # either is there, a decoder that does not build fails the phase.
        if found["jpeglib.h"] or (found["pillow_libjpeg"]
                                  and found["port_jpeg_headers"]):
            out["decode"] = input_decode(root, seed)
        else:
            print(json.dumps({"input": {
                "jpeglib.h": "not installed",
                "pillow_libjpeg": "Pillow ships no libjpeg"}}))
        grain = found["grain"] and found["dm-tree"]
        for name in ("grain", "dm-tree"):
            if not found[name]:
                print(json.dumps({"input": {
                    name: "not installed on this machine"}}))
                break
        if grain and "jax" not in sys.modules:
            # grain imports JAX's tree utilities where JAX is installed;
            # this script imports nothing of JAX, so grain takes dm-tree.
            sys.modules["jax"] = None
        out["training"] = input_training(root, grain)
    return out


UNRUN_F32_STEP = {"gru_fwd_f32": K1F_LAUNCHES, "gru_bwd_f32": K3F_LAUNCHES,
                  "attention_resident_fwd_f32": 2,
                  "attention_resident_bwd_f32": 3}
UNRUN_MAIN_STEP = {
    "float32": UNRUN_F32_STEP,
    "float16": {"gru_fwd_f16": 1, "gru_bwd_f16": 3,
                "attention_resident_fwd_f16": 2,
                "attention_resident_bwd_f16": 3},
    "int8": {"gru_fwd": 1, "gru_bwd": 3, "attention_resident_fwd[int8]": 2,
             "attention_resident_bwd[int8]": 3}}
UNRUN_OVER = {"float32": {"model.dtype": "float32"},
              "float16": {"model.dtype": "float16"},
              "int8": {"train.store_quantize": "int8"}}


def unrun_limits(cfg, spec, state, batch, dev, gathered: bool = False
                 ) -> dict:
    """check_first_step's limits for ``cfg``'s dtype: float32's, float16's
    (with f16_grad_bounds on this batch) or bf16's."""
    dtype = cfg.model.dtype
    if dtype == "float32":
        return {"loss_tol": TOL_F32_LOSS, "grad_cos": F32_GRAD_COS}
    if dtype == "float16":
        return {"loss_tol": TOL_F16_LOSS, "grad_cos": F16_GRAD_COS,
                "grad_cos_by_param": f16_grad_bounds(spec, state, batch, dev,
                                                     gathered)}
    return {}


def unrun_first_step(cfg, ds, dev, what: str, build=None,
                     streamed: bool = False) -> dict:
    """The first step of ``cfg``'s model (``build(cfg)`` or its seeded
    ``build_model``) on the run's first batch, with the kernels and with
    their plain versions on the card, at the dtype's limits: the resident
    batch, or with ``streamed`` the first host batch as the uploader
    stages it."""
    import torch
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    t = cfg.train
    spec = (build(cfg) if build is not None else build_model(
        cfg, generator=torch.Generator().manual_seed(t.seed)))
    trainer = Trainer(cfg, spec, train_dir=t.train_dir)
    state = trainer.init_state()
    if streamed:
        batch = trainer._uploader()(next(ds.batches(t.batch_size,
                                                    seed=t.seed)))
    else:
        _, make_batch, _ = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(t.batch_size, seed=t.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
    gathered = streamed or cfg.model.model == "vqa_end2end"
    out = check_first_step(spec, state, batch, dev, what,
                           frozen=trainer.tx.frozen,
                           **unrun_limits(cfg, spec, state, batch, dev,
                                          gathered))
    trainer.close()
    return out


def unrun_graphed(cfg_of, ds, dev, what: str, tag: str, per_step: dict,
                  trace: Optional[dict] = None) -> dict:
    """One path at ``train.steps_per_call`` UNRUN_K against eager from one
    initialization (``cfg_of(tag, k)``, dropout 0): the first step against
    the plain path, then UNRUN_STEPS steps each way through
    :func:`spc_run` (the launches counted at warm-up and capture, each
    replay's from the profiler window over the last UNRUN_PROFILE steps),
    the parameters graphed against eager (:func:`spc_compare`)."""
    out = {"first_step": unrun_first_step(cfg_of(tag, 1), ds, dev, what)}
    runs = {k: spc_run(cfg_of(tag, k), ds, what, per_step,
                       timed=UNRUN_TIMED, trace=trace)
            for k in (1, UNRUN_K)}
    out.update({
        "launches": {k: r["launches"] for k, r in runs.items()},
        "window_records": {k: r["window_records"] for k, r in runs.items()},
        "wall_ms_per_step": {k: r["wall_ms_per_step"]
                             for k, r in runs.items()},
        "replays": {k: r["replays"] for k, r in runs.items()},
        "profile": {k: r["profile"] for k, r in runs.items()},
        "against_eager": spc_compare(runs[1], runs[UNRUN_K],
                                     f"{what} k={UNRUN_K} against eager")})
    return out


def unrun_main_graphed(dev, tmp: str, ds) -> dict:
    """(f) The main path (gather-free, the main corpus) graphed at k =
    UNRUN_K against eager in float32, float16 and on the int8 store (a
    bf16 model). The float32 GRU's launches a call are pinned against
    ``kernels.gru_f32_plan`` at the main path's shape (its persistent
    forms), the others as phases 23 and 28 count them."""
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    for name, backward in (("gru_fwd_f32", False), ("gru_bwd_f32", True)):
        route = gru._f32_route(name, B_TRAIN, H, dev)
        plan = kernels.gru_f32_plan(B_TRAIN, H,
                                    *gru._f32_occupancy(name, H, dev),
                                    backward)
        check(route == "persistent"
              and plan["launches"] == UNRUN_F32_STEP[name],
              f"{name} at B={B_TRAIN}, H={H}: route {route}, "
              f"{plan['launches']} launches a call")

    out = {}
    for dtype, over in UNRUN_OVER.items():
        def cfg_of(tag, k, over=over):
            return stage2_config(os.path.join(tmp, f"{tag}_k{k}"),
                                 UNRUN_STEPS, **{
                                     **over, "model.dropout": 0.0,
                                     "train.log_every": UNRUN_K,
                                     "train.steps_per_call": k,
                                     "train.profile_start":
                                     UNRUN_STEPS - UNRUN_PROFILE,
                                     "train.profile_steps": UNRUN_PROFILE})

        out[dtype] = unrun_graphed(cfg_of, ds, dev,
                                   f"main path graphed, {dtype}",
                                   f"main_{dtype}", UNRUN_MAIN_STEP[dtype])
    return out


def unrun_wide_graphed(dev, tmp: str, ds) -> dict:
    """(c) Stage 2 gather-free at ``model.rnn_dim`` UNRUN_WIDE in bf16,
    graphed at k = UNRUN_K against eager: the GRU's step forms
    (``csrc/gru_wide_step.cuh``, cluster launches) inside the captured
    steps. Their dU_h product is attention_dwv.cuh's, as K5's is: the
    window's records of each are told apart by the cells' type."""
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    rnn, Tq = UNRUN_WIDE, stage2_config("", 1).data.max_question_len
    fwd_form = gru._fwd_route("gru_fwd", B_TRAIN,
                              kernels.round_up(rnn, kernels.GRU_FWD_PAD), dev)
    bwd_form = gru._bwd_route("gru_bwd", B_TRAIN,
                              kernels.round_up(rnn, kernels.GRU_BWD_PAD), dev,
                              1)
    check(fwd_form == bwd_form == "step",
          f"rnn_dim {rnn}: GRU forms {fwd_form}, {bwd_form}")
    Hs = kernels.round_up(rnn, kernels.GRU_STEP_PAD)
    per_step = {
        "gru_fwd_wide": kernels.gru_step_plan(Tq, B_TRAIN, Hs,
                                              False)["launches"],
        "gru_bwd_wide": kernels.gru_step_plan(Tq, B_TRAIN, Hs,
                                              True)["launches"],
        "attention_resident_fwd": 2, "attention_resident_bwd": 3}
    trace = {"gru_fwd_wide": ("wide::gru_wide_fwd_kernel",),
             "gru_bwd_wide": ("wide::gru_wide_round_kernel",
                              "wide::gru_wide_gh_kernel",
                              "wide::gru_wide_carry_kernel",
                              "attn_dwv::dwv_kernel<attn_dwv::DenseCells",
                              "gru_dbhn_kernel"),
             "attention_resident_bwd": (
                 "attn_res_bwd_rows_kernel",
                 "attn_dwv::dwv_kernel<attn_dwv::StoreCells",
                 "attn_dwv::reduce_kernel")}

    def cfg_of(tag, k):
        return stage2_config(os.path.join(tmp, f"{tag}_k{k}"), UNRUN_STEPS,
                             **{"model.rnn_dim": rnn, "model.dropout": 0.0,
                                "train.log_every": UNRUN_K,
                                "train.steps_per_call": k,
                                "train.profile_start":
                                UNRUN_STEPS - UNRUN_PROFILE,
                                "train.profile_steps": UNRUN_PROFILE})

    out = unrun_graphed(cfg_of, ds, dev, f"stage 2 at rnn_dim {rnn}, "
                        "graphed", "wide_bf16", per_step, trace)
    out["per_step"] = per_step
    return out


def unrun_f32_launches(name: str, Tq: int, dev, what: str) -> int:
    """Launches a call of K1f, K3f, K6f or K7f (``name``) over ``Tq``
    steps at B_TRAIN x UNRUN_WIDE, from ``kernels.gru_f32_launches`` on
    the card's occupancy; the route there is the step form."""
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    route = gru._f32_route(name, B_TRAIN, UNRUN_WIDE, dev)
    check(route == "step", f"{what}: {name} takes the {route} form at "
          f"{UNRUN_WIDE} units")
    return kernels.gru_f32_launches(
        Tq, B_TRAIN, UNRUN_WIDE, *gru._f32_occupancy(name, UNRUN_WIDE, dev),
        *gru._F32_KINDS[name])


def unrun_f32_wide(dev, tmp: str, ds) -> dict:
    """(c) A float32 model at ``model.rnn_dim`` UNRUN_WIDE: stage 2
    gather-free for UNRUN_WIDE_STEPS steps (K1f and K3f in their step
    forms, K4f, K5f), its first step against the plain path, then the
    resident evaluator; stage 1 (``vlmap_description``, K6f and K7f in
    their step forms) the same steps."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    out = {}
    steps, rnn = UNRUN_WIDE_STEPS, UNRUN_WIDE
    over = {"model.rnn_dim": rnn, "model.dtype": "float32"}
    for stage in ("stage2", "stage1"):
        what = f"float32 {stage} at rnn_dim {rnn}"
        run_dir = os.path.join(tmp, f"f32_wide_{stage}")
        if stage == "stage2":
            cfg = stage2_config(run_dir, steps, **over)
            sds, Tq = ds, cfg.data.max_question_len
            names = ("gru_fwd_f32", "gru_bwd_f32")
        else:
            cfg = stage1_config(run_dir, steps).replace_flat(over)
            sds = load_dataset(cfg, "train", stage="vlmap_desc")
            Tq = sds.arrays["desc_ids"].shape[1]
            names = ("bigru_fwd_f32", "bigru_bwd_f32")
        n = {name: unrun_f32_launches(name, Tq, dev, what) for name in names}
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=run_dir)
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(sds)
        idx0 = next(sds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        res = {"first_step": check_first_step(
            spec, state, batch, dev, what, loss_tol=TOL_F32_LOSS,
            grad_cos=F32_GRAD_COS), "launches_a_call": n}
        del data, make_batch, batch
        per_step = dict(n)
        if stage == "stage2":
            per_step.update({"attention_resident_fwd_f32": 2,
                             "attention_resident_bwd_f32": 3})
        reset_counts()
        state = trainer.fit_resident(sds, state)
        torch.cuda.synchronize()
        res["launches"] = read_counts()
        check_launches(res["launches"],
                       {op: c * steps for op, c in per_step.items()},
                       f"{what} over {steps} steps")
        res.update(read_steps(run_dir, steps, what,
                              "questions" if stage == "stage2"
                              else "regions", warmup=1))
        if stage == "stage2":
            val = load_dataset(cfg.replace_flat(
                {"data.synthetic_size": VAL_QUESTIONS}), "val")
            reset_counts()
            metrics, preds = trainer.evaluate_resident(state, val)
            torch.cuda.synchronize()
            nb = -(-VAL_QUESTIONS // B_TRAIN)
            res["eval_launches"] = read_counts()
            check_launches(res["eval_launches"], {
                "gru_fwd_f32": n["gru_fwd_f32"] * nb,
                "attention_resident_fwd_f32": 2 * nb},
                f"{what}: the resident evaluator")
            check(np.isfinite(metrics["loss"])
                  and len(preds) == VAL_QUESTIONS,
                  f"{what} evaluation: {metrics}, {len(preds)} predictions")
            res["eval_metrics"] = {k: float(v) for k, v in metrics.items()}
            print(f"{what} resident evaluation: {metrics}")
        trainer.close()
        out[stage] = res
    return out


def unrun_wide_times(dev) -> dict:
    """The wide GRU kernels at B=256, T=26, UNRUN_WIDE units that phases 30
    and 32 train but no phase timed there: K6's and K7's bf16 step forms
    (``bigru_fwd_wide``, ``bigru_bwd_wide``) beside
    ``nn.GRU(bidirectional=True)`` in bf16, and the float32 step forms of
    K1f, K3f, K6f and K7f beside ``nn.GRU`` in float32 (TF32 off). Each
    kernel's outputs on the inputs it is timed on are held against its
    plain version (bf16: the states to TOL_GRU, the BPTT's outputs to
    TOL_K3_REL of each one's largest |value|; float32: TOL_F32_REL of
    each), its launches a call against its plan
    (``kernels.gru_step_plan`` for the bf16 step forms,
    ``kernels.gru_f32_launches`` for float32), and it is timed in turns
    with its library call (library, kernel, kernel, library), with its
    plain version's time and its bound (K6/K7's twice K1/K3's at the same
    lengths; float32 at the FFMA peak); the float32 BPTT step forms' (K3f,
    K7f) launches apart, device ms a call of each (F32_STEP_BWD_PARTS)."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    Hh, out = UNRUN_WIDE, {}
    for dtype, names in ((torch.bfloat16, ("bigru_fwd_wide",
                                           "bigru_bwd_wide")),
                         (torch.float32, ("gru_fwd_f32", "gru_bwd_f32",
                                          "bigru_fwd_f32", "bigru_bwd_f32"))):
        f = widths_gru_inputs(dev, T, B_TRAIN, Hh, dtype, 8)
        b = widths_gru_inputs(dev, T, B_TRAIN, Hh, dtype, 9)
        lens = f[1]
        _, _, hsf, hsb = gru.bigru_reference(f[0], b[0], lens, f[2], b[2],
                                             f[3], b[3])
        b1, b3 = gru_width_bounds(lens, Hh, f32=dtype == torch.float32)
        one_f = (f[0], lens, f[2], f[3])
        two_f = (f[0], b[0], lens, f[2], b[2], f[3], b[3])
        two_b = (f[0], b[0], hsf, hsb, lens, f[2], b[2], f[3], b[3], f[4],
                 b[4])
        # name -> (kernel, plain version, output names)
        n6, n7 = ("hTf", "hTb", "hseqf", "hseqb"), (
            "dgxf", "dgxb", "duhf", "duhb", "dbhnf", "dbhnb")
        calls = {
            "gru_fwd_f32": (lambda: gru.gru_fwd_f32(*one_f),
                            lambda: gru.gru_reference(*one_f),
                            ("hT", "hseq")),
            "gru_bwd_f32": (
                lambda: gru.gru_bwd_f32(f[0], hsf, lens, f[2], f[3], f[4]),
                lambda: gru.gru_bwd_reference(f[0], hsf, lens, f[2], f[3],
                                              f[4]),
                ("dgx", "duh", "dbhn")),
            names[-2]: (lambda: getattr(gru, names[-2])(*two_f),
                        lambda: gru.bigru_reference(*two_f), n6),
            names[-1]: (lambda: getattr(gru, names[-1])(*two_b),
                        lambda: gru.bigru_bwd_reference(*two_b), n7)}
        bounds = {"gru_fwd_f32": b1, "gru_bwd_f32": b3,
                  names[-2]: (2 * b1[0], b1[1]),
                  names[-1]: (2 * b3[0], b3[1])}
        Hs = kernels.round_up(Hh, kernels.GRU_STEP_PAD)
        planned = {
            name: (kernels.gru_f32_launches(
                T, B_TRAIN, Hh, *gru._f32_occupancy(name, Hh, dev),
                *gru._F32_KINDS[name]) if dtype == torch.float32
                else kernels.gru_step_plan(T, B_TRAIN, Hs, "bwd" in name,
                                           2)["launches"])
            for name in names}
        # The library calls: nn.GRU's packed forward and its backward, one
        # and two directions, on the same lengths.
        lib = {}
        for two in (False, True):
            net = torch.nn.GRU(D, Hh, bidirectional=two).to(dev, dtype)
            net.flatten_parameters()
            x = torch.randn(T, B_TRAIN, D, device=dev, dtype=dtype,
                            requires_grad=True)
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x, lens.cpu(), enforce_sorted=False)
            _, h_n = net(packed)
            wrt, g_n = [x, *net.parameters()], torch.randn_like(h_n)

            def lib_fwd(net=net, packed=packed):
                with torch.inference_mode():
                    net(packed)

            def lib_bwd(h_n=h_n, wrt=wrt, g_n=g_n):
                torch.autograd.grad(h_n, wrt, g_n, retain_graph=True)

            lib[two] = (lib_fwd, lib_bwd)
        for name in names:
            kernel, plain, outs = calls[name]
            two, back = name.startswith("bigru"), "bwd" in name
            reset_counts()
            got = kernel()
            torch.cuda.synchronize()
            launches = read_counts()[name]
            check(launches == planned[name],
                  f"{name} at H={Hh}: {launches} launches a call, its plan "
                  f"{planned[name]}")
            want = plain()
            got, want = dict(zip(outs, got)), dict(zip(outs, want))
            if dtype == torch.float32:
                errors = f32_errors(got, want,
                                    {k: TOL_F32_REL for k in outs})
            else:
                limits = {k: (TOL_K3_REL if back else TOL_GRU)
                          for k in outs}
                errors = {}
                for k in outs:
                    e = ((got[k].float() - want[k].float()).abs().max()
                         .item())
                    err = rel_err(got[k].float(), want[k].float()) \
                        if back else e
                    check(bool(torch.isfinite(got[k]).all())
                          and err <= limits[k],
                          f"{name} at H={Hh}: {k} error {err} over "
                          f"{limits[k]}")
                    errors[k] = {"err": err, "limit": limits[k],
                                 "max_abs_err": e}
            del got, want
            lib_call = lib[two][back]
            t = [time_cuda(lib_call, buf), time_cuda(kernel, buf),
                 time_cuda(kernel, buf), time_cuda(lib_call, buf)]
            # The float32 BPTT step form's launches apart: device ms a call
            # of each part, from one profile.
            parts = (split_device_ms(kernel, F32_STEP_BWD_PARTS, buf)
                     if dtype == torch.float32 and back else None)
            out[name] = {
                "ms": t[1], "turns_ms": t, "kernel_turns": [t[1], t[2]],
                "library_turns": [t[0], t[3]],
                "plain_ms": time_cuda(plain, buf, runs=5, warmup=1),
                "launches_a_call": launches,
                "planned_launches": planned[name], "errors": errors,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": t[0],
                "library_call": ("backward of " if back else "")
                + f"torch.nn.GRU({D}, {Hh}"
                + (", bidirectional=True" if two else "")
                + f") in {dtype} over a packed sequence"
                + (", input-projection gradients included" if back
                   else ", input projection included")
                + (" (TF32 off)" if dtype == torch.float32 else "")}
            if parts is not None:
                out[name]["parts_device_ms"] = parts
                print(f"{name} at H={Hh}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in parts.items())
                    + " device ms a call")
            r = out[name]
            print(f"{name} at H={Hh}, B={B_TRAIN}: {t[1]:.4f} / "
                  f"{t[2]:.4f} ms, library {t[0]:.4f} / {t[3]:.4f} ms, in "
                  f"turns; {launches} launches a call (its plan's); plain "
                  f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}; errors " + ", ".join(
                      f"{k} {v.get('rel_err', v.get('err')):.3e}"
                      for k, v in errors.items()))
        del f, b, hsf, hsb, calls, lib
    return out


def unrun_streamed_f32(dev, tmp: str) -> dict:
    """(b) The streamed loop (``Trainer.fit`` through ``cli.train``,
    ``train.device_data_cache`` false) in float32 on STREAM_QUESTIONS
    questions of the flat layout, UNRUN_STREAM_STEPS steps: the uploader
    stages float32 grids (the compute dtype), the first step against the
    plain path on the first batch as the uploader stages it, K1f, K3f, K2f
    and K8f at their exact counts, finite losses, step times."""
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.parallel import trainer as tr

    steps = UNRUN_STREAM_STEPS
    flags = {"data.synthetic": True, "data.synthetic_layout": "flat",
             "data.synthetic_size": STREAM_QUESTIONS,
             "train.device_data_cache": False, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             "model.dtype": "float32", **MODEL_OVERRIDES}
    what = "float32 streamed stage-2 training"
    cfg = Config().replace_flat({**flags, "train.train_dir":
                                 os.path.join(tmp, "streamed_f32_first")})
    staged = []
    real_init = tr._Uploader.__init__

    def uploader(self, device, dtype):
        staged.append(dtype)
        real_init(self, device, dtype)

    tr._Uploader.__init__ = uploader
    try:
        out = {"first_step": unrun_first_step(
            cfg, load_dataset(cfg, "train"), dev, what, streamed=True)}
        run = os.path.join(tmp, "streamed_f32")
        reset_counts()
        t0 = time.perf_counter()
        train_dir = train_cli.main(["--train.train_dir", run]
                                   + cli_argv(flags))
        torch.cuda.synchronize()
    finally:
        tr._Uploader.__init__ = real_init
    out.update(cli_s=time.perf_counter() - t0, launches=read_counts(),
               staged_dtypes=sorted({str(d) for d in staged}))
    check(staged and all(d == torch.float32 for d in staged),
          f"{what}: the uploader staged {staged}")
    check_launches(out["launches"], {
        "gru_fwd_f32": K1F_LAUNCHES * steps,
        "gru_bwd_f32": K3F_LAUNCHES * steps,
        "attention_fwd_f32": 3 * steps, "attention_bwd_f32": 3 * steps},
        f"{what} over {steps} steps")
    out.update(read_steps(train_dir, steps, what, "questions", warmup=2))
    return out


UNRUN_E2E_STEP = {
    "float32": ({"gru_fwd_f32": K1F_LAUNCHES, "gru_bwd_f32": K3F_LAUNCHES,
                 "attention_fwd_f32": 3, "attention_bwd_f32": 3},
                {"gru_fwd_f32": K1F_LAUNCHES, "attention_fwd_f32": 3}),
    "float16": ({"gru_fwd_f16": 1, "gru_bwd_f16": 3, "attention_fwd_f16": 2,
                 "attention_bwd_f16": 4},
                {"gru_fwd_f16": 1, "attention_fwd_f16": 2})}


def unrun_end2end(dev, root: str, pth: str, dtype: str) -> dict:
    """(a) ``vqa_end2end`` (ResNet-101 at E2E_SIZE, the seeded checkpoint
    of :func:`e2e_checkpoint`) in ``dtype``: the backbone at E2E_BATCH
    (float16 against float32 at TOL_F16_BACKBONE_*, every output finite),
    the first step against the plain path, ``cli.train`` UNRUN_E2E_STEPS
    steps at E2E_BATCH on UNRUN_E2E_IMAGES synthetic images held on the
    card, ``cli.eval`` on the run, the ``Predictor`` at E2E_PREDICT (logits
    against the plain path at the dtype's serving limit): launch counts of
    each."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.cli.common import (
        build_spec, load_resnet_backbone)
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.end2end import (
        VQAEnd2EndModel)
    from vqa_transfer_externaldata_torch.ops import resnet
    from vqa_transfer_externaldata_torch.serving import Predictor

    what, device = f"end2end in {dtype}", ["--device", str(dev)]
    dt = getattr(torch, dtype)
    stages = tuple(int(x) for x in E2E_STAGES.split(","))
    flags = {**MODEL_OVERRIDES, "model.model": "vqa_end2end",
             "model.dtype": dtype, "model.resnet_checkpoint": pth,
             "model.resnet_stages": E2E_STAGES,
             "model.resnet_width": E2E_WIDTH, "data.image_size": E2E_SIZE,
             "data.synthetic": True, "data.synthetic_size": UNRUN_E2E_IMAGES,
             "train.device_data_cache": True, "train.batch_size": E2E_BATCH,
             "train.max_steps": UNRUN_E2E_STEPS, "train.log_every": 1,
             "train.eval_every": 10 ** 6,
             "train.checkpoint_every": UNRUN_E2E_STEPS}
    cfg = Config().replace_flat({**flags, "train.train_dir":
                                 os.path.join(root, f"{dtype}_first")})
    backbone = load_resnet_backbone(cfg)
    out = {}

    # --- the backbone: every output finite; float16 against float32 -------
    nets = {}
    for d in {dt, torch.float32}:
        with torch.device("meta"):
            net = resnet.ResNetV1(stages, E2E_WIDTH, dtype=d,
                                  stem=VQAEnd2EndModel.stem)
        net.load_state_dict(backbone, assign=True)
        nets[d] = net.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(47)
    images = torch.randint(0, 256, (E2E_BATCH, E2E_SIZE, E2E_SIZE, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    with torch.inference_mode():
        x = resnet.preprocess_images(images, E2E_SIZE)
        got = nets[dt](x)
        ref = nets[torch.float32](x) if dt != torch.float32 else got
    check(got["grid"].dtype == dt and all(
        bool(torch.isfinite(got[k]).all()) for k in ("grid", "pool5")),
        f"{what}: backbone grid {got['grid'].dtype}, finite "
        f"{[bool(torch.isfinite(got[k]).all()) for k in ('grid', 'pool5')]}")
    out["backbone_max_abs"] = got["grid"].float().abs().max().item()
    if dt == torch.float16:
        errs = {k: e2e_grid_errors(got[k], ref[k]) for k in ("grid", "pool5")}
        out["backbone_vs_f32"] = errs
        print(f"{what}: backbone at B={E2E_BATCH}, {E2E_SIZE}px against "
              f"float32 on the card {errs} (limits: mean "
              f"{TOL_F16_BACKBONE_MEAN}, max {TOL_F16_BACKBONE_MAX}, "
              f"cosine {F16_BACKBONE_COS}); largest |grid| "
              f"{out['backbone_max_abs']:.1f}")
        for k, e in errs.items():
            check(e["mean_rel"] <= TOL_F16_BACKBONE_MEAN
                  and e["max_rel"] <= TOL_F16_BACKBONE_MAX
                  and e["cos"] >= F16_BACKBONE_COS,
                  f"{what}: backbone {k} against float32: {e}")
    del nets, got, ref, x, images

    # --- the first step against the plain path ----------------------------
    def e2e_spec(c):
        sp, _, _ = build_spec(c, generator=torch.Generator().manual_seed(
            c.train.seed))
        sp.module.resnet.load_state_dict(backbone)
        return sp

    ds = load_dataset(cfg, "train")
    out["first_step"] = unrun_first_step(cfg, ds, dev, what, build=e2e_spec)
    del ds

    # --- cli.train, cli.eval, the Predictor -------------------------------
    train_step, eval_step = UNRUN_E2E_STEP[dtype]
    reset_counts()
    run_dir = train_cli.main(device + cli_argv(flags) + [
        "--train.train_dir", os.path.join(root, f"{dtype}_run")])
    torch.cuda.synchronize()
    out["train_launches"] = read_counts()
    check_launches(out["train_launches"],
                   {op: c * UNRUN_E2E_STEPS for op, c in train_step.items()},
                   f"{what}: cli.train over {UNRUN_E2E_STEPS} steps")
    out["train"] = read_steps(run_dir, UNRUN_E2E_STEPS, f"{what} cli.train",
                              "images", warmup=1, batch=E2E_BATCH)
    reset_counts()
    metrics = eval_cli.main(device + ["--train.train_dir", run_dir])
    torch.cuda.synchronize()
    batches = -(-UNRUN_E2E_IMAGES // E2E_BATCH)
    out["eval_launches"] = read_counts()
    check_launches(out["eval_launches"],
                   {op: c * batches for op, c in eval_step.items()},
                   f"{what}: cli.eval over {batches} batches")
    check(all(np.isfinite(v) for v in metrics.values()),
          f"{what}: cli.eval metrics {metrics}")
    out["eval_metrics"] = metrics

    pred = Predictor(run_dir, batch_size=E2E_PREDICT, device=str(dev))
    rng = np.random.default_rng(53)
    pix = rng.integers(0, 256, (E2E_PREDICT, E2E_SIZE, E2E_SIZE, 3)
                       ).astype(np.uint8)
    words = len(pred.word_vocab) - 4
    questions = [" ".join(f"w{w}" for w in rng.integers(0, words, n))
                 for n in rng.integers(1, T + 1, E2E_PREDICT)]
    reset_counts()
    answers = pred.answer(pix, questions)
    out["predict_launches"] = read_counts()
    check_launches(out["predict_launches"], eval_step,
                   f"{what}: Predictor at batch {E2E_PREDICT}")
    v = torch.from_numpy(pix).to(dev)
    q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
    with torch.inference_mode():
        lk = pred.model(v, q)["logits"]
        with plain_kernels():
            lr = pred.model(v, q)["logits"]
    tol = TOL_F32_LOGITS if dtype == "float32" else TOL_F16_LOGITS
    err = (lk - lr).abs().max().item()
    top2 = lr.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    plain = [pred.answer_vocab.tokens[int(i)] for i in lr.argmax(-1)]
    check(bool(torch.isfinite(lk).all()) and err <= tol and all(
        a == p for a, p, d in zip(answers, plain, decided.tolist()) if d),
        f"{what}: serving logits err {err} (tol {tol}), answers {answers} "
        f"against plain {plain}")
    out["predict_logits_err"] = err
    print(f"{what}: Predictor at batch {E2E_PREDICT}: logits against the "
          f"plain path {err:.3e} (tol {tol}); {answers}")
    del pred
    return out


def unrun_multi_device(dev, tmp: str) -> dict:
    """(d) Phase 24's world-1 runs in float32 and float16 (this process
    in a one-rank NCCL group against no group, eagerly and at k = MD_K:
    bit-equal), and two gloo ranks sharing the card on the replicated
    store in float32 against one process, at MD_TOL_LOSS_F32 and
    MD_GRAD_COS_F32."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset

    out = {}
    for dtype in ("float32", "float16"):
        over = UNRUN_OVER[dtype]
        root = os.path.join(tmp, f"md_{dtype}")
        os.makedirs(root)
        out[f"world1_{dtype}"] = md_world1(root, over,
                                           UNRUN_MAIN_STEP[dtype])
    over = UNRUN_OVER["float32"]
    root = os.path.join(tmp, "md_f32_world2")
    os.makedirs(root)
    device = str(torch.device(dev.type, 0) if dev.type == "cuda" else dev)
    ranks = md_spawn("replicated", device, root, {
        "MODEL_OVERRIDES": {**MODEL_OVERRIDES, **over}})
    ref_cfg = md_config("ref_data", root, **over)
    ds = md_dataset(ref_cfg, "replicated")
    val = load_dataset(ref_cfg.replace_flat(
        {"data.synthetic_size": VAL_QUESTIONS}), "val")
    nb = -(-VAL_QUESTIONS // B_TRAIN)
    for r, res in enumerate(ranks):
        check_launches(res["launches"], {op: c * MD_RANK_STEPS for op, c in
                                         UNRUN_F32_STEP.items()},
                       f"float32 replicated, rank {r} of {MD_WORLD}")
        check_launches(res["eval_launches"], {
            "gru_fwd_f32": K1F_LAUNCHES * nb,
            "attention_resident_fwd_f32": 2 * nb},
            f"float32 replicated evaluation, rank {r}")
        check(res["preds"] == ranks[0]["preds"],
              "float32 replicated: the ranks' predictions differ")
    one = md_fit(md_config("one", root, **over), ds, val, device=dev)
    out["world2_float32_replicated"] = {
        "launches": [res["launches"] for res in ranks],
        "ms_per_step": [res["ms_per_step"] for res in ranks],
        "losses": ranks[0]["losses"],
        **md_agree(ranks[0], one, f"float32 replicated on {MD_WORLD} ranks "
                   "against one process",
                   (MD_TOL_LOSS_F32, MD_GRAD_COS_F32))}
    check(np.isfinite(list(ranks[0]["losses"].values())).all(),
          f"float32 replicated: losses {ranks[0]['losses']}")
    return out


def phase_unrun_paths(report: dict, dev) -> dict:
    """Phase 32: the ported paths no earlier phase ran, each through its
    entry points at config.py's full width, cut in depth only, each
    checked three ways (its first step against the plain path at its
    dtype's limits; graphed against eager bit-equal or within
    SPC_PARAM_REL; its exact launch counts): (f) the main path graphed in
    float32, float16 and on the int8 store; (c) stage 2 at rnn_dim
    UNRUN_WIDE graphed in bf16, and a float32 model at that width (stage
    2 with its evaluator, stage 1), with the wide kernels' times; (b) the
    streamed loop in float32; (a) ``vqa_end2end`` in float32 and float16;
    (d) multi-device in float32 and float16. Within UNRUN_BUDGET_S."""
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset

    t0 = time.perf_counter()
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_unrun_") as tmp:
        ds = load_dataset(stage2_config(os.path.join(tmp, "data"), 1),
                          "train")
        for key, fn in (
                ("graphed", lambda: unrun_main_graphed(dev, tmp, ds)),
                ("wide_graphed", lambda: unrun_wide_graphed(dev, tmp, ds)),
                ("f32_wide", lambda: unrun_f32_wide(dev, tmp, ds)),
                ("wide_times", lambda: unrun_wide_times(dev)),
                ("streamed_f32", lambda: unrun_streamed_f32(dev, tmp)),
                ("end2end", lambda: {
                    dtype: unrun_end2end(dev, tmp, pth, dtype)
                    for pth in [e2e_checkpoint(tmp)]
                    for dtype in ("float32", "float16")}),
                ("multi_device", lambda: unrun_multi_device(dev, tmp))):
            t1 = time.perf_counter()
            out[key] = fn()
            seconds[key] = time.perf_counter() - t1
            print(f"phase 32, {key}: {seconds[key]:.1f} s")
    paths = {}
    for dtype, r in out["graphed"].items():
        for k, counts in r["launches"].items():
            paths[f"unrun_graphed_{dtype}_k{k}"] = counts
    for k, counts in out["wide_graphed"]["launches"].items():
        paths[f"unrun_wide_bf16_k{k}"] = counts
    for stage, r in out["f32_wide"].items():
        paths[f"unrun_f32_wide_{stage}"] = r["launches"]
    paths["unrun_f32_wide_stage2_eval"] = out["f32_wide"]["stage2"][
        "eval_launches"]
    paths["unrun_streamed_f32"] = out["streamed_f32"]["launches"]
    for dtype, r in out["end2end"].items():
        for part in ("train", "eval", "predict"):
            paths[f"unrun_end2end_{dtype}_{part}"] = r[f"{part}_launches"]
    md = out["multi_device"]
    for dtype in ("float32", "float16"):
        for k in (1, MD_K):
            paths[f"unrun_md_world1_{dtype}_k{k}"] = md[
                f"world1_{dtype}"][f"k{k}"]["launches"]
    for r, counts in enumerate(md["world2_float32_replicated"]["launches"]):
        paths[f"unrun_md_float32_replicated_rank{r}"] = counts
    out["launches_by_path"] = paths
    out["seconds"] = seconds
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 32 took {out['phase_s']:.1f} s (budget {UNRUN_BUDGET_S} "
          f"s): {json.dumps(seconds)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 31's store and fixtures")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: FAIL: {torch.cuda.device_count()} CUDA devices "
              "visible; it drives one card (set CUDA_VISIBLE_DEVICES to "
              "one)", file=sys.stderr)
        return 2
    try:
        import vqa_transfer_externaldata_torch as port
    except ImportError:
        port = None
    if port is None or not os.path.abspath(port.__file__).startswith(HERE):
        print("chip_smoke: FAIL: the vqa_transfer_externaldata_torch "
              "package must sit beside chip_smoke.py (run it from the "
              "repository root)", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"chip_smoke: FAIL: nvidia-smi: {smi.stderr}", file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        phase_build(report)
        k1 = phase_gru(report, dev, gen)
        k2 = phase_attention(report, dev, gen)
        k3 = phase_gru_bwd(report, dev, gen)
        k45 = phase_resident(report, dev, gen)
        k45g = phase_resident_multi(report, dev, gen, k45)
        k45q = phase_resident_int8(report, dev, gen, k45)
        k67 = phase_bigru(report, dev, gen)
        k8 = phase_attention_bwd(report, dev, gen)
        serving = phase_serving(report, dev)
        report["training"] = training = phase_training(report, dev)
        report["gathered"] = gathered = phase_gathered(report, dev)
        report["streamed"] = streamed = phase_streamed(report, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_stage1_") as root:
            report["stage1"] = stage1 = phase_stage1(report, dev, root)
            report["transfer"] = transfer = phase_transfer(
                report, dev, stage1["params_path"])
            report["baseline"] = phase_baseline(report, dev,
                                                stage1["params_path"])
        report["glimpses2"] = glimpses2 = phase_glimpses2(report, dev)
        report["training_int8"] = training_int8 = phase_training_int8(
            report, dev)
        report["probes"] = probes = phase_probes(report, dev)
        times = phase_times(report, k1, k2, k3, k45, k45g, k45q, k67, k8,
                            dev)
        report["real_data"] = real_data = phase_real_data(report, dev)
        report["oov"] = oov = phase_oov(report, dev)
        report["end2end"] = end2end = phase_end2end(report, dev)
        report["steps_per_call"] = spc = phase_steps_per_call(report, dev)
        report["multi_device"] = md = phase_multi_device(report, dev)
        f32 = phase_float32(report, dev, gen)
        report["float32"] = {  # the kernels' inputs stay out of the report
            **{k: v for k, v in f32.items() if k not in ("k13", "k45")},
            "checks": {"k1f_k3f": f32["k13"]["checks"],
                       "k4f_k5f": f32["k45"]["checks"]}}
        report["fidelity"] = fid = phase_fidelity(report, dev)
        f32g = phase_float32_gathered(report, dev, gen)
        report["float32_gathered"] = {  # the kernels' inputs stay out
            **{k: v for k, v in f32g.items() if k not in ("k28", "k67")},
            "checks": {"k2f_k8f": f32g["k28"]["checks"],
                       "k6f": f32g["k67"]["k6f"], "k7f": f32g["k67"]["k7f"]}}
        f16 = phase_float16(report, dev, gen)
        report["float16"] = {  # the kernels' inputs stay out of the report
            **{k: v for k, v in f16.items() if k not in ("k13", "k45")},
            "checks": {"k1h_k3h": f16["k13"]["checks"],
                       "k4h_k5h": f16["k45"]["checks"]}}
        t0 = time.perf_counter()
        f16g = phase_float16_gathered(report, dev, gen)
        report["float16_gathered"] = {
            **{k: v for k, v in f16g.items() if k not in ("k28", "k67")},
            "checks": {"k2h_k8h": f16g["k28"]["checks"],
                       "k6h_k7h": f16g["k67"]["checks"]},
            "phase_s": time.perf_counter() - t0}
        print(f"phase 29 took {report['float16_gathered']['phase_s']:.1f} s")
        report["widths"] = widths = phase_widths(report, dev)
        t0 = time.perf_counter()
        report["input"] = phase_input(report, dev, args.seed)
        report["input"]["phase_s"] = time.perf_counter() - t0
        print(f"phase 31 took {report['input']['phase_s']:.1f} s")
        report["unrun"] = unrun = phase_unrun_paths(report, dev)
        torch.cuda.synchronize()
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    # max_abs_err: the largest error of the kernel's outputs against its
    # plain version; each kernel also lists its checks beside their limits.
    # launches: the count of the path that runs the kernel (stage-2
    # training for K1 and K3; glimpses2 training, at G=2, for K4 and K5;
    # serving for K2; stage-1 training for K6 and K7; gathered stage-2
    # training for K8; int8-store training for K4 and K5 on int8 rows; the
    # probes' entries for P1 and P2), and every path's count under
    # launches_by_path. K1's times are at the training batch, and at the
    # serving batch under at_serving_batch. K4's and K5's times and bounds
    # are at G=2, and at G=1 under at_g1; on int8 rows at G=1; K4's score
    # launch alone at G=1 under score_ms_g1 and score_tflops_g1; the dW_v
    # launch alone of K5 at G=1 (bf16 and int8 rows) and of K8 under
    # dwv_stage_g1 / dwv_stage, with cuBLAS on the same product (library_ms
    # of the whole kernel stays null: no one PyTorch call computes it); K8's
    # dz launch alone under dz_stage, with cuBLAS on its product; K2's score
    # launch alone at the serving batch under score_ms, K2 at the
    # Predictor's default batch under at_predict_batch, and at the training
    # batch (its score launch alone with its bound and cuBLAS on its
    # product, its wsum launch alone with its bound) under
    # at_training_batch; the
    # rows launch alone of K5 (rows_stage_g1/g2/g8, int8 rows_stage_g1, the
    # launch's shape under rows_launch) and of P2 (rows_stage), each beside
    # its bytes bound.
    # The graphed runs of phases 22 and 23 are under steps_per_call_* in
    # launches_by_path: the launches each ran (the graph's warm-up as
    # counted, each replay as its records in the run's profiler trace).
    # Phase 24's are under multi_device_*: the one-rank NCCL runs (k = 1
    # and k = 4, counted the same way) and each rank of the two-rank runs
    # sharing the card.
    # P1's time is at Q=1, with every Q under by_q; its library call is
    # cuBLAS on the gathered rows, the gather timed apart. K6's time is
    # taken in turns with two K1 calls on its inputs (two_k1_ms), K7's with
    # two K3 calls (two_k3_ms); each lists its persistent launch and what
    # ptxas reports for its persistent kernel in both builds that run it,
    # and K6 its two tilings' times. K1 lists its persistent launch at both
    # batches, its time a step (T=26 against T=1) and the warnings of its
    # nvcc log.
    src = "vqa_transfer_externaldata_torch/csrc/"
    ref = "vqa_transfer_externaldata_tpu/ops/"
    k1_serving = times["gru_fwd"].pop("at_serving_batch")
    k2t = times["attention_fwd"].pop("at_training_batch")
    meta = {
        "gru_fwd": (ref + "gru.py:227", max(k1["err"], k3["k1_err"]), {
            "tol": TOL_GRU, "err_by_batch": {str(B): k1["err"],
                                             str(B_TRAIN): k3["k1_err"]},
            "persistent_launch": k3["k1_launch"],
            "nvcc_warnings": [
                line for line in report["ptxas"].get("gru_fwd",
                                                     "").splitlines()
                if "warning" in line.lower()],
            "step_us": times["gru_fwd"]["step_us"],
            "one_step_ms": times["gru_fwd"]["one_step_ms"],
            "tilings_ms": times["gru_fwd"]["tilings_ms"],
            "at_serving_batch": {
                "batch": B, "ms": k1_serving["kernel"],
                "step_us": k1_serving["step_us"],
                "one_step_ms": k1_serving["one_step_ms"],
                "plain_ms": k1_serving["plain"],
                "bound_ms": k1_serving["bound"][0],
                "bound_by": k1_serving["bound"][1],
                "library_ms": k1_serving["library"]}}),
        "attention_fwd": (
            ref + "attention.py:125",
            max(max(c["v_att_err"], c["alpha_err"])
                for c in k2["checks"] + k8["k2_checks"]),
            {"checks": k2["checks"] + k8["k2_checks"],
             "score_ms": times["attention_fwd"]["score_ms"],
             "at_predict_batch": times["attention_fwd"]["at_predict_batch"],
             "at_training_batch": {
                 "batch": B_TRAIN, "ms": k2t["kernel"],
                 "plain_ms": k2t["plain"], "score_ms": k2t["score_ms"],
                 "score_tflops": k2t["score_tflops"],
                 "score_bound_ms": k2t["score_bound"][0],
                 "score_bound_by": k2t["score_bound"][1],
                 "score_library_ms": k2t["score_library_ms"],
                 "score_library_call": times["attention_bwd"]["dz_stage"][
                     "library_call"],
                 "score_launch": k2t["score_launch"],
                 "wsum_ms": k2t["wsum_ms"],
                 "wsum_bound_ms": k2t["wsum_bound"][0],
                 "wsum_bound_by": k2t["wsum_bound"][1],
                 "bound_ms": k2t["bound"][0], "bound_by": k2t["bound"][1]}}),
        "gru_bwd": (ref + "gru.py:259", k3["err"], {
            "checks": k3["checks"], "persistent_launch": k3["launch"]}),
        "attention_resident_fwd": (
            ref + "attention_resident.py:150", max(k45["err4"], k45g["err4"]),
            {"glimpses": "1-8", "checks": k45["checks4"] + k45g["checks4"],
             "score_ms_g1": times["attention_resident_fwd"]["score"],
             "score_tflops_g1":
             times["attention_resident_fwd"]["score_tflops"],
             "score_stage_g1": times["attention_resident_fwd"]["score_stage"],
             "score_launch": report["score_launch"]}),
        "attention_resident_bwd": (
            ref + "attention_resident.py:208", max(k45["err5"], k45g["err5"]),
            {"glimpses": "1-8", "checks": k45["checks5"] + k45g["checks5"],
             "dwv_stage_g1": times["attention_resident_bwd"]["dwv_stage"],
             "dwv_launch": report["dwv_launch"],
             "rows_stage_g1": report["rows_stage"]["k5_g1"],
             "rows_stage_g2": report["rows_stage"]["k5_g2"],
             "rows_stage_g8": report["rows_stage"]["k5_g8"],
             "rows_launch": report["rows_launch"]}),
        "bigru_fwd": (ref + "gru.py:474", k67["err6"], {
            "tol": TOL_GRU, "diff_vs_two_k1_calls": k67["diff6"],
            "persistent_launch": k67["launch6"],
            "ptxas_gru_seq_kernel": k67["ptxas_seq"],
            "two_k1_ms": times["bigru_fwd"]["two_k1"],
            "tilings_ms": times["bigru_fwd"]["tilings_ms"]}),
        "bigru_bwd": (ref + "gru.py:561", k67["err7"], {
            "checks": k67["checks7"],
            "diff_vs_two_k3_calls": k67["diff7"],
            "persistent_launch": k67["launch7"],
            "ptxas_gru_bptt_kernel": k67["ptxas_bptt"],
            "two_k3_ms": times["bigru_bwd"]["two_k3"]}),
        "attention_bwd": (ref + "attention.py:267", k8["err"], {
            "checks": k8["checks"], "op_grad_cos_vs_explicit":
            k8["op_grad_cos"],
            "op_backward_with_kernel_ms":
            times["attention_bwd"]["op_backward_with_kernel"],
            "explicit_backward_ms":
            times["attention_bwd"]["explicit_backward"],
            "dwv_stage": times["attention_bwd"]["dwv_stage"],
            "dz_stage": times["attention_bwd"]["dz_stage"]}),
        "attention_resident_fwd[int8]": (
            ref + "attention_resident.py:174", k45q["err4"], {
                "glimpses": "1-8", "checks": k45q["checks4"],
                "score_ms_g1": times["attention_resident_fwd[int8]"]["score"],
                "score_tflops_g1":
                times["attention_resident_fwd[int8]"]["score_tflops"],
                "score_stage_g1":
                times["attention_resident_fwd[int8]"]["score_stage"],
                "vatt_quant_rel_err_vs_bf16_store":
                k45q["vatt_quant_rel_err"]}),
        "attention_resident_bwd[int8]": (
            ref + "attention_resident.py:235", k45q["err5"], {
                "glimpses": "1-8", "checks": k45q["checks5"],
                "dwv_stage_g1":
                times["attention_resident_bwd[int8]"]["dwv_stage"],
                "rows_stage_g1": report["rows_stage"]["k5_int8_g1"]}),
    }
    paths = {"serving": serving, "training": training["launches"],
             "gathered": gathered["launches"],
             "streamed": streamed["launches"],
             "stage1": stage1["gathered"]["launches"],
             "stage1_dense": stage1["dense"]["launches"],
             "transfer": transfer["launches"],
             "glimpses2": glimpses2["launches"],
             "training_int8": training_int8["launches"],
             "probes": probes["launches"],
             "real_data_stage1": real_data["stage1_launches"],
             "real_data_stage2": real_data["stage2_launches"],
             "real_data_eval": real_data["eval_launches"],
             "real_data_predict": real_data["predict_launches"],
             "oov": oov["launches"],
             "end2end_train": end2end["train_launches"],
             "end2end_eval": end2end["eval_launches"],
             "end2end_predict": end2end["predict_launches"]}
    if end2end["pil"]:
        paths.update(end2end_jpeg_train=end2end["jpeg_train_launches"],
                     end2end_jpeg_predict=end2end["jpeg_predict_launches"])
    # The graphed runs of phases 22 and 23: the launches each ran, the
    # graph's warm-up as counted and each replay as the records a replay
    # has in the run's profiler window.
    for k in SPC_KS:
        paths[f"steps_per_call_main_k{k}"] = spc["main"][k]["launches"]
    for tag in ("stage1", "gathered", "streamed"):
        paths[f"steps_per_call_{tag}_k{SPC_KS[0]}"] = spc[tag]["launches"][
            SPC_KS[0]]
    paths[f"steps_per_call_end2end_k{E2E_SPC_K}"] = end2end[
        "steps_per_call"]["launches"][E2E_SPC_K]
    # Phase 24: the world-1 NCCL runs (graphed launches as phase 23's) and
    # each rank of the two-rank runs sharing the card.
    paths.update(md["launches"])
    # Phases 25 and 26: the float32 main path and the fidelity path.
    paths.update(float32_training=f32["launches"],
                 float32_eval=f32["eval_launches"],
                 fidelity_train=fid["train_launches"],
                 fidelity_eval=fid["eval_launches"],
                 fidelity_predict=fid["predict_launches"])
    # Phase 27: float32 on the gathered store, its evaluator, the float32
    # Predictor at each batch and float32 stage 1.
    paths.update(float32_gathered_training=f32g["launches"],
                 float32_gathered_eval=f32g["eval_launches"],
                 float32_stage1=f32g["stage1"]["launches"],
                 **{f"float32_predict_b{b}": p["launches"]
                    for b, p in f32g["predictor"].items()})
    # Phase 30: the wide models' runs, their evaluators, and TINY in bf16
    # through the entry points.
    paths.update({f"widths_{k}": v["launches"] for k, v in widths.items()
                  if k.startswith(("stage1_", "stage2_"))})
    paths.update({f"widths_{k}_eval": v["eval_launches"]
                  for k, v in widths.items()
                  if k.startswith("stage2_") and "eval_launches" in v})
    paths.update({f"widths_tiny_{k[:-len('_launches')]}": v
                  for k, v in widths["tiny"].items()
                  if k.endswith("_launches")})
    # Phase 32: each path that had not run on the card, by dtype and k.
    paths.update(unrun["launches_by_path"])
    main_path = {"attention_fwd": "serving", "bigru_fwd": "stage1",
                 "bigru_bwd": "stage1", "attention_bwd": "gathered",
                 "attention_resident_fwd": "glimpses2",
                 "attention_resident_bwd": "glimpses2",
                 "attention_resident_fwd[int8]": "training_int8",
                 "attention_resident_bwd[int8]": "training_int8"}
    for name in ("attention_resident_fwd", "attention_resident_bwd"):
        g1, g2 = times[name], times[name].pop("at_g2")
        meta[name][2]["at_g1"] = {
            "launches": paths["training"][name], "ms": g1["kernel"],
            "plain_ms": g1["plain"], "bound_ms": g1["bound"][0],
            "bound_by": g1["bound"][1], "library_ms": g1["library"]}
        times[name] = g2
    # K2 and K8 on the backbone's grid at phase 22's batches.
    for name, key in (("attention_fwd", "k2"), ("attention_bwd", "k8")):
        meta[name][2]["at_end2end_batches"] = {
            str(bq): {**hk[key], "checks": hk[f"{key}_checks"]}
            for bq, hk in end2end["head_kernels"].items()}
    kernels = []
    for name, (replaces, err, errs) in meta.items():
        t = times[name]
        path = main_path.get(name, "training")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{src}{name.split('[')[0]}.cu",
            "replaces": replaces, "launches": paths[path][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err, **errs, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library"],
        })
    # The probes: their runs' own checks, times and bounds.
    p1, p2 = probes["probe_mxu_rows"], probes["probe_bwd_ceiling"]
    for name, r, replaces, ms, extra in (
            ("probe_mxu_rows", p1, "tools/probe_mxu_rows.py:34",
             p1["by_q"][1]["ms"], {"by_q": p1["by_q"],
                                   "rel_err_vs_plain": p1["rel_err_vs_plain"],
                                   "library_gather_ms":
                                   p1["cublas_gather_ms"]}),
            ("probe_bwd_ceiling", p2, "tools/probe_bwd_ceiling.py:36",
             p2["ms"], {"tflops": p2["tflops"],
                        "dwv_rel_err": p2["dwv_rel_err"],
                        "dal_rel_err": p2["dal_rel_err"],
                        "rows_stage": report["rows_stage"]["p2"]})):
        b_ms, b_by = bound(r["bound"]["bytes"], r["bound"]["flops"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces, "launches": paths["probes"][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], **extra, "ms": ms,
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["cublas_ms"], "library_call": r["cublas_call"]})
    # The float32 kernels: launches of phase 25's float32 training, their
    # checks at the main path's shapes (K4f/K5f over every row type and
    # glimpse count), their times at G=1 on float16 rows with each stage's
    # library GEMM.
    k13, k45f, f32t = f32["k13"], f32["k45"], f32["times"]
    for name, replaces, err, extra in (
            ("gru_fwd_f32", ref + "gru.py:227", k13["err1"], {
                "tol_rel": TOL_F32_REL, "form": k13["routes"]["gru_fwd_f32"],
                "checks": [{"reverse": c["reverse"], **c["k1f"]}
                           for c in k13["checks"]],
                "step_form_bit_equal": True,
                **{k: f32t["gru_fwd_f32"][k] for k in (
                    "turns_ms", "step_form", "kernel_turns",
                    "library_turns")}}),
            ("gru_bwd_f32", ref + "gru.py:259", k13["err3"], {
                "tol_rel": TOL_F32_REL, "form": k13["routes"]["gru_bwd_f32"],
                "checks": [{"reverse": c["reverse"], **c["k3f"]}
                           for c in k13["checks"]],
                "step_form_bit_equal": True,
                **{k: f32t["gru_bwd_f32"][k] for k in (
                    "turns_ms", "step_form", "kernel_turns",
                    "library_turns", "launch_ms")}}),
            ("attention_resident_fwd_f32", ref + "attention_resident.py:150",
             k45f["err4"], {
                 "tol_rel": TOL_F32_REL, "glimpses": "1-8",
                 "rows": list(F32_ROWS),
                 "checks": [{k: c[k] for k in ("rows", "glimpses",
                                               "normalize", "k4f")}
                            for c in k45f["checks"]],
                 "score_ms": f32t["attention_resident_fwd_f32"]["score_ms"],
                 "score_tflops":
                 f32t["attention_resident_fwd_f32"]["score_tflops"],
                 "score_launch":
                 f32t["attention_resident_fwd_f32"]["score_launch"],
                 "library_gather_ms":
                 f32t["attention_resident_fwd_f32"]["library_gather_ms"]}),
            ("attention_resident_bwd_f32", ref + "attention_resident.py:208",
             k45f["err5"], {
                 "tol_rel": TOL_F32_REL, "glimpses": "1-8",
                 "rows": list(F32_ROWS),
                 "checks": [{k: c[k] for k in ("rows", "glimpses",
                                               "normalize", "k5f")}
                            for c in k45f["checks"]],
                 "dwv_ms": f32t["attention_resident_bwd_f32"]["dwv_ms"],
                 "dwv_tflops":
                 f32t["attention_resident_bwd_f32"]["dwv_tflops"],
                 "dwv_launch":
                 f32t["attention_resident_bwd_f32"]["dwv_launch"]})):
        t = f32t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces,
            "launches": paths["float32_training"][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err, **extra, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library"],
            "library_call": t["library_call"]})
    # The float32 kernels of phase 27: K2f and K8f with the launches of the
    # float32 gathered training, K6f and K7f of float32 stage 1; their
    # checks at every shape, their times at the main path's shapes (K2f at
    # the training batch, and at the serving batch under at_serving_batch).
    k28, k67, f32gt = f32g["k28"], f32g["k67"], f32g["times"]
    k2s = f32gt["attention_fwd_f32_serving"]
    for name, replaces, err, path, extra in (
            ("attention_fwd_f32", ref + "attention.py:125", k28["err2"],
             "float32_gathered_training", {
                 "tol_rel": TOL_F32_REL, "tol_r_rel": TOL_R_REL,
                 "checks": [{k: c[k] for k in ("shape", "normalize", "k2f")}
                            for c in k28["checks"]],
                 "score_ms": f32gt["attention_fwd_f32"]["score_ms"],
                 "score_tflops": f32gt["attention_fwd_f32"]["score_tflops"],
                 "score_launch": f32gt["attention_fwd_f32"]["score_launch"],
                 "at_serving_batch": {
                     "batch": B, "ms": k2s["kernel"],
                     "plain_ms": k2s["plain"], "bound_ms": k2s["bound"][0],
                     "bound_by": k2s["bound"][1],
                     "library_ms": k2s["library"]}}),
            ("attention_bwd_f32", ref + "attention.py:267", k28["err8"],
             "float32_gathered_training", {
                 "tol_rel": TOL_F32_REL, "relu_flip_allowance": True,
                 "checks": [{k: c[k] for k in ("shape", "normalize", "k8f",
                                               "units_near_zero")}
                            for c in k28["checks"]],
                 **{k: f32gt["attention_bwd_f32"][k] for k in (
                     "dz_ms", "dz_tflops", "dwv_ms", "dwv_tflops",
                     "library_dz_ms", "dz_launch", "dwv_launch")}}),
            ("bigru_fwd_f32", ref + "gru.py:474", k67["err6"],
             "float32_stage1", {
                 "tol_rel": TOL_F32_REL, "checks": k67["k6f"],
                 "diff_vs_two_k1f_calls": k67["diff_vs_two_k1f"],
                 "diff_vs_other_forms": k67["diff_vs_other_forms"],
                 "launches_a_call": {f: n[0] for f, n in
                                     k67["launches_a_call"].items()},
                 "plan": k67["plans"]["bigru_fwd_f32"],
                 "two_k1f_ms": f32gt["bigru_fwd_f32"]["two_k1f"],
                 "step_form_ms": f32gt["bigru_fwd_f32"]["step_form"],
                 "rows64_ms": f32gt["bigru_fwd_f32"]["rows64"],
                 "device_ms": f32gt["bigru_fwd_f32"]["device_ms"],
                 "turns_ms": f32gt["bigru_fwd_f32"]["turns_ms"]}),
            ("bigru_bwd_f32", ref + "gru.py:561", k67["err7"],
             "float32_stage1", {
                 "tol_rel": TOL_F32_REL, "checks": k67["k7f"],
                 "diff_vs_two_k3f_calls": k67["diff_vs_two_k3f"],
                 "diff_vs_other_forms": k67["diff_vs_other_forms"],
                 "launches_a_call": {f: n[1] for f, n in
                                     k67["launches_a_call"].items()},
                 "plan": k67["plans"]["bigru_bwd_f32"],
                 "two_k3f_ms": f32gt["bigru_bwd_f32"]["two_k3f"],
                 "step_form_ms": f32gt["bigru_bwd_f32"]["step_form"],
                 "launch_ms": f32gt["bigru_bwd_f32"]["launch_ms"],
                 "turns_ms": f32gt["bigru_bwd_f32"]["turns_ms"]})):
        t = f32gt[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces, "launches": paths[path][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err, **extra, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library"],
            "library_call": t["library_call"]})
    # The float16 kernels of phase 28: the launches of its float16
    # training (K4h/K5h on int8 rows: of its int8-store training), their
    # checks at both batches, their times at the training batch beside
    # the bf16 kernel's (bf16_ms, turns_ms), the bf16 row's bound.
    paths.update(float16_training=f16["training"]["launches"],
                 float16_eval=f16["training"]["eval_launches"],
                 float16_int8_training=f16["training_int8"]["launches"],
                 float16_int8_eval=f16["training_int8"]["eval_launches"])
    # Phase 29: float16 on the gathered store, its evaluator, the float16
    # Predictor at each batch, the streamed loop, stage 1 and the transfer.
    f16gg, f16s1 = f16g["gathered"], f16g["stage1"]
    paths.update(float16_gathered_training=f16gg["launches"],
                 float16_gathered_eval=f16gg["eval_launches"],
                 float16_streamed=f16g["streamed"]["launches"],
                 float16_stage1=f16s1["launches"],
                 float16_transfer=f16s1["transfer_launches"],
                 **{f"float16_predict_b{b}": p["launches"]
                    for b, p in f16gg["predictor"].items()})
    k13h, k45h, f16t = f16["k13"], f16["k45"], f16["times"]
    k4h_checks = [{k: c[k] for k in ("rows", "batch", "glimpses",
                                     "normalize", "alpha_abs_err", "k4h")}
                  for c in k45h["checks"]]
    k5h_checks = [{k: c[k] for k in ("rows", "batch", "glimpses",
                                     "normalize", "k5h")}
                  for c in k45h["checks"]]
    for name, source, replaces, err, path, extra in (
            ("gru_fwd_f16", "gru_fwd_f16.cu", ref + "gru.py:227",
             k13h["err1"], "float16_training", {
                 "tol": TOL_F16_GRU,
                 "checks": [{k: c[k] for k in ("batch", "reverse",
                                               "k1h_abs_err")}
                            for c in k13h["checks"]]}),
            ("gru_bwd_f16", "gru_bwd_f16.cu", ref + "gru.py:259",
             k13h["err3"], "float16_training", {
                 "tol_rel": TOL_F16_K3_REL,
                 "checks": [{k: c[k] for k in ("batch", "reverse", "k3h")}
                            for c in k13h["checks"]]}),
            ("attention_resident_fwd_f16", "attention_resident_fwd_f16.cu",
             ref + "attention_resident.py:150", k45h["err4"],
             "float16_training", {
                 "tol_h_rel": TOL_F16_K4_H_REL,
                 "tol_vatt_rel": TOL_F16_VATT_REL, "tol_alpha": TOL_ALPHA,
                 "glimpses": list(F16_GLIMPSES),
                 "checks": [c for c in k4h_checks if c["rows"] != "int8"]}),
            ("attention_resident_bwd_f16", "attention_resident_bwd_f16.cu",
             ref + "attention_resident.py:208", k45h["err5"],
             "float16_training", {
                 "tol_rel": TOL_F16_K5_REL, "glimpses": list(F16_GLIMPSES),
                 "checks": [c for c in k5h_checks if c["rows"] != "int8"]}),
            ("attention_resident_fwd_f16[int8]",
             "attention_resident_fwd_f16.cu",
             ref + "attention_resident.py:174", k45h["err4"],
             "float16_int8_training", {
                 "tol_h_rel": TOL_F16_K4_H_REL,
                 "tol_vatt_rel": TOL_F16_VATT_REL,
                 "glimpses": list(F16_GLIMPSES),
                 "checks": [c for c in k4h_checks if c["rows"] == "int8"]}),
            ("attention_resident_bwd_f16[int8]",
             "attention_resident_bwd_f16.cu",
             ref + "attention_resident.py:235", k45h["err5"],
             "float16_int8_training", {
                 "tol_rel": TOL_F16_K5_REL, "glimpses": list(F16_GLIMPSES),
                 "checks": [c for c in k5h_checks if c["rows"] == "int8"]})):
        t = f16t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{source}",
            "replaces": replaces, "launches": paths[path][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err, **extra, "ms": t["kernel"],
            "bf16_ms": t["bf16_ms"], "turns_ms": t["turns_ms"],
            "plain_ms": t["plain"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library"],
            "library_call": t["library_call"]})
    # The float16 kernels of phase 29: K2h and K8h with the launches of its
    # float16 gathered training, K6h and K7h of its float16 stage 1; their
    # checks at both batches, their times at the training batch (K2h also
    # at the serving batch) beside the bf16 kernel's, the bf16 row's bound.
    k28h, k67h, f16gt = f16g["k28"], f16g["k67"], f16g["times"]
    k2hs = f16gt["attention_fwd_f16_serving"]
    for name, replaces, err, path, extra in (
            ("attention_fwd_f16", ref + "attention.py:125", k28h["err2"],
             "float16_gathered_training", {
                 "tol_vatt_rel": TOL_F16_VATT_REL, "tol_alpha": TOL_ALPHA,
                 "tol_r_rel": TOL_R_REL,
                 "checks": [{k: c[k] for k in (
                     "batch", "normalize", "v_att_err", "v_att_tol",
                     "alpha_err", "r_rel_err")} for c in k28h["checks"]],
                 "at_serving_batch": {
                     "batch": B, "ms": k2hs["kernel"],
                     "bf16_ms": k2hs["bf16_ms"],
                     "turns_ms": k2hs["turns_ms"],
                     "plain_ms": k2hs["plain"],
                     "bound_ms": k2hs["bound"][0],
                     "bound_by": k2hs["bound"][1],
                     "library_ms": k2hs["library"]}}),
            ("attention_bwd_f16", ref + "attention.py:267", k28h["err8"],
             "float16_gathered_training", {
                 "tol_rel": TOL_F16_K8_REL, "relu_flip_allowance": True,
                 "checks": [{k: c[k] for k in (
                     "batch", "normalize", "k8h", "units_near_zero")}
                     for c in k28h["checks"]]}),
            ("bigru_fwd_f16", ref + "gru.py:474", k67h["err6"],
             "float16_stage1", {
                 "tol": TOL_F16_GRU,
                 "checks": [{k: c[k] for k in (
                     "batch", "k6h_abs_err", "diff_vs_two_k1h_calls")}
                     for c in k67h["checks"]]}),
            ("bigru_bwd_f16", ref + "gru.py:561", k67h["err7"],
             "float16_stage1", {
                 "tol_rel": TOL_F16_K3_REL,
                 "checks": [{k: c[k] for k in (
                     "batch", "k7h", "diff_vs_two_k3h_calls")}
                     for c in k67h["checks"]]})):
        t = f16gt[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces, "launches": paths[path][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err, **extra, "ms": t["kernel"],
            "bf16_ms": t["bf16_ms"], "turns_ms": t["turns_ms"],
            "plain_ms": t["plain"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library"],
            "library_call": t["library_call"]})
    # Phase 30: the GRU's step forms with the launches of the wide runs that
    # take them, their largest error against their plain versions over the
    # width sweep (K6/K7's: two K1/K3 calls', which they equal bit for bit),
    # their times at WIDE_RNN[-1] (K6/K7's at WIDE_RNN[0]) and at every
    # width timed under at_widths; every 16-bit kernel's largest error to
    # its limit over the sweep under widths_error_to_limit, and the
    # padding's cost under padding_ms.
    wt, wide = widths["gru_times"], WIDE_RNN[-1]
    for name, source, replaces, path in (
            ("gru_fwd_wide", "gru_fwd_wide.cu", ref + "gru.py:227",
             f"widths_stage2_rnn{wide}"),
            ("gru_bwd_wide", "gru_bwd_wide.cu", ref + "gru.py:259",
             f"widths_stage2_rnn{WIDE_RNN[0]}"),
            ("bigru_fwd_wide", "gru_fwd_wide.cu", ref + "gru.py:474",
             f"widths_stage1_rnn{wide}"),
            ("bigru_bwd_wide", "gru_bwd_wide.cu", ref + "gru.py:561",
             f"widths_stage1_rnn{WIDE_RNN[0]}"),
            ("gru_fwd_wide_f16", "gru_fwd_wide_f16.cu", ref + "gru.py:227",
             f"widths_stage2_rnn{wide}_f16"),
            ("gru_bwd_wide_f16", "gru_bwd_wide_f16.cu", ref + "gru.py:259",
             f"widths_stage2_rnn{wide}_f16"),
            ("bigru_fwd_wide_f16", "gru_fwd_wide_f16.cu", ref + "gru.py:474",
             f"widths_stage1_rnn{wide}_f16"),
            ("bigru_bwd_wide_f16", "gru_bwd_wide_f16.cu", ref + "gru.py:561",
             f"widths_stage1_rnn{wide}_f16")):
        at = {k.split("@")[1]: {
            "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library"], "library_call": t["library_call"],
            "launches_a_call": t["launches_a_call"],
            **{x: t[x] for x in ("persistent_ms", "two_k1_ms", "two_k3_ms",
                                 "device_ms_a_step", "split_ms",
                                 "carry_clusters")
               if x in t}}
            for k, t in wt.items() if k.split("@")[0] == name}
        if name == "gru_fwd_wide" or name == "gru_bwd_wide":
            at[f"H{H}_against_persistent"] = wt[f"both_forms@H{H}"][
                "forward" if "fwd" in name else "backward"]
        t = at[f"H{wide}"] if f"H{wide}" in at else at[f"H{WIDE_RNN[0]}"]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{source}",
            "replaces": replaces, "launches": paths[path][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": widths["errors"][name],
            "error_to_limit": widths["error_to_limit"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": t["library_call"], "at_widths": at})
    for k in kernels:
        if k["name"] in widths["error_to_limit"]:
            k["widths_error_to_limit"] = widths["error_to_limit"][k["name"]]
        if k["name"] in widths["pad_times"]:
            k["padding_ms"] = widths["pad_times"][k["name"]]
    report["kernels"] = kernels
    report["library_calls"] = {k: times[k]["library_call"]
                               for k in ("gru_fwd", "gru_bwd", "bigru_fwd",
                                         "bigru_bwd")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
