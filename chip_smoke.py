#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:

1. env     torch and CUDA versions, the card's name and power limit.
2. build   the six kernels from ``src/repro_torch/kernels/csrc/`` (five
           sources, each with its small fixed set of compiled tiles as
           template instances): one nvcc per source, all started together,
           with ``-Xptxas -v``, whose report each build keeps
           (``Library.report``; ``conv_mvu.cu``, and ``mvu_int.cu``,
           ``mvu_binary.cu``, ``mvu_packed.cu``, ``mvu_xnor.cu`` on the
           dense core ``dense_mvu.cuh``): registers, shared memory and
           spills of each kernel instance.
3. kernel  ``mvu_int`` against ``mvu_int_plain`` on the card at every
           (N, K) of the NID path, M in {1, 3, 128, 4096}, in the tile of
           the layer's Table 6 folding as the path launches it
           (``path_tile``: fc0 32 x 64 x 64, the rest 32 x 32 x 32), and at the
           FULL CNV's dense (N, K) at M = 1 (its one image a microbatch),
           all three epilogues, 2-bit and full-int8 weights: exact equality.  Device
           times (CUDA events, median) of the kernel, its plain version and
           a float32 ``torch.matmul`` + epilogue yardstick (``library_ms``;
           exact here since |acc| < 2^24), beside the least time the card
           needs (bytes at 3.35 TB/s or operations at the 1,979 TOP/s int8
           tensor-core peak, whichever is larger).
   kernel  the same for ``mvu_xnor`` (both entries: packed words, and
           ``mvu_xnor_bits`` on int32 activations, which the engine runs),
           ``mvu_binary``, ``mvu_binary_packed`` and ``mvu_int2_packed`` at
           M in {1, 128, 4096} (``mvu_xnor`` and ``mvu_binary`` also at
           the CNV's dense shapes, M = 1), activations up to 299 (the
           packed kernels narrow them to int8 with a wrap; the xnor bit
           entry takes their LSBs); the yardstick multiplies the unpacked
           +/-1 or integer operands.  The timed layers of the kernels on
           the dense core and of ``conv_mvu`` print their launch plan
           (arrangement, tile, K splits = cluster size, dynamic shared
           memory).  Each layer is timed with its own epilogue: thresholds
           (as many as its variant's activation levels) or, on a
           classifier head, the scale.
   kernel  the dense core's arrangements: its six entry points
           (``dense_mvu.CODING``) at N = 10 (ragged), M in
           {1, 9, 100, 128, 4096} x K in {27, 64, 600, 2304} (gemv and
           tiled, with and without split K; NID fc0's 150-byte 2-bit rows
           at K = 600; xnor bits with K not a multiple of 32), activations
           in [-300, 300) (the packed kernels' int8 wrap, the xnor bit
           entry's LSBs), all three epilogues; ``mvu_int`` and
           ``mvu_binary`` with activations near 2^30 and any int8 weight
           (the uint32 wrap); ``mvu_binary_packed`` and ``mvu_int2_packed``
           with every pad bit or lane of the last word or byte set and two
           words or bytes more a row than K needs.
   kernel  ``conv_mvu`` against ``conv_mvu_plain`` at each of the FULL
           CNV's six conv shapes in the three modes, at 1 and 32 images,
           all three epilogues (1 image: K split in a cluster on
           conv1-conv5), plus one stride-2 / pad-1 case per mode and two
           images too wide for the line buffer (the gather arrangement:
           8 x 1000 x 256, and 5 x 3000 x 12 at stride 2, pad 1);
           activations up to 299 for standard and binary (the kernel
           narrows them to int8 with a wrap).  The yardstick is
           ``torch.nn.functional.conv2d`` in float32 (TF32 off) on the
           +/-1 or integer operands plus the same epilogue, timed only.
4. slice   the NID-MLP (Table 6) built on the card in each variant of the
           golden file (2-bit standard, xnor, binary, packed binary,
           packed 2-bit standard); ``acc(x)`` on ``nid.make_dataset(4096,
           seed=1)`` must equal ``acc.interpret(x)`` and the JAX package's
           golden digest, and, with every launch counter set to 0 just
           before it, must launch the variant's kernel exactly
           4 x n_micro times and no other kernel (the xnor variant: and
           call ``packing.pack_bits`` no time, its stages packing in the
           kernel); flows/s at batch 4096 (and 65536 for the standard
           variant), host clock, synchronised.
   slice   the FULL CNV built on the card in each variant of its golden
           file (xnor W1A1, binary A2, standard W2A2); ``acc(x)`` on the
           golden batch of numpy-seeded images must equal
           ``acc.interpret(x)`` and the golden digest, and must launch
           ``conv_mvu`` exactly 6 x n_micro times, the variant's dense
           kernel 3 x n_micro times and nothing else (xnor: no
           ``pack_bits``); images/s at batch 256 and the build seconds.
   slice   the residual MLP (``configs/residual_mlp.py``: 600->64->64,
           a skip join ``add``, ->1; standard, 2-bit, Table 6 folding)
           built on the card; ``acc(x)`` on ``nid.make_dataset(4096,
           seed=1)`` must equal ``acc.interpret(x)`` and the JAX golden
           digest and launch ``mvu_int`` exactly 3 x n_micro times and no
           other kernel; flows/s at batch 4096.
   slice   the deterministic random-DAG sweep of the JAX package's
           ``tests/test_dag_build.py`` (``tests/torch_random_dag.py``:
           seeds and depths (0, 3), (1, 4), (2, 6); skip joins add / sub /
           mul re-quantized) in the standard, binary and xnor datapaths:
           ``FusedEngine(g)(x)`` must equal ``dataflow.execute(g, x)``,
           both on the card, launching the mode's kernel once a stage.
   profile ``acc.profile(x, Tracer(), drift=...)`` on the NID standard
           build at 4096 and the CNV standard build at 256: equal to
           ``acc(x)``, n_micro x len(engine.graph) node spans nested in
           ``engine.profile``, every scheduled stage fed to the drift
           monitor; the median span of each node (host + device: the card
           is synchronised after every node, so these are not ``acc(x)``
           times).
   qat     the paper's Section 6.5 flow (``repro_torch.launch.nid_qat``) at
           full size: ``accuracy_check()``'s two halves, ``prepare`` (the
           flows of ``nid.make_dataset``, 300 steps of straight-through
           training on 4096, the float accuracy on 1024, the streamlined
           build on the card) and ``score``, with its engine call between
           them counted: with every launch counter set to 0 just before it,
           ``acc(x_test)`` must launch ``mvu_int`` exactly 4 x n_micro times
           and nothing else, equal ``acc.interpret(x_test)`` and meet the
           reference's claims (Table 7 cycles, integer accuracy at least the
           float one less 0.05, and above 0.95); its five keys are printed.
           fc0's trained int8 weights (up to +/-127) through ``mvu_int`` at
           its Table 6 tile against ``mvu_int_plain`` at M = the microbatch
           and 1024; flows/s at 1024.  Then each variant of
           ``configs/nid_qat_golden.json`` (seeded float weights, identity or
           seeded batchnorm) built on the card: ``acc(x)`` on
           ``nid.make_dataset(4096, seed=1)`` must equal the interpreter and
           the JAX package's streamlined digest and launch ``mvu_int``
           4 x n_micro times and nothing else.
   examples each ``examples/torch_*.py``'s ``main(device="cuda",
           out_dir=<tmp>)`` (NID with ``fast=True``), finishing with its own
           asserts (engine equal to the interpreter, the kernels it
           launched, served requests equal to the engine); its output in
           ``chiprun_out/example_<name>.log``.  Both phases run before any
           profiler trace.
   trace   one ``torch.profiler`` trace (CPU and CUDA activities) of one
           NID standard ``acc(x)`` at 4096 and one CNV standard ``acc(x)``
           at 256, after two untraced calls and one traced step whose
           events are dropped (CUPTI's first-launch set-up): the window
           (host clock from the call to the end of
           ``torch.cuda.synchronize()``, and the same as the trace's
           annotation), device busy time (the union of kernel, memcpy and
           memset intervals), the device idle share 1 - busy / window
           (and against the untraced ``acc(x)`` time), the host split of
           the window (torch ops, CUDA runtime calls, the rest: Python)
           with the top-level torch ops, the five device ops with the
           most time and the five longest idle gaps with the host op
           under each.  The trace's kernel events of each hand kernel
           must equal its launch counter for that call.  The Chrome traces
           are saved as ``chiprun_out/trace_{nid,cnv}_standard.json.gz``.
           A trace with no device event at all while kernels launched is
           printed with its event categories and taken once more; a second
           such trace in the run fails it, and the count is printed before
           the kernels line.
   serve   the NID-MLP standard variant built with ``target="serving"`` on
           the card (its ``calibrate`` step times ``acc(x)`` at 32 flows,
           synchronised): the calibrated seconds per cycle and the measured
           interval beside the nominal one.  ``acc.serve(batch_buckets=(1,
           8, 32, 128), slo_s=0.05)`` (warm-up and golden canary first)
           then serves the 4,096 flows of ``nid.make_dataset(4096,
           seed=1)`` as a stream of bursts of 1-128 flows (sizes from a
           seeded numpy generator; a single flow goes through ``submit``),
           each burst waiting, polling, for room in the admission queue:
           the outputs, stacked in request order, must equal ``acc(x)`` and
           the golden digest, and with every launch counter set to 0 after
           the warm-up, ``mvu_int`` must launch 4 x the sum of ``n_micro``
           over the dispatched batches and nothing else.  Printed: flows/s
           served (first submit to the end of the drain) beside the same
           build's ``acc(x)`` at 4096, p50/p95/p99 latency, the padding
           share, and per bucket the dispatches, launches and p50/p99.
           Then a chaos run on three logical replicas of the card (a seeded
           ``FaultPlan``: error, straggle and corrupt rates and one replica
           death): every request resolves, equal to ``acc(x)`` or counted
           shed, none dropped; the retry, quarantine, probe and recovery
           counters.  Last a traced run (a ``Tracer`` and
           ``acc.drift_monitor()`` on the batcher): bit-exact with the
           untraced run, its span names and the drift monitor's keys.
           Every bucket's graph is captured at the warm-up: no served run,
           the chaos run included, may capture one, and the counters count
           each replay as its capture's launches (the graph phase traces
           one replay of each bucket's graph against them).
   tune    the autotuner on the card, in a temporary cache (never
           ``experiments/autotune/cache.json``).  First ``conv_mvu``
           against ``conv_mvu_plain`` at every image count the CNV's tile
           race can choose (2, 4, 8, 256) for the FULL CNV's six conv
           shapes, three modes, three epilogues.  Then each NID variant
           (at 4096), the three CNV variants (at 256) and the residual MLP
           (at 4096) built with ``tune="auto"`` on the card, its output on
           the golden batch (the capture and two replays) held to the golden
           digest, its nodes raced at the heuristic microbatch h; then
           ``tune_engine`` races the microbatch tile (h, 2h, 4h, 8h and the
           batch; every tile must be bit-exact, so raced), prints each
           tile's speedup and the choice, and races every node again at
           the rows (images) a launch gets under it: per node its cache
           key, the picked storage and tile, the entry's speedup and
           ``sample_m`` (the chosen microbatch), ``measured_candidates``
           (each compiled tile the node's candidates launch, and a dense
           node that is not xnor its packed datapath, raced against the
           default 32 tile) and each raced candidate's tile and speedup
           with each side's time on the card's clock.  Each is rebuilt with
           ``tune="cache"`` from the filled cache with the timer replaced by
           one that raises: no miss, the recorded tile, and with every launch
           counter set to 0 just before it, its ``acc(x)`` on the golden
           batch launches each node's kernel n_micro times under the tuned
           plan and nothing else, and equals the untuned ``acc(x)`` and the
           golden digest (a packed layer digested in its packed storage);
           at the timed batch it equals the untuned ``acc(x)`` too, and
           each dense node's kernels (both sides of its packed race; xnor:
           the bit entry) equal their plain versions at M = the tuned
           microbatch, on the node's weights and epilogue.  Tuned and
           untuned ``acc(x)`` rates, timed in turns (U T T U) in
           this process; for the NID and CNV standard variants the trace
           phase's lines for one tuned ``acc(x)`` (``trace_*_tuned``); and
           the phase's wall seconds.
   graph   the engine's compiled executable: every ``acc(x)`` above ran
           through it (a CUDA engine captures each key's stream as a CUDA
           graph on the key's first call and replays it after).  For the
           five NID variants at 4096, untuned and tuned, the three CNV
           variants at their golden batch and at 256 (and tuned at 256), and
           the residual MLP, untuned and tuned:
           the second and third call of the key (replays) must equal the
           eager stream (``engine._stream``) and the golden digest (CNV at
           256: its first golden-batch images; tuned: ``tuned_digest``), and
           with every launch counter set to 0, each replay must count what
           the eager stream launched; neither call may capture a graph.  A
           replay's counts are the capture's, added back, so one traced
           replay of each key (``take_trace``, saved as
           ``trace_graph_<label>``) must show the card running exactly
           those hand kernels.
           The graphs each engine captured; untraced ``acc(x)`` medians of
           the eager and the replayed arm in turns (E R R E) as flows/s or
           images/s; a trace each (the trace phase's lines) of the tuned NID
           and CNV standard plans, replayed and eager; the serve phase's
           stream served again in turns on captured buckets and on the
           eager stream (E C C E: flows/s, p50/p99, equal to ``acc(x)``);
           the phase's peak ``torch.cuda.max_memory_allocated()`` and what
           stays allocated and reserved after it.  Last, a new key of the
           tuned CNV (255 images) must reserve less than a quarter of what
           its eager stream's intermediates peak at: the engine's graphs
           on the card share one pool and one capture stream.
   tiles   the per-layer kernel tiles.  Each entry point on the dense
           core at each of its compiled tiles (``dense_mvu.tiles``: 32 rows
           x 32 or 64 columns at K steps 32, and 64 and 128 for int8 rows
           and 2-bit lanes, and 64 x 32 x 32), pinned by its tile kwargs and read back from the
           plan, against its plain version and timed (CUDA events) at the
           NID layers' shapes at M in {64, 4096} (the residual MLP's are
           among them) and the FULL CNV's dense layers at 256 images (at 2
           images: the gemv arrangement, which has no tile, once), and at
           its ragged edges (K past a whole step, N below tile_n and N = 1,
           M one past a tile, split K); ``conv_mvu`` in each mode at each
           pixel x channel tile (``swu_mvu.CONV_TILES``) at the FULL CNV's
           six conv layers at 2 and 256 images.  Each line has the tile's
           registers and spill bytes from the build's ptxas report; every
           time goes to ``chiprun_out/tiles.json``.  Then each build's
           launched tile per layer, untuned (the folding's) and tuned, read
           from the plans; the NID standard variant under Table 6's folding
           and another, whose fc0 launches another tile: each fc0 launch of
           an eager stream must pass the card its planned tile's index, and
           both equal the golden digest; last the untuned and tuned ``acc(x)`` rates against
           every layer pinned to the 32 x 32 x 32 tile by a cache entry, at
           the untuned and at the tuned microbatch, in turns (F U F' T T F'
           U F), NID standard at 4096 and CNV standard at 256: the tuned
           arm's mean time may exceed F''s only by the largest spread of
           an arm's two turns.
   explore the design-space explorer (``repro_torch.explore``) on the card,
           with every launch counter set to 0 just before each sweep: the
           NID-MLP at 4096 flows and the QUICK CNV at 256 images, each over
           the quick grid PE (1, 8, 64) x SIMD (8, 64, 600) x packing (18
           points, ``tune="off"``), the records in
           ``chiprun_out/explore/``.  Each point as the sweep measures it:
           every node's planned tile must be the one its folding maps to
           (``folding_tile``), and each dense launch of the engine's eager
           stream must pass the card that tile's index; the replayed
           ``acc(x)`` must equal the stream; a NID point's ``acc(x)`` on
           ``nid.make_dataset(4096, seed=1)`` must equal the golden digest
           of ``standard`` (unpacked) or ``standard_packed`` (packed).  Then
           every point bit-exact, the NID sweep launching two or more tiles
           on some layer, the sweep's kernels (NID: ``mvu_int`` and
           ``mvu_int2_packed``; CNV: ``conv_mvu`` and ``mvu_xnor``) each
           launched, the warm build of the cache phase all hits, and the
           card holding no more at a later point than at the first beyond
           one input.  Printed: each point's tiles, microbatch, samples/s,
           resource analogs and node device times (one launch at the whole
           batch), the frontier, ``s_per_cycle`` and ``model_error_p90``,
           the cold/warm walls, the phase's wall seconds and peak memory.
   pipeline the FINN dataflow as a GPipe schedule (``acc.as_pipeline``, one
           CUDA stream a stage, events between them).  The full-width chain
           of ``configs/mvu_chain.py`` (eight of the NID's 64 x 64 hidden
           layers, PE 16 x SIMD 32, a batchnorm and a 2-bit quantizer after
           each, so every stage carries thresholds) built with
           ``target="pipeline"`` in standard (2-bit weights, ``mvu_int``)
           and binary (1-bit, ``mvu_binary``) mode; 4,096 numpy-seeded flows
           in 32 microbatches of 128.  ``acc(x)`` must equal the chain run
           layer by layer through the kernel's plain version on the card;
           at 1, 2, 4 and 8 stages on the one card, each run must equal
           ``acc(x)`` and, with every launch counter set to 0 just before
           it, launch the mode's kernel 32 x 8 = 256 times and nothing else.
           The same ticks on the caller's stream alone
           (``run(xs, stage_streams=False)``) must equal it too.  Printed:
           each run's ms on the stage streams and on one stream (CUDA events
           on the caller's stream, median of 7 after a warm-up) beside the
           replayed ``acc(x)``, one stage layer call's host time alone, and
           one stage layer timed as the kernel phase times a layer.  Then
           the JAX package's test chain (d = 32, four layers, 2 bits, 8 x 4)
           at 1, 2 and 4 stages, equal to ``acc(x)``; one traced run at four
           stages (one ``pipeline.run`` span, lanes ``stage0``-``stage3``,
           occupancy 32/35) and a ``torch.profiler`` trace of that schedule
           (streams, busy and overlap, no gate on its events); the float
           example (``examples/torch_dataflow_pipeline.py``), forward and
           gradients against ``sequential_reference``.
   lm      the integer-deployed dense LM (``repro_torch.models``).  First
           the reduced Yi-9B in float32 (``configs/lm_golden.py``: the
           ``lm_numpy_params`` tree, a 2 x 12 prompt, prefill and three
           greedy decode steps), dense and W8A8, held to the JAX package's
           golden run (``configs/yi_9b_lm_golden.json``): logits within
           1e-3 of the largest reference logit, greedy tokens equal, W8A8
           launching ``mvu_int`` 7 x 2 layers x 4 calls and nothing else.
           Then full-width Yi-9B (48 x 4096, 32 / 4 heads, d_ff 11008,
           vocab 64,000, bfloat16) drawn on the card from a seeded
           generator, each layer quantized to W8A8 as it is drawn
           (``init(g, quantize=...)``), served by ``serve_loop``: 8 seeded requests
           (prompts of 32-128 tokens) in groups of 4, 16 new tokens each,
           ``max_len`` 256; with every launch counter set to 0 just
           before it, ``mvu_int`` must launch 7 x 48 x (1 + 16) times a
           group and nothing else, and every request must get its 16
           tokens.  Group 0's prefill and decode step timed on the host
           clock, synchronised (median of 3), and the peak memory.  The
           same model at 4 layers under ``mvu_binary``: one prefill
           launching ``mvu_binary`` 7 x 4 times, finite logits.  Layer 0's
           seven projections (W8A8 and binary) through the wrappers at the
           blocks ``quantized_linear`` passes, at M = 4 (decode, gemv) and
           each group's prefill rows: equal to the plain versions, raw
           int32 accumulators and the scale epilogue, each shape timed as
           the kernel phase times a layer (its plan printed).
   lm_qat  the QAT forward and backward of the dense LM (``Model.loss``,
           ``linear``'s fake-quant arm, remat).  First the reduced Yi-9B in
           float32, remat on, under dense, W8A8 and binary: loss and every
           gradient (``torch.autograd.grad``) held to the JAX package's
           ``jax.value_and_grad`` golden (``configs/yi_9b_qat_golden.json``:
           loss within 1e-5 of |loss|; each leaf's largest magnitude, sum
           and norm, and a layer at a time its first values and product with
           a fixed seeded unit vector, within 1e-4 of its largest magnitude,
           the sum, norm and product scaled by size, sqrt(size) and
           sqrt(row size)); TF32 off; no kernel launched.  Then
           full-width Yi-9B (48 layers, bfloat16, remat on) as float
           params drawn on the card from a seeded generator, under
           ``mvu_w8a8`` and then ``mvu_binary``: loss and every gradient on
           2 x 129 numpy-seeded tokens, finite, each gradient of its
           parameter's shape and dtype, no kernel launched; forward +
           backward on the host clock (synchronised, 3 calls after the
           checked one) and the peak memory.  Then the same weights
           deployed (``quantize_model_params``) and the same 2 x 128 tokens
           prefilled on ``mvu_int`` / ``mvu_binary``, launching it 7 x 48
           times and nothing else; printed as findings: the last-token logit
           correlation against the fake-quant prefill and the share of
           layer 0's fake-quant grid equal to the deployed values.  Layer
           0's deployed projections against the plain versions at M = 256,
           each shape timed.
   train   AdamW training of the dense LM (``make_train_step``:
           ``Model.loss``, ``torch.autograd.grad``, ``adamw.update``) and its
           checkpoint.  First the reduced Yi-9B in float32 under dense and
           W8A8: 4 steps (AdamW lr 1e-3, warmup 2, 8 steps in all, on
           batches of ``SyntheticLM(256, 32, 4)``) held to the JAX package's
           jitted ``make_train_step`` golden
           (``configs/yi_9b_train_golden.json``: each step's loss within
           1e-4 x |loss| + 1e-5, grad_norm within rtol 1e-4, lr within 1e-6;
           the final params and moments, a layer at a time, within 1e-4 of
           each leaf's largest magnitude); no kernel launched.  Then
           full-width Yi-9B cut to 4 layers (2 where the temporary disk or
           the host memory cannot hold one checkpoint; the cut and its
           reasons printed), bf16, remat on, W8A8 QAT, seeded weights: 8
           steps on 8 batches of ``SyntheticLM(64000, 128, 2)``, each timed
           by a ``StepWatchdog`` and ending in the loss's host sync, finite;
           a ``CheckpointManager(every=4, keep=1, async)`` in a temporary
           directory saves step 4; the run dies after step 8, before its
           save; ``resume_latest`` onto the card must equal step 4's state
           bit for bit, and steps 5-8 again the first run's losses within
           rtol 1e-4, atol 1e-5; the directory is removed.  Step ms,
           tokens/s, the watchdog's median and stragglers, peak memory, the
           checkpoint's bytes and its save and restore seconds printed, and
           a step split into the loss with its gradients and the update.
           Then the trained weights deployed (``quantize_model_params``) and
           2 x 128 tokens prefilled on ``mvu_int``, launching it 7 x 4 times
           and nothing else, finite; the logit correlation against the
           fake-quant prefill printed; layer 0's projections against the
           plain versions at M = 256, each shape timed.
   lm_moe  the MoE family (``models/moe.py``: top-k routing, capacity
           dispatch and combine, the experts as ``torch.einsum``; only the
           attention projections integer-deployed, as in the reference).
           First the reduced Granite-MoE and Qwen3-MoE in float32, dense
           and W8A8, held to the JAX package's golden runs
           (``configs/{granite_moe_3b_a800m,qwen3_moe_235b_a22b}_lm_golden.json``:
           logits within 1e-3 of the largest, greedy tokens and each call's
           dropped assignments equal), W8A8 launching ``mvu_int`` 4 x 2
           layers x 4 calls and nothing else.  Then full-width, full-depth
           Granite-MoE 3B-A800M (32 x 1536, 24 / 8 heads of 64, 40 experts
           top-8 of d_ff 512, vocab 49,155, bf16; experts 6.04 GB) drawn
           on the card from a seed, the attention quantized to W8A8 layer
           by layer, served by ``serve_loop`` on the lm phase's 8 requests
           (groups of 4, 16 new tokens, ``max_len`` 256): ``mvu_int``
           exactly 4 x 32 x 17 x 2 times and nothing else, every request
           answered, the prefill assignments dropped by capacity counted
           (none may drop at decode); group 0's prefill and decode ms on the
           host clock (median of 3), tokens/s, peak memory; layer 0's
           ``moe_ffn`` alone at the decode and the prefill rows by CUDA
           events, with its share of a step.  Layer 0's four attention
           projections against the plain version at the decode and each
           group's prefill rows, each shape timed.  Then full-width
           Qwen3-MoE 235B-A22B (4096, 64 / 4 heads of 128, qk-norm, 128
           experts top-8 of d_ff 1536, vocab 151,936) cut to 4 layers
           (experts 19.3 GB): group 0 prefilled and 4 greedy steps,
           ``mvu_int`` 4 x 4 x 5 times and nothing else, finite logits;
           its layer 0's projections as Granite's.  The phase's seconds and
           peak memory.
   lm_ssm  the SSM family (``models/ssm.py``: the chunked SSD, the causal
           convs, the O(1) recurrent decode step).  No SSM projection is in
           ``PROJ_NAMES``, so none is integer-deployed and under W8A8 each
           takes ``linear``'s fake-quant arm, as in the reference: the
           phase launches no kernel, every run counted to hold that.
           First the reduced mamba2 in float32, dense and W8A8, held to the
           JAX package's golden run (``configs/mamba2_780m_lm_golden.json``:
           logits within 1e-3 of the largest, greedy tokens equal).  Then
           full-width, full-depth mamba2-780m (48 x 1536, d_inner 3072, 48
           heads of 64, state 128, chunk 128, vocab 50,280, bf16) drawn on
           the card from a seed with ``init(g, quantize="mvu_w8a8")``, every
           projection still a float ``{"w"}`` and ``A_log`` / ``D`` /
           ``dt_bias`` float32, served by ``serve_loop`` on the lm phase's 8
           requests: every request answered; group 0's prefill and decode ms
           on the host clock (median of 3), tokens/s, the model's bytes and
           peak memory; the decode step again under ``dense`` on the same
           weights (the gap is what the fake-quant arm costs a step); layer
           0's ``ssm_prefill`` and ``ssm_decode_step`` (both backends) by
           CUDA events.  Then ``ssd_chunked`` at full-width shapes across
           chunks (B = 4, S = 300: two chunks and a part; H = 48, P = 64,
           N = 128), float32 against a float64 step recurrence on the card:
           y and the final state within 1e-4 of their largest magnitude.
           Then full-width mamba2-780m in float32 (dense, 3.1 GB): a prefill
           of 2 x 300 tokens against a prefill of 296 and 4 decode steps,
           within the reference's rtol = atol = 2e-2, argmax equal.  The
           phase's seconds and peak memory.
   lm_hybrid  the hybrid (Jamba) interleave of ``models/transformer.py``:
           groups of ``attn_period`` layers, attention at j = per // 2 and
           an SSM layer elsewhere, a MoE FFN at odd j and a dense one at
           even j; only the attention and dense-FFN projections
           integer-deployed, as in the reference.  First the reduced Jamba
           (one group of 4) in float32, dense and W8A8, held to the JAX
           package's golden run (``configs/jamba_1_5_large_398b_lm_golden.json``:
           logits within 1e-3 of the largest, greedy tokens and each call's
           dropped assignments equal), W8A8 launching ``mvu_int`` exactly 10
           times a call (4 attention + 3 x 2 dense-FFN projections) and
           nothing else.  Then full-width Jamba-1.5-Large (8192, 64 / 8
           heads of 128, no RoPE; SSM d_inner 16384 in 128 heads of 128,
           state 128; 16 experts top-2 of d_ff 24576; dense d_ff 24576;
           vocab 65,536, untied; bf16) cut to one group of 4 layers (72 ->
           4, period 8 -> 4: one group of 8 is ~88 GB of weights), drawn on
           the card from a seed with ``init(g, quantize="mvu_w8a8")`` into
           stacks allocated once: the attention and dense FFN int8, the SSM
           projections and the experts bf16, the router and ``A_log`` /
           ``D`` / ``dt_bias`` float32; served by ``serve_loop`` on the lm
           phase's 8 requests, ``mvu_int`` exactly 10 times a call, every
           request answered, the prefill assignments dropped by capacity
           counted (none may drop at decode); the model's bytes, the peak
           while drawing and while serving; group 0's prefill and decode ms
           on the host clock (median of 3), tokens/s; the group's
           attention, SSM, MoE and dense-FFN sub-layers by CUDA events at
           the decode and the prefill rows.  The attention's and the first
           dense FFN's projections ((K, N) = (8192, 8192), (8192, 1024),
           (8192, 24576), (24576, 8192)) against the plain version at the
           decode and each group's prefill rows, each shape timed.  Then the
           reduced Jamba in float32 at capacity 8.0: a prefill of 1 x 40
           tokens (three SSD chunks) against a prefill of 36 and 4 decode
           steps, within rtol = atol = 2e-2, argmax equal.  The phase's
           seconds and peak memory.
   lm_vlm  the VLM backbone (Qwen2-VL): the dense stack with M-RoPE
           (``layers.apply_mrope``, ``models/vlm.py``), every projection
           integer-deployed.  First the reduced Qwen2-VL in float32, dense
           and W8A8, held to the JAX package's golden run
           (``configs/qwen2_vl_7b_lm_golden.json``: logits within 1e-3 of
           the largest, greedy tokens equal), W8A8 launching ``mvu_int``
           exactly 7 x 2 layers x 4 calls = 56 times and nothing else; then
           its loss behind a 40-patch vision prefix (the t, h and w ids all
           distinct), float32, remat on, under dense, W8A8 and binary (the
           fake-quant arm, no kernel), held to the JAX package's prefix-loss
           golden (``configs/qwen2_vl_7b_qat_golden.json``: the loss within
           1e-5, every gradient leaf within 1e-4 of its largest).  Then
           full-width, full-depth Qwen2-VL-7B (28 x 3584, 28 / 4 heads of
           128, M-RoPE sections (16, 24, 24), theta 1e6, SwiGLU d_ff 18944,
           vocab 152,064, untied, bf16) drawn on the card from a seed with
           ``init(g, quantize="mvu_w8a8")``, served by ``serve_loop`` on the
           lm phase's 8 requests (text only: serving reads no vision prefix
           in either package), ``mvu_int`` exactly 7 x 28 x 17 x 2 = 6,664
           times and nothing else, every request answered; the model's
           bytes, the peak while drawing and while serving; group 0's
           prefill and decode ms on the host clock (median of 3), tokens/s,
           and a prefill carrying ``prefix_embeds`` equal to the same
           tokens alone.  Layer 0's projections ((K, N) = (3584, 3584),
           (3584, 512), (3584, 18944), (18944, 3584)) against the plain
           version at the decode and each group's prefill rows, each shape
           timed beside float32 ``torch.matmul``.  Then the QAT loss of
           full-width, full-depth Qwen2-VL-7B (float bf16 params drawn on
           the card, W8A8 fake-quant, remat on) on 2 rows of a 256-patch
           prefix (the reference dry run's 16 x 16 grid, seeded, normal x
           0.02) and 128 predicted tokens, with ``torch.autograd.grad`` of
           every leaf: the loss finite within (0.5, 2.5) x ln(vocab), as the
           reference's smoke test bounds it, every gradient finite, no
           kernel launched; ms a call (3 calls) and the peak memory.  The
           phase's seconds and peak memory.
   lm_encdec  the encoder-decoder (the Whisper backbone): an encoder of
           non-causal self-attention and a decoder of causal self-attention
           and cross attention over the encoder's output
           (``attention.cross_attention``), both stacks integer-deployed,
           the cross attention's projections with them.  First the reduced
           whisper-tiny in float32, dense and W8A8, held to the JAX package's
           golden run (``configs/whisper_tiny_lm_golden.json``: a prefill of
           2 x 12 tokens behind 2 x 20 seeded frame embeddings, 40 encoder
           rows a projection, and three greedy steps; logits within 1e-3 of
           the largest, greedy tokens equal), W8A8 launching ``mvu_int``
           exactly 2 x 6 + 2 x 10 x 4 = 92 times and nothing else; then its
           loss and gradients behind those frames, float32, remat on, under
           dense, W8A8 and binary (the fake-quant arm, no kernel), held to
           the JAX package's QAT golden
           (``configs/whisper_tiny_qat_golden.json``).  Then full-width,
           full-depth whisper-tiny (4 encoder + 4 decoder layers x 384, 6
           heads of 64, GELU d_ff 1536, LayerNorm, vocab 51,865, untied,
           bf16) drawn on the card from a seed with ``init(g,
           quantize="mvu_w8a8")``, served on the lm phase's 8 requests in
           groups of 4 behind (4, 1500, 384) seeded frame embeddings (a
           30-second window's 3000 mel frames after the stride-2 stem, a
           stub in both packages) through ``prefill`` and 16 greedy
           ``decode_step``s (``serve_encdec``: ``serve_loop``'s groups and
           padding; ``serve_loop`` itself must raise ``KeyError:
           'enc_embeds'``, as the reference's does, before any launch):
           ``mvu_int`` exactly 2 x (64 + 16 x 40) = 1,408 times and nothing
           else, every request answered; the model's bytes, the peak while
           drawing and while serving; group 0's encoder, prefill and decode
           ms on the host clock (median of 3), decode tokens/s.  The three
           new shapes ((K, N) = (384, 384), (384, 1536), (1536, 384):
           decoder layer 0's projections) against the plain version at
           M = 4, each group's decoder prefill rows and the encoder's 6,000,
           each timed beside float32 ``torch.matmul``, and the share of a
           decode step's kernel time the cross attention's 8 launches at
           M = 6,000 take (every step projects the encoder memory again).
           Then the QAT loss of full-width, full-depth whisper-tiny (float
           bf16 params, W8A8 fake-quant, remat on) on 2 rows of 1500 frames
           and 128 predicted tokens, with ``torch.autograd.grad`` of every
           leaf: finite within (0.5, 2.5) x ln(vocab), every gradient
           finite, no kernel launched; ms a call (3 calls) and the peak
           memory.  The phase's seconds and peak memory.
5. the kernels JSON line (each kernel also with its tiles phase's times
   by tile; ``mvu_int``'s launches and times include the qat phase's three
   counted ``acc(x)``; ``mvu_int``'s and ``mvu_binary``'s the pipeline,
   lm, lm_qat, train, lm_moe, lm_hybrid, lm_vlm and lm_encdec phases'
   counted runs,
   each launch at its shape; the lm_ssm phase's add none), the card's
   ``nvidia-smi`` line, and last the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package (``src/repro``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(1, os.path.join(HERE, "tests"))  # torch_random_dag: the DAG generator

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
KERNEL_MS = (1, 3, 128, 4096)
NEW_KERNEL_MS = (1, 128, 4096)
SLEEP_CYCLES = 50_000_000  # keeps the card busy while a timed loop is enqueued
CSRC = "src/repro_torch/kernels/csrc/"
# kernel -> (its source, the JAX function it replaces: file:line)
KERNELS = {
    "mvu_int": (CSRC + "mvu_int.cu", "src/repro/kernels/mvu_int.py:59"),
    "mvu_xnor": (CSRC + "mvu_xnor.cu", "src/repro/kernels/mvu_xnor.py:74"),
    "mvu_binary": (CSRC + "mvu_binary.cu", "src/repro/kernels/mvu_binary.py:60"),
    "mvu_binary_packed": (CSRC + "mvu_packed.cu", "src/repro/kernels/mvu_packed.py:124"),
    "mvu_int2_packed": (CSRC + "mvu_packed.cu", "src/repro/kernels/mvu_packed.py:250"),
    "conv_mvu": (CSRC + "conv_mvu.cu", "src/repro/kernels/swu_mvu.py:139"),
}
CONV_IMAGES = (1, 32)
TUNE_CONV_IMAGES = (2, 4, 8, 256)  # the CNV tile race's choices at 256 beside 1
TUNE_NID_BATCH = 4096
# (B, H, W, C, N, stride, pad) of images too wide for conv_mvu's line
# buffer: checked, not timed (the gather arrangement)
CONV_WIDE = [(1, 8, 1000, 256, 64, 1, 0), (1, 5, 3000, 12, 16, 2, 1)]
# the entry point the engine's xnor stages launch, and the kernel whose
# launch counter it adds to
XNOR_PATH_ENTRY = "mvu_xnor_bits"
COUNTER = {XNOR_PATH_ENTRY: "mvu_xnor"}
DENSE_MS = (1, 9, 100, 128, 4096)  # the dense core's checks: both arrangements
DENSE_KS = (27, 64, 600, 2304)
CNV_DENSE_M = 1  # images a CNV microbatch: the dense layers' M on that path
CNV_BATCH = 256  # images per acc(x) for the images/s line
# the tiles phase: the NID layers' M (half the default burst of 128, and
# the timed batch as one microbatch), the CNV's images (its dense layers' M)
TILE_NID_MS = (64, 4096)
TILE_CNV_IMAGES = (2, 256)
TILE_SLEEP_CYCLES = 5_000_000  # covers the enqueue of a timed loop of 20 launches
# the dense entry point -> (mode, packed) of the datapath it runs
ENTRY_DATAPATH = {"mvu_int": ("standard", False), "mvu_binary": ("binary", False),
                  "mvu_binary_packed": ("binary", True), "mvu_int2_packed": ("standard", True),
                  "mvu_xnor": ("xnor", False), XNOR_PATH_ENTRY: ("xnor", False)}
# the dense entry point -> its coding's substring in a kernel's demangled name
ENTRY_CODING = {"mvu_int": "Coding<false,false,false>", "mvu_binary": "Coding<false,false,true>",
                "mvu_binary_packed": "Coding<true,true,true>", "mvu_int2_packed": "Int2Lanes",
                "mvu_xnor": "XnorWords", XNOR_PATH_ENTRY: "XnorBits"}
# a NID folding that launches fc0 in another tile than Table 6's (64, 50):
# PE 16 -> 32 output columns a block, SIMD 40 -> a 64-synapse step
NID_OTHER_FOLDING = ((16, 40), (16, 32), (16, 32), (1, 8))
TRACE_DIR = os.path.join(HERE, "chiprun_out")
DRIFT_S_PER_CYCLE = 1e-8  # any fixed cycle time: the profile phase checks only the keys
SERVE_BUCKETS = (1, 8, 32, 128)
SERVE_SLO_S = 0.05
SERVE_SEED = 0  # the burst sizes
CHAOS_REPLICAS = 3
# the host pause at each side of a traced call: the profiler keeps only the
# device events inside its active window on the host clock, and the card's
# timestamps, carried to that clock, can fall milliseconds early, so a short
# call right at the window's start lost every kernel event in a few traces
# of a hundred (scripts/trace_window_probe.py)
TRACE_PAUSE_S = 0.05
TRACES: list[str] = []  # every report_trace call of this run, by name
TRACE_RETAKES: list[str] = []  # traces taken again (no device event, or part of them)
# the hand kernel a device function of the trace belongs to: a substring of
# its demangled name (spaces removed) -> the kernel's launch counter
# the explore phase: (config, batch) of each sweep, the kernels each must launch
EXAMPLES = {"torch_quickstart": {}, "torch_cnv_dataflow": {}, "torch_residual_mlp": {},
            "torch_nid_intrusion_detection": {"fast": True},
            "torch_dataflow_pipeline": {}}  # main()'s extra kwargs
# the pipeline phase: the chain's seed, stage counts and weight bits by mode
PIPE_SEED = 0
PIPE_STAGES = (1, 2, 4, 8)
PIPE_WEIGHT_BITS = {"standard": 2, "binary": 1}
EXPLORE_RUNS = (("nid_mlp", 4096), ("cnv_quick", CNV_BATCH))
EXPLORE_KERNELS = {"nid_mlp": ("mvu_int", "mvu_int2_packed"),
                   "cnv_quick": ("conv_mvu", "mvu_xnor")}
EXPLORE_DIR = os.path.join(TRACE_DIR, "explore")
# the lm phase: full-width Yi-9B served under W8A8 (seeded weights and
# prompts), and a prefill of its first layers under the binary backend
LM_ARCH = "yi-9b"
LM_BACKEND = "mvu_w8a8"
LM_SEED = 0
LM_REQUESTS = 8
LM_PROMPT_LENS = (32, 128)  # the seeded prompt lengths' range, both ends in
LM_BATCH = 4
LM_MAX_NEW = 16
LM_MAX_LEN = 256
LM_BINARY_LAYERS = 4
# the lm_qat phase: the QAT forward and backward of full-width Yi-9B (seeded
# float weights, remat on) under each backend, then those weights deployed
# and prefilled on the backend's kernel
LM_QAT_KERNELS = {"mvu_w8a8": "mvu_int", "mvu_binary": "mvu_binary"}
LM_QAT_BATCH = 2
LM_QAT_SEQ = 128  # tokens predicted a row; the deployed prefill takes these
LM_QAT_CALLS = 3
# the train phase: AdamW steps of full-width Yi-9B (seeded float weights,
# W8A8 QAT, remat on) at a cut depth, checkpointed at step 4, crashed after
# step 8 and resumed, then the trained weights deployed on mvu_int
TRAIN_BACKEND = "mvu_w8a8"
TRAIN_LAYERS = (4, 2)  # the depth, and the cut if one checkpoint does not fit
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
TRAIN_BATCH = 2
TRAIN_SEQ = 128  # tokens predicted a row; the deployed prefill takes these
TRAIN_CKPT_BYTES_PER_PARAM = 10  # bf16 param + float32 mu and nu
# the lm_moe phase: full-width, full-depth Granite-MoE 3B-A800M served under
# W8A8 on the lm phase's requests, and full-width Qwen3-MoE 235B-A22B cut to
# a few layers (its 94 layers of bf16 experts are ~454 GB)
MOE_SERVE_ARCH = "granite-moe-3b-a800m"
MOE_CUT_ARCH = "qwen3-moe-235b-a22b"
MOE_CUT_LAYERS = 4
MOE_CUT_STEPS = 4  # greedy decode steps after the prefill
MOE_DECODE_CAPACITY = 2.0  # the reference's decode capacity factor
# the lm_ssm phase: full-width, full-depth mamba2-780m served on the lm
# phase's requests (its projections on linear's fake-quant arm: none is in
# PROJ_NAMES), ssd_chunked at full-width shapes, and prefill + decode
# against one long prefill in float32
SSM_ARCH = "mamba2-780m"
SSM_PROJ = ("w_z", "w_x", "w_B", "w_C", "w_dt", "out_proj")
SSM_FLOAT32 = ("A_log", "D", "dt_bias")
SSD_CHECK = (4, 300)  # (B, S): two whole chunks of 128 and a partial one
# y and the final state within SSD_ATOL of their largest magnitude: the
# bound tests/test_ssm.py holds the reference to its recurrence; float32
# on the CPU reaches 4.9e-6 (y) and 2.0e-6 (state) at these shapes, B = 1
SSD_ATOL = 1e-4
SSM_LONG = (2, 300, 4)  # (B, S, decode steps): a prefill of S against S - 4 + steps
SSM_LONG_TOL = 2e-2  # the reference's test_prefill_decode_matches_forward
# the lm_hybrid phase: full-width Jamba-1.5-Large cut to one group of
# HYBRID_CUT layers (one group of its 8 needs 87.7 GB of weights) served on
# the lm phase's requests, and the reduced Jamba's prefill + decode against
# one long prefill in float32
HYBRID_CUT = 4  # num_layers = attn_period: the reference's REDUCED interleave, 1:3
# (K, N) of its integer-deployed projections: wq / wo, wk / wv, w_up / w_gate, w_down
HYBRID_SHAPES = [(8192, 8192), (8192, 1024), (8192, 24576), (24576, 8192)]
HYBRID_LONG = (1, 40, 4)  # (B, S, decode steps): three SSD chunks of 16, one routing group
HYBRID_LONG_CAPACITY = 8.0  # the reference's test_prefill_decode_matches_forward: no drops
ATTN_NAMES = ("wq", "wk", "wv", "wo")  # a block's integer-deployed attention projections
# the lm_vlm phase: full-width, full-depth Qwen2-VL-7B (the backbone; its
# serving reads only tokens, as the reference's does) served on the lm
# phase's requests, and its QAT loss behind the dry run's 16 x 16 patch grid
VLM_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]  # (K, N), as above
VLM_PREFIX = 256  # patches: the reference dry run's prefix, a 16 x 16 grid
VLM_PREFIX_SCALE = 0.02  # the patch embeddings' scale: the token embeddings' init
VLM_LOSS_SEQ = 128  # text tokens predicted a row behind the prefix
VLM_LOSS_CALLS = 3
# the lm_encdec phase: full-width, full-depth whisper-tiny served through
# prefill / decode_step on the lm phase's requests behind a 30 s window's
# encoder positions, and its QAT loss on the dry run's train batch
ENCDEC_FRAMES = 1500  # 3000 mel frames halved by the stride-2 conv stem (a stub)
ENCDEC_SCALE = 0.1  # the frame embeddings' scale: the reference's test's
ENCDEC_SHAPES = [(384, 384), (384, 1536), (1536, 384)]  # (K, N): attention, w_up, w_down
ENCDEC_LOSS_CALLS = 3
TRACE_KERNELS = {
    "conv_mvu_kernel": "conv_mvu",
    "Coding<false,false,false>": "mvu_int",
    "Coding<false,false,true>": "mvu_binary",
    "Coding<true,true,true>": "mvu_binary_packed",
    "Int2Lanes": "mvu_int2_packed",
    "XnorWords": "mvu_xnor",
    "XnorBits": "mvu_xnor",
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_ms(fn, reps: int, trials: int = 5, sleep: int = SLEEP_CYCLES) -> float:
    """Median device milliseconds per call of ``fn`` (CUDA events).

    The card sleeps ``sleep`` cycles while the host enqueues ``reps``
    calls, so the events time back-to-back device work, not the host's
    launch rate.  With ``sleep=0`` and ``reps=1`` they time one call as the
    card sees it, the host's enqueue included (a wall time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(trials):
        if sleep:
            torch.cuda._sleep(sleep)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def ptxas_lines(report: str) -> list[str]:
    """One line per kernel instance of an ``nvcc -Xptxas -v`` report: its
    (demangled) name, registers, shared memory and spill bytes."""
    import re
    import shutil

    entries, name = [], None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers(.*)", line)):
            entries.append((name, f"{m.group(1)} registers{m.group(2)}; {spill}"))
            name = None
    if entries and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in entries),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(entries):
            entries = [(nm, u) for nm, (_, u) in zip(names, entries)]
    return [f"{nm}: {u}" for nm, u in entries]


def plan_text(plan) -> str:
    """A launch plan as printed beside a time: the tile is rows (pixels) x
    columns, and the K step for the dense core."""
    step = f"x{plan.kstep}" if hasattr(plan, "kstep") and plan.arrangement == "tiled" else ""
    return (f"plan={plan.arrangement} {plan.tile_m}x{plan.tile_n}{step} splits={plan.splits} "
            f"smem={plan.smem_bytes}")


def dense_plan_text(name: str, m: int, n: int, k: int, **tile) -> str:
    """The launch plan of an entry point on the dense core at (M, N, K)
    with the tile kwargs ``tile`` (packed xnor: K synapses are ceil(K/32)
    words, its K unit)."""
    from repro_torch.kernels.dense_mvu import CODING, dense_launch_plan

    units = -(-k // 32) if CODING[name] == "words" else k
    return plan_text(dense_launch_plan(
        m, n, units, CODING[name], block_n=tile.get("block_n", 32),
        block_k=tile.get("block_k", tile.get("block_kw", 32)),
        rows_per_tile=tile.get("rows_per_tile")))


def path_tile(name: str, n: int, k: int) -> dict:
    """The tile kwargs the main path launches dense entry point ``name``
    with on an (N, K) NID layer: its Table 6 folding's
    (``folding.to_gpu_blocks``); none for another shape (the CNV's dense
    layers run at one image a microbatch: the gemv arrangement)."""
    from repro_torch.configs import nid_mlp
    from repro_torch.core.folding import Folding, to_gpu_blocks
    from repro_torch.kernels import ops

    for kk, nn, pe, simd in nid_mlp.LAYERS:
        if (nn, kk) == (n, k):
            mode, packed = ENTRY_DATAPATH[name]
            return ops.tile_kwargs(name, **to_gpu_blocks(Folding(pe, simd), mode, packed=packed))
    return {}


def dense_case(name, m, n, k, g, dev):
    """Operands of one check of an entry point on the dense core:
    ``(wrapper, plain, args)``, both taking ``*args`` plus the epilogue.
    Activations in [-300, 300) (the packed kernels narrow them with a
    wrap, the xnor bit entry takes their LSBs, the packed xnor entry their
    packed LSBs); ``mvu_int`` takes any int8 weight, ``mvu_int2_packed``
    2-bit lanes, the binary and xnor kernels {0,1}."""
    import torch

    from repro_torch.kernels import mvu_binary as B, mvu_int as K, mvu_packed as P
    from repro_torch.kernels import mvu_xnor as X, packing

    a = torch.randint(-300, 300, (m, k), generator=g, dtype=torch.int32)
    if name == "mvu_int":
        w = torch.randint(-128, 128, (n, k), generator=g, dtype=torch.int8)
        fn, plain, args = K.mvu_int, K.mvu_int_plain, (a, w)
    elif name == "mvu_int2_packed":
        w2 = torch.randint(-2, 2, (n, k), generator=g, dtype=torch.int8)
        fn, plain, args = P.mvu_int2_packed, P.mvu_int2_packed_plain, (a, packing.pack_int2(w2), k)
    else:
        bits = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8)
        if name == "mvu_binary":
            fn, plain, args = B.mvu_binary, B.mvu_binary_plain, (a, bits)
        elif name == "mvu_xnor":
            fn, plain = X.mvu_xnor, X.mvu_xnor_plain
            args = (packing.pack_bits(a), packing.pack_bits(bits), k)
        elif name == XNOR_PATH_ENTRY:
            fn, plain, args = X.mvu_xnor_bits, X.mvu_xnor_bits_plain, (a, packing.pack_bits(bits))
        else:
            fn, plain = P.mvu_binary_packed, P.mvu_binary_packed_plain
            args = (a, packing.pack_bits(bits), k)
    return fn, plain, tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in args)


def acc_seconds(acc, x, trials: int = 7) -> float:
    """Median host seconds of ``acc(x)`` to its last result on the card
    (``torch.cuda.synchronize()``), after two warm-up calls."""
    import torch

    for _ in range(2):
        acc(x)
    torch.cuda.synchronize()
    secs = []
    for _ in range(trials):
        t0 = time.perf_counter()
        acc(x)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def nid_accelerator(gd):
    """The NID-MLP built on the card for one variant of the golden file."""
    from repro_torch.build import build
    from repro_torch.configs import nid_mlp

    return build(nid_mlp.build_graph(gd["seed"]), target="engine", tune="off",
                 folding=nid_mlp.foldings(), device="cuda", **gd["build"])


def cnv_accelerator(gd):
    """The FULL CNV built on the card for one variant of its golden file."""
    from repro_torch.build import build
    from repro_torch.configs import cnv_bnn

    kw = gd["build"]
    return build(cnv_bnn.build_graph(cnv_bnn.spec_for(kw), seed=gd["seed"]),
                 target="engine", tune="off", device="cuda", **kw)


def burst_sizes(n: int, seed: int) -> list[int]:
    """Burst sizes of 1-128 flows (single flows included), summing to ``n``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(min(int(rng.integers(1, 129)), n - sum(sizes)))
    return sizes


def serve_stream(batcher, xs, sizes) -> list[int]:
    """Submit ``xs`` as bursts of ``sizes`` (a single flow through
    ``submit``), polling after each; a burst waits, polling, until the
    admission queue has room for it.  Returns the rids in request order."""
    rids, at = [], 0
    for size in sizes:
        check(size <= batcher.queue.capacity, f"a burst of {size} exceeds the queue")
        while batcher.queue.depth + size > batcher.queue.capacity:
            batcher.poll()
        burst = xs[at:at + size]
        rids += [batcher.submit(burst[0])] if size == 1 else batcher.submit_batch(burst)
        at += size
        batcher.poll()
    return rids


def record_dispatches(pool) -> list[tuple[int, int, list[int]]]:
    """Wrap ``pool.dispatch`` to log each launched batch: (bucket, its
    plan's n_micro, its rids)."""
    log = []
    dispatch = pool.dispatch

    def logged(xs, entries, n_valid=None, *, exclude=()):
        pending = dispatch(xs, entries, n_valid, exclude=exclude)
        log.append((len(xs), pending.plan.n_micro, [e.rid for e in entries]))
        return pending

    pool.dispatch = logged
    return log


def qat_phase(dev, smi: str) -> list[tuple[int, int]]:
    """The paper's Section 6.5 flow on the card (``repro_torch.launch.nid_qat``):
    ``accuracy_check`` at full size, its engine call counted, then the QAT
    golden variants.  Returns the (microbatch, n_micro) of every counted
    ``acc(x)``, for the kernels line."""
    import torch

    from repro_torch.configs import golden as golden_mod, nid_mlp
    from repro_torch.core.folding import Folding, to_gpu_blocks
    from repro_torch.data import nid
    from repro_torch.kernels import mvu_int as K, ops
    from repro_torch.launch import nid_qat

    t_phase = time.perf_counter()
    counted = []

    def only_mvu_int(counts, plan, what):
        n_micro = plan.n_micro
        check(plan.microbatch in KERNEL_MS, f"qat {what}: microbatch {plan.microbatch}, but "
              f"the kernel phase timed mvu_int at M in {KERNEL_MS} only")
        check(counts == {k: 4 * n_micro if k == "mvu_int" else 0 for k in counts},
              f"qat {what}: acc(x) launched {counts}, want mvu_int 4 x {n_micro} times "
              "and nothing else")

    # accuracy_check() is prepare() then score(acc(x_test)); the engine call
    # between them is the one counted (its first call: eager, then captured)
    t0 = time.perf_counter()
    run = nid_qat.prepare(device="cuda")  # 4096 train / 1024 test flows, 300 steps
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    n_test = run.x_test.shape[0]
    plan = run.acc.plan(n_test)
    ops.reset_launch_counts()
    out = run.acc(run.x_test)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    only_mvu_int(counts, plan, "accuracy_check")
    counted.append((plan.microbatch, plan.n_micro))
    check(out.is_cuda and out.dtype == torch.float32 and tuple(out.shape) == (n_test, 1)
          and bool(torch.isfinite(out).all()), f"qat: bad output {out.dtype} {tuple(out.shape)}")
    res = nid_qat.score(run, out)  # raises unless out equals acc.interpret(x_test)
    check(torch.equal(out, run.acc.interpret(run.x_test)),
          "qat: acc(x_test) differs from acc.interpret(x_test)")
    claims = nid_qat.check_claims(nid_qat.layer_rows(), res)
    print(f"qat: accuracy_check() on the card: {json.dumps(res)}; trained and built in "
          f"{t_prep:.2f} s ({run.acc.report.step_names})", flush=True)
    print(f"qat: acc(x_test) at {n_test} flows equals acc.interpret(x_test); "
          f"{counts['mvu_int']} mvu_int launches = 4 x n_micro={plan.n_micro}, no other "
          f"kernel; claims {claims}", flush=True)

    # fc0 at its Table 6 tile on the trained full-range int8 weights
    fc0 = next(n for n in run.acc.graph if n.op == "mvu").params["mvu"]
    _, _, pe, simd = nid_mlp.LAYERS[0]
    tile = ops.tile_kwargs("mvu_int", **to_gpu_blocks(Folding(pe, simd), "standard"))
    wmax = int(fc0.weights.abs().max())
    for m in (plan.microbatch, n_test):
        a = run.x_test[:m]
        got = K.mvu_int(a, fc0.weights, fc0.thresholds, None, **tile)
        want = K.mvu_int_plain(a, fc0.weights, fc0.thresholds, None)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"qat: mvu_int != mvu_int_plain on fc0's trained weights at M={m} "
              f"(|w| <= {wmax}, {dense_plan_text('mvu_int', m, 64, 600, **tile)})")
    print(f"qat: fc0's trained weights (int8, |w| up to {wmax}) through mvu_int at its "
          f"Table 6 tile {tile} equal mvu_int_plain at M={plan.microbatch} and {n_test}",
          flush=True)
    med = acc_seconds(run.acc, run.x_test)
    print(f"qat: batch {n_test}: {n_test / med:.1f} flows/s (median of 7 acc(x), "
          f"{med * 1e3:.3f} ms)", flush=True)

    # the golden variants: the JAX package's streamlined graph on seeded weights
    for variant, gd in sorted(nid_qat.load_golden().items()):
        acc = nid_qat.build_streamlined(nid_qat.variant_graph(variant))
        x = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0]).to(dev)
        vplan = acc.plan(gd["batch"])
        ops.reset_launch_counts()
        y = acc(x)
        torch.cuda.synchronize()
        only_mvu_int(ops.launch_counts(), vplan, variant)
        counted.append((vplan.microbatch, vplan.n_micro))
        check(torch.equal(y, acc.interpret(x)), f"qat {variant}: acc(x) differs from "
              "acc.interpret(x)")
        check(golden_mod.digest_like(gd, y.cpu().numpy(), acc.graph) == gd,
              f"qat {variant}: the card's output differs from the JAX package's "
              "streamlined golden digest")
        print(f"qat: golden {variant}: acc(x) at {gd['batch']} flows equals "
              f"acc.interpret(x) and the JAX golden digest; {4 * vplan.n_micro} mvu_int "
              f"launches = 4 x n_micro={vplan.n_micro}", flush=True)
    print(f"qat: phase {time.perf_counter() - t_phase:.2f} s ({smi})", flush=True)
    return counted


def examples_phase(smi: str) -> None:
    """Each ``examples/torch_*.py`` ``main(device="cuda", out_dir=<tmp>)`` (the
    NID example with ``fast=True``), finishing with its own asserts; its
    output goes to ``chiprun_out/example_<name>.log``."""
    import contextlib
    import importlib.util
    import tempfile

    t_phase = time.perf_counter()
    os.makedirs(TRACE_DIR, exist_ok=True)
    for name, kwargs in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        log = os.path.join(TRACE_DIR, f"example_{name}.log")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, open(log, "w") as f, \
                contextlib.redirect_stdout(f):
            mod.main(device="cuda", out_dir=tmp, **kwargs)
            reports = sorted(os.listdir(tmp))
        with open(log) as f:
            oks = [ln.strip() for ln in f if ln.startswith("OK") or "ran the" in ln]
        print(f"examples: {name}.main(device='cuda'{', fast=True' if kwargs else ''}) "
              f"finished in {time.perf_counter() - t0:.2f} s; reports {reports}; "
              f"{' | '.join(oks)}", flush=True)
    print(f"examples: phase {time.perf_counter() - t_phase:.2f} s ({smi})", flush=True)


def serve_phase(dev, smi: str):
    """The serve phase (see the module doc): the NID standard variant built
    with ``target="serving"`` on ``dev``, served in bursts, then the chaos
    run and the traced run.  Every bucket's graph is captured at the
    warm-up: no served run captures one.  Returns (the serving build, the
    flows, ``acc(x)`` on them, the burst sizes) for the graph phase."""
    import numpy as np
    import torch

    from repro_torch.build import build
    from repro_torch.configs import golden as golden_mod, nid_mlp
    from repro_torch.core.autotune import cycle_time_key
    from repro_torch.data import nid
    from repro_torch.kernels import ops
    from repro_torch.serving import FaultEvent, FaultPlan, FaultPolicy, ReplicaPool
    from repro_torch.telemetry import Tracer

    gd = nid_mlp.load_golden()["standard"]
    t0 = time.perf_counter()
    sacc = build(nid_mlp.build_graph(gd["seed"]), target="serving", tune="off",
                 folding=nid_mlp.foldings(), device=dev, **gd["build"])
    cal = sacc.calibration
    check(sacc.report.cycle_time_source == "measured" and cal["s_per_cycle"] > 0
          and list(sacc.cache.entries) == [cycle_time_key(dev)],
          f"serve: the serving build did not calibrate on the card: {cal}")
    print(f"serve: standard {gd['build']} target='serving': built "
          f"{sacc.report.step_names} in {time.perf_counter() - t0:.2f} s; calibrated "
          f"s_per_cycle={cal['s_per_cycle']!r} (acc(x) at batch {cal['batch']}, n_micro="
          f"{cal['n_micro']}, {cal['measured_s'] * 1e3:.4f} ms, min of "
          f"{sacc.config.calibrate_reps}) under {cycle_time_key(dev)!r}; measured_interval_s="
          f"{sacc.report.measured_interval_s!r} against the nominal "
          f"{sacc.report.predicted_interval_s!r} ({smi})", flush=True)
    xs_np = nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0]
    want = sacc(torch.from_numpy(xs_np).to(dev)).cpu().numpy()
    sizes = burst_sizes(len(xs_np), SERVE_SEED)
    batcher = sacc.serve(batch_buckets=SERVE_BUCKETS, slo_s=SERVE_SLO_S)
    log = record_dispatches(batcher.pool)
    graphs = sacc.engine.captured_graphs
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = serve_stream(batcher, xs_np, sizes)
    batcher.drain(timeout=300)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(sacc.engine.captured_graphs == graphs >= len(SERVE_BUCKETS),
          f"serve: {sacc.engine.captured_graphs - graphs} graphs captured while serving, "
          f"{graphs} at the warm-up: each bucket's graph must be captured at the warm-up")
    n_micro_sum = sum(n for _, n, _ in log)
    check(counts == {k: 4 * n_micro_sum if k == "mvu_int" else 0 for k in counts},
          f"serve: {counts} launched, want mvu_int 4 x {n_micro_sum} (the sum of n_micro "
          "over the dispatched batches) and nothing else")
    y_served = np.stack([batcher.results[r].out for r in rids])
    check(y_served.dtype == want.dtype and np.array_equal(y_served, want),
          "serve: the served outputs differ from acc(x)")
    check(golden_mod.digest_like(gd, y_served, sacc.graph) == gd,
          "serve: the served outputs differ from the JAX package's golden digest")
    snap = batcher.metrics.snapshot()
    check(snap["completed"] == len(xs_np) and snap["shed"] == 0,
          f"serve: {snap['completed']} completed, {snap['shed']} shed of {len(xs_np)}")
    acc_s = acc_seconds(sacc, torch.from_numpy(xs_np).to(dev))
    print(f"serve: {len(xs_np)} flows in {len(sizes)} bursts of 1-128 "
          f"({sum(s == 1 for s in sizes)} single flows) equal acc(x) and the golden digest; "
          f"{counts['mvu_int']} mvu_int launches = 4 x sum(n_micro)={n_micro_sum} over "
          f"{len(log)} dispatched batches, no other kernel; {graphs} graphs captured at the "
          "warm-up (the buckets, the calibration's batch and the build's probe), none "
          "while serving", flush=True)
    print(f"serve: {len(xs_np) / wall:.1f} flows/s served ({wall * 1e3:.3f} ms, first submit "
          f"to the end of the drain; metrics samples_per_s {snap['samples_per_s']:.1f}) "
          f"against acc(x) at {len(xs_np)}: {len(xs_np) / acc_s:.1f} flows/s "
          f"({acc_s * 1e3:.3f} ms, median of 7); latency p50 {snap['p50_ms']:.4f} ms, p95 "
          f"{snap['p95_ms']:.4f} ms, p99 {snap['p99_ms']:.4f} ms; padding share "
          f"{snap['padding_overhead']:.4f}; deadline misses {snap['deadline_misses']}; "
          f"{smi}", flush=True)
    for bucket in SERVE_BUCKETS:
        batches = [(n, r) for b, n, r in log if b == bucket]
        lat = sorted(batcher.results[rid].latency_s * 1e3 for _, r in batches for rid in r)
        pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]) if lat else (lambda q: 0.0)
        print(f"serve: bucket {bucket}: {len(batches)} batches, "
              f"{4 * sum(n for n, _ in batches)} mvu_int launches, {len(lat)} flows, "
              f"p50 {pct(0.50):.4f} ms, p99 {pct(0.99):.4f} ms", flush=True)

    # the chaos run: three logical replicas on the card, seeded faults
    fault_plan = FaultPlan(seed=SERVE_SEED, rates={"error": 0.05, "straggle": 0.05, "corrupt": 0.05},
                           events=[FaultEvent("die", replica=CHAOS_REPLICAS - 1,
                                               at_dispatch=5)],
                           straggle_delay_s=0.002)
    policy = FaultPolicy(max_retries=3, probe_backoff_s=0.01)
    pool = ReplicaPool(sacc.engine, devices=[dev] * CHAOS_REPLICAS, faults=fault_plan,
                       policy=policy)
    chaos = sacc.serve(batch_buckets=SERVE_BUCKETS, slo_s=SERVE_SLO_S, pool=pool,
                       fault_policy=policy)
    crids = serve_stream(chaos, xs_np, sizes)
    chaos.drain(timeout=300)
    check(sorted(chaos.results) == sorted(crids) and len(crids) == len(xs_np),
          f"chaos: {len(chaos.results)} of {len(crids)} requests resolved")
    n_shed = 0
    for i, rid in enumerate(crids):
        r = chaos.results[rid]
        if r.shed:
            n_shed += 1
        else:
            check(np.array_equal(r.out, want[i]), f"chaos: request {i} differs from acc(x)")
    c = chaos.metrics.counters
    check(c["completed"] + c["shed"] == len(crids) and c["shed"] == n_shed,
          f"chaos: {c['completed']} completed + {c['shed']} shed != {len(crids)}")
    check(pool.replicas[-1].health.dead, "chaos: the replica death was not injected")
    check(sacc.engine.captured_graphs == graphs, "chaos: the logical replicas share the "
          "engine's parameters, so their buckets' graphs, yet the chaos run captured "
          f"{sacc.engine.captured_graphs - graphs}")
    print(f"chaos: {len(crids)} requests on {CHAOS_REPLICAS} logical replicas of the card "
          f"resolved, {c['completed']} equal to acc(x), {c['shed']} counted shed, none "
          f"dropped; " + ", ".join(f"{k} {c[k]}" for k in (
              "dispatch_failures", "retries", "corrupt_batches", "timeouts", "quarantines",
              "probes", "recoveries", "deadline_misses")) + f"; load {pool.load()}", flush=True)

    # the traced run: request lifecycle spans and the calibrated drift monitor
    tr = Tracer()
    drift = sacc.drift_monitor()
    traced = sacc.serve(batch_buckets=SERVE_BUCKETS, slo_s=SERVE_SLO_S, tracer=tr, drift=drift)
    t0 = time.perf_counter()
    trids = serve_stream(traced, xs_np, sizes)
    traced.drain(timeout=300)
    traced_wall = time.perf_counter() - t0
    y_traced = np.stack([traced.results[r].out for r in trids])
    check(np.array_equal(y_traced, y_served), "trace: the traced run differs from the untraced")
    begins = sum(e["ph"] == "b" for e in tr.events())
    check(begins == len(xs_np) and tr.dropped == 0,
          f"trace: {begins} request intervals, {tr.dropped} events dropped")
    names = sorted({f"{e['ph']}:{e['name']}" for e in tr.events()})
    print(f"serve: traced run bit-exact with the untraced one; {len(xs_np) / traced_wall:.1f} "
          f"flows/s ({traced_wall * 1e3:.3f} ms); {len(tr)} events, "
          f"{begins} request intervals; names {names}; drift keys "
          f"{sorted(drift.status()['keys'])}, flagged {drift.status()['flagged']}", flush=True)
    return sacc, xs_np, want, sizes


def plan_launches(acc, batch: int) -> dict[str, int]:
    """The launches of one ``acc(x)`` at ``batch`` under its (tuned) plan:
    each MVU node's kernel (``conv_mvu``, or the dense kernel of its mode
    and storage) once a microbatch, nothing else."""
    from repro_torch.kernels import ops

    n_micro = acc.plan(batch).n_micro
    want = dict.fromkeys(ops.KERNELS, 0)
    for node in acc.engine.graph:
        if node.op in ("mvu", "conv_mvu"):
            cfg = node.attrs["config"]
            want["conv_mvu" if node.op == "conv_mvu"
                 else ops.kernel_name(cfg.mode, cfg.packed)] += n_micro
    return want


def tuned_digest(gd, y, tuned, untuned) -> tuple[dict, dict]:
    """(the digest of a tuned run, the digest it must equal): the golden
    digest ``gd`` of the untuned build, with each layer whose tuned node
    chose the packed datapath digested in its packed storage, packed from
    the untuned build's weights (which phase 4 held to ``gd``)."""
    from repro_torch.configs import golden as golden_mod
    from repro_torch.kernels.mvu_packed import pack_mvu_weights

    layers = golden_mod.graph_layers(untuned.graph)
    for node in tuned.graph:
        cfg = node.attrs.get("config")
        if node.op == "mvu" and cfg.packed and cfg.mode != "xnor":
            old = next(n for n in untuned.graph if n.name == node.name)
            if not old.attrs["config"].packed:
                layers[node.name]["weights"] = pack_mvu_weights(
                    old.params["mvu"].weights, cfg.mode).cpu().numpy()
    want = {**gd, "layers": golden_mod.golden_digest(y, layers)["layers"]}
    return golden_mod.digest_like(gd, y, tuned.graph), want


def dense_at_tile(acc, m: int, g, dev) -> tuple[int, float, list]:
    """Each dense node of ``acc`` against its plain version at M = ``m``
    rows (a tuned plan's microbatch), on the node's weights, epilogue and
    tile: both sides of its packed race (the unpacked kernel and the packed
    twin from the same weights), or, for xnor, the bit entry the engine's
    stages launch; activations in [0, 4) and [-128, 128).  Returns the
    checks made, the largest |kernel - plain| and the (N, K) checked."""
    import torch

    from repro_torch.core.lowering import packable
    from repro_torch.kernels import mvu_binary as B, mvu_int as K, mvu_packed as P
    from repro_torch.kernels import mvu_xnor as X, ops, packing

    n_checked, max_err, shapes = 0, 0.0, []
    for node in acc.engine.graph:
        if node.op != "mvu":
            continue
        cfg, p = node.attrs["config"], node.params["mvu"]
        k, w = cfg.in_features, p.weights
        # (kernel, its plain version, the weights, the arguments after them)
        if cfg.mode == "xnor":
            cases = [(X.mvu_xnor_bits, X.mvu_xnor_bits_plain, w, ())]
        else:
            if cfg.packed:  # the packed storage's own weights, unpacked
                w = (packing.unpack_bits(w, k) if cfg.mode == "binary"
                     else packing.unpack_int2(w, k)).to(torch.int8)
            cases = [(B.mvu_binary, B.mvu_binary_plain, w, ()) if cfg.mode == "binary"
                     else (K.mvu_int, K.mvu_int_plain, w, ())]
            if packable(cfg):
                wp = P.pack_mvu_weights(w, cfg.mode)
                cases.append((P.mvu_binary_packed, P.mvu_binary_packed_plain, wp, (k,))
                             if cfg.mode == "binary"
                             else (P.mvu_int2_packed, P.mvu_int2_packed_plain, wp, (k,)))
        shapes.append((cfg.out_features, k, [fn.__name__ for fn, *_ in cases]))
        for lo, hi in ((0, 4), (-128, 128)):
            a = torch.randint(lo, hi, (m, k), generator=g, dtype=torch.int32).to(dev)
            for fn, plain, wk, extra in cases:
                args = (a, wk, *extra)
                got = fn(*args, p.thresholds, p.out_scale,
                         **ops.tile_kwargs(fn.__name__, **cfg.kernel_blocks()))
                want = plain(*args, p.thresholds, p.out_scale)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"tune: {fn.__name__} != its plain version at the tuned tile M={m} "
                      f"N={cfg.out_features} K={k} ({node.name}), a in [{lo},{hi})")
                max_err = max(max_err, (got.double() - want.double()).abs().max().item())
                n_checked += 1
    return n_checked, max_err, shapes


def tune_phase(dev, smi: str, path_accs: dict) -> dict:
    """The tune phase (see the module doc): conv_mvu at the tile race's
    image counts; each NID variant and the CNV standard variant built with
    ``tune="auto"`` on the card, its tile raced, rebuilt from the cache with
    ``tune="cache"`` (no timer may run) and held to the untuned build and
    its golden digest; tuned and untuned ``acc(x)`` timed in turns.  Returns
    the ``tune="cache"`` rebuilds by (config, variant)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.build import build
    from repro_torch.configs import cnv_bnn, nid_mlp, residual_mlp
    from repro_torch.core import autotune
    from repro_torch.data import nid
    from repro_torch.kernels import ops, swu_mvu as C

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(1)
    # 1. conv_mvu at every image count the CNV tile race can choose
    n_checked, max_err = 0, 0.0
    for mode in C.MODES:
        for h, c, n in conv_shapes(cnv_bnn.FULL):
            for b in TUNE_CONV_IMAGES:
                x, w, _, _, _ = conv_case(mode, b, h, c, n, 3, g, dev)
                k = 9 * c
                thr = torch.sort(torch.randint(-8 * k, 8 * k, (n, 3), generator=g,
                                               dtype=torch.int32), dim=1).values.to(dev)
                scale = (torch.rand(n, generator=g) + 0.01).to(dev)
                for t, s in ((None, None), (thr, None), (None, scale)):
                    got = C.conv_mvu(x, w, t, s, kernel=3, mode=mode)
                    want = C.conv_mvu_plain(x, w, t, s, kernel=3, mode=mode)
                    torch.cuda.synchronize()
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"tune: conv_mvu != conv_mvu_plain ({mode}) at B={b} H=W={h} C={c} "
                          f"N={n} thresholds={t is not None} scale={s is not None}")
                    max_err = max(max_err, (got.double() - want.double()).abs().max().item())
                    n_checked += 1
    print(f"tune: conv_mvu at {TUNE_CONV_IMAGES} images (the CNV tile race's choices) x the "
          f"FULL CNV's six conv shapes x three modes x three epilogues: {n_checked} checks "
          f"equal to the plain version, max_abs_err={max_err}", flush=True)

    races: list[tuple] = []  # the current node search's (candidate, (t_a, t_b, speedup))
    node_races: list[tuple[str, list[tuple]]] = []  # per tune_node call, in order
    tile_races: dict[int, float] = {}
    tune_node, node_fn = autotune.tune_node, autotune._node_fn

    def tagged_node_fn(cfg, params, cand, conv):
        fn = node_fn(cfg, params, cand, conv)
        fn.candidate = cand  # the timer reads which candidate it races
        return fn

    def timer(fa, fb, *args, **kw):
        r = autotune.paired_times(fa, fb, *args, **kw)
        if isinstance(getattr(fb, "_tile", None), int):
            tile_races[fb._tile] = r[2]
        else:
            races.append((fb.candidate, r))
        return r

    def traced_tune_node(node, *args, **kw):
        races.clear()
        entry = tune_node(node, *args, **kw)
        node_races.append((node.name, list(races)))
        return entry

    def no_timer(*a, **kw):
        raise RuntimeError("tune=\"cache\" ran the timer")

    cases = [("nid", v) for v in ("standard", *sorted(v for v in nid_mlp.load_golden()
                                                      if v != "standard"))]
    cases += [("cnv", "standard"), ("cnv", "binary"), ("cnv", "xnor"),
              ("residual", "standard")]
    tuned = {}
    with tempfile.TemporaryDirectory() as tmp:
        old_env = os.environ.get(autotune.CACHE_PATH_ENV)
        os.environ[autotune.CACHE_PATH_ENV] = os.path.join(tmp, "cache.json")
        for cfg_name, variant in cases:
            if cfg_name in ("nid", "residual"):
                mlp = nid_mlp if cfg_name == "nid" else residual_mlp
                gd = nid_mlp.load_golden()[variant] if cfg_name == "nid" else \
                    residual_mlp.load_golden()
                graph = lambda gd=gd, mlp=mlp: mlp.build_graph(gd["seed"])  # noqa: E731
                extra = {"folding": mlp.foldings()}
                batch = TUNE_NID_BATCH
                xb = torch.from_numpy(nid.make_dataset(batch, seed=gd["data_seed"])[0])
                xg = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0])
            else:
                gd = cnv_bnn.load_golden()[variant]
                graph = lambda gd=gd: cnv_bnn.build_graph(  # noqa: E731
                    cnv_bnn.spec_for(gd["build"]), seed=gd["seed"])
                extra = {}
                batch = CNV_BATCH
                ab = gd["build"]["act_bits"]
                xb = torch.from_numpy(cnv_bnn.images(batch, ab, gd["data_seed"]))
                xg = torch.from_numpy(cnv_bnn.images(gd["batch"], ab, gd["data_seed"]))
            xb, xg = xb.to(dev), xg.to(dev)
            untuned = path_accs[(cfg_name, variant)]
            label = f"{cfg_name} {variant}"
            # the search: tune="auto" on the card, then the engine tile and
            # the nodes again at the rows a launch gets under it
            cache = autotune.ScheduleCache()
            node_races.clear()
            tile_races.clear()
            autotune.paired_timer, autotune.tune_node = timer, traced_tune_node
            autotune._node_fn = tagged_node_fn
            t0 = time.perf_counter()
            acc = build(graph(), target="engine", tune="auto", cache=cache, device=dev,
                        **extra, **gd["build"])
            t_build = time.perf_counter() - t0
            build_picks = {k: tile_pick(e) for k, e in cache.entries.items()}
            build_races = list(node_races)
            node_races.clear()
            t0 = time.perf_counter()
            entry = autotune.tune_engine(acc.graph, batch, cache=cache,
                                         pack=gd["build"].get("pack", "auto"))
            t_engine = time.perf_counter() - t0
            autotune.paired_timer, autotune.tune_node = autotune.paired_times, tune_node
            autotune._node_fn = node_fn
            # the tune="auto" build on the golden batch: its capture, two replays
            for _ in range(3):
                y = acc(xg)
                torch.cuda.synchronize()
                got_digest, want_digest = tuned_digest(gd, y.cpu().numpy(), acc, untuned)
                check(got_digest == want_digest, f"tune: {label}: the tune='auto' build's "
                      "acc(x) differs from the golden digest")
            scope = autotune.device_kind(dev)
            check(all(k.split("|")[1] == scope for k in cache.entries if k.startswith("engine|"))
                  and all(k.startswith(scope + "|") for k in cache.entries
                          if not k.startswith("engine|")),
                  f"tune: {label}: cache keys outside the card's scope {scope}: "
                  f"{sorted(cache.entries)}")
            heur = untuned.plan(batch).microbatch
            print(f"tune: {label} {gd['build']}: tune='auto' build in {t_build:.2f} s "
                  f"(report.tune {acc.report.tune}; its nodes raced at h={heur}: "
                  + ", ".join(f"{'|'.join(k.split('|')[1:5])} {p}"
                              for k, p in build_picks.items())
                  + f"), tune_engine at batch {batch} in {t_engine:.2f} s; {len(cache)} cache "
                  "entries", flush=True)
            want_tiles = sorted({heur * 2, heur * 4, heur * 8, batch} - {heur})
            check(sorted(tile_races) == want_tiles,
                  f"tune: {label}: tiles {sorted(tile_races)} raced, want {want_tiles} (a "
                  "tile whose output differs from the heuristic plan's is not raced)")
            print(f"tune: {label}: tile race at batch {batch} against h={heur}: "
                  + ", ".join(f"{t} -> {r:.4f}x" for t, r in sorted(tile_races.items()))
                  + f"; chose microbatch={entry['microbatch']} speedup={entry['speedup']:.4f}"
                  f" (margin 1.10: clears it by {entry['speedup'] / 1.10:.4f}x)", flush=True)
            # one tune_node call a node in the build and again in tune_engine,
            # each putting its key, in the same order; tune_engine's at the
            # rows (images) a launch gets under the chosen microbatch. A node
            # races its compiled tiles (and, a dense node that is not xnor,
            # its packed datapath) against the default 32 tile
            node_keys = [k for k in cache.entries if not k.startswith("engine|")]
            samples = -(-batch // -(-batch // entry["microbatch"]))
            check(len(node_keys) == len(build_races) == len(node_races),
                  f"tune: {label}: {len(build_races)} and {len(node_races)} node searches "
                  f"for {len(node_keys)} entries")
            for key, (name, raced) in zip(node_keys, node_races):
                e = cache.get(key)
                check(e["measured_candidates"] == len(raced) >= 1 and e["backend"] == "cuda"
                      and e["sample_m"] == samples,
                      f"tune: {label} {name}: measured {e['measured_candidates']} candidates "
                      f"({len(raced)} races) on {e['backend']!r} at {e['sample_m']} samples, "
                      f"want every race, at least one, on 'cuda' at {samples}")
                print(f"tune: {label} {name} {key}: at {e['sample_m']} samples picked "
                      f"{tile_pick(e)} speedup={e['speedup']:.4f} "
                      f"measured_candidates={e['measured_candidates']} raced "
                      + ", ".join(f"{'packed ' if c.packed else ''}n{c.blocks.block_n} "
                                  f"k{c.blocks.block_k} rows{c.blocks.rows_per_tile} "
                                  f"{r:.4f}x ({ta * 1e6:.2f} us 32 tile, {tb * 1e6:.2f} us it)"
                                  for c, (ta, tb, r) in raced)
                      + " (the card's clock, per-side minima; margin 1.05: the entry's "
                      f"speedup / 1.05 = {e['speedup'] / 1.05:.4f})", flush=True)
            # the replay: tune="cache" from the filled cache, no timer
            autotune.paired_timer = no_timer
            t0 = time.perf_counter()
            again = build(graph(), target="engine", tune="cache", cache=cache, device=dev,
                          **extra, **gd["build"])
            t_again = time.perf_counter() - t0
            tuned[(cfg_name, variant)] = again
            check(again.report.tune["cache_misses"] == 0
                  and again.report.tune["engine_tile"] == entry["microbatch"],
                  f"tune: {label}: the cache rebuild reported {again.report.tune}")
            plan = again.plan(gd["batch"])
            for call in range(3):  # the key's first call (capture), then two replays
                ops.reset_launch_counts()
                y = again(xg)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                want_counts = plan_launches(again, gd["batch"])
                check(counts == want_counts, f"tune: {label}: call {call + 1} of the cache "
                      f"rebuild's acc(x) launched {counts}, want {want_counts} (each node's "
                      f"kernel x n_micro={plan.n_micro})")
                check(torch.equal(y, untuned(xg)), f"tune: {label}: the tuned acc(x) differs "
                      "from the untuned one")
                got_digest, want_digest = tuned_digest(gd, y.cpu().numpy(), again, untuned)
                check(got_digest == want_digest,
                      f"tune: {label}: the tuned run differs from the golden digest")
            # the timed batch too: the tuned plan's microbatch there is the
            # tile the race chose, and the dense kernels run at that M
            check(torch.equal(again(xb), untuned(xb)), f"tune: {label}: the tuned acc(x) "
                  f"differs from the untuned one at the timed batch {batch}")
            tile_m = again.plan(batch).microbatch
            n_dense, dense_err, dense_nk = dense_at_tile(again, tile_m, g, dev)
            print(f"tune: {label}: tuned acc(x) at the timed batch {batch} equals the untuned "
                  f"one; the dense kernels at M={tile_m} (the tuned microbatch) equal their "
                  f"plain versions: {n_dense} checks over {dense_nk}, max_abs_err={dense_err}",
                  flush=True)
            autotune.paired_timer = autotune.paired_times
            print(f"tune: {label}: tune='cache' rebuild in {t_again:.2f} s measured nothing; "
                  f"acc(x) at batch {gd['batch']} (its capture and two replays; the "
                  f"tune='auto' build's too) equals the untuned acc(x) and the golden "
                  f"digest (packed layers: "
                  f"{[n.name for n in again.graph if n.op == 'mvu' and n.attrs['config'].packed]}"
                  f"); launches {({k: v for k, v in counts.items() if v})} = the tuned plan "
                  f"(n_micro={plan.n_micro}, microbatch={plan.microbatch})", flush=True)
            # tuned and untuned acc(x), in turns: untuned, tuned, tuned, untuned
            secs = {"untuned": [], "tuned": []}
            for side in ("untuned", "tuned", "tuned", "untuned"):
                secs[side].append(acc_seconds(untuned if side == "untuned" else again, xb))
            unit = "images/s" if cfg_name == "cnv" else "flows/s"
            print(f"tune: {label}: batch {batch}: untuned "
                  + ", ".join(f"{batch / t:.1f}" for t in secs["untuned"])
                  + " " + unit + "; tuned " + ", ".join(f"{batch / t:.1f}" for t in secs["tuned"])
                  + f" {unit} (each the median of 7 acc(x), in the turns U T T U; tuned plan "
                  f"n_micro={again.plan(batch).n_micro} against {untuned.plan(batch).n_micro}; "
                  f"{smi})", flush=True)
            if cfg_name != "residual" and variant == "standard":  # where the time goes
                report_trace(again, xb, f"{cfg_name} standard tuned")
        if old_env is None:
            del os.environ[autotune.CACHE_PATH_ENV]
        else:
            os.environ[autotune.CACHE_PATH_ENV] = old_env
    print(f"tune: phase done in {time.perf_counter() - t_phase:.2f} s wall ({len(cases)} "
          "builds tuned and replayed)", flush=True)
    return tuned


def graph_phase(dev, smi: str, path_accs: dict, tuned: dict, served) -> None:
    """The graph phase (see the module doc): replays against the eager
    stream and the golden digests, their launches, rates in turns, traces,
    serving on captured buckets against the eager stream, and memory."""
    import numpy as np
    import torch

    from repro_torch.configs import cnv_bnn, golden as golden_mod, nid_mlp, residual_mlp
    from repro_torch.data import nid
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    # (label, build, input, golden digest, the untuned build of a tuned one, unit)
    cases = []
    for v, gd in sorted(nid_mlp.load_golden().items()):
        x = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0]).to(dev)
        cases.append((f"nid {v}", path_accs[("nid", v)], x, gd, None, "flows/s"))
        cases.append((f"nid {v} tuned", tuned[("nid", v)], x, gd, path_accs[("nid", v)],
                      "flows/s"))
    for v, gd in sorted(cnv_bnn.load_golden().items()):
        for b in (gd["batch"], CNV_BATCH):
            # the golden batch's images are the first of the larger batch's
            x = torch.from_numpy(cnv_bnn.images(b, gd["build"]["act_bits"],
                                                gd["data_seed"])).to(dev)
            cases.append((f"cnv {v} batch {b}", path_accs[("cnv", v)], x, gd, None,
                          "images/s"))
            if v == "standard" and b == CNV_BATCH:
                cases.append((f"cnv {v} tuned batch {b}", tuned[("cnv", v)], x, gd,
                              path_accs[("cnv", v)], "images/s"))
    gd = residual_mlp.load_golden()
    x = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0]).to(dev)
    cases.append(("residual", path_accs[("residual", "standard")], x, gd, None, "flows/s"))
    eager_arms = {}
    for label, acc, x, gd, untuned, unit in cases:
        eng = acc.engine
        batch = x.shape[0]
        n_micro = acc.plan(batch).n_micro

        def eager(x, eng=eng, n_micro=n_micro):
            return eng._stream(eng.params, x, n_micro)

        eager_arms[label] = eager
        ops.reset_launch_counts()
        want = eager(x)
        torch.cuda.synchronize()
        eager_counts = ops.launch_counts()
        acc(x)  # the key's first call, unless an earlier phase made it
        torch.cuda.synchronize()
        graphs = eng.captured_graphs
        ys = []
        for call in (2, 3):
            ops.reset_launch_counts()
            ys.append(acc(x))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            check(counts == eager_counts, f"graph: {label}: call {call} launched {counts}, "
                  f"the eager stream {eager_counts}")
        check(eng.captured_graphs == graphs, f"graph: {label}: a repeated key captured "
              f"{eng.captured_graphs - graphs} graphs")
        check(all(y.dtype == want.dtype and torch.equal(y, want) for y in ys),
              f"graph: {label}: a replay differs from the eager stream")
        check(ys[0].data_ptr() != ys[1].data_ptr(), f"graph: {label}: two replays "
              "returned one buffer")
        y_np = ys[1][:gd["batch"]].cpu().numpy()
        if untuned is None:
            got, want_digest = golden_mod.digest_like(gd, y_np, acc.graph), gd
        else:
            got, want_digest = tuned_digest(gd, y_np, acc, untuned)
        check(got == want_digest, f"graph: {label}: a replay differs from the golden digest")
        # the counters of a replay are the capture's, added back: the card's
        # kernel events in one traced replay must equal them
        traced = take_trace(acc, x, f"graph {label}")
        check(traced["counts"] == eager_counts and eng.captured_graphs == graphs,
              f"graph: {label}: the traced replay counted {traced['counts']}, the eager "
              f"stream {eager_counts}")
        secs = {"replayed": [], "eager": []}
        for arm in ("eager", "replayed", "replayed", "eager"):
            secs[arm].append(acc_seconds(acc if arm == "replayed" else eager, x))
        print(f"graph: {label}: calls 2 and 3 of the key (replays) equal the eager stream "
              f"and the golden digest (its first {gd['batch']} rows); launches per replay "
              f"{({k: v for k, v in counts.items() if v})} = the eager stream's = the "
              f"hand-kernel events of one traced replay ({traced['device_events']} device "
              "events; " + os.path.relpath(traced["path"], HERE) + "); n_micro="
              f"{n_micro}; no capture on a repeated key ({graphs} graphs in this engine); "
              f"batch {batch}: replayed " + ", ".join(f"{batch / t:.1f}" for t in secs["replayed"])
              + f" {unit}, eager " + ", ".join(f"{batch / t:.1f}" for t in secs["eager"])
              + f" {unit} (each the median of 7 acc(x), turns E R R E; replayed "
              + ", ".join(f"{t * 1e3:.4f}" for t in secs["replayed"]) + " ms, eager "
              + ", ".join(f"{t * 1e3:.4f}" for t in secs["eager"]) + f" ms; {smi})",
              flush=True)
    engines = {id(a.engine): a.engine for a in (*path_accs.values(), *tuned.values(),
                                                  served[0])}
    print(f"graph: {sum(e.captured_graphs for e in engines.values())} graphs captured in "
          f"this run by {len(engines)} engines ({len(path_accs)} untuned, {len(tuned)} "
          "tuned, the serving build); a repeated key captured none", flush=True)

    # where the time goes, replayed and eager, under the tuned plans
    for label, name in (("nid standard tuned", "nid standard tuned"),
                        (f"cnv standard tuned batch {CNV_BATCH}", "cnv standard tuned")):
        acc, x = next((c[1], c[2]) for c in cases if c[0] == label)
        report_trace(acc, x, f"{name} replayed")
        report_trace(eager_arms[label], x, f"{name} eager")

    # the serve phase's stream again, on captured buckets and on the eager
    # stream in turns (the eager arm swaps the engine's run for its stream
    # for this comparison alone)
    sacc, xs_np, want, sizes = served
    eng = sacc.engine
    # the serve phase counted each bucket's captured launches: one traced
    # replay of each bucket's graph (the replica's parameters are the
    # engine's own, so acc(x) at the bucket's size is its key)
    graphs = eng.captured_graphs
    seen = {}
    for b in SERVE_BUCKETS:
        xb = torch.from_numpy(xs_np[:b]).to(dev)
        traced = take_trace(sacc, xb, f"graph serve bucket {b}")
        n_micro = sacc.plan(b).n_micro
        check(traced["counts"] == {k: 4 * n_micro if k == "mvu_int" else 0
                                   for k in ops.KERNELS},
              f"graph: serve bucket {b}: the traced replay counted {traced['counts']}, want "
              f"mvu_int 4 x n_micro={n_micro}")
        seen[b] = traced["seen"]["mvu_int"]
    check(eng.captured_graphs == graphs, f"graph: serve: tracing the buckets captured "
          f"{eng.captured_graphs - graphs} graphs: a bucket's graph was not the warm-up's")
    print(f"graph: serve: one traced replay of each bucket's graph (captured at the warm-up): "
          f"mvu_int kernel events {seen} by bucket = the counters the serve phase adds a "
          "replay", flush=True)
    runs = {"captured": [], "eager": []}
    for arm in ("eager", "captured", "captured", "eager"):
        if arm == "eager":
            eng._run = eng._stream
        batcher = sacc.serve(batch_buckets=SERVE_BUCKETS, slo_s=SERVE_SLO_S)
        graphs = eng.captured_graphs
        t0 = time.perf_counter()
        rids = serve_stream(batcher, xs_np, sizes)
        batcher.drain(timeout=300)
        wall = time.perf_counter() - t0
        if arm == "eager":
            del eng._run
        y = np.stack([batcher.results[r].out for r in rids])
        check(y.dtype == want.dtype and np.array_equal(y, want),
              f"graph: serve ({arm}): the served outputs differ from acc(x)")
        check(eng.captured_graphs == graphs, f"graph: serve ({arm}): the stream captured "
              f"{eng.captured_graphs - graphs} graphs")
        snap = batcher.metrics.snapshot()
        runs[arm].append((len(xs_np) / wall, snap["p50_ms"], snap["p99_ms"]))
    print("graph: serve: the serve phase's 4,096 flows again, each run equal to acc(x), none "
          "capturing: " + "; ".join(
              f"{arm} " + ", ".join(f"{r:.1f} flows/s (p50 {p50:.4f} ms, p99 {p99:.4f} ms)"
                                    for r, p50, p99 in rs) for arm, rs in runs.items())
          + f" (turns E C C E; {smi})", flush=True)
    print(f"graph: phase done in {time.perf_counter() - t_phase:.2f} s wall; its peak "
          f"torch.cuda.max_memory_allocated() {torch.cuda.max_memory_allocated(dev) / 2**20:.1f}"
          f" MiB; after it {torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB allocated, "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB reserved ({smi})", flush=True)

    # an engine's graphs on one card share one pool and one capture stream:
    # a new key reuses the blocks of the graphs captured before it
    acc, x = next((c[1], c[2]) for c in cases if c[0] == f"cnv standard tuned batch {CNV_BATCH}")
    eng = acc.engine
    n_micro = acc.plan(CNV_BATCH).n_micro
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    eng._stream(eng.params, x, n_micro)
    torch.cuda.synchronize(dev)
    transient = torch.cuda.max_memory_allocated(dev) - base
    graphs = eng.captured_graphs
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    acc(x[:CNV_BATCH - 1])  # a new key: the eager run, then its capture
    torch.cuda.synchronize(dev)
    grown = torch.cuda.memory_reserved(dev) - reserved
    check(eng.captured_graphs == graphs + 1 and grown < transient / 4,
          f"graph: memory: a new key of the tuned CNV reserved {grown / 2**20:.1f} MiB beside "
          f"the engine's graphs, whose eager stream peaks {transient / 2**20:.1f} MiB above "
          "its input: the graphs do not share their blocks")
    print(f"graph: memory: a new key of the tuned CNV ({CNV_BATCH - 1} images) reserved "
          f"{grown / 2**20:.1f} MiB beside the engine's {graphs} graphs; the eager stream at "
          f"{CNV_BATCH} images peaks {transient / 2**20:.1f} MiB above what was allocated "
          f"({smi})", flush=True)


def instance_usage(ptxas: dict, *parts: str) -> tuple[int, int, int]:
    """(fewest, most registers, most spill-store bytes) over the compiled
    instances whose demangled names hold every one of ``parts`` (spaces
    removed): a tile's instances over epilogues and load paths."""
    import re

    regs, spills = [], []
    for name, line in ptxas.items():
        if all(p in name.replace(" ", "") for p in parts):
            regs.append(int(re.search(r"(\d+) registers", line).group(1)))
            m = re.search(r"(\d+) bytes spill stores", line)
            spills.append(int(m.group(1)) if m else 0)
    check(regs, f"tiles: no compiled instance named {parts}")
    return min(regs), max(regs), max(spills)


def tile_label(tile) -> str:
    return "x".join(str(v) for v in tile)


def conv_rows(tile_m: int, ow: int):
    """The rows_per_tile that pins a tile_m-pixel conv tile on rows of ow
    pixels (None: the untuned 32)."""
    from repro_torch.kernels import swu_mvu as C

    return None if tile_m == C.TILE_M else max(1, tile_m // ow)


def tile_pick(e: dict) -> str:
    """A node entry's storage and tile blocks, as printed."""
    return (f"{'packed ' if e.get('packed') else ''}block_n={e['block_n']} "
            f"block_k={e['block_k']} block_kw={e['block_kw']} rows_per_tile={e['rows_per_tile']}")


def node_tiles(acc, batch: int) -> list[tuple]:
    """Each MVU node of the engine and its launched tile at ``batch``'s
    microbatch, read from its launch plan: ``(node, tile)``, the tile
    ``(arrangement, rows, columns, K step)`` for a dense node (gemv: no
    tile of its own) and ``(arrangement, pixels, channels)`` for a conv."""
    from repro_torch.core import autotune, ir
    from repro_torch.core.mvu import KernelBlocks

    mb = acc.plan(batch).microbatch
    out = []
    for node, ins, _ in ir.io_shapes(acc.engine.graph):
        if node.op not in ("mvu", "conv_mvu"):
            continue
        cfg = node.attrs["config"]
        conv = ({k: node.attrs[k] for k in ("kernel", "stride", "pad")}
                if node.op == "conv_mvu" else None)
        tile, _ = autotune.launched_tile(cfg, KernelBlocks.from_blocks(cfg.kernel_blocks()),
                                         cfg.packed or cfg.mode == "xnor", m=mb, conv=conv,
                                         in_shape=ins[0] if conv is not None else None)
        out.append((node, tile))
    return out


def layer_tiles(acc, batch: int) -> list[str]:
    """Each MVU node's launched tile at ``batch``'s microbatch, read from its
    launch plan: ``name=tile`` (dense: rows x columns x K step, or gemv;
    conv: pixels x channels)."""
    return [f"{node.name}={tile[0]} {tile_label(tile[1:])}" for node, tile in
            node_tiles(acc, batch)]


def tiles_phase(dev, smi: str, ptxas: dict, path_accs: dict, tuned: dict) -> dict:
    """The tiles phase (see the module doc): every kernel against its plain
    version at every compiled tile, on the main path's shapes and at its
    ragged edges, timed, with its registers and spills; the layers' tiles
    of every build; two foldings of one layer launching two tiles, as the
    launches pass them to the card; the untuned (folding) and tuned acc(x) rates
    against the fixed 32 tile in turns.  Returns, by kernel, each tile's
    summed ms over the main path's shapes and its ptxas usage."""
    import torch

    from repro_torch.build import build
    from repro_torch.configs import cnv_bnn, golden as golden_mod, nid_mlp
    from repro_torch.core import autotune
    from repro_torch.core.engine import FusedEngine
    from repro_torch.core.folding import Folding
    from repro_torch.data import nid
    from repro_torch.kernels import dense_mvu, mvu_int as K, ops, swu_mvu as C

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(29)
    out = {name: [] for name in KERNELS}
    records = []  # every timed (kernel, tile, shape, ms) for chiprun_out/tiles.json

    def err(got, want):
        return (got.double() - want.double()).abs().max().item() if got.numel() else 0.0

    # 1. the dense core: each entry point at each of its compiled tiles
    nid_shapes = [(m, n, k) for m in TILE_NID_MS for k, n, _, _ in nid_mlp.LAYERS]
    cnv_dense = dense_shapes(cnv_bnn.FULL)
    cnv_shapes_ = [(b, n, k) for b in TILE_CNV_IMAGES for n, k in cnv_dense]
    for name, coding in dense_mvu.CODING.items():
        kernel = COUNTER.get(name, name)
        unit = 32 if coding == "words" else 1
        cases = {}  # (m, n, k) -> (args, thresholds or scale, plain output)
        for i, (m, n, k) in enumerate(nid_shapes + cnv_shapes_):
            fn, plain, args = dense_case(name, m, n, k, g, dev)
            head = n < 10 or (i >= len(nid_shapes) and n == cnv_dense[-1][0])
            span = {"mvu_int": 128 * 300 * k, "mvu_xnor": k}.get(kernel, 300 * k)
            thr = torch.sort(torch.randint(-span, span, (n, 3), generator=g,
                                           dtype=torch.int32), dim=1).values.to(dev)
            scale = (torch.rand(n, generator=g) + 0.01).to(dev)
            epi = (None, scale) if head else (thr, None)
            cases[(m, n, k)] = (args, epi, plain(*args, *epi))
        gemv_ms = {}  # (m, n, k) -> ms of the gemv arrangement, which has no tile
        for tile in dense_mvu.tiles(coding):
            tm, tn, tk = tile
            kw = ops.tile_kwargs(name, block_n=tn, block_k=tk, block_kw=tk, rows_per_tile=tm)
            max_e, times, n_checked = 0.0, {}, 0
            for (m, n, k), (args, epi, want) in cases.items():
                plan = dense_mvu.dense_launch_plan(m, n, -(-k // unit), coding, block_n=tn,
                                                   block_k=tk, rows_per_tile=tm)
                if plan.arrangement == "gemv":
                    if (m, n, k) in gemv_ms:
                        continue  # no tile: once an entry point
                else:
                    check((plan.tile_m, plan.tile_n, plan.kstep) == tile,
                          f"tiles: {name} at M={m} N={n} K={k} planned "
                          f"{plan.tile_m}x{plan.tile_n}x{plan.kstep}, not {tile_label(tile)}")
                got = fn(*args, *epi, **kw)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"tiles: {name} != its plain version at tile {tile_label(tile)} "
                      f"M={m} N={n} K={k}")
                max_e, n_checked = max(max_e, err(got, want)), n_checked + 1
                ms = device_ms(lambda: fn(*args, *epi, **kw), reps=20, trials=3,
                               sleep=TILE_SLEEP_CYCLES)
                (times if plan.arrangement == "tiled" else gemv_ms)[(m, n, k)] = ms
                records.append({"kernel": name, "tile": tile_label(tile) if plan.arrangement
                                == "tiled" else "gemv", "m": m, "n": n, "k": k, "ms": ms})
            # the ragged edges: K past a whole step, N below tile_n and N = 1,
            # M one past a tile, and an output of few tiles (split K)
            for m, n, ku in ((tm + 1, tn - 3, tk + 5), (tm + 1, 1, 3 * tk - 1),
                             (2 * tm - 1, tn + 1, 600), (4 * tm, 10, 2 * tk + 9)):
                k = ku * unit
                fn, plain, args = dense_case(name, m, n, k, g, dev)
                thr = torch.sort(torch.randint(-300 * k, 300 * k, (n, 3), generator=g,
                                               dtype=torch.int32), dim=1).values.to(dev)
                for t in (None, thr):
                    got, want = fn(*args, t, None, **kw), plain(*args, t, None)
                    torch.cuda.synchronize()
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"tiles: {name} != its plain version at tile {tile_label(tile)}, "
                          f"ragged M={m} N={n} K={k}")
                    max_e, n_checked = max(max_e, err(got, want)), n_checked + 1
            rmin, rmax, spill = instance_usage(ptxas, ENTRY_CODING[name],
                                               f"Tile<{tm},{tn},{tk}>")
            nid_ms = {mm: sum(v for (m, _, _), v in times.items() if m == mm)
                      for mm in TILE_NID_MS}
            cnv_ms = sum(v for (m, _, _), v in times.items() if m == TILE_CNV_IMAGES[-1])
            out[kernel].append({"entry": name, "tile": tile_label(tile), "max_abs_err": max_e,
                                "nid_ms": nid_ms, "cnv_ms": cnv_ms, "registers": [rmin, rmax],
                                "spill_bytes": spill})
            print(f"tiles: {name} {tile_label(tile)} (rows x columns x K step): {n_checked} "
                  f"checks equal to the plain version (ragged edges included), max_abs_err="
                  f"{max_e}; ptxas {rmin}-{rmax} registers, spill stores <= {spill} B; NID "
                  + "; ".join(f"M={mm}: " + " ".join(f"{times[(mm, n, k)]:.5f}"
                                                      for k, n, _, _ in nid_mlp.LAYERS)
                              + f" (sum {nid_ms[mm]:.5f})" for mm in TILE_NID_MS)
                  + f" ms; CNV dense M={TILE_CNV_IMAGES[-1]}: "
                  + " ".join(f"{times[(TILE_CNV_IMAGES[-1], n, k)]:.5f}" for n, k in cnv_dense)
                  + f" (sum {cnv_ms:.5f}) ms", flush=True)
        print(f"tiles: {name} gemv (M <= 8, no tile) at CNV dense M={TILE_CNV_IMAGES[0]}: "
              "equal to the plain version, ms "
              + " ".join(f"{gemv_ms[(m, n, k)]:.5f}" for m, n, k in sorted(gemv_ms)), flush=True)

    # 2. conv_mvu: each mode at each compiled pixel x channel tile
    cnv_convs = conv_shapes(cnv_bnn.FULL)
    for mode in C.MODES:
        cases = {}
        for h, c, n in cnv_convs:
            for b in TILE_CNV_IMAGES:
                x, w, _, _, _ = conv_case(mode, b, h, c, n, 3, g, dev)
                k = 9 * c
                thr = torch.sort(torch.randint(-8 * k, 8 * k, (n, 3), generator=g,
                                               dtype=torch.int32), dim=1).values.to(dev)
                cases[(b, h, c, n)] = (x, w, thr, C.conv_mvu_plain(x, w, thr, kernel=3,
                                                                   mode=mode))
        for tile in C.CONV_TILES:
            tm, tn = tile
            max_e, times, n_checked = 0.0, {}, 0
            for (b, h, c, n), (x, w, thr, want) in cases.items():
                rows = conv_rows(tm, h - 2)
                plan = C.conv_launch_plan(b, h, h, c, n, 3, block_n=tn, rows_per_tile=rows)
                check((plan.tile_m, plan.tile_n) == tile, f"tiles: conv_mvu at B={b} H={h} "
                      f"planned {plan.tile_m}x{plan.tile_n}, not {tile_label(tile)}")
                kw = dict(kernel=3, mode=mode, block_n=tn, rows_per_tile=rows)
                got = C.conv_mvu(x, w, thr, **kw)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"tiles: conv_mvu ({mode}) != its plain version at tile "
                      f"{tile_label(tile)} B={b} H=W={h} C={c} N={n}")
                max_e, n_checked = max(max_e, err(got, want)), n_checked + 1
                ms = device_ms(lambda: C.conv_mvu(x, w, thr, **kw), reps=10, trials=3,
                               sleep=TILE_SLEEP_CYCLES)
                times[(b, h, c, n)] = ms
                records.append({"kernel": "conv_mvu", "mode": mode, "tile": tile_label(tile),
                                "b": b, "h": h, "c": c, "n": n, "ms": ms})
            rmin, rmax, spill = instance_usage(ptxas, "conv_mvu_kernel",
                                               f"ConvTile<{tm},{tn}>", f">,{C.MODES.index(mode)},")
            sums = {b: sum(v for (bb, *_), v in times.items() if bb == b)
                    for b in TILE_CNV_IMAGES}
            out["conv_mvu"].append({"mode": mode, "tile": tile_label(tile), "max_abs_err": max_e,
                                    "cnv_ms": sums, "registers": [rmin, rmax],
                                    "spill_bytes": spill})
            print(f"tiles: conv_mvu {mode} {tile_label(tile)} (pixels x channels): {n_checked} "
                  f"checks equal to the plain version, max_abs_err={max_e}; ptxas {rmin}-{rmax} "
                  f"registers, spill stores <= {spill} B; "
                  + "; ".join(f"B={b}: " + " ".join(f"{times[(b, h, c, n)]:.5f}"
                                                    for h, c, n in cnv_convs)
                              + f" (sum {sums[b]:.5f})" for b in TILE_CNV_IMAGES) + " ms",
                  flush=True)

    # 3. the layers' tiles: folding-derived (untuned) and tuned, read from the plans
    for key, acc in sorted(path_accs.items()):
        batch = TUNE_NID_BATCH if key[0] != "cnv" else CNV_BATCH
        line = f"tiles: {' '.join(key)} untuned (the folding's tiles) at batch {batch}: " + \
            ", ".join(layer_tiles(acc, batch))
        if key in tuned:
            line += "; tuned: " + ", ".join(layer_tiles(tuned[key], batch))
        print(line, flush=True)

    # 4. one layer, two foldings: two tiles, read from the plan each launch
    # passes the card (the eager stream: a replay makes no wrapper call)
    gd = nid_mlp.load_golden()["standard"]
    x = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0]).to(dev)
    seen = {}
    lib_run = K.LIB.run
    for label, folds in (("table 6", nid_mlp.foldings()),
                         ("other", [Folding(*f) for f in NID_OTHER_FOLDING])):
        acc = build(nid_mlp.build_graph(gd["seed"]), target="engine", folding=folds,
                    device="cuda", **gd["build"])
        fc0 = next(n for n in acc.engine.graph if n.op == "mvu")
        mb = acc.plan(gd["batch"]).microbatch
        plan = dense_mvu.dense_launch_plan(
            mb, fc0.attrs["config"].out_features, fc0.attrs["config"].in_features, "int8",
            **ops.tile_kwargs("mvu_int", **fc0.attrs["config"].kernel_blocks()))
        launched = []  # (m, n, k, tile index) of each mvu_int launch, as the card got it

        def recording_run(fn, device, *args, launched=launched):
            m, n, k, tile = args[5], args[6], args[7], args[12]
            launched.append((m, n, k, tile))
            return lib_run(fn, device, *args)

        K.LIB.run = recording_run  # an instance attribute over the method, deleted below
        eng = acc.engine
        y = eng._stream(eng.params, x, acc.plan(gd["batch"]).n_micro)
        del K.LIB.run
        torch.cuda.synchronize()
        nk0 = (fc0.attrs["config"].out_features, fc0.attrs["config"].in_features)
        fc0_tiles = [t for m, n, k, t in launched if (n, k) == nk0]
        check(fc0_tiles and set(fc0_tiles) == {plan.tile}, f"tiles: NID {label} folding: fc0 "
              f"launched tiles {sorted(set(fc0_tiles))}, planned {plan.tile}")
        check(golden_mod.digest_like(gd, y.cpu().numpy(), acc.graph) == gd
              and torch.equal(acc(x), y),
              f"tiles: NID {label} folding: acc(x) differs from the golden digest")
        seen[label] = plan.tile
        fo = fc0.attrs["config"].folding
        all_tiles = sorted({tile_label(dense_mvu.DENSE_TILES[t]) if t >= 0 else "gemv"
                            for *_, t in launched})
        print(f"tiles: NID standard, {label} folding (fc0 PE={fo.pe} SIMD={fo.simd}): each of "
              f"fc0's {len(fc0_tiles)} launches at M={mb} passed the card tile {plan.tile} = "
              f"{tile_label(dense_mvu.DENSE_TILES[plan.tile])} (rows x columns x K step); all "
              f"{len(launched)} launches' tiles {all_tiles}; equals the golden digest",
              flush=True)
    check(seen["table 6"] != seen["other"], "tiles: two foldings of fc0 launched one tile")

    # 5. untuned (folding) and tuned acc(x) against the fixed 32 tile, in turns
    fixed = {"backend": "cuda", "block_n": 32, "block_k": 32, "block_kw": 32}
    for cfg_name, variant, batch, unit in (("nid", "standard", TUNE_NID_BATCH, "flows/s"),
                                           ("cnv", "standard", CNV_BATCH, "images/s")):
        untuned = path_accs[(cfg_name, variant)]
        cache = autotune.ScheduleCache({
            k: {**fixed, "block_m": n.attrs["config"].block_m}
            for k, n in zip(autotune.graph_node_keys(untuned.graph),
                            [n for n in untuned.graph if n.op in ("mvu", "conv_mvu")])})
        if cfg_name == "nid":
            gd = nid_mlp.load_golden()[variant]
            graph, extra = nid_mlp.build_graph(gd["seed"]), {"folding": nid_mlp.foldings()}
            xb = torch.from_numpy(nid.make_dataset(batch, seed=gd["data_seed"])[0]).to(dev)
        else:
            gd = cnv_bnn.load_golden()[variant]
            graph, extra = cnv_bnn.build_graph(cnv_bnn.spec_for(gd["build"]), seed=gd["seed"]), {}
            xb = torch.from_numpy(cnv_bnn.images(batch, gd["build"]["act_bits"],
                                                 gd["data_seed"])).to(dev)
        fixed_acc = build(graph, target="engine", tune="cache", cache=cache, device="cuda",
                          **extra, **gd["build"])
        check(fixed_acc.report.tune["cache_misses"] == 0,
              f"tiles: the fixed-32 {cfg_name} build missed entries: {fixed_acc.report.tune}")
        # the fixed 32 tile at the tuned plan's microbatch: the tuned arm's
        # gain over it is the tuned nodes' alone
        tuned_acc = tuned[(cfg_name, variant)]
        cache.put(autotune.engine_key(fixed_acc.engine.graph),
                  {"microbatch": tuned_acc.plan(batch).microbatch, "batch": batch})
        fixed_mb = FusedEngine(fixed_acc.graph, tune="cache", cache=cache, fuse=False)
        check((fixed_mb.plan(batch).n_micro, fixed_mb.plan(batch).microbatch)
              == (tuned_acc.plan(batch).n_micro, tuned_acc.plan(batch).microbatch),
              f"tiles: {cfg_name}: the fixed-32 engine at the tuned microbatch plans "
              f"{fixed_mb.plan(batch)}, the tuned build {tuned_acc.plan(batch)}")
        for arm in (fixed_acc, fixed_mb):
            check(torch.equal(arm(xb), untuned(xb)),
                  f"tiles: {cfg_name} {variant}: the fixed 32 tile's output differs")
        arms = {"fixed 32": fixed_acc, "folding": untuned, "fixed 32 at the tuned microbatch":
                fixed_mb, "tuned": tuned_acc}
        secs = {a: [] for a in arms}
        for arm in ("fixed 32", "folding", "fixed 32 at the tuned microbatch", "tuned", "tuned",
                    "fixed 32 at the tuned microbatch", "folding", "fixed 32"):
            secs[arm].append(acc_seconds(arms[arm], xb))
        print(f"tiles: {cfg_name} {variant} batch {batch}: "
              + "; ".join(f"{a} " + ", ".join(f"{batch / t:.1f}" for t in ts) + f" {unit}"
                          for a, ts in secs.items())
              + " (each the median of 7 acc(x), turns F U F' T T F' U F; fixed 32 = every "
              "layer pinned to the 32 x 32 x 32 tile by a cache entry, its tiles "
              f"{layer_tiles(fixed_acc, batch)}; {smi})", flush=True)
        # the tuned plan must not fall behind the fixed 32 tile at its own
        # microbatch beyond the turns' spread: the 32 tile is in every race
        mean = {a: sum(ts) / len(ts) for a, ts in secs.items()}
        spread = max((max(ts) - min(ts)) / min(ts) for ts in secs.values())
        ratio = mean["fixed 32 at the tuned microbatch"] / mean["tuned"]
        check(ratio >= 1 / (1 + spread),
              f"tiles: {cfg_name} {variant}: the tuned plan runs at {ratio:.4f}x of the fixed "
              f"32 tile at the tuned microbatch, below the turns' spread {spread:.4f}")
        print(f"tiles: {cfg_name} {variant}: tuned / fixed 32 at the tuned microbatch = "
              f"{ratio:.4f}x (mean times), turns' largest spread {spread:.4f}: met", flush=True)

    with open(os.path.join(TRACE_DIR, "tiles.json"), "w") as f:
        json.dump({"card": smi, "records": records, "by_kernel": out}, f)
    print(f"tiles: phase done in {time.perf_counter() - t_phase:.2f} s wall; every time in "
          "chiprun_out/tiles.json", flush=True)
    return out


def folding_tile(node, mb: int) -> tuple:
    """The tile a node's folding maps to at a microbatch of ``mb`` rows, from
    its PE and SIMD alone (``folding.to_gpu_blocks``' rule): dense, 32 rows x
    PE rounded up onto the compiled columns x SIMD rounded up onto its
    coding's K steps, or ``("gemv",)`` at M <= 8, which has no tile; conv,
    32 pixels x PE rounded up onto the compiled channels."""
    from repro_torch.kernels import _cuda, dense_mvu, ops, swu_mvu as C

    cfg = node.attrs["config"]
    fold = cfg.resolved_folding()
    if node.op == "conv_mvu":
        return (C.TILE_M, _cuda.round_up_to(fold.pe, C.CONV_TILE_NS))
    if mb <= dense_mvu.GEMV_MAX_M:
        return ("gemv",)
    coding = dense_mvu.CODING[ops.kernel_name(cfg.mode, cfg.packed)]
    return ("tiled", _cuda.BLOCK_M, _cuda.round_up_to(fold.pe, dense_mvu.TILE_NS),
            _cuda.round_up_to(fold.simd, dense_mvu.ksteps(coding)))


def explore_phase(dev, smi: str) -> None:
    """The explore phase (see the module doc): ``repro_torch.explore`` over
    the quick grid of the NID-MLP at 4096 flows and of the QUICK CNV at 256
    images, each point checked as the sweep measures it (its tiles against
    its folding's, at the plan and at each dense launch of its stream; NID:
    the golden digest), then the records' points, frontier, calibration and
    cache phase."""
    import torch

    from repro_torch.configs import golden as golden_mod, nid_mlp
    from repro_torch.data import nid
    from repro_torch.explore import ExploreConfig, explore, explorer
    from repro_torch.kernels import dense_mvu, ops, swu_mvu as C

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    golden = nid_mlp.load_golden()
    dense_libs = [lib for lib in ops.LIBRARIES if lib is not C.LIB]
    measure = explorer._measure_point
    for config, batch in EXPLORE_RUNS:
        seen = {}  # point id -> what the checks read of it
        layer_tiles_seen = {}  # dense node -> the tile indices its launches passed the card
        resident = []  # bytes allocated on the card as each point's measurement starts

        def checked_measure(acc, x, *, reps, config=config, batch=batch, seen=seen,
                            layer_tiles_seen=layer_tiles_seen, resident=resident):
            resident.append((torch.cuda.memory_allocated(dev), x.numel() * x.element_size()))
            measured = measure(acc, x, reps=reps)
            pid = acc.report.sweep["point_id"]
            plan = acc.plan(batch)
            tiles = node_tiles(acc, batch)
            for node, tile in tiles:
                want = folding_tile(node, plan.microbatch)
                got = tile[:1] if want == ("gemv",) else tile[1:] if node.op == "conv_mvu" \
                    else tile
                check(got == want and (node.op == "mvu" or tile[0] in C.ARRANGEMENTS),
                      f"explore: {config} {pid}: {node.name} plans tile {tile}, its folding "
                      f"{node.attrs['config'].resolved_folding()} maps to {want}")
            # each dense launch of the engine's stream, as the card got it
            launched = []  # (N, tile index) a launch

            def recording(lib_run):
                def run(fn, device, *args):
                    launched.append((args[6], args[12]))
                    return lib_run(fn, device, *args)
                return run

            for lib in dense_libs:
                lib.run = recording(lib.run)  # an instance attribute over the method
            eng = acc.engine
            y = eng._stream(eng.params, x, plan.n_micro)
            for lib in dense_libs:
                del lib.run
            dense = [node for node, _ in tiles if node.op == "mvu"]
            check(len(launched) == len(dense) * plan.n_micro,
                  f"explore: {config} {pid}: the stream made {len(launched)} dense launches, "
                  f"want {len(dense)} x n_micro={plan.n_micro}")
            for i, (n, index) in enumerate(launched):
                node = dense[i % len(dense)]
                want = folding_tile(node, plan.microbatch)
                want_index = -1 if want == ("gemv",) else dense_mvu.DENSE_TILES.index(want[1:])
                check(n == node.attrs["config"].out_features and index == want_index,
                      f"explore: {config} {pid}: {node.name} launched N={n} tile {index}, "
                      f"its folding's is {want_index}")
                layer_tiles_seen.setdefault(node.name, set()).add(index)
            check(torch.equal(y, acc(x)), f"explore: {config} {pid}: the replayed acc(x) "
                  "differs from the eager stream")
            variant = None
            if config == "nid_mlp":
                variant = "standard_packed" if acc.report.sweep["packed"] else "standard"
                gd = golden[variant]
                xg = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0])
                yg = acc(xg.to(dev))
                check(golden_mod.digest_like(gd, yg.cpu().numpy(), acc.graph) == gd,
                      f"explore: nid_mlp {pid}: acc(x) differs from the golden digest "
                      f"{variant}")
            seen[pid] = {"tiles": [f"{node.name}={tile[0]} {tile_label(tile[1:])}"
                                   for node, tile in tiles],
                         "microbatch": plan.microbatch, "n_micro": plan.n_micro,
                         "golden": variant}
            return measured

        explorer._measure_point = checked_measure
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rec = explore(ExploreConfig(config=config, quick=True, batch=batch,
                                    out_dir=EXPLORE_DIR))
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        explorer._measure_point = measure
        if config == "nid_mlp":
            check(golden["standard"]["seed"] == 0 and golden["standard"]["batch"] == batch,
                  "explore: the NID golden digests are not of seed 0 at this batch")
        check(rec["bit_exact"] and all(p["bit_exact"] for p in rec["points"])
              and set(seen) == {p["point_id"] for p in rec["points"]},
              f"explore: {config}: not every point measured and bit-exact")
        check(all(counts[k] > 0 for k in EXPLORE_KERNELS[config]),
              f"explore: {config}: launched {counts}, want each of {EXPLORE_KERNELS[config]}")
        n_nodes = len(rec["points"][0]["nodes"])
        cache = rec["cache"]
        check(cache["warm_hits"] == n_nodes and cache["warm_misses"] == 0,
              f"explore: {config}: the warm build hit {cache['warm_hits']} and missed "
              f"{cache['warm_misses']} of {n_nodes} nodes")
        first, x_bytes = resident[0]
        grown = max(r for r, _ in resident) - first
        check(grown < x_bytes, f"explore: {config}: the card held {grown} bytes more at a "
              f"later point than at the first, as much as an input of {x_bytes} bytes: a "
              "point's engine or graphs outlived it")
        distinct = {name: sorted(t) for name, t in layer_tiles_seen.items()}
        if config == "nid_mlp":
            check(any(len(t) > 1 for t in distinct.values()),
                  f"explore: the NID sweep launched one tile a layer: {distinct}")
        for p in rec["points"]:
            info = seen[p["point_id"]]
            node_us = ", ".join(f"{n['name']} {n['measured_s'] * batch * 1e6:.2f}"
                                for n in p["nodes"])
            print(f"explore: {config} {p['point_id']} foldings {p['foldings']}: tiles "
                  f"{', '.join(info['tiles'])}; microbatch {info['microbatch']} x "
                  f"n_micro={info['n_micro']}; {p['samples_per_s']:.1f} samples/s "
                  f"({p['engine_us']:.1f} us an acc(x) of {batch}); lut_bytes={p['lut_bytes']} "
                  f"ff_bytes={p['ff_bytes']} bram_bytes={p['bram_bytes']} "
                  f"weight_bytes={p['weight_bytes']} interval_cycles={p['interval_cycles']}; "
                  f"device us a launch at M={batch}: {node_us}; bit-exact"
                  + (f", equals the golden digest {info['golden']}" if info["golden"] else "")
                  + ("; on the frontier" if p["pareto"] else ""), flush=True)
        rates = [p["samples_per_s"] for p in rec["points"]]
        cal = rec["calibration"]
        print(f"explore: {config}: {rec['n_points']} points in {wall:.2f} s; frontier "
              f"{rec['pareto_front']} ({rec['packed_pareto_points']} packed); samples/s "
              f"{min(rates):.1f}-{max(rates):.1f} ({max(rates) / min(rates):.3f}x); tiles "
              f"launched a dense layer {distinct}; s_per_cycle={cal['s_per_cycle']:.6e} "
              f"(clock analog {cal['clock_mhz_analog']:.3f} MHz, {cal['samples']} node times "
              f"on the card's clock), model_error_p90={rec['model_error_p90']:.4f}, per node "
              + ", ".join(f"{k} p90 {v['p90_abs']:.4f}" for k, v in cal["per_node"].items())
              + f"; the card held at most {grown} bytes more than at the first point; "
              f"launches {counts}; record {os.path.relpath(rec['path'], HERE)} ({smi})",
              flush=True)
        print(f"explore: {config}: cache phase: cold tune=\"auto\" build "
              f"{cache['cold_wall_s']:.3f} s (tune step {cache['cold_tune_wall_s']:.3f} s, "
              f"{cache['cold_misses']} misses), warm tune=\"cache\" "
              f"{cache['warm_wall_s']:.3f} s (tune step {cache['warm_tune_wall_s']:.4f} s, "
              f"{cache['warm_hits']} hits, {cache['warm_misses']} misses), "
              f"{cache['cache_speedup']:.3f}x; {cache['entries']} entries ({smi})", flush=True)
    torch.cuda.synchronize()
    print(f"explore: phase done in {time.perf_counter() - t_phase:.2f} s wall; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB allocated "
          f"(torch.cuda.max_memory_allocated), {torch.cuda.memory_allocated(dev) / 2**20:.1f} "
          f"MiB after ({smi})", flush=True)


def stage_params(acc) -> list:
    """The MVUParams of each MVU stage of ``acc``'s engine, in chain order."""
    mvus = {n.name for n in acc.engine.graph if n.op == "mvu"}
    return [p for name, p in zip(acc.engine._names, acc.engine.params) if name in mvus]


def stage_layer_row(kernel: str, p, m: int, tile: dict, g, dev) -> tuple:
    """One pipeline layer's launch timed as the kernel phase times a layer:
    (kernel, plain, library, bound) ms and what bounds it, on the stage's
    own weights and thresholds at M = ``m`` rows of 2-bit activations; the
    float32 yardstick must equal the kernel."""
    import torch

    from repro_torch.kernels import mvu_binary as B, mvu_int as K

    fn, plain = ((K.mvu_int, K.mvu_int_plain) if kernel == "mvu_int"
                 else (B.mvu_binary, B.mvu_binary_plain))
    n, k = p.weights.shape
    a = torch.randint(0, 4, (m, k), generator=g, dtype=torch.int32).to(dev)
    w, t = p.weights, p.thresholds
    # binary weights are {0,1}-coded +/-1
    wf = w.float() if kernel == "mvu_int" else 2 * w.float() - 1
    af, tf = a.float(), t.float()

    def library():
        return (torch.matmul(af, wf.T)[:, :, None] >= tf[None]).sum(-1, dtype=torch.int32)

    check(torch.equal(library(), fn(a, w, t, **tile)),
          f"pipeline: the float32 yardstick disagrees with {kernel} at M={m} N={n} K={k}")
    kms = device_ms(lambda: fn(a, w, t, **tile), reps=100)
    pms = device_ms(lambda: plain(a, w, t), reps=10)
    lms = device_ms(library, reps=100)
    return (kms, pms, lms, *bound(m, n, k, t.numel() * 4))


def pipeline_phase(dev, smi: str) -> dict:
    """The pipeline phase (see the module doc): ``as_pipeline`` of the
    full-width chain in both modes at 1, 2, 4 and 8 stages and of the JAX
    package's test chain, held to ``acc(x)`` and the plain chain; the
    traced run; the float example.  Returns, by kernel, the counted runs'
    launches and a timing row for each launch."""
    import contextlib
    import importlib.util

    import numpy as np
    import torch

    from repro_torch.build import build
    from repro_torch.configs import mvu_chain
    from repro_torch.kernels import mvu_binary as B, mvu_int as K, ops
    from repro_torch.telemetry import Tracer

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(PIPE_SEED)
    launches: dict[str, int] = {}
    rows: dict[str, list] = {}

    def counted(run, xs, kernel: str, want_launches: int, what: str):
        """One run with every launch counter set to 0 just before it: the
        mode's kernel ``want_launches`` times and nothing else."""
        ops.reset_launch_counts()
        got = run(xs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts == {k: want_launches if k == kernel else 0 for k in counts},
              f"pipeline: {what} launched {counts}, want {kernel} {want_launches} times "
              "and nothing else")
        launches[kernel] = launches.get(kernel, 0) + want_launches
        return got

    cfg = mvu_chain.FULL
    full = {}  # mode -> (acc, xs, want)
    for mode in ("standard", "binary"):
        kernel = ops.kernel_name(mode)
        rng = np.random.default_rng(PIPE_SEED)
        t0 = time.perf_counter()
        acc = build(mvu_chain.build_graph(rng, cfg["d"], cfg["layers"], cfg["bits"]),
                    target="pipeline", mode=mode, weight_bits=PIPE_WEIGHT_BITS[mode],
                    act_bits=cfg["bits"], folding=mvu_chain.foldings(), device=dev)
        build_s = time.perf_counter() - t0
        x = torch.from_numpy(rng.integers(0, 2 ** cfg["bits"], (cfg["batch"], cfg["d"]))
                             .astype(np.int32)).to(dev)
        plan = acc.plan(cfg["batch"])
        check((plan.n_micro, plan.microbatch) == (cfg["batch"] // cfg["microbatch"],
                                                  cfg["microbatch"]),
              f"pipeline {mode}: acc.plan({cfg['batch']}) is {plan}, want microbatches of "
              f"{cfg['microbatch']}")
        want = acc(x)
        torch.cuda.synchronize()
        check(want.is_cuda and want.dtype == torch.int32 and tuple(want.shape) == tuple(x.shape)
              and int(want.min()) >= 0 and int(want.max()) < 2 ** cfg["bits"],
              f"pipeline {mode}: acc(x) is {want.dtype} {tuple(want.shape)}, want 2-bit levels")
        # the same chain layer by layer through the kernel's plain version
        plain = K.mvu_int_plain if kernel == "mvu_int" else B.mvu_binary_plain
        stages = stage_params(acc)
        h = x
        for p in stages:
            h = plain(h, p.weights, p.thresholds, p.out_scale)
        check(torch.equal(h, want), f"pipeline {mode}: acc(x) differs from the chain run "
              "layer by layer through the plain version")
        mvu0 = next(n for n in acc.engine.graph if n.op == "mvu")
        tile = ops.tile_kwargs(kernel, **mvu0.attrs["config"].kernel_blocks())
        print(f"pipeline: {mode} chain {cfg['layers']} x {cfg['d']}x{cfg['d']} "
              f"(PE {cfg['pe']} x SIMD {cfg['simd']}, {PIPE_WEIGHT_BITS[mode]}-bit weights, "
              f"{cfg['bits']}-bit activations) built in {build_s:.2f} s; {cfg['batch']} flows "
              f"in {plan.n_micro} microbatches of {plan.microbatch}; every stage launches "
              f"{kernel} {dense_plan_text(kernel, plan.microbatch, cfg['d'], cfg['d'], **tile)}; "
              "acc(x) equals the plain chain", flush=True)
        xs = x.reshape(plan.n_micro, plan.microbatch, cfg["d"])
        # one call as the card sees it, the host's enqueue included
        acc_ms = device_ms(lambda: acc(x), reps=1, trials=7, sleep=0)
        n_layer_calls = plan.n_micro * cfg["layers"]
        # the host's time for one stage layer call alone (no schedule, no
        # stream): what a run's 256 calls cost before streams and events
        layer_fn = ops.mvu_layer_fn(mode, **mvu0.attrs["config"].kernel_blocks())
        p0 = {"w": stages[0].weights, "t": stages[0].thresholds}
        host = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(n_layer_calls):
                layer_fn(p0, xs[0])
            host.append((time.perf_counter() - t0) / n_layer_calls * 1e6)
            torch.cuda.synchronize()
        layer_us = statistics.median(host)
        print(f"pipeline: {mode} one stage layer call (ops.mvu_layer_fn at M="
              f"{plan.microbatch}) holds the host {layer_us:.2f} us (perf_counter over "
              f"{n_layer_calls} calls, median of 7): {layer_us * n_layer_calls / 1e3:.4f} ms "
              "for a run's calls", flush=True)
        for n_stages in PIPE_STAGES:
            run = acc.as_pipeline([dev] * n_stages)
            got = counted(run, xs, kernel, n_layer_calls, f"{mode} S={n_stages}")
            check(got.is_cuda and got.dtype == want.dtype
                  and torch.equal(got.reshape(want.shape), want),
                  f"pipeline {mode} S={n_stages}: differs from acc(x)")
            # the same ticks on the caller's stream: what the stage streams cost
            one = run(xs, stage_streams=False)
            check(torch.equal(one.reshape(want.shape), want),
                  f"pipeline {mode} S={n_stages}: the one-stream run differs from acc(x)")
            ms = device_ms(lambda: run(xs), reps=1, trials=7, sleep=0)
            one_ms = device_ms(lambda: run(xs, stage_streams=False), reps=1, trials=7,
                               sleep=0)
            print(f"pipeline: {mode} S={n_stages}: equals acc(x) and the plain chain; "
                  f"{n_layer_calls} {kernel} launches a run, nothing else; {ms:.4f} ms a run "
                  f"on {n_stages} stage streams, {one_ms:.4f} ms on one stream (equal too), "
                  f"so streams and events cost {(ms - one_ms) / n_layer_calls * 1e3:.2f} us a "
                  f"layer call beside the call's own {layer_us:.2f} us (CUDA events, median of "
                  f"7 after a warm-up; replayed acc(x) "
                  f"{acc_ms:.4f} ms) ({smi})", flush=True)
        row = stage_layer_row(kernel, stages[0], plan.microbatch, tile, g, dev)
        rows.setdefault(kernel, []).extend([row] * (n_layer_calls * len(PIPE_STAGES)))
        print(f"pipeline: {mode} one stage layer at M={plan.microbatch}: ms={row[0]:.5f} "
              f"plain_ms={row[1]:.5f} library_ms={row[2]:.5f} bound_ms={row[3]:.6f} "
              f"({row[4]})", flush=True)
        full[mode] = (acc, xs, want, row)

    # the JAX package's pipeline test chain (tests/test_engine.py)
    small = mvu_chain.SMALL
    rng = np.random.default_rng(0)
    acc = build(mvu_chain.build_graph(rng, small["d"], small["layers"], small["bits"]),
                target="pipeline", mode="standard", weight_bits=4, act_bits=small["bits"],
                device=dev)
    xs = torch.from_numpy(rng.integers(0, 2 ** small["bits"], (
        small["n_micro"], small["microbatch"], small["d"])).astype(np.int32)).to(dev)
    want = acc(xs.reshape(-1, small["d"])).reshape(xs.shape)
    n_small = small["n_micro"] * small["layers"]
    for n_stages in (1, 2, 4):
        got = counted(acc.as_pipeline([dev] * n_stages), xs, "mvu_int", n_small,
                      f"small chain S={n_stages}")
        check(torch.equal(got, want), f"pipeline: the small chain at S={n_stages} differs "
              "from acc(x)")
    mvu0 = next(n for n in acc.engine.graph if n.op == "mvu")
    row = stage_layer_row("mvu_int", stage_params(acc)[0], small["microbatch"],
                          ops.tile_kwargs("mvu_int", **mvu0.attrs["config"].kernel_blocks()),
                          g, dev)
    rows["mvu_int"].extend([row] * (n_small * 3))
    print(f"pipeline: the JAX test's chain ({small['layers']} x {small['d']}, "
          f"{small['bits']} bits, {small['n_micro']} x {small['microbatch']}) at S = 1, 2, 4 "
          f"equals acc(x); {n_small} mvu_int launches a run", flush=True)

    # one traced run at four stages: its span, lanes and occupancy
    acc, xs, want, row = full["standard"]
    n_micro = int(xs.shape[0])
    tr = Tracer()
    got = counted(acc.as_pipeline([dev] * 4, tracer=tr), xs, "mvu_int",
                  n_micro * cfg["layers"], "the traced S=4 run")
    check(torch.equal(got.reshape(want.shape), want), "pipeline: the traced run differs "
          "from acc(x)")
    rows["mvu_int"].extend([row] * (n_micro * cfg["layers"]))
    runs = tr.spans(name="pipeline.run")
    lanes = {sp["tid"] for sp in tr.spans(cat="pipeline") if isinstance(sp["tid"], str)}
    occ = runs[0]["args"].get("occupancy") if len(runs) == 1 else None
    check(len(runs) == 1 and lanes == {f"stage{s}" for s in range(4)}
          and occ is not None and abs(occ - n_micro / (n_micro + 3)) < 1e-12,
          f"pipeline: the traced run has {len(runs)} pipeline.run spans, lanes "
          f"{sorted(lanes)}, occupancy {occ}; want 1, stage0-stage3, {n_micro}/{n_micro + 3}")
    print(f"pipeline: traced S=4: one pipeline.run span of {runs[0]['dur'] * 1e3:.3f} ms "
          f"(host clock, every stage synchronised), lanes {sorted(lanes)}, occupancy "
          f"{occ:.6f} = {n_micro}/{n_micro + 3}, bubble ticks "
          f"{runs[0]['args']['bubble_ticks']}", flush=True)
    # the profiler reads only this run's schedule; no gate rests on its events
    TRACES.append("pipeline standard S=4")
    run4 = acc.as_pipeline([dev] * 4)
    r = trace_acc(run4, xs, "pipeline_standard_s4")
    print(f"trace: pipeline standard S=4: window {r['window_us'] / 1e3:.3f} ms in the trace; "
          f"device busy {r['busy_us'] / 1e3:.4f} ms ({r['device_events']} device events on "
          f"{len(r['kernel_streams'])} streams, kernels summed {r['kernel_sum_us'] / 1e3:.4f} "
          f"ms: {max(0.0, r['kernel_sum_us'] - r['busy_us']) / 1e3:.4f} ms of overlap at "
          f"most); idle share {r['idle_share'] * 100:.2f}%; host split: torch ops "
          f"{r['torch_ops_us'] / 1e3:.3f} ms, CUDA runtime {r['runtime_us'] / 1e3:.3f} ms, "
          f"Python {r['python_us'] / 1e3:.3f} ms; hand-kernel events "
          f"{ {k: v for k, v in r['seen'].items() if v} } against the counters "
          f"{ {k: v for k, v in r['counts'].items() if v} } (not a gate)", flush=True)

    # the float example: forward and gradients through the stage streams
    spec = importlib.util.spec_from_file_location(
        "torch_dataflow_pipeline", os.path.join(HERE, "examples", "torch_dataflow_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.devnull, "w") as f, contextlib.redirect_stdout(f):
        ex = mod.main(device=str(dev))
    check(ex["forward_err"] < 1e-5 and ex["grad_err"] < 1e-4,
          f"pipeline: the float example's errors {ex}")
    print(f"pipeline: float example (8 tanh layers of 64, 8 x 4, {ex['stages']} stage "
          f"streams): forward max err {ex['forward_err']:.3e} (< 1e-5), gradients "
          f"{ex['grad_err']:.3e} (< 1e-4) against sequential_reference", flush=True)
    print(f"pipeline: launches of the counted runs {launches}; phase "
          f"{time.perf_counter() - t_phase:.2f} s ({smi})", flush=True)
    return {"launches": launches, "rows": rows}


def counted(fn, want: dict, what: str):
    """``fn()`` with every launch counter set to 0 just before it: the
    kernels of ``want`` that many times and nothing else."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts == {k: want.get(k, 0) for k in counts},
          f"{what} launched {counts}, want {want or 'no kernel'} and nothing else")
    return out


def deployed_projections(layer0: dict) -> dict:
    """A layer's integer-deployed projections by name: the seven of a dense
    block, the four attention projections of a MoE block (its experts and
    router stay float)."""
    from repro_torch.models.layers import PROJ_NAMES

    nodes = layer0["attn"] | layer0.get("ffn", {})
    return {name: nodes[name] for name in PROJ_NAMES if "values" in nodes.get(name, {})}


def projection_rows(layer0: dict, kernel: str, ms, g, tag: str) -> dict:
    """A deployed layer's projections (:func:`deployed_projections`) through
    ``kernel``'s wrapper (``mvu_int`` or ``mvu_binary``) at the blocks
    ``quantized_linear`` passes, at each M of ``ms``: equal to the plain
    version (raw int32 accumulators, then the scale epilogue), each launch
    shape timed as the kernel phase times a layer (its plan printed).
    Returns (kernel, m, n, k) -> (ms, plain_ms, library_ms, bound_ms,
    bound_by)."""
    import torch

    from repro_torch.core.mvu import LINEAR_BLOCKS as blocks
    from repro_torch.kernels import ops, packing

    mode = {"mvu_int": "standard", "mvu_binary": "binary"}[kernel]
    nodes = deployed_projections(layer0)
    timed = {}
    for name, node in nodes.items():
        w = node["values"]
        dev = w.device
        if mode == "binary":
            w = packing.bipolar_to_bits(w).to(torch.int8)
        n, k = w.shape
        s = node["scale"].to(torch.float32)
        for m in sorted(ms):
            a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            for epi in (None, s):
                got = ops.mvu(a, w, mode, out_scale=epi, backend="cuda", **blocks)
                want = ops.mvu(a, w, mode, out_scale=epi, backend="torch")
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"{tag}: {kernel} differs from its plain version on layer 0's {name} at "
                      f"M={m} N={n} K={k} (scale={epi is not None})")
            af = a.float()
            wf = w.float() if mode == "standard" else 2 * w.float() - 1

            def library(af=af, wf=wf, s=s):
                return torch.matmul(af, wf.T) * s

            row = (device_ms(lambda: ops.mvu(a, w, mode, out_scale=s, backend="cuda",
                                             **blocks), reps=20),
                   device_ms(lambda: ops.mvu(a, w, mode, out_scale=s, backend="torch"),
                             reps=1, trials=3),
                   device_ms(library, reps=20), *bound(m, n, k, n * 4, a_bytes=1))
            timed[(kernel, m, n, k)] = row
            print(f"{tag}: {kernel} layer 0 {name} M={m} N={n} K={k}: equals the plain "
                  f"version (raw and scaled); ms={row[0]:.5f} plain_ms={row[1]:.5f} "
                  f"library_ms={row[2]:.5f} bound_ms={row[3]:.6f} ({row[4]}) "
                  f"{dense_plan_text(kernel, m, n, k, **ops.tile_kwargs(kernel, **blocks))}",
                  flush=True)
    return timed


def lm_phase(dev, smi: str) -> dict:
    """The lm phase (see the module doc): the reduced Yi-9B against the JAX
    package's golden run, full-width Yi-9B served by ``serve_loop`` on
    ``mvu_int`` with its launches counted, layer 0's projections against
    the plain versions, a 4-layer binary prefill on ``mvu_binary``, and the
    serving times.  Returns, by kernel, the counted runs' launches and a
    timing row for each launch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.launch.serve import Request, prompt_batch, serve_loop
    from repro_torch.models import layers as L, transformer as tf
    from repro_torch.models.model import build

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # (a) the reduced model, float32, against the JAX package's golden run
    golden = G.load_golden()
    for backend in G.VARIANTS:
        cfg = G.golden_config(backend)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        if backend != "dense":
            params = L.quantize_model_params(params, backend)
        want = {} if backend == "dense" else {
            "mvu_int": len(L.PROJ_NAMES) * cfg.num_layers * (1 + G.DECODE_STEPS)}
        model = build(cfg, device=dev)
        got = counted(lambda: G.greedy_run(model, params), want,
                      f"lm: the golden run ({backend})")
        bad = G.mismatch(golden["variants"][backend], got)
        check(bad is None, f"lm: the reduced {backend} model on the card differs from the JAX "
              f"package's golden run: {bad}")
        ref = np.asarray(golden["variants"][backend]["logits"], np.float32)
        print(f"lm: golden: reduced {cfg.name} {backend} float32 on the card, prefill of "
              f"{G.BATCH} x {G.PROMPT_LEN} + {G.DECODE_STEPS} greedy steps: max |logit error| "
              f"{float(np.abs(got['logits'] - ref).max()):.3e} (bound {G.LOGIT_ATOL} x "
              f"{float(np.abs(ref).max()):.4f}), greedy tokens equal the JAX package's "
              f"{got['tokens'].tolist()}; launches {want or 'none'}", flush=True)

    # (b) full-width Yi-9B, integer-deployed, served by serve_loop
    cfg = get_config(LM_ARCH).replace(linear_backend=LM_BACKEND)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    params = model.init(g, quantize=LM_BACKEND)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    proj = {name: blk[name] for blk in (params["layers"]["attn"], params["layers"]["ffn"])
            for name in L.PROJ_NAMES if name in blk}
    check(len(proj) == len(L.PROJ_NAMES) and all(
        set(p) == {"values", "scale"} and p["values"].dtype == torch.int8
        and p["values"].shape[0] == cfg.num_layers for p in proj.values()),
        "lm: a full-width projection is not integer-deployed int8 on every layer")
    proj_bytes = sum(p["values"].numel() for p in proj.values())
    print(f"lm: full width: {cfg.name} ({cfg.num_layers} layers x {cfg.d_model}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}) drawn on the card from seed {LM_SEED} and "
          f"quantized to {LM_BACKEND} layer by layer in {init_s:.2f} s: "
          f"{proj_bytes / 1e9:.3f} GB of int8 projections, peak "
          f"{init_peak / 1e9:.2f} GB allocated", flush=True)
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(i, p, LM_MAX_NEW) for i, p in enumerate(prompts)]

    groups = [requests()[i:i + LM_BATCH] for i in range(0, LM_REQUESTS, LM_BATCH)]
    group_tokens = [prompt_batch(grp) for grp in groups]
    per_group = len(L.PROJ_NAMES) * cfg.num_layers * (1 + LM_MAX_NEW)
    t0 = time.perf_counter()
    done = counted(lambda: serve_loop(model, params, requests(), batch=LM_BATCH,
                                      max_len=LM_MAX_LEN),
                   {"mvu_int": per_group * len(groups)}, "lm: serve_loop at full width")
    serve_s = time.perf_counter() - t0
    check([r.rid for r in done] == list(range(LM_REQUESTS))
          and all(len(r.out) == LM_MAX_NEW and all(0 <= t < cfg.vocab_size for t in r.out)
                  for r in done),
          "lm: serve_loop did not answer every request with its tokens in the vocabulary")
    print(f"lm: serve_loop: {LM_REQUESTS} requests (prompts {lens.tolist()} tokens) in "
          f"{len(groups)} groups of {LM_BATCH}, max_new {LM_MAX_NEW}, max_len {LM_MAX_LEN}: "
          f"every request answered; mvu_int launched {per_group * len(groups)} times = "
          f"{len(L.PROJ_NAMES)} projections x {cfg.num_layers} layers x (1 prefill + "
          f"{LM_MAX_NEW} decode steps) x {len(groups)} groups, nothing else; "
          f"{LM_REQUESTS * LM_MAX_NEW / serve_s:.2f} tokens/s over the loop's "
          f"{serve_s:.3f} s (host clock, the first run: no warm-up); first tokens "
          f"{[r.out[:4] for r in done[:2]]}", flush=True)

    # (e) serving times on the host clock, synchronised: group 0's prefill,
    # then its decode steps
    toks0 = torch.from_numpy(group_tokens[0])
    pre, dec = [], []
    for _ in range(3):
        state = model.init_decode_state(LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": toks0}, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(LM_MAX_NEW):
            logits, state = model.decode_step(params, state, torch.argmax(logits, -1))
        torch.cuda.synchronize()
        pre.append(t1 - t0)
        dec.append((time.perf_counter() - t1) / LM_MAX_NEW)
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (LM_BATCH,
                                                                          cfg.vocab_size),
          f"lm: full-width logits {tuple(logits.shape)} not finite")
    pre_ms, dec_ms = statistics.median(pre) * 1e3, statistics.median(dec) * 1e3
    print(f"lm: full width {LM_BACKEND}, group 0 ({LM_BATCH} x {toks0.shape[1]} tokens): "
          f"prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms a step ({LM_BATCH} tokens), "
          f"{LM_BATCH / dec_ms * 1e3:.2f} decode tokens/s, "
          f"{LM_BATCH * toks0.shape[1] / pre_ms * 1e3:.1f} prefill tokens/s (host clock, "
          f"synchronised, median of 3 after the served run); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated ({smi})", flush=True)

    # (d) the full-width model under mvu_binary at reduced depth: one prefill
    bcfg = cfg.replace(num_layers=LM_BINARY_LAYERS, linear_backend="mvu_binary")
    bmodel = build(bcfg, device=dev)
    bparams = bmodel.init(g, quantize="mvu_binary")
    n_bin = len(L.PROJ_NAMES) * LM_BINARY_LAYERS
    blogits, _ = counted(lambda: bmodel.prefill(bparams, {"tokens": toks0},
                                                bmodel.init_decode_state(LM_BATCH, LM_MAX_LEN)),
                         {"mvu_binary": n_bin}, "lm: the binary prefill")
    check(bool(torch.isfinite(blogits).all()) and tuple(blogits.shape) == (LM_BATCH,
                                                                           cfg.vocab_size),
          f"lm: the binary prefill's logits {tuple(blogits.shape)} are not finite")
    print(f"lm: binary: full-width {cfg.name} at {LM_BINARY_LAYERS} layers under mvu_binary, "
          f"prefill of {LM_BATCH} x {toks0.shape[1]}: finite logits; mvu_binary launched "
          f"{n_bin} times, nothing else", flush=True)

    # (c) layer 0's seven projections at full width against the plain
    # versions at the decode rows and at group 0's prefill rows, each
    # launch shape timed
    ga = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    m_pre = [LM_BATCH * t.shape[1] for t in group_tokens]
    timed = projection_rows(tf.layer(params["layers"], 0), "mvu_int", {LM_BATCH, *m_pre}, ga,
                            "lm")
    timed |= projection_rows(tf.layer(bparams["layers"], 0), "mvu_binary", {m_pre[0]}, ga, "lm")
    layer0 = tf.layer(params["layers"], 0)
    shapes = {name: tuple((layer0["attn"] | layer0["ffn"])[name]["values"].shape)
              for name in L.PROJ_NAMES}
    # a timing row per counted launch: each group's prefill and decode steps,
    # then the binary prefill
    rows = {"mvu_int": [], "mvu_binary": []}
    for m in m_pre:
        for mm, reps in ((m, 1), (LM_BATCH, LM_MAX_NEW)):
            rows["mvu_int"] += [timed[("mvu_int", mm, n, k)] for n, k in shapes.values()] * (
                cfg.num_layers * reps)
    rows["mvu_binary"] = [timed[("mvu_binary", m_pre[0], n, k)]
                          for n, k in shapes.values()] * LM_BINARY_LAYERS
    launches = {"mvu_int": per_group * len(groups), "mvu_binary": n_bin}
    check(all(len(rows[k]) == launches[k] for k in launches), "lm: a row for every launch")
    print(f"lm: launches of the counted runs {launches}; kernel ms over them "
          f"{ {k: round(sum(r[0] for r in v), 4) for k, v in rows.items()} }; phase "
          f"{time.perf_counter() - t_phase:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated ({smi})", flush=True)
    return {"launches": launches, "rows": rows}


def lm_qat_phase(dev, smi: str) -> dict:
    """The lm_qat phase (see the module doc): the reduced Yi-9B's QAT loss
    and gradients against the JAX package's golden, full-width Yi-9B's
    forward and backward under each ``mvu_*`` backend, and its weights
    deployed and prefilled on ``mvu_int`` / ``mvu_binary``.  Returns, by
    kernel, the counted prefills' launches and a timing row for each."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.core.quantize import weight_grid
    from repro_torch.models import layers as L, transformer as tf
    from repro_torch.models.model import build
    from repro_torch.tree import flat_leaves

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "lm_qat: float32 matmuls must not run in TF32 (PyTorch's default is off)")

    # (a) the reduced model, float32, against the JAX package's QAT golden
    golden = G.load_qat_golden()
    for backend in G.QAT_VARIANTS:
        cfg = G.qat_config(backend)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        model = build(cfg, device=dev)
        got = counted(lambda: G.qat_run(model, params), {},
                      f"lm_qat: the QAT golden's loss and backward ({backend})")
        want = golden["variants"][backend]
        bad = G.qat_mismatch(want, got)
        check(bad is None, f"lm_qat: the reduced {backend} model's loss and gradients on the "
              f"card differ from the JAX package's: {bad}")
        wg = want["grads"]
        worst = max(float(np.abs(np.subtract(g["head"], wg[p]["head"])).max())
                    / wg[p]["max_abs"] for p, g in got["grads"].items())
        worst_dot = max(float(np.abs(np.subtract(g["dot"], wg[p]["dot"])).max())
                        / np.sqrt(wg[p]["size"] / len(wg[p]["dot"])) / wg[p]["max_abs"]
                        for p, g in got["grads"].items())
        print(f"lm_qat: golden: reduced {cfg.name} {backend} float32, remat on, on the card: "
              f"loss {got['loss']:.7f} (JAX {want['loss']:.7f}, |error| "
              f"{abs(got['loss'] - want['loss']):.3e}, bound {G.LOSS_RTOL} x |loss|); "
              f"{len(got['grads'])} gradient leaves within the bounds, a layer at a time; "
              f"worst head error {worst:.3e} and worst probe-product error {worst_dot:.3e} "
              f"(over sqrt(row size)) of the leaf's largest (bound {G.GRAD_ATOL}); no kernel "
              f"launched", flush=True)

    # (b) full-width Yi-9B, float bf16, remat on: loss and every gradient
    cfg = get_config(LM_ARCH)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = build(cfg, device=dev).init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    n_params = sum(t.numel() for t in leaves.values())
    tokens = np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (LM_QAT_BATCH, LM_QAT_SEQ + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    print(f"lm_qat: full width: {cfg.name} ({cfg.num_layers} layers x {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}) float params "
          f"drawn on the card from seed {LM_SEED} in {init_s:.2f} s: {n_params:,} parameters, "
          f"{sum(t.numel() * t.element_size() for t in leaves.values()) / 1e9:.3f} GB; batch "
          f"{LM_QAT_BATCH} x {LM_QAT_SEQ + 1} tokens", flush=True)
    rows = {"mvu_int": [], "mvu_binary": []}
    launches = {"mvu_int": 0, "mvu_binary": 0}
    ga = torch.Generator(device=dev).manual_seed(LM_SEED + 2)
    for backend, kernel in LM_QAT_KERNELS.items():
        model = build(cfg.replace(linear_backend=backend), device=dev)

        def step(after_forward=None):
            loss, _ = model.loss(params, batch)
            if after_forward is not None:  # (allocated, peak) once the forward is done
                after_forward += [torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()]
            return loss, torch.autograd.grad(loss, list(leaves.values()))

        torch.cuda.reset_peak_memory_stats()
        fwd_mem = []
        loss, grads = counted(lambda: step(fwd_mem), {},
                              f"lm_qat: the full-width {backend} forward and backward")
        finite = torch.stack([torch.isfinite(gr).all() for gr in grads]).all()
        check(bool(torch.isfinite(loss)) and bool(finite)
              and all(gr.shape == t.shape and gr.dtype == t.dtype
                      for gr, t in zip(grads, leaves.values())),
              f"lm_qat: full-width {backend}: the loss or a gradient is not finite, or a "
              f"gradient has not its parameter's shape and dtype")
        loss0 = loss.item()
        del loss, grads
        times = []
        for _ in range(LM_QAT_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del loss, grads
        peak = torch.cuda.max_memory_allocated()
        print(f"lm_qat: full width {backend} (fake-quant STE on every projection, remat on), "
              f"{LM_QAT_BATCH} x {LM_QAT_SEQ} predicted tokens: loss {loss0:.6f}, finite; "
              f"{len(leaves)} gradient leaves finite, each of its parameter's shape and dtype; "
              f"no kernel launched; forward + backward "
              f"{', '.join(f'{t:.3f}' for t in times)} ms, median {statistics.median(times):.3f} "
              f"ms (host clock, synchronised, {LM_QAT_CALLS} calls after the checked one); "
              f"{LM_QAT_BATCH * LM_QAT_SEQ / statistics.median(times) * 1e3:.1f} tokens/s; "
              f"after the forward {fwd_mem[0] / 1e9:.2f} GB allocated (peak so far "
              f"{fwd_mem[1] / 1e9:.2f}), peak {peak / 1e9:.2f} GB allocated ({smi})",
              flush=True)

        # (c) the same weights deployed, the same 128 tokens prefilled on the kernel
        bits = L.MVU_BACKENDS[backend][0]
        prompt = {"tokens": batch["tokens"][:, :LM_QAT_SEQ]}
        with torch.no_grad():
            fake, _ = model.prefill(params, prompt,
                                    model.init_decode_state(LM_QAT_BATCH, LM_QAT_SEQ))
            t0 = time.perf_counter()
            deployed = L.quantize_model_params(params, backend)
            torch.cuda.synchronize()
            deploy_s = time.perf_counter() - t0
            n_pre = len(L.PROJ_NAMES) * cfg.num_layers
            logits, _ = counted(
                lambda: model.prefill(deployed, prompt,
                                      model.init_decode_state(LM_QAT_BATCH, LM_QAT_SEQ)),
                {kernel: n_pre}, f"lm_qat: the deployed {backend} prefill")
            check(bool(torch.isfinite(logits).all())
                  and tuple(logits.shape) == (LM_QAT_BATCH, cfg.vocab_size),
                  f"lm_qat: the deployed {backend} prefill's logits are not finite")
            corr = float(np.corrcoef(fake.float().cpu().numpy().ravel(),
                                     logits.float().cpu().numpy().ravel())[0, 1])
            float0, int0 = tf.layer(params["layers"], 0), tf.layer(deployed["layers"], 0)
            same = total = 0
            for name in L.PROJ_NAMES:
                blk = "attn" if name in float0["attn"] else "ffn"
                grid, _ = weight_grid(float0[blk][name]["w"], bits, axis=1)
                same += int((grid.T.to(torch.int8) == int0[blk][name]["values"]).sum())
                total += grid.numel()
        print(f"lm_qat: deployed {backend}: quantize_model_params of the same weights in "
              f"{deploy_s:.2f} s, prefill of {LM_QAT_BATCH} x {LM_QAT_SEQ} on {kernel}: finite "
              f"logits; {kernel} launched {n_pre} times = {len(L.PROJ_NAMES)} projections x "
              f"{cfg.num_layers} layers, nothing else; finding: last-token logit correlation "
              f"against the fake-quant prefill {corr:.6f}; layer 0's fake-quant grid (bf16) "
              f"equals the deployed values (quantized from float32) at {same / total:.6f} of "
              f"its {total:,} weights", flush=True)
        m = LM_QAT_BATCH * LM_QAT_SEQ
        timed = projection_rows(int0, kernel, {m}, ga, "lm_qat")
        rows[kernel] += [timed[(kernel, m, *(int0["attn"] | int0["ffn"])[name]["values"].shape)]
                         for name in L.PROJ_NAMES] * cfg.num_layers
        launches[kernel] += n_pre
        del deployed, int0, fake, logits
    check(all(len(rows[k]) == launches[k] for k in launches), "lm_qat: a row for every launch")
    print(f"lm_qat: launches of the counted prefills {launches}; kernel ms over them "
          f"{ {k: round(sum(r[0] for r in v), 4) for k, v in rows.items()} }; phase "
          f"{time.perf_counter() - t_phase:.2f} s ({smi})", flush=True)
    return {"launches": launches, "rows": rows}


def dense_param_count(cfg) -> int:
    """Parameters of a dense decoder of ``cfg`` (untied, RMSNorm, gated
    FFN: the Yi-9B layout), from its widths alone."""
    d, hd = cfg.d_model, cfg.head_dim
    layer = (2 * d + d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
             + 3 * d * cfg.d_ff)
    return 2 * cfg.vocab_size * d + d + cfg.num_layers * layer


def host_bytes_available() -> int:
    """MemAvailable of the host (``/proc/meminfo``), in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (NaN, -0 included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}.get(a.element_size())
    if a.is_floating_point() and view is not None:
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def train_phase(dev, smi: str) -> dict:
    """The train phase (see the module doc): the reduced Yi-9B's AdamW
    steps against the JAX package's golden, full-width Yi-9B at a cut depth
    trained by ``make_train_step`` with a ``StepWatchdog`` and a
    ``CheckpointManager``, crashed and resumed from its checkpoint, then
    its trained weights deployed and prefilled on ``mvu_int``.  Returns,
    by kernel, the counted prefill's launches and a timing row for each."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.fault_tolerance import CheckpointManager, StepWatchdog
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import layers as L, transformer as tf
    from repro_torch.models.model import build
    from repro_torch.optim import adamw
    from repro_torch.tree import flat_leaves, tree_map

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train: float32 matmuls must not run in TF32 (PyTorch's default is off)")

    # (a) the reduced model, float32, against the JAX package's train golden
    golden = G.load_train_golden()
    for backend in G.TRAIN_VARIANTS:
        cfg = G.golden_config(backend)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        model = build(cfg, device=dev)
        got = counted(lambda: G.train_run(model, params), {},
                      f"train: the train golden's steps ({backend})")
        want = golden["variants"][backend]
        bad = G.train_mismatch(want, got)
        check(bad is None, f"train: the reduced {backend} model's AdamW steps on the card "
              f"differ from the JAX package's: {bad}")
        rel = {k: max(abs(g - w) / abs(w) for g, w in zip(got[k], want[k]))
               for k in G.TRAIN_METRICS}
        worst = {t: max(float(np.abs(np.subtract(g["head"], want[t][p]["head"])).max())
                        / want[t][p]["max_abs"] for p, g in got[t].items())
                 for t in ("params", "mu", "nu")}
        print(f"train: golden: reduced {cfg.name} {backend} float32, {G.TRAIN_STEPS} steps of "
              f"make_train_step (AdamW {G.TRAIN_OPT}) on SyntheticLM{G.TRAIN_DATA} batches, on "
              f"the card: losses {[round(x, 7) for x in got['loss']]} (JAX "
              f"{[round(x, 7) for x in want['loss']]}); largest relative error "
              f"{ {k: float(f'{v:.3e}') for k, v in rel.items()} } (bounds loss "
              f"{G.TRAIN_LOSS_RTOL} + {G.TRAIN_LOSS_ATOL}, grad_norm {G.TRAIN_GNORM_RTOL}, lr "
              f"{G.TRAIN_LR_RTOL}); worst head error over the leaf's largest "
              f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (bound {G.TRAIN_ATOL}); "
              f"no kernel launched", flush=True)

    # (b) full-width Yi-9B at a cut depth, W8A8 QAT, trained, checkpointed,
    # crashed after step 8 (before its save) and resumed from step 4
    full = get_config(LM_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        free_disk, free_host = shutil.disk_usage(tmp).free, host_bytes_available()
        for layers in TRAIN_LAYERS:
            cfg = full.replace(num_layers=layers, linear_backend=TRAIN_BACKEND)
            ckpt_need = TRAIN_CKPT_BYTES_PER_PARAM * dense_param_count(cfg)
            if free_disk >= 1.25 * ckpt_need and free_host >= 1.5 * ckpt_need:
                break
        check(free_disk >= 1.25 * ckpt_need and free_host >= 1.5 * ckpt_need,
              f"train: {tmp} has {free_disk / 1e9:.1f} GB free and the host "
              f"{free_host / 1e9:.1f} GB available, too little for one checkpoint of "
              f"{ckpt_need / 1e9:.1f} GB even at {cfg.num_layers} layers")
        print(f"train: reduced: depth {full.num_layers} -> {cfg.num_layers} layers, widths as "
              f"published; at {full.num_layers} layers ({dense_param_count(full) / 1e9:.2f} B "
              f"parameters) bf16 params and gradients and float32 mu / nu take 12 B a "
              f"parameter, {12 * dense_param_count(full) / 1e9:.0f} GB, more than the 80 GB "
              f"card; a checkpoint is held in host memory and written at "
              f"{TRAIN_CKPT_BYTES_PER_PARAM} B a parameter, {ckpt_need / 1e9:.2f} GB at "
              f"{cfg.num_layers} layers (temp disk {free_disk / 1e9:.1f} GB free, host "
              f"{free_host / 1e9:.1f} GB available"
              + ("" if cfg.num_layers == TRAIN_LAYERS[0] else
                 f"; too little for {TRAIN_LAYERS[0]} layers, so cut to {cfg.num_layers}")
              + ")", flush=True)

        model = build(cfg, device=dev)
        g = torch.Generator(device=dev).manual_seed(LM_SEED)
        params = model.init(g)
        n_params = sum(t.numel() for t in flat_leaves(params).values())
        check(n_params == dense_param_count(cfg),
              f"train: {n_params} parameters, want {dense_param_count(cfg)}")
        data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        batches = [{"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
                   for _ in range(TRAIN_STEPS)]
        data.close()
        step_fn = make_train_step(model, G.train_opt_config())
        opt = adamw.init(params)
        wd = StepWatchdog()
        mgr = CheckpointManager(tmp, every=TRAIN_CKPT_EVERY, keep=1, use_async=True)
        hist = {"loss": [], "grad_norm": [], "lr": [], "ms": []}
        saved, save_call_s, peak_steps = None, 0.0, 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, batch in enumerate(batches, 1):
            t0 = time.perf_counter()
            with wd:
                params, opt, metrics = step_fn(params, opt, batch)
                loss = metrics["loss"].item()  # the host sync that ends the step
            hist["ms"].append((time.perf_counter() - t0) * 1e3)
            hist["loss"].append(loss)
            hist["grad_norm"].append(metrics["grad_norm"].item())
            hist["lr"].append(metrics["lr"].item())
            if i == TRAIN_CKPT_EVERY:
                peak_steps = torch.cuda.max_memory_allocated()
                # the step is functional: these tensors stay as step 4 left them
                saved = {"params": params, "opt": opt}
            if i < TRAIN_STEPS:  # the run dies after step 8, before its save
                t0, wall0 = time.perf_counter(), time.time()
                if mgr.maybe_save(i, {"params": params, "opt": opt}):
                    save_call_s, save_wall0 = time.perf_counter() - t0, wall0
        mgr.wait()
        finite = all(np.isfinite(v) for k in ("loss", "grad_norm", "lr") for v in hist[k])
        check(finite and saved is not None,
              f"train: full width: a loss, grad_norm or lr is not finite: {hist}")
        step_dir = os.path.join(tmp, f"step_{TRAIN_CKPT_EVERY:08d}")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            written_s = json.load(f)["time"] - save_wall0
        ckpt_bytes = os.path.getsize(os.path.join(step_dir, "arrays.npz"))
        med = statistics.median(hist["ms"])
        print(f"train: full width: {cfg.name} at {cfg.num_layers} layers x {cfg.d_model} "
              f"({cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}, {TRAIN_BACKEND} QAT), "
              f"{n_params:,} parameters drawn on the card from seed {LM_SEED}; "
              f"{TRAIN_STEPS} make_train_step steps (AdamW {G.TRAIN_OPT}) on "
              f"{TRAIN_STEPS} batches of SyntheticLM({cfg.vocab_size}, {TRAIN_SEQ}, "
              f"{TRAIN_BATCH}, seed=0): losses {[round(x, 5) for x in hist['loss']]}, "
              f"grad_norm {[round(x, 4) for x in hist['grad_norm']]}, lr "
              f"{[float(f'{x:.4e}') for x in hist['lr']]}, all finite; no kernel on the "
              f"training path", flush=True)
        print(f"train: full width: step ms {', '.join(f'{t:.3f}' for t in hist['ms'])}; "
              f"median {med:.3f} ms (host clock, each step ending in the loss's host sync), "
              f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s; StepWatchdog median "
              f"{wd.median * 1e3:.3f} ms, {wd.stragglers} stragglers (factor {wd.factor}; it "
              f"judges a step only after 8 samples, so none of these {TRAIN_STEPS}); "
              f"peak {peak_steps / 1e9:.2f} GB allocated over steps 1-{TRAIN_CKPT_EVERY}, "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB over the run (step "
              f"{TRAIN_CKPT_EVERY}'s state kept for the resume check) ({smi})", flush=True)

        # the crash: the live state is dropped; resume from the newest checkpoint
        losses = hist["loss"]
        del params, opt, metrics
        torch.cuda.empty_cache()
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                              saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, restored = CheckpointManager(tmp, every=TRAIN_CKPT_EVERY, keep=1).resume_latest(
            like, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(start == TRAIN_CKPT_EVERY, f"train: resumed from step {start}, want "
              f"{TRAIN_CKPT_EVERY} (the run died before step {TRAIN_STEPS}'s save)")
        have, want = flat_leaves(restored), flat_leaves(saved)
        check(have.keys() == want.keys() and all(bits_equal(have[k], want[k]) for k in want),
              f"train: the restored state differs from step {start}'s: "
              f"{[k for k in want if k not in have or not bits_equal(have[k], want[k])]}")
        n_state = sum(t.numel() * t.element_size() for t in want.values())
        del saved, have, want
        params, opt = restored["params"], restored["opt"]
        resumed = []
        for batch in batches[start:]:
            params, opt, metrics = step_fn(params, opt, batch)
            resumed.append(metrics["loss"].item())
        again = np.allclose(resumed, losses[start:], rtol=1e-4, atol=1e-5)
        check(again, f"train: resumed losses {resumed} differ from the first run's "
              f"{losses[start:]} beyond rtol 1e-4, atol 1e-5")
        print(f"train: checkpoint: CheckpointManager(every={TRAIN_CKPT_EVERY}, keep=1, async) "
              f"saved step {TRAIN_CKPT_EVERY}: {ckpt_bytes:,} bytes on disk for {n_state:,} "
              f"bytes of state; the host snapshot (device -> host copy) {save_call_s:.3f} s in "
              f"the caller, written {written_s:.3f} s after the call (background thread, "
              f"during steps {TRAIN_CKPT_EVERY + 1}-{TRAIN_STEPS}); crash after step "
              f"{TRAIN_STEPS}, resume_latest onto the card {restore_s:.3f} s (the file warm in "
              f"the page cache): step {start}, every leaf equal bit for bit to step {start}'s "
              f"state; steps {start + 1}-{TRAIN_STEPS} again: losses "
              f"{[round(x, 7) for x in resumed]} against {[round(x, 7) for x in losses[start:]]}"
              f", max |difference| {float(np.abs(np.subtract(resumed, losses[start:])).max()):.3e}"
              f" (bound rtol 1e-4, atol 1e-5)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # where a step's time goes: the loss and its gradients, then the update
    split = {"forward + backward": [], "update": []}
    for _ in range(3):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(live, batches[0])
        grads = iter(torch.autograd.grad(loss, list(flat_leaves(live).values())))
        grads = tree_map(lambda _: next(grads), live)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            adamw.update(G.train_opt_config(), live, grads, opt)
        torch.cuda.synchronize()
        split["forward + backward"].append((t1 - t0) * 1e3)
        split["update"].append((time.perf_counter() - t1) * 1e3)
        del live, loss, grads
    print(f"train: full width, one step split (host clock, synchronised, median of 3 after "
          f"the run): "
          + ", ".join(f"{k} {statistics.median(v):.3f} ms" for k, v in split.items()), flush=True)

    # (c) the trained weights deployed and prefilled on mvu_int
    prompt = {"tokens": batches[0]["tokens"][:, :TRAIN_SEQ]}
    n_pre = len(L.PROJ_NAMES) * cfg.num_layers
    with torch.no_grad():
        fake, _ = model.prefill(params, prompt, model.init_decode_state(TRAIN_BATCH, TRAIN_SEQ))
        deployed = L.quantize_model_params(params, TRAIN_BACKEND)
        logits, _ = counted(
            lambda: model.prefill(deployed, prompt,
                                  model.init_decode_state(TRAIN_BATCH, TRAIN_SEQ)),
            {"mvu_int": n_pre}, "train: the deployed prefill of the trained weights")
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (TRAIN_BATCH, cfg.vocab_size),
          "train: the deployed prefill's logits are not finite")
    corr = float(np.corrcoef(fake.float().cpu().numpy().ravel(),
                             logits.float().cpu().numpy().ravel())[0, 1])
    print(f"train: deployed: quantize_model_params(trained params, {TRAIN_BACKEND!r}), prefill "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ} on mvu_int: finite logits; mvu_int launched "
          f"{n_pre} times = {len(L.PROJ_NAMES)} projections x {cfg.num_layers} layers, nothing "
          f"else; last-token logit correlation against the fake-quant prefill of the same "
          f"trained weights {corr:.6f}", flush=True)
    int0 = tf.layer(deployed["layers"], 0)
    m = TRAIN_BATCH * TRAIN_SEQ
    ga = torch.Generator(device=dev).manual_seed(LM_SEED + 3)
    timed = projection_rows(int0, "mvu_int", {m}, ga, "train")
    rows = [timed[("mvu_int", m, *(int0["attn"] | int0["ffn"])[name]["values"].shape)]
            for name in L.PROJ_NAMES] * cfg.num_layers
    print(f"train: launches of the counted prefill {{'mvu_int': {n_pre}}}; kernel ms over them "
          f"{round(sum(r[0] for r in rows), 4)}; phase {time.perf_counter() - t_phase:.2f} s "
          f"({smi})", flush=True)
    return {"launches": {"mvu_int": n_pre}, "rows": {"mvu_int": rows}}


def lm_moe_phase(dev, smi: str) -> dict:
    """The lm_moe phase (see the module doc): the reduced MoE goldens, the
    full-width Granite-MoE served by ``serve_loop`` on ``mvu_int`` with
    its launches and dropped assignments counted, layer 0's ``moe_ffn``
    timed, full-width Qwen3-MoE at ``MOE_CUT_LAYERS`` layers, and layer 0's
    attention projections of both against the plain version.  Returns, by
    kernel, the counted runs' launches and a timing row for each launch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.launch.serve import Request, prompt_batch, serve_loop
    from repro_torch.models import layers as L, moe, transformer as tf
    from repro_torch.models.model import build
    from repro_torch.tree import flat_leaves

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    attn_names = ATTN_NAMES  # a MoE block's integer-deployed projections

    # (a) the reduced MoE models, float32, against the JAX package's golden runs
    for arch in G.MOE_ARCHS:
        golden = G.load_golden(arch)
        for backend in G.VARIANTS:
            cfg = G.golden_config(backend, arch)
            params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
            if backend != "dense":
                params = L.quantize_model_params(params, backend)
            want = {} if backend == "dense" else {
                "mvu_int": len(attn_names) * cfg.num_layers * (1 + G.DECODE_STEPS)}
            model = build(cfg, device=dev)
            got = counted(lambda: G.greedy_run(model, params), want,
                          f"lm_moe: the {arch} golden run ({backend})")
            bad = G.mismatch(golden["variants"][backend], got)
            check(bad is None, f"lm_moe: the reduced {arch} {backend} model on the card differs "
                  f"from the JAX package's golden run: {bad}")
            ref = np.asarray(golden["variants"][backend]["logits"], np.float32)
            print(f"lm_moe: golden: reduced {cfg.name} {backend} float32 on the card, prefill "
                  f"of {G.BATCH} x {G.PROMPT_LEN} + {G.DECODE_STEPS} greedy steps: max |logit "
                  f"error| {float(np.abs(got['logits'] - ref).max()):.3e} (bound "
                  f"{G.LOGIT_ATOL} x {float(np.abs(ref).max()):.4f}), greedy tokens and dropped "
                  f"assignments by call {got['dropped']} equal the JAX package's; launches "
                  f"{want or 'none'}", flush=True)

    # (b) full-width, full-depth Granite-MoE, attention integer-deployed,
    # experts bf16, served by serve_loop
    cfg = get_config(MOE_SERVE_ARCH).replace(linear_backend=LM_BACKEND)
    check(LM_BATCH * LM_PROMPT_LENS[1] <= cfg.moe_group_size,
          "lm_moe: a prefill group must hold at most one routing group of tokens")
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    params = model.init(g, quantize=LM_BACKEND)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    proj = deployed_projections(params["layers"])
    experts = params["layers"]["moe"]
    check(tuple(proj) == attn_names and all(
        p["values"].dtype == torch.int8 and p["values"].shape[0] == cfg.num_layers
        for p in proj.values()),
        "lm_moe: the attention projections are not integer-deployed int8 on every layer")
    check(experts["router"]["w"].dtype == torch.float32
          and all(experts[k].dtype == torch.bfloat16 for k in ("w_up", "w_gate", "w_down")),
          "lm_moe: the router must stay float32 and the experts bf16")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    expert_bytes = nbytes(experts[k] for k in ("w_up", "w_gate", "w_down"))
    model_bytes = nbytes(flat_leaves(params).values())
    print(f"lm_moe: full width: {cfg.name} ({cfg.num_layers} layers x {cfg.d_model}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, {cfg.num_experts} "
          f"experts top-{cfg.num_experts_per_tok} of d_ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}) drawn on the card from seed {LM_SEED}, attention "
          f"quantized to {LM_BACKEND} layer by layer in {init_s:.2f} s: experts "
          f"{expert_bytes / 1e9:.3f} GB bf16, router float32, the model "
          f"{model_bytes / 1e9:.3f} GB", flush=True)
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(i, p, LM_MAX_NEW) for i, p in enumerate(prompts)]

    groups = [requests()[i:i + LM_BATCH] for i in range(0, LM_REQUESTS, LM_BATCH)]
    group_tokens = [prompt_batch(grp) for grp in groups]
    per_group = len(attn_names) * cfg.num_layers * (1 + LM_MAX_NEW)
    with G.counting_drops() as drops:
        t0 = time.perf_counter()
        done = counted(lambda: serve_loop(model, params, requests(), batch=LM_BATCH,
                                          max_len=LM_MAX_LEN),
                       {"mvu_int": per_group * len(groups)},
                       "lm_moe: serve_loop of Granite-MoE at full width")
        serve_s = time.perf_counter() - t0
    check([r.rid for r in done] == list(range(LM_REQUESTS))
          and all(len(r.out) == LM_MAX_NEW and all(0 <= t < cfg.vocab_size for t in r.out)
                  for r in done),
          "lm_moe: serve_loop did not answer every request with its tokens in the vocabulary")
    # one count a layer a call: each group's prefill, then its decode steps
    by_call = torch.stack(drops).reshape(len(groups), 1 + LM_MAX_NEW, cfg.num_layers).sum(-1)
    pre_drops = by_call[:, 0].tolist()
    pre_assign = [LM_BATCH * t.shape[1] * cfg.num_experts_per_tok * cfg.num_layers
                  for t in group_tokens]
    check(int(by_call[:, 1:].sum()) == 0, "lm_moe: a decode step dropped an assignment (its "
          f"capacity of max(4, ...) slots holds the {LM_BATCH} tokens an expert can get)")
    print(f"lm_moe: serve_loop: {LM_REQUESTS} requests (prompts {lens.tolist()} tokens) in "
          f"{len(groups)} groups of {LM_BATCH}, max_new {LM_MAX_NEW}, max_len {LM_MAX_LEN}: "
          f"every request answered; mvu_int launched {per_group * len(groups)} times = "
          f"{len(attn_names)} attention projections x {cfg.num_layers} layers x (1 prefill + "
          f"{LM_MAX_NEW} decode steps) x {len(groups)} groups, nothing else; prefill "
          f"assignments dropped by capacity {pre_drops} of {pre_assign} by group (capacity "
          f"factor {cfg.capacity_factor}), none at decode; "
          f"{LM_REQUESTS * LM_MAX_NEW / serve_s:.2f} tokens/s over the loop's {serve_s:.3f} s "
          f"(host clock, the first run: no warm-up, a drop count a layer); first tokens "
          f"{[r.out[:4] for r in done[:2]]}", flush=True)

    # (e) serving times on the host clock, synchronised: group 0's prefill,
    # then its decode steps
    toks0 = torch.from_numpy(group_tokens[0])
    pre, dec = [], []
    for _ in range(3):
        state = model.init_decode_state(LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": toks0}, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(LM_MAX_NEW):
            logits, state = model.decode_step(params, state, torch.argmax(logits, -1))
        torch.cuda.synchronize()
        pre.append(t1 - t0)
        dec.append((time.perf_counter() - t1) / LM_MAX_NEW)
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (LM_BATCH,
                                                                          cfg.vocab_size),
          f"lm_moe: full-width logits {tuple(logits.shape)} not finite")
    pre_ms, dec_ms = statistics.median(pre) * 1e3, statistics.median(dec) * 1e3
    print(f"lm_moe: full width {LM_BACKEND}, group 0 ({LM_BATCH} x {toks0.shape[1]} tokens): "
          f"prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms a step ({LM_BATCH} tokens), "
          f"{LM_BATCH / dec_ms * 1e3:.2f} decode tokens/s, "
          f"{LM_BATCH * toks0.shape[1] / pre_ms * 1e3:.1f} prefill tokens/s (host clock, "
          f"synchronised, median of 3 after the served run); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated ({smi})", flush=True)

    # (f) layer 0's moe_ffn alone at the decode and the prefill rows, by CUDA
    # events: the experts' share of a step
    p0 = tf.layer(params["layers"], 0)["moe"]
    for what, shape, factor, step_ms in (
            ("decode", (LM_BATCH, 1), MOE_DECODE_CAPACITY, dec_ms),
            ("prefill", tuple(toks0.shape), cfg.capacity_factor, pre_ms)):
        x = torch.randn((*shape, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
        ffn_ms = device_ms(lambda: moe.moe_ffn(p0, cfg, x, group_size=cfg.moe_group_size,
                                               capacity_factor=factor), reps=5)
        t = shape[0] * shape[1]
        print(f"lm_moe: layer 0 moe_ffn at the {what} rows ({t} tokens, capacity "
              f"{moe._capacity(t, cfg.num_experts, cfg.num_experts_per_tok, factor)} slots an "
              f"expert): {ffn_ms:.4f} ms (CUDA events, median of 5 x 5 calls); x "
              f"{cfg.num_layers} layers = {ffn_ms * cfg.num_layers / step_ms:.1%} of the "
              f"{what} step's {step_ms:.3f} ms ({smi})", flush=True)

    # (d) layer 0's attention projections at full width against the plain
    # version at the decode rows and each group's prefill rows
    ga = torch.Generator(device=dev).manual_seed(LM_SEED + 4)
    m_pre = [LM_BATCH * t.shape[1] for t in group_tokens]
    layer0 = tf.layer(params["layers"], 0)
    timed = projection_rows(layer0, "mvu_int", {LM_BATCH, *m_pre}, ga, "lm_moe")
    shapes = [tuple(p["values"].shape) for p in deployed_projections(layer0).values()]
    rows = []
    for m in m_pre:
        for mm, reps in ((m, 1), (LM_BATCH, LM_MAX_NEW)):
            rows += [timed[("mvu_int", mm, n, k)] for n, k in shapes] * (cfg.num_layers * reps)
    granite_peak = torch.cuda.max_memory_allocated()
    del model, params, experts, proj, p0, layer0
    torch.cuda.empty_cache()

    # (c) full-width Qwen3-MoE cut to MOE_CUT_LAYERS layers: one prefill of
    # group 0 and MOE_CUT_STEPS greedy decode steps
    torch.cuda.reset_peak_memory_stats()
    qcfg = get_config(MOE_CUT_ARCH).replace(num_layers=MOE_CUT_LAYERS,
                                            linear_backend=LM_BACKEND)
    t0 = time.perf_counter()
    qmodel = build(qcfg, device=dev)
    qparams = qmodel.init(g, quantize=LM_BACKEND)
    torch.cuda.synchronize()
    q_init_s = time.perf_counter() - t0
    q_experts = nbytes(qparams["layers"]["moe"][k] for k in ("w_up", "w_gate", "w_down"))

    def qrun():
        state = qmodel.init_decode_state(LM_BATCH, LM_MAX_LEN)
        logits, state = qmodel.prefill(qparams, {"tokens": toks0}, state)
        for _ in range(MOE_CUT_STEPS):
            logits, state = qmodel.decode_step(qparams, state, torch.argmax(logits, -1))
        return logits

    n_q = len(attn_names) * MOE_CUT_LAYERS * (1 + MOE_CUT_STEPS)
    qlogits = counted(qrun, {"mvu_int": n_q}, f"lm_moe: {qcfg.name} at {MOE_CUT_LAYERS} layers")
    check(bool(torch.isfinite(qlogits).all())
          and tuple(qlogits.shape) == (LM_BATCH, qcfg.vocab_size),
          f"lm_moe: {qcfg.name}'s logits {tuple(qlogits.shape)} are not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qrun()
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    print(f"lm_moe: cut: {qcfg.name} at full width ({qcfg.d_model}, {qcfg.num_heads} / "
          f"{qcfg.num_kv_heads} heads of {qcfg.head_dim}, qk-norm, {qcfg.num_experts} experts "
          f"top-{qcfg.num_experts_per_tok} of d_ff {qcfg.moe_d_ff}, vocab {qcfg.vocab_size}) at "
          f"{MOE_CUT_LAYERS} of its 94 layers, drawn and quantized in {q_init_s:.2f} s "
          f"(experts {q_experts / 1e9:.3f} GB bf16): prefill of {LM_BATCH} x {toks0.shape[1]} "
          f"+ {MOE_CUT_STEPS} greedy steps, finite logits {tuple(qlogits.shape)}; mvu_int "
          f"launched {n_q} times = {len(attn_names)} x {MOE_CUT_LAYERS} layers x "
          f"{1 + MOE_CUT_STEPS} calls, nothing else; {q_s * 1e3:.3f} ms the run (host clock, "
          f"synchronised, the second); peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"allocated", flush=True)
    q0 = tf.layer(qparams["layers"], 0)
    qtimed = projection_rows(q0, "mvu_int", {LM_BATCH, m_pre[0]}, ga, "lm_moe")
    qshapes = [tuple(p["values"].shape) for p in deployed_projections(q0).values()]
    for mm, reps in ((m_pre[0], 1), (LM_BATCH, MOE_CUT_STEPS)):
        rows += [qtimed[("mvu_int", mm, n, k)] for n, k in qshapes] * (MOE_CUT_LAYERS * reps)
    del qmodel, qparams, q0
    torch.cuda.empty_cache()

    launches = {"mvu_int": per_group * len(groups) + n_q}
    check(len(rows) == launches["mvu_int"], "lm_moe: a row for every launch")
    print(f"lm_moe: launches of the counted runs {launches}; kernel ms over them "
          f"{round(sum(r[0] for r in rows), 4)}; phase {time.perf_counter() - t_phase:.2f} s, "
          f"peak {max(granite_peak, torch.cuda.max_memory_allocated()) / 1e9:.2f} GB "
          f"allocated ({smi})", flush=True)
    return {"launches": launches, "rows": {"mvu_int": rows}}


def ssd_recurrence(x, dt, a_log, b_mat, c_mat):
    """The SSD as its step recurrence in float64 on the inputs' device (the
    port of ``tests/test_ssm.py::_naive_recurrence``): (y (B, S, H, P),
    final state (B, H, P, N))."""
    import torch

    f64 = torch.float64
    a = -torch.exp(a_log.to(f64))
    x, dt, b_mat, c_mat = (t.to(f64) for t in (x, dt, b_mat, c_mat))
    bsz, s, h, p = x.shape
    rep = h // b_mat.shape[2]
    state = torch.zeros((bsz, h, p, b_mat.shape[3]), dtype=f64, device=x.device)
    ys = torch.empty((bsz, s, h, p), dtype=f64, device=x.device)
    for t in range(s):
        bh = b_mat[:, t].repeat_interleave(rep, dim=1)
        ch = c_mat[:, t].repeat_interleave(rep, dim=1)
        state = state * torch.exp(dt[:, t] * a)[..., None, None] + (
            dt[:, t][..., None, None] * x[:, t][..., None] * bh[:, :, None, :])
        ys[:, t] = torch.einsum("bhpn,bhn->bhp", state, ch)
    return ys, state


def lm_ssm_phase(dev, smi: str) -> dict:
    """The lm_ssm phase (see the module doc): the reduced mamba2's golden,
    full-width, full-depth mamba2-780m served by ``serve_loop`` with layer
    0's prefill and decode step timed, ``ssd_chunked`` at full-width shapes
    against the float64 recurrence, and prefill + decode against one long
    prefill in float32.  Every run is counted: no kernel launches.  Returns
    the (empty) launches and rows by kernel, as the other LM phases do."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.configs.base import ssm_dims
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.launch.serve import Request, prompt_batch, serve_loop
    from repro_torch.models import layers as L, ssm, transformer as tf
    from repro_torch.models.model import build
    from repro_torch.tree import flat_leaves

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # (a) the reduced mamba2, float32, against the JAX package's golden run
    golden = G.load_golden(SSM_ARCH)
    for backend in G.VARIANTS:
        cfg = G.golden_config(backend, SSM_ARCH)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        if backend != "dense":
            params = L.quantize_model_params(params, backend)
        model = build(cfg, device=dev)
        got = counted(lambda: G.greedy_run(model, params), {},
                      f"lm_ssm: the {SSM_ARCH} golden run ({backend})")
        bad = G.mismatch(golden["variants"][backend], got)
        check(bad is None, f"lm_ssm: the reduced {SSM_ARCH} {backend} model on the card "
              f"differs from the JAX package's golden run: {bad}")
        ref = np.asarray(golden["variants"][backend]["logits"], np.float32)
        print(f"lm_ssm: golden: reduced {cfg.name} {backend} float32 on the card, prefill of "
              f"{G.BATCH} x {G.PROMPT_LEN} + {G.DECODE_STEPS} greedy steps: max |logit error| "
              f"{float(np.abs(got['logits'] - ref).max()):.3e} (bound {G.LOGIT_ATOL} x "
              f"{float(np.abs(ref).max()):.4f}), greedy tokens equal the JAX package's; no "
              f"kernel launched", flush=True)

    # (b) full-width, full-depth mamba2-780m, bf16, served by serve_loop
    cfg = get_config(SSM_ARCH).replace(linear_backend=LM_BACKEND)
    d_inner, nheads, _ = ssm_dims(cfg)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    params = model.init(g, quantize=LM_BACKEND)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    blk = params["layers"]["ssm"]
    check(all(set(blk[k]) == {"w"} and blk[k]["w"].dtype == torch.bfloat16
              and blk[k]["w"].shape[0] == cfg.num_layers for k in SSM_PROJ),
          f"lm_ssm: an SSM projection is not a float bf16 {{'w'}} on every layer after "
          f"init(quantize={LM_BACKEND!r}) (none is in PROJ_NAMES)")
    check(all(blk[k].dtype == torch.float32 for k in SSM_FLOAT32),
          f"lm_ssm: {SSM_FLOAT32} must stay float32 in a bf16 model")
    leaves = flat_leaves(params).values()
    model_bytes = sum(t.numel() * t.element_size() for t in leaves)
    n_params = sum(t.numel() for t in leaves)
    print(f"lm_ssm: full width: {cfg.name} ({cfg.num_layers} layers x {cfg.d_model}, d_inner "
          f"{d_inner}, {nheads} heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, conv "
          f"{cfg.ssm_conv}, chunk {cfg.ssd_chunk}, vocab {cfg.vocab_size}, tied embeddings, "
          f"{cfg.dtype}) drawn on the card from seed {LM_SEED} with init(quantize="
          f"{LM_BACKEND!r}) in {init_s:.2f} s: {n_params:,} parameters, {model_bytes / 1e9:.3f} "
          f"GB; every projection ({', '.join(SSM_PROJ)}) a float bf16 {{'w'}}, "
          f"{'/'.join(SSM_FLOAT32)} float32", flush=True)
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(i, p, LM_MAX_NEW) for i, p in enumerate(prompts)]

    groups = [requests()[i:i + LM_BATCH] for i in range(0, LM_REQUESTS, LM_BATCH)]
    toks0 = torch.from_numpy(prompt_batch(groups[0]))
    t0 = time.perf_counter()
    done = counted(lambda: serve_loop(model, params, requests(), batch=LM_BATCH,
                                      max_len=LM_MAX_LEN),
                   {}, "lm_ssm: serve_loop of mamba2-780m at full width")
    serve_s = time.perf_counter() - t0
    check([r.rid for r in done] == list(range(LM_REQUESTS))
          and all(len(r.out) == LM_MAX_NEW and all(0 <= t < cfg.vocab_size for t in r.out)
                  for r in done),
          "lm_ssm: serve_loop did not answer every request with its tokens in the vocabulary")
    print(f"lm_ssm: serve_loop: {LM_REQUESTS} requests (prompts {lens.tolist()} tokens) in "
          f"{len(groups)} groups of {LM_BATCH}, max_new {LM_MAX_NEW}, max_len {LM_MAX_LEN} "
          f"(ignored by the SSM cache): every request answered, no kernel launched; "
          f"{LM_REQUESTS * LM_MAX_NEW / serve_s:.2f} tokens/s over the loop's {serve_s:.3f} s "
          f"(host clock, the first run: no warm-up); first tokens "
          f"{[r.out[:4] for r in done[:2]]}", flush=True)

    # (e) serving times on the host clock, synchronised: group 0's prefill,
    # then its decode steps, under W8A8 (the fake-quant arm) and under dense
    # on the same weights
    dense_model = build(cfg.replace(linear_backend="dense"), device=dev)
    times = {}
    for what, m in ((LM_BACKEND, model), ("dense", dense_model)):
        pre, dec = [], []
        for _ in range(3):
            state = m.init_decode_state(LM_BATCH, LM_MAX_LEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = m.prefill(params, {"tokens": toks0}, state)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(LM_MAX_NEW):
                logits, state = m.decode_step(params, state, torch.argmax(logits, -1))
            torch.cuda.synchronize()
            pre.append(t1 - t0)
            dec.append((time.perf_counter() - t1) / LM_MAX_NEW)
        check(bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (LM_BATCH, cfg.vocab_size),
              f"lm_ssm: full-width {what} logits {tuple(logits.shape)} not finite")
        times[what] = (statistics.median(pre) * 1e3, statistics.median(dec) * 1e3)
    pre_ms, dec_ms = times[LM_BACKEND]
    print(f"lm_ssm: full width {LM_BACKEND}, group 0 ({LM_BATCH} x {toks0.shape[1]} tokens): "
          f"prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms a step ({LM_BATCH} tokens), "
          f"{LM_BATCH / dec_ms * 1e3:.2f} decode tokens/s, "
          f"{LM_BATCH * toks0.shape[1] / pre_ms * 1e3:.1f} prefill tokens/s; dense on the same "
          f"weights: prefill {times['dense'][0]:.3f} ms, decode {times['dense'][1]:.3f} ms a "
          f"step: the fake-quant arm costs {dec_ms - times['dense'][1]:.3f} ms a step (host "
          f"clock, synchronised, median of 3 after the served run); the model "
          f"{model_bytes / 1e9:.3f} GB, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"allocated ({smi})", flush=True)

    # (f) layer 0's ssm_prefill and ssm_decode_step alone, by CUDA events
    p0 = tf.layer(params["layers"], 0)["ssm"]
    x = torch.randn((*toks0.shape, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    x1 = torch.randn((LM_BATCH, 1, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    prefill0 = lambda: ssm.ssm_prefill(p0, cfg, x, chunk=cfg.ssd_chunk, backend=LM_BACKEND)
    cache0 = prefill0()[1]
    layer_ms = {"prefill": device_ms(prefill0, reps=5)}
    for be in (LM_BACKEND, "dense"):
        layer_ms[be] = device_ms(lambda: ssm.ssm_decode_step(p0, cfg, x1, cache0, backend=be),
                                 reps=5)
    print(f"lm_ssm: layer 0 ssm_prefill ({LM_BATCH} x {toks0.shape[1]} tokens, {LM_BACKEND}) "
          f"{layer_ms['prefill']:.4f} ms, x {cfg.num_layers} layers = "
          f"{layer_ms['prefill'] * cfg.num_layers / pre_ms:.1%} of the prefill's {pre_ms:.3f} ms; "
          f"ssm_decode_step ({LM_BATCH} tokens) {layer_ms[LM_BACKEND]:.4f} ms under "
          f"{LM_BACKEND}, {layer_ms['dense']:.4f} ms under dense, x {cfg.num_layers} layers = "
          f"{layer_ms[LM_BACKEND] * cfg.num_layers / dec_ms:.1%} of the decode step's "
          f"{dec_ms:.3f} ms (CUDA events, median of 5 x 5 calls; {smi})", flush=True)
    del model, dense_model, params, blk, p0, cache0, leaves
    torch.cuda.empty_cache()

    # (c) ssd_chunked at full-width shapes across chunks against the float64
    # step recurrence
    bsz, s = SSD_CHECK
    gc = torch.Generator(device=dev).manual_seed(LM_SEED + 5)
    rnd = lambda *shape: torch.randn(shape, generator=gc, device=dev)
    xs, dts = rnd(bsz, s, nheads, cfg.ssm_headdim), ssm.softplus(rnd(bsz, s, nheads))
    a_log = torch.rand((nheads,), generator=gc, device=dev)
    bm, cm = rnd(bsz, s, cfg.ssm_groups, cfg.ssm_state), rnd(bsz, s, cfg.ssm_groups,
                                                              cfg.ssm_state)
    ssd = lambda: ssm.ssd_chunked(xs, dts, a_log, bm, cm, chunk=cfg.ssd_chunk)
    y, st = counted(ssd, {}, "lm_ssm: ssd_chunked at full width")
    y_ref, st_ref = ssd_recurrence(xs, dts, a_log, bm, cm)
    errs = [float((got.double() - want).abs().max() / want.abs().max())
            for got, want in ((y, y_ref), (st, st_ref))]
    check(all(e <= SSD_ATOL for e in errs),
          f"lm_ssm: ssd_chunked (y, state) off the float64 recurrence by {errs} of the largest, "
          f"bound {SSD_ATOL}")
    ssd_ms = device_ms(ssd, reps=5)
    print(f"lm_ssm: ssd_chunked float32 at B={bsz} S={s} (chunk {cfg.ssd_chunk}: "
          f"{-(-s // cfg.ssd_chunk)} chunks, the last padded) H={nheads} P={cfg.ssm_headdim} "
          f"N={cfg.ssm_state}: y and the final state within {errs[0]:.3e} and {errs[1]:.3e} of "
          f"their largest magnitude of the float64 step recurrence (bound {SSD_ATOL}); "
          f"{ssd_ms:.4f} ms (CUDA events, median of 5 x 5 calls)", flush=True)
    del xs, dts, bm, cm, y, st, y_ref, st_ref

    # (d) full width in float32: one prefill of S tokens against a prefill of
    # S - steps and steps decode steps
    bsz, s, steps = SSM_LONG
    fcfg = get_config(SSM_ARCH).replace(dtype="float32")
    fmodel = build(fcfg, device=dev)
    fparams = fmodel.init(g)
    toks = torch.from_numpy(np.random.default_rng(LM_SEED + 6).integers(
        0, fcfg.vocab_size, (bsz, s)).astype(np.int32))

    def one_prefill():
        return fmodel.prefill(fparams, {"tokens": toks}, fmodel.init_decode_state(bsz, s))[0]

    def prefill_then_decode():
        logits, state = fmodel.prefill(fparams, {"tokens": toks[:, :s - steps]},
                                       fmodel.init_decode_state(bsz, s))
        for t in range(s - steps, s):
            logits, state = fmodel.decode_step(fparams, state, toks[:, t].to(dev))
        return logits

    full = counted(one_prefill, {}, "lm_ssm: the long prefill")
    part = counted(prefill_then_decode, {}, "lm_ssm: prefill + decode")
    err = float((part - full).abs().max())
    close = bool(torch.allclose(part, full, rtol=SSM_LONG_TOL, atol=SSM_LONG_TOL))
    same = bool(torch.equal(part.argmax(-1), full.argmax(-1)))
    check(close and same, f"lm_ssm: prefill of {s - steps} + {steps} decode steps differs from "
          f"one prefill of {s}: max |logit error| {err:.3e} (rtol = atol = {SSM_LONG_TOL}), "
          f"argmax equal {same}")
    f_bytes = sum(t.numel() * t.element_size() for t in flat_leaves(fparams).values())
    print(f"lm_ssm: full width float32 ({f_bytes / 1e9:.3f} GB), dense: a prefill of {bsz} x {s - steps} + {steps} decode steps gives one "
          f"prefill of {bsz} x {s}'s logits: max |error| {err:.3e} of largest "
          f"{float(full.abs().max()):.4f} (rtol = atol = {SSM_LONG_TOL}), argmax equal; no "
          f"kernel launched", flush=True)
    del fmodel, fparams, full, part
    torch.cuda.empty_cache()
    print(f"lm_ssm: phase {time.perf_counter() - t_phase:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated since (b) ({smi})",
          flush=True)
    return {"launches": {}, "rows": {}}


def lm_hybrid_phase(dev, smi: str) -> dict:
    """The lm_hybrid phase (see the module doc): the reduced Jamba's golden
    with its launches and drops, full-width Jamba-1.5-Large cut to one
    group of ``HYBRID_CUT`` layers served by ``serve_loop`` on ``mvu_int``
    with its sub-layers timed, its new ``mvu_int`` shapes against the
    plain version, and prefill + decode against one long prefill of the
    reduced Jamba.  Returns, by kernel, the served run's launches and a
    timing row for each launch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.configs.base import ssm_dims
    from repro_torch.convert import keeps_float32, lm_numpy_params, lm_params_from_numpy
    from repro_torch.launch.serve import Request, prompt_batch, serve_loop
    from repro_torch.models import attention, layers as L, moe, ssm, transformer as tf
    from repro_torch.models.model import build
    from repro_torch.tree import flat_leaves

    t_phase = time.perf_counter()
    arch = G.HYBRID_ARCH
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)

    def launches_a_call(cfg) -> int:
        """mvu_int launches of one prefill or decode call: the four
        attention projections and the gated dense FFNs' three each."""
        per = cfg.attn_period
        return cfg.num_layers // per * (len(ATTN_NAMES) + 3 * (per - per // 2))

    # (a) the reduced Jamba, float32, against the JAX package's golden run
    golden = G.load_golden(arch)
    for backend in G.VARIANTS:
        cfg = G.golden_config(backend, arch)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        if backend != "dense":
            params = L.quantize_model_params(params, backend)
        want = {} if backend == "dense" else {
            "mvu_int": launches_a_call(cfg) * (1 + G.DECODE_STEPS)}
        model = build(cfg, device=dev)
        got = counted(lambda: G.greedy_run(model, params), want,
                      f"lm_hybrid: the {arch} golden run ({backend})")
        bad = G.mismatch(golden["variants"][backend], got)
        check(bad is None, f"lm_hybrid: the reduced {arch} {backend} model on the card differs "
              f"from the JAX package's golden run: {bad}")
        ref = np.asarray(golden["variants"][backend]["logits"], np.float32)
        print(f"lm_hybrid: golden: reduced {cfg.name} {backend} float32 on the card (one group "
              f"of {cfg.attn_period} layers), prefill of {G.BATCH} x {G.PROMPT_LEN} + "
              f"{G.DECODE_STEPS} greedy steps: max |logit error| "
              f"{float(np.abs(got['logits'] - ref).max()):.3e} (bound {G.LOGIT_ATOL} x "
              f"{float(np.abs(ref).max()):.4f}), greedy tokens and dropped assignments by call "
              f"{got['dropped']} equal the JAX package's; launches {want or 'none'}", flush=True)
    del model, params
    torch.cuda.empty_cache()

    # (b) full width, one group of HYBRID_CUT layers, bf16, drawn on the card
    full = get_config(arch)
    cfg = full.replace(num_layers=HYBRID_CUT, attn_period=HYBRID_CUT, linear_backend=LM_BACKEND)
    d_inner, nheads, _ = ssm_dims(cfg)
    check(LM_BATCH * LM_PROMPT_LENS[1] <= cfg.moe_group_size,
          "lm_hybrid: a prefill group must hold at most one routing group of tokens")
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    params = model.init(g, quantize=LM_BACKEND)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated()
    lay = params["layers"]
    per, n_groups = cfg.attn_period, cfg.num_layers // cfg.attn_period
    n_moe, n_dense = per // 2, per - per // 2
    proj = {**{k: lay["attn"][k] for k in ATTN_NAMES},
            **{k: lay["ffn"][k] for k in ("w_up", "w_gate", "w_down")}}
    check(all(set(p) == {"values", "scale"} and p["values"].dtype == torch.int8
              and p["values"].shape[0] == n_groups for p in proj.values())
          and lay["ffn"]["w_up"]["values"].shape[:2] == (n_groups, n_dense),
          "lm_hybrid: the attention and dense-FFN projections are not int8 on every sub-layer")
    float_leaves = {f"{node}/{path}": t for node in ("ssm", "moe")
                    for path, t in flat_leaves(lay[node]).items()}
    check(all(t.dtype == (torch.float32 if keeps_float32(path) else torch.bfloat16)
              for path, t in float_leaves.items())
          and all(set(lay["ssm"][k]) == {"w"} for k in SSM_PROJ)
          and lay["moe"]["w_up"].shape[:2] == (n_groups, n_moe)
          and lay["ssm"]["w_z"]["w"].shape[:2] == (n_groups, per - 1),
          "lm_hybrid: the SSM projections and the experts must stay bf16, the router and "
          f"{'/'.join(SSM_FLOAT32)} float32")
    expert_bytes = nbytes(lay["moe"][k] for k in ("w_up", "w_gate", "w_down"))
    model_bytes = nbytes(flat_leaves(params).values())
    # a model of one group at the config's attn_period, from this tree: each
    # kind's bytes a sub-layer times the sub-layers it adds
    each = {k: nbytes(flat_leaves(lay[k]).values()) / (n_groups * n)
            for k, n in (("ssm", per - 1), ("moe", n_moe), ("ffn", n_dense))}
    fp = full.attn_period
    group_bytes = model_bytes / n_groups + ((fp - per) * each["ssm"]
                                            + (fp // 2 - n_moe) * each["moe"]
                                            + (fp - fp // 2 - n_dense) * each["ffn"])
    print(f"lm_hybrid: cut: {full.name} ({full.num_layers} layers, attn_period {fp}: "
          f"1:{fp - 1}) -> {cfg.num_layers} layers, attn_period {per} (1:{per - 1}, the "
          f"reference's REDUCED interleave), every width and the {cfg.num_experts} experts "
          f"kept: a model of one group of {fp} layers would hold {group_bytes / 1e9:.1f} GB "
          f"of weights (these sub-layers' bytes), one of {per} holds "
          f"{model_bytes / 1e9:.1f} GB", flush=True)
    print(f"lm_hybrid: full width: {cfg.name} ({cfg.d_model}, {cfg.num_heads} / "
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, no RoPE; SSM d_inner {d_inner}, "
          f"{nheads} heads of {cfg.ssm_headdim}, state {cfg.ssm_state}; {cfg.num_experts} "
          f"experts top-{cfg.num_experts_per_tok} of d_ff {cfg.moe_d_ff}; dense d_ff "
          f"{cfg.d_ff}; vocab {cfg.vocab_size}, untied; {cfg.dtype}): {n_groups} group of "
          f"{per} (1 attention + {per - 1} SSM, {n_moe} MoE + {n_dense} dense FFNs) drawn on "
          f"the card from seed {LM_SEED} with init(quantize={LM_BACKEND!r}) in {init_s:.2f} s: "
          f"the model {model_bytes / 1e9:.3f} GB (experts {expert_bytes / 1e9:.3f} GB bf16), "
          f"attention and dense FFN int8, SSM projections and experts bf16, router and "
          f"{'/'.join(SSM_FLOAT32)} float32; peak while drawing {draw_peak / 1e9:.2f} GB "
          f"allocated ({smi})", flush=True)
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(i, p, LM_MAX_NEW) for i, p in enumerate(prompts)]

    groups = [requests()[i:i + LM_BATCH] for i in range(0, LM_REQUESTS, LM_BATCH)]
    group_tokens = [prompt_batch(grp) for grp in groups]
    a_call = launches_a_call(cfg)
    per_group = a_call * (1 + LM_MAX_NEW)
    torch.cuda.reset_peak_memory_stats()
    with G.counting_drops() as drops:
        t0 = time.perf_counter()
        done = counted(lambda: serve_loop(model, params, requests(), batch=LM_BATCH,
                                          max_len=LM_MAX_LEN),
                       {"mvu_int": per_group * len(groups)},
                       "lm_hybrid: serve_loop of Jamba at full width")
        serve_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    check([r.rid for r in done] == list(range(LM_REQUESTS))
          and all(len(r.out) == LM_MAX_NEW and all(0 <= t < cfg.vocab_size for t in r.out)
                  for r in done),
          "lm_hybrid: serve_loop did not answer every request with its tokens in the vocabulary")
    # one count a MoE layer a call: each group's prefill, then its decode steps
    by_call = torch.stack(drops).reshape(len(groups), 1 + LM_MAX_NEW,
                                         n_groups * n_moe).sum(-1)
    pre_drops = by_call[:, 0].tolist()
    pre_assign = [t.size * cfg.num_experts_per_tok * n_groups * n_moe for t in group_tokens]
    check(int(by_call[:, 1:].sum()) == 0, "lm_hybrid: a decode step dropped an assignment "
          f"(its capacity of max(4, ...) slots holds the {LM_BATCH} tokens an expert can get)")
    print(f"lm_hybrid: serve_loop: {LM_REQUESTS} requests (prompts {lens.tolist()} tokens) in "
          f"{len(groups)} groups of {LM_BATCH}, max_new {LM_MAX_NEW}, max_len {LM_MAX_LEN}: "
          f"every request answered; mvu_int launched {per_group * len(groups)} times = "
          f"{a_call} a call ({len(ATTN_NAMES)} attention + 3 x {n_dense} dense-FFN projections) "
          f"x (1 prefill + {LM_MAX_NEW} decode steps) x {len(groups)} groups, nothing else; "
          f"prefill assignments dropped by capacity {pre_drops} of {pre_assign} by group "
          f"(capacity factor {cfg.capacity_factor}), none at decode; "
          f"{LM_REQUESTS * LM_MAX_NEW / serve_s:.2f} tokens/s over the loop's {serve_s:.3f} s "
          f"(host clock, the first run: no warm-up, a drop count a MoE layer); peak while "
          f"serving {serve_peak / 1e9:.2f} GB allocated; first tokens "
          f"{[r.out[:4] for r in done[:2]]} ({smi})", flush=True)

    # (e) serving times on the host clock, synchronised: group 0's prefill,
    # then its decode steps
    toks0 = torch.from_numpy(group_tokens[0])
    pre, dec = [], []
    for _ in range(3):
        state = model.init_decode_state(LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": toks0}, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(LM_MAX_NEW):
            logits, state = model.decode_step(params, state, torch.argmax(logits, -1))
        torch.cuda.synchronize()
        pre.append(t1 - t0)
        dec.append((time.perf_counter() - t1) / LM_MAX_NEW)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (LM_BATCH, cfg.vocab_size),
          f"lm_hybrid: full-width logits {tuple(logits.shape)} not finite")
    pre_ms, dec_ms = statistics.median(pre) * 1e3, statistics.median(dec) * 1e3
    print(f"lm_hybrid: full width {LM_BACKEND}, group 0 ({LM_BATCH} x {toks0.shape[1]} "
          f"tokens): prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms a step ({LM_BATCH} "
          f"tokens), {LM_BATCH / dec_ms * 1e3:.2f} decode tokens/s, "
          f"{toks0.numel() / pre_ms * 1e3:.1f} prefill tokens/s (host clock, synchronised, "
          f"median of 3 after the served run) ({smi})", flush=True)

    # (f) the group's sub-layers alone by CUDA events, at the decode and the
    # prefill rows: the attention, an SSM layer, a MoE FFN and a dense FFN
    group0 = tf.layer(lay, 0)
    subs = tf._sub_layers(group0)
    kv = attention.init_kv_cache(cfg, LM_BATCH, LM_MAX_LEN, torch.bfloat16, dev)
    pos = torch.full((LM_BATCH, 1), toks0.shape[1], dtype=torch.int32, device=dev)
    positions = torch.arange(toks0.shape[1], dtype=torch.int32, device=dev)[None].expand(
        LM_BATCH, -1)
    bf16 = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    cache0 = ssm.ssm_prefill(subs["ssm"][0], cfg, bf16(LM_BATCH, 8, cfg.d_model),
                             chunk=cfg.ssd_chunk, backend=LM_BACKEND)[1]
    step_ms = {"decode": dec_ms, "prefill": pre_ms}
    for what, rows, factor in (("decode", 1, MOE_DECODE_CAPACITY),
                               ("prefill", toks0.shape[1], cfg.capacity_factor)):
        x = bf16(LM_BATCH, rows, cfg.d_model)
        if what == "decode":
            fns = {"attention": lambda: attention.attention_decode(
                       group0["attn"], cfg, x, pos, kv, backend=LM_BACKEND),
                   "ssm": lambda: ssm.ssm_decode_step(subs["ssm"][0], cfg, x, cache0,
                                                      backend=LM_BACKEND)}
        else:
            fns = {"attention": lambda: attention.attention_prefill(
                       group0["attn"], cfg, x, positions, kv, backend=LM_BACKEND),
                   "ssm": lambda: ssm.ssm_prefill(subs["ssm"][0], cfg, x, chunk=cfg.ssd_chunk,
                                                  backend=LM_BACKEND)}
        fns["moe"] = lambda: moe.moe_ffn(subs["moe"][0], cfg, x, group_size=cfg.moe_group_size,
                                         capacity_factor=factor)
        fns["ffn"] = lambda: tf.ffn(subs["ffn"][0], cfg, x, backend=LM_BACKEND)
        ms = {k: device_ms(fn, reps=3) for k, fn in fns.items()}
        count = {"attention": n_groups, "ssm": n_groups * (per - 1), "moe": n_groups * n_moe,
                 "ffn": n_groups * n_dense}
        total = sum(ms[k] * count[k] for k in ms)
        t = LM_BATCH * rows
        print(f"lm_hybrid: the group's sub-layers at the {what} rows ({t} tokens; MoE capacity "
              f"{moe._capacity(t, cfg.num_experts, cfg.num_experts_per_tok, factor)} slots an "
              f"expert), CUDA events, median of 5 x 3 calls: "
              + ", ".join(f"{k} {ms[k]:.4f} ms (x {count[k]})" for k in ms)
              + f"; {total:.3f} ms in all = {total / step_ms[what]:.1%} of the {what} step's "
              f"{step_ms[what]:.3f} ms ({smi})", flush=True)
    del kv, x, fns, cache0

    # (c) the new mvu_int shapes: the attention and the first dense FFN
    # against the plain version at the decode and each group's prefill rows
    ga = torch.Generator(device=dev).manual_seed(LM_SEED + 4)
    m_pre = [t.size for t in group_tokens]
    layer0 = {"attn": group0["attn"], "ffn": subs["ffn"][0]}  # as one deployed layer
    timed = projection_rows(layer0, "mvu_int", {LM_BATCH, *m_pre}, ga, "lm_hybrid")
    shapes = [tuple(p["values"].shape) for p in deployed_projections(layer0).values()]
    check(sorted({(k, n) for n, k in shapes}) == sorted(HYBRID_SHAPES),
          f"lm_hybrid: the deployed shapes (K, N) {sorted({(k, n) for n, k in shapes})}, want "
          f"{sorted(HYBRID_SHAPES)}")
    # a call launches the attention's four once and the FFN's three n_dense
    # times a group
    call_shapes = shapes[:len(ATTN_NAMES)] + shapes[len(ATTN_NAMES):] * n_dense
    rows = []
    for m in m_pre:
        for mm, reps in ((m, 1), (LM_BATCH, LM_MAX_NEW)):
            rows += [timed[("mvu_int", mm, n, k)] for n, k in call_shapes] * (n_groups * reps)
    del model, params, lay, proj, float_leaves, group0, subs, layer0
    torch.cuda.empty_cache()

    # (d) the reduced Jamba in float32, capacity 8.0: one prefill of S tokens
    # against a prefill of S - steps and steps decode steps
    bsz, s, steps = HYBRID_LONG
    fcfg = G.golden_config("dense", arch).replace(capacity_factor=HYBRID_LONG_CAPACITY)
    fmodel = build(fcfg, device=dev)
    fparams = lm_params_from_numpy(lm_numpy_params(fcfg, G.SEED), dev)
    toks = torch.from_numpy(np.random.default_rng(LM_SEED + 6).integers(
        0, fcfg.vocab_size, (bsz, s)).astype(np.int32))

    def one_prefill():
        return fmodel.prefill(fparams, {"tokens": toks}, fmodel.init_decode_state(bsz, s))[0]

    def prefill_then_decode():
        logits, state = fmodel.prefill(fparams, {"tokens": toks[:, :s - steps]},
                                       fmodel.init_decode_state(bsz, s))
        for t in range(s - steps, s):
            logits, state = fmodel.decode_step(fparams, state, toks[:, t].to(dev))
        return logits

    whole = counted(one_prefill, {}, "lm_hybrid: the long prefill")
    part = counted(prefill_then_decode, {}, "lm_hybrid: prefill + decode")
    err = float((part - whole).abs().max())
    close = bool(torch.allclose(part, whole, rtol=SSM_LONG_TOL, atol=SSM_LONG_TOL))
    same = bool(torch.equal(part.argmax(-1), whole.argmax(-1)))
    check(close and same, f"lm_hybrid: prefill of {s - steps} + {steps} decode steps differs "
          f"from one prefill of {s}: max |logit error| {err:.3e} (rtol = atol = "
          f"{SSM_LONG_TOL}), argmax equal {same}")
    print(f"lm_hybrid: reduced {fcfg.name} float32, capacity {HYBRID_LONG_CAPACITY}, dense: a "
          f"prefill of {bsz} x {s - steps} + {steps} decode steps gives one prefill of {bsz} x "
          f"{s}'s logits ({-(-s // fcfg.ssd_chunk)} SSD chunks of {fcfg.ssd_chunk}): max "
          f"|error| {err:.3e} of largest {float(whole.abs().max()):.4f} (rtol = atol = "
          f"{SSM_LONG_TOL}), argmax equal; no kernel launched", flush=True)
    del fmodel, fparams, whole, part
    torch.cuda.empty_cache()

    launches = {"mvu_int": per_group * len(groups)}
    check(len(rows) == launches["mvu_int"], "lm_hybrid: a row for every launch")
    print(f"lm_hybrid: launches of the served run {launches}; kernel ms over them "
          f"{round(sum(r[0] for r in rows), 4)}; phase {time.perf_counter() - t_phase:.2f} s, "
          f"peak while drawing {draw_peak / 1e9:.2f} GB, while serving {serve_peak / 1e9:.2f} "
          f"GB allocated ({smi})", flush=True)
    return {"launches": launches, "rows": {"mvu_int": rows}}


def lm_vlm_phase(dev, smi: str) -> dict:
    """The lm_vlm phase (see the module doc): the reduced Qwen2-VL against
    the JAX package's golden run and its prefix-loss golden, full-width,
    full-depth Qwen2-VL-7B served by ``serve_loop`` on ``mvu_int`` with its
    launches counted, its four projection shapes against the plain version,
    and its QAT loss and gradients behind a 256-patch prefix.  Returns, by
    kernel, the served run's launches and a timing row for each launch."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.launch.serve import Request, prompt_batch, serve_loop
    from repro_torch.models import layers as L, transformer as tf
    from repro_torch.models.model import build
    from repro_torch.tree import flat_leaves

    t_phase = time.perf_counter()
    arch = G.VLM_ARCH
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "lm_vlm: float32 matmuls must not run in TF32 (PyTorch's default is off)")
    torch.cuda.reset_peak_memory_stats()

    # (a) the reduced Qwen2-VL, float32, against the JAX package's golden run
    golden = G.load_golden(arch)
    for backend in G.VARIANTS:
        cfg = G.golden_config(backend, arch)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        if backend != "dense":
            params = L.quantize_model_params(params, backend)
        want = {} if backend == "dense" else {
            "mvu_int": len(L.PROJ_NAMES) * cfg.num_layers * (1 + G.DECODE_STEPS)}
        model = build(cfg, device=dev)
        got = counted(lambda: G.greedy_run(model, params), want,
                      f"lm_vlm: the {arch} golden run ({backend})")
        bad = G.mismatch(golden["variants"][backend], got)
        check(bad is None, f"lm_vlm: the reduced {arch} {backend} model on the card differs "
              f"from the JAX package's golden run: {bad}")
        ref = np.asarray(golden["variants"][backend]["logits"], np.float32)
        print(f"lm_vlm: golden: reduced {cfg.name} {backend} float32 on the card (M-RoPE "
              f"sections {cfg.mrope_sections}), prefill of {G.BATCH} x {G.PROMPT_LEN} + "
              f"{G.DECODE_STEPS} greedy steps: max |logit error| "
              f"{float(np.abs(got['logits'] - ref).max()):.3e} (bound {G.LOGIT_ATOL} x "
              f"{float(np.abs(ref).max()):.4f}), greedy tokens equal the JAX package's "
              f"{got['tokens'].tolist()}; launches {want or 'none'}", flush=True)

    # (b) the loss behind a vision prefix, float32, remat on, against the
    # JAX package's prefix-loss golden: the t, h and w ids all differ there
    qgolden = G.load_qat_golden(arch)
    for backend in G.QAT_VARIANTS:
        cfg = G.qat_config(backend, arch)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        model = build(cfg, device=dev)
        got = counted(lambda: G.qat_run(model, params), {},
                      f"lm_vlm: the prefix-loss golden's loss and backward ({backend})")
        want = qgolden["variants"][backend]
        bad = G.qat_mismatch(want, got)
        check(bad is None, f"lm_vlm: the reduced {backend} model's prefix loss and gradients on "
              f"the card differ from the JAX package's: {bad}")
        wg = want["grads"]
        worst = max(float(np.abs(np.subtract(gr["head"], wg[p]["head"])).max())
                    / wg[p]["max_abs"] for p, gr in got["grads"].items())
        print(f"lm_vlm: prefix-loss golden: reduced {cfg.name} {backend} float32, remat on, "
              f"{G.BATCH} x {G.QAT_SEQ} tokens behind {G.VLM_PREFIX} patches on the card: loss "
              f"{got['loss']:.7f} (JAX {want['loss']:.7f}, |error| "
              f"{abs(got['loss'] - want['loss']):.3e}, bound {G.LOSS_RTOL} x |loss|); "
              f"{len(got['grads'])} gradient leaves within the bounds, worst head error "
              f"{worst:.3e} of the leaf's largest (bound {G.GRAD_ATOL}); no kernel launched",
              flush=True)
    del model, params
    torch.cuda.empty_cache()

    # (c) full width and depth, integer-deployed, served by serve_loop
    cfg = get_config(arch).replace(linear_backend=LM_BACKEND)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    params = model.init(g, quantize=LM_BACKEND)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated()
    proj = {name: blk[name] for blk in (params["layers"]["attn"], params["layers"]["ffn"])
            for name in L.PROJ_NAMES if name in blk}
    check(len(proj) == len(L.PROJ_NAMES) and all(
        set(p) == {"values", "scale"} and p["values"].dtype == torch.int8
        and p["values"].shape[0] == cfg.num_layers for p in proj.values()),
        "lm_vlm: a full-width projection is not integer-deployed int8 on every layer")
    model_bytes = nbytes(flat_leaves(params).values())
    proj_bytes = nbytes(p["values"] for p in proj.values())
    print(f"lm_vlm: full width: {cfg.name} ({cfg.num_layers} layers x {cfg.d_model}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, M-RoPE sections "
          f"{cfg.mrope_sections} theta {cfg.rope_theta:g}, {cfg.activation} d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, untied {not cfg.tie_embeddings}, {cfg.dtype}) drawn on the "
          f"card from seed {LM_SEED} with init(quantize={LM_BACKEND!r}) in {init_s:.2f} s: the "
          f"model {model_bytes / 1e9:.3f} GB ({proj_bytes / 1e9:.3f} GB of int8 projections); "
          f"peak while drawing {draw_peak / 1e9:.2f} GB allocated ({smi})", flush=True)
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(i, p, LM_MAX_NEW) for i, p in enumerate(prompts)]

    groups = [requests()[i:i + LM_BATCH] for i in range(0, LM_REQUESTS, LM_BATCH)]
    group_tokens = [prompt_batch(grp) for grp in groups]
    per_group = len(L.PROJ_NAMES) * cfg.num_layers * (1 + LM_MAX_NEW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = counted(lambda: serve_loop(model, params, requests(), batch=LM_BATCH,
                                      max_len=LM_MAX_LEN),
                   {"mvu_int": per_group * len(groups)},
                   "lm_vlm: serve_loop of Qwen2-VL at full width")
    serve_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    check([r.rid for r in done] == list(range(LM_REQUESTS))
          and all(len(r.out) == LM_MAX_NEW and all(0 <= t < cfg.vocab_size for t in r.out)
                  for r in done),
          "lm_vlm: serve_loop did not answer every request with its tokens in the vocabulary")
    print(f"lm_vlm: serve_loop: {LM_REQUESTS} requests (prompts {lens.tolist()} tokens, text "
          f"only: the served model reads no vision prefix, as the reference's) in "
          f"{len(groups)} groups of {LM_BATCH}, max_new {LM_MAX_NEW}, max_len {LM_MAX_LEN}: "
          f"every request answered; mvu_int launched {per_group * len(groups)} times = "
          f"{len(L.PROJ_NAMES)} projections x {cfg.num_layers} layers x (1 prefill + "
          f"{LM_MAX_NEW} decode steps) x {len(groups)} groups, nothing else; "
          f"{LM_REQUESTS * LM_MAX_NEW / serve_s:.2f} tokens/s over the loop's {serve_s:.3f} s "
          f"(host clock, the first run: no warm-up); peak while serving "
          f"{serve_peak / 1e9:.2f} GB allocated; first tokens {[r.out[:4] for r in done[:2]]} "
          f"({smi})", flush=True)

    # serving times on the host clock, synchronised: group 0's prefill, then
    # its decode steps; a prefill batch carrying a vision prefix is the same
    # prefill (the reference ignores it too)
    toks0 = torch.from_numpy(group_tokens[0])
    pre, dec = [], []
    for _ in range(3):
        state = model.init_decode_state(LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": toks0}, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        first = logits
        for _ in range(LM_MAX_NEW):
            logits, state = model.decode_step(params, state, torch.argmax(logits, -1))
        torch.cuda.synchronize()
        pre.append(t1 - t0)
        dec.append((time.perf_counter() - t1) / LM_MAX_NEW)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (LM_BATCH, cfg.vocab_size),
          f"lm_vlm: full-width logits {tuple(logits.shape)} not finite")
    with_prefix, _ = model.prefill(params, {"tokens": toks0, "prefix_embeds": torch.zeros(
        (LM_BATCH, VLM_PREFIX, cfg.d_model), dtype=torch.bfloat16, device=dev)},
        model.init_decode_state(LM_BATCH, LM_MAX_LEN))
    check(torch.equal(with_prefix, first), "lm_vlm: a prefill batch carrying prefix_embeds "
          "gave other logits than the same tokens alone")
    pre_ms, dec_ms = statistics.median(pre) * 1e3, statistics.median(dec) * 1e3
    print(f"lm_vlm: full width {LM_BACKEND}, group 0 ({LM_BATCH} x {toks0.shape[1]} tokens): "
          f"prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms a step ({LM_BATCH} tokens), "
          f"{LM_BATCH / dec_ms * 1e3:.2f} decode tokens/s, "
          f"{toks0.numel() / pre_ms * 1e3:.1f} prefill tokens/s (host clock, synchronised, "
          f"median of 3 after the served run); a prefill carrying a {VLM_PREFIX}-patch "
          f"prefix_embeds gave the same logits ({smi})", flush=True)

    # (d) the four new mvu_int shapes: layer 0's projections against the
    # plain version at the decode rows and at each group's prefill rows
    ga = torch.Generator(device=dev).manual_seed(LM_SEED + 5)
    m_pre = [t.size for t in group_tokens]
    layer0 = tf.layer(params["layers"], 0)
    timed = projection_rows(layer0, "mvu_int", {LM_BATCH, *m_pre}, ga, "lm_vlm")
    shapes = {name: tuple((layer0["attn"] | layer0["ffn"])[name]["values"].shape)
              for name in L.PROJ_NAMES}
    check(sorted({(k, n) for n, k in shapes.values()}) == sorted(VLM_SHAPES),
          f"lm_vlm: the deployed shapes (K, N) {sorted({(k, n) for n, k in shapes.values()})}, "
          f"want {sorted(VLM_SHAPES)}")
    # a timing row per counted launch: each group's prefill and decode steps
    rows = []
    for m in m_pre:
        for mm, reps in ((m, 1), (LM_BATCH, LM_MAX_NEW)):
            rows += [timed[("mvu_int", mm, n, k)] for n, k in shapes.values()] * (
                cfg.num_layers * reps)
    del model, params, proj, layer0, logits, first, with_prefix, state
    torch.cuda.empty_cache()

    # (e) the QAT loss and its gradients at full width and depth behind the
    # dry run's 256-patch prefix: float bf16 params, W8A8 fake-quant, remat on
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build(cfg, device=dev).init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tokens = np.random.default_rng(LM_SEED + 7).integers(
        0, cfg.vocab_size, (LM_QAT_BATCH, VLM_LOSS_SEQ + 1)).astype(np.int32)
    prefix = torch.randn((LM_QAT_BATCH, VLM_PREFIX, cfg.d_model), generator=g,
                         device=dev).mul_(VLM_PREFIX_SCALE).to(torch.bfloat16)
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "prefix_embeds": prefix}
    model = build(cfg, device=dev)
    check(cfg.remat, "lm_vlm: the full-width loss runs with remat on")

    def step():
        loss, _ = model.loss(params, batch)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    loss, grads = counted(step, {}, "lm_vlm: the full-width prefix loss and backward")
    finite = torch.stack([torch.isfinite(gr).all() for gr in grads]).all()
    ln_v = math.log(cfg.vocab_size)
    check(bool(torch.isfinite(loss)) and 0.5 * ln_v < loss.item() < 2.5 * ln_v and bool(finite)
          and all(gr.shape == t.shape and gr.dtype == t.dtype
                  for gr, t in zip(grads, leaves.values())),
          f"lm_vlm: the full-width prefix loss {loss.item()} is not finite within (0.5, 2.5) x "
          "ln(vocab), or a gradient is not finite or not of its parameter's shape and dtype")
    loss0 = loss.item()
    del loss, grads
    times = []
    for _ in range(VLM_LOSS_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del loss, grads
    loss_peak = torch.cuda.max_memory_allocated()
    print(f"lm_vlm: prefix loss at full width and depth ({cfg.num_layers} layers): {cfg.name} "
          f"float {cfg.dtype} params drawn on the card in {init_s:.2f} s "
          f"({sum(t.numel() for t in leaves.values()):,} parameters, "
          f"{nbytes(leaves.values()) / 1e9:.3f} GB), {LM_BACKEND} fake-quant on every "
          f"projection, remat on; {LM_QAT_BATCH} rows of {VLM_PREFIX} patches (a 16 x 16 grid, "
          f"normal x {VLM_PREFIX_SCALE}, bf16) + {VLM_LOSS_SEQ} predicted tokens: loss "
          f"{loss0:.6f} (ln(vocab) {ln_v:.4f}), finite; {len(leaves)} gradient leaves finite, "
          f"each of its parameter's shape and dtype; no kernel launched; forward + backward "
          f"{', '.join(f'{t:.3f}' for t in times)} ms, median {statistics.median(times):.3f} ms "
          f"(host clock, synchronised, {VLM_LOSS_CALLS} calls after the checked one); peak "
          f"{loss_peak / 1e9:.2f} GB allocated ({smi})", flush=True)
    del model, params, leaves, batch, prefix
    torch.cuda.empty_cache()

    launches = {"mvu_int": per_group * len(groups)}
    check(len(rows) == launches["mvu_int"], "lm_vlm: a row for every launch")
    print(f"lm_vlm: launches of the served run {launches}; kernel ms over them "
          f"{round(sum(r[0] for r in rows), 4)}; phase {time.perf_counter() - t_phase:.2f} s, "
          f"peak while drawing {draw_peak / 1e9:.2f} GB, while serving {serve_peak / 1e9:.2f} "
          f"GB, in the prefix loss {loss_peak / 1e9:.2f} GB allocated ({smi})", flush=True)
    return {"launches": launches, "rows": {"mvu_int": rows}}


def serve_encdec(model, params, requests, enc_embeds, *, batch: int, max_len: int):
    """``serve_loop``'s groups, padding and greedy lockstep decode for an
    encoder-decoder, whose prefill also reads ``enc_embeds`` (batch, T, d):
    the model is served through ``prefill`` and ``decode_step``, as the
    reference's dry run drives it (``serve_loop`` hands ``prefill`` tokens
    alone, and raises ``KeyError`` on it in both packages).  Returns the
    answered requests in order."""
    import torch

    from repro_torch.launch.serve import Request, prompt_batch

    done = []
    for i in range(0, len(requests), batch):
        group = requests[i:i + batch]
        while len(group) < batch:
            group.append(Request(rid=-1, prompt=group[0].prompt, max_new=group[0].max_new))
        toks = torch.from_numpy(prompt_batch(group))
        state = model.init_decode_state(batch, max_len)
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": toks, "enc_embeds": enc_embeds}, state)
        nxt = torch.argmax(logits, -1)
        for _ in range(max(r.max_new for r in group)):
            host = nxt.tolist()
            for j, r in enumerate(group):
                if r.rid >= 0 and len(r.out) < r.max_new:
                    r.out.append(host[j])
            logits, state = model.decode_step(params, state, nxt)
            nxt = torch.argmax(logits, -1)
        t1 = time.perf_counter()
        for r in group:
            if r.rid >= 0:
                r.t_done = t1 - t0
                done.append(r)
    return done


def lm_encdec_phase(dev, smi: str) -> dict:
    """The lm_encdec phase (see the module doc): the reduced whisper-tiny
    against the JAX package's golden run and QAT golden, full-width,
    full-depth whisper-tiny served through ``prefill`` / ``decode_step`` on
    ``mvu_int`` with its launches counted, its three projection shapes
    against the plain version, and its QAT loss and gradients behind 1500
    encoder positions.  Returns, by kernel, the served run's launches and a
    timing row for each launch."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, prompt_batch, serve_loop
    from repro_torch.models import layers as L, transformer as tf
    from repro_torch.models.model import build
    from repro_torch.tree import flat_leaves

    t_phase = time.perf_counter()
    arch = G.ENCDEC_ARCH
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "lm_encdec: float32 matmuls must not run in TF32 (PyTorch's default is off)")
    torch.cuda.reset_peak_memory_stats()

    def launches_a_run(cfg) -> int:
        # a prefill: 6 projections an encoder layer, 10 a decoder layer (self
        # and cross attention, the FFN); a decode step: 10 a decoder layer
        enc, dec = 6 * cfg.enc_layers, 10 * cfg.num_layers
        return enc + dec * (1 + G.DECODE_STEPS)

    # (a) the reduced whisper-tiny, float32, against the JAX package's golden run
    golden = G.load_golden(arch)
    for backend in G.VARIANTS:
        cfg = G.golden_config(backend, arch)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        if backend != "dense":
            params = L.quantize_model_params(params, backend)
        want = {} if backend == "dense" else {"mvu_int": launches_a_run(cfg)}
        model = build(cfg, device=dev)
        got = counted(lambda: G.greedy_run(model, params), want,
                      f"lm_encdec: the {arch} golden run ({backend})")
        bad = G.mismatch(golden["variants"][backend], got)
        check(bad is None, f"lm_encdec: the reduced {arch} {backend} model on the card differs "
              f"from the JAX package's golden run: {bad}")
        ref = np.asarray(golden["variants"][backend]["logits"], np.float32)
        print(f"lm_encdec: golden: reduced {cfg.name} {backend} float32 on the card, prefill "
              f"of {G.BATCH} x {G.PROMPT_LEN} tokens behind {G.BATCH} x {G.ENC_FRAMES} frames "
              f"+ {G.DECODE_STEPS} greedy steps: max |logit error| "
              f"{float(np.abs(got['logits'] - ref).max()):.3e} (bound {G.LOGIT_ATOL} x "
              f"{float(np.abs(ref).max()):.4f}), greedy tokens equal the JAX package's "
              f"{got['tokens'].tolist()}; launches {want or 'none'}", flush=True)

    # (b) the QAT loss and gradients, float32, remat on, against the JAX
    # package's golden
    qgolden = G.load_qat_golden(arch)
    for backend in G.QAT_VARIANTS:
        cfg = G.qat_config(backend, arch)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), dev)
        model = build(cfg, device=dev)
        got = counted(lambda: G.qat_run(model, params), {},
                      f"lm_encdec: the QAT golden's loss and backward ({backend})")
        want = qgolden["variants"][backend]
        bad = G.qat_mismatch(want, got)
        check(bad is None, f"lm_encdec: the reduced {backend} model's loss and gradients on "
              f"the card differ from the JAX package's: {bad}")
        wg = want["grads"]
        worst = max(float(np.abs(np.subtract(gr["head"], wg[p]["head"])).max())
                    / wg[p]["max_abs"] for p, gr in got["grads"].items())
        print(f"lm_encdec: QAT golden: reduced {cfg.name} {backend} float32, remat on, "
              f"{G.BATCH} x {G.QAT_SEQ} tokens behind {G.ENC_FRAMES} frames on the card: loss "
              f"{got['loss']:.7f} (JAX {want['loss']:.7f}, |error| "
              f"{abs(got['loss'] - want['loss']):.3e}, bound {G.LOSS_RTOL} x |loss|); "
              f"{len(got['grads'])} gradient leaves within the bounds, worst head error "
              f"{worst:.3e} of the leaf's largest (bound {G.GRAD_ATOL}); no kernel launched",
              flush=True)
    del model, params
    torch.cuda.empty_cache()

    # (c) full width and depth, integer-deployed, served through prefill
    # (with the frame embeddings) and decode_step
    cfg = get_config(arch).replace(linear_backend=LM_BACKEND)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    params = model.init(g, quantize=LM_BACKEND)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated()
    stacks = params["encdec"]
    proj = {f"{s}/{node}/{name}": leaf for s, nodes in (("enc", ("attn", "ffn")),
                                                       ("dec", ("attn", "xattn", "ffn")))
            for node in nodes for name, leaf in stacks[s][node].items()}
    check(len(proj) == 16 and all(
        set(p) == {"values", "scale"} and p["values"].dtype == torch.int8
        and p["values"].shape[0] == (cfg.enc_layers if k.startswith("enc") else cfg.num_layers)
        for k, p in proj.items()),
        "lm_encdec: a full-width projection is not integer-deployed int8 on every layer")
    model_bytes = nbytes(flat_leaves(params).values())
    proj_bytes = nbytes(p["values"] for p in proj.values())
    print(f"lm_encdec: full width: {cfg.name} ({cfg.enc_layers} encoder + {cfg.num_layers} "
          f"decoder layers x {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, "
          f"{cfg.activation} d_ff {cfg.d_ff}, {cfg.norm}, vocab {cfg.vocab_size}, untied "
          f"{not cfg.tie_embeddings}, {cfg.dtype}) drawn on the card from seed {LM_SEED} with "
          f"init(quantize={LM_BACKEND!r}) in {init_s:.2f} s: the model "
          f"{model_bytes / 1e9:.4f} GB ({proj_bytes / 1e9:.4f} GB of int8 projections); "
          f"peak while drawing {draw_peak / 1e9:.3f} GB allocated ({smi})", flush=True)
    enc = torch.randn((LM_BATCH, ENCDEC_FRAMES, cfg.d_model), generator=g, device=dev).mul_(
        ENCDEC_SCALE).to(torch.bfloat16)
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(i, p, LM_MAX_NEW) for i, p in enumerate(prompts)]

    groups = [requests()[i:i + LM_BATCH] for i in range(0, LM_REQUESTS, LM_BATCH)]
    group_tokens = [prompt_batch(grp) for grp in groups]
    check(all(t.shape[1] + LM_MAX_NEW <= LM_MAX_LEN for t in group_tokens),
          "lm_encdec: a group's prompt and new tokens do not fit max_len")
    pre_launches = 6 * cfg.enc_layers + 10 * cfg.num_layers
    step_launches = 10 * cfg.num_layers
    per_group = pre_launches + LM_MAX_NEW * step_launches
    ops.reset_launch_counts()
    try:
        serve_loop(model, params, requests()[:1], batch=LM_BATCH, max_len=LM_MAX_LEN)
        raised = None
    except KeyError as e:
        raised = e
    torch.cuda.synchronize()
    check(raised is not None and "enc_embeds" in str(raised)
          and not any(ops.launch_counts().values()),
          f"lm_encdec: serve_loop on the encoder-decoder gave {raised!r}, want KeyError "
          "'enc_embeds' (the reference's) before any launch")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = counted(lambda: serve_encdec(model, params, requests(), enc, batch=LM_BATCH,
                                        max_len=LM_MAX_LEN),
                   {"mvu_int": per_group * len(groups)},
                   "lm_encdec: whisper-tiny served at full width")
    serve_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    check([r.rid for r in done] == list(range(LM_REQUESTS))
          and all(len(r.out) == LM_MAX_NEW and all(0 <= t < cfg.vocab_size for t in r.out)
                  for r in done),
          "lm_encdec: a request was not answered with its tokens in the vocabulary")
    print(f"lm_encdec: served: {LM_REQUESTS} requests (prompts {lens.tolist()} tokens, each "
          f"group behind {LM_BATCH} x {ENCDEC_FRAMES} seeded frame embeddings, normal x "
          f"{ENCDEC_SCALE}, bf16) in {len(groups)} groups of {LM_BATCH} through prefill + "
          f"decode_step (serve_loop raises KeyError 'enc_embeds', as the reference's), "
          f"max_new {LM_MAX_NEW}, max_len {LM_MAX_LEN}: every request answered; mvu_int "
          f"launched {per_group * len(groups)} times = ({pre_launches} a prefill + "
          f"{LM_MAX_NEW} x {step_launches} a decode step) x {len(groups)} groups, nothing "
          f"else; {LM_REQUESTS * LM_MAX_NEW / serve_s:.2f} tokens/s over the run's "
          f"{serve_s:.3f} s (host clock, the first run: no warm-up); peak while serving "
          f"{serve_peak / 1e9:.3f} GB allocated; first tokens {[r.out[:4] for r in done[:2]]} "
          f"({smi})", flush=True)

    # serving times on the host clock, synchronised: group 0's encoder, its
    # whole prefill, then its decode steps
    toks0 = torch.from_numpy(group_tokens[0])
    pos_enc = torch.arange(ENCDEC_FRAMES, dtype=torch.int32, device=dev)[None].expand(
        LM_BATCH, ENCDEC_FRAMES)
    enc_t, pre, dec = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc_out = tf.encoder_forward(stacks, cfg, enc, pos_enc)
        torch.cuda.synchronize()
        enc_t.append(time.perf_counter() - t0)
        state = model.init_decode_state(LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": toks0, "enc_embeds": enc}, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(LM_MAX_NEW):
            logits, state = model.decode_step(params, state, torch.argmax(logits, -1))
        torch.cuda.synchronize()
        pre.append(t1 - t0)
        dec.append((time.perf_counter() - t1) / LM_MAX_NEW)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
          and torch.equal(state["enc_out"], enc_out),
          f"lm_encdec: full-width logits {tuple(logits.shape)} not finite, or the state's "
          "enc_out is not the encoder's output")
    enc_ms, pre_ms, dec_ms = (statistics.median(v) * 1e3 for v in (enc_t, pre, dec))
    print(f"lm_encdec: full width {LM_BACKEND}, group 0 ({LM_BATCH} x {toks0.shape[1]} tokens "
          f"behind {LM_BATCH} x {ENCDEC_FRAMES} frames): encoder {enc_ms:.3f} ms, prefill "
          f"(encoder included) {pre_ms:.3f} ms, decode {dec_ms:.3f} ms a step ({LM_BATCH} "
          f"tokens), {LM_BATCH / dec_ms * 1e3:.2f} decode tokens/s (host clock, synchronised, "
          f"median of 3 after the served run) ({smi})", flush=True)

    # (d) the three new mvu_int shapes: the decoder's layer 0 projections
    # (its self-attention's and the cross attention's share a shape)
    # against the plain version at the decode rows, each group's decoder
    # prefill rows and the encoder's rows
    ga = torch.Generator(device=dev).manual_seed(LM_SEED + 9)
    m_pre = [t.size for t in group_tokens]
    m_enc = LM_BATCH * ENCDEC_FRAMES
    dec0 = tf.layer(stacks["dec"], 0)
    timed = projection_rows({"attn": dec0["attn"], "ffn": dec0["ffn"]}, "mvu_int",
                            {LM_BATCH, *m_pre, m_enc}, ga, "lm_encdec")
    shape = {name: tuple(node["values"].shape) for name, node in
             (dec0["attn"] | dec0["ffn"]).items()}
    check(sorted({(k, n) for n, k in shape.values()}) == sorted(ENCDEC_SHAPES)
          and all(tuple(v["values"].shape) == shape[n] for n, v in dec0["xattn"].items()),
          f"lm_encdec: the deployed shapes (K, N) {sorted({(k, n) for n, k in shape.values()})}, "
          f"want {sorted(ENCDEC_SHAPES)}")
    at = lambda m, names: [timed[("mvu_int", m, *shape[nm])] for nm in names]
    attn, ffn2 = ("wq", "wk", "wv", "wo"), ("w_up", "w_down")
    # a timing row per counted launch, in the order the run launches them
    rows = []
    for m in m_pre:
        rows += at(m_enc, attn + ffn2) * cfg.enc_layers
        rows += (at(m, attn) + at(m, ("wq",)) + at(m_enc, ("wk", "wv")) + at(m, ("wo",))
                 + at(m, ffn2)) * cfg.num_layers
        step = (at(LM_BATCH, attn) + at(LM_BATCH, ("wq",)) + at(m_enc, ("wk", "wv"))
                + at(LM_BATCH, ("wo",)) + at(LM_BATCH, ffn2)) * cfg.num_layers
        rows += step * LM_MAX_NEW
    memory_ms = sum(r[0] for r in at(m_enc, ("wk", "wv"))) * cfg.num_layers
    step_ms = sum(r[0] for r in step)
    print(f"lm_encdec: a decode step's {step_launches} mvu_int launches take {step_ms:.4f} ms "
          f"of kernel time (CUDA events, each launch shape's median); the cross attention's "
          f"{2 * cfg.num_layers} launches at M = {m_enc} on the encoder memory (wk, wv, every "
          f"step: no cross K/V cache, as in the reference) {memory_ms:.4f} ms of it, "
          f"{memory_ms / step_ms:.3f} of the kernel time and {memory_ms / dec_ms:.4f} of the "
          f"{dec_ms:.3f} ms step on the host clock ({smi})", flush=True)
    del model, params, stacks, proj, dec0, logits, state, enc_out
    torch.cuda.empty_cache()

    # (e) the QAT loss and its gradients at full width and depth: float bf16
    # params, W8A8 fake-quant, remat on, the dry run's train batch of tokens
    # beside frame embeddings
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, device=dev)
    params = model.init(g)
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tokens = np.random.default_rng(LM_SEED + 7).integers(
        0, cfg.vocab_size, (LM_QAT_BATCH, LM_QAT_SEQ + 1)).astype(np.int32)
    frames = torch.randn((LM_QAT_BATCH, ENCDEC_FRAMES, cfg.d_model), generator=g,
                         device=dev).mul_(ENCDEC_SCALE).to(torch.bfloat16)
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "enc_embeds": frames}
    check(cfg.remat, "lm_encdec: the full-width loss runs with remat on")

    def step():
        loss, _ = model.loss(params, batch)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    loss, grads = counted(step, {}, "lm_encdec: the full-width loss and backward")
    finite = torch.stack([torch.isfinite(gr).all() for gr in grads]).all()
    ln_v = math.log(cfg.vocab_size)
    check(bool(torch.isfinite(loss)) and 0.5 * ln_v < loss.item() < 2.5 * ln_v and bool(finite)
          and all(gr.shape == t.shape and gr.dtype == t.dtype
                  for gr, t in zip(grads, leaves.values())),
          f"lm_encdec: the full-width loss {loss.item()} is not finite within (0.5, 2.5) x "
          "ln(vocab), or a gradient is not finite or not of its parameter's shape and dtype")
    loss0 = loss.item()
    del loss, grads
    times = []
    for _ in range(ENCDEC_LOSS_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del loss, grads
    loss_peak = torch.cuda.max_memory_allocated()
    print(f"lm_encdec: loss at full width and depth: {cfg.name} float {cfg.dtype} params "
          f"({sum(t.numel() for t in leaves.values()):,} parameters), {LM_BACKEND} fake-quant "
          f"on every projection, remat on; {LM_QAT_BATCH} rows of {ENCDEC_FRAMES} frames "
          f"(normal x {ENCDEC_SCALE}, bf16) + {LM_QAT_SEQ} predicted tokens: loss {loss0:.6f} "
          f"(ln(vocab) {ln_v:.4f}), finite; {len(leaves)} gradient leaves finite, each of its "
          f"parameter's shape and dtype; no kernel launched; forward + backward "
          f"{', '.join(f'{t:.3f}' for t in times)} ms, median {statistics.median(times):.3f} ms "
          f"(host clock, synchronised, {ENCDEC_LOSS_CALLS} calls after the checked one); peak "
          f"{loss_peak / 1e9:.3f} GB allocated ({smi})", flush=True)
    del model, params, leaves, batch, frames
    torch.cuda.empty_cache()

    launches = {"mvu_int": per_group * len(groups)}
    check(len(rows) == launches["mvu_int"], "lm_encdec: a row for every launch")
    print(f"lm_encdec: launches of the served run {launches}; kernel ms over them "
          f"{round(sum(r[0] for r in rows), 4)}; phase {time.perf_counter() - t_phase:.2f} s, "
          f"peak while drawing {draw_peak / 1e9:.3f} GB, while serving {serve_peak / 1e9:.3f} "
          f"GB, in the loss {loss_peak / 1e9:.3f} GB allocated ({smi})", flush=True)
    return {"launches": launches, "rows": {"mvu_int": rows}}


def bound_of(nbytes: int, ops: int) -> tuple[float, str]:
    """Least ms the card needs: ``nbytes`` at the HBM rate or ``ops`` at the
    int8 tensor-core peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(m: int, n: int, k: int, epilogue_bytes: int, a_bytes: int = 4) -> tuple[float, str]:
    """Least ms for one ``mvu_int`` launch: read A (``a_bytes`` an element:
    int32 where the path hands the kernel int32, 1 where it hands int8,
    as ``quantized_linear`` does) and W (int8) and the epilogue operand
    once, write the (M, N) 4-byte output once."""
    return bound_of(m * k * a_bytes + n * k + epilogue_bytes + m * n * 4, 2 * m * n * k)


def new_kernel_case(name, m, n, k, g, dev):
    """Operands of one launch of the xnor, binary or packed kernels:
    ``(wrapper, plain, args, a_f, w_f, nbytes)`` -- the wrapper and plain
    version take ``*args`` plus the epilogue; ``a_f @ w_f.T`` (float32, the
    +/-1 or integer values the kernel multiplies) is the yardstick's
    product; ``nbytes`` counts the activation and weight bytes the launch
    must read."""
    import torch

    from repro_torch.kernels import mvu_binary as B, mvu_packed as P, mvu_xnor as X
    from repro_torch.kernels import packing
    from repro_torch.kernels._common import narrow_int8

    a = torch.randint(-8, 300, (m, k), generator=g, dtype=torch.int32)
    bits = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8)
    bipolar = 2 * bits.float() - 1
    if name == "mvu_xnor":
        ap, wp = packing.pack_bits(a), packing.pack_bits(bits)
        fn, plain, args = X.mvu_xnor, X.mvu_xnor_plain, (ap, wp, k)
        a_f, w_f, nbytes = 2 * (a & 1).float() - 1, bipolar, 4 * (ap.numel() + wp.numel())
    elif name == XNOR_PATH_ENTRY:  # the activations as int32, packed in the kernel
        wp = packing.pack_bits(bits)
        fn, plain, args = X.mvu_xnor_bits, X.mvu_xnor_bits_plain, (a, wp)
        a_f, w_f, nbytes = 2 * (a & 1).float() - 1, bipolar, 4 * (a.numel() + wp.numel())
    elif name == "mvu_binary":
        fn, plain, args = B.mvu_binary, B.mvu_binary_plain, (a, bits)
        a_f, w_f, nbytes = a.float(), bipolar, 4 * a.numel() + bits.numel()
    elif name == "mvu_binary_packed":
        wp = packing.pack_bits(bits)
        fn, plain, args = P.mvu_binary_packed, P.mvu_binary_packed_plain, (a, wp, k)
        a_f, w_f, nbytes = narrow_int8(a).float(), bipolar, 4 * (a.numel() + wp.numel())
    else:
        w2 = torch.randint(-2, 2, (n, k), generator=g, dtype=torch.int8)
        wp = packing.pack_int2(w2)
        fn, plain, args = P.mvu_int2_packed, P.mvu_int2_packed_plain, (a, wp, k)
        a_f, w_f, nbytes = narrow_int8(a).float(), w2.float(), 4 * a.numel() + wp.numel()
    args = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in args)
    return fn, plain, args, a_f.to(dev), w_f.to(dev), nbytes


def conv_shapes(spec) -> list[tuple[int, int, int]]:
    """(H = W, C, N) of each 3x3 / stride 1 / pad 0 conv layer of a CNV spec."""
    shapes, size, cin = [], spec.image, 3
    for i, cout in enumerate(spec.channels):
        shapes.append((size, cin, cout))
        size, cin = size - 2, cout
        if i in spec.pool_after:
            size //= 2
    return shapes


def dense_shapes(spec) -> list[tuple[int, int]]:
    """(N, K) of each dense layer of a CNV spec, the flattened last conv
    output first."""
    h, _, _ = conv_shapes(spec)[-1]
    k = (h - 2) ** 2 * spec.channels[-1]
    shapes = []
    for n in spec.fc:
        shapes.append((n, k))
        k = n
    return shapes


def conv_case(mode, b, h, c, n, kd, g, dev, hi=300, width=None):
    """Operands of one ``conv_mvu`` launch on a (b, h, width, c) image
    (width defaults to h):
    ``(x, w, x_f, w_f, nbytes)`` -- the image (int32; {0,1} for xnor,
    [-8, hi) otherwise), the mode's weight storage, the float32 NCHW image
    and (N, C, kd, kd) weights the yardstick convolves (the int8-narrowed
    or +/-1 values the kernel multiplies), and the bytes the launch must
    read (image and weights)."""
    import torch

    from repro_torch.kernels import packing
    from repro_torch.kernels._common import narrow_int8

    k = kd * kd * c
    shape = (b, h, width or h, c)
    if mode == "xnor":
        x = torch.randint(0, 2, shape, generator=g, dtype=torch.int32)
        x_f = 2 * x.float() - 1
    else:
        x = torch.randint(-8, hi, shape, generator=g, dtype=torch.int32)
        x_f = narrow_int8(x).float()
    if mode == "standard":
        w = torch.randint(-2, 2, (n, k), generator=g, dtype=torch.int8)
        w_f = w.float()
    else:
        w = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8)
        w_f = 2 * w.float() - 1
        if mode == "xnor":
            w = packing.pack_bits(w)
    nbytes = 4 * x.numel() + w.numel() * w.element_size()
    w_f = w_f.reshape(n, kd, kd, c).permute(0, 3, 1, 2).contiguous()
    return (x.to(dev), w.to(dev), x_f.permute(0, 3, 1, 2).contiguous().to(dev),
            w_f.to(dev), nbytes)


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def hand_kernel(name: str) -> str | None:
    """The hand kernel (launch counter name) of a traced device function."""
    flat = name.replace(" ", "")
    return next((k for sub, k in TRACE_KERNELS.items() if sub in flat), None)


def trace_acc(acc, x, label: str) -> dict:
    """One ``torch.profiler`` trace of ``acc(x)`` after two warm-up calls:
    the window, device busy time and idle share, the host split, the top
    device ops, the longest idle gaps and the hand kernels' events beside
    their launch counters.  Saves the Chrome trace under ``TRACE_DIR``.
    The active step sleeps ``TRACE_PAUSE_S`` before and after the call."""
    import gzip

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from repro_torch.kernels import ops

    for _ in range(2):
        acc(x)
    torch.cuda.synchronize()
    # one traced warm-up step whose events are dropped: the first launch of
    # each kernel under a fresh trace pays CUPTI's set-up
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"trace_{label}.json.gz")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for step in range(2):
            if step == 1:
                ops.reset_launch_counts()
                time.sleep(TRACE_PAUSE_S)
            t0 = time.perf_counter()
            with record_function("chip_smoke.acc"):
                acc(x)
                torch.cuda.synchronize()
            host_window_ms = (time.perf_counter() - t0) * 1e3
            if step == 1:
                time.sleep(TRACE_PAUSE_S)
            prof.step()
    counts = ops.launch_counts()
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]

    def cat(e):
        return str(e.get("cat", "")).lower()

    def span(e):
        return (float(e["ts"]), float(e["ts"]) + float(e["dur"]))

    marks = [e for e in events if e.get("name") == "chip_smoke.acc" and cat(e) == "user_annotation"]
    check(len(marks) == 1, f"trace {label}: {len(marks)} chip_smoke.acc annotations, want 1")
    w0, w1 = span(marks[0])
    device = [e for e in events if cat(e) in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if cat(e) == "kernel"]
    busy = union(span(e) for e in device)
    busy_us = covered(busy, w0, w1)
    cpu_ops = [span(e) for e in events if cat(e) == "cpu_op"]
    runtime = [span(e) for e in events if cat(e) in ("cuda_runtime", "cuda_driver")]
    torch_us = covered(cpu_ops, w0, w1)
    runtime_us = covered(cpu_ops + runtime, w0, w1) - torch_us
    # the hand kernels the trace saw, against the wrappers' counters
    seen = dict.fromkeys(counts, 0)
    for e in kernels:
        if (k := hand_kernel(e["name"])) is not None:
            seen[k] += 1
    # idle gaps inside the window, each with the host event under most of it
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, min(a, w1)))
        prev = max(prev, b)
    host = [(span(e), e["name"]) for e in events
            if cat(e) in ("cpu_op", "cuda_runtime", "cuda_driver")]

    def under(g0, g1):
        best = max(((min(b, g1) - max(a, g0), -(b - a), name) for (a, b), name in host
                    if min(b, g1) > max(a, g0)), default=None)
        return (best[2], best[0]) if best else ("(no traced host op: Python)", 0.0)

    totals: dict[str, list] = {}
    for e in device:
        t = totals.setdefault(e["name"], [0.0, 0])
        t[0] += float(e["dur"])
        t[1] += 1
    # the host's torch ops not nested in another: where torch's own time goes
    host_ops: dict[str, list] = {}
    top_end = float("-inf")
    for e in sorted((e for e in events if cat(e) == "cpu_op"),
                    key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        a, b = span(e)
        if a >= top_end and w0 <= a < w1:
            top_end = b
            t = host_ops.setdefault(e["name"], [0.0, 0])
            t[0] += b - a
            t[1] += 1
    return {
        "host_window_ms": host_window_ms, "window_us": w1 - w0, "busy_us": busy_us,
        "idle_share": 1.0 - busy_us / (w1 - w0), "torch_ops_us": torch_us,
        "runtime_us": runtime_us, "python_us": (w1 - w0) - torch_us - runtime_us,
        "device_events": len(device), "counts": counts, "seen": seen,
        "top": sorted(totals.items(), key=lambda kv: -kv[1][0])[:5],
        "host_ops": sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:6],
        "gaps": [(g1 - g0, g0 - w0, *under(g0, g1))
                 for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:5]],
        "n_gaps": len(gaps), "path": path, "n_events": len(events),
        "kernel_streams": {(e.get("args") or {}).get("stream") for e in kernels},
        "kernel_sum_us": sum(float(e["dur"]) for e in kernels),
        "by_cat": {c: sum(1 for e in events if cat(e) == c)
                   for c in sorted({cat(e) for e in events})},
    }


def take_trace(acc, xp, name: str) -> dict:
    """``trace_acc`` of ``acc(xp)``, saved as ``chiprun_out/trace_<name,
    spaces as _>.json.gz``, whose hand-kernel events must equal the launch
    counters of the traced call.

    A trace that holds no device event at all while kernels launched is
    reported with what it did hold, counted in ``TRACE_RETAKES`` and taken
    once more; a second such trace in one run fails the script.  So is a
    trace that holds some of the counted hand-kernel events and none beyond
    them; its retake must hold them all.  Both were seen when the traced
    call began at the profiler's window: the events whose card timestamps
    fell before the window on the host clock were dropped.
    ``TRACE_PAUSE_S`` now keeps the call clear of both ends of the window."""
    TRACES.append(name)
    r = trace_acc(acc, xp, name.replace(" ", "_"))
    if r["device_events"] == 0 and any(r["counts"].values()):
        TRACE_RETAKES.append(name)
        print(f"trace: {name}: RETAKE {len(TRACE_RETAKES)}: the trace holds no device event "
              f"while {sum(r['counts'].values())} kernels launched; it holds "
              f"{r['n_events']} complete events by category {r['by_cat']}", flush=True)
        check(sum(not t.endswith(" (partial)") for t in TRACE_RETAKES) == 1,
              f"trace {name}: a second trace without device events in this run "
              f"({TRACE_RETAKES}): CUPTI is not delivering")
        r = trace_acc(acc, xp, name.replace(" ", "_"))
    elif r["seen"] != r["counts"] and all(r["seen"][k] <= n for k, n in r["counts"].items()):
        TRACE_RETAKES.append(f"{name} (partial)")
        print(f"trace: {name}: RETAKE {len(TRACE_RETAKES)}: the trace holds the hand-kernel "
              f"events {r['seen']} of the counted {r['counts']} ({r['device_events']} device "
              f"events, {r['n_events']} complete events by category {r['by_cat']})", flush=True)
        r = trace_acc(acc, xp, name.replace(" ", "_"))
    check(r["seen"] == r["counts"], f"trace {name}: the trace's hand-kernel events "
          f"{r['seen']} differ from the launch counters {r['counts']} (does CUPTI see "
          "the ctypes launches?)")
    return r


def report_trace(acc, xp, name: str) -> None:
    """The trace phase's lines for one ``acc(x)`` (see ``take_trace``),
    each starting ``trace: <name>``."""
    untraced = acc_seconds(acc, xp)
    r = take_trace(acc, xp, name)
    print(f"trace: {name} batch {xp.shape[0]}: window "
          f"{r['host_window_ms']:.3f} ms host clock ({r['window_us'] / 1e3:.3f} ms in the "
          f"trace; untraced acc(x) {untraced * 1e3:.3f} ms, median of 7); device busy "
          f"{r['busy_us'] / 1e3:.4f} ms ({r['device_events']} device events); device "
          f"idle share {r['idle_share'] * 100:.2f}% (against the untraced acc(x) time: "
          f"{(1 - r['busy_us'] / 1e3 / (untraced * 1e3)) * 100:.2f}%)", flush=True)
    print(f"trace: {name} host split of the window: torch ops "
          f"{r['torch_ops_us'] / 1e3:.3f} ms, CUDA runtime calls outside them "
          f"{r['runtime_us'] / 1e3:.3f} ms, no traced op (Python: stage loop, wrapper "
          f"checks, ctypes) {r['python_us'] / 1e3:.3f} ms", flush=True)
    print(f"trace: {name} top-level torch ops on the host: " + ", ".join(
        f"{op} {us / 1e3:.3f} ms in {n}" for op, (us, n) in r["host_ops"]), flush=True)
    print(f"trace: {name} hand-kernel events equal the launch counters: "
          f"{ {k: v for k, v in r['seen'].items() if v} }", flush=True)
    for op, (us, n) in r["top"]:
        print(f"trace: {name} top device op: {us / 1e3:.4f} ms in {n} events: "
              f"{op[:160]}", flush=True)
    print(f"trace: {name} {r['n_gaps']} idle gaps; the five longest:", flush=True)
    for dur, at, host_op, host_us in r["gaps"]:
        print(f"trace: {name} gap {dur:.1f} us at +{at:.1f} us: {host_op[:100]} "
              f"({host_us:.1f} us of it)", flush=True)
    print(f"trace: {name} Chrome trace saved to {os.path.relpath(r['path'], HERE)}",
          flush=True)


def main() -> int:
    import torch

    import torch.nn.functional as F

    from repro_torch.build import build
    from repro_torch.configs import cnv_bnn, golden as golden_mod, nid_mlp, residual_mlp
    from repro_torch.core import dataflow
    from repro_torch.core.engine import FusedEngine
    from repro_torch.data import nid
    from repro_torch.telemetry import DriftMonitor, Tracer
    import torch_random_dag
    from repro_torch.kernels import _cuda, dense_mvu, ops, packing
    from repro_torch.kernels import mvu_binary as B, mvu_int as K, mvu_packed as P
    from repro_torch.kernels import swu_mvu as C

    path_nk = sorted({(n, k) for k, n, _, _ in nid_mlp.LAYERS}, reverse=True)
    cnv_golden = cnv_bnn.load_golden()
    cnv_dense = dense_shapes(cnv_bnn.FULL)

    def dense_cases(name: str, ms) -> list[tuple[int, int, int, int]]:
        """(M, N, K, T) of each timed launch of a dense kernel: the NID layers
        at every M of ``ms`` (T = 3 thresholds; the 1-wide head takes the
        scale, T = 0), then, for the CNV variant that runs the kernel, its
        dense layers at M = CNV_DENSE_M (T = 2^act_bits - 1; the
        classifier head takes the scale)."""
        cases = [(m, n, k, 3 if n > 1 else 0) for n, k in path_nk for m in ms]
        for gd in cnv_golden.values():
            if ops.kernel_name(gd["build"]["mode"]) == COUNTER.get(name, name):
                t = 2 ** gd["build"]["act_bits"] - 1
                cases += [(CNV_DENSE_M, n, k, t if i < len(cnv_dense) - 1 else 0)
                          for i, (n, k) in enumerate(cnv_dense)]
        return cases

    # ------------------------------------------------------------ 1. env
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, {smi}", flush=True)
    # the yardsticks in full float32: cuDNN convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("env: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False (float32 yardsticks)", flush=True)

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    libs = _cuda.build_all(ops.LIBRARIES)
    print(f"build: {', '.join(os.path.relpath(p, HERE) for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)", flush=True)
    ptxas = {}  # kernel instance (demangled) -> its ptxas line
    for lib in ops.LIBRARIES:
        for line in ptxas_lines(lib.report()):
            ptxas[line.split(": ")[0]] = line
            print(f"build: ptxas {lib.source}: {line}", flush=True)

    # --------------------------------------------------------- 3. kernel
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    max_err = dict.fromkeys(KERNELS, 0.0)  # by kernel: both xnor entries in mvu_xnor's
    checked = dict.fromkeys(KERNELS, 0)
    # (kernel, m, n, k) -> (kernel, plain, library, bound) ms on the layer's own
    # epilogue, and what bounds it ("bytes" or "operations")
    timing = {}

    def err(got, want):
        return (got.double() - want.double()).abs().max().item() if got.numel() else 0.0

    for m, n, k, n_thr in dense_cases("mvu_int", KERNEL_MS):
        thr = torch.sort(torch.randint(-300, 300, (n, n_thr or 3), generator=g,
                                       dtype=torch.int32), dim=1).values.to(dev)
        scale = (torch.rand(n, generator=g) + 0.01).to(dev)
        a = torch.randint(0, 4, (m, k), generator=g, dtype=torch.int32).to(dev)
        pt = path_tile("mvu_int", n, k)  # the layer's folding's tile, as the path launches it
        for lo, hi in ((-1, 2), (-128, 128)):
            w = torch.randint(lo, hi, (n, k), generator=g, dtype=torch.int8).to(dev)
            for t, s in ((None, None), (thr, None), (None, scale)):
                got = K.mvu_int(a, w, t, s, **pt)
                want = K.mvu_int_plain(a, w, t, s)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"mvu_int != mvu_int_plain at M={m} N={n} K={k} "
                      f"w in [{lo},{hi}) thresholds={t is not None} scale={s is not None}")
                max_err["mvu_int"] = max(max_err["mvu_int"], err(got, want))
                checked["mvu_int"] += 1
        # time the layer as the path runs it: 2-bit weights, its own epilogue
        w = torch.randint(-1, 2, (n, k), generator=g, dtype=torch.int8).to(dev)
        t, s = (thr, None) if n_thr else (None, scale)
        af, wf = a.float(), w.float()
        tf = None if t is None else t.float()

        def library(af=af, wf=wf, tf=tf, s=s):
            c = torch.matmul(af, wf.T)
            return ((c[:, :, None] >= tf[None]).sum(-1, dtype=torch.int32)
                    if tf is not None else c * s)

        check(torch.equal(library(), K.mvu_int(a, w, t, s, **pt)),
              f"the float32 yardstick disagrees with the kernel at M={m} N={n} K={k}")
        kms = device_ms(lambda: K.mvu_int(a, w, t, s, **pt), reps=100)
        pms = device_ms(lambda: K.mvu_int_plain(a, w, t, s), reps=10)
        lms = device_ms(library, reps=100)
        bms, bby = bound(m, n, k, t.numel() * 4 if t is not None else s.numel() * 4)
        timing[("mvu_int", m, n, k)] = (kms, pms, lms, bms, bby)
        print(f"kernel: mvu_int M={m} N={n} K={k} "
              f"{f'{n_thr} thresholds' if t is not None else 'scale'}: "
              f"ms={kms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
              f"bound_ms={bms:.6f} ({bby}) {dense_plan_text('mvu_int', m, n, k, **pt)}",
              flush=True)

    for name in ("mvu_xnor", XNOR_PATH_ENTRY, "mvu_binary", "mvu_binary_packed",
                 "mvu_int2_packed"):
        kernel = COUNTER.get(name, name)
        for m, n, k, n_thr in dense_cases(name, NEW_KERNEL_MS):
            span = k if kernel == "mvu_xnor" else 300 * k  # an xnor dot lies in [-K, K]
            thr = torch.sort(torch.randint(-span, span, (n, n_thr or 3), generator=g,
                                           dtype=torch.int32), dim=1).values.to(dev)
            scale = (torch.rand(n, generator=g) + 0.01).to(dev)
            fn, plain, args, af, wf, nbytes = new_kernel_case(name, m, n, k, g, dev)
            pt = path_tile(name, n, k)
            for t, s in ((None, None), (thr, None), (None, scale)):
                got = fn(*args, t, s, **pt)
                want = plain(*args, t, s)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"{name} != its plain version at M={m} N={n} K={k} "
                      f"thresholds={t is not None} scale={s is not None}")
                max_err[kernel] = max(max_err[kernel], err(got, want))
                checked[kernel] += 1
            t, s = (thr, None) if n_thr else (None, scale)
            tf = None if t is None else t.float()

            def library(af=af, wf=wf, tf=tf, s=s):
                c = torch.matmul(af, wf.T)
                return ((c[:, :, None] >= tf[None]).sum(-1, dtype=torch.int32)
                        if tf is not None else c * s)

            check(torch.equal(library(), fn(*args, t, s, **pt)),
                  f"the float32 yardstick disagrees with {name} at M={m} N={n} K={k}")
            kms = device_ms(lambda: fn(*args, t, s, **pt), reps=100)
            pms = device_ms(lambda: plain(*args, t, s), reps=10)
            lms = device_ms(library, reps=100)
            bms, bby = bound_of(nbytes + (t.numel() if t is not None else n) * 4
                                + m * n * 4, 2 * m * n * k)
            timing[(name, m, n, k)] = (kms, pms, lms, bms, bby)
            print(f"kernel: {name} M={m} N={n} K={k} "
                  f"{f'{n_thr} thresholds' if t is not None else 'scale'}: "
                  f"ms={kms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
                  f"bound_ms={bms:.6f} ({bby}) {dense_plan_text(name, m, n, k, **pt)}",
                  flush=True)

    # the dense core: both arrangements, split K or not, at a ragged N
    n = 10
    for name in dense_mvu.CODING:
        kernel = COUNTER.get(name, name)
        for m in DENSE_MS:
            for k in DENSE_KS:
                # the dot's range: full int8 products, +/-1 (xnor), else 300 a synapse
                span = {"mvu_int": 128 * 300 * k, "mvu_xnor": k}.get(kernel, 300 * k)
                thr = torch.sort(torch.randint(-span, span, (n, 3), generator=g,
                                               dtype=torch.int32), dim=1).values.to(dev)
                scale = (torch.rand(n, generator=g) + 0.01).to(dev)
                fn, plain, args = dense_case(name, m, n, k, g, dev)
                for t, s in ((None, None), (thr, None), (None, scale)):
                    got, want = fn(*args, t, s), plain(*args, t, s)
                    torch.cuda.synchronize()
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"{name} != its plain version at M={m} N={n} K={k} "
                          f"({dense_plan_text(name, m, n, k)}) "
                          f"thresholds={t is not None} scale={s is not None}")
                    max_err[kernel] = max(max_err[kernel], err(got, want))
                    checked[kernel] += 1
    # the uint32 wrap: activations near 2^30, any int8 weight, both arrangements
    for name, fn, plain in (("mvu_int", K.mvu_int, K.mvu_int_plain),
                            ("mvu_binary", B.mvu_binary, B.mvu_binary_plain)):
        for m in (1, 128):
            a = torch.randint(2**30 - 2**20, 2**30, (m, 600), generator=g, dtype=torch.int32)
            a[:, ::3] *= -1
            w = torch.randint(-128, 128, (33, 600), generator=g, dtype=torch.int8)
            a, w = a.to(dev), w.to(dev)
            got, want = fn(a, w), plain(a, w)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} does not wrap mod 2^32 like its "
                  f"plain version at M={m} with activations near 2^30")
            max_err[name] = max(max_err[name], err(got, want))
            checked[name] += 1
    # bitplanes whose pad bits are all 1, two words more a row than K needs
    for m in (1, 9, 128):
        for k in (27, 600):
            a = torch.randint(-300, 300, (m, k), generator=g, dtype=torch.int32)
            bits = torch.randint(0, 2, (33, k), generator=g, dtype=torch.int8)
            wp = packing.pack_bits_pad_set(bits, 2, g)
            thr = torch.sort(torch.randint(-300 * k, 300 * k, (33, 3), generator=g,
                                           dtype=torch.int32), dim=1).values
            a, wp, thr = a.to(dev), wp.to(dev), thr.to(dev)
            for t in (None, thr):
                got = P.mvu_binary_packed(a, wp, k, t)
                want = P.mvu_binary_packed_plain(a, wp, k, t)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"mvu_binary_packed counts pad bits at M={m} "
                      f"K={k} Wd={wp.shape[1]} ({dense_plan_text('mvu_binary_packed', m, 33, k)})")
                max_err["mvu_binary_packed"] = max(max_err["mvu_binary_packed"], err(got, want))
                checked["mvu_binary_packed"] += 1
    # 2-bit rows whose pad lanes are all set (0b11), two bytes more a row than
    # K needs: 9-, 18- and 152-byte rows (the byte and the 8-byte staging)
    for m in (1, 9, 128):
        for k in (27, 64, 600):
            a = torch.randint(-300, 300, (m, k), generator=g, dtype=torch.int32)
            w2 = torch.randint(-2, 2, (33, k), generator=g, dtype=torch.int8)
            wp = packing.pack_int2_pad_set(w2, 2, g)
            thr = torch.sort(torch.randint(-300 * k, 300 * k, (33, 3), generator=g,
                                           dtype=torch.int32), dim=1).values
            a, wp, thr = a.to(dev), wp.to(dev), thr.to(dev)
            for t in (None, thr):
                got = P.mvu_int2_packed(a, wp, k, t)
                want = P.mvu_int2_packed_plain(a, wp, k, t)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"mvu_int2_packed counts pad lanes at M={m} "
                      f"K={k} Bd={wp.shape[1]} ({dense_plan_text('mvu_int2_packed', m, 33, k)})")
                max_err["mvu_int2_packed"] = max(max_err["mvu_int2_packed"], err(got, want))
                checked["mvu_int2_packed"] += 1
    for name in ("mvu_int", "mvu_xnor", "mvu_binary", "mvu_binary_packed", "mvu_int2_packed"):
        print(f"kernel: {name}: {checked[name]} checks equal to the plain version, "
              f"max_abs_err={max_err[name]}", flush=True)

    # conv_mvu at the FULL CNV's six conv shapes, three modes, 1 and 32 images
    n_checked = 0
    cnv_shapes = conv_shapes(cnv_bnn.FULL)
    for mode in C.MODES:
        timed = [(b, h, h, c, n, 1, 0) for h, c, n in cnv_shapes for b in CONV_IMAGES]
        cases = timed + [(2, 9, 9, 16, 24, 2, 1)  # stride 2, pad 1: pad taps (xnor: -1)
                         ] + CONV_WIDE
        for b, h, wd, c, n, stride, pad in cases:
            kd = 3
            k = kd * kd * c
            x, w, x_f, w_f, nbytes = conv_case(mode, b, h, c, n, kd, g, dev, width=wd)
            thr = torch.sort(torch.randint(-8 * k, 8 * k, (n, 3), generator=g,
                                           dtype=torch.int32), dim=1).values.to(dev)
            scale = (torch.rand(n, generator=g) + 0.01).to(dev)
            geo = dict(kernel=kd, stride=stride, pad=pad, mode=mode)
            for t, s in ((None, None), (thr, None), (None, scale)):
                got = C.conv_mvu(x, w, t, s, **geo)
                want = C.conv_mvu_plain(x, w, t, s, **geo)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"conv_mvu != conv_mvu_plain ({mode}) at B={b} H={h} W={wd} C={c} "
                      f"N={n} stride={stride} pad={pad} thresholds={t is not None} "
                      f"scale={s is not None} "
                      f"({plan_text(C.conv_launch_plan(b, h, wd, c, n, kd, stride, pad))})")
                max_err["conv_mvu"] = max(max_err["conv_mvu"], err(got, want))
                n_checked += 1
            if (b, h, wd, c, n, stride, pad) not in timed:
                continue
            # time the layer as the path runs it: the threshold epilogue.  The
            # yardstick is timed only: cuDNN may pick a Winograd or FFT
            # algorithm, whose float32 rounding is not exact here
            tf = thr.float()

            def library(x_f=x_f, w_f=w_f, tf=tf, b=b, n=n):
                c_ = F.conv2d(x_f, w_f).permute(0, 2, 3, 1).reshape(b, -1, n)
                return (c_[..., None] >= tf).sum(-1, dtype=torch.int32)

            kms = device_ms(lambda: C.conv_mvu(x, w, thr, **geo), reps=50)
            pms = device_ms(lambda: C.conv_mvu_plain(x, w, thr, **geo),
                            reps=10 if b == 1 else 2, trials=3)
            lms = device_ms(library, reps=50)
            m = b * (h - 2) * (h - 2)
            bms, bby = bound_of(nbytes + thr.numel() * 4 + m * n * 4, 2 * m * n * k)
            timing[("conv_mvu", mode, b, h, c, n)] = (kms, pms, lms, bms, bby)
            print(f"kernel: conv_mvu {mode} B={b} H=W={h} C={c} N={n} K={k} thresholds: "
                  f"ms={kms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
                  f"bound_ms={bms:.6f} ({bby}) "
                  f"{plan_text(C.conv_launch_plan(b, h, h, c, n, kd))}", flush=True)
    print(f"kernel: conv_mvu: {n_checked} checks equal to the plain version, "
          f"max_abs_err={max_err['conv_mvu']}", flush=True)

    # ---------------------------------------------------------- 4. slice
    golden = nid_mlp.load_golden()
    path_accs = {}  # (config, variant) -> its Accelerator, for the later phases
    launches = {}
    plan = None
    # pack_bits calls, by the wrapper below: an xnor acc(x) on the card
    # packs its stages' inputs in the kernel and must make none
    pack_calls = [0]
    pack_bits = packing.pack_bits

    def counted_pack_bits(x):
        pack_calls[0] += 1
        return pack_bits(x)

    packing.pack_bits = counted_pack_bits
    for variant in ("standard", *sorted(v for v in golden if v != "standard")):
        gd = golden[variant]
        kw = gd["build"]
        kernel = ops.kernel_name(kw["mode"], packed=kw.get("pack") == "always")
        t0 = time.perf_counter()
        acc = nid_accelerator(gd)
        path_accs[("nid", variant)] = acc
        print(f"slice: {variant} {kw}: built {acc.report.step_names} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        batch = gd["batch"]
        x = torch.from_numpy(nid.make_dataset(batch, seed=gd["data_seed"])[0]).to(dev)
        plan = acc.plan(batch)
        ops.reset_launch_counts()
        pack_calls[0] = 0
        y = acc(x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts == {k: 4 * plan.n_micro if k == kernel else 0 for k in counts},
              f"{variant}: acc(x) launched {counts}, want {kernel} 4 x {plan.n_micro} "
              f"times and nothing else")
        check(pack_calls[0] == 0, f"{variant}: acc(x) called packing.pack_bits "
              f"{pack_calls[0]} times, want 0")
        launches[kernel] = counts[kernel]
        check(y.is_cuda and y.dtype == torch.float32 and tuple(y.shape) == (batch, 1)
              and bool(torch.isfinite(y).all()), f"{variant}: bad output {y.dtype} "
              f"{tuple(y.shape)}")
        check(torch.equal(y, acc.interpret(x)), f"{variant}: acc(x) differs from "
              "acc.interpret(x)")
        check(golden_mod.digest_like(gd, y.cpu().numpy(), acc.graph) == gd,
              f"{variant}: the card's NID output differs from the JAX package's "
              "golden digest")
        print(f"slice: {variant}: acc(x) at batch {batch} equals acc.interpret(x) and the "
              f"golden digest; {counts[kernel]} {kernel} launches = 4 x n_micro="
              f"{plan.n_micro}, no other kernel; pack_bits called {pack_calls[0]} times",
              flush=True)
        for b in (4096, 65536) if variant == "standard" else (4096,):
            xb = torch.from_numpy(nid.make_dataset(b, seed=gd["data_seed"])[0]).to(dev)
            med = acc_seconds(acc, xb)
            print(f"slice: {variant}: batch {b}: {b / med:.1f} flows/s (median of 7 "
                  f"acc(x), {med * 1e3:.3f} ms)", flush=True)

    # the FULL CNV in each golden variant
    cnv_runs = {}  # variant -> (mode, dense kernel, n_micro, its launch counts)
    for variant, gd in sorted(cnv_golden.items()):
        kw = gd["build"]
        dense = ops.kernel_name(kw["mode"])
        t0 = time.perf_counter()
        acc = cnv_accelerator(gd)
        path_accs[("cnv", variant)] = acc
        torch.cuda.synchronize()
        print(f"slice: cnv {variant} {kw}: built {acc.report.step_names} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        batch = gd["batch"]
        x = torch.from_numpy(cnv_bnn.images(batch, kw["act_bits"], gd["data_seed"])).to(dev)
        cplan = acc.plan(batch)
        check(cplan.microbatch == CNV_DENSE_M, f"cnv {variant}: {cplan.microbatch} images "
              f"a microbatch, but the dense kernels were checked at M={CNV_DENSE_M}")
        ops.reset_launch_counts()
        pack_calls[0] = 0
        y = acc(x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {k: 0 for k in counts}
        want["conv_mvu"], want[dense] = 6 * cplan.n_micro, 3 * cplan.n_micro
        check(counts == want, f"cnv {variant}: acc(x) launched {counts}, want conv_mvu "
              f"6 x {cplan.n_micro} and {dense} 3 x {cplan.n_micro} times and nothing else")
        check(pack_calls[0] == 0, f"cnv {variant}: acc(x) called packing.pack_bits "
              f"{pack_calls[0]} times, want 0")
        cnv_runs[variant] = (kw["mode"], dense, cplan.n_micro, counts)
        check(y.is_cuda and y.dtype == torch.float32 and tuple(y.shape) == (batch, 10)
              and bool(torch.isfinite(y).all()), f"cnv {variant}: bad output {y.dtype} "
              f"{tuple(y.shape)}")
        check(torch.equal(y, acc.interpret(x)), f"cnv {variant}: acc(x) differs from "
              "acc.interpret(x)")
        check(golden_mod.digest_like(gd, y.cpu().numpy(), acc.graph) == gd,
              f"cnv {variant}: the card's CNV output differs from the JAX package's "
              "golden digest")
        print(f"slice: cnv {variant}: acc(x) at batch {batch} equals acc.interpret(x) and "
              f"the golden digest; {counts['conv_mvu']} conv_mvu launches = 6 x n_micro="
              f"{cplan.n_micro}, {counts[dense]} {dense} = 3 x n_micro, no other kernel; "
              f"pack_bits called {pack_calls[0]} times", flush=True)
        xb = torch.from_numpy(cnv_bnn.images(CNV_BATCH, kw["act_bits"], gd["data_seed"])).to(dev)
        med = acc_seconds(acc, xb)
        print(f"slice: cnv {variant}: batch {CNV_BATCH}: {CNV_BATCH / med:.1f} images/s "
              f"(median of 7 acc(x), {med * 1e3:.3f} ms; n_micro="
              f"{acc.plan(CNV_BATCH).n_micro})", flush=True)

    packing.pack_bits = pack_bits

    # the residual MLP: fan-out and fan-in on the card
    gd = residual_mlp.load_golden()
    t0 = time.perf_counter()
    acc = build(residual_mlp.build_graph(gd["seed"]), target="engine", tune="off",
                folding=residual_mlp.foldings(), device="cuda", **gd["build"])
    print(f"slice: residual {gd['build']}: built {acc.report.step_names} in "
          f"{time.perf_counter() - t0:.2f} s; joins {acc.report.schedule['joins']}",
          flush=True)
    batch = gd["batch"]
    x = torch.from_numpy(nid.make_dataset(batch, seed=gd["data_seed"])[0]).to(dev)
    rplan = acc.plan(batch)
    path_accs[("residual", "standard")] = acc
    ops.reset_launch_counts()
    y = acc(x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts == {k: 3 * rplan.n_micro if k == "mvu_int" else 0 for k in counts},
          f"residual: acc(x) launched {counts}, want mvu_int 3 x {rplan.n_micro} times "
          "and nothing else")
    check(y.is_cuda and y.dtype == torch.float32 and tuple(y.shape) == (batch, 1)
          and bool(torch.isfinite(y).all()), f"residual: bad output {y.dtype} {tuple(y.shape)}")
    check(torch.equal(y, acc.interpret(x)), "residual: acc(x) differs from acc.interpret(x)")
    check(golden_mod.digest_like(gd, y.cpu().numpy(), acc.graph) == gd,
          "residual: the card's output differs from the JAX package's golden digest")
    med = acc_seconds(acc, x)
    print(f"slice: residual: acc(x) at batch {batch} equals acc.interpret(x) and the golden "
          f"digest; {counts['mvu_int']} mvu_int launches = 3 x n_micro={rplan.n_micro}, no "
          f"other kernel; {batch / med:.1f} flows/s (median of 7 acc(x), "
          f"{med * 1e3:.3f} ms)", flush=True)

    # the random-DAG sweep: engine against interpreter, both on the card
    n_dags = 0
    for mode, bits in torch_random_dag.MODES:
        kernel = ops.kernel_name(mode)
        for seed, depth in torch_random_dag.SWEEP:
            low, xd = torch_random_dag.dag_case(seed, depth, mode, bits)
            low = dataflow.graph_to(low, dev)
            xd = torch.from_numpy(xd).to(dev)
            eng = FusedEngine(low)
            n_stages = sum(n.op == "mvu" for n in eng.graph) * eng.plan(xd.shape[0]).n_micro
            ops.reset_launch_counts()
            got = eng(xd)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            check(counts == {k: n_stages if k == kernel else 0 for k in counts},
                  f"random DAG {mode} seed={seed} depth={depth}: launched {counts}, want "
                  f"{kernel} {n_stages} times and nothing else")
            want = dataflow.execute(low, xd)
            torch.cuda.synchronize()
            check(got.is_cuda and got.dtype == want.dtype and torch.equal(got, want),
                  f"random DAG {mode} seed={seed} depth={depth}: the engine differs from "
                  "dataflow.execute")
            joins = [n.name for n in low if n.op in ("add", "sub", "mul")]
            print(f"slice: random DAG {mode} seed={seed} depth={depth}: engine equals "
                  f"dataflow.execute on the card; joins {joins}; {n_stages} {kernel} "
                  "launches", flush=True)
            n_dags += 1
    print(f"slice: random DAGs: {n_dags} graphs equal in standard, binary and xnor",
          flush=True)

    # profile: per-node spans, bit-exact with acc(x)
    prof_inputs = {
        "nid": torch.from_numpy(nid.make_dataset(4096, seed=golden["standard"]["data_seed"])[0]),
        "cnv": torch.from_numpy(cnv_bnn.images(
            CNV_BATCH, cnv_golden["standard"]["build"]["act_bits"],
            cnv_golden["standard"]["data_seed"])),
    }
    for cfg_name, xp in prof_inputs.items():
        acc = path_accs[(cfg_name, "standard")]
        xp = xp.to(dev)
        tr = Tracer()
        drift = DriftMonitor.from_schedule(acc.schedule, DRIFT_S_PER_CYCLE)
        yp, pplan = acc.profile(xp, tr, drift=drift)
        check(torch.equal(yp, acc(xp)), f"profile {cfg_name}: differs from acc(x)")
        outer = tr.spans(name="engine.profile")
        nodes = tr.spans(cat="node")
        check(len(outer) == 1 and len(nodes) == pplan.n_micro * len(acc.engine.graph),
              f"profile {cfg_name}: {len(nodes)} node spans, want n_micro={pplan.n_micro} x "
              f"{len(acc.engine.graph)} nodes")
        check(all(outer[0]["t0"] <= sp["t0"] and sp["t1"] <= outer[0]["t1"]
                  and sp["depth"] == 2 for sp in nodes),
              f"profile {cfg_name}: node spans do not nest in engine.profile > micro")
        stages = {st.name for st in acc.schedule.stages}
        check(set(drift.status()["keys"]) == stages,
              f"profile {cfg_name}: the drift monitor saw {sorted(drift.status()['keys'])}, "
              f"want every scheduled stage {sorted(stages)}")
        med = {n.name: statistics.median(sp["dur"] for sp in nodes if sp["name"] == n.name)
               for n in acc.engine.graph}
        print(f"profile: {cfg_name} standard batch {xp.shape[0]}: equals acc(x); "
              f"{len(nodes)} node spans = n_micro={pplan.n_micro} x {len(acc.engine.graph)} "
              f"nodes, nested; drift fed {len(stages)} stages; engine.profile "
              f"{outer[0]['dur'] * 1e3:.3f} ms", flush=True)
        print(f"profile: {cfg_name} median node span, us (host + device, the card "
              "synchronised after each node, so not acc(x) time): "
              + ", ".join(f"{k} {v * 1e6:.1f}" for k, v in med.items()), flush=True)

    # the Section 6.5 flow and the examples, before any profiler trace
    qat_runs = qat_phase(dev, smi)
    examples_phase(smi)

    # trace: torch.profiler of one acc(x) each, after warm-up
    for cfg_name, xp in prof_inputs.items():
        report_trace(path_accs[(cfg_name, "standard")], xp.to(dev), f"{cfg_name} standard")

    served = serve_phase(dev, smi)
    tuned = tune_phase(dev, smi, path_accs)
    graph_phase(dev, smi, path_accs, tuned, served)
    tiles = tiles_phase(dev, smi, ptxas, path_accs, tuned)
    explore_phase(dev, smi)
    piped = pipeline_phase(dev, smi)
    lm = lm_phase(dev, smi)
    lm_qat = lm_qat_phase(dev, smi)
    trained = train_phase(dev, smi)
    moe_lm = lm_moe_phase(dev, smi)
    ssm_lm = lm_ssm_phase(dev, smi)
    hybrid_lm = lm_hybrid_phase(dev, smi)
    vlm_lm = lm_vlm_phase(dev, smi)
    encdec_lm = lm_encdec_phase(dev, smi)

    # -------------------------------------------------------- 5. results
    mb = plan.microbatch
    lines = []
    for name, (source, replaces) in KERNELS.items():
        if name == "conv_mvu":
            # the three CNV acc(x) runs: each launches every conv layer once
            # per microbatch of one image, in its variant's mode
            rows = [timing[("conv_mvu", mode, 1, h, c, n)] for mode, _, n_micro, _ in
                    cnv_runs.values() for h, c, n in cnv_shapes for _ in range(n_micro)]
            n_launches = sum(r[3]["conv_mvu"] for r in cnv_runs.values())
        else:
            # one NID acc(x) launches each layer once per microbatch, at
            # M = microbatch; the CNV acc(x) of the variant that runs this
            # kernel (if one does) each dense layer once per image; xnor's
            # engine stages launch its bit entry
            entry = XNOR_PATH_ENTRY if name == "mvu_xnor" else name
            rows = [timing[(entry, mb, n, k)] for k, n, _, _ in nid_mlp.LAYERS] * plan.n_micro
            n_launches = launches[name]
            if name == "mvu_int":  # the Section 6.5 flow's acc(x) runs, the qat phase
                for q_mb, q_n_micro in qat_runs:
                    rows += [timing[(name, q_mb, n, k)]
                             for k, n, _, _ in nid_mlp.LAYERS] * q_n_micro
                    n_launches += 4 * q_n_micro
            for _, dense, n_micro, counts in cnv_runs.values():
                if dense == name:
                    rows += [timing[(entry, CNV_DENSE_M, n, k)] for n, k in cnv_dense] * n_micro
                    n_launches += counts[name]
            # the pipeline, lm, lm_qat, train, lm_moe, lm_ssm, lm_hybrid,
            # lm_vlm and lm_encdec phases' counted runs, each launch at its
            # shape (lm_ssm's: none)
            for phase in (piped, lm, lm_qat, trained, moe_lm, ssm_lm, hybrid_lm, vlm_lm,
                          encdec_lm):
                rows += phase["rows"].get(name, [])
                n_launches += phase["launches"].get(name, 0)
            if name == "mvu_xnor":  # the packed entry on the same launches, beside it
                packed = [timing[(name, mb, n, k)] for k, n, _, _ in nid_mlp.LAYERS]
                packed = packed * plan.n_micro + [
                    timing[(name, CNV_DENSE_M, n, k)] for n, k in cnv_dense] * sum(
                    r[2] for r in cnv_runs.values() if r[1] == name)
                print(f"kernel: mvu_xnor over the path's {len(packed)} launches: bit entry "
                      f"(launched) ms={sum(r[0] for r in rows):.7f}, packed entry "
                      f"ms={sum(r[0] for r in packed):.7f} (its bound_ms="
                      f"{sum(r[3] for r in packed):.7f})", flush=True)
        per_acc = [sum(r[i] for r in rows) for i in range(4)]
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": max_err[name],
            "ms": per_acc[0], "plain_ms": per_acc[1], "library_ms": per_acc[2],
            "bound_ms": per_acc[3],
            "bound_by": "bytes" if all(r[4] == "bytes" for r in rows) else "operations",
            # each compiled tile on the main path's shapes (the tiles phase)
            "tiles": tiles[name]})
    for variant, (mode, dense, _, _) in sorted(cnv_runs.items()):
        conv_ms = sum(timing[("conv_mvu", mode, 1, h, c, n)][0] for h, c, n in cnv_shapes)
        dense_ms = sum(timing[(dense, CNV_DENSE_M, n, k)][0] for n, k in cnv_dense)
        print(f"slice: cnv {variant}: kernel time per image (the per-launch medians): "
              f"conv_mvu {conv_ms:.5f} ms, {dense} {dense_ms:.5f} ms", flush=True)
    print(f"trace: {len(TRACES)} traces in this run, {len(TRACE_RETAKES)} taken again for "
          f"holding no device event or, marked partial, part of the hand kernels' "
          f"{TRACE_RETAKES}", flush=True)
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
