#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (built for H100).

    python3 chip_smoke.py [--layers N] [--train-layers N] [--moe-layers N]
                          [--vlm-layers N] [--gemma-layers N] [--pages N]
                          [--seed S] [--gmm-tile-rows]
    python3 chip_smoke.py --ab PARENT_CHECKOUT [--layers N]

``--ab`` runs only the kernel checks of item 2 (all six kernels;
``moe_gmm`` at one moefied Qwen2-7B call) and the greedy decode of item
3's six staggered requests (ring and paged infer engines and a ring
mode="base" engine, --layers deep, warm ms/step) on another checkout
(unpacked with ``git archive``) and on this one in turns, p c c p, one
process each, on the same seeded inputs: each turn within TOL of the
plain versions, the timed medians and warm decode ms/step per turn,
whether the change beat the parent in every turn at the cases of
``AB_FASTER``, and it fails unless each tree's outputs are equal bit for
bit in its own two turns and the kernels and paths this change leaves
alone (``AB_SAME``) give the same bits in both trees. Without it:

1. Prints the card (nvidia-smi name and power limit), builds the
   hand-written CUDA kernels from src/repro_torch/kernels/csrc with nvcc
   (sm_90a, one process per source, in parallel) and prints the build time,
   ptxas's registers and spills, and the number of tensor-core (HGMMA)
   instructions in each flash_fwd instantiation's SASS and in the MLP's
   tensor-core up and down phases, which run the dense (fused_mlp), routed
   (fused_mlp_routed) and grouped (moe_gmm) modes (fails unless the bf16
   Dh=128 flash kernel and every MLP phase have some).
2. Holds each kernel against its plain PyTorch version at Qwen2-7B shapes,
   in bf16 and f32, with ragged counts, kv_valid holes, a part-filled ring
   (t at the decode kernel's split edges, a slot with every key masked and
   an inactive one) and a routed selection; prints the max error beside the
   tolerance, and times the kernel, the plain version and (attention) one
   SDPA call with CUDA events. The int8 operand forms of four kernels
   (int8 K/V with per-(key, kv-head) scales for both decode kernels, int8
   weights with per-output-channel scales for fused_mlp) are held the same
   way at Qwen2-7B shapes, bf16 and f32 activations, with holes, a masked
   and an inactive slot, each timed beside the same kernel on bf16
   operands (their bound counts int8 at 1 byte plus the f32 scales; no
   single PyTorch call computes an int8-operand function: library none;
   kept under each kernel's "int8" key of the result line) (KV heads shared by enable_gqa; SDPA over K/V
   repeated to the q-heads is printed beside it). The MLP kernels are
   timed at the ring prefill's 512 rows, the training shape and a paged
   prefill chunk's 16 rows (fused_mlp) and at a training step's routed
   bucket (fused_mlp_routed), each beside a cuBLAS bf16 composite of the
   same function (several calls: printed, never library_ms). The attention kernels,
   their plain versions and SDPA are timed twice: back to back (eager) and
   replayed from a CUDA graph (graphed: the device's time without the
   host's cost of issuing each call); the result line's ms, plain_ms and
   library_ms are back-to-back medians in every row, as for the MLP
   kernels, and the attention rows carry the graphed medians beside them
   as graphed_ms, graphed_plain_ms and graphed_library_ms. moe_gmm is held
   to its plain version after each expert path (items 6, 8, 9) at the
   calls that path made: their shapes and group counts are recorded during
   the path and
   replayed (random x and weights in the path's weight layout, bf16 and
   f32, with and without routing weights, exact zeros past every count,
   each output bit-stable across a repeat), the largest timed beside its
   bound and a cuBLAS per-expert composite (printed, never library_ms);
   with --gmm-tile-rows also the tensor-core body at 64- and at 128-row
   tiles.
3. Serving: 6 staggered mixed-budget requests through ``ServingEngine`` at
   Qwen2-7B full width (random bf16 weights from --seed; --layers cuts depth
   only) and fails unless budget-1.0 requests equal a mode="base" engine
   bit for bit, a request served alone equals its staggered tokens, and
   every serving kernel launched during the run. The engines capture their
   entry points as CUDA graphs (the default): the main run is held bit for
   bit to a ``cuda_graphs=False`` twin at the same depth (tokens and every
   cache leaf), and both engines' ``compile_counts()`` are printed and
   gated (ring: prefill 0, decode at most 2 forms). Prints prefill and
   decode rates of the main run, of its twin and of the (warm) teacher
   run, warm decode ms/step, prefill tok/s and the device's busy share
   graphed and eager (in turns, then profiled), and the device kernel time
   of the solo run under torch.profiler.
3b. Paged serving: the same weights and requests through
   ``ServingEngine(kv_layout="paged")`` (page size 16, --pages pages,
   default the ring-equivalent 4 * 64 + 1): fails unless staggered ==
   solo and budget 1.0 == a mode="base" paged engine bit for bit, two
   requests with a common 256-token prefix share its 16 pages and each
   gives its solo tokens, a fork mid-decode and a pool small enough that
   two 512-token requests collide (at least one preemption) complete, the
   pool drains after every run, and paged_decode_attention and fused_mlp
   launched. Prints the rates beside the ring's, paged-vs-ring token
   agreement, whether the fork child and the preempted request match
   their independent runs (reported, not gated: in bf16 K/V written by
   decode and by a chunk may round differently), the solo run's device
   time under torch.profiler, and warm decode of one request on a ring and
   a paged engine in turns, each also profiled per step.
   paged_decode_attention is held to its plain version at the path's
   decode shape (4 slots, 64-entry table rows with -1 holes, an all -1
   row, pvalid holes, shuffled pages), and at the path's own calls: the
   staggered run's calls are recorded (table, t, pvalid) and the heaviest
   decode-step call and prefill-chunk call (16 rows over one table row)
   are replayed in bf16 and f32 and timed.
3c. Quantized serving: the same weights and requests through int8
   engines (``kv_dtype`` and ``weight_dtype`` "int8"; each engine
   quantizes the weights once at init), ring then paged: fails unless
   staggered == solo, budget 1.0 == an int8 mode="base" engine of the
   same layout, (paged) two requests sharing a 256-token prefix each
   equal their solo runs and the pool drains, bit for bit, and the int8
   forms of fused_mlp, decode_attention (ring) and paged_decode_attention
   (paged) launched; the path's heaviest int8 calls are replayed against
   the plain versions. Prints the rates beside the bf16 rows of item 3 /
   3b, the int8-vs-bf16 greedy agreement (not gated), KV and weight bytes
   against a bf16 engine's, and one warm decode profiled beside a bf16
   engine (device ms and operations per step).
3d. int8 fork and preemption: f32 at Qwen2-7B width, 2 layers, paged: a
   fork child mid-page equals its independent run, and two 512-token
   requests on a pool one page short (a preemption) each equal their
   uninterrupted runs, bit for bit.
3e. Train-mode serving: the same weights and requests through
   ``ServingEngine(mode="train")`` on the ring (each admission routes by
   top-k into the request's ragged capacity bucket; the dense MLPs run
   ``fused_mlp_routed``), in bf16 and with int8 weights and K/V (the
   routed kernel's int8 form): fails unless the tokens are in the
   vocabulary, budget-1.0 requests equal the teacher of item 3 (int8:
   item 3c's int8 teacher), request 4 alone equals its staggered run, bit
   for bit, ``compile_counts()`` is {prefill 0, decode 1} and the path's
   kernels launched. Every ``fused_mlp_routed`` call of the int8 run is
   replayed against the plain version (unselected rows exact zeros), the
   heaviest timed beside the kernel on bf16 weights at the same shape.
   Prints each warm admission's bucket and time beside an infer engine's,
   the profiled device time of one admission of each, and the rates.
4. Gradients: the router gradients of one distillation loss at full width,
   2 layers, f32, through the kernels against the same through the plain
   versions.
5. Training: 4 router self-distillation steps through
   ``repro_torch.launch.train`` at Qwen2-7B full width and depth (the
   serving weights; --train-layers cuts depth), seq 512, batch 2, budget
   annealed 1.0 -> 0.5 over 3 steps. Fails unless budget 1.0 gives the
   teacher's hidden states bit for bit and a distillation loss of exactly
   0, a plan step run twice gives the same bits, every loss is finite and
   every training kernel launched. Prints each step's losses, bucket,
   teacher and student times, tokens/s and peak memory.
5a. Surfaces (``check_surfaces``), on the serving weights: (i)
   ``launch.train.train`` at Qwen2-7B width, --train-layers deep, B=2,
   S=512, 8 steps annealed 1.0 -> 0.5 over 4, checkpoints every 2 steps
   into a fresh temporary directory (removed after), run clean and with a
   failure injected at step 5: fails unless the faulty run restarted once
   and both end in the same routers, AdamW moments and step and every
   step's loss, bit for bit, and each directory holds steps 4, 6 and 8,
   each restoring with every checksum verified; prints each save's
   snapshot and background-write host times and one restore's. (ii) The
   last checkpoint restored into port routers (== the trainer's state bit
   for bit) and served: a ring infer engine (bf16, 4 slots, graphed), 8
   requests of 64-512 tokens and 32 new tokens, budgets 0.5 / 0.75 / 1.0
   round-robin, Poisson at 4 req/s (seed 0) through
   ``launch.serve.open_loop``: fails unless every request is done, each
   equals itself served alone on a fresh engine, the budget-1.0 ones equal
   a mode="base" engine's and ``compile_counts()`` does not move during the
   window; prints ``latency_stats`` and occupancy. (iii) ``python -m
   repro_torch.launch.serve`` (``SURF_CLI``: Qwen2-7B at full width and
   depth, paged, bf16, open loop) as a subprocess: fails unless it exits 0,
   prints its report lines (echoed) and builds nothing (it loads the
   parent's kernels). Its launches are not counted.
5b. Depth serving: the slice's spec and routers plus a fresh seeded depth
   router per layer (per-token whole-layer skip), the six staggered
   requests on the ring and on the paged pool: fails unless budget-1.0
   rows equal the mode="base" runs of items 3 and 3b bit for bit, a
   request alone equals its staggered tokens, the pool drains, and
   flash_attention, fused_mlp, decode_attention (ring) and
   paged_decode_attention (paged) launched. The path's flash, decode,
   MLP and paged calls are recorded and the heaviest of each replayed in
   bf16 and f32 against the plain version (rows with no attendable key
   exact zeros). Prints the rates beside the slice's, the share of
   (token, layer) pairs that wrote no K/V per budget (ring ``valid``,
   paged ``pvalid``) and the depth router's own skip share at the
   staggered ring run's prefills; the depth ring path is decoded warm in
   turns against the slice's ring engine.
5c. Depth gradients: item 4 for the depth spec at depth 0.5 and budget
   0.75 on the other knobs (the bucket solved with the spec: 256 rows,
   not the token knobs' 384; every head's router at a partial top-k, so
   no leaf's gradient is structurally zero), every depth router leaf
   non-zero on both paths.
5d. Depth training: item 5's anneal with the depth spec (the same gates,
   every depth router leaf with a non-zero gradient), then the step timed
   at (depth, token) = (1.0, 1.0), (0.75, 1.0), (0.5, 1.0), (0.5, 0.5)
   (wall time), and the last once more under torch.profiler (device
   time).
5e. Controller serving: the slice's weights with item 5b's depth routers
   under an ``SLOController`` (``runtime/controller.py``), 24 requests of
   a ``launch/workloads`` trace (prompts 64-512 and 16-64 new tokens,
   heavy-tailed; interactive 0.75 with p95 TTFT and ITL targets, batch
   0.25 shed first and with a queue deadline; bursty arrivals) on an
   injected ``StepClock`` advanced a fixed tick per step, through
   ``replay``, on the ring (a) and the paged pool (b): fails unless the
   controller walks degrade_admission, degrade_depth, degrade_inflight
   and shed in that order and restores after, shed requests are rejected
   with a Retry-After hint and expired ones deadline_exceeded, none
   prefilled, the controller escalates and ``maybe_escalate`` declines,
   ``compile_counts()`` does not grow after the first degrade, and the
   graphed engine at ``TWIN_LAYERS`` equals its ``cuda_graphs=False`` twin
   in trajectory, events, statuses, tokens and caches (the in-flight
   splices read by a replayed graph). (c1) the fault drill: the requests
   without a controller, all at once, through ``serve_resilient`` with a
   failure injected mid-run and a straggler watchdog: one restart (a
   shape of 8 devices skipped, then ``reshard(None)``), every request
   finished with its fault-free tokens, ``compile_counts()`` restarted at
   the re-mesh and flat after it. (c2) the ring trace on the wall clock:
   every request terminal, ``compile_counts()`` flat; prints
   ``summarize`` (attainment, goodput, TTFT and ITL percentiles, shed and
   expired), the controller's summary and, for (a) and (c2), decode
   ms/step over the degraded steps against the undegraded ones. The
   path's flash, decode, MLP and paged calls are replayed against the
   plain versions, as in item 5b.
5f. Sampled serving: the six requests of item 3 with temperature 0 on the
   first two and 0.7 / 1.0, top-k 0 / 40 and seeds on the rest: fails
   unless the temperature-0 rows equal item 3's greedy tokens, a sampled
   request alone equals its staggered tokens, greedy-only and sampling
   decode steps hand ``decode_step`` tensors of the same shapes and
   dtypes and the sampling steps hand ``sample_tokens`` (B,) settings (a
   host branch skips the sort and noise when no live slot samples), and
   (paged
   pool, f32, 2 layers) a preempted sampled request resumes to its
   uninterrupted run's tokens. Times one ``sample_tokens`` call against
   the greedy argmax at (4, vocab), graphed and eager.
6. Expert serving: the same six requests through the same weights with
   the MLPs moefied into 8 routed experts (views of the dense weights,
   fresh routers): staggered == solo bit for bit, moe_gmm launched; prints
   the rates, and the budget-1.0-vs-teacher logit difference and token
   agreement (reported, not gated: E partial products in bf16).
7. Expert gradients: the check of item 4 for the expert spec, with the
   expert routers' leaves and the same routing decisions on both paths.
8. Expert training: item 5's anneal with the expert spec: finite losses,
   a plan step twice gives the same bits, every expert router leaf gets a
   non-zero gradient, moe_gmm launched.
9. Native MoE serving: Qwen1.5-MoE-A2.7B at full width (qwen2-moe-a2.7b,
   --moe-layers deep, random bf16 weights, its registered elastic config)
   after the Qwen2-7B weights are freed: staggered == solo bit for bit,
   moe_gmm launched; prints the rates.
9a. Native MoE training: the same weights through ``launch.train.train``
   (4 steps, B=2, S=512, budget 1.0 -> 0.5 over 2, checkpoints every 2),
   clean and with a failure at step 3: bit for bit equal as in item 5a,
   every loss finite; moe_gmm's calls of both runs are recorded and
   replayed against the plain version; prints ms per step and peak memory.
9b. Native MoE int8 serving: the same model, routers and requests with
   int8 weights and K/V: staggered == solo bit for bit, moe_gmm launched;
   moe_gmm's int8 form (int8 expert stacks, (E, Fe) / (E, D) scales) is
   replayed at that path's calls against the plain version and timed
   beside the kernel on bf16 stacks.
9c. (a) VLM serving, after the earlier models' weights are freed:
   Llama-3.2-Vision-11B at full width (``--vlm-layers`` deep, default 20
   = 16 attn + 4 xattn; random bf16 weights and routers from --seed), its
   registered elastic spec (MLPs moefied into 16 experts, token and head
   routing, LoRA, the image-token router at 0.6), six requests on the
   ring in infer mode, each with its own ``procedural_images`` image
   (1601 x 1280) as ``extra_inputs``, budgets 1.0 / 0.75 / 0.5: fails
   unless staggered == solo, the registered spec with dense MLPs at
   budget 1.0 equals a mode="base" engine (the moefied spec's agreement
   is reported: a full expert budget sums 16 partial products), one
   prompt with two images gives different tokens and with the same image
   the same tokens, the graphed engine equals its ``cuda_graphs=False``
   twin at 5 layers (the first xattn layer is the 5th; tokens and every
   cache leaf, the context caches too), ``compile_counts()`` stays flat
   and the path's kernels launched. Prints the rates, peak memory and one
   warm request's admission ms and decode ms/step. The kernel calls of
   the eager twin are held to the plain versions in bf16 and f32: the
   heaviest causal and non-causal flash call, decode call (H 32, K 8,
   Dh 128) and moe_gmm call of each shape (16 experts x 896 x 4096);
   the heaviest non-causal flash call (the cross-attention of a prompt
   over the image tokens with the router's holes) is timed graphed and
   eager beside SDPA (enable_gqa) and its bound (the result line's
   flash_attention ``context`` key, row 1b).
9d. (b) VLM distillation: 3 steps of ``make_train_step`` at the same
   width and depth, B=1, S=256, one image, budget 1.0 -> 0.8 -> 0.6, with
   the image-token capacity static (the gathered 961 rows) and tensor
   (the 1601 rows and a validity mask): fails unless every loss is
   finite, the vlm router's gradient at the last step is non-zero, the
   last step twice from the same state gives the same bits, and the
   kernels launched. Each form's kernel calls are held to the plain
   versions as in (a): flash causal and non-causal, the teacher's dense
   swiglu MLP (4096 x 14336) and moe_gmm.
9e. (c) ViT distillation: toy-vit in bf16 and f32, 4 steps of the cosine
   distance on ``procedural_images`` (B=8), budget 1.0 -> 0.5 with its
   ragged bucket: the same gates, the token routers' gradient non-zero.
9f. (d) Encoder-decoder serving: Whisper-medium at full width (24 encoder
   layers over 1500 frames from --seed, 24 decoder layers), its
   registered spec without the moefied experts, four requests with their
   frames as ``extra_inputs``: fails unless staggered == solo and budget
   1.0 == a mode="base" engine bit for bit, the twins at 4 decoder layers
   are equal, and the path's kernels launched. The eager twin's kernel
   calls are held to the plain versions as in (a) (flash causal and
   non-causal, decode at H 16, K 16, Dh 64, the dense MLP); the
   encoder's heaviest flash call (non-causal, 1500 x 1500, Dh 64; row 1c)
   and the heaviest dense MLP call (ungated GELU, 1500 x 1024 x 4096; row
   2f, fused_mlp's ``context`` key) are timed.
9g. (e) RecurrentGemma-2B at full width and depth (26 layers: 18 RG-LRU
   and 8 local-attention layers, 10 q-heads on 1 kv-head at Dh 256,
   window 2048), its registered spec (16 moefied experts), the six
   requests on the ring (4 slots, max_seq 1024): staggered == solo,
   budget 1.0 == a mode="base" engine with the spec's dense MLPs (the
   moefied agreement reported), twins at one (rglru, rglru, attn)
   period (every cache leaf, ``state``/``conv`` included),
   ``compile_counts()`` flat; then 3 distillation steps (B=1, S=512, 1.0
   -> 0.5): finite losses, a non-zero gradient on the RG-LRU layers'
   token routers, the last step twice the same bits. The path's flash
   and decode calls at Dh 256 (rows 1d, 5c) and its ``moe_gmm`` calls are
   held to the plain versions and timed.
9h. (f) Gemma-3-27B at full width, ``--gemma-layers`` deep (default 12,
   two 5 local : 1 global periods, window 1024), the port's default spec:
   four requests of 1500, 700, 1100 and 300 tokens and 64 new ones on
   the ring (max_seq 2048: the local rings wrap in prefill and decode),
   the gates of (e) (twins at one 6-layer period); in f32 at 6 layers the
   1500-token prompt's base-mode decode logits against a full-sequence
   forward (atol 2e-3, rtol 1e-3); 3 distillation steps (B=1, S=1536,
   1.0 -> 0.6), whose local layers run the plain windowed gathered
   attention: its calls of a step are replayed forward and backward
   against the step's device time. Rows 1e (flash, window 1024 over
   1500 keys) and 5d (decode over a wrapped window ring).
9i. (g) Mamba2-780M at full width and depth (48 SSD layers), its
   registered spec (the mixer's token router): the six requests with
   the gates of (e), budget 1.0 == the teacher bit for bit; 3
   distillation steps (B=2, S=512). Plain PyTorch end to end, as in the
   JAX package: it fails if any kernel launches.
9j. (h) Granite-34B (8 of 88 layers: 48:1 MQA, ungated GELU, layernorm,
   qkv bias), Phi-3-medium-14B (8 of 40) and Grok-1-314B (2 of 64, ~23
   GB: 8 experts of 32768, geglu, its registered expert routing) at full
   width, four requests each: staggered == solo, budget 1.0 == the
   teacher (Granite, Phi-3; Grok-1's agreement reported). Rows 1f and 5e
   (flash and decode at 48:1), 2g (Granite's MLP, 300 x 6144 x 24576)
   and 4g (``moe_gmm`` at Grok-1's 8 x 32768, geglu).
   The new modes' calls are replayed in bf16 and f32 against the plain
   versions (``check_path_calls``; a windowed call apart from the global
   ones) and timed graphed and eager beside SDPA (enable_gqa) or a
   cuBLAS composite and their bounds (the result line's ``modes`` keys).
9k. (i) Analysis and accounting: ``repro_torch.analysis.run_all`` on the
   toy bundle and on Qwen2-7B's ring and paged entry points (admission,
   chunk, decode, the training step) at ``TWIN_LAYERS`` in bf16 and with
   int8 weights and K/V, on the card: every finding and every waived one
   printed, an unwaived error fails. Every kernel call the paths recorded
   (``PathCalls.signatures``) and the bundles' entry points made: its
   Python launch statement (``ops.launch_geometry``) must equal what its C
   launcher reports through its ``*_geometry`` entry (``ops.c_geometry``).
   Qwen2-7B at 28 layers: a 4-slot decode step counted on its eager twin
   and timed graphed (device ms a step), and a 2 x 512 training step at
   budget 0.5 counted and timed (device ms), as FLOPs, bytes
   (``hloprof.count_step``) and shares of the card's peaks
   (``step_shares``): a share above 1.0 fails. Every bound of the timed
   kernel cases comes from ``ops.kernel_cost``, and each of PERF.md §6's
   rows must come out as printed there (``PERF_BOUNDS``).
9l. (j) Tensor-parallel serving (``check_tp_serving``): two ranks spawned
   with ``torch.multiprocessing`` on the one card, a (data=1, model=2)
   mesh over gloo (NCCL refuses two ranks on one device; every number of
   the phase is labelled "2 ranks sharing one H100, gloo" and describes
   that arrangement, not a TP deployment). Each rank draws the serving
   weights from --seed (the same tree as item 3), keeps its shard
   (``sharding.shard_params``: 14 of 28 q-heads on 2 of 4 kv-heads, 9,472
   of 18,944 MLP columns, 76,032 vocabulary rows) and serves the six
   staggered requests at budgets {1.0, 0.75, 0.5} on a ring engine with
   ``mesh=`` (eager: gloo cannot be captured): fails unless budget 1.0 ==
   a TP mode="base" engine and staggered == solo bit for bit, on every
   rank the decode step's kernel calls (``ops.call_signature``: kernel,
   operand shapes and dtypes, other arguments) are the same in the
   staggered run as in one request served alone at each budget,
   ``compile_counts()`` is prefill 0 / decode 1, and flash, fused_mlp
   and decode_attention launched on each rank;
   each rank's heaviest flash, decode and MLP call (recorded at its
   shapes) is replayed against the plain version (``check_path_calls``),
   and each recorded call's launch geometry held to its launcher's. At 2
   layers in f32 (full width) the TP engine's greedy tokens must equal a
   one-rank engine's on the same weights and its prefill and decode
   logits be within 1e-4 of them; at 28 layers in bf16 the tokens are
   compared with item 3's one-rank run and the first divergence printed
   (a report: the two partial sums round in another order). Prints per
   rank the launch counts, decode ms/step, admission ms, collectives and
   their time per decode step, and peak device memory.
9m. (k) Serving on a (data=2, model=2) mesh (``check_dp_serving``): four
   ranks spawned on the one card over gloo (every number labelled "4
   ranks sharing one H100, gloo"); rank (d, m) holds model shard m and
   replica d's two slots of the ring cache or half of the page pool.
   Each rank draws the serving weights from --seed (the same tree as item
   3) in turn on the card and keeps its shard. At --layers in bf16 the
   ring engine with ``mesh=`` serves the six staggered requests: fails
   unless budget 1.0 == a mesh mode="base" engine and staggered == solo
   bit for bit, admissions landed on both replicas, ``compile_counts()``
   is prefill 0 / decode 1 and the decode step's kernel calls the same at
   every budget on each rank, flash, fused_mlp and decode_attention
   launched on each rank, each rank's heaviest call of each replayed
   against the plain version and every launch statement equal to its
   launcher's. The paged engine on the same mesh (page 16, the pool split
   into two replica ranges; ``DP_PAGED_LAYERS`` deep, printed): staggered
   == solo, budget 1.0 == a paged base engine, two requests with a
   common 256-token prefix share its pages on one replica, and on each
   rank paged_decode_attention launched at (2, 1, 14, 128) over its
   local pool with its heaviest calls replayed. At 2 layers in f32 (full
   width) the greedy tokens equal a one-rank engine's on the same
   weights for the ring and the paged (2, 2) engines and across a live
   re-mesh (2, 2) -> (1, 2) -> None with every request in flight,
   ``compile_counts()`` restarting at prefill 0 / decode 1 after each.
   Prints per rank the launch counts, decode ms/step, admission ms, the
   model-axis and data-axis collectives (count, bytes, host ms), peak
   device memory and the phase's seconds.
10. Prints one JSON line of per-kernel results (launches by path), one of
   the accounting (``{"accounting": {"decode_mfu", "decode_hbm_share",
   "train_mfu", "train_hbm_share", ...}}``), the card line again, and as
   the last line {"ok": true, "device": {...}}.

Every serving phase holds its graphed engines to ``cuda_graphs=False``
twins on the same weights and requests, bit for bit (tokens, every cache
and pool leaf, the page table and pool stats): the slice's ring and paged
infer engines at the served depth, the others (teachers, int8,
train-mode, depth, sampled, moefied, native MoE and its int8 form) at
``TWIN_LAYERS`` layers,
the sampled preemption at its 2 f32 layers; every engine's
``compile_counts()`` must be prefill 1 (paged) or 0 (ring) and decode 1
or 2. A graph replay calls no Python wrapper: the launch counts add each
replayed graph's launches (``ops.count_replay``), and the kernel calls
that the path-call checks replay against the plain versions, and the
sampled phase's ``decode_step`` / ``sample_tokens`` records, come from the
eager twins.

The kernel build prints ptxas's registers, shared memory and spills for
every instantiation (the ring and paged modes of the decode kernel among
them).

Any failed phase raises and the script exits non-zero before that line.
TF32 is off for matmuls and cuDNN (both set below): f32 means f32.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = {"bf16": (1e-2, 1e-2), "f32": (1e-4, 1e-4)}   # (atol, rtol), per element
L2_BYTES = 50 * 2 ** 20                       # H100 SXM L2
SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:124"),
    "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:140"),
    "fused_mlp_routed": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                         "src/repro/kernels/fused_mlp.py:261"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:104"),
    "moe_gmm": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                "src/repro/kernels/moe_gmm.py:99"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:108"),
}

# kernels each path must launch (the teacher of expert training is dense)
PATH_KERNELS = {
    "serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "paged_serving": ("fused_mlp", "paged_decode_attention"),
    "training": ("flash_attention", "fused_mlp", "fused_mlp_routed"),
    "expert_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    "expert_training": ("flash_attention", "fused_mlp", "moe_gmm"),
    "native_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    "depth_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "depth_paged_serving": ("fused_mlp", "paged_decode_attention"),
    "depth_training": ("flash_attention", "fused_mlp", "fused_mlp_routed"),
    "sampled_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "quant_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "quant_paged_serving": ("fused_mlp", "paged_decode_attention"),
    "quant_native_serving": ("flash_attention", "moe_gmm",
                             "decode_attention"),
    "train_serving": ("flash_attention", "fused_mlp", "fused_mlp_routed",
                      "decode_attention"),
    "quant_train_serving": ("flash_attention", "fused_mlp",
                            "fused_mlp_routed", "decode_attention"),
    "controller_serving": ("flash_attention", "fused_mlp",
                           "decode_attention"),
    "controller_paged_serving": ("fused_mlp", "paged_decode_attention"),
    "controller_fault_drill": ("flash_attention", "fused_mlp",
                               "decode_attention"),
    "resumable_training": ("flash_attention", "fused_mlp",
                           "fused_mlp_routed"),
    "checkpoint_serving": ("flash_attention", "fused_mlp",
                           "decode_attention"),
    "native_training": ("flash_attention", "moe_gmm"),
    # the context families (the MLPs of the VLM's registered spec are
    # moefied; its teacher and the encoder-decoder's run dense)
    "vlm_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    "vlm_training": ("flash_attention", "fused_mlp", "moe_gmm"),
    "vit_training": ("flash_attention", "fused_mlp", "fused_mlp_routed"),
    "encdec_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    # the recurrent, windowed and attention-only families (RecurrentGemma's
    # registered spec moefies its MLPs; Gemma-3's student runs the routed
    # MLP; Mamba2 runs no kernel: its SSD mixer is plain PyTorch in both
    # packages, and it has no attention or MLP)
    "hybrid_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    "hybrid_training": ("flash_attention", "fused_mlp", "moe_gmm"),
    "windowed_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "windowed_training": ("flash_attention", "fused_mlp",
                          "fused_mlp_routed"),
    "ssm_serving": (),
    "ssm_training": (),
    "granite_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "phi3_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "grok_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    # (j) each rank of the tensor-parallel ring engine
    "tp_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    # (k) each rank of the (data, model) ring and paged engines
    "dp_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "dp_paged_serving": ("fused_mlp", "paged_decode_attention"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, reps: int = 5, warmup: int = 5,
            graph: bool = False) -> list:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls,
    measured with CUDA events ``reps`` times after ``warmup`` calls; returns
    the ``reps`` means, sorted (median is the reported time, the ends are
    its spread). With ``graph`` the ``iters`` calls are captured once into
    a CUDA graph, which is replayed: the device's time per call without the
    host's cost of issuing it (wrapper Python, allocation, launch calls),
    which the plain back-to-back form includes wherever it is the larger."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return sorted(out)


def device_and_eager_ms(fn, iters: int) -> tuple:
    """(graphed, back-to-back) times of ``fn`` (``cuda_ms``): the attention
    kernels, their plain versions and SDPA run near the host's cost of one
    call, so both are kept."""
    return cuda_ms(fn, iters, graph=True), cuda_ms(fn, iters)


def cycling(fn, n: int):
    """A no-argument callable that calls ``fn(i)`` with i = 0, 1, ..., n-1,
    0, ... in turn (rotates over n input sets)."""
    state = [0]

    def call():
        i = state[0]
        state[0] = (i + 1) % n
        return fn(i)
    return call


def bound_ms(flops: float, nbytes: float, kind: str):
    """``launch/hloprof.bound_ms``: the card's peak rates live there."""
    from repro_torch.launch.hloprof import bound_ms as bound
    return bound(flops, nbytes, kind)


def cost(name, *args, **kw):
    """``ops.kernel_cost``: (flops, bytes, kind) of one call of the kernel
    wrapper ``name``, the one source of every bound below."""
    from repro_torch.kernels import ops
    return ops.kernel_cost(name, *args, **kw)


class Results:
    """Per-kernel comparison errors and main-case timings."""

    def __init__(self):
        self.rows = {n: {"max_abs_err": 0.0} for n in SOURCES}

    def compare(self, name, case, got, want, kind, quiet=False):
        """Per element: |got - want| <= atol + rtol * |want|. ``quiet``:
        print only a failure (the caller prints a summary). Returns the
        worst err/tol."""
        import torch
        diff = (got.float() - want.float()).abs()
        atol, rtol = TOL[kind]
        tol = atol + rtol * want.float().abs()
        err = float(diff.max())
        worst = float((diff / tol).max())       # <= 1 everywhere to pass
        ok = bool(torch.isfinite(got.float()).all()) and worst <= 1.0
        n_diff = int((got != want).sum())
        if not quiet or not ok:
            print(f"  {name:17s} {case:44s} max_abs_err {err:.3e}  worst "
                  f"err/tol {worst:.3f} (tol atol {atol:g} + rtol {rtol:g} "
                  f"* |plain| per element; {n_diff} of {got.numel()} "
                  f"elements differ)  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {case}: kernel disagrees with its plain version")
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        return worst

    def timing(self, name, ms, plain_ms, flops, nbytes, kind, library_ms):
        """Each time is the sorted list from ``cuda_ms``, or a (graphed,
        back-to-back) pair of them from ``device_and_eager_ms``; the
        back-to-back median goes into the result line under its key (one
        clock for every row), the graphed one of a pair beside it as
        graphed_*; the spread is printed. (flops, nbytes, kind): the call's
        ``cost``."""
        b, by = bound_ms(flops, nbytes, kind)
        med = lambda ts: None if ts is None else ts[len(ts) // 2]
        fmt = lambda ts: ("n/a" if ts is None else f"{med(ts):.4f} ms "
                          f"[{ts[0]:.4f}-{ts[-1]:.4f}]")
        times = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
        text = {}
        for key, ts in times.items():
            if isinstance(ts, tuple):
                self.rows[name][key] = med(ts[1])
                self.rows[name]["graphed_" + key] = med(ts[0])
                text[key] = f"{fmt(ts[0])} graphed, {fmt(ts[1])} eager"
            else:
                self.rows[name][key] = med(ts)
                text[key] = fmt(ts)
        self.rows[name].update(bound_ms=b, bound_by=by)
        print(f"  {name:17s} median [min-max] of 5: kernel {text['ms']}"
              f"  plain {text['plain_ms']}  library {text['library_ms']}  "
              f"bound {b:.4f} ms ({by})")


def mib(tensors) -> float:
    return sum(a.numel() * a.element_size() for a in tensors) / 2 ** 20


def sdpa_ms(name, qt, ks, vs, mask, iters):
    """Library time of one ``scaled_dot_product_attention`` call on the
    kernel's own inputs: q as (B, H, Sq, Dh), each K/V set of ``ks``/``vs``
    ((B, S, K, Dh), rotated in turn) as (B, K, S, Dh) with its KV heads
    shared by ``enable_gqa``. Printed beside it, not returned: the same
    call over K/V repeated to the H q-heads first (H/K times the bytes)."""
    import torch.nn.functional as F
    H, K, n = qt.shape[1], ks[0].shape[2], len(ks)
    gqa = device_and_eager_ms(cycling(
        lambda i: F.scaled_dot_product_attention(
            qt, ks[i].transpose(1, 2), vs[i].transpose(1, 2),
            attn_mask=mask, enable_gqa=True), n), iters)
    rep = lambda a: a.repeat_interleave(H // K, dim=2).transpose(1, 2)
    kxs, vxs = [rep(a) for a in ks], [rep(a) for a in vs]
    full = device_and_eager_ms(cycling(
        lambda i: F.scaled_dot_product_attention(
            qt, kxs[i], vxs[i], attn_mask=mask), n), iters)
    med = lambda ts: (f"{ts[0][len(ts[0]) // 2]:.4f} ms graphed, "
                      f"{ts[1][len(ts[1]) // 2]:.4f} eager")
    print(f"  {name:17s} SDPA, KV heads shared (enable_gqa; the library "
          f"time): {med(gqa)}; over K/V repeated to {H} heads first "
          f"({mib(kxs + vxs):.0f} MiB): {med(full)}")
    return gqa


# ----------------------------- kernel checks ---------------------------------

def check_flash(res: Results, rng, dev, H, K, Dh):
    """flash_attention against its plain version: the serving prefill's
    512-token prompt (timed), the training shape (B=2, S=512, a per-row
    count), a prompt that is not a multiple of the 64-row tile, and ragged
    f32 / bf16 counts. Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, B, S, keep fraction, counts, timed)
        ("bf16", 1, 512, 0.6, None, True),
        ("f32", 2, 384, 0.7, [384, 200], False),
        ("bf16", 2, 256, 0.5, [256, 77], False),
        ("bf16", 2, 512, 0.8, [512, 347], False),
        ("bf16", 1, 300, 0.9, None, False),
    ]
    outs = {}
    for kind, B, S, keep, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        q = torch.randn(B, S, H, Dh, device=dev).to(dt)
        k = torch.randn(B, S, K, Dh, device=dev).to(dt)
        v = torch.randn(B, S, K, Dh, device=dev).to(dt)
        valid = torch.from_numpy(rng.random((B, S)) < keep).to(dev)
        cnt = None if counts is None else torch.tensor(counts, device=dev,
                                                       dtype=torch.int32)
        kw = dict(kv_valid=valid, kv_count=cnt, causal=True)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, backend="ref", **kw)
        case = f"{kind} B={B} S={S} H={H} K={K} keep={keep} cnt={counts}"
        res.compare("flash_attention", case, got, want, kind)
        outs[case] = got
        if not timed:
            continue
        mask = ops.attention_pairs(B, S, S, valid, cnt, True, 0, dev)
        res.timing(
            "flash_attention",
            device_and_eager_ms(lambda: ops.flash_attention(q, k, v, **kw),
                                20),
            device_and_eager_ms(lambda: ops.flash_attention(
                q, k, v, backend="ref", **kw), 5),
            *cost("flash_attention", q, k, v, **kw),
            sdpa_ms("flash_attention", q.transpose(1, 2), [k], [v],
                    mask[:, None], 20))
    return outs


def composite_ms(x, wi, wo, wg, tw, act):
    """CUDA-event times of a cuBLAS bf16 composite of the MLP on the
    kernel's inputs (x already gathered): x@wi, x@wg, act*mul, h@wo, *tw.
    Several PyTorch calls, not one: printed as a yardstick, never a
    row's library_ms."""
    import torch.nn.functional as F
    f = F.silu if act == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))

    def run():
        h = x @ wi
        h = f(x @ wg) * h if wg is not None else f(h)
        y = h @ wo
        return y if tw is None else y * tw[..., None].to(y.dtype)
    return cuda_ms(run, 5)


def mlp_timing(res: Results, name, label, run, composite, work):
    """Times one MLP case (kernel, plain version) and prints the cuBLAS
    composite beside it. label "main": the row's timing; any other label:
    kept in the row under cases[label] (ms, plain_ms, bound_ms, bound_by).
    ``work``: the call's ``cost``."""
    ms, plain = cuda_ms(run, 5), cuda_ms(lambda: run("ref"), 3)
    comp = composite()
    med = lambda ts: ts[len(ts) // 2]
    print(f"  {name:17s} {label}: cuBLAS bf16 composite (x@wi, x@wg, "
          f"act*mul, h@wo, *tw; a yardstick, several calls) {med(comp):.4f} "
          f"ms [{comp[0]:.4f}-{comp[-1]:.4f}]")
    if label == "main":
        res.timing(name, ms, plain, *work, None)
        return
    b, by = bound_ms(*work)
    res.rows[name].setdefault("cases", {})[label] = dict(
        ms=med(ms), plain_ms=med(plain), composite_ms=med(comp), bound_ms=b,
        bound_by=by)
    print(f"  {name:17s} {label} median [min-max] of 5: kernel "
          f"{med(ms):.4f} ms [{ms[0]:.4f}-{ms[-1]:.4f}]  plain "
          f"{med(plain):.4f} ms  bound {b:.4f} ms ({by})")


def check_fused_mlp(res: Results, dev, D, Fd):
    """fused_mlp against its plain version at Qwen2-7B widths and small
    ones, bf16 (the tensor-core body at widths that are multiples of 64)
    and f32 (the CUDA-core body). Timed, each beside a cuBLAS composite:
    the ring prefill's 512-token call (the row's time), the training shape
    (B=2, T=512) and a paged prefill chunk's 16-row call (bound by the
    weights' bytes). Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, x shape, D, F, act, gated, token weights, counts, timed)
        ("bf16", (1, 512), D, Fd, "swiglu", True, False, None, "main"),
        ("bf16", (2, 512), D, Fd, "swiglu", True, False, None, "train"),
        ("bf16", (1, 16), D, Fd, "swiglu", True, False, None, "chunk"),
        ("bf16", (2, 77), D, Fd, "swiglu", True, True, [77, 30], None),
        ("f32", (2, 96), D, Fd, "swiglu", True, True, [96, 41], None),
        ("f32", (1, 70), 256, 512, "gelu", False, True, [70], None),
    ]
    outs = {}
    for kind, xs, d, f, act, gated, weighted, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        x = torch.randn(*xs, d, device=dev).to(dt)
        w = lambda a, b: (torch.randn(a, b, device=dev) / a ** 0.5).to(dt)
        wi, wo = w(d, f), w(f, d)
        wg = w(d, f) if gated else None
        tw = torch.rand(*xs, device=dev) if weighted else None
        cnt = None if counts is None else torch.tensor(counts, device=dev,
                                                       dtype=torch.int32)
        run = lambda backend=None: ops.fused_mlp(
            x, wi, wo, wg, tw, cnt, act=act, backend=backend)
        case = f"{kind} x={tuple(x.shape)} F={f} {act} cnt={counts}"
        outs[case] = run()
        res.compare("fused_mlp", case, outs[case], run("ref"), kind)
        if not timed:
            continue
        mlp_timing(res, "fused_mlp", timed, run,
                   lambda: composite_ms(x, wi, wo, wg, tw, act),
                   cost("fused_mlp", x, wi, wo, wg, tw, cnt))
    return outs


def check_fused_mlp_routed(res: Results, rng, dev, D, Fd):
    """The routed MLP at a training step's shapes: B=2, S=512, a 256-row
    bucket with counts (256, 200) (timed, beside a cuBLAS composite on the
    gathered rows); plus a small ungated case whose bucket is the whole
    sequence. Rows outside the live selection must be exactly zero.
    Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, B, S, Kb, D, F, act, gated, counts, timed)
        ("bf16", 2, 512, 256, D, Fd, "swiglu", True, [256, 200], True),
        ("f32", 2, 512, 256, D, Fd, "swiglu", True, [256, 200], False),
        ("f32", 2, 96, 96, 256, 512, "gelu", False, [96, 0], False),
    ]
    outs = {}
    for kind, B, S, Kb, d, f, act, gated, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        x = torch.randn(B, S, d, device=dev).to(dt)
        w = lambda a, b: (torch.randn(a, b, device=dev) / a ** 0.5).to(dt)
        wi, wo = w(d, f), w(f, d)
        wg = w(d, f) if gated else None
        # a RoutingPlan's layout: the selection ascending, then the rest
        idx_np = np.stack([np.concatenate([np.sort(p[:c]), np.sort(p[c:Kb])])
                           for p, c in ((rng.permutation(S), c)
                                        for c in counts)])
        idx = torch.from_numpy(idx_np.astype(np.int64)).to(dev)
        tw = torch.rand(B, Kb, device=dev)
        cnt = torch.tensor(counts, device=dev, dtype=torch.int32)
        run = lambda backend=None: ops.fused_mlp_routed(
            x, idx, wi, wo, wg, tw, cnt, act=act, backend=backend)
        got = run()
        case = f"{kind} x={tuple(x.shape)} Kb={Kb} F={f} {act} cnt={counts}"
        outs[case] = got
        res.compare("fused_mlp_routed", case, got, run("ref"), kind)
        live = torch.zeros(B, S, dtype=torch.bool, device=dev)
        for b, c in enumerate(counts):
            live[b, idx[b, :c]] = True
        n_dead = int((~live).sum())
        if got[~live].count_nonzero() != 0:
            fail(f"fused_mlp_routed {kind}: a row outside the selection is "
                 f"not zero")
        print(f"  fused_mlp_routed  {n_dead} rows outside the selection: all "
              f"exactly zero")
        if not timed:
            continue
        xg = torch.gather(x, 1, idx[..., None].expand(B, Kb, d))
        mlp_timing(res, "fused_mlp_routed", "main", run,
                   lambda: composite_ms(xg, wi, wo, wg, tw, act),
                   cost("fused_mlp_routed", x, idx, wi, wo, wg, tw, cnt))
    return outs


def _ring(rng, B, L, t, keep):
    """Ring-cache positions written up to per-slot t (slot = pos % L), -1
    for never-written slots, and a routing validity mask."""
    slots = np.arange(L)[None, :]
    tt = np.asarray(t)[:, None]
    pos = np.where(slots <= tt % L, tt - tt % L, tt - tt % L - L) + slots
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    return pos, rng.random((B, L)) < keep


def check_decode_edges(res: Results, rng, dev, H, K, Dh, L):
    import torch
    from repro_torch.kernels import ops
    split = ops.decode_split_plan(L)[0]
    t = np.asarray([split - 1, split, split + 1, 700, 0], np.int32)
    B = len(t)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pos_np, valid_np = _ring(rng, B, L, t, 0.8)
        valid_np[3] = False                    # every key of slot 3 masked
        pos_np[4] = -1                         # slot 4 inactive
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        k = torch.randn(B, L, K, Dh, device=dev).to(dt)
        v = torch.randn(B, L, K, Dh, device=dev).to(dt)
        pos, valid, tv = (torch.from_numpy(a).to(dev)
                          for a in (pos_np, valid_np, t))
        run = lambda backend=None: ops.decode_attention(
            q, k, v, pos, tv, valid, backend=backend)
        outs[f"edges {kind}"] = got = run()
        res.compare("decode_attention", f"{kind} B={B} L={L} t={t.tolist()} "
                    f"split edges", got, run("ref"), kind)
        if got[3:].count_nonzero() != 0:
            fail("decode_attention: a slot with no attendable key is not "
                 "zero")
    return outs


def check_decode(res: Results, rng, dev, H, K, Dh, L, edges=True):
    """decode_attention against its plain version at the ring serving
    path's shape (4 slots, L=1024; bf16 timed L2-cold, f32 windowed) and,
    with ``edges``, at the kernel's split edges: t = split - 1, split,
    split + 1, a slot whose every key is masked and an inactive slot (no
    position written), the last two exact zeros. Returns the outputs."""
    import torch
    from repro_torch.kernels import ops
    outs = check_decode_edges(res, rng, dev, H, K, Dh, L) if edges else {}
    B = 4
    t = np.asarray([63, 300, L - 1, L + 476], np.int32)   # last one wrapped
    cases = [("bf16", 0, True), ("f32", 256, False)]      # (dtype, window)
    for kind, window, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pos_np, valid_np = _ring(rng, B, L, t, 0.8)
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        k = torch.randn(B, L, K, Dh, device=dev).to(dt)
        v = torch.randn(B, L, K, Dh, device=dev).to(dt)
        pos, valid = (torch.from_numpy(a).to(dev) for a in (pos_np, valid_np))
        tv = torch.from_numpy(t).to(dev)
        run = lambda backend=None: ops.decode_attention(
            q, k, v, pos, tv, valid, window=window, backend=backend)
        outs[kind] = run()
        res.compare("decode_attention", f"{kind} B={B} L={L} H={H} K={K} "
                    f"window={window} ring holes", outs[kind], run("ref"),
                    kind)
        if not timed:
            continue
        att = (pos_np >= 0) & (pos_np <= t[:, None]) & valid_np
        if window:
            att &= (t[:, None] - pos_np) < window
        esz = q.element_size()
        # On the serving path every layer has its own ring cache, so decode
        # finds K/V cold in HBM. Time it that way: rotate over enough K/V
        # sets (same masks) that their total is twice the L2 cache.
        n_sets = 1 + 2 * L2_BYTES // (k.numel() * esz * 2)
        ks = [k] + [torch.randn_like(k) for _ in range(n_sets - 1)]
        vs = [v] + [torch.randn_like(v) for _ in range(n_sets - 1)]
        mask = torch.from_numpy(att).to(dev)[:, None, None, :]
        dec = lambda backend: cycling(lambda i: ops.decode_attention(
            q, ks[i], vs[i], pos, tv, valid, window=window,
            backend=backend), n_sets)
        print(f"  decode_attention  timed L2-cold: rotating over {n_sets} "
              f"K/V sets ({mib(ks + vs):.0f} MiB)")
        res.timing("decode_attention", device_and_eager_ms(dec(None), 50),
                   device_and_eager_ms(dec("ref"), 10),
                   *cost("decode_attention", q, k, v, pos, tv, valid,
                         window=window),
                   sdpa_ms("decode_attention", q.transpose(1, 2), ks, vs,
                           mask, 50))
        del ks, vs
    return outs


PAGE_SIZE = 16                 # the JAX engine's default page size


def _paged_case(rng, B, N, ps, P):
    """Page-table rows for B slots of P entries over a pool of N pages (the
    last one the trash page), in shuffled pool order: row 0 mid-page with
    a -1 hole, row 1 full, row 2 all -1 (an inactive slot: exact zeros),
    row 3 at the first lane of a page. Returns (table, t)."""
    pages = iter(rng.permutation(N - 1))
    t = np.asarray([8 * ps + 4, P * ps - 1, 300, 16 * ps], np.int32)[:B]
    table = np.full((B, P), -1, np.int32)
    for b in (0, 1, 3):
        for p in range(int(t[b]) // ps + 1):
            table[b, p] = next(pages)
    table[0, 5] = -1
    return table, t


def paged_attendable(table, t, pvalid):
    """``ops.paged_keys``: (R, P * ps) bool masks of one (or, leading
    dimensions, several stacked) ``paged_decode_attention`` call's keys,
    attended and visited."""
    from repro_torch.kernels import ops
    return ops.paged_keys(table, t, pvalid)[:2]


def paged_work(q, kp, vp, table, t, pvalid, kscale=None, vscale=None):
    """(``cost`` of one ``paged_decode_attention`` call on this data,
    attendable keys): q and out, the attended K/V rows (int8: 1 byte an
    element plus the f32 scale) and the pvalid lanes of the visited keys,
    each once however many q rows share its page (the rows of a prefill
    chunk share all of theirs), the table and t; FLOPs count every (q row,
    attendable key) pair."""
    return (cost("paged_decode_attention", q, kp, vp, table, t, pvalid,
                 kscale, vscale),
            int(paged_attendable(table, t, pvalid)[0].sum()))


def paged_cold(q, kp, vp, table, t, pvalid):
    """Kernel and plain times of one ``paged_decode_attention`` call,
    L2-cold: on the serving path every layer has its own pool, so rotate
    over enough pools (same table, t and pvalid) that their total is twice
    the L2 cache. Returns (kernel times, plain times, K pools, V pools),
    each time a (graphed, back-to-back) pair (``device_and_eager_ms``)."""
    import torch
    from repro_torch.kernels import ops
    n_sets = 1 + 2 * L2_BYTES // (kp.numel() * kp.element_size() * 2)
    kps = [kp] + [torch.randn_like(kp) for _ in range(n_sets - 1)]
    vps = [vp] + [torch.randn_like(vp) for _ in range(n_sets - 1)]
    dec = lambda backend: cycling(lambda i: ops.paged_decode_attention(
        q, kps[i], vps[i], table, t, pvalid, backend=backend), n_sets)
    print(f"  paged_decode_attention timed L2-cold: rotating over {n_sets} "
          f"pools ({mib(kps + vps):.0f} MiB)")
    return (device_and_eager_ms(dec(None), 50),
            device_and_eager_ms(dec("ref"), 10), kps, vps)


def check_paged_decode(res: Results, rng, dev, H, K, Dh, max_seq):
    """paged_decode_attention against its plain version at the paged
    serving path's shape (4 slots, page size 16, max_seq 1024: 64 entries
    per row, the ring-equivalent pool of 4 * 64 + 1 pages), bf16 and f32,
    with pvalid holes; timed L2-cold beside SDPA over the pre-gathered
    buffer and the gather alone."""
    import torch
    from repro_torch.kernels import ops
    B, ps = 4, PAGE_SIZE
    P = max_seq // ps
    N = B * P + 1
    table_np, t = _paged_case(rng, B, N, ps, P)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pvalid_np = rng.random((N, ps)) < 0.8
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        kp = torch.randn(N, ps, K, Dh, device=dev).to(dt)
        vp = torch.randn(N, ps, K, Dh, device=dev).to(dt)
        table, tv, pvalid = (torch.from_numpy(a).to(dev)
                             for a in (table_np, t, pvalid_np))
        run = lambda backend=None: ops.paged_decode_attention(
            q, kp, vp, table, tv, pvalid, backend=backend)
        outs[kind] = got = run()
        res.compare("paged_decode_attention", f"{kind} B={B} P={P} ps={ps} "
                    f"N={N} H={H} K={K} holes", got, run("ref"), kind)
        if got[2].count_nonzero() != 0:
            fail("paged_decode_attention: the all -1 row is not zero")
        if kind != "bf16":
            continue
        work, keys = paged_work(q, kp, vp, table, tv, pvalid)
        print(f"  paged_decode_attention {keys} attendable keys of "
              f"{B * P * ps}")
        ms, plain, kps, vps = paged_cold(q, kp, vp, table, tv, pvalid)
        pid = table.clamp(min=0).long()
        gather = lambda i: (kps[i][pid].reshape(B, P * ps, K, Dh),
                            vps[i][pid].reshape(B, P * ps, K, Dh))
        kvs = [gather(i) for i in range(len(kps))]
        mask = paged_attendable(table, tv, pvalid)[0][:, None, None, :]
        res.timing("paged_decode_attention", ms, plain, *work,
                   sdpa_ms("paged_decode_attention", q.transpose(1, 2),
                           [k for k, _ in kvs], [v for _, v in kvs], mask,
                           50))
        g = cuda_ms(cycling(gather, len(kps)), 50)
        print(f"  paged_decode_attention beside it: the page gather alone "
              f"(K and V to (B, P*ps, K, Dh), what SDPA needs first) "
              f"{g[len(g) // 2]:.4f} ms [{g[0]:.4f}-{g[-1]:.4f}]")
        del kps, vps, kvs
    return outs


class PathCalls:
    """Records what decides the work of every call to the kernel wrappers
    ``names`` (default all of ``DATA``) made while active: each tensor
    operand's shape and dtype, copies of the operands that ``DATA`` names
    (masks, positions, page tables, counts; the caches change after the
    call), and the other arguments. The model calls the kernels through
    the ``ops`` module, so a delegating wrapper put there sees each call;
    the kernel wrappers and their launch counts are untouched. A captured
    graph's replay calls no wrapper: record a ``cuda_graphs=False``
    engine."""

    DATA = {"flash_attention": ("kv_valid", "kv_count"),
            "decode_attention": ("kv_pos", "t", "kv_valid"),
            "fused_mlp": ("token_weights", "valid_count"),
            "fused_mlp_routed": ("idx", "token_weights", "valid_count"),
            "paged_decode_attention": ("table", "t", "pvalid"),
            "moe_gmm": ("group_counts",)}
    # the kernels check_path_calls replays (the others have their own)
    REPLAYED = ("flash_attention", "decode_attention", "fused_mlp")
    # one recorded call of each launch signature (kernel, the tensors'
    # shapes and dtypes, the other arguments) of every path recorded so
    # far: phase (i) holds each one's launch statement to its launcher
    signatures: dict = {}

    def __init__(self, *names):
        self.names = names or tuple(self.DATA)

    def __enter__(self):
        import inspect
        import torch
        from repro_torch.kernels import ops
        self.calls, self._ops, self._orig = {}, ops, {}
        for name in self.names:
            orig = self._orig[name] = getattr(ops, name)
            sig = inspect.signature(orig)

            def record(*a, _name=name, _orig=orig, _sig=sig,
                       _data=self.DATA[name], **kw):
                bound = _sig.bind(*a, **kw)
                bound.apply_defaults()      # e.g. flash's ``causal`` flag
                args = bound.arguments
                rec = {}
                for k, v in args.items():
                    if not isinstance(v, torch.Tensor):
                        rec[k] = v
                    elif k in _data:
                        rec[k] = v.detach().clone()
                    else:
                        rec[k] = ("shape", tuple(v.shape), v.dtype)
                self.calls.setdefault(_name, []).append(rec)
                return _orig(*a, **kw)
            setattr(ops, name, record)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self._ops, name, orig)
        for name, cs in self.calls.items():
            for c in cs:
                key = (name,) + tuple(
                    (k, v[1:] if isinstance(v, tuple) and v[:1] == ("shape",)
                     else (tuple(v.shape), v.dtype) if hasattr(v, "shape")
                     else repr(v)) for k, v in c.items())
                PathCalls.signatures.setdefault(key, (name, c))

    @staticmethod
    def _work(name, c):
        """A call's work on its data: attendable (query, key) pairs for
        the attention kernels, rows for the MLP."""
        import torch
        if name == "flash_attention":
            return int(PathCalls.flash_mask(c).sum())
        if name == "decode_attention":
            return int(PathCalls.decode_mask(c).sum())
        if name == "fused_mlp_routed":      # the selected rows
            B, Kb = c["idx"].shape
            cnt = c.get("valid_count")
            return B * Kb if cnt is None else int(
                torch.as_tensor(cnt).clamp(0, Kb).expand(B).sum())
        return int(np.prod(c["x"][1][:-1]))

    @staticmethod
    def flash_mask(c):
        """A recorded flash call's (B, Sq, Sk) attendable pairs
        (``ops.attention_pairs``)."""
        from repro_torch.kernels import ops
        B, Sq = c["q"][1][:2]
        valid, cnt = c.get("kv_valid"), c.get("kv_count")
        dev = next((v.device for v in (valid, cnt) if hasattr(v, "device")),
                   None)
        return ops.attention_pairs(B, Sq, c["k"][1][1], valid, cnt,
                                   c.get("causal", True), c.get("window", 0),
                                   dev)

    @staticmethod
    def decode_mask(c):
        """A recorded ring decode call's (B, L) attendable keys: written,
        at or before t, inside the window, valid (``ops.ring_attended``)."""
        from repro_torch.kernels import ops
        return ops.ring_attended(c["kv_pos"], c["t"], c.get("kv_valid"),
                                 c.get("window", 0))

    def heaviest(self):
        """The call of each of ``REPLAYED`` with the most work on its data,
        flash's non-causal calls (encoder self-attention, cross-attention)
        apart from its causal ones, under "flash_attention non-causal",
        and the attention calls with a sliding window apart from the
        global ones, under "... window"."""
        groups = {}
        for name, cs in self.calls.items():
            if name not in self.REPLAYED:
                continue
            for c in cs:
                key = name if c.get("causal", True) else f"{name} non-causal"
                if c.get("window"):
                    key += " window"
                groups.setdefault(key, (name, []))[1].append(c)
        return {key: max(cs, key=lambda c: self._work(name, c))
                for key, (name, cs) in groups.items()}

    def paged_cases(self, chunk=256):
        """The heaviest ``paged_decode_attention`` call (most attendable
        keys) of each (q, pool) shape as (q shape, pool shape, table, t,
        pvalid, calls of that shape), the most q rows first."""
        import torch
        groups = {}
        for c in self.calls.get("paged_decode_attention", []):
            groups.setdefault((c["q"][1], c["kp"][1]), []).append(
                (c["table"], c["t"].reshape(-1), c["pvalid"]))
        out = []
        for (qs, ks), cs in groups.items():
            keys = torch.cat([paged_attendable(
                *(torch.stack([c[i] for c in cs[j:j + chunk]])
                  for i in range(3)))[0].sum((1, 2))
                for j in range(0, len(cs), chunk)])
            out.append((qs, ks, *cs[int(keys.argmax())], len(cs)))
        return sorted(out, key=lambda c: -c[0][0])

    def gmm_cases(self):
        """The heaviest ``moe_gmm`` call (most dispatched rows) of each
        distinct shape as (shape, (B, E) numpy counts), the largest shape
        first."""
        best = {}
        for c in self.calls.get("moe_gmm", []):
            shape = c["x"][1]
            cnt = c["group_counts"].cpu().numpy().reshape(shape[0], shape[1])
            if shape not in best or cnt.sum() > best[shape].sum():
                best[shape] = cnt
        return sorted(best.items(), key=lambda kv: (-np.prod(kv[0]),
                                                    -kv[1].sum()))


def check_paged_calls(res: Results, dev, cases, labels):
    """Replays the paged serving path's own ``paged_decode_attention``
    calls: the heaviest of each shape (a decode step's slot rows, a prefill
    chunk's rows: one table row repeated, t = pos0 + i) with its recorded
    table, t and pvalid and a random q and pool, in bf16 and f32, against
    the plain version; a row with no attendable key must be exact zeros.
    Each is timed L2-cold in bf16 beside its bound (printed; the kernel's
    row keeps check_paged_decode's time)."""
    import torch
    from repro_torch.kernels import ops
    for qs, ks, table, t, pvalid, n in cases:
        label = labels.get(qs[0], f"{qs[0]}-row")
        dead = ~paged_attendable(table, t, pvalid)[0].any(1)
        for kind in ("bf16", "f32"):
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            q = torch.randn(qs, device=dev).to(dt)
            kp = torch.randn(ks, device=dev).to(dt)
            vp = torch.randn(ks, device=dev).to(dt)
            run = lambda backend=None: ops.paged_decode_attention(
                q, kp, vp, table, t, pvalid, backend=backend)
            got = run()
            res.compare("paged_decode_attention", f"{kind} path {label} "
                        f"q {qs[0]} rows, t {int(t.min())}-{int(t.max())}",
                        got, run("ref"), kind)
            if got[dead].count_nonzero() != 0:
                fail(f"paged_decode_attention, the path's {label} call: a "
                     f"row with no attendable key is not zero")
            if kind != "bf16":
                continue
            work, keys = paged_work(q, kp, vp, table, t, pvalid)
            ms, plain, _, _ = paged_cold(q, kp, vp, table, t, pvalid)
            b, by = bound_ms(*work)
            med = lambda tt: " / ".join(
                f"{ts[len(ts) // 2]:.4f} ms [{ts[0]:.4f}-{ts[-1]:.4f}]"
                for ts in tt) + " (graphed / eager)"
            print(f"  paged_decode_attention path {label}, heaviest of {n} "
                  f"calls ({keys} attendable keys, {int(dead.sum())} "
                  f"row(s) with none): kernel {med(ms)}  plain "
                  f"{med(plain)}  bound {b:.4f} ms ({by})")


def gmm_composite_ms(x, wi, wg, wo, counts, act):
    """(graphed, back-to-back) CUDA-event times of a cuBLAS bf16 composite
    of ``moe_gmm`` without routing weights: a zeroed output, then for every
    live group its live slots through x@wi, x@wg, act*mul, h@wo on
    contiguous copies of the expert weights (copied before the timing).
    Several PyTorch calls per live group, not one: printed as a yardstick,
    never the row's library_ms; the graphed time is the device's (the
    back-to-back one is the host's cost of ~5 calls per group at 60
    experts)."""
    import torch.nn.functional as F
    f = F.silu if act == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    E = wi.shape[0]
    wic = [wi[e].contiguous() for e in range(E)]
    wgc = [wg[e].contiguous() for e in range(E)]
    woc = [wo[e].contiguous() for e in range(E)]
    live = [(b, e, int(c)) for (b, e), c in np.ndenumerate(counts) if c > 0]

    def run():
        out = x.new_zeros(x.shape)
        for b, e, c in live:
            xs = x[b, e, :c]
            out[b, e, :c] = (f(xs @ wgc[e]) * (xs @ wic[e])) @ woc[e]
        return out
    return device_and_eager_ms(run, 5)


def gmm_tile_rows_ms(main):
    """``main``'s graphed times (``cuda_ms``) and output with the
    tensor-core plan's tile rows forced to 64 and to 128 (``ops.mlp_plan``
    patched for the call; ``--gmm-tile-rows``): the measurement behind the
    plan's choice of tile rows for ``moe_gmm``."""
    from repro_torch.kernels import ops
    orig, got = ops.mlp_plan, {}
    try:
        for rows in (64, 128):
            ops.mlp_plan = lambda *a, rows=rows: orig(*a)._replace(rows=rows)
            got[rows] = (cuda_ms(main, 5, graph=True), main())
    finally:
        ops.mlp_plan = orig
    return got


def check_moe_gmm(res, dev, label, cases, weights_of, timed,
                  tile_rows=False, act="swiglu"):
    """Replays a path's own ``moe_gmm`` calls on the card: each recorded
    (shape, counts) with random x and routing weights and the layout's
    expert weights ``weights_of(dtype) -> (wi, wg, wo)`` (strided moefied
    views or contiguous native stacks), in bf16 and f32, with and without
    routing weights, against the plain version; every slot at or past its
    count must be exactly zero, and each output must repeat bit for bit.
    The heaviest call of the largest shape in bf16 without weights (the
    path's own call) is timed beside its bound and a cuBLAS per-expert
    composite (and, with ``tile_rows``, the tensor-core body at 64- and
    128-row tiles): ``timed`` makes it the row's timing, else it is kept in
    the row under cases[label]. Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    print(f"  moe_gmm {label}: {len(cases)} distinct call shapes, the "
          f"heaviest call of each replayed")
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        wi, wg, wo = weights_of(dt)
        Fe = wi.shape[-1]
        for ci, (shape, counts) in enumerate(cases):
            B, E, C, D = shape
            x = torch.randn(shape, device=dev).to(dt)
            cnt = torch.from_numpy(counts.astype(np.int32)).to(dev)
            live = torch.arange(C, device=dev) < cnt[..., None]
            plan = ops.mlp_plan(dt, B * E, C, D, Fe)
            for weighted in (False, True):
                rw = torch.rand(B, E, C, device=dev) if weighted else None
                run = lambda backend=None: ops.moe_gmm(
                    x, wi, wo, wg, rw, cnt, act=act, backend=backend)
                got = run()
                case = (f"{kind} {label} {tuple(shape)} rows "
                        f"{int(counts.sum())} w={'y' if weighted else 'n'}")
                outs[case] = got
                res.compare("moe_gmm", case, got, run("ref"), kind)
                if got[~live].count_nonzero() != 0:
                    fail(f"moe_gmm {label} {kind} {shape}: a slot past its "
                         f"count is not zero")
                if not torch.equal(got, run()):
                    fail(f"moe_gmm {label} {kind} {shape}: a repeat gives "
                         f"other bits")
            if kind == "bf16":
                lv = counts[counts > 0]
                print(f"  moe_gmm           {label} {tuple(shape)}: plan "
                      f"{tuple(plan)}; counts sum {int(counts.sum())}, "
                      f"{int((counts == 0).sum())} empty group(s), live "
                      f"groups' counts min / median / max {int(lv.min())} / "
                      f"{int(np.median(lv))} / {int(lv.max())}; "
                      f"{int((~live).sum())} slots past their counts: all "
                      f"exactly zero; repeats bit-identical")
            if kind != "bf16" or ci != 0:
                continue
            rows = int(counts.sum())
            main = lambda backend=None: ops.moe_gmm(     # no weights
                x, wi, wo, wg, None, cnt, act=act, backend=backend)
            args = (device_and_eager_ms(main, 5),
                    cuda_ms(lambda: main("ref"), 3),
                    *cost("moe_gmm", x, wi, wo, wg, None, cnt), None)
            comp = gmm_composite_ms(x, wi, wg, wo, counts, act)
            tiles = gmm_tile_rows_ms(main) if tile_rows and \
                plan.body == "wgmma" else {}
            med = lambda ts: ts[len(ts) // 2]
            print(f"  moe_gmm           {label}: cuBLAS bf16 per-expert "
                  f"composite (a yardstick, ~5 calls per live group) "
                  f"{med(comp[0]):.4f} ms graphed [{comp[0][0]:.4f}-"
                  f"{comp[0][-1]:.4f}], {med(comp[1]):.4f} ms eager")
            want = main()
            for r, (ts, o) in tiles.items():
                print(f"  moe_gmm           {label}: {r}-row tiles "
                      f"{med(ts):.4f} ms [{ts[0]:.4f}-{ts[-1]:.4f}] "
                      f"graphed; the "
                      f"same bits as the plan's {plan.rows}-row tiles: "
                      f"{torch.equal(o, want)}")
            extra = dict(shape=list(shape), rows=rows,
                         composite_ms=med(comp[1]),
                         graphed_composite_ms=med(comp[0]),
                         **{f"rows{r}_ms": med(ts)
                            for r, (ts, _) in tiles.items()})
            if timed:
                res.timing("moe_gmm", *args)
                res.rows["moe_gmm"].update(extra)
                continue
            b, by = bound_ms(*args[2:5])
            (graphed, eager), plain = args[:2]
            res.rows["moe_gmm"].setdefault("cases", {})[label] = dict(
                ms=med(eager), graphed_ms=med(graphed), plain_ms=med(plain),
                bound_ms=b, bound_by=by, **extra)
            print(f"  moe_gmm           {label} {tuple(shape)} median "
                  f"[min-max] of 5: kernel {med(graphed):.4f} ms "
                  f"[{graphed[0]:.4f}-{graphed[-1]:.4f}] graphed, "
                  f"{med(eager):.4f} ms [{eager[0]:.4f}-{eager[-1]:.4f}] "
                  f"eager  plain {med(plain):.4f} ms [{plain[0]:.4f}-"
                  f"{plain[-1]:.4f}]  bound {b:.4f} ms ({by})")
        del wi, wg, wo
    return outs


def moefied_weights(dev, D, F, E):
    """``weights_of`` for the moefied Qwen2-7B: random dense (D, F) / (F,
    D) matrices and their expert views (core/moefy.py, no copy)."""
    import torch
    from repro_torch.core.moefy import moefy_mlp

    def of(dt):
        w = lambda *sh: (torch.randn(*sh, device=dev) / sh[0] ** 0.5).to(dt)
        ep = moefy_mlp({"wi": w(D, F), "wg": w(D, F), "wo": w(F, D)}, E)
        return ep["wi"], ep["wg"], ep["wo"]
    return of


def native_weights(dev, cfg):
    """``weights_of`` for the native MoE: contiguous (E, D, Fe) / (E, Fe,
    D) expert stacks, as ``moe_init`` lays them out."""
    import torch
    E, D, Fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert

    def of(dt):
        w = lambda *sh: (torch.randn(*sh, device=dev) / sh[1] ** 0.5).to(dt)
        return w(E, D, Fe), w(E, D, Fe), w(E, Fe, D)
    return of


# ------------------------------- serving -------------------------------------

def serve(engine, requests, stagger: bool, after_step=None):
    """Submit two requests, step twice, submit the rest, run to the end.
    A request is (prompt, max_new_tokens, budget[, GenRequest kwargs[,
    extra_inputs]]) (extra inputs: a VLM's image row, an
    encoder-decoder's frames);
    ``after_step(handles)`` runs after every step. A graphed engine's
    ``compile_counts()`` is gated after the run (``check_counts``)."""
    from repro_torch.training import GenRequest
    first = 2 if stagger else len(requests)
    make = lambda r: GenRequest(r[0], r[1], budget=r[2],
                                **(r[3] if len(r) > 3 else {}))
    sub = lambda r: engine.submit(make(r), **(
        {"extra_inputs": r[4]} if len(r) > 4 else {}))
    handles = [sub(r) for r in requests[:first]]

    def step():
        progressed = engine.step()
        if after_step is not None:
            after_step(handles)
        return progressed
    if stagger:
        for _ in range(2):
            step()
        handles += [sub(r) for r in requests[first:]]
    while not all(h.done for h in handles):
        if step() == 0:
            fail("serving engine stalled")
    if getattr(engine, "cuda_graphs", False):    # (--ab: an older tree's)
        check_counts(f"a graphed {engine.kv_layout} engine", engine)
    return [list(h.output) for h in handles]


def cache_tensors(tree):
    """Every tensor of a cache tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_tensors(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in cache_tensors(v)]
    return [tree]


def check_counts(label, engine):
    """Fails unless ``engine.compile_counts()`` is what a graphed engine
    builds whatever its budgets, slots and sampling settings: one chunk
    form on the paged layout (none on the ring: its admission is eager)
    and at most two decode forms, greedy-only and sampling."""
    counts = engine.compile_counts()
    paged = engine.kv_layout == "paged"
    if counts["prefill"] != int(paged) or not 1 <= counts["decode"] <= 2:
        fail(f"{label}: compile_counts {counts}, want prefill "
             f"{int(paged)} and decode 1 or 2")
    return counts


def engine_cache_tensors(engine):
    """``cache_tensors`` of an engine's caches; a paged pool's leaves
    without the trash page. That page is the sink of the writes no live
    page may take (inactive slots, tokens a router skipped, a shared final
    chunk): several slots write one lane of it in one scatter, in no fixed
    order, so its content is unspecified. Nothing reads it: the paged
    kernel reads only the pages of a slot's table row, and this fails
    unless the trash page is out of every table row, every freelist and
    the refcounts (it was never allocated)."""
    import torch
    leaves = cache_tensors(engine._caches)
    if engine.kv_layout != "paged":
        return leaves
    pool = engine.pool
    trash = [pool.trash_page(r) for r in range(pool.n_replicas)]
    if np.isin(engine._table, trash).any() or \
            any(t in pool._ref for t in trash) or \
            any(t in free for free in pool._free for t in trash):
        fail("the trash page is in a page-table row, a freelist or the "
             "refcounts")
    keep = torch.ones(pool.n_pages, dtype=torch.bool, device=engine.device)
    keep[trash] = False
    return [x[keep] for x in leaves]


def check_twin(label, graphed, eager, got, want):
    """A graphed engine against its ``cuda_graphs=False`` twin after the
    same requests: the same tokens, every cache (and pool) leaf (a pool
    without its trash page, ``engine_cache_tensors``) and, paged, the same
    page table and pool stats, bit for bit; prints both engines'
    ``compile_counts()``."""
    import torch
    if not graphed.cuda_graphs or eager.cuda_graphs:
        fail(f"{label}: not a graphed engine and its eager twin")
    if got != want:
        fail(f"{label}: graphed tokens {got} != cuda_graphs=False {want}")
    for a, b in zip(engine_cache_tensors(graphed),
                    engine_cache_tensors(eager)):
        if not torch.equal(a, b):
            fail(f"{label}: a cache leaf of the graphed engine differs from "
                 f"its cuda_graphs=False twin's")
    what = "tokens, caches"
    if graphed.kv_layout == "paged":
        if not np.array_equal(graphed._table, eager._table) or \
                graphed.pool.stats() != eager.pool.stats():
            fail(f"{label}: page table or pool stats differ from the "
                 f"cuda_graphs=False twin's")
        what += " but the trash page, page table, pool stats"
    counts = check_counts(label, graphed)
    print(f"{label}: graphed == cuda_graphs=False twin, bit for bit "
          f"({what}): ok; compile_counts {counts} (twin "
          f"{eager.compile_counts()})")


def twins(label, mk, run, rec=None):
    """``mk(cuda_graphs)`` -> an engine, ``run(engine)`` -> its tokens:
    runs a graphed engine, then its ``cuda_graphs=False`` twin (inside
    ``rec``, a ``PathCalls`` or any context, when given: a replay calls no
    wrapper, so the path's kernel calls are recorded from the twin), and
    holds them equal (``check_twin``). Returns the graphed engine's
    tokens."""
    graphed = mk(True)
    got = run(graphed)
    eager = mk(False)
    with (rec or contextlib.nullcontext()):
        want = run(eager)
    check_twin(label, graphed, eager, got, want)
    return got


def reserved_over(fn, label, device_line):
    """``fn()`` after the allocator's cache is emptied: prints the device
    memory it reserved beyond what was in use before it (the peak; for a
    graphed engine's first run this includes its graph pool). Returns
    fn's result."""
    import torch
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r0 = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    print(f"{label}: {(torch.cuda.max_memory_reserved() - r0) / 1e6:.1f} MB "
          f"of device memory reserved over the run, peak "
          f"[{device_line}]")
    return out


def cut(params, n_layers):
    """The first ``n_layers`` layers of a param or router tree (the
    twins' reduced depth; no copy)."""
    return dict(params, layers=params["layers"][:n_layers])


TWIN_LAYERS = 4     # the depth of the graphed-vs-eager twins of later phases


def twin_depth(cfg) -> int:
    """The reduced twins' depth: ``TWIN_LAYERS``, or the served depth when
    that is less."""
    return min(TWIN_LAYERS, cfg.n_layers)


def print_timing(label, tm, device_line):
    print(f"{label} prefill: {tm['prefill_tokens']} tokens in "
          f"{tm['prefill_s'] * 1e3:.1f} ms = "
          f"{tm['prefill_tokens'] / tm['prefill_s']:.1f} tok/s [{device_line}]")
    print(f"{label} decode: {tm['decode_steps']} steps, {tm['decode_tokens']} "
          f"tokens in {tm['decode_s'] * 1e3:.1f} ms = "
          f"{tm['decode_s'] * 1e3 / tm['decode_steps']:.2f} ms/step, "
          f"{tm['decode_tokens'] / tm['decode_s']:.1f} tok/s [{device_line}]")


def print_device_time(prof, wall_s, top=8):
    """Kernel time on the device by name, from a torch.profiler run, beside
    the host wall time of the same window (device busy share)."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"profiled window: wall {wall_s * 1e3:.1f} ms, kernels "
          f"{busy_ms:.1f} ms on the device ({100 * busy_ms / (wall_s * 1e3):.1f}"
          f" % busy, device-activity profiler on)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  "
              f"{e.key[:100]}")


def profiled(fn, top=8):
    """``fn()`` under torch.profiler, device activity only (host op
    recording would slow the host-bound paths several times); prints the
    device kernel time by name beside the wall time of the window. Returns
    fn's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    print_device_time(prof, time.perf_counter() - t0, top=top)
    return out


def check_serving(args, dev, device_line, spec):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine

    full = get_config("qwen2-7b")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    # the weights cover the deeper of the serving and training depths;
    # serving runs the first --layers of them
    init_cfg = dataclasses.replace(
        full, n_layers=max(args.layers, args.train_layers))
    print(f"model: {cfg.name} d={cfg.d_model} H={cfg.n_heads} K="
          f"{cfg.n_kv_heads} Dh={cfg.d_head} F={cfg.d_ff} V={cfg.vocab_size} "
          f"{cfg.dtype}, depth {cfg.n_layers} of {full.n_layers} layers"
          + ("" if cfg.n_layers == full.n_layers else " (depth cut)"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, init_cfg, spec, device=dev)
    rp = router_init(gen, init_cfg, spec, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for layer in params["layers"] for d in layer.values()
            for p in d.values()) + params["embed"].numel() + \
        params["lm_head"].numel()
    print(f"init: {n / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(args.seed)
    lens = [64, 512, 200, 333, 128, 450]
    budgets = [1.0, 0.75, 0.5, 1.0, 0.5, 0.75]
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 16, b)
                for n, b in zip(lens, budgets)]
    mk = lambda mode, graphs=True: ServingEngine(
        params, rp, cfg, spec, mode=mode, batch_size=4, max_seq=1024,
        device=dev, cuda_graphs=graphs)

    engine = mk("infer")
    ops.reset_launch_counts()
    tokens = reserved_over(lambda: serve(engine, requests, stagger=True),
                           "ring infer, graphed (first run)",
                           device_line)               # the main path
    launches = ops.launch_counts()
    check_launches("serving", launches)
    first = dict(engine.timing)
    print_timing("main path (first run, cold)", first, device_line)
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    eager = mk("infer", graphs=False)
    check_twin(f"ring infer, {cfg.n_layers} layers", engine, eager, tokens,
               reserved_over(lambda: serve(eager, requests, stagger=True),
                             "ring infer, cuda_graphs=False twin",
                             device_line))
    print_timing("ring infer, cuda_graphs=False twin (first run)",
                 eager.timing, device_line)
    graph_vs_eager({"ring graphed": engine, "ring eager": eager},
                   (requests[1][0], 16, 0.75), device_line)
    del eager

    base = mk("base")
    teacher = serve(base, requests, stagger=True)
    print_timing("teacher, mode='base' (warm)", base.timing, device_line)
    nt = twin_depth(cfg)
    cfg_t = dataclasses.replace(cfg, n_layers=nt)
    twins(f"ring teacher (mode='base'), {nt} layers",
          lambda g: ServingEngine(cut(params, nt), rp, cfg_t, spec,
                                  mode="base", batch_size=4, max_seq=1024,
                                  device=dev, cuda_graphs=g),
          lambda e: serve(e, requests, stagger=True))
    for i, b in enumerate(budgets):
        if b == 1.0 and tokens[i] != teacher[i]:
            fail(f"budget-1.0 request {i} differs from the teacher: "
                 f"{tokens[i]} vs {teacher[i]}")
    print("budget 1.0 == mode='base' teacher, bit for bit: ok "
          f"({sum(b == 1.0 for b in budgets)} requests; "
          f"{sum(tokens[i] != teacher[i] for i in range(6))} of 6 differ "
          f"from the teacher in all)")
    solo_i = 4                       # budget 0.5, admitted mid-decode
    solo = profiled(lambda: serve(mk("infer"), [requests[solo_i]],
                                  stagger=False))[0]
    if solo != tokens[solo_i]:
        fail(f"request {solo_i} alone {solo} != staggered {tokens[solo_i]}")
    print(f"staggered == solo (request {solo_i}, budget "
          f"{budgets[solo_i]}): ok")
    ring = {"tokens": tokens, "timing": first}
    return launches, params, rp, requests, teacher, ring


def decode_turns(engines, req, device_line):
    """Warm serving of one request on each of two engines (name -> engine)
    in turns (a b b a): decode ms per step and prefill tok/s from
    ``engine.timing``. Reported, not gated."""
    a, b = engines
    turns, rates = [], []
    for name in (a, b, b, a):
        tm = engines[name].timing
        tm.update(decode_s=0.0, decode_steps=0, prefill_s=0.0,
                  prefill_tokens=0)
        serve(engines[name], [req], stagger=False)
        turns.append(f"{name} {tm['decode_s'] * 1e3 / tm['decode_steps']:.2f}")
        rates.append(f"{name} {tm['prefill_tokens'] / tm['prefill_s']:.1f}")
    print(f"warm serving in turns, one request ({len(req[0])}-token prompt, "
          f"{req[1]} new tokens, budget {req[2]}): decode ms/step "
          f"{' / '.join(turns)}; prefill tok/s {' / '.join(rates)} "
          f"[{device_line}]")


def graph_vs_eager(engines, req, device_line):
    """A graphed engine and its ``cuda_graphs=False`` twin (name ->
    engine), both warm: decode ms/step and prefill tok/s in turns, then
    decode under the profiler (wall and device ms per step, the device's
    busy share, operations per step). Reported, not gated."""
    decode_turns(engines, req, device_line)
    decode_profile(engines, req)


def decode_profile(engines, req, prof_tokens=7):
    """The decode steps of a ``prof_tokens``-token request (``req``'s
    prompt and budget) on each of two engines, after the step that admits
    it (the prefill's token and one decode step), under torch.profiler,
    device activity only: wall and device time per step, device
    operations per step, and the operations whose count per step differs
    between the two. Reported, not gated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import GenRequest
    a, b = engines
    ops_by = {}
    for name, eng in engines.items():
        h = eng.submit(GenRequest(req[0], prof_tokens, budget=req[2]))
        eng.step()                   # admission (prefill), first decode step
        torch.cuda.synchronize()
        steps = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while not h.done:
                eng.step()
                steps += 1
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        ops_by[name] = {e.key: (e.count / steps,
                                e.self_device_time_total / 1e3 / steps)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA}
        busy = sum(t for _, t in ops_by[name].values())
        print(f"{name} decode under the profiler (device activity): "
              f"{steps} steps, {wall:.2f} ms/step wall, {busy:.2f} "
              f"ms/step on the device ({100 * busy / wall:.1f} % busy), "
              f"{sum(c for c, _ in ops_by[name].values()):.0f} device "
              f"operations per step")
    get = lambda n, k: ops_by[n].get(k, (0.0, 0.0))
    diff = sorted(set(ops_by[a]) | set(ops_by[b]),
                  key=lambda k: -abs(get(b, k)[0] - get(a, k)[0]))
    print(f"device operations per step, {b} minus {a} (count, ms):")
    for k in diff[:8]:
        dc = get(b, k)[0] - get(a, k)[0]
        if dc:
            print(f"  {dc:+6.0f}x {get(b, k)[1] - get(a, k)[1]:+7.3f} ms  "
                  f"{k[:90]}")


def check_paged_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring):
    """The paged serving path on the Qwen2-7B weights already on the card:
    the six staggered requests (their paged_decode_attention calls recorded
    and the heaviest decode and chunk call replayed against the plain
    version), a mode="base" paged engine, a solo run, warm decode in turns
    with a ring engine, prefix sharing, a fork and preemption. Returns the
    launches of the staggered run, and its tokens, timing and the paged
    teacher's tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)

    def mk(mode="infer", n_pages=args.pages, graphs=True):
        return ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=4,
                             max_seq=1024, device=dev, kv_layout="paged",
                             page_size=PAGE_SIZE, n_pages=n_pages,
                             cuda_graphs=graphs)

    def drained(eng, what):
        st = eng.paged_stats()
        if st["allocated"] != 0:
            fail(f"paged serving, {what}: {st['allocated']} pages still "
                 f"allocated after every request finished")
        return st

    engine = mk()
    st = engine.pool.stats()
    pool_mb = sum(t.numel() * t.element_size() for layer in
                  engine._caches["layers"] for t in layer["attn"].values())
    print(f"paged serving: {cfg.name} depth {cfg.n_layers}, page size "
          f"{PAGE_SIZE}, {engine.pool.n_pages} pages ({st['usable']} usable "
          f"+ trash), {pool_mb / 1e6:.1f} MB of pool over {cfg.n_layers} "
          f"layers [{device_line}]")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = reserved_over(lambda: serve(engine, requests, stagger=True),
                           "paged infer, graphed (first run)",
                           device_line)               # the main path
    launches = ops.launch_counts()
    check_launches("paged_serving", launches)
    first = dict(engine.timing)
    st = drained(engine, "staggered run")
    eager = mk(graphs=False)
    with PathCalls("paged_decode_attention") as rec:   # replays call none
        want = reserved_over(lambda: serve(eager, requests, stagger=True),
                             "paged infer, cuda_graphs=False twin",
                             device_line)
    check_twin(f"paged infer, {cfg.n_layers} layers", engine, eager, tokens,
               want)
    print_timing("paged infer, cuda_graphs=False twin (first run)",
                 eager.timing, device_line)
    print(f"paged_decode_attention at the paged serving path's calls "
          f"(recorded from the twin) [{device_line}]:")
    check_paged_calls(res, dev, rec.paged_cases(), {4: "decode step",
                                              PAGE_SIZE: "prefill chunk"})
    del rec
    print_timing("paged serving (first run)", first, device_line)
    print_timing("ring serving, same call (first run)", ring["timing"],
                 device_line)
    print(f"paged pool peak: {st['peak_allocated']} of {st['usable']} pages")
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    same = [i for i in range(len(tokens)) if tokens[i] == ring["tokens"][i]]
    agree = sum(a == b for i in range(len(tokens))
                for a, b in zip(tokens[i], ring["tokens"][i]))
    print(f"paged vs ring (reported, not gated: chunked and one-shot "
          f"prefills sum in other orders in bf16): {len(same)} of "
          f"{len(tokens)} requests identical, {agree} of "
          f"{sum(map(len, tokens))} tokens agree position by position")

    graph_vs_eager({"paged graphed": engine, "paged eager": eager},
                   (requests[1][0], 16, 0.75), device_line)
    del eager

    base = mk("base")
    teacher = serve(base, requests, stagger=True)
    drained(base, "teacher run")
    print_timing("paged teacher, mode='base' (warm)", base.timing,
                 device_line)
    nt = twin_depth(cfg)
    cfg_t = dataclasses.replace(cfg, n_layers=nt)
    twins(f"paged teacher (mode='base'), {nt} layers",
          lambda g: ServingEngine(cut(params, nt), rp, cfg_t, spec,
                                  mode="base", batch_size=4, max_seq=1024,
                                  device=dev, kv_layout="paged",
                                  page_size=PAGE_SIZE, cuda_graphs=g),
          lambda e: serve(e, requests, stagger=True))
    for i, (_, _, b) in enumerate(requests):
        if b == 1.0 and tokens[i] != teacher[i]:
            fail(f"paged: budget-1.0 request {i} differs from the paged "
                 f"teacher: {tokens[i]} vs {teacher[i]}")
    print("paged budget 1.0 == mode='base' paged teacher, bit for bit: ok")
    solo_i = 4
    solo_eng = mk()
    solo = profiled(lambda: serve(solo_eng, [requests[solo_i]],
                                  stagger=False))[0]
    drained(solo_eng, "solo run")
    if solo != tokens[solo_i]:
        fail(f"paged: request {solo_i} alone {solo} != staggered "
             f"{tokens[solo_i]}")
    print(f"paged staggered == solo (request {solo_i}): ok")
    ring_eng = ServingEngine(params, rp, cfg, spec, mode="infer",
                             batch_size=4, max_seq=1024, device=dev)
    engines = {"ring": ring_eng, "paged": mk()}
    decode_turns(engines, (requests[0][0], 16, 0.75), device_line)
    decode_profile(engines, (requests[0][0], 16, 0.75))
    del engines
    del ring_eng

    # prefix sharing: a common 256-token prefix = 16 full pages
    rng = np.random.default_rng(args.seed + 3)
    V = cfg.vocab_size
    pre = rng.integers(0, V, 256).astype(np.int32)
    pair = [np.concatenate([pre, rng.integers(0, V, 64).astype(np.int32)])
            for _ in range(2)]
    eng = mk()
    hs = [eng.submit(GenRequest(pair[0], 16, budget=0.75))]
    eng.step()
    hs.append(eng.submit(GenRequest(pair[1], 16, budget=0.75)))
    eng.step()
    shared = eng.paged_stats()["shared"]
    while not all(h.done for h in hs):
        if eng.step() == 0:
            fail("paged engine stalled (prefix sharing)")
    drained(eng, "prefix sharing")
    if shared != 256 // PAGE_SIZE:
        fail(f"prefix sharing: {shared} shared pages, want "
             f"{256 // PAGE_SIZE}")
    for i, h in enumerate(hs):
        alone = serve(mk(), [(pair[i], 16, 0.75)], stagger=False)[0]
        if list(h.output) != alone:
            fail(f"prefix sharing: request {i} {list(h.output)} != alone "
                 f"{alone}")
    print(f"prefix sharing: {shared} pages shared while both ran, each "
          f"request == alone bit for bit, pool drained: ok")

    # fork mid-decode (copy-on-write of the partial tail page)
    p, n, b = requests[2]
    eng = mk()
    hp = eng.submit(GenRequest(p, n, budget=b))
    for _ in range(6):
        eng.step()
    prefix = list(hp.output)
    t_fork = int(eng._t[hp.slot])
    hc = eng.fork(hp)
    while not (hp.done and hc.done):
        if eng.step() == 0:
            fail("paged engine stalled (fork)")
    drained(eng, "fork")
    indep = serve(mk(), [(np.concatenate([p, np.asarray(prefix, np.int32)]),
                          n - len(prefix), b)], stagger=False)[0]
    print(f"fork at position {t_fork} ({t_fork % PAGE_SIZE} lanes of the "
          f"tail page copied) after {len(prefix)} tokens: parent and child "
          f"completed, pool drained: ok; child == independent run of prompt "
          f"+ output (reported, not gated): {list(hc.output) == indep} "
          f"({sum(x == y for x, y in zip(hc.output, indep))} of {len(indep)} "
          f"tokens)")

    # preemption: two 512-token requests on a pool too small for both to
    # grow past their prompts (each needs 33 pages at full length)
    need = -(-(512 + 16) // PAGE_SIZE)
    small = 2 * need - 1 + 1                # one page short, plus trash
    p2 = rng.integers(0, V, 512).astype(np.int32)
    pre_reqs = [requests[1], (p2, 16, requests[1][2])]
    eng = mk(n_pages=small)
    hs = [eng.submit(GenRequest(p, n, budget=b)) for p, n, b in pre_reqs]
    steps = 0
    while not all(h.done for h in hs):
        if eng.step() == 0 or steps > 500:
            fail("paged engine stalled (preemption)")
        steps += 1
    drained(eng, "preemption")
    if eng.n_preempted < 1:
        fail(f"preemption: none on a {small}-page pool")
    alone = [tokens[1], serve(mk(), [pre_reqs[1]], stagger=False)[0]]
    print(f"preemption: {small}-page pool, {eng.n_preempted} preemption(s), "
          f"both requests completed, pool drained: ok; each == its "
          f"uninterrupted run (reported, not gated): "
          f"{[list(h.output) == a for h, a in zip(hs, alone)]}")
    check_chunked_prefill_f32(params, rp, spec, dev, requests[2][0])
    return launches, {"tokens": tokens, "timing": first,
                      "teacher": teacher}


def check_chunked_prefill_f32(params, rp, spec, dev, prompt, n_layers=2,
                              rel_tol=1e-3):
    """The chunked paged prefill against the one-shot ring prefill at
    Qwen2-7B full width, ``n_layers`` layers, f32, budget 0.5: the
    last-token logits of ``prompt`` must agree within ``rel_tol`` of their
    largest magnitude (the two paths sum attention and the projections in
    other orders). Separates rounding from a fault where the bf16 paths'
    tokens part."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticPolicy
    from repro_torch.models import paged_cache_init, prefill, \
        prefill_chunk_step
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    pol = ElasticPolicy.uniform(0.5, n_heads=cfg.n_heads).to(dev)
    plen, ps = len(prompt), PAGE_SIZE
    n_chunks = -(-plen // ps)
    with torch.no_grad():
        ring, _ = prefill(p32, r32, {"tokens": torch.as_tensor(
            prompt[None], device=dev)}, cfg, spec, mode="infer", policy=pol)
        caches = paged_cache_init(cfg, n_chunks + 1, ps, device=dev)
        row = torch.arange(n_chunks, dtype=torch.int32, device=dev)
        for c in range(n_chunks):
            ck = np.zeros((1, ps), np.int32)
            ck[0, :min(ps, plen - c * ps)] = prompt[c * ps:(c + 1) * ps]
            paged, caches = prefill_chunk_step(
                p32, r32, torch.as_tensor(ck, device=dev), caches, c, row,
                c * ps, plen, cfg, spec, mode="infer", policy=pol)
    diff = float((paged - ring).abs().max())
    scale = float(ring.abs().max())
    same = int(paged.argmax()) == int(ring.argmax())
    print(f"chunked paged prefill vs one-shot ring prefill, f32, qwen2-7b "
          f"width, {n_layers} layers, {plen} tokens, budget 0.5: last-token "
          f"logits max |diff| {diff:.3e} of max |logit| {scale:.3e} "
          f"(tolerance {rel_tol:g} of it); same argmax: {same}")
    if not diff <= rel_tol * scale:
        fail("the chunked paged prefill disagrees with the ring prefill in "
             "f32")


def check_launches(path, launches):
    print(f"{path} path launches: {launches}")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the {path} path: {missing}")


def expert_spec(spec):
    """The slice's spec with every dense MLP moefied into 8 routed experts."""
    import dataclasses
    return dataclasses.replace(spec, mlp_n_experts=8, expert_routed=True)


def check_expert_serving(args, dev, device_line, spec, params, requests,
                         teacher):
    """The serving path with the Qwen2-7B MLPs moefied into 8 routed
    experts: the dense weights already on the card (moefied views, no
    copy) and fresh routers; the same six staggered requests. Returns the
    launches and the routers."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import prefill, router_init
    from repro_torch.training import ServingEngine
    full = get_config("qwen2-7b")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    espec = expert_spec(spec)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rp = router_init(gen, dataclasses.replace(
        full, n_layers=max(args.layers, args.train_layers)), espec, device=dev)
    print(f"expert serving: {cfg.name} depth {cfg.n_layers}, MLPs moefied "
          f"into {espec.mlp_n_experts} experts (views of the dense weights), "
          f"fresh routers [{device_line}]")
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), espec,
        mode="infer", batch_size=4, max_seq=1024, device=dev, cuda_graphs=g)
    engine = mk()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("expert_serving", launches)
    twins(f"moefied ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, requests, stagger=True))
    print_timing("expert serving (first run)", engine.timing, device_line)
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    solo_i = 4
    solo = profiled(lambda: serve(mk(), [requests[solo_i]], stagger=False))[0]
    if solo != tokens[solo_i]:
        fail(f"expert serving: request {solo_i} alone {solo} != staggered "
             f"{tokens[solo_i]}")
    print(f"expert serving staggered == solo (request {solo_i}, budget "
          f"{requests[solo_i][2]}): ok")
    # budget 1.0 against the teacher: E partial products in bf16, so
    # reported, not gated
    full_ids = [i for i, r in enumerate(requests) if r[2] == 1.0]
    same = sum(tokens[i] == teacher[i] for i in full_ids)
    pol = ElasticPolicy.uniform(1.0, n_heads=cfg.n_heads,
                                n_experts=espec.mlp_n_experts).to(dev)
    prompt = {"tokens": torch.as_tensor(requests[0][0][None], device=dev)}
    with torch.no_grad():
        ls, _ = prefill(params, rp, prompt, cfg, espec, mode="infer",
                        policy=pol)
        lt, _ = prefill(params, None, prompt, cfg, espec, mode="base")
    diff = float((ls.float() - lt.float()).abs().max())
    print(f"expert serving budget 1.0 vs the dense teacher (reported, not "
          f"gated): {same} of {len(full_ids)} budget-1.0 requests give the "
          f"teacher's tokens; last-token logits of request 0 "
          f"({len(requests[0][0])} tokens) differ by at most {diff:.4e} "
          f"(bf16)")
    return launches, rp


def _f32_cut(params, rp, n_layers):
    """The first ``n_layers`` layers (and embedding, head, final norm) of
    the model and routers, as f32 copies."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.float()
    p = cast({k: v for k, v in params.items() if k != "layers"})
    p["layers"] = cast(params["layers"][:n_layers])
    return p, {"layers": cast(rp["layers"][:n_layers])}


def check_gradients(params, rp, spec, dev, seed, n_layers=2, budget=0.5,
                    depth=None, rel_tol=2e-3):
    """Router gradients of one distillation loss at Qwen2-7B full width,
    ``n_layers`` layers, f32: the kernel path (backend "cuda") against the
    plain path (backend "ref") on the same batch and policy. A leaf passes
    when max |g_kernel - g_plain| <= rel_tol * max |g_plain|. A leaf whose
    kernel-path gradient is all zero while the plain one is not fails (the
    mark of a kernel whose autograd plumbing is missing). With expert
    routing, every expert routing decision must also be the same on both
    paths: which experts each token selects, and which (token, expert)
    pairs each expert's capacity keeps (``expert_decisions``). ``depth``
    sets the depth budget apart from ``budget`` (the other knobs); the
    bucket is solved with the spec, so depth composes into it, and with
    depth routing every depth router leaf must get a non-zero gradient on
    both paths."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticPolicy, ragged_bucket
    from repro_torch.data import LMDataPipeline
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.training import make_loss_fn
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    S, B = 512, 2
    # the budget on every knob directly: at 2 layers the FLOP solver would
    # cut far deeper (the embedding and LM head dominate the 2-layer model)
    pol = ElasticPolicy.uniform(budget, n_heads=cfg.n_heads,
                                n_experts=spec.mlp_n_experts)
    if depth is not None:
        pol = pol.replace(depth_capacity=depth)
    pol = pol.to(dev)
    bucket = ragged_bucket(pol, S, spec=spec)
    tokens = torch.from_numpy(LMDataPipeline(
        vocab=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=seed).batch_at(0)).to(dev)
    out, picks, depth_ids = {}, {}, {}
    for backend in ("cuda", "ref"):
        sp = dataclasses.replace(spec, kernel_backend=backend)
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          r32)
        with expert_decisions() as picks[backend]:
            loss, m = make_loss_fn(cfg, sp)(leaves, p32, {"tokens": tokens},
                                            pol, bucket)
        flat = tree_leaves(leaves)
        depth_ids[backend] = [i for i, t in enumerate(flat) if any(
            t is d for layer in leaves["layers"] if "depth" in layer
            for d in tree_leaves(layer["depth"]))]
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        out[backend] = (float(loss.detach()), float(m["sel_rate"]),
                        [torch.zeros_like(t) if g is None else g
                         for g, t in zip(gs, flat)])
        torch.cuda.synchronize()
    (lk, sk, gk), (lr_, sr, gr) = out["cuda"], out["ref"]
    label = ("experts" if spec.expert_routed else
             "depth" if spec.depth_routed else "dense")
    print(f"gradient check ({label}): qwen2-7b width, {n_layers} layers, f32,"
          f" B={B} S={S}, budget {budget}"
          + ("" if depth is None else f", depth {depth}")
          + f" (bucket {bucket}; without the spec "
          f"{ragged_bucket(pol, S)}): loss kernel "
          f"{lk:.6f} plain {lr_:.6f}, sel_rate {sk:.6f} / {sr:.6f}")
    if sk != sr:
        fail("the kernel and plain paths selected different tokens")
    if spec.expert_routed:
        (dk, ok), (dr, orr) = picks["cuda"].result(), picks["ref"].result()
        if not dk or len(dk) != len(dr) or not all(
                torch.equal(a, b) for a, b in zip(dk, dr)):
            fail("the kernel and plain paths took different expert routing "
                 "decisions")
        moved = sum(int((a != b).sum()) for a, b in zip(ok, orr))
        print(f"  expert routing decisions of {len(dk) // 2} dispatches "
              f"(each token's experts, each expert's kept tokens) identical "
              f"on both paths: ok ({moved} kept tokens sit in another slot "
              f"of their expert's buffer: equal weights to f32 rounding, "
              f"the slot does not change a token's result)")
    if spec.depth_routed:
        ids = depth_ids["cuda"]
        if not ids or any(not bool(g[i].any()) for g in (gk, gr)
                          for i in ids):
            fail("a depth router leaf has no gradient")
        print(f"  all {len(ids)} depth router leaves get a non-zero "
              f"gradient on both paths: ok")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gk, gr)):
        scale = float(b.abs().max())
        if scale > 0 and float(a.abs().max()) == 0.0:
            fail(f"router leaf {i}: all-zero gradient on the kernel path, "
                 f"non-zero on the plain path")
        rel = float((a - b).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if rel > rel_tol:
            fail(f"router leaf {i}: kernel vs plain gradient {rel:.3e} of "
                 f"its largest element (tolerance {rel_tol:g})")
    print(f"  {len(gk)} router leaves: worst max|g_kernel - g_plain| / "
          f"max|g_plain| = {worst:.3e} (tolerance {rel_tol:g}); no leaf "
          f"zero on one path only: ok")


class expert_decisions:
    """Context manager that records the expert routing decisions of every
    ``models.moe.moe_apply`` chunk run inside it: per chunk, the
    (B, s, E) experts each token selected (the combine's finite top-k) and
    the (B, E, s) tokens each expert's capacity kept (the dispatch's first
    ``count`` slots). ``result()``: (decisions, slot orders)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []
        self.real = (moe._top, moe._expert_ffn)

        def top(scores, k):
            v, i = self.real[0](scores, k)
            self.calls.append(("top", v, i))
            return v, i

        def ffn(p, x_sel, act, backend=None, counts=None):
            self.calls.append(("ffn", counts))
            return self.real[1](p, x_sel, act, backend=backend, counts=counts)

        moe._top, moe._expert_ffn = top, ffn
        return self

    def __exit__(self, *exc):
        self.moe._top, self.moe._expert_ffn = self.real
        return False

    def result(self):
        import torch
        decisions, orders = [], []
        calls = iter(self.calls)
        for (_, dv, di), (_, cnt), (_, cv, ci) in zip(calls, calls, calls):
            B, E, C = di.shape
            s = cv.shape[1]
            slot = torch.arange(C, device=di.device)
            kept = torch.zeros(B, E, s, dtype=torch.bool, device=di.device)
            kept.scatter_(2, di, slot < cnt[..., None])
            sel = torch.zeros(B, s, E, dtype=torch.bool, device=ci.device)
            sel.scatter_(2, ci, torch.isfinite(cv))
            decisions += [sel, kept]
            orders.append(torch.where(slot < cnt[..., None], di, -1))
        return decisions, orders


def check_training(args, params, rp, spec, dev, device_line):
    """The training path: 4 steps at Qwen2-7B full width, --train-layers
    deep, bf16, through launch.train's build_trainer and step function.
    Returns the kernels' launches during the 4 steps. With expert routing
    the budget-1.0 student sums E partial products, so its difference from
    the teacher is reported instead of held to 0. Every expert or depth
    router leaf must get a non-zero gradient in the repeated plan step;
    with depth routing the step is then timed over ``depth_training_grid``'s
    (depth, token) budgets."""
    import torch
    from repro_torch.core import routing as R
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models import forward
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.training import make_loss_fn
    steps, S, B = 4, 512, 2
    n = args.train_layers
    experts = spec.expert_routed
    path = ("expert_training" if experts else
            "depth_training" if spec.depth_routed else "training")
    cfg, ecfg, params, state, step_fn, pipe = T.build_trainer(
        "qwen2-7b", lr=1e-4, total_steps=steps, seq_len=S, global_batch=B,
        seed=args.seed, ecfg=spec, device=dev, n_layers=n,
        params={**params, "layers": params["layers"][:n]},
        routers={"layers": rp["layers"][:n]})
    anneal = dict(budget=0.5, anneal_from=1.0, anneal_steps=3)
    policy_at = T.policy_schedule(cfg, ecfg, seq_len=S, total_steps=steps,
                                  device=dev, **anneal)
    budget_at = T.capacity_anneal(1.0, 0.5, 3)
    print(f"{path}: {cfg.name} width, depth {n} layers, {cfg.dtype}, "
          f"B={B} S={S}, AdamW on "
          f"{T.router_param_count(state.router_params)} router params, "
          f"remat, budget 1.0 -> 0.5 over 3 steps [{device_line}]")
    batches = [{"tokens": torch.as_tensor(pipe.batch_at(i), device=dev)}
               for i in range(steps)]
    states = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i in range(steps):
        pol, bucket = policy_at(i)
        states.append(state)
        torch.cuda.reset_peak_memory_stats()
        timing = {}
        t0 = time.perf_counter()
        state, m = step_fn(state, params, batches[i], pol, bucket,
                           timing=timing)
        wall = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"training step {i}: non-finite metrics {m}")
        print(f"  step {i} budget {budget_at(i):.4f} "
              f"bucket {bucket}: loss {m['loss']:.6f} distill "
              f"{m['distill']:.6e} aux_load {m['aux_load']:.6f} aux_topk "
              f"{m['aux_topk']:.6f} sel_rate {m['sel_rate']:.4f} grad_norm "
              f"{m['grad_norm']:.6f} | teacher fwd "
              f"{timing['teacher_s'] * 1e3:.1f} ms, student fwd+bwd+update "
              f"{timing['student_s'] * 1e3:.1f} ms, step {wall * 1e3:.1f} ms "
              f"= {B * S / wall:.1f} tok/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"[{device_line}]")
        if i == 0 and (bucket != R.IDENTITY_BUCKET or (
                m["distill"] != 0.0 and not experts)):
            fail(f"budget-1.0 step: bucket {bucket}, distill {m['distill']}"
                 f" (want the identity bucket and exactly 0)")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches(path, launches)

    # budget 1.0: the student's final hidden states are the teacher's
    pol, bucket = policy_at(0)
    with torch.no_grad():
        h_s, _ = forward(params, states[0].router_params, batches[0], cfg,
                         ecfg, mode="train", return_hidden=True, policy=pol,
                         bucket=bucket)
        h_t, _ = forward(params, None, batches[0], cfg, ecfg, mode="base",
                         return_hidden=True)
    if experts:
        print(f"budget 1.0 student vs mode='base' teacher hidden states "
              f"(reported, not gated: E partial products in bf16): max "
              f"|diff| {float((h_s.float() - h_t.float()).abs().max()):.4e}")
    elif not torch.equal(h_s, h_t):
        fail("budget-1.0 student hidden states differ from the teacher's")
    else:
        print("budget 1.0 student == mode='base' teacher hidden states, bit "
              "for bit; distill == 0.0 exactly: ok")

    # a plan step twice from the same state: the same bits
    i = steps - 1
    pol, bucket = policy_at(i)
    loss_fn = make_loss_fn(cfg, ecfg, remat=True)
    runs = []
    for _ in range(2):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          states[i].router_params)
        loss, _ = loss_fn(leaves, params, batches[i], pol, bucket)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        runs.append((loss.detach(), grads))
    kind = "expert" if experts else "depth" if spec.depth_routed else None
    if kind is not None:
        ids = {id(t) for layer in leaves["layers"]
               for t in tree_leaves(layer[kind])}
        dead = [j for j, (t, g) in enumerate(zip(flat, runs[0][1]))
                if id(t) in ids and (g is None or not bool(g.any()))]
        if dead or not ids:
            fail(f"{kind} router leaves without a gradient: {dead}")
        print(f"all {len(ids)} {kind} router leaves get a non-zero "
              f"gradient: ok")
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(runs[0][1], runs[1][1]))
    if not same:
        fail(f"plan step {i} (bucket {bucket}) run twice differs")
    print(f"plan step {i} (bucket {bucket}) twice from the same state: "
          f"loss and {len(runs[0][1])} router gradients bit-identical: ok")

    # where a plan step's time goes on the device
    print(f"plan step {i} under torch.profiler:")
    profiled(lambda: step_fn(states[i], params, batches[i], pol, bucket),
             top=12)
    if spec.depth_routed:
        depth_training_grid(step_fn, states[i], params, batches[0], cfg,
                            ecfg, dev, device_line, S)
    return launches


def check_native_serving(args, dev, device_line):
    """Qwen1.5-MoE-A2.7B at its published widths (qwen2-moe-a2.7b,
    --moe-layers deep, random bf16 weights from --seed) with its registered
    elastic config: expert top-k over the 60 experts, token routing, head
    top-k, LoRA. Five staggered requests of 64-512 tokens; the request
    admitted mid-decode alone must give its staggered tokens. Returns the
    launches and (params, routers, cfg, spec, requests) for the int8
    phase."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_elastic
    from repro_torch.core.policy import spec_from_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine
    full = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(full, n_layers=args.moe_layers)
    spec = spec_from_config(get_elastic("qwen2-moe-a2.7b", cfg))
    m = cfg.moe
    print(f"native MoE serving: {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
          f"K={cfg.n_kv_heads} Dh={cfg.d_head} experts {m.n_experts} top-"
          f"{m.top_k} d_expert {m.d_expert} shared {m.d_shared} "
          f"V={cfg.vocab_size} {cfg.dtype}, depth {cfg.n_layers} of "
          f"{full.n_layers} layers"
          + ("" if cfg.n_layers == full.n_layers else " (depth cut)"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.n_params() / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed + 2)
    lens = [64, 512, 200, 333, 128]
    budgets = [1.0, 0.75, 0.5, None, 0.5]
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 16, b)
                for n, b in zip(lens, budgets)]
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), spec,
        mode="infer", batch_size=4, max_seq=1024, device=dev, cuda_graphs=g)
    engine = mk()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("native_serving", launches)
    twins(f"native MoE ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, requests, stagger=True))
    print_timing("native MoE serving (first run)", engine.timing,
                 device_line)
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    for solo_i in (3, 4):
        run = lambda: serve(mk(), [requests[solo_i]], stagger=False)
        solo = (profiled(run) if solo_i == 4 else run())[0]
        if solo != tokens[solo_i]:
            fail(f"native MoE: request {solo_i} alone {solo} != staggered "
                 f"{tokens[solo_i]}")
    print("native MoE staggered == solo (requests 3 and 4, budgets None and "
          "0.5): ok")
    return launches, (params, rp, cfg, spec, requests)


# ------------------------------- surfaces -------------------------------------
#
# The entry points users start: the trainer with checkpoints and resume
# (launch/train.py, checkpoint/), serving from a checkpoint through the
# serving CLI's open loop, and the CLI itself (launch/serve.py).

SURF_STEPS = 8           # resumable training: steps of each run
SURF_SAVE_EVERY = 2      # its checkpoint interval (keep=3: steps 4, 6, 8)
SURF_FAIL_STEP = 5       # the faulty run's injected failure
SURF_REQUESTS = 8        # served from the checkpoint, 32 new tokens each
SURF_RATE = 4.0          # their Poisson arrivals, req/s (seed 0)
SURF_CLI = ("--arch", "qwen2-7b", "--variant", "full", "--requests", "8",
            "--batch", "4", "--prompt-len", "256", "--max-new", "32",
            "--budget", "0.5,0.75,1.0", "--arrival-rate", "4",
            "--kv-layout", "paged", "--kv-dtype", "bf16",
            "--weight-dtype", "bf16")


@contextlib.contextmanager
def timed_saves():
    """Host seconds of every ``Checkpointer`` save while active, by step:
    the ``save`` call (the snapshot to host memory, after which training
    goes on) and its background write (``_write``)."""
    from repro_torch.checkpoint import Checkpointer
    times, save, write = {}, Checkpointer.save, Checkpointer._write

    def timed_save(self, step, *a, **kw):
        t0 = time.perf_counter()
        save(self, step, *a, **kw)
        times.setdefault(step, {})["snapshot_s"] = time.perf_counter() - t0

    def timed_write(self, step, *a, **kw):
        t0 = time.perf_counter()
        write(self, step, *a, **kw)
        times.setdefault(step, {})["write_s"] = time.perf_counter() - t0
    Checkpointer.save, Checkpointer._write = timed_save, timed_write
    try:
        yield times
    finally:
        Checkpointer.save, Checkpointer._write = save, write


def same_tree(a, b) -> bool:
    """Equal structure (keys, whatever their order) and equal leaves,
    dtype and bits."""
    from repro_torch.checkpoint import flatten
    fa, fb = flatten(a), flatten(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


def resumable_runs(label, arch, root, fail_at, device_line, **kw):
    """``launch.train.train`` twice into fresh checkpoint directories under
    ``root``: once clean and once with a failure injected at ``fail_at``.
    Fails unless the faulty run restarted once and both end in the same
    routers and AdamW moments and the same loss at every step, bit for
    bit. Prints each step's loss, time and peak memory, and each save's
    host time (snapshot, background write). Returns {run: (state,
    history, directory)}."""
    import os
    import torch
    from repro_torch.launch import train as T
    runs = {}
    for run, inject in (("clean", ()), ("faulty", (fail_at,))):
        d = os.path.join(root, f"{label}_{run}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with timed_saves() as saves:
            state, hist, restarts, wd = T.train(
                arch, ckpt_dir=d, inject_failures=inject, log_every=10 ** 6,
                **kw)
        wall = time.perf_counter() - t0
        want = len(inject)
        if restarts != want:
            fail(f"{label} {run}: {restarts} restarts, want {want}")
        for i, m in enumerate(hist):
            if m is None or not all(np.isfinite(v) for k, v in m.items()
                                    if k != "bucket"):
                fail(f"{label} {run}: step {i} metrics {m}")
            print(f"  {run} step {i} bucket {m['bucket']}: loss "
                  f"{m['loss']:.6f} distill {m['distill']:.6e} sel_rate "
                  f"{m['sel_rate']:.4f} step {m['step_s'] * 1e3:.1f} ms")
        steps = [m["step_s"] for m in hist]
        print(f"  {run}: {len(hist)} steps + {restarts} restart(s) in "
              f"{wall:.1f} s; step median {np.median(steps) * 1e3:.1f} ms "
              f"(first {steps[0] * 1e3:.1f}), peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"watchdog flagged {len(wd.flagged)} [{device_line}]")
        for s, t in sorted(saves.items()):
            print(f"  {run} save of step {s}: save call (snapshot) "
                  f"{t['snapshot_s'] * 1e3:.2f} ms (returns to training), "
                  f"background write {t['write_s'] * 1e3:.2f} ms "
                  f"[{device_line}]")
        runs[run] = (state, hist, d)
    (sc, hc, _), (sf, hf, _) = runs["clean"], runs["faulty"]
    if not (same_tree(sc.router_params, sf.router_params)
            and same_tree(sc.opt.m, sf.opt.m)
            and same_tree(sc.opt.v, sf.opt.v)
            and torch.equal(sc.opt.step, sf.opt.step)):
        fail(f"{label}: the resumed run's routers or moments differ from "
             f"the clean run's")
    if [m["loss"] for m in hc] != [m["loss"] for m in hf]:
        fail(f"{label}: losses differ: {[m['loss'] for m in hc]} vs "
             f"{[m['loss'] for m in hf]}")
    print(f"{label}: failure at step {fail_at}, one restart, resumed == "
          f"clean: routers, both AdamW moments, the step and all "
          f"{len(hc)} losses bit for bit: ok")
    return runs


def check_checkpoint_dir(label, d, state, cfg, ecfg, want_steps,
                         device_line):
    """The directory holds exactly ``want_steps``; each restores with every
    checksum verified; the last restore (timed, a fresh Checkpointer)
    converted to port routers is bit for bit ``state``. Returns that
    restored state."""
    from repro_torch.checkpoint import Checkpointer, flatten
    from repro_torch.interop import train_state_from_tree, train_state_tree
    import torch
    ck = Checkpointer(d, keep=3)
    if ck.all_steps() != list(want_steps):
        fail(f"{label}: checkpoint steps {ck.all_steps()}, want "
             f"{list(want_steps)}")
    like = train_state_tree(state, cfg, ecfg)
    for s in want_steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, extra = Checkpointer(d).restore(s, like)
        got = train_state_from_tree(loaded, extra["opt_step"], cfg, ecfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if extra["step"] != s or extra["opt_step"] != s:
            fail(f"{label}: step {s} manifest extra {extra}")
    print(f"{label}: steps {ck.all_steps()} (keep=3) each restored with "
          f"every checksum verified ({len(flatten(loaded))} arrays); a "
          f"restore of "
          f"step {want_steps[-1]} onto the card and into port routers "
          f"{dt * 1e3:.1f} ms [{device_line}]")
    if not (same_tree(got.router_params, state.router_params)
            and same_tree(got.opt.m, state.opt.m)
            and same_tree(got.opt.v, state.opt.v)):
        fail(f"{label}: the restored step {want_steps[-1]} differs from the "
             f"trainer's final state")
    print(f"{label}: restored routers and moments == the trainer's final "
          f"state, bit for bit: ok")
    return got


def check_surfaces(args, dev, device_line, params):
    """Item 5a: the trainer with checkpoints (a failure at step
    ``SURF_FAIL_STEP`` resumed bit for bit), serving the trained routers
    from their checkpoint through ``launch.serve.open_loop``, and the
    serving CLI as a subprocess. Returns the launches by path."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config, get_elastic
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import latency_stats, open_loop
    from repro_torch.training import GenRequest, ServingEngine
    n = args.train_layers
    cfg = dataclasses.replace(get_config("qwen2-7b", "full"), n_layers=n)
    ecfg = get_elastic("qwen2-7b", cfg)
    kw = dict(variant="full", total_steps=SURF_STEPS, seq_len=512,
              global_batch=2, lr=1e-4, budget=0.5, anneal_from=1.0,
              anneal_steps=4, save_every=SURF_SAVE_EVERY, seed=args.seed,
              device=dev, n_layers=n, params=cut(params, n))
    root = tempfile.mkdtemp(prefix="surfaces_")
    paths = {}
    try:
        print(f"resumable training: {cfg.name} width, depth {n} layers, "
              f"B=2 S=512, {SURF_STEPS} steps, budget 1.0 -> 0.5 over 4, "
              f"saves every {SURF_SAVE_EVERY} (keep=3), clean and with a "
              f"failure at step {SURF_FAIL_STEP} [{device_line}]")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        runs = resumable_runs("resumable training", "qwen2-7b", root,
                              SURF_FAIL_STEP, device_line, **kw)
        torch.cuda.synchronize()
        paths["resumable_training"] = ops.launch_counts()
        check_launches("resumable_training", paths["resumable_training"])
        state, _, clean_dir = runs["clean"]
        keep = tuple(range(SURF_STEPS - 2 * SURF_SAVE_EVERY, SURF_STEPS + 1,
                           SURF_SAVE_EVERY))
        for run in ("clean", "faulty"):
            got = check_checkpoint_dir(f"{run} checkpoints", runs[run][2],
                                       state, cfg, ecfg, keep, device_line)
        routers = got.router_params
        del runs, got

        # serving the trained routers from their checkpoint
        rng = np.random.default_rng(args.seed + 5)
        budgets = [(0.5, 0.75, 1.0)[i % 3] for i in range(SURF_REQUESTS)]
        reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513)))
                 .astype(np.int32), 32, b) for b in budgets]
        mk = lambda mode="infer": ServingEngine(
            cut(params, n), routers, cfg, ecfg, mode=mode, batch_size=4,
            max_seq=1024, device=dev)
        engine = mk()
        engine.generate([GenRequest(reqs[0][0], 4)])     # capture, warm
        engine.scheduler.reset_stats()
        counts = engine.compile_counts()
        timing0 = dict(engine.timing)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        handles, elapsed = open_loop(
            engine, [GenRequest(p, m, budget=b) for p, m, b in reqs],
            SURF_RATE, seed=0)
        torch.cuda.synchronize()
        paths["checkpoint_serving"] = ops.launch_counts()
        check_launches("checkpoint_serving", paths["checkpoint_serving"])
        if engine.compile_counts() != counts:
            fail(f"checkpoint serving: compile_counts {counts} -> "
                 f"{engine.compile_counts()} during the open loop")
        if not all(h.status == "done" for h in handles):
            fail(f"checkpoint serving: not every request done: {handles}")
        tokens = [list(h.output) for h in handles]
        n_tok = sum(map(len, tokens))
        st = latency_stats(handles)
        tm = {k: engine.timing[k] - timing0[k] for k in timing0}
        print(f"checkpoint serving: {SURF_REQUESTS} requests of "
              f"{[len(p) for p, _, _ in reqs]} tokens, budgets {budgets}, "
              f"open loop @ {SURF_RATE} req/s: {n_tok} tokens in "
              f"{elapsed:.2f} s ({n_tok / elapsed:.1f} tok/s), occupancy "
              f"{engine.occupancy:.0%} [{device_line}]")
        print("  latency_stats (ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in st.items()))
        print_timing("checkpoint serving (warm)", tm, device_line)
        del engine
        solo_engine = mk()
        for i, r in enumerate(reqs):
            solo = serve(solo_engine, [r], stagger=False)[0]
            if solo != tokens[i]:
                fail(f"checkpoint serving: request {i} alone {solo} != "
                     f"open loop {tokens[i]}")
        del solo_engine
        full = [i for i, b in enumerate(budgets) if b == 1.0]
        teacher = serve(mk("base"), [reqs[i] for i in full], stagger=False)
        for i, t in zip(full, teacher):
            if t != tokens[i]:
                fail(f"checkpoint serving: budget-1.0 request {i} "
                     f"{tokens[i]} != the teacher's {t}")
        print(f"checkpoint serving: every request done; each == itself "
              f"served alone on a fresh engine; budget 1.0 (requests {full}) == "
              f"mode='base'; compile_counts {counts} flat over the window: "
              f"ok")
        del routers, state
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the serving CLI as users start it, in a process of its own
    def built():
        return {p: p.stat().st_mtime_ns for p in build.BUILD_ROOT.rglob("*")}
    before = built()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *SURF_CLI]
    print(f"serving CLI: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"the serving CLI exited {out.returncode}:\n{out.stdout}\n"
             f"{out.stderr[-4000:]}")
    lines = out.stdout.splitlines()
    for head in ("open loop:", "latency:", "compiles:", "paged pool:"):
        got = [ln for ln in lines if ln.startswith(head)]
        if not got:
            fail(f"the serving CLI printed no {head!r} line:\n{out.stdout}")
        print(f"  | {got[0]}")
    if built() != before:
        fail("the serving CLI built the kernels again")
    print(f"serving CLI: exit 0 in {wall:.1f} s of wall, kernels loaded "
          f"from the parent's build (no file under {build.BUILD_ROOT.name}/ "
          f"changed) [{device_line}]")
    return paths


def check_native_training(args, dev, device_line, native):
    """Item 9a: Qwen1.5-MoE-A2.7B trained at full width (--moe-layers deep,
    the native serving weights) through ``launch.train.train`` with
    checkpoints, clean and with a failure injected at step 3 and resumed:
    bit for bit the same. Returns the launches of both runs."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import ops
    params, _, cfg, _, _ = native
    kw = dict(variant="full", total_steps=4, seq_len=512, global_batch=2,
              lr=1e-4, budget=0.5, anneal_from=1.0, anneal_steps=2,
              save_every=2, seed=args.seed, device=dev,
              n_layers=cfg.n_layers, params=params)
    print(f"native MoE training: {cfg.name} width, depth {cfg.n_layers} "
          f"layers, B=2 S=512, 4 steps, budget 1.0 -> 0.5 over 2, saves "
          f"every 2, clean and with a failure at step 3 [{device_line}]")
    root = tempfile.mkdtemp(prefix="native_training_")
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        resumable_runs("native MoE training", "qwen2-moe-a2.7b", root, 3,
                       device_line, **kw)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_launches("native_training", launches)
    return launches


# ----------------------------- quantized serving ------------------------------
#
# The serving engine's kv_dtype / weight_dtype = "int8": K/V codes with f32
# scales per (key, kv-head) and weights with f32 scales per output channel
# (src/repro_torch/models/quant.py). Each kernel reads its int8 operands as
# int8; its bound counts them at 1 byte plus their f32 scales.

def int8_kv(k, v):
    """(k codes, v codes, k scales, v scales) of f32 K/V."""
    from repro_torch.models.quant import quantize_kv
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return kq, vq, ks, vs


def int8_weight(w):
    """(codes, scales) of an (.., in, out) weight, per output channel."""
    from repro_torch.models.quant import quantize_weight
    return quantize_weight(w.float(), (-2,))


def int8_timing(res, name, label, ms, plain, bf16_ms, work):
    """Keeps an int8 case's times in the kernel's row under int8[label]:
    the kernel, its plain version and the same kernel on bf16 operands at
    the same shape (each a ``cuda_ms`` list, or a (graphed, back-to-back)
    pair), beside the bound; there is no single PyTorch call for an
    int8-operand function (library: none). ``work``: the call's
    ``cost``."""
    b, by = bound_ms(*work)
    med = lambda ts: ts[len(ts) // 2]
    row = dict(bound_ms=b, bound_by=by, library_ms=None)
    text = []
    for key, ts in (("ms", ms), ("plain_ms", plain), ("bf16_ms", bf16_ms)):
        if isinstance(ts, tuple):
            row[key], row["graphed_" + key] = med(ts[1]), med(ts[0])
            text.append(f"{key[:-3] or 'kernel'} {med(ts[0]):.4f} ms "
                        f"[{ts[0][0]:.4f}-{ts[0][-1]:.4f}] graphed, "
                        f"{med(ts[1]):.4f} eager")
        else:
            row[key] = med(ts)
            text.append(f"{key[:-3] or 'kernel'} {med(ts):.4f} ms "
                        f"[{ts[0]:.4f}-{ts[-1]:.4f}]")
    res.rows[name].setdefault("int8", {})[label] = row
    print(f"  {name:17s} int8 {label} median [min-max] of 5: "
          f"{'; '.join(text)}; library: none; bound {b:.4f} ms ({by}, "
          f"int8 operands at 1 byte plus their f32 scales)")


def cold_sets(nbytes_one: int) -> int:
    """Operand sets to rotate over so that their total is twice the L2."""
    return 1 + 2 * L2_BYTES // max(nbytes_one, 1)


def check_int8_decode(res, rng, dev, H, K, Dh, L):
    """decode_attention with int8 K/V (kscale / vscale (B, L, K)) against
    its plain version at the ring serving path's shape (L = 1024), bf16
    and f32 queries: a wrapped ring, kv_valid holes, a slot whose every
    key is masked and an inactive slot (exact zeros); the bf16 call timed
    L2-cold beside the kernel on bf16 K/V at the same shape."""
    import torch
    from repro_torch.kernels import ops
    B = 5
    t = np.asarray([63, 300, L - 1, L + 476, 0], np.int32)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pos_np, valid_np = _ring(rng, B, L, t, 0.8)
        valid_np[3] = False                    # every key of slot 3 masked
        pos_np[4] = -1                         # slot 4 inactive
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        k = torch.randn(B, L, K, Dh, device=dev)
        v = torch.randn(B, L, K, Dh, device=dev)
        kq, vq, ks, vs = int8_kv(k, v)
        pos, valid, tv = (torch.from_numpy(a).to(dev)
                          for a in (pos_np, valid_np, t))
        run = lambda backend=None: ops.decode_attention(
            q, kq, vq, pos, tv, valid, ks, vs, backend=backend)
        outs[kind] = got = run()
        res.compare("decode_attention", f"int8 K/V, {kind} q, B={B} L={L} "
                    f"holes, masked + inactive slot", got, run("ref"), kind)
        if got[3:].count_nonzero() != 0:
            fail("int8 decode_attention: a slot with no attendable key is "
                 "not zero")
        if kind != "bf16":
            continue
        att = (pos_np >= 0) & (pos_np <= t[:, None]) & valid_np
        rows = int(att.sum())
        n8 = cold_sets(2 * (kq.numel() + ks.numel() * 4))
        sets8 = [int8_kv(torch.randn_like(k), torch.randn_like(v))
                 for _ in range(n8 - 1)] + [(kq, vq, ks, vs)]
        n16 = cold_sets(2 * k.numel() * 2)
        sets16 = [(torch.randn_like(k).to(dt), torch.randn_like(v).to(dt))
                  for _ in range(n16)]
        call8 = lambda backend: cycling(lambda i: ops.decode_attention(
            q, sets8[i][0], sets8[i][1], pos, tv, valid, sets8[i][2],
            sets8[i][3], backend=backend), n8)
        call16 = cycling(lambda i: ops.decode_attention(
            q, sets16[i][0], sets16[i][1], pos, tv, valid), n16)
        print(f"  decode_attention  int8 timed L2-cold: {n8} int8 K/V sets "
              f"({mib([a for s in sets8 for a in s]):.0f} MiB), bf16 beside "
              f"it over {n16} ({mib([a for s in sets16 for a in s]):.0f} "
              f"MiB); {rows} attended rows of {B * L}")
        int8_timing(res, "decode_attention", f"ring ({B}, {L})",
                    device_and_eager_ms(call8(None), 50),
                    device_and_eager_ms(call8("ref"), 10),
                    device_and_eager_ms(call16, 50),
                    cost("decode_attention", q, kq, vq, pos, tv, valid, ks,
                         vs))
        del sets8, sets16
    return outs


def paged_int8_case(res, dev, label, qs, N, ps, K, Dh, table, t, pvalid,
                    timed):
    """One paged_decode_attention call shape with int8 pools against the
    plain version in bf16 and f32 (rows with no attendable key exact
    zeros); with ``timed`` the bf16 call L2-cold beside the kernel on bf16
    pools. Returns the outputs."""
    import torch
    from repro_torch.kernels import ops
    dead = ~paged_attendable(table, t, pvalid)[0].any(1)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        q = torch.randn(qs, device=dev).to(dt)
        kp = torch.randn(N, ps, K, Dh, device=dev)
        vp = torch.randn(N, ps, K, Dh, device=dev)
        kq, vq, ks, vs = int8_kv(kp, vp)
        run = lambda backend=None: ops.paged_decode_attention(
            q, kq, vq, table, t, pvalid, ks, vs, backend=backend)
        outs[kind] = got = run()
        res.compare("paged_decode_attention", f"int8 pool, {kind} q, "
                    f"{label}", got, run("ref"), kind)
        if got[dead].count_nonzero() != 0:
            fail(f"int8 paged_decode_attention {label}: a row with no "
                 f"attendable key is not zero")
        if kind != "bf16" or not timed:
            continue
        work, keys = paged_work(q, kq, vq, table, t, pvalid, ks, vs)
        n8 = cold_sets(2 * (kq.numel() + ks.numel() * 4))
        sets8 = [int8_kv(torch.randn_like(kp), torch.randn_like(vp))
                 for _ in range(n8 - 1)] + [(kq, vq, ks, vs)]
        n16 = cold_sets(2 * kp.numel() * 2)
        sets16 = [(torch.randn_like(kp).to(dt), torch.randn_like(vp).to(dt))
                  for _ in range(n16)]
        call8 = lambda backend: cycling(lambda i: ops.paged_decode_attention(
            q, sets8[i][0], sets8[i][1], table, t, pvalid, sets8[i][2],
            sets8[i][3], backend=backend), n8)
        call16 = cycling(lambda i: ops.paged_decode_attention(
            q, sets16[i][0], sets16[i][1], table, t, pvalid), n16)
        print(f"  paged_decode_attention int8 {label}: {keys} attendable "
              f"keys; timed L2-cold over {n8} int8 pools, bf16 beside it "
              f"over {n16}")
        int8_timing(res, "paged_decode_attention", label,
                    device_and_eager_ms(call8(None), 50),
                    device_and_eager_ms(call8("ref"), 10),
                    device_and_eager_ms(call16, 50), work)
        del sets8, sets16
    return outs


def check_int8_paged(res, rng, dev, H, K, Dh, max_seq):
    """paged_decode_attention with int8 pools and (N, ps, K) scale pools
    at the paged serving path's decode shape (``check_paged_decode``'s
    table: holes, an all -1 row, shuffled pages, pvalid holes)."""
    import torch
    B, ps = 4, PAGE_SIZE
    P = max_seq // ps
    N = B * P + 1
    table_np, t_np = _paged_case(rng, B, N, ps, P)
    table, t = (torch.from_numpy(a).to(dev) for a in (table_np, t_np))
    pvalid = torch.from_numpy(rng.random((N, ps)) < 0.8).to(dev)
    return paged_int8_case(res, dev, f"decode (4, {P}x{ps})", (B, 1, H, Dh),
                           N, ps, K, Dh, table, t, pvalid, timed=True)


def check_int8_mlp(res, dev, D, Fd):
    """fused_mlp with int8 weights and per-output-channel scales against
    its plain version: Qwen2-7B widths at the ring prefill's 512 rows and
    a paged chunk's 16 (bf16 x, timed beside the kernel on bf16 weights at
    the same shape), ragged counts with token weights (bf16, f32) and an
    ungated toy width (f32)."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, x shape, D, F, act, gated, token weights, counts, timed)
        ("bf16", (1, 512), D, Fd, "swiglu", True, False, None, "prefill"),
        ("bf16", (1, 16), D, Fd, "swiglu", True, False, None, "chunk"),
        ("bf16", (2, 77), D, Fd, "swiglu", True, True, [77, 30], None),
        ("f32", (2, 96), D, Fd, "swiglu", True, True, [96, 41], None),
        ("f32", (1, 70), 256, 512, "gelu", False, True, [70], None),
    ]
    outs = {}
    for kind, xs, d, f, act, gated, weighted, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        x = torch.randn(*xs, d, device=dev).to(dt)
        w = lambda a, b: torch.randn(a, b, device=dev) / a ** 0.5
        ws = [w(d, f), w(f, d)] + ([w(d, f)] if gated else [])
        (wi, wis), (wo, wos) = int8_weight(ws[0]), int8_weight(ws[1])
        wg, wgs = int8_weight(ws[2]) if gated else (None, None)
        tw = torch.rand(*xs, device=dev) if weighted else None
        cnt = None if counts is None else torch.tensor(counts, device=dev,
                                                       dtype=torch.int32)
        run = lambda backend=None: ops.fused_mlp(
            x, wi, wo, wg, tw, cnt, wis, wos, wgs, act=act, backend=backend)
        case = f"int8 weights, {kind} x={tuple(x.shape)} F={f} {act} " \
               f"cnt={counts}"
        outs[case] = got = run()
        res.compare("fused_mlp", case, got, run("ref"), kind)
        if not torch.equal(got, run()):
            fail(f"int8 fused_mlp {case}: a repeat gives other bits")
        if not timed:
            continue
        wb = [a.to(dt) for a in ws] + ([None] if not gated else [])
        bf16 = lambda: ops.fused_mlp(x, wb[0], wb[1], wb[2], tw, cnt,
                                     act=act)
        int8_timing(res, "fused_mlp", f"{timed} {tuple(xs)}", cuda_ms(run, 5),
                    cuda_ms(lambda: run("ref"), 3), cuda_ms(bf16, 5),
                    cost("fused_mlp", x, wi, wo, wg, tw, cnt, wis, wos, wgs))
    return outs


def check_int8_gmm(res, dev, label, cases, cfg):
    """Replays an int8 expert path's own ``moe_gmm`` calls (recorded shapes
    and group counts) with native (E, D, Fe) / (E, Fe, D) int8 stacks and
    their (E, Fe) / (E, D) scales, random x, in bf16 and f32, with and
    without routing weights, against the plain version: slots past their
    count exact zeros, a repeat bit-identical. The heaviest call of the
    largest shape in bf16 timed beside the kernel on bf16 stacks."""
    import torch
    from repro_torch.kernels import ops
    E, D, Fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    w = lambda *sh: torch.randn(*sh, device=dev) / sh[1] ** 0.5
    wf = [w(E, D, Fe), w(E, D, Fe), w(E, Fe, D)]
    (wi, wis), (wg, wgs), (wo, wos) = (int8_weight(a) for a in wf)
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        for ci, (shape, counts) in enumerate(cases):
            B, E_, C, D_ = shape
            x = torch.randn(shape, device=dev).to(dt)
            cnt = torch.from_numpy(counts.astype(np.int32)).to(dev)
            live = torch.arange(C, device=dev) < cnt[..., None]
            for weighted in (False, True):
                rw = torch.rand(B, E, C, device=dev) if weighted else None
                run = lambda backend=None: ops.moe_gmm(
                    x, wi, wo, wg, rw, cnt, wis, wos, wgs, act="swiglu",
                    backend=backend)
                got = run()
                res.compare("moe_gmm", f"int8 stacks, {kind} {label} "
                            f"{tuple(shape)} rows {int(counts.sum())} "
                            f"w={'y' if weighted else 'n'}", got, run("ref"),
                            kind)
                if got[~live].count_nonzero() != 0:
                    fail(f"int8 moe_gmm {label}: a slot past its count is "
                         f"not zero")
                if not torch.equal(got, run()):
                    fail(f"int8 moe_gmm {label}: a repeat gives other bits")
            if kind != "bf16" or ci != 0:
                continue
            wb = [a.to(dt) for a in wf]
            int8_timing(res, "moe_gmm", f"{label} {tuple(shape)}",
                        device_and_eager_ms(lambda: ops.moe_gmm(
                            x, wi, wo, wg, None, cnt, wis, wos, wgs), 5),
                        cuda_ms(lambda: ops.moe_gmm(
                            x, wi, wo, wg, None, cnt, wis, wos, wgs,
                            backend="ref"), 3),
                        device_and_eager_ms(lambda: ops.moe_gmm(
                            x, wb[0], wb[2], wb[1], None, cnt), 5),
                        cost("moe_gmm", x, wi, wo, wg, None, cnt, wis, wos,
                             wgs))
            del wb


def check_int8_path_calls(res, dev, label, rec):
    """Replays the heaviest int8 ``decode_attention`` and ``fused_mlp``
    call a quantized path made (its recorded positions, masks, counts) with
    random int8 operands and scales of its shapes, in bf16 and f32, against
    the plain version; a slot with no attendable key must be exact
    zeros."""
    import torch
    from repro_torch.kernels import ops
    for name, c in sorted(rec.heaviest().items()):
        work = PathCalls._work(name, c)
        for kind in ("bf16", "f32"):
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            if name == "decode_attention":
                kq, vq, ks, vs = int8_kv(torch.randn(c["k"][1], device=dev),
                                         torch.randn(c["v"][1], device=dev))
                q = torch.randn(c["q"][1], device=dev).to(dt)
                run = lambda backend=None: ops.decode_attention(
                    q, kq, vq, c["kv_pos"], c["t"], c["kv_valid"], ks, vs,
                    window=c.get("window", 0), backend=backend)
                shape = c["q"][1]
            else:
                x = torch.randn(c["x"][1], device=dev).to(dt)
                sh = lambda k: c[k][1]
                (wi, wis), (wo, wos) = (int8_weight(torch.randn(
                    sh(k), device=dev) / sh(k)[0] ** 0.5) for k in ("wi",
                                                                    "wo"))
                wg, wgs = int8_weight(torch.randn(
                    sh("wg"), device=dev) / sh("wg")[0] ** 0.5) \
                    if isinstance(c.get("wg"), tuple) else (None, None)
                run = lambda backend=None: ops.fused_mlp(
                    x, wi, wo, wg, c.get("token_weights"),
                    c.get("valid_count"), wis, wos, wgs,
                    act=c.get("act", "swiglu"), backend=backend)
                shape = c["x"][1]
            got = run()
            res.compare(name, f"int8 {kind} {label} path {tuple(shape)} "
                        f"({work} {'rows' if name == 'fused_mlp' else 'pairs'})",
                        got, run("ref"), kind)
            if name == "decode_attention":
                pos, t = c["kv_pos"], c["t"].reshape(-1, 1)
                dead = ~((pos >= 0) & (pos <= t) & c["kv_valid"]).any(-1)
                if got[dead].count_nonzero() != 0:
                    fail(f"int8 decode_attention, the {label} path's "
                         f"heaviest call: a slot with no attendable key is "
                         f"not zero")


def check_int8_paged_calls(res, dev, cases, labels):
    """The quantized paged path's heaviest ``paged_decode_attention`` call
    of each shape (a decode step, a prefill chunk), replayed with int8
    pools (``paged_int8_case``), the chunk timed."""
    for qs, ks, table, t, pvalid, n in cases:
        label = f"path {labels.get(qs[0], f'{qs[0]}-row')} (heaviest of {n})"
        paged_int8_case(res, dev, label, qs, ks[0], ks[1], ks[2], ks[3],
                        table, t, pvalid, timed=qs[0] == PAGE_SIZE)


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict / list."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def check_quant_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring, paged):
    """Qwen2-7B (``--layers`` deep) served with int8 weights and int8 K/V,
    ring then paged, on the bf16 weights already on the card (each engine
    quantizes them once at init): the six staggered requests; fails unless
    budget-1.0 rows equal an int8 mode="base" engine of the same layout, a
    request alone equals its staggered tokens, (paged) two requests
    sharing a 256-token prefix each equal their solo runs, the pool drains,
    and the int8 forms of fused_mlp, decode_attention (ring) and
    paged_decode_attention (paged) launched. The path's heaviest int8
    calls are replayed against the plain versions. Prints the rates beside
    the bf16 rows of the same call, the int8-vs-bf16 greedy agreement (not
    gated), the int8 engine's KV and weight bytes against the bf16
    engine's, and one warm decode profiled beside a bf16 engine. Returns
    the launches by path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    # the weights cover the training depth too: count the served layers
    served = dict(params, layers=params["layers"][:cfg.n_layers])

    def mk(mode="infer", layout="ring", dtype="int8", n_pages=args.pages,
           n_layers=cfg.n_layers, graphs=True):
        kw = dict(kv_layout="paged", page_size=PAGE_SIZE, n_pages=n_pages) \
            if layout == "paged" else {}
        return ServingEngine(cut(served, n_layers), rp, dataclasses.replace(
            cfg, n_layers=n_layers), spec, mode=mode, batch_size=4,
            max_seq=1024, device=dev, kv_dtype=dtype, weight_dtype=dtype,
            cuda_graphs=graphs, **kw)

    launches = {}
    for layout, bf in (("ring", ring), ("paged", paged)):
        path = "quant_serving" if layout == "ring" else "quant_paged_serving"
        eng = mk(layout=layout)
        ref = mk(layout=layout, dtype="fp32")
        kv8, kv16 = tree_bytes(eng._caches), tree_bytes(ref._caches)
        w8, w16 = tree_bytes(eng.params), tree_bytes(ref.params)
        print(f"int8 {layout} serving: {cfg.name} depth {cfg.n_layers}, int8 "
              f"weights and K/V [{device_line}]: KV {kv8 / 1e6:.1f} MB "
              f"against bf16's {kv16 / 1e6:.1f} MB ({kv8 / kv16:.3f}x); "
              f"weights {w8 / 1e9:.3f} GB against {w16 / 1e9:.3f} GB "
              f"({w8 / w16:.3f}x)")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tokens = serve(eng, requests, stagger=True)   # the main path
        torch.cuda.synchronize()
        launches[path] = ops.launch_counts()
        check_launches(path, launches[path])
        if layout == "paged" and eng.paged_stats()["allocated"] != 0:
            fail("int8 paged serving: the pool did not drain")
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"bad generated tokens {toks}")
        rec = PathCalls(*(("fused_mlp", "paged_decode_attention")
                          if layout == "paged" else
                          ("fused_mlp", "decode_attention")))
        nt = twin_depth(cfg)
        twins(f"int8 {layout} infer, {nt} layers",
              lambda g: mk(layout=layout, n_layers=nt, graphs=g),
              lambda e: serve(e, requests, stagger=True), rec=rec)
        print(f"int8 {layout} kernel calls at the path's own shapes "
              f"(recorded from the {nt}-layer twin) "
              f"[{device_line}]:")
        check_int8_path_calls(res, dev, f"int8 {layout}", rec)
        if layout == "paged":
            check_int8_paged_calls(res, dev, rec.paged_cases(),
                                   {4: "decode step",
                                    PAGE_SIZE: "prefill chunk"})
        del rec
        print_timing(f"int8 {layout} serving (first run)", eng.timing,
                     device_line)
        print_timing(f"bf16 {layout} serving, same call (first run)",
                     bf["timing"], device_line)
        agree = sum(a == b for i in range(len(tokens))
                    for a, b in zip(tokens[i], bf["tokens"][i]))
        print(f"int8 vs bf16 greedy tokens (reported, not gated): "
              f"{sum(a == b for a, b in zip(tokens, bf['tokens']))} of "
              f"{len(tokens)} requests identical, {agree} of "
              f"{sum(map(len, tokens))} tokens agree position by position")
        base = mk("base", layout)
        teacher = serve(base, requests, stagger=True)
        if layout == "ring":    # for the train-mode phase
            bf.update(int8_teacher=teacher, int8_timing=dict(eng.timing))
        for i, (_, _, b) in enumerate(requests):
            if b == 1.0 and tokens[i] != teacher[i]:
                fail(f"int8 {layout}: budget-1.0 request {i} differs from "
                     f"the int8 teacher: {tokens[i]} vs {teacher[i]}")
        if layout == "paged" and base.paged_stats()["allocated"] != 0:
            fail("int8 paged teacher: the pool did not drain")
        del base
        solo = serve(mk(layout=layout), [requests[4]], stagger=False)[0]
        if solo != tokens[4]:
            fail(f"int8 {layout}: request 4 alone {solo} != staggered "
                 f"{tokens[4]}")
        print(f"int8 {layout}: budget 1.0 == int8 mode='base' teacher and "
              f"staggered == solo (request 4), bit for bit: ok")
        if layout == "paged":
            rng = np.random.default_rng(args.seed + 3)
            V = cfg.vocab_size
            pre = rng.integers(0, V, 256).astype(np.int32)
            pair = [np.concatenate([pre, rng.integers(0, V, 64).astype(
                np.int32)]) for _ in range(2)]
            sh = mk(layout="paged")
            hs = [sh.submit(GenRequest(pair[0], 16, budget=0.75))]
            sh.step()
            hs.append(sh.submit(GenRequest(pair[1], 16, budget=0.75)))
            sh.step()
            shared = sh.paged_stats()["shared"]
            while not all(h.done for h in hs):
                if sh.step() == 0:
                    fail("int8 paged engine stalled (prefix sharing)")
            if sh.paged_stats()["allocated"] != 0 or \
                    shared != 256 // PAGE_SIZE:
                fail(f"int8 prefix sharing: {shared} shared pages, "
                     f"{sh.paged_stats()['allocated']} left allocated")
            for i, h in enumerate(hs):
                alone = serve(mk(layout="paged"), [(pair[i], 16, 0.75)],
                              stagger=False)[0]
                if list(h.output) != alone:
                    fail(f"int8 prefix sharing: request {i} != alone")
            print(f"int8 prefix sharing: {shared} pages shared, each request "
                  f"== alone bit for bit, pool drained: ok")
            del sh
        decode_profile({f"bf16 {layout}": ref, f"int8 {layout}": eng},
                       (requests[0][0], 16, 0.75))
        del eng, ref
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def check_int8_fork_preemption(params, rp, spec, dev, seed, n_layers=2):
    """int8 weights and K/V on the paged pool, f32 at Qwen2-7B width,
    ``n_layers`` layers (a re-prefill then rounds as the decode steps it
    replaces, so a difference is a fault of the stored bytes): a fork
    child mid-page equals its independent run of prompt + output (the
    tail page's codes and scales copied verbatim), and two 512-token
    requests on a pool one page short (at least one preemption) each
    equal their uninterrupted runs, bit for bit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    mk = lambda n_pages=None: ServingEngine(
        p32, r32, cfg, spec, mode="infer", batch_size=2, max_seq=1024,
        device=dev, kv_layout="paged", page_size=PAGE_SIZE, n_pages=n_pages,
        kv_dtype="int8", weight_dtype="int8")
    rng = np.random.default_rng(seed + 6)
    p = rng.integers(0, cfg.vocab_size, 203).astype(np.int32)
    eng = mk()
    hp = eng.submit(GenRequest(p, 16, budget=0.75))
    for _ in range(4):
        eng.step()
    prefix = list(hp.output)
    t_fork = int(eng._t[hp.slot])
    hc = eng.fork(hp)
    while not (hp.done and hc.done):
        if eng.step() == 0:
            fail("int8 fork: engine stalled")
    indep = serve(mk(), [(np.concatenate([p, np.asarray(prefix, np.int32)]),
                          16 - len(prefix), 0.75)], stagger=False)[0]
    if list(hc.output) != indep or eng.paged_stats()["allocated"] != 0:
        fail(f"int8 fork at {t_fork}: child {list(hc.output)} != "
             f"independent {indep}")
    reqs = [(rng.integers(0, cfg.vocab_size, 512).astype(np.int32), 16, 0.75)
            for _ in range(2)]
    need = -(-(512 + 16) // PAGE_SIZE)
    eng = mk(2 * need)                  # one page short, plus the trash page
    got = serve(eng, reqs, stagger=False)
    if eng.n_preempted < 1:
        fail("int8 preemption: none on the short pool")
    alone = [serve(mk(), [r], stagger=False)[0] for r in reqs]
    if got != alone:
        fail(f"int8 preemption: {got} != uninterrupted {alone}")
    print(f"int8 fork (f32, {n_layers} layers, at position {t_fork}, "
          f"{t_fork % PAGE_SIZE} lanes of the tail page copied) == its "
          f"independent run; preemption ({2 * need}-page pool, "
          f"{eng.n_preempted} preemption(s)) == uninterrupted runs; bit for "
          f"bit: ok")


def admission_times(engine, requests, profile=False):
    """Serves ``requests`` (staggered) on ``engine`` and returns each
    admission's (prompt length, bucket, ms): the host time of its
    ``prefill_into_slot`` call between two synchronizations (the bucket
    None on an infer engine). ``profile``: each call also runs under
    torch.profiler (device activity only) and its row adds (device ms,
    kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as profiler
    from repro_torch.training import serve as serve_mod
    real, out = serve_mod.prefill_into_slot, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (profiler(activities=[ProfilerActivity.CUDA]) if profile
              else contextlib.nullcontext()) as prof:
            r = real(*a, **kw)
            torch.cuda.synchronize()
        row = (a[2]["tokens"].shape[1], kw.get("bucket"),
               (time.perf_counter() - t0) * 1e3)
        if profile:
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            row += (sum(e.self_device_time_total for e in kern) / 1e3,
                    sum(e.count for e in kern))
        out.append(row)
        return r
    serve_mod.prefill_into_slot = timed
    try:
        serve(engine, requests, stagger=True)
    finally:
        serve_mod.prefill_into_slot = real
    return out


def check_int8_routed_calls(res, dev, label, calls):
    """Replays every ``fused_mlp_routed`` call an int8 train-mode path made
    (its recorded gather indices, token weights and count, random bf16 x of
    its shape) on random int8 weights of its shapes with their scales,
    against the plain version: within TOL, rows outside the selection exact
    zeros. The heaviest call (most selected rows) is timed beside the same
    kernel on the bf16 weights the codes came from, at the same shape
    (``int8_timing``)."""
    import torch
    from repro_torch.kernels import ops
    c0 = calls[0]
    D, Fd = c0["wi"][1]
    w = lambda a, b: torch.randn(a, b, device=dev) / a ** 0.5
    wf = [w(D, Fd), w(Fd, D), w(D, Fd)]
    (wi, wis), (wo, wos), (wg, wgs) = (int8_weight(a) for a in wf)
    worst, zeros = 0.0, 0

    def runner(c, x, ws, scales, backend=None):
        return lambda backend=backend: ops.fused_mlp_routed(
            x, c["idx"], *ws, c.get("token_weights"), c.get("valid_count"),
            *scales, act=c.get("act", "swiglu"), backend=backend)
    for c in calls:
        x = torch.randn(c["x"][1], device=dev).to(torch.bfloat16)
        run = runner(c, x, (wi, wo, wg), (wis, wos, wgs))
        got = run()
        worst = max(worst, res.compare(
            "fused_mlp_routed", f"int8 {label} call {tuple(x.shape)}", got,
            run("ref"), "bf16", quiet=True))
        B, Kb = c["idx"].shape
        live = torch.zeros(x.shape[:2], dtype=torch.bool, device=dev)
        cnt = torch.as_tensor(c["valid_count"], device=dev).expand(B)
        for b in range(B):
            live[b, c["idx"][b, :int(cnt[b])]] = True
        if got[~live].count_nonzero() != 0:
            fail(f"int8 fused_mlp_routed, a {label} call: a row outside the "
                 f"selection is not zero")
        zeros += int((~live).sum())
    rows = [PathCalls._work("fused_mlp_routed", c) for c in calls]
    print(f"  fused_mlp_routed  int8 {label}: {len(calls)} calls replayed "
          f"(selected rows {min(rows)}-{max(rows)}, buckets "
          f"{sorted({c['idx'].shape[1] for c in calls})}), worst err/tol "
          f"{worst:.3f} (bf16 TOL), {zeros} unselected rows all exactly "
          f"zero: ok")
    c = max(calls, key=lambda c: PathCalls._work("fused_mlp_routed", c))
    x = torch.randn(c["x"][1], device=dev).to(torch.bfloat16)
    B, S, _ = x.shape
    Kb, n = c["idx"].shape[1], PathCalls._work("fused_mlp_routed", c)
    run = runner(c, x, (wi, wo, wg), (wis, wos, wgs))
    bf16 = runner(c, x, [a.to(torch.bfloat16) for a in wf], (None,) * 3)
    int8_timing(res, "fused_mlp_routed", f"{label} ({B}, {S}) Kb={Kb}",
                cuda_ms(run, 5), cuda_ms(lambda: run("ref"), 3),
                cuda_ms(bf16, 5),
                cost("fused_mlp_routed", x, c["idx"], wi, wo, wg,
                     c.get("token_weights"), c.get("valid_count"), wis, wos,
                     wgs))


def check_train_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring):
    """Qwen2-7B (``--layers`` deep) served by ``ServingEngine(mode="train")``
    on the ring: each admission routes by top-k into the request's ragged
    capacity bucket (the routed MLP through ``fused_mlp_routed``), decode
    is the threshold step. The six staggered requests in bf16, then with
    int8 weights and K/V (the routed kernel's int8 form); fails unless the
    tokens are in the vocabulary, budget-1.0 requests equal the teacher
    (the ring ``mode="base"`` run of item 3; for int8, item 3c's int8
    teacher), request 4 (budget 0.5) alone equals its staggered run, bit
    for bit, ``compile_counts()`` is {prefill 0, decode 1}, the graphed
    engine equals its ``cuda_graphs=False`` twin at ``twin_depth`` and the
    path's kernels launched. Every ``fused_mlp_routed`` call of the int8
    run is replayed against the plain version (``check_int8_routed_calls``).
    Prints each admission's bucket and time (warm) beside an infer engine's
    and both engines' rates. Returns the launches by path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    served = cut(params, cfg.n_layers)

    def mk(dtype, mode="train", n_layers=cfg.n_layers, graphs=True):
        return ServingEngine(cut(served, n_layers), rp, dataclasses.replace(
            cfg, n_layers=n_layers), spec, mode=mode, batch_size=4,
            max_seq=1024, device=dev, kv_dtype=dtype, weight_dtype=dtype,
            cuda_graphs=graphs)

    launches = {}
    for dtype, path in (("fp32", "train_serving"),
                        ("int8", "quant_train_serving")):
        label = "bf16" if dtype == "fp32" else "int8"
        teacher = ring["teacher" if dtype == "fp32" else "int8_teacher"]
        eng = mk(dtype)
        rec = PathCalls("fused_mlp_routed") if dtype == "int8" else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with (rec or contextlib.nullcontext()):
            tokens = serve(eng, requests, stagger=True)   # the main path
        torch.cuda.synchronize()
        launches[path] = ops.launch_counts()
        check_launches(path, launches[path])
        timing = dict(eng.timing)
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"train {label}: bad generated tokens {toks}")
        if eng.compile_counts() != {"prefill": 0, "decode": 1}:
            fail(f"train {label}: compile_counts {eng.compile_counts()}, "
                 f"want prefill 0, decode 1")
        for i, (_, _, b) in enumerate(requests):
            if b == 1.0 and tokens[i] != teacher[i]:
                fail(f"train {label}: budget-1.0 request {i} differs from "
                     f"the teacher: {tokens[i]} vs {teacher[i]}")
        solo = serve(mk(dtype), [requests[4]], stagger=False)[0]
        if solo != tokens[4]:
            fail(f"train {label}: request 4 alone {solo} != staggered "
                 f"{tokens[4]}")
        print(f"train {label} ring serving, {cfg.name} depth {cfg.n_layers} "
              f"[{device_line}]: budget 1.0 == the {label} mode='base' "
              f"teacher, staggered == solo (request 4), bit for bit; "
              f"compile_counts {eng.compile_counts()}; launches "
              f"{launches[path]}: ok")
        nt = twin_depth(cfg)
        twins(f"train {label} ring, {nt} layers",
              lambda g: mk(dtype, n_layers=nt, graphs=g),
              lambda e: serve(e, requests, stagger=True))
        if rec is not None:
            print(f"int8 fused_mlp_routed at the train-mode path's own calls "
                  f"(the {cfg.n_layers}-layer run's admissions) "
                  f"[{device_line}]:")
            check_int8_routed_calls(res, dev, "train admission",
                                    rec.calls["fused_mlp_routed"])
            del rec
        # warm: each admission's bucket and time beside an infer engine's
        train = admission_times(eng, requests)
        infer = mk(dtype, mode="infer")
        serve(infer, requests, stagger=True)            # its cold run
        inf = admission_times(infer, requests)
        print(f"train {label} admissions, warm, bucket and ms (tok/s) "
              f"against the {label} infer engine's [{device_line}]:")
        for (n, bucket, ms), (_, _, ims), r in zip(train, inf, requests):
            print(f"  prompt {n:4d} budget {r[2]}: bucket "
                  f"{'identity' if bucket == -1 else bucket} {ms:8.2f} ms "
                  f"({n / ms * 1e3:8.1f} tok/s); infer {ims:8.2f} ms "
                  f"({n / ims * 1e3:8.1f} tok/s)")
        (tms, tk), (ims, ik) = (
            admission_times(e, requests[1:2], profile=True)[0][3:]
            for e in (eng, infer))
        print(f"train {label} admission of request 1 ({len(requests[1][0])} "
              f"tokens, budget {requests[1][2]}) under the profiler: "
              f"{tms:.2f} device ms, {tk} kernels; infer {ims:.2f} device "
              f"ms, {ik} kernels [{device_line}]")
        print_timing(f"train {label} ring serving (first run)", timing,
                     device_line)
        print_timing(f"{label} ring infer serving, same call (first run)",
                     ring["timing" if dtype == "fp32" else "int8_timing"],
                     device_line)
        del eng, infer
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def check_native_int8_serving(dev, device_line, state):
    """The native MoE of ``check_native_serving`` (its weights, routers and
    requests) served with int8 weights and K/V: staggered == solo bit for
    bit, moe_gmm launched; prints the rates. Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    params, rp, cfg, spec, requests = state
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), spec,
        mode="infer", batch_size=4, max_seq=1024, device=dev,
        kv_dtype="int8", weight_dtype="int8", cuda_graphs=g)
    engine = mk()
    print(f"native MoE int8 serving: weights {tree_bytes(engine.params) / 1e9:.3f}"
          f" GB (bf16 {tree_bytes(params) / 1e9:.3f}), KV "
          f"{tree_bytes(engine._caches) / 1e6:.1f} MB [{device_line}]")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("quant_native_serving", launches)
    twins(f"native MoE int8 ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, requests, stagger=True))
    print_timing("native MoE int8 serving (first run)", engine.timing,
                 device_line)
    del engine
    solo = serve(mk(), [requests[4]], stagger=False)[0]
    if solo != tokens[4]:
        fail(f"native MoE int8: request 4 alone {solo} != staggered "
             f"{tokens[4]}")
    print("native MoE int8 staggered == solo (request 4), bit for bit: ok")
    return launches


# ----------------------------- context families -------------------------------
#
# The VLM (Llama-3.2-Vision-11B: image embeddings projected by in_proj, top-k
# selected by the vlm router, cross-attended by every 5th layer), its router
# distillation, the ViT encoder's (toy-vit, cosine loss), and the
# encoder-decoder (Whisper-medium: a 24-layer encoder run non-causally over
# 1500 frames, cross-attended by every decoder layer).

VLM_LENS = (64, 300, 128, 200, 96, 256)   # the six requests' prompt lengths
VLM_BUDGETS = (1.0, 0.75, 0.5, 1.0, 0.5, 0.75)
VLM_TWIN_LAYERS = 5     # the twins' depth: the first xattn layer is the 5th
CTX_NEW = 16            # new tokens per request


def context_spec(name, experts=True):
    """``name``'s elastic spec (``get_elastic``: the registered one, or
    the port's default for an arch that registers none); ``experts=False``
    drops its moefied experts (then budget 1.0 is the dense teacher bit
    for bit: with them a full expert budget sums E partial products)."""
    import dataclasses
    from repro_torch.configs import get_config, get_elastic
    from repro_torch.core.policy import spec_from_config
    spec = spec_from_config(get_elastic(name, get_config(name)))
    if not experts:
        spec = dataclasses.replace(spec, mlp_n_experts=None,
                                   expert_routed=False)
    return spec


def peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def admission_and_decode(engine, req, device_line):
    """``req`` served twice on ``engine``; the second run's admission
    (prefill) ms and decode ms/step from ``engine.timing`` (host wall: each
    ends in a copy to the host, which waits for the device; the first run
    captured the decode graph)."""
    import torch
    serve(engine, [req], stagger=False)
    for k in engine.timing:
        engine.timing[k] = 0 if isinstance(engine.timing[k], int) else 0.0
    torch.cuda.synchronize()
    serve(engine, [req], stagger=False)
    tm = engine.timing
    print(f"  warm: admission {tm['prefill_s'] * 1e3:.1f} ms "
          f"({tm['prefill_tokens']} prompt tokens), decode "
          f"{tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step "
          f"over {tm['decode_steps']} steps [{device_line}]")
    return tm


def xattn_decode_share(label, engine, dev, device_line):
    """The device time of a captured decode step (its graph replayed)
    beside that of the plain decode-time cross-attention of every xattn
    layer (``attention.cross_attn_decode`` on the engine's context
    caches, one token per slot, captured and replayed too): the
    cross-attention's device share of a step."""
    import torch
    from repro_torch.models.attention import cross_attn_decode
    from repro_torch.models.layers import dtype_of
    cfg = engine.cfg
    graph, _ = engine._forms[("decode", "greedy")]
    step = cuda_ms(graph.replay, 10)
    layers = [(p, c) for p, c in zip(engine.params["layers"],
                                     engine._caches["layers"])
              if "xattn" in c]
    x = torch.randn((engine.B, 1, cfg.d_model), device=dev).to(dtype_of(cfg))
    xa = cuda_ms(lambda: [cross_attn_decode(p["xattn"], x, c["xattn"],
                                            cfg=cfg) for p, c in layers], 10,
                 graph=True)
    med = lambda ts: ts[len(ts) // 2]
    print(f"  {label}: a graphed decode step {med(step):.3f} ms on the device"
          f" [{step[0]:.3f}-{step[-1]:.3f}]; the plain cross-attention of "
          f"its {len(layers)} xattn layers ({engine.B} slots over "
          f"{layers[0][1]['xattn']['k'].shape[1]} context rows) "
          f"{med(xa):.3f} ms graphed [{xa[0]:.3f}-{xa[-1]:.3f}], "
          f"{100 * med(xa) / med(step):.1f} % of the step [{device_line}]")


def context_timing(res, dev, label, name, c, row, group="context"):
    """Times a context path's recorded non-causal ``flash_attention`` or
    dense ``fused_mlp`` call (``check_path_calls`` holds it to the plain
    version) on random bf16 operands of its shapes with its masks: the
    kernel graphed and eager beside the plain version, one library call
    (SDPA, enable_gqa, the same mask) or a cuBLAS composite (printed, not
    library_ms), and its bound; a repeat must give the same bits. Kept in
    the result line under the kernel's ``context`` key as ``row``."""
    import torch
    from repro_torch.kernels import ops
    med = lambda ts: ts[len(ts) // 2]
    rand = lambda key, scale=1.0: (torch.randn(c[key][1], device=dev)
                                   * scale).to(torch.bfloat16)
    if name == "flash_attention":
        q, k, v = rand("q"), rand("k"), rand("v")
        mask = PathCalls.flash_mask(c)
        pairs = int(mask.sum())
        B, Sq, H, Dh = q.shape
        Sk, K = k.shape[1:3]
        kw = dict(kv_valid=c.get("kv_valid"), kv_count=c.get("kv_count"),
                  causal=c.get("causal", True), window=c.get("window", 0))
        run = lambda backend=None: ops.flash_attention(q, k, v,
                                                       backend=backend, **kw)
        work = cost("flash_attention", q, k, v, **kw)
        lib = sdpa_ms(name, q.transpose(1, 2), [k], [v], mask[:, None], 20)
        what = (f"q {(B, Sq, H, Dh)} over {Sk} keys (K {K}, causal "
                f"{kw['causal']}, window {kw['window']}, {pairs} pairs)")
        out = dict(shape=[B, Sq, Sk, H, K, Dh], pairs=pairs,
                   causal=kw["causal"], window=kw["window"],
                   graphed_library_ms=med(lib[0]), library_ms=med(lib[1]))
        lib_s = f"SDPA {med(lib[0]):.4f} / {med(lib[1]):.4f}"
    else:
        D, Fd = c["wi"][1]
        gated = isinstance(c.get("wg"), tuple)
        x, wi, wo = rand("x"), rand("wi", D ** -0.5), rand("wo", Fd ** -0.5)
        wg = rand("wg", D ** -0.5) if gated else None
        act = c["act"]
        run = lambda backend=None: ops.fused_mlp(x, wi, wo, wg, act=act,
                                                 backend=backend)
        rows = x.numel() // D
        work = cost("fused_mlp", x, wi, wo, wg, act=act)
        plan = ops.mlp_plan(x.dtype, 1, rows, D, Fd)
        comp = composite_ms(x.reshape(-1, D), wi, wo, wg, None, act)
        what = (f"{rows} rows x {D} x {Fd} {act} "
                f"({'gated' if gated else 'ungated'}, {plan.body} body, "
                f"{plan.rows} rows/tile, split {plan.split})")
        out = dict(shape=list(x.shape) + [Fd], act=act, body=plan.body,
                   library_ms=None)
        lib_s = f"cuBLAS composite {med(comp):.4f} (printed, not library_ms)"
    if not torch.equal(run(), run()):
        fail(f"{name} {label}: a repeat gives other bits")
    kern = device_and_eager_ms(run, 20)
    plain = device_and_eager_ms(lambda: run("ref"), 5)
    b, by = bound_ms(*work)
    out.update(graphed_ms=med(kern[0]), ms=med(kern[1]),
               graphed_plain_ms=med(plain[0]), plain_ms=med(plain[1]),
               bound_ms=b, bound_by=by)
    print(f"  {name:17s} {label} bf16 {what}: kernel {med(kern[0]):.4f} ms "
          f"graphed [{kern[0][0]:.4f}-{kern[0][-1]:.4f}], {med(kern[1]):.4f}"
          f" eager; plain {med(plain[0]):.4f} / {med(plain[1]):.4f}; {lib_s};"
          f" bound {b:.4f} ms ({by})")
    res.rows[name].setdefault(group, {})[row] = out


def check_vlm_serving(args, res, dev, device_line):
    """(a) Llama-3.2-Vision-11B at full width, --vlm-layers deep, random
    bf16 weights and routers from --seed, its registered elastic spec
    (the MLPs moefied into 16 experts, token and head routing, LoRA, the
    image-token router at 0.6). Six requests on the ring in infer mode,
    each with its own ``procedural_images`` image (1601 x 1280), budgets
    1.0 / 0.75 / 0.5. Returns the paths' launches and (params, rp, cfg,
    spec, requests) for the distillation phase."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_elastic
    from repro_torch.data import procedural_images
    from repro_torch.kernels import ops
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine
    arch = "llama-3.2-vision-11b"
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=args.vlm_layers)
    spec = context_spec(arch)
    print(f"VLM serving: {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
          f"K={cfg.n_kv_heads} Dh={cfg.d_head} F={cfg.d_ff} "
          f"V={cfg.vocab_size} {cfg.dtype}, image {cfg.n_image_tokens} x "
          f"{cfg.d_frontend}, depth {cfg.n_layers} of {full.n_layers} "
          f"({cfg.layer_kinds.count('xattn')} xattn), MLPs moefied into "
          f"{spec.mlp_n_experts} experts, image tokens at "
          f"{get_elastic(arch, full).vlm_token_capacity} "
          f"[{device_line}]")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.n_params() / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s, {peak_gib():.2f} GiB")
    t0 = time.perf_counter()
    images, _ = procedural_images(len(VLM_LENS) + 1, cfg.n_image_tokens,
                                  cfg.d_frontend, args.seed)
    print(f"procedural_images: {images.shape} in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed + 3)
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                 CTX_NEW, b, {}, {"image_embeds": images[i:i + 1]})
                for i, (n, b) in enumerate(zip(VLM_LENS, VLM_BUDGETS))]
    mk = lambda n=cfg.n_layers, g=True, mode="infer", sp=spec: \
        ServingEngine(cut(params, n), rp, dataclasses.replace(
            cfg, n_layers=n), sp, mode=mode, batch_size=4, max_seq=512,
            device=dev, cuda_graphs=g)
    engine = mk()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("vlm_serving", launches)
    print(f"VLM serving peak memory {peak_gib():.2f} GiB [{device_line}]")
    print_timing("VLM serving (first run)", engine.timing, device_line)
    for toks in tokens:
        if len(toks) != CTX_NEW or not all(0 <= x < cfg.vocab_size
                                           for x in toks):
            fail(f"VLM: bad generated tokens {toks}")
    nt = min(VLM_TWIN_LAYERS, cfg.n_layers)
    rec = PathCalls()
    twins(f"VLM ring infer, {nt} layers (an xattn layer among them)",
          lambda g: mk(nt, g), lambda e: serve(e, requests, stagger=True),
          rec=rec)
    solo_i = 4
    solo = profiled(lambda: serve(mk(), [requests[solo_i]],
                                  stagger=False))[0]
    if solo != tokens[solo_i]:
        fail(f"VLM: request {solo_i} alone {solo} != staggered "
             f"{tokens[solo_i]}")
    print(f"VLM staggered == solo (request {solo_i}, budget "
          f"{VLM_BUDGETS[solo_i]}), bit for bit: ok")
    # budget 1.0 against the teacher: with the moefied MLPs a full expert
    # budget sums 16 partial products (reported); without them (the same
    # spec, dense MLPs) bit for bit (gated)
    base = mk(mode="base")
    teacher = serve(base, requests, stagger=True)
    full_ids = [i for i, b in enumerate(VLM_BUDGETS) if b == 1.0]
    same = sum(tokens[i] == teacher[i] for i in full_ids)
    print(f"VLM budget 1.0 (16 moefied experts) vs mode='base': {same} of "
          f"{len(full_ids)} requests give the teacher's tokens (reported, "
          f"not gated: E partial products in bf16)")
    dense = serve(mk(sp=context_spec(arch, experts=False)),
                  [requests[i] for i in full_ids], stagger=False)
    if dense != [teacher[i] for i in full_ids]:
        fail(f"VLM budget 1.0 (dense MLPs) {dense} != mode='base' "
             f"{[teacher[i] for i in full_ids]}")
    print(f"VLM budget 1.0 == mode='base' teacher, bit for bit, with the "
          f"registered spec's dense MLPs ({len(full_ids)} requests): ok")
    # the image decides the tokens
    same_prompt = [(requests[1][0], CTX_NEW, 0.75, {}, requests[j][4])
                   for j in (0, 1, 0)]
    alt = [(requests[1][0], CTX_NEW, 0.75, {},
            {"image_embeds": images[-1:]})]
    out = serve(mk(), same_prompt + alt, stagger=False)
    if out[0] != out[2] or out[0] == out[1] or out[0] == out[3]:
        fail(f"VLM: one prompt with images 0, 1, 0, 6 gave {out}")
    print("VLM: one prompt with two images gives different tokens, with the "
          "same image the same tokens, bit for bit: ok")
    warm = mk()
    admission_and_decode(warm, requests[1], device_line)
    xattn_decode_share("VLM", warm, dev, device_line)
    del warm
    context_calls(res, dev, device_line, "VLM serving", rec, cfg, spec,
                  {"flash_attention non-causal": "1b_vlm_cross"})
    return {"vlm_serving": launches}, (params, rp, cfg, spec, images)


def context_calls(res, dev, device_line, label, rec, cfg, spec, rows):
    """A context path's recorded kernel calls held to the plain versions:
    the heaviest flash (causal and non-causal), decode and dense MLP call
    (``check_path_calls``) and, where the spec moefies the MLPs, the
    heaviest ``moe_gmm`` call of each shape on expert views of the
    config's width (``check_moe_gmm``); ``rows`` maps the replayed calls
    to time (``context_timing``) to their result rows."""
    print(f"kernel calls of the {label} path (recorded from the eager "
          f"twin or the steps) [{device_line}]:")
    heaviest = check_path_calls(res, dev, label, rec)
    if spec.mlp_n_experts:
        check_moe_gmm(res, dev, label, rec.gmm_cases(), moefied_weights(
            dev, cfg.d_model, cfg.d_ff, spec.mlp_n_experts), timed=False)
    for key, row in rows.items():
        context_timing(res, dev, label, key.split()[0], heaviest[key], row)


def check_context_training(label, path, cfg, spec, params, rp, batches,
                           policies, dev, device_line, remat=True):
    """Router distillation steps of ``make_train_step`` over ``batches``
    with ``policies`` ((policy, bucket) per step): every loss finite;
    then the last step's loss and router gradients twice from the same
    state: the same bits, and a non-zero gradient on every router kind
    named by ``policies``' caller (returned). Returns the launches of the
    steps."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.training import (init_train_state, make_loss_fn,
                                      make_train_step)
    state = init_train_state(rp)
    step_fn = make_train_step(cfg, spec, lr=1e-4, remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    states = []
    for i, (batch, (pol, bucket)) in enumerate(zip(batches, policies)):
        states.append(state)
        timing = {}
        t0 = time.perf_counter()
        state, m = step_fn(state, params, batch, pol, bucket, timing=timing)
        wall = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{label} step {i}: non-finite metrics {m}")
        print(f"  {label} step {i} bucket {bucket}: loss {m['loss']:.6f} "
              f"distill {m['distill']:.6e} sel_rate {m['sel_rate']:.4f} "
              f"grad_norm {m['grad_norm']:.6f} | teacher "
              f"{timing['teacher_s'] * 1e3:.1f} ms, student "
              f"{timing['student_s'] * 1e3:.1f} ms, step {wall * 1e3:.1f} ms,"
              f" peak {peak_gib():.2f} GiB [{device_line}]")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches(path, launches)
    loss_fn = make_loss_fn(cfg, spec, remat=remat)
    pol, bucket = policies[-1]
    runs = []
    for _ in range(2):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          states[-1].router_params)
        loss, _ = loss_fn(leaves, params, batches[-1], pol, bucket)
        grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                    allow_unused=True)
        runs.append((loss.detach(), grads, leaves))
    if not (torch.equal(runs[0][0], runs[1][0]) and all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(runs[0][1], runs[1][1]))):
        fail(f"{label}: the last step run twice differs")
    print(f"  {label}: the last step twice from the same state, loss and "
          f"{len(runs[0][1])} router gradients bit-identical: ok")
    return launches, runs[0][2], runs[0][1]


def nonzero_grad(label, leaves, grads, sub):
    """Fails unless the router subtree ``sub`` of ``leaves`` got a non-zero
    gradient."""
    from repro_torch.optim.optimizer import tree_leaves
    ids = {id(t) for t in tree_leaves(sub)}
    g = [gr for t, gr in zip(tree_leaves(leaves), grads) if id(t) in ids]
    if not g or not any(x is not None and bool(x.any()) for x in g):
        fail(f"{label}: no gradient reaches the router")
    return max(float(x.abs().max()) for x in g if x is not None)


def check_vlm_training(args, res, dev, device_line, state):
    """(b) 3 distillation steps at Llama-3.2-Vision full width,
    --vlm-layers deep, B=1, S=256, one image, budget annealed 1.0 -> 0.6,
    with the image-token capacity static (the (1, 961, D) gathered subset)
    and tensor (the full 1601 rows and a validity mask, the ragged bucket
    of the token routers): finite losses, the vlm router's gradient
    non-zero at the last step, a repeated step bit for bit."""
    import torch
    from repro_torch.core.policy import ElasticPolicy, ragged_bucket
    from repro_torch.data import LMDataPipeline
    params, rp, cfg, spec, images = state
    S = 256
    pipe = LMDataPipeline(vocab=cfg.vocab_size, seq_len=S, global_batch=1,
                          seed=args.seed)
    batches = [{"tokens": torch.as_tensor(pipe.batch_at(i), device=dev),
                "image_embeds": torch.as_tensor(images[i:i + 1],
                                                device=dev)}
               for i in range(3)]
    budgets = (1.0, 0.8, 0.6)
    kw = dict(n_heads=cfg.n_heads, n_experts=spec.mlp_n_experts)
    out = {}
    for form in ("static", "tensor"):
        pols = []
        for b in budgets:
            if form == "static":
                pols.append((ElasticPolicy.uniform(b, static=True, **kw),
                             None))
            else:
                p = ElasticPolicy.uniform(b, **kw).to(dev)
                pols.append((p, ragged_bucket(p, S, spec=spec)))
        print(f"VLM distillation, image-token capacity {form}: {cfg.name} "
              f"width, depth {cfg.n_layers}, B=1 S={S}, image "
              f"{cfg.n_image_tokens} tokens, budget {budgets} [{device_line}]")
        with PathCalls() as rec:
            launches, leaves, grads = check_context_training(
                f"VLM {form}", "vlm_training", cfg, spec, params, rp,
                batches, pols, dev, device_line)
        g = nonzero_grad(f"VLM {form}", leaves, grads, leaves["vlm"])
        print(f"  VLM {form}: the vlm router's gradient max |g| {g:.4e} "
              f"(non-zero): ok")
        out[f"vlm_training_{form}"] = launches
        del leaves, grads
        context_calls(res, dev, device_line, f"VLM training {form}", rec,
                      cfg, spec, {})
        del rec
    return out


def check_vit_training(args, dev, device_line):
    """(c) toy-vit (the bidirectional encoder over 64 patch embeddings) in
    bf16 and f32: 4 distillation steps of the cosine distance on
    ``procedural_images``, budget 1.0 -> 0.5 with its ragged bucket:
    finite losses, a non-zero token-router gradient, a repeated step bit
    for bit."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_elastic
    from repro_torch.core.policy import (ElasticPolicy, ragged_bucket,
                                         spec_from_config)
    from repro_torch.data import procedural_images
    from repro_torch.models import model_init, router_init
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("toy-vit"), dtype=dtype)
        spec = spec_from_config(get_elastic("toy-vit", cfg))
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = model_init(gen, cfg, spec, device=dev)
        rp = router_init(gen, cfg, spec, device=dev)
        batches = [{"embeds": torch.as_tensor(procedural_images(
            8, cfg.n_image_tokens, cfg.d_frontend, args.seed + i)[0],
            device=dev)} for i in range(4)]
        pols = []
        for b in (1.0, 0.8, 0.65, 0.5):
            p = ElasticPolicy.uniform(b, n_heads=cfg.n_heads).to(dev)
            pols.append((p, ragged_bucket(p, cfg.n_image_tokens, spec=spec)))
        print(f"ViT distillation (cosine): {cfg.name} d={cfg.d_model} "
              f"{cfg.n_layers} layers, {dtype}, B=8 x {cfg.n_image_tokens} "
              f"patches [{device_line}]")
        launches, leaves, grads = check_context_training(
            f"ViT {dtype}", "vit_training", cfg, spec, params, rp, batches,
            pols, dev, device_line, remat=False)
        g = nonzero_grad(f"ViT {dtype}", leaves, grads,
                         [layer["tok_mixer"] for layer in leaves["layers"]])
        print(f"  ViT {dtype}: token routers' gradient max |g| {g:.4e} "
              f"(non-zero): ok")
        out[f"vit_training_{dtype}"] = launches
    return out


def check_encdec_serving(args, res, dev, device_line):
    """(d) Whisper-medium at full width (24 encoder + 24 decoder layers,
    d 1024, 16 heads, layernorm, gelu, qkv bias), random bf16 weights
    from --seed, its registered spec without the moefied experts (budget
    1.0 is then the teacher bit for bit); 1500 frames per request from
    --seed. Four requests on the ring in infer mode: staggered == solo
    and budget 1.0 == a mode="base" engine, bit for bit; graphed == eager
    twins at 4 decoder layers. The path's heaviest non-causal flash call
    (the encoder's) and dense MLP call are replayed and timed."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine
    cfg = get_config("whisper-medium")
    spec = context_spec("whisper-medium", experts=False)
    e = cfg.encoder
    print(f"encoder-decoder serving: {cfg.name} d={cfg.d_model} "
          f"H={cfg.n_heads} Dh={cfg.d_head} F={cfg.d_ff} {cfg.act} "
          f"{cfg.norm} V={cfg.vocab_size}, encoder {e.n_layers} layers over "
          f"{e.encoder_seq} frames, decoder {cfg.n_layers} xattn layers, "
          f"{cfg.dtype}, frame tokens at 0.6 [{device_line}]")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.n_params() / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(args.seed + 4)
    frames = torch.randn((4, e.encoder_seq, e.d_model), generator=g,
                         device=dev)
    rng = np.random.default_rng(args.seed + 4)
    budgets = (1.0, 0.75, 0.5, 1.0)
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                 CTX_NEW, b, {}, {"frames": frames[i:i + 1]})
                for i, (n, b) in enumerate(zip((8, 24, 4, 16), budgets))]
    mk = lambda n=cfg.n_layers, g=True, mode="infer": ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), spec,
        mode=mode, batch_size=4, max_seq=64, device=dev, cuda_graphs=g)
    engine = mk()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("encdec_serving", launches)
    print(f"encoder-decoder serving peak memory {peak_gib():.2f} GiB "
          f"[{device_line}]")
    print_timing("encoder-decoder serving (first run)", engine.timing,
                 device_line)
    for toks in tokens:
        if len(toks) != CTX_NEW or not all(0 <= x < cfg.vocab_size
                                           for x in toks):
            fail(f"encoder-decoder: bad generated tokens {toks}")
    rec = PathCalls()
    twins(f"encoder-decoder ring infer, {twin_depth(cfg)} decoder layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, requests, stagger=True), rec=rec)
    solo = profiled(lambda: serve(mk(), [requests[2]], stagger=False))[0]
    if solo != tokens[2]:
        fail(f"encoder-decoder: request 2 alone {solo} != staggered "
             f"{tokens[2]}")
    print("encoder-decoder staggered == solo (request 2, budget 0.5), bit "
          "for bit: ok")
    teacher = serve(mk(mode="base"), requests, stagger=True)
    for i, b in enumerate(budgets):
        if b == 1.0 and tokens[i] != teacher[i]:
            fail(f"encoder-decoder budget-1.0 request {i} {tokens[i]} != "
                 f"mode='base' {teacher[i]}")
    print("encoder-decoder budget 1.0 == mode='base' teacher, bit for bit: "
          "ok")
    warm = mk()
    admission_and_decode(warm, requests[1], device_line)
    xattn_decode_share("encoder-decoder", warm, dev, device_line)
    del warm
    context_calls(res, dev, device_line, "encoder-decoder serving", rec, cfg,
                  spec, {"flash_attention non-causal": "1c_whisper_encoder",
                         "fused_mlp": "2f_whisper_gelu"})
    return {"encdec_serving": launches}


# ------------------ the recurrent, windowed and attention-only ----------------
# families: (e) RecurrentGemma-2B, (f) Gemma-3-27B, (g) Mamba2-780M, (h)
# Granite-34B, Phi-3-medium-14B and Grok-1-314B

FAM_NEW = 16            # new tokens per request of (e), (g), (h)
GEMMA_LENS = (1500, 700, 1100, 300)     # past the local window of 1024
GEMMA_BUDGETS = (1.0, 0.75, 0.5, 1.0)
GEMMA_NEW = 64
HYBRID_TWIN_LAYERS = 3  # one (rglru, rglru, attn) period of RecurrentGemma
GEMMA_TWIN_LAYERS = 6   # one 5 local : 1 global period of Gemma-3


def family_requests(cfg, lens, budgets, new, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new, b)
            for n, b in zip(lens, budgets)]


def family_serving(args, dev, device_line, label, path, cfg, spec, requests,
                   max_seq, twin_layers, dense_spec=None):
    """One family's ring serving at ``cfg`` (full width; random bf16
    weights and routers from --seed): the staggered requests on a graphed
    infer engine (the path; its launches counted and gated by
    ``PATH_KERNELS[path]``), the graphed engine at ``twin_layers`` held
    to its ``cuda_graphs=False`` twin (tokens and every cache leaf, the
    recurrent ``state``/``conv`` ones too; the twin's kernel calls
    recorded), request 2 alone == staggered, and budget 1.0
    against a mode="base" engine: gated bit for bit with ``spec`` when it
    moefies nothing, else with ``dense_spec`` (the same spec's dense
    MLPs), the spec's own agreement reported. Prints peak memory, the
    rates and one warm request's admission ms and decode ms/step.
    Returns (launches, params, rp, recorded calls, tokens)."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.n_params() / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s, {peak_gib():.2f} GiB")
    mk = lambda n=cfg.n_layers, g=True, mode="infer", sp=spec: \
        ServingEngine(cut(params, n), rp, dataclasses.replace(
            cfg, n_layers=n), sp, mode=mode, batch_size=4, max_seq=max_seq,
            device=dev, cuda_graphs=g)
    engine = mk()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches(path, launches)
    print(f"{label} serving peak memory {peak_gib():.2f} GiB [{device_line}]")
    print_timing(f"{label} serving (first run)", engine.timing, device_line)
    del engine
    for (_, new, _), toks in zip(requests, tokens):
        if len(toks) != new or not all(0 <= x < cfg.vocab_size
                                       for x in toks):
            fail(f"{label}: bad generated tokens {toks}")
    nt = min(twin_layers, cfg.n_layers)
    rec = PathCalls()
    twins(f"{label} ring infer, {nt} layers", lambda g: mk(nt, g),
          lambda e: serve(e, requests, stagger=True), rec=rec)
    solo = serve(mk(), [requests[2]], stagger=False)[0]
    if solo != tokens[2]:
        fail(f"{label}: request 2 alone {solo} != staggered {tokens[2]}")
    print(f"{label} staggered == solo (request 2, budget {requests[2][2]}), "
          f"bit for bit: ok")
    full_ids = [i for i, r in enumerate(requests) if r[2] == 1.0]
    teacher = serve(mk(mode="base"), [requests[i] for i in full_ids],
                    stagger=False)
    if spec.mlp_n_experts or (cfg.moe is not None and spec.expert_routed):
        same = sum(tokens[i] == t for i, t in zip(full_ids, teacher))
        print(f"{label} budget 1.0 (expert routing) vs mode='base': {same} "
              f"of {len(full_ids)} requests give the teacher's tokens "
              f"(reported, not gated: a full expert budget sums E partial "
              f"products in bf16)")
    if cfg.moe is None:
        sp = dense_spec if spec.mlp_n_experts else spec
        got = [tokens[i] for i in full_ids] if sp is spec else serve(
            mk(sp=sp), [requests[i] for i in full_ids], stagger=False)
        if got != teacher:
            fail(f"{label} budget 1.0 {got} != mode='base' {teacher}")
        print(f"{label} budget 1.0 == mode='base' teacher, bit for bit"
              f"{' (the spec with dense MLPs)' if sp is not spec else ''} "
              f"({len(full_ids)} requests): ok")
    torch.cuda.reset_peak_memory_stats()
    warm = mk()
    admission_and_decode(warm, requests[1], device_line)
    print(f"{label} warm serving peak memory {peak_gib():.2f} GiB "
          f"[{device_line}]")
    del warm
    return launches, params, rp, rec, tokens


def family_training(args, dev, device_line, label, path, cfg, spec, params,
                    rp, B, S, budgets, grad_kinds):
    """Distillation steps of ``make_train_step`` at ``cfg``, B x S tokens
    of ``LMDataPipeline`` (--seed), the budget annealed over ``budgets``
    (tensor policies with their ragged buckets): every loss finite, the
    last step twice the same bits (``check_context_training``), and a
    non-zero gradient on the ``tok_mixer`` router of every layer whose
    kind is in ``grad_kinds``. Returns (launches, recorded calls)."""
    import torch
    from repro_torch.core.policy import ElasticPolicy, ragged_bucket
    from repro_torch.data import LMDataPipeline
    pipe = LMDataPipeline(vocab=cfg.vocab_size, seq_len=S, global_batch=B,
                          seed=args.seed)
    batches = [{"tokens": torch.as_tensor(pipe.batch_at(i), device=dev)}
               for i in range(len(budgets))]
    kw = dict(n_heads=cfg.n_heads or None, n_experts=spec.mlp_n_experts)
    pols = []
    for b in budgets:
        # the bucket solved without the spec: with it a spec that routes
        # one token knob (Mamba2's) counts the other as full and gets the
        # identity bucket at any budget, in both packages (ROADMAP Queue
        # C); for uniform policies the spec-free bucket is the plan's
        p = ElasticPolicy.uniform(b, **kw).to(dev)
        pols.append((p, ragged_bucket(p, S)))
    print(f"{label} distillation: {cfg.name} width, depth {cfg.n_layers}, "
          f"B={B} S={S}, budget {budgets} [{device_line}]")
    with PathCalls() as rec:
        launches, leaves, grads = check_context_training(
            label, path, cfg, spec, params, rp, batches, pols, dev,
            device_line)
    layers = [i for i, k in enumerate(cfg.layer_kinds) if k in grad_kinds]
    g = nonzero_grad(label, leaves, grads,
                     [leaves["layers"][i]["tok_mixer"] for i in layers])
    print(f"  {label}: the tok_mixer routers of its {len(layers)} "
          f"{'/'.join(grad_kinds)} layers, gradient max |g| {g:.4e} "
          f"(non-zero): ok")
    return launches, rec, (leaves, grads, batches[-1], pols[-1])


def decode_timing(res, dev, label, c, row):
    """Times a path's recorded ring ``decode_attention`` call (its
    positions, t, validity and window) on random bf16 K/V of its shapes,
    L2-cold (rotating over K/V sets twice the L2 cache, as each layer's
    own ring is on the path), graphed and eager, beside the plain version,
    SDPA (enable_gqa, the same attendable keys) and its bound (the
    attended K/V rows). Kept under the kernel's ``modes`` key as
    ``row``."""
    import torch
    from repro_torch.kernels import ops
    med = lambda ts: ts[len(ts) // 2]
    B, _, H, Dh = c["q"][1]
    L, K = c["k"][1][1:3]
    q = torch.randn(c["q"][1], device=dev).to(torch.bfloat16)
    att = PathCalls.decode_mask(c)
    pos, tv, valid = c["kv_pos"], c["t"], c.get("kv_valid")
    window = c.get("window", 0)
    esz = q.element_size()
    n_sets = 1 + 2 * L2_BYTES // (B * L * K * Dh * esz * 2)
    ks = [torch.randn(c["k"][1], device=dev).to(torch.bfloat16)
          for _ in range(n_sets)]
    vs = [torch.randn(c["v"][1], device=dev).to(torch.bfloat16)
          for _ in range(n_sets)]
    dec = lambda backend: cycling(lambda i: ops.decode_attention(
        q, ks[i], vs[i], pos, tv, valid, window=window, backend=backend),
        n_sets)
    if not torch.equal(dec(None)(), dec(None)()) and n_sets == 1:
        fail(f"decode_attention {label}: a repeat gives other bits")
    n_att = int(att.sum())
    kern = device_and_eager_ms(dec(None), 50)
    plain = device_and_eager_ms(dec("ref"), 10)
    lib = sdpa_ms("decode_attention", q.transpose(1, 2), ks, vs,
                  att[:, None, None, :], 50)
    b, by = bound_ms(*cost("decode_attention", q, ks[0], vs[0], pos, tv,
                           valid, window=window))
    res.rows["decode_attention"].setdefault("modes", {})[row] = dict(
        shape=[B, L, H, K, Dh], window=window, attended=n_att,
        graphed_ms=med(kern[0]), ms=med(kern[1]),
        graphed_plain_ms=med(plain[0]), plain_ms=med(plain[1]),
        graphed_library_ms=med(lib[0]), library_ms=med(lib[1]),
        bound_ms=b, bound_by=by)
    print(f"  decode_attention  {label} bf16 {B} slots x L {L}, H {H} K {K} "
          f"Dh {Dh} window {window} ({n_att} attended keys; L2-cold over "
          f"{n_sets} K/V sets): kernel {med(kern[0]):.4f} ms graphed "
          f"[{kern[0][0]:.4f}-{kern[0][-1]:.4f}], {med(kern[1]):.4f} eager; "
          f"plain {med(plain[0]):.4f} / {med(plain[1]):.4f}; SDPA "
          f"{med(lib[0]):.4f} / {med(lib[1]):.4f}; bound {b:.4f} ms ({by})")
    del ks, vs


def mode_calls(res, dev, device_line, label, rec, rows):
    """A new family's recorded kernel calls held to the plain versions in
    bf16 and f32 (``check_path_calls``: the heaviest flash, decode and
    dense MLP call of each mode; a window's calls apart) and the new-mode
    calls ``rows`` names timed: flash and the dense MLP by
    ``context_timing``, decode by ``decode_timing``, under each kernel's
    ``modes`` key."""
    print(f"kernel calls of the {label} path (recorded from the eager twin "
          f"or the steps) [{device_line}]:")
    heaviest = check_path_calls(res, dev, label, rec)
    for key, row in rows.items():
        if key not in heaviest:
            fail(f"{label}: no {key} call was recorded")
        name = key.split()[0]
        if name == "decode_attention":
            decode_timing(res, dev, label, heaviest[key], row)
        else:
            context_timing(res, dev, label, name, heaviest[key], row,
                           group="modes")


def check_hybrid(args, res, dev, device_line):
    """(e) RecurrentGemma-2B at full width and depth (26 layers: 18 RG-LRU
    + 8 local-attention MQA layers, 10 q-heads on 1 kv-head at Dh 256,
    window 2048, geglu 7680, V 256000 tied), its registered spec (16
    moefied experts), the six requests on the ring (4 slots, max_seq
    1024), then 3 distillation steps (B=1, S=512, 1.0 -> 0.5)."""
    from repro_torch.configs import get_config
    arch = "recurrentgemma-2b"
    cfg = get_config(arch)
    spec = context_spec(arch)
    kinds = cfg.layer_kinds
    print(f"hybrid serving: {cfg.name} d={cfg.d_model} {kinds.count('rglru')} "
          f"rglru (lru {cfg.lru_width}) + {kinds.count('attn')} "
          f"attn (H={cfg.n_heads} K={cfg.n_kv_heads} Dh={cfg.d_head}, window "
          f"{max(cfg.window_pattern)}), F={cfg.d_ff} {cfg.act}, "
          f"V={cfg.vocab_size}, {cfg.dtype}, MLPs moefied into "
          f"{spec.mlp_n_experts} experts [{device_line}]")
    requests = family_requests(cfg, VLM_LENS, VLM_BUDGETS, FAM_NEW,
                               args.seed + 5)
    launches, params, rp, rec, _ = family_serving(
        args, dev, device_line, "hybrid", "hybrid_serving", cfg, spec,
        requests, 1024, HYBRID_TWIN_LAYERS,
        dense_spec=context_spec(arch, experts=False))
    mode_calls(res, dev, device_line, "hybrid serving", rec,
               {"flash_attention window": "1d_dh256",
                "decode_attention window": "5c_dh256"})
    check_moe_gmm(res, dev, "hybrid serving", rec.gmm_cases(),
                  moefied_weights(dev, cfg.d_model, cfg.d_ff,
                                  spec.mlp_n_experts), timed=False,
                  act=cfg.act)
    del rec
    tl, trec, _ = family_training(args, dev, device_line, "hybrid",
                                  "hybrid_training", cfg, spec, params, rp,
                                  1, 512, (1.0, 0.75, 0.5), ("rglru",))
    mode_calls(res, dev, device_line, "hybrid training", trec, {})
    return {"hybrid_serving": launches, "hybrid_training": tl}


def windowed_share(label, dev, device_line, calls, cfg, spec, params,
                   leaves, batch, pol):
    """The plain windowed gathered attention's share of a training step's
    device time: the step (loss and router gradients, CUDA events around
    it) beside the step's recorded ``windowed_gathered_attention`` calls
    replayed forward and backward on random operands of their shapes
    (each layer's forward runs twice under remat)."""
    import torch
    from repro_torch.models.attention import windowed_gathered_attention
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.training import make_loss_fn
    loss_fn = make_loss_fn(cfg, spec, remat=True)
    p, bucket = pol

    def step():
        loss, _ = loss_fn(leaves, params, batch, p, bucket)
        torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    step_ms = cuda_ms(step, 1, reps=3, warmup=1)
    fwd, bwd = 0.0, 0.0
    for q_s, k_s, pos, window, valid in calls:
        q = torch.randn(q_s, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.randn(k_s, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        v = torch.randn(k_s, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        run = lambda: windowed_gathered_attention(q, k, v, pos, window, True,
                                                  valid)
        f_ms = cuda_ms(run, 1, reps=3, warmup=1)
        out = run()
        g = torch.randn_like(out)
        fb_ms = cuda_ms(lambda: torch.autograd.grad(run(), (q, k, v), g), 1,
                        reps=3, warmup=1)
        fwd += f_ms[1]
        bwd += fb_ms[1] - f_ms[1]
    med = lambda ts: ts[len(ts) // 2]
    share = (2 * fwd + bwd) / med(step_ms)
    print(f"  {label}: a step {med(step_ms):.1f} ms on the device "
          f"[{step_ms[0]:.1f}-{step_ms[-1]:.1f}]; its {len(calls)} windowed "
          f"gathered attention calls (plain PyTorch) replayed: forward "
          f"{fwd:.1f} ms, backward {bwd:.1f} ms; under remat 2 x forward + "
          f"backward = {2 * fwd + bwd:.1f} ms, {100 * share:.1f} % of the "
          f"step [{device_line}]")
    return share


def gemma_f32_decode(params, cfg, dev, prompt, new_tokens, n_layers=6):
    """Gemma-3 in f32 at ``n_layers`` (a 5:1 period): the base-mode
    prefill of ``prompt`` then decode steps over ``new_tokens`` against a
    full-sequence forward(mode="base") at the same positions, within
    tests/test_models_smoke.py:84's atol 2e-3, rtol 1e-3 (the local rings
    of 1024 wrap: the prompt is longer)."""
    import dataclasses
    import torch
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.optim.optimizer import tree_map
    c32 = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   cut(params, n_layers))
    toks = torch.as_tensor(np.concatenate([prompt, new_tokens]),
                           device=dev)[None].long()
    S, P = toks.shape[1], len(prompt)
    with torch.no_grad():
        full, _ = forward(p32, None, {"tokens": toks}, c32, None, mode="base")
        lg, caches = prefill(p32, None, {"tokens": toks[:, :P]}, c32, None,
                             mode="base", max_cache_len=2048)
        errs = [float((lg - full[:, P - 1]).abs().max())]
        ok = bool(torch.allclose(lg, full[:, P - 1], atol=2e-3, rtol=1e-3))
        for t in range(P, S - 1):
            lg, caches = decode_step(p32, None, toks[:, t:t + 1], caches,
                                     torch.tensor([t], dtype=torch.int32,
                                                  device=dev), c32, None,
                                     mode="base")
            errs.append(float((lg - full[:, t]).abs().max()))
            ok &= bool(torch.allclose(lg, full[:, t], atol=2e-3, rtol=1e-3))
    ring = caches["layers"][0]["attn"]["pos"]
    print(f"  Gemma-3 f32, {n_layers} layers: base-mode prefill of {P} tokens "
          f"and {S - 1 - P} decode steps (local rings of {ring.shape[1]}, "
          f"positions {int(ring.min())}..{int(ring.max())}: wrapped) against "
          f"forward(mode='base'): max |diff| {max(errs):.3e} "
          f"(atol 2e-3 + rtol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("Gemma-3 f32: decode logits differ from the full forward")
    del p32, full, caches


def check_gemma(args, res, dev, device_line):
    """(f) Gemma-3-27B at full width, --gemma-layers deep (default 12: two
    5 local : 1 global periods; window 1024), the port's default spec,
    four requests of (1500, 700, 1100, 300) tokens and 64 new ones on the
    ring (max_seq 2048: the local rings of 1024 wrap in prefill and
    decode); f32 decode == forward at 6 layers; then 3 distillation steps
    (B=1, S=1536, 1.0 -> 0.6) whose local layers run the plain windowed
    gathered attention, its share of a step measured."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    arch = "gemma3-27b"
    full = get_config(arch)
    if args.gemma_layers % 6:
        fail("--gemma-layers must be a multiple of 6 (whole 5:1 periods)")
    cfg = dataclasses.replace(full, n_layers=args.gemma_layers)
    spec = context_spec(arch)
    print(f"windowed serving: {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
          f"K={cfg.n_kv_heads} Dh={cfg.d_head} F={cfg.d_ff} {cfg.act} "
          f"V={cfg.vocab_size} {cfg.dtype}, depth {cfg.n_layers} of "
          f"{full.n_layers}, windows {cfg.layer_windows[:6]} "
          f"[{device_line}]")
    requests = family_requests(cfg, GEMMA_LENS, GEMMA_BUDGETS, GEMMA_NEW,
                               args.seed + 6)
    launches, params, rp, rec, tokens = family_serving(
        args, dev, device_line, "Gemma-3", "windowed_serving", cfg, spec,
        requests, 2048, GEMMA_TWIN_LAYERS)
    mode_calls(res, dev, device_line, "Gemma-3 serving", rec,
               {"flash_attention window": "1e_window1024",
                "decode_attention window": "5d_window_ring"})
    del rec
    gemma_f32_decode(params, cfg, dev, requests[0][0],
                     np.asarray(tokens[0][:8], np.int32))
    torch.cuda.empty_cache()
    calls = []
    real = A.windowed_gathered_attention

    def rec_wga(q, k, v, positions, window, causal=True, kv_valid=None):
        calls.append((tuple(q.shape), tuple(k.shape), positions.detach(),
                      window, None if kv_valid is None
                      else kv_valid.detach()))
        return real(q, k, v, positions, window, causal, kv_valid)
    A.windowed_gathered_attention = rec_wga
    try:
        tl, trec, last = family_training(
            args, dev, device_line, "Gemma-3", "windowed_training", cfg,
            spec, params, rp, 1, 1536, (1.0, 0.8, 0.6), ("attn",))
    finally:
        A.windowed_gathered_attention = real
    n_local = sum(1 for w in cfg.layer_windows if w)
    per_step = [c for c in calls][-2 * n_local:]   # the last step's forward
    if not per_step:
        fail("Gemma-3 training: the windowed gathered attention never ran")
    leaves, _, batch, pol = last
    share = windowed_share("Gemma-3 training", dev, device_line,
                           per_step[:n_local], cfg, spec, params,
                           leaves, batch, pol)
    res.rows["flash_attention"].setdefault("modes", {})[
        "windowed_gathered_share"] = share
    mode_calls(res, dev, device_line, "Gemma-3 training", trec, {})
    return {"windowed_serving": launches, "windowed_training": tl}


def check_mamba(args, res, dev, device_line):
    """(g) Mamba2-780M at full width and depth (48 SSD layers, d 1536, 48
    heads of 64, state 128, chunk 256, V 50280 tied), its registered spec
    (the mixer's token router), the six requests on the ring, then 3
    distillation steps (B=2, S=512). Plain PyTorch end to end, as in the
    JAX package: the path launches no kernel."""
    from repro_torch.configs import get_config
    arch = "mamba2-780m"
    cfg = get_config(arch)
    spec = context_spec(arch)
    print(f"SSM serving: {cfg.name} d={cfg.d_model} {cfg.n_layers} SSD "
          f"layers ({cfg.n_ssm_heads} heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}), V={cfg.vocab_size} "
          f"{cfg.dtype} [{device_line}]")
    requests = family_requests(cfg, VLM_LENS, VLM_BUDGETS, FAM_NEW,
                               args.seed + 7)
    launches, params, rp, rec, _ = family_serving(
        args, dev, device_line, "Mamba2", "ssm_serving", cfg, spec,
        requests, 512, TWIN_LAYERS)
    if any(rec.calls.values()) or any(launches.values()):
        fail("Mamba2: a kernel launched on a path that has none")
    print("Mamba2: no kernel launched (plain SSD mixer, plain decode "
          "step): ok")
    tl, _, _ = family_training(args, dev, device_line, "Mamba2",
                               "ssm_training", cfg, spec, params, rp, 2, 512,
                               (1.0, 0.75, 0.5), ("ssm",))
    if any(tl.values()):
        fail("Mamba2 training: a kernel launched on a path that has none")
    return {"ssm_serving": launches, "ssm_training": tl}


def check_attention_only(args, res, dev, device_line):
    """(h) Granite-34B at 8 of 88 layers (48:1 MQA, ungated GELU,
    layernorm, qkv bias), Phi-3-medium-14B at 8 of 40 and Grok-1-314B at 2
    of 64 (8 experts of 32768, geglu, its registered expert routing), at
    full width: four requests each on the ring, staggered == solo;
    budget 1.0 == the teacher for Granite and Phi-3, reported for Grok.
    Granite's 48:1 flash and decode calls and its dense MLP, and Grok's
    expert calls, are replayed and timed."""
    import dataclasses
    from repro_torch.configs import get_config
    out = {}
    for arch, depth, path in (("granite-34b", 8, "granite_serving"),
                              ("phi3-medium-14b", 8, "phi3_serving"),
                              ("grok-1-314b", 2, "grok_serving")):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=depth)
        spec = context_spec(arch)
        moe = (f", {cfg.moe.n_experts} experts x {cfg.moe.d_expert} top-"
               f"{cfg.moe.top_k}" if cfg.moe else "")
        print(f"attention-only serving: {cfg.name} d={cfg.d_model} "
              f"H={cfg.n_heads} K={cfg.n_kv_heads} Dh={cfg.d_head} "
              f"F={cfg.d_ff} {cfg.act} {cfg.norm} qkv_bias={cfg.qkv_bias} "
              f"V={cfg.vocab_size}{moe}, depth {depth} of {full.n_layers} "
              f"[{device_line}]")
        requests = family_requests(cfg, VLM_LENS[:4], VLM_BUDGETS[:4],
                                   FAM_NEW, args.seed + 8)
        out[path], params, rp, rec, _ = family_serving(
            args, dev, device_line, cfg.name, path, cfg, spec, requests, 512,
            TWIN_LAYERS)
        del params, rp
        gc.collect()
        if arch == "granite-34b":
            mode_calls(res, dev, device_line, "Granite serving", rec,
                       {"flash_attention": "1f_mqa48",
                        "decode_attention": "5e_mqa48",
                        "fused_mlp": "2g_granite_gelu"})
        elif arch == "grok-1-314b":
            mode_calls(res, dev, device_line, "Grok-1 serving", rec, {})
            print(f"moe_gmm at the Grok-1 serving path's calls "
                  f"[{device_line}]:")
            check_moe_gmm(res, dev, "grok-1 serving (4g)", rec.gmm_cases(),
                          native_weights(dev, cfg), timed=False,
                          act=cfg.act)
        else:
            mode_calls(res, dev, device_line, "Phi-3 serving", rec, {})
        del rec
        gc.collect()
    return out

# -------------------------- depth routing, sampling ---------------------------

def depth_spec(spec):
    """The slice's spec with the depth router (per-token whole-layer skip)."""
    import dataclasses
    return dataclasses.replace(spec, depth_routed=True)


def with_depth_routers(rp, dev, d_model, seed):
    """The slice's routers with a fresh seeded depth router in each layer."""
    import torch
    from repro_torch.core import routing as R
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"layers": [dict(layer, depth=R.token_router_init(
        gen, d_model, device=dev)) for layer in rp["layers"]]}


def check_path_calls(res: Results, dev, label, rec: PathCalls):
    """Replays the heaviest ``flash_attention`` (causal and non-causal
    apart), ``decode_attention`` and ``fused_mlp`` call a path made with
    its recorded masks, positions and counts and random operands of its
    shapes, in bf16 and f32, against the plain version (within TOL); a
    query row or slot with no attendable key must give exact zeros.
    Returns the replayed calls (``PathCalls.heaviest``)."""
    import torch
    from repro_torch.kernels import ops
    heaviest = rec.heaviest()
    for key, c in sorted(heaviest.items()):
        name, what = key.split()[0], key[len(key.split()[0]):]
        work = PathCalls._work(name, c)
        for kind in ("bf16", "f32"):
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            rand = lambda key, scale=1.0: (
                torch.randn(c[key][1], device=dev) * scale).to(dt)
            args = {k: (rand(k) if isinstance(v, tuple) and v
                        and v[0] == "shape" else v) for k, v in c.items()}
            if name == "fused_mlp":         # weights at a 1/sqrt(fan-in) scale
                for k in ("wi", "wg", "wo"):
                    if isinstance(c.get(k), tuple):
                        args[k] = rand(k, c[k][1][0] ** -0.5)
            args.pop("backend", None)
            got = getattr(ops, name)(**args)
            want = getattr(ops, name)(**args, backend="ref")
            shape = tuple(c["q" if "q" in c else "x"][1])
            mode = "" if name == "fused_mlp" else (
                f" K {c['k'][1][2]} window {c.get('window', 0)}")
            unit = "rows" if name == "fused_mlp" else "pairs"
            res.compare(name, f"{kind} {label} path{what} {shape}{mode} "
                        f"({work} {unit})", got, want, kind)
            if name == "fused_mlp":
                continue
            if name == "flash_attention":
                dead = ~PathCalls.flash_mask(c).any(-1)
            else:
                dead = ~PathCalls.decode_mask(c).any(-1)
            if got[dead].count_nonzero() != 0:
                fail(f"{name}, the {label} path's heaviest call: a row with "
                     f"no attendable key is not zero")
            if kind == "bf16":
                print(f"  {name:17s} {label} path{what}: {int(dead.sum())} "
                      f"query row(s) with no attendable key, exact zeros")
    return heaviest


def serve_holes(engine, requests):
    """``serve(stagger=True)`` that also reads, as each request finishes,
    the (position, layer) pairs whose K/V it did not write (a token the
    depth or the attention token router skipped at that layer): the ring's
    ``valid`` row of its slot, or the ``pvalid`` lanes of its pages,
    over the prompt and every generated token but the last (never
    written). Returns (tokens, [(holes, pairs)] per request)."""
    import torch
    paged = engine.kv_layout == "paged"
    rows = {}
    if paged:                    # the table row as the slot frees it
        real_free = engine._free_slot_pages

        def free(slot):
            rows[slot] = engine._table[slot].copy()
            real_free(slot)
        engine._free_slot_pages = free
    holes = {}

    def read(handles):
        for i, h in enumerate(handles):
            if not h.done or i in holes:
                continue
            n = len(h.request.prompt) + len(h.output) - 1
            j = np.arange(n)
            miss = 0
            for layer in engine._caches["layers"]:
                a = layer["attn"]
                if paged:
                    pages = torch.as_tensor(
                        rows[h.slot][j // engine.page_size].astype(np.int64),
                        device=engine.device)
                    lanes = torch.as_tensor(j % engine.page_size,
                                            device=engine.device)
                    kept = a["pvalid"][pages, lanes]
                else:
                    if not bool((a["pos"][h.slot, :n].cpu().numpy()
                                 == j).all()):
                        fail("depth serving: a ring row's positions are "
                             "not its request's")
                    kept = a["valid"][h.slot, :n]
                miss += int((~kept).sum())
            holes[i] = (miss, n * len(engine._caches["layers"]))

    tokens = serve(engine, requests, stagger=True, after_step=read)
    if paged:
        del engine._free_slot_pages
    return tokens, [holes[i] for i in range(len(tokens))]


class DepthPromptSkips:
    """While active, records per budget below 1 the share of (prompt
    token, layer) pairs the depth router alone skips at the ring engine's
    infer prefills (one request's whole prompt each, told apart by its
    length), read from the router's logits against the threshold of the
    serving engine's policy for the request's budget (a budget-1.0 row
    keeps every token)."""

    def __init__(self, rp, cfg, spec, requests):
        from repro_torch.core import routing as R
        from repro_torch.core.policy import solve_budget
        self._R, self._ids = R, {id(layer["depth"]) for layer in rp["layers"]}
        self._budget = {len(p): b for p, _, b in requests if b < 1.0}
        self._thr = {b: R.threshold_logit(float(
            solve_budget(cfg, spec, b, static=True).theta))
            for b in set(self._budget.values())}
        self.seen = []

    def __enter__(self):
        real = self._real = self._R.token_logits

        def token_logits(r, x):
            lg = real(r, x)
            b = self._budget.get(x.shape[1]) if x.dim() == 3 else None
            if id(r) in self._ids and b is not None:
                self.seen.append((b, (lg <= self._thr[b]).float().mean()))
            return lg
        self._R.token_logits = token_logits
        return self

    def __exit__(self, *exc):
        self._R.token_logits = self._real

    def shares(self):
        return {b: float(sum(v for bb, v in self.seen if bb == b))
                / sum(bb == b for bb, _ in self.seen)
                for b in sorted(set(self._thr), reverse=True)}


def check_depth_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring, paged):
    """The slice's serving path with the depth router added (fresh seeded
    depth routers beside the slice's routers), on the Qwen2-7B weights
    already on the card, ring and paged: the six staggered requests,
    budget-1.0 rows against the mode="base" runs of the ring and paged
    phases, one request alone, the pool drained, the path's kernel calls
    replayed against their plain versions. Prints the KV holes and the
    depth router's own skip share per budget, and the rates beside the
    slice's. Returns (launches by path, the depth routers)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    dspec = depth_spec(spec)
    rp_d = with_depth_routers(rp, dev, cfg.d_model, args.seed + 4)
    budgets = sorted({b for _, _, b in requests}, reverse=True)
    launches = {}
    for layout, prior in (("ring", ring), ("paged", paged)):
        path = "depth_serving" if layout == "ring" else "depth_paged_serving"
        kw = dict(kv_layout="paged", page_size=PAGE_SIZE,
                  n_pages=args.pages) if layout == "paged" else {}
        mk = lambda n=cfg.n_layers, g=True: ServingEngine(
            cut(params, n), rp_d, dataclasses.replace(cfg, n_layers=n),
            dspec, mode="infer", batch_size=4, max_seq=1024, device=dev,
            cuda_graphs=g, **kw)
        engine = mk()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        skips = DepthPromptSkips(rp_d, cfg, dspec, requests) \
            if layout == "ring" else None
        with (skips or contextlib.nullcontext()):
            tokens, holes = serve_holes(engine, requests)   # the main path
            torch.cuda.synchronize()
        launches[path] = ops.launch_counts()
        rec = PathCalls()
        twins(f"depth {layout} infer, {twin_depth(cfg)} layers",
              lambda g: mk(twin_depth(cfg), g),
              lambda e: serve(e, requests, stagger=True), rec=rec)
        check_launches(path, launches[path])
        print(f"{path}: {cfg.name} depth {cfg.n_layers}, the slice's spec "
              f"and routers plus a depth router per layer [{device_line}]")
        print_timing(f"depth {layout} serving (first run)", engine.timing,
                     device_line)
        print_timing(f"{layout} serving without depth, same call (first "
                     f"run)", prior["timing"], device_line)
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"bad generated tokens {toks}")
        for i, (_, _, b) in enumerate(requests):
            if b == 1.0 and tokens[i] != prior["teacher"][i]:
                fail(f"depth {layout}: budget-1.0 request {i} differs from "
                     f"the mode='base' teacher")
        print(f"depth {layout}: budget 1.0 == mode='base' teacher, bit for "
              f"bit: ok")
        solo_i = 4
        solo_eng = mk()
        solo = serve(solo_eng, [requests[solo_i]], stagger=False)[0]
        if solo != tokens[solo_i]:
            fail(f"depth {layout}: request {solo_i} alone {solo} != "
                 f"staggered {tokens[solo_i]}")
        print(f"depth {layout}: staggered == solo (request {solo_i}, budget "
              f"{requests[solo_i][2]}): ok")
        if layout == "ring":
            print("depth router alone, share of (prompt token, layer) pairs "
                  "skipped at the staggered run's prefills, by budget: "
                  + ", ".join(f"{b}: {100 * v:.2f} %"
                              for b, v in skips.shares().items())
                  + "; 1.0: 0 (full budget keeps every token)")
            decode_turns({"ring": ServingEngine(
                params, rp, cfg, spec, mode="infer", batch_size=4,
                max_seq=1024, device=dev), "depth ring": mk()},
                (requests[0][0], 8, 0.75), device_line)
        if layout == "paged":
            for eng, what in ((engine, "staggered"), (solo_eng, "solo")):
                if eng.paged_stats()["allocated"] != 0:
                    fail(f"depth paged serving, {what} run: the pool did "
                         f"not drain")
            print("depth paged: the pool drained after both runs: ok")
        share = {b: sum(h for (h, _), (_, _, bb) in zip(holes, requests)
                        if bb == b) / sum(n for (_, n), (_, _, bb) in
                                          zip(holes, requests) if bb == b)
                 for b in budgets}
        print(f"depth {layout}: (token, layer) pairs that wrote no K/V, by "
              f"budget (depth or attention token router; ring valid / "
              f"paged pvalid): " + ", ".join(f"{b}: {100 * s:.2f} %"
                                             for b, s in share.items()))
        print(f"depth kernel calls of the {layout} path (recorded from the "
              f"{twin_depth(cfg)}-layer twin) [{device_line}]:")
        check_path_calls(res, dev, f"depth {layout}", rec)
        if layout == "paged":
            check_paged_calls(res, dev, rec.paged_cases(),
                              {4: "depth decode step",
                               PAGE_SIZE: "depth prefill chunk"})
        del rec, engine, solo_eng
    return launches, rp_d


# --------------------- SLO controller, fault tolerance ------------------------

CTRL_N = 24            # requests in the controller phase's trace
CTRL_TICK_S = 0.02     # the injected clock's tick per engine step
CTRL_RATE = 4.0        # base arrivals per second of the trace (burst 4x)
CTRL_FAIL_STEP = 60    # the fault drill's failing step


def controller_trace(vocab, seed):
    """The controller phase's trace: ``CTRL_N`` requests from
    ``launch/workloads.make_requests`` (prompts 64-512 tokens and 16-64 new
    tokens, both heavy-tailed; classes interactive 0.75 / batch 0.25;
    request seeds 0-23), arrival times from ``bursty_times`` (the middle
    40 % at 4x ``CTRL_RATE``), and the classes' SLO targets: interactive
    p95 TTFT and ITL, batch shed first and with a queue deadline."""
    from repro_torch.launch import workloads as W
    from repro_torch.runtime.controller import SLOTarget
    reqs = W.make_requests(
        CTRL_N, vocab, prompt_lo=64, prompt_hi=512, max_new_lo=16,
        max_new_hi=64, class_mix={"interactive": 0.75, "batch": 0.25},
        seed=seed)
    arrive = W.bursty_times(np.random.default_rng(seed), CTRL_RATE, CTRL_N,
                            burst_factor=4, burst_frac=0.4)
    targets = {"interactive": SLOTarget(p95_ttft_ms=200.0,
                                        p95_itl_ms=2.5e3 * CTRL_TICK_S),
               "batch": SLOTarget(shed_order=1, deadline_ms=400.0)}
    return reqs, arrive, targets


def make_controller(targets):
    """The phase's ``SLOController``: floor 0.25 in steps of 0.25, one
    evaluation every two ticks, restore after two healthy evaluations."""
    from repro_torch.runtime.controller import SLOController
    return SLOController(targets=targets, floor=0.25, step_down=0.25,
                         step_up=0.25, window=16, min_samples=2,
                         eval_interval_s=2 * CTRL_TICK_S, hysteresis=0.7,
                         patience=2, queue_factor=0.5, escalate_after=4,
                         sample_ttl_s=0.5)


def run_controlled(engine, reqs, arrive, clock=None):
    """``launch/workloads.replay`` of the trace on ``engine`` (with a
    controller; ``clock``: the ``StepClock(CTRL_TICK_S)`` it was built
    with, ticked once per step, or None for the wall clock). A ring engine
    gets no fallback shape and a paged one (1, 1), so an escalation is
    declined on both (the paged engine cannot reshard). Records per step
    whether the
    controller was degraded when it began, the decode wall time and steps
    it added to ``engine.timing``, its ``compile_counts()`` after it and
    the controller's event count. Returns (handles, elapsed, replay info,
    the records)."""
    from repro_torch.launch.workloads import replay
    real, ctrl, rows = engine.step, engine.controller, []

    def step():
        degraded = min(ctrl.admission_budget, ctrl.depth_budget,
                       ctrl.inflight_budget) < 1.0
        tm = engine.timing
        d0, n0 = tm["decode_s"], tm["decode_steps"]
        n = real()
        rows.append((degraded, tm["decode_s"] - d0, tm["decode_steps"] - n0,
                     engine.compile_counts(), len(ctrl.events)))
        return n
    engine.step = step
    try:
        handles, elapsed, info = replay(
            engine, reqs, arrive, clock=clock,
            fallback_shapes=[(1, 1)] if engine.kv_layout == "paged" else ())
    finally:
        del engine.step
    return handles, elapsed, info, rows


def check_terminal(label, handles):
    """Every request reached a terminal state: served (``done``), shed
    (``rejected`` with a Retry-After hint) or expired
    (``deadline_exceeded``); no shed or expired request was prefilled.
    Returns (served, shed, expired)."""
    served = [h for h in handles if h.status == "done"]
    shed = [h for h in handles if h.finish_reason == "rejected"]
    expired = [h for h in handles if h.finish_reason == "deadline_exceeded"]
    if len(served) + len(shed) + len(expired) != len(handles):
        fail(f"{label}: a request did not reach a terminal state: "
             f"{[(h.status, h.finish_reason) for h in handles]}")
    for h in shed + expired:
        if h.status != "rejected" or h.t_first is not None or h.output:
            fail(f"{label}: a {h.finish_reason} request was prefilled or is "
                 f"not typed rejected")
    if any(h.retry_after is None for h in shed):
        fail(f"{label}: a shed request has no Retry-After hint")
    return served, shed, expired


def check_ladder(label, engine, handles, info, rows):
    """The gates of a controlled run on the injected clock: the events
    reach degrade_admission, degrade_depth, degrade_inflight and shed in
    that order and restore after the shed; shed requests are rejected with
    a Retry-After hint and expired ones deadline_exceeded, none prefilled,
    as the engine counted them; the controller escalated and
    ``maybe_escalate`` declined (``run_controlled``); ``compile_counts()``
    after the first degrade is what it is at the end. Prints the counts,
    the events and the served share."""
    ctrl = engine.controller
    kinds = [k for _t, k, _v in ctrl.events]
    ladder = ("degrade_admission", "degrade_depth", "degrade_inflight",
              "shed")
    missing = [k for k in ladder if k not in kinds]
    if missing:
        fail(f"{label}: the controller never reached {missing}: {kinds}")
    first = [kinds.index(k) for k in ladder]
    if first != sorted(first):
        fail(f"{label}: stages out of ladder order: {kinds}")
    if not any(k.startswith("restore_") for k in kinds[first[-1]:]):
        fail(f"{label}: no restore after the shed: {kinds}")
    served, shed, expired = check_terminal(label, handles)
    if not expired:
        fail(f"{label}: no request expired in the queue")
    if (engine.n_rejected, engine.n_expired) != (len(shed), len(expired)):
        fail(f"{label}: n_rejected / n_expired {engine.n_rejected} / "
             f"{engine.n_expired} != {len(shed)} / {len(expired)}")
    if "escalate" not in kinds or info["escalations"] or \
            engine.remeshed_at is not None:
        fail(f"{label}: no escalation, or maybe_escalate re-meshed "
             f"({info['escalations']} escalations)")
    at_degrade = next(r[3] for r in rows if r[4] > 0)
    if engine.compile_counts() != at_degrade:
        fail(f"{label}: compile_counts {engine.compile_counts()} grew after "
             f"the first degrade ({at_degrade})")
    print(f"{label}: {len(served)} served, {len(shed)} shed (rejected, "
          f"Retry-After {sorted({h.retry_after for h in shed})} s), "
          f"{len(expired)} expired in the queue, none prefilled; "
          f"{info['steps']} steps, queue peak {info['queue_peak']}; "
          f"compile_counts {at_degrade} at the first degrade and at the "
          f"end: ok")
    print(f"{label}: events " + ", ".join(
        f"{k}{'' if k in ('escalate',) else f' {v:g}'}@{t:.2f}s"
        for t, k, v in ctrl.events))
    return served, shed, expired


SPLIT_MIN_STEPS = 10   # steps on each side before degraded_ms compares


def degraded_ms(label, rows, device_line):
    """Mean decode wall ms per step over the steps that began degraded and
    over the others (steps that built a form left out); no comparison
    unless each side has ``SPLIT_MIN_STEPS`` steps."""
    out = {}
    for deg in (False, True):
        ts = [r[1] for i, r in enumerate(rows) if r[0] == deg and r[2] == 1
              and (i == 0 or r[3] == rows[i - 1][3])]
        out[deg] = (1e3 * sum(ts) / len(ts), len(ts)) if ts else (0.0, 0)
    if min(out[True][1], out[False][1]) < SPLIT_MIN_STEPS:
        print(f"{label}: degraded/undegraded decode split not measured "
              f"({out[True][1]} degraded and {out[False][1]} undegraded "
              f"steps, fewer than {SPLIT_MIN_STEPS} on a side)")
        return
    print(f"{label}: decode {out[True][0]:.2f} ms/step over {out[True][1]} "
          f"degraded steps, {out[False][0]:.2f} ms/step over "
          f"{out[False][1]} undegraded ones (wall, engine.timing) "
          f"[{device_line}]")


def check_fault_drill(mk, reqs, device_line):
    """(c1): the trace's requests without a controller, all submitted at
    once, through ``serve_resilient`` with a failure injected at step
    ``CTRL_FAIL_STEP`` (fallback shapes (8, 1), refused until the mesh
    slice and skipped, then (1, 1): ``reshard(None)``) and a straggler
    watchdog, against a fault-free run of the same requests: one restart,
    every request finished with ``length`` or ``eos`` and its fault-free
    tokens, ``compile_counts()`` restarted at the re-mesh and flat after
    it. Returns the faulty run's launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.runtime import fault_tolerance as FT
    clean = mk()
    hs = [clean.submit(r) for r in reqs]
    FT.serve_resilient(clean)
    want = [h.output for h in hs]
    eng = mk()
    hs = [eng.submit(r) for r in reqs]
    at_reshard, real = [], eng.reshard

    def reshard(mesh):
        real(mesh)
        at_reshard.append(eng.compile_counts())
    eng.reshard = reshard
    wd = FT.StragglerWatchdog()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    steps, restarts = FT.serve_resilient(
        eng, fallback_shapes=[(8, 1), (1, 1)], max_restarts=1,
        injector=FT.FailureInjector(at_steps=(CTRL_FAIL_STEP,)),
        watchdog=wd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if restarts != 1:
        fail(f"fault drill: {restarts} restarts, want 1")
    if any(h.finish_reason not in ("length", "eos") for h in hs):
        fail(f"fault drill: a request was lost: "
             f"{[h.finish_reason for h in hs]}")
    if [h.output for h in hs] != want:
        fail("fault drill: tokens differ from the fault-free run")
    if at_reshard != [{"prefill": 0, "decode": 0}] or \
            eng.compile_counts() != {"prefill": 0, "decode": 1}:
        fail(f"fault drill: compile_counts {at_reshard} at the re-mesh, "
             f"{eng.compile_counts()} at the end")
    slow = ", ".join(f"{s}: {1e3 * dt:.1f} ms" for s, dt, _ in wd.flagged[:4])
    print(f"fault drill: failure at step {CTRL_FAIL_STEP} of {steps}, "
          f"{restarts} restart ((8, 1) skipped, re-meshed onto one device), "
          f"all {len(hs)} requests finished with their fault-free tokens, "
          f"compile_counts restarted at the re-mesh and "
          f"{eng.compile_counts()} at the end: ok; watchdog ewma "
          f"{1e3 * wd.ewma:.2f} ms, {len(wd.flagged)} step(s) flagged "
          f"({slow}); {wall:.1f} s [{device_line}]")
    return launches


def check_controller_serving(args, res, dev, device_line, spec, params,
                             rp_d):
    """The SLO controller, fault tolerance and the trace workloads on the
    serving engine: Qwen2-7B (``--layers`` deep, bf16) with the depth
    routers of the depth phase, the trace of ``controller_trace`` on an
    injected ``StepClock`` (a fixed tick per step) on the ring (a) and the
    paged pool (b), each graphed engine held to its ``cuda_graphs=False``
    twin at ``TWIN_LAYERS`` (trajectory, events, statuses, tokens, caches);
    the fault drill (c1); the ring trace on the wall clock (c2). Returns
    the launches by path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import workloads as W
    from repro_torch.training import ServingEngine
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    dspec = depth_spec(spec)
    reqs, arrive, targets = controller_trace(cfg.vocab_size, args.seed)
    print(f"controller trace: {len(reqs)} requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens, "
          f"{min(r.max_new_tokens for r in reqs)}-"
          f"{max(r.max_new_tokens for r in reqs)} new, classes "
          f"{sorted({r.slo_class for r in reqs})}, arrivals over "
          f"{arrive[-1]:.2f} s on a clock of {CTRL_TICK_S} s per step")

    def mk(n=cfg.n_layers, g=True, layout="ring", ctrl=True, clock=None):
        kw = dict(kv_layout="paged", page_size=PAGE_SIZE,
                  n_pages=args.pages) if layout == "paged" else {}
        return ServingEngine(
            cut(params, n), rp_d, dataclasses.replace(cfg, n_layers=n),
            dspec, mode="infer", batch_size=4, max_seq=1024, device=dev,
            cuda_graphs=g, controller=make_controller(targets) if ctrl
            else None, clock=clock, **kw)

    launches = {}
    for layout in ("ring", "paged"):
        path = ("controller_serving" if layout == "ring"
                else "controller_paged_serving")
        label = f"controller {layout} (injected clock)"
        clock = W.StepClock(CTRL_TICK_S)
        engine = mk(layout=layout, clock=clock)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles, _, info, rows = run_controlled(engine, reqs, arrive,
                                                clock)   # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = ops.launch_counts()
        check_launches(path, launches[path])
        check_ladder(f"{label}, {cfg.n_layers} layers", engine, handles,
                     info, rows)
        degraded_ms(f"{label}, {cfg.n_layers} layers", rows, device_line)
        tm = engine.timing
        n_adm = len(reqs) - engine.n_rejected - engine.n_expired
        print(f"{label}, {cfg.n_layers} layers: {wall:.1f} s of wall, "
              f"{tm['prefill_s']:.1f} s in {n_adm} admissions, "
              f"{tm['decode_s']:.1f} s in {tm['decode_steps']} decode steps "
              f"[{device_line}]")
        nt = twin_depth(cfg)
        rec = PathCalls()
        twin, outs = {}, {}
        for g in (True, False):     # the eager twin's kernel calls recorded
            clock = W.StepClock(CTRL_TICK_S)
            twin[g] = mk(nt, g, layout, clock=clock)
            with (contextlib.nullcontext() if g else rec):
                hs, _, _, _ = run_controlled(twin[g], reqs, arrive, clock)
            ctrl = twin[g].controller
            outs[g] = (ctrl.trajectory, ctrl.events,
                       [(h.status, h.finish_reason, h.output) for h in hs])
        if outs[True] != outs[False]:
            fail(f"{label}: the graphed {nt}-layer engine's trajectory, "
                 f"events, statuses or tokens differ from its "
                 f"cuda_graphs=False twin's")
        print(f"{label}, {nt} layers: graphed == cuda_graphs=False twin: "
              f"trajectory ({len(outs[True][0])} evaluations), events, "
              f"statuses: ok")
        check_twin(f"{label}, {nt} layers", twin[True], twin[False],
                   [h[2] for h in outs[True][2]],
                   [h[2] for h in outs[False][2]])
        print(f"{label}: controller {engine.controller.summary()}")
        print(f"controller kernel calls of the {layout} path (recorded from "
              f"the {nt}-layer twin) [{device_line}]:")
        check_path_calls(res, dev, f"controller {layout}", rec)
        if layout == "paged":
            check_paged_calls(res, dev, rec.paged_cases(),
                              {4: "controller decode step",
                               PAGE_SIZE: "controller prefill chunk"})
        del rec, engine, twin
        gc.collect()

    launches["controller_fault_drill"] = check_fault_drill(
        lambda: mk(ctrl=False), reqs, device_line)
    gc.collect()

    engine = mk()                                # (c2): the wall clock
    handles, elapsed, info, rows = run_controlled(engine, reqs, arrive)
    check_terminal("controller ring (wall clock)", handles)
    built = [r[3] for r in rows if r[3]["decode"]]
    if engine.compile_counts() != {"prefill": 0, "decode": 1} or any(
            c != engine.compile_counts() for c in built):
        fail(f"controller ring (wall clock): compile_counts not flat: "
             f"{built}")
    summ = W.summarize(handles, elapsed, targets)
    keys = ("attainment", "goodput_tok_s", "ttft_p50_ms", "ttft_p95_ms",
            "itl_mean_ms", "itl_p95_ms", "shed", "expired")
    print(f"controller ring (wall clock), {cfg.n_layers} layers: "
          f"{summ['served']} of {summ['n']} served in {elapsed:.2f} s, "
          + ", ".join(f"{k} {summ[k]:.4g}" if isinstance(summ[k], float)
                      else f"{k} {summ[k]}" for k in keys)
          + f"; compile_counts {engine.compile_counts()} throughout "
          f"[{device_line}]")
    print(f"controller ring (wall clock): controller "
          f"{engine.controller.summary()}")
    degraded_ms("controller ring (wall clock)", rows, device_line)
    print(f"controller serving phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def tensor_signature(obj):
    """Shapes and dtypes of every tensor in ``obj`` (tuples, lists, dicts
    and dataclasses such as the policy walked in order)."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return ((tuple(obj.shape), obj.dtype),)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    elif not isinstance(obj, (list, tuple)):
        return ()
    return tuple(x for o in obj for x in tensor_signature(o))


def check_sampled_serving(args, dev, device_line, spec, params, rp,
                          requests, ring):
    """The ring serving path with per-request sampling: the six requests of
    the serving phase (same prompts, budgets and stagger) with temperature
    0 on the first two and 0.7 / 1.0, top-k 0 / 40 and distinct seeds on
    the rest. Fails unless the temperature-0 rows give the greedy run's
    tokens, a sampled request alone gives its staggered tokens, every
    decode step (greedy-only and sampling) hands ``decode_step`` tensors
    of the same shapes and dtypes, the sampling steps hand
    ``sample_tokens`` (B,) settings, and, on the paged pool in f32 at 2
    layers, two sampled requests one of which is preempted give their
    uninterrupted runs' tokens. Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    from repro_torch.training import serve as serve_mod
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    knobs = [dict(), dict(), dict(temperature=0.7, top_k=40, seed=11),
             dict(temperature=1.0, seed=2 ** 32 - 1),
             dict(temperature=0.7, seed=7),
             dict(temperature=1.0, top_k=40, seed=123)]
    reqs = [r + (k,) for r, k in zip(requests, knobs)]
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), spec,
        mode="infer", batch_size=4, max_seq=1024, device=dev, cuda_graphs=g)
    engine = mk()
    steps = []     # per decode step: [decode_step's, sample_tokens' tensors]
    real_step, real_sample = serve_mod.decode_step, serve_mod.sample_tokens

    def step(*a, **kw):
        steps.append([tensor_signature((a, kw))])
        return real_step(*a, **kw)

    def sample(*a, **kw):
        if steps and len(steps[-1]) == 1:     # the decode step's own call
            steps[-1].append(tensor_signature((a, kw)))
        return real_sample(*a, **kw)

    @contextlib.contextmanager
    def recording():             # a replay calls neither: the eager twin
        serve_mod.decode_step, serve_mod.sample_tokens = step, sample
        try:
            yield
        finally:
            serve_mod.decode_step, serve_mod.sample_tokens = real_step, \
                real_sample

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, reqs, stagger=True)       # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("sampled_serving", launches)
    twins(f"sampled ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, reqs, stagger=True), rec=recording())
    print(f"sampled serving: {cfg.name} depth {cfg.n_layers}, the six "
          f"requests with {[k.get('temperature', 0.0) for k in knobs]} "
          f"temperatures, top-k {[k.get('top_k', 0) for k in knobs]} "
          f"[{device_line}]")
    print_timing("sampled ring serving (first run)", engine.timing,
                 device_line)
    for i, k in enumerate(knobs):
        if not k and tokens[i] != ring["tokens"][i]:
            fail(f"sampled serving: temperature-0 request {i} differs from "
                 f"the greedy run")
    sampled_differ = sum(tokens[i] != ring["tokens"][i]
                         for i, k in enumerate(knobs) if k)
    print(f"sampled serving: temperature-0 rows == the greedy run's tokens, "
          f"bit for bit: ok ({sampled_differ} of "
          f"{sum(1 for k in knobs if k)} sampled rows differ from greedy)")
    if sampled_differ == 0:
        fail("sampled serving: no sampled row differs from greedy")
    greedy = [st for st in steps if len(st[1]) == 1]
    sampled = [st for st in steps if len(st[1]) > 1]
    B = engine.B
    if not greedy or not sampled or len({st[0] for st in steps}) != 1 \
            or len({st[1] for st in sampled}) != 1 \
            or [sh for sh, _ in sampled[0][1][1:]] != [(B,)] * 4:
        fail(f"sampled serving: {len(greedy)} greedy-only and "
             f"{len(sampled)} sampling decode steps handed decode_step "
             f"{len({st[0] for st in steps})} tensor signature(s) and the "
             f"sampling ones handed sample_tokens "
             f"{len({st[1] for st in sampled})}, not one each with (B,) "
             f"settings")
    print(f"sampled serving ({twin_depth(cfg)}-layer twin): {len(greedy)} "
          f"greedy-only and {len(sampled)} "
          f"sampling decode steps handed decode_step tensors of the same "
          f"shapes and dtypes; the sampling ones handed sample_tokens "
          f"({B},) temperature, top-k, seed and position tensors, the "
          f"greedy-only ones the logits alone (a host branch): ok")
    solo_i = 4
    solo = serve(mk(), [reqs[solo_i]], stagger=False)[0]
    if solo != tokens[solo_i]:
        fail(f"sampled serving: request {solo_i} alone {solo} != staggered "
             f"{tokens[solo_i]}")
    print(f"sampled serving: staggered == solo (request {solo_i}, "
          f"temperature 0.7): ok")
    sampling_cost(dev, cfg.vocab_size, device_line)
    check_sampled_preemption(params, rp, spec, dev, args.seed)
    return launches


def sampling_cost(dev, vocab, device_line, B=4):
    """CUDA-event times of one ``sample_tokens`` call on (B, vocab) f32
    logits, every row sampling (top-k 40 on half of them) against the
    greedy argmax: graphed (the device's time) and back to back (with the
    host's cost of issuing each operation)."""
    import torch
    from repro_torch.training.serve import sample_tokens
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn(B, vocab, generator=gen, device=dev)
    temp = torch.full((B,), 0.7, device=dev)
    topk = torch.tensor([0, 40] * (B // 2), dtype=torch.int32, device=dev)
    seeds = torch.arange(B, dtype=torch.int64, device=dev)
    pos = torch.full((B,), 100, dtype=torch.int32, device=dev)
    med = lambda ts: f"{ts[len(ts) // 2]:.4f}"
    out = {}
    for name, fn in (("sampled", lambda: sample_tokens(
            logits, temp, topk, seeds, pos)), ("greedy", lambda: sample_tokens(
                logits))):
        graphed, eager = device_and_eager_ms(fn, 20)
        out[name] = f"{med(graphed)} ms graphed, {med(eager)} eager"
    print(f"sample_tokens on ({B}, {vocab}) f32 logits: sampling "
          f"{out['sampled']}; greedy argmax {out['greedy']} [{device_line}]")


def check_sampled_preemption(params, rp, spec, dev, seed, n_layers=2):
    """Two sampled 512-token requests on a paged pool one page short of
    both at full length (f32, Qwen2-7B width, ``n_layers`` layers: the
    resumed request's chunked re-prefill then rounds as the decode steps
    it replaces, so a difference is a fault of the stream, not bf16): at
    least one preemption, and each request gives the tokens of its
    uninterrupted run."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    rng = np.random.default_rng(seed + 5)
    reqs = [(rng.integers(0, cfg.vocab_size, 512).astype(np.int32), 16, 0.75,
             dict(temperature=0.8, top_k=40, seed=s)) for s in (21, 22)]
    need = -(-(512 + 16) // PAGE_SIZE)
    mk = lambda n_pages=None, g=True: ServingEngine(
        p32, r32, cfg, spec, mode="infer", batch_size=2, max_seq=1024,
        device=dev, kv_layout="paged", page_size=PAGE_SIZE, n_pages=n_pages,
        cuda_graphs=g)
    eng = mk(2 * need)                  # one page short, plus the trash page
    got = serve(eng, reqs, stagger=False)
    if eng.n_preempted < 1:
        fail("sampled preemption: none on the short pool")
    twin = mk(2 * need, False)
    check_twin(f"sampled preemption, f32, {n_layers} layers", eng, twin, got,
               serve(twin, reqs, stagger=False))
    alone = [serve(mk(), [r], stagger=False)[0] for r in reqs]
    if got != alone:
        fail(f"sampled preemption: {got} != uninterrupted {alone}")
    print(f"sampled preemption: f32, {n_layers} layers, {2 * need}-page "
          f"pool, {eng.n_preempted} preemption(s): each request == its "
          f"uninterrupted run, bit for bit: ok")


def device_ms(fn) -> tuple:
    """(wall ms, kernel ms on the device) of ``fn()`` under torch.profiler,
    device activity only; the wall from the call to the device's end,
    without the profiler's start and stop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3


def depth_training_grid(step_fn, state, params, batch, cfg, spec, dev,
                        device_line, S, grid=((1.0, 1.0), (0.75, 1.0),
                                              (0.5, 1.0), (0.5, 0.5))):
    """The depth spec's training step (``launch.train``'s step function) at
    (depth, token) budgets set directly, each timed after one warm-up step:
    the wall time with the teacher's and student's parts and the ragged
    bucket; then one more step of the last budget under torch.profiler
    (device activity) for its device time (the step is host-bound, so the
    wall hides what the bucket saves)."""
    import torch
    from repro_torch.core.policy import ElasticPolicy, ragged_bucket
    print(f"depth training grid, {cfg.name} width, depth {cfg.n_layers}, "
          f"B={batch['tokens'].shape[0]} S={S} [{device_line}]:")
    for depth, token in grid:
        pol = ElasticPolicy.uniform(token, n_heads=cfg.n_heads).replace(
            depth_capacity=depth).to(dev)
        bucket = ragged_bucket(pol, S, spec=spec)
        timing, out = {}, {}
        run = lambda: out.update(step_fn(state, params, batch, pol, bucket,
                                         timing=timing)[1])
        run()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        loss = float(out["loss"])
        if not np.isfinite(loss):
            fail(f"depth grid ({depth}, {token}): loss {loss}")
        print(f"  (depth, token) = ({depth}, {token}) bucket {bucket}: step "
              f"{wall:.1f} ms (teacher {timing['teacher_s'] * 1e3:.1f}, "
              f"student fwd+bwd+update {timing['student_s'] * 1e3:.1f}); "
              f"loss {loss:.6f}, sel_rate {float(out['sel_rate']):.4f}")
    wall, dev_ms = device_ms(run)
    print(f"  ({depth}, {token}) once more under torch.profiler (device "
          f"activity): {wall:.1f} ms wall, {dev_ms:.1f} ms of it on the "
          f"device ({100 * dev_ms / wall:.1f} % busy)")


def print_ptxas(build, sources=None, tag=""):
    """ptxas's registers and spills per instantiation, from the build log."""
    for name, log in build.BUILD_LOG.items():
        if sources is not None and name not in sources:
            continue
        fn = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "registers" in line or "spill" in line:
                print(f"  {tag}ptxas {name} {fn}: {line.strip()}")


def sass_hgmma(build, lib, pattern, name_of) -> dict:
    """HGMMA (tensor-core) instruction count per kernel function of the
    built library ``lib`` whose mangled name matches ``pattern``
    (cuobjdump -sass, or the copy in Triton's package where the toolkit
    lacks it); ``name_of(match)`` names it."""
    import re
    import shutil
    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        tools.append(str(Path(triton.__file__).parent / "backends" /
                         "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and Path(t).exists()), None)
    if tool is None:
        fail("no cuobjdump to count the kernels' HGMMA instructions")
    path = build.BUILD_ROOT / build.source_hash() / f"lib{lib}.so"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            fn = None if m is None else name_of(m)
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def print_hgmma(build) -> None:
    """Counts the HGMMA instructions of every flash_fwd instantiation and
    of the MLP library's tensor-core up and down phases (mlp_tc, one code
    for the dense, routed and grouped-expert modes); fails unless the bf16
    Dh=128 flash kernel and every mlp_tc instantiation have some."""
    flash = sass_hgmma(
        build, "flash_attention", r"(flash_fwd_\w+?)I(\w*?)L?i(\d+)E",
        lambda m: (f"{m.group(1)}<"
                   f"{'bf16, ' if 'bfloat16' in m.group(2) else ''}"
                   f"{'f32, ' if m.group(2).endswith('f') else ''}"
                   f"{m.group(3)}>"))
    print(f"  SASS HGMMA instructions per flash_fwd instantiation: {flash}")
    if not flash.get("flash_fwd_wgmma<128>"):
        fail("the bf16 Dh=128 flash kernel has no HGMMA instruction")
    mlp = sass_hgmma(
        build, "fused_mlp", r"mlp_tcILb(\d)ELi(\d)ELb(\d)E",
        lambda m: (f"mlp_tc<{'up' if m.group(1) == '1' else 'down'}, "
                   f"{64 * int(m.group(2))} rows"
                   f"{', int8 weights' if m.group(3) == '1' else ''}>"))
    print(f"  SASS HGMMA instructions per fused_mlp tensor-core phase (all "
          f"three modes; bf16 and int8 weights): {mlp}")
    if len(mlp) != 8 or not all(mlp.values()):
        fail("a tensor-core MLP phase (up / down, 64 or 128 rows, bf16 or "
             "int8 weights) has no HGMMA instruction")


AB_KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention",
              "fused_mlp", "fused_mlp_routed", "moe_gmm")
# outputs that must be bit-identical between the two trees (kernels and
# modes this change leaves as they were, and the greedy serving path), by
# ab_turn's case prefix
AB_SAME = ("flash", "ring", "paged", "fused_mlp", "fused_mlp_routed",
           "moe_gmm", "decode")
# timed cases of a kernel the change redesigned (none: this change
# redesigned no kernel)
AB_FASTER = ()


def slice_spec():
    """The slice's elastic spec: token routing of attention and the MLP,
    head top-k, LoRA rank 1."""
    from repro_torch.core.policy import ElasticSpec
    return ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)


def ab_decode(dev, layers, reps=2):
    """``--ab``'s serving turn: item 3's six staggered requests, seed 0,
    greedy, through a ring and a paged infer engine and a ring mode="base"
    engine of the tree on the path (Qwen2-7B width, ``layers`` deep, the
    slice's spec; each tree's default engine: a tree whose engine captures
    CUDA graphs runs graphed, an older one eagerly), each served once cold
    and ``reps`` times warm. Returns each engine's tokens (one (6, 16)
    tensor, equal across its warm runs) and its warm decode ms/step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=layers)
    spec = slice_spec()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 16, b)
                for n, b in zip([64, 512, 200, 333, 128, 450],
                                [1.0, 0.75, 0.5, 1.0, 0.5, 0.75])]
    outs, ms = {}, {}
    for name, mode, kw in (
            ("ring infer", "infer", {}),
            ("paged infer", "infer", dict(kv_layout="paged",
                                          page_size=PAGE_SIZE)),
            ("ring base", "base", {})):
        eng = ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=4,
                            max_seq=1024, device=dev, **kw)
        tokens = serve(eng, requests, stagger=True)          # cold
        warm = []
        for _ in range(reps):
            eng.timing.update(decode_s=0.0, decode_steps=0)
            if serve(eng, requests, stagger=True) != tokens:
                fail(f"--ab decode {name}: a warm run's tokens differ")
            warm.append(eng.timing["decode_s"] * 1e3
                        / eng.timing["decode_steps"])
        outs[f"decode {name} tokens"] = torch.tensor(tokens)
        ms[name] = warm
        print(f"--ab decode {name}: " + (
            f"graphed, compile_counts {eng.compile_counts()}"
            if getattr(eng, "cuda_graphs", False) else "eager"))
        del eng
    return outs, ms


def ab_turn(tree: Path, out: Path, layers: int) -> None:
    """One turn of ``--ab``: ``check_flash``, ``check_decode`` (ring, no
    split edges), ``check_paged_decode``, ``check_fused_mlp``,
    ``check_fused_mlp_routed`` and ``check_moe_gmm`` (a moefied Qwen2-7B
    call, 8 experts, ragged counts) on the kernels of the checkout at
    ``tree`` (its ``src`` first on the path, its kernels built into its
    own tree), inputs drawn from seed 0, each held to its plain version
    under ``TOL``, then ``ab_decode`` on its serving engines; saves the
    outputs, each kernel's timed-case medians and the warm decode ms/step
    to ``out``."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    build.build()
    print_ptxas(build, None, f"{tree}: ")
    cfg = get_config("qwen2-7b")
    D, Fd = cfg.d_model, cfg.d_ff
    torch.manual_seed(0)
    rng, dev, res = np.random.default_rng(0), torch.device("cuda"), Results()
    counts = np.array([[512, 301, 0, 77, 512, 450, 128, 1]])
    outs = {}
    for name, fn in (("flash", lambda: check_flash(res, rng, dev, 28, 4,
                                                   128)),
                     ("ring", lambda: check_decode(res, rng, dev, 28, 4, 128,
                                                   1024, edges=False)),
                     ("paged", lambda: check_paged_decode(
                         res, rng, dev, 28, 4, 128, 1024)),
                     ("fused_mlp", lambda: check_fused_mlp(res, dev, D, Fd)),
                     ("fused_mlp_routed", lambda: check_fused_mlp_routed(
                         res, rng, dev, D, Fd)),
                     ("moe_gmm", lambda: check_moe_gmm(
                         res, dev, "moefied", [((1, 8, 512, D), counts)],
                         moefied_weights(dev, D, Fd, 8), timed=True))):
        outs.update({f"{name} {k}": o.cpu() for k, o in fn().items()})
    dec_outs, dec_ms = ab_decode(dev, layers)
    outs.update(dec_outs)
    ms = {}
    for n in AB_KERNELS:
        row = res.rows[n]
        ms[(n, None)] = (row.get("graphed_ms"), row["ms"])
        for label, case in row.get("cases", {}).items():
            ms[(n, label)] = (None, case["ms"])
    torch.save({"outs": outs, "ms": ms, "decode_ms": dec_ms}, out)


def kernel_ab(parent: Path, layers: int) -> int:
    """``--ab PARENT``: the six kernels and the greedy serving engines of
    the checkout at PARENT (p) and of this one (c) in turns p c c p, each
    turn a process of its own (``ab_turn``) on the same seeded inputs at
    Qwen2-7B widths, each turn within ``TOL`` of the plain version. Prints
    each kernel's timed medians per turn (graphed and eager for attention,
    eager for the MLP kernels, whose calls are far above the host's cost
    of issuing them), each engine's warm decode ms/step per turn, and
    whether the change was faster than the parent in every turn at the
    cases it redesigned (``AB_FASTER``); fails unless each tree's outputs
    are equal bit for bit across its own two turns, and unless the kernels
    and paths of ``AB_SAME`` give the same bits in both trees."""
    import shutil
    import tempfile
    import torch
    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    turns = [("p", parent), ("c", ROOT), ("c", ROOT), ("p", parent)]
    try:
        got = []
        for i, (_, tree) in enumerate(turns):
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--ab-turn", str(tree), str(tmp / f"{i}.pt"),
                            "--layers", str(layers)],
                           check=True)
            got.append(torch.load(tmp / f"{i}.pt"))
    finally:
        shutil.rmtree(tmp)
    ok = True
    for tree, (i, j) in (("p", (0, 3)), ("c", (1, 2))):
        same = all(torch.equal(got[i]["outs"][k], got[j]["outs"][k])
                   for k in got[i]["outs"])
        ok = ok and same
        print(f"--ab {tree} ({parent if tree == 'p' else ROOT}): outputs "
              f"bit for bit equal in its two turns: {same}")
    for prefix in AB_SAME:
        keys = [k for k in got[0]["outs"] if k.startswith(prefix + " ")]
        same = bool(keys) and all(
            torch.equal(got[0]["outs"][k], got[1]["outs"][k]) for k in keys)
        ok = ok and same
        print(f"--ab {prefix}: {len(keys)} outputs bit for bit equal between "
              f"the parent and the change: {same}")
    for key in got[0]["ms"]:
        n, label = key
        for i, form in enumerate(("graphed", "eager")):
            if got[0]["ms"][key][i] is None:
                continue
            ms = " / ".join(f"{t} {g['ms'][key][i]:.4f}"
                            for (t, _), g in zip(turns, got))
            print(f"--ab {n}{'' if label is None else ' ' + label}, turns "
                  f"p c c p, timed-case median ms, {form}: {ms}")
    for name in got[0]["decode_ms"]:
        ms = " / ".join(f"{t} " + ", ".join(
            f"{v:.2f}" for v in g["decode_ms"][name])
            for (t, _), g in zip(turns, got))
        print(f"--ab decode {name}, six staggered requests, {layers} "
              f"layers, turns p c c p, warm ms/step per run: {ms}")
    for key in AB_FASTER:
        t = [g["ms"][key][1] for g in got]
        print(f"--ab {key[0]}{'' if key[1] is None else ' ' + key[1]}: the "
              f"change faster than the parent in every turn: "
              f"{max(t[1], t[2]) < min(t[0], t[3])}")
    return 0 if ok else 1


# ----------------------- (i) analysis and accounting -------------------------

# PERF.md §6's kernel bounds (ms, as printed there) by their row and
# their place in the result line's rows (an fnmatch pattern over the key
# path joined by " / "): every one must come out of ``ops.kernel_cost``
# again, to the four decimals printed
PERF_BOUNDS = {
    "1": ("flash_attention", 0.0024),
    "1b": ("flash_attention / context / 1b_vlm_cross", 0.0056),
    "1c": ("flash_attention / context / 1c_whisper_encoder", 0.0093),
    "1d": ("flash_attention / modes / 1d_dh256", 0.0010),
    "1e": ("flash_attention / modes / 1e_window1024", 0.0168),
    "1f": ("flash_attention / modes / 1f_mqa48", 0.0022),
    "2": ("fused_mlp", 0.2109),
    "2b": ("fused_mlp / cases / chunk", 0.1217),
    "2c": ("fused_mlp / cases / train", 0.4218),
    "2d": ("fused_mlp / int8 / prefill (1, 512)", 0.2109),
    "2e": ("fused_mlp / int8 / chunk (1, 16)", 0.0609),
    "2f": ("fused_mlp / context / 2f_whisper_gelu", 0.0254),
    "2g": ("fused_mlp / modes / 2g_granite_gelu", 0.1832),
    "3": ("fused_mlp_routed", 0.1878),
    "3b": ("fused_mlp_routed / int8 / train admission (1, 512) Kb=384",
           0.1553),
    "4": ("moe_gmm", 0.1845),
    "4b": ("moe_gmm / cases / moefied qwen2-7b training", 0.4218),
    "4c": ("moe_gmm / cases / native qwen1.5-moe serving", 0.3687),
    "4d": ("moe_gmm / int8 / native int8 (1, 60, 512, 2048)", 0.3045),
    "4e": ("moe_gmm / cases / native qwen1.5-moe training", 1.0748),
    "4f": ("moe_gmm / cases / VLM serving", 0.1257),
    "4g": ("moe_gmm / cases / grok-1 serving (4g)", 2.9001),
    "4h": ("moe_gmm / cases / hybrid serving", 0.0448),
    "5": ("decode_attention", 0.0012),
    "5b": ("decode_attention / int8 / ring (5, 1024)", 0.0004),
    "5c": ("decode_attention / modes / 5c_dh256", 0.0002),
    "5d": ("decode_attention / modes / 5d_window_ring", 0.0058),
    "5e": ("decode_attention / modes / 5e_mqa48", 0.0001),
    "6": ("paged_decode_attention", 0.0007),
    "6b": ("paged_decode_attention / int8 / decode (4, 64x16)", 0.0004),
    "6c": ("paged_decode_attention / int8 / path prefill chunk (heaviest "
           "of *)", 0.0002),
}


def run_passes(label, bundle, device_line) -> list:
    """``repro_torch.analysis.run_all`` over ``bundle``'s entry points and
    kernels on the card: prints every finding and every waived one with
    its reason, fails on an unwaived error. Returns the kernel calls the
    entry points recorded."""
    from repro_torch.analysis import run_all
    from repro_torch.kernels.ops import KernelCall
    t0 = time.perf_counter()
    report = run_all(bundle)
    eng = bundle.engine
    print(f"analysis, {label}: {bundle.cfg.name}, {bundle.cfg.n_layers} "
          f"layers, {bundle.cfg.dtype}, KV {eng.kv_dtype}, weights "
          f"{eng.weight_dtype}, entries {sorted(bundle.entries())}: "
          f"{time.perf_counter() - t0:.1f} s [{device_line}]")
    for name in sorted(bundle.entries()):
        recs = bundle.trace(name).records
        n_k = sum(isinstance(r, KernelCall) for r in recs)
        print(f"  {name}: {len(recs) - n_k} aten operations, {n_k} kernel "
              f"calls per call")
    print("  " + report.table().replace("\n", "\n  "))
    if not report.ok:
        fail(f"analysis, {label}: {len(report.errors)} unwaived error(s)")
    return [r for name in bundle.entries()
            for r in bundle.trace(name).records if isinstance(r, KernelCall)]


def recorded_args(c, dev) -> dict:
    """A ``PathCalls`` record's arguments, each recorded shape an empty
    tensor of its dtype on the card (a launch's geometry reads shapes,
    dtypes and the recorded masks and counts, never the operands)."""
    import torch
    return {k: (torch.empty(v[1], dtype=v[2], device=dev)
                if isinstance(v, tuple) and v[:1] == ("shape",) else v)
            for k, v in c.items()}


def check_geometry(calls, device_line):
    """Every (kernel name, arguments) of ``calls`` (an iterable, consumed
    one call at a time): the Python statement of its launches
    (``ops.launch_geometry``) must equal what its C launcher reports
    (``ops.c_geometry``: the launcher's host code, stopped before the
    launch). Fails on the first difference."""
    from repro_torch.kernels import ops
    by, seen = {}, set()
    for name, a in calls:
        sig = (name,) + tuple((k, (tuple(v.shape), v.dtype, v.stride()))
                              if hasattr(v, "stride") else (k, repr(v))
                              for k, v in a.items())
        if sig in seen:
            continue
        seen.add(sig)
        py = [(l["grid"], l["block"], l["smem"])
              for l in ops.launch_geometry(name, **a)["launches"]]
        c = ops.c_geometry(name, **a)
        if py != c:
            fail(f"{name} launch geometry: Python {py} != launcher {c} "
                 f"(arguments {[(k, tuple(v.shape) if hasattr(v, 'shape') else v) for k, v in a.items()]})")
        by[name] = by.get(name, 0) + 1
    print(f"launch geometry, Python statement == C launcher for every "
          f"recorded call signature: {by} [{device_line}]")


def check_accounting(args, dev, device_line) -> dict:
    """Qwen2-7B at all 28 layers (random weights from --seed): the decode
    step of four slots (counted on its eager twin: a graph replay calls no
    wrapper and no aten operation; timed graphed, device ms a step under
    the profiler) and one training step of 2 x 512 tokens at budget 0.5
    (counted and timed, device ms), each as FLOPs and bytes
    (``hloprof.count_step``) and as shares of the card's peaks
    (``step_shares``). Fails if a share passes 1.0 (a count is wrong)."""
    import torch
    from repro_torch.analysis.framework import clone_tensors
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.hloprof import count_step, step_shares
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg, spec = get_config("qwen2-7b"), slice_spec()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    eng = ServingEngine(params, rp, cfg, spec, mode="infer", batch_size=4,
                        max_seq=1024, device=dev)
    rng = np.random.default_rng(args.seed)
    for n, b in zip((64, 512, 200, 333), (1.0, 0.75, 0.5, 1.0)):
        eng.submit(GenRequest(rng.integers(0, cfg.vocab_size, n).astype(
            np.int32), 64, budget=b))
    eng.step()                       # admissions; the greedy form captured
    eng.step()
    a = list(eng._decode_args(False))
    a[2], a[3] = a[2].clone(), clone_tensors(a[3])
    with torch.no_grad():
        dec = count_step(eng._decode_fn, *a)
    del a
    n_steps = 10
    _, dms = device_ms(lambda: [eng.step() for _ in range(n_steps)])
    dec_ms = dms / n_steps
    out = {}
    sh = step_shares(dec["flops_by"], dec["bytes"], dec_ms)
    out.update(decode_mfu=sh["mfu"], decode_hbm_share=sh["hbm_share"],
               decode_flops=dec["flops"], decode_bytes=dec["bytes"],
               decode_device_ms=dec_ms, decode_ops=dec["ops"],
               decode_kernel_calls=dec["kernel_calls"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    S, B = 512, 2
    cfg_t, ecfg, params, state, step_fn, pipe = T.build_trainer(
        "qwen2-7b", lr=1e-4, total_steps=4, seq_len=S, global_batch=B,
        seed=args.seed, ecfg=spec, device=dev, n_layers=cfg.n_layers,
        params=params, routers=rp)
    pol, bucket = T.policy_schedule(cfg_t, ecfg, seq_len=S, total_steps=4,
                                    device=dev, budget=0.5, anneal_from=1.0,
                                    anneal_steps=3)(3)
    batch = {"tokens": torch.as_tensor(pipe.batch_at(0), device=dev)}
    run = lambda: step_fn(state, params, batch, pol, bucket)
    run()                            # warm-up
    tr = count_step(run)
    _, tr_ms = device_ms(run)
    sh = step_shares(tr["flops_by"], tr["bytes"], tr_ms)
    out.update(train_mfu=sh["mfu"], train_hbm_share=sh["hbm_share"],
               train_flops=tr["flops"], train_bytes=tr["bytes"],
               train_device_ms=tr_ms, train_ops=tr["ops"],
               train_kernel_calls=tr["kernel_calls"], train_bucket=bucket)
    print(f"accounting, {cfg.name} at {cfg.n_layers} layers [{device_line}]:"
          f" decode (4 slots) {dec['flops'] / 1e9:.2f} GFLOP "
          f"{dict((k, round(v / 1e9, 3)) for k, v in dec['flops_by'].items())}"
          f", {dec['bytes'] / 1e9:.3f} GB moved, {dec['ops']} aten ops + "
          f"{dec['kernel_calls']} kernel calls, graphed {dec_ms:.3f} device "
          f"ms/step: MFU {out['decode_mfu']:.4f}, HBM share "
          f"{out['decode_hbm_share']:.4f}; training step (2 x 512, bucket "
          f"{bucket}) {tr['flops'] / 1e12:.3f} TFLOP "
          f"{dict((k, round(v / 1e12, 3)) for k, v in tr['flops_by'].items())}"
          f", {tr['bytes'] / 1e9:.2f} GB moved, {tr['ops']} aten ops + "
          f"{tr['kernel_calls']} kernel calls, {tr_ms:.1f} device ms: MFU "
          f"{out['train_mfu']:.4f}, HBM share {out['train_hbm_share']:.4f}")
    for k in ("decode_mfu", "decode_hbm_share", "train_mfu",
              "train_hbm_share"):
        if not 0.0 < out[k] <= 1.0:
            fail(f"accounting: {k} {out[k]:.4f} is outside (0, 1]: a count "
                 f"is wrong")
    return out


def flat_bounds(rows, prefix=()) -> dict:
    """Every ``bound_ms`` of the result line's rows by its key path."""
    out = {}
    for k, v in rows.items():
        if isinstance(v, dict):
            if "bound_ms" in v:
                out[prefix + (k,)] = v["bound_ms"]
            out.update(flat_bounds(v, prefix + (k,)))
    return out


def check_bounds(res, device_line):
    """Prints every kernel case's bound (from ``ops.kernel_cost``) and
    fails unless each of PERF.md §6's rows (``PERF_BOUNDS``) matches one
    case whose bound is as printed there, to four decimals."""
    import fnmatch
    got = {" / ".join(p): b for p, b in flat_bounds(res.rows).items()}
    rows = {key: row for row, (pat, _) in PERF_BOUNDS.items()
            for key in got if fnmatch.fnmatchcase(key, pat)}
    bad = []
    for key, b in sorted(got.items()):
        row = rows.get(key)
        want = None if row is None else PERF_BOUNDS[row][1]
        same = want is None or f"{b:.4f}" == f"{want:.4f}"
        bad += [] if same else [f"row {row}: {b:.4f} != {want:.4f}"]
        print(f"  bound {key}: {b:.6f} ms" + (
            "" if row is None else f" (PERF.md row {row} {want:.4f}: "
            f"{'same' if same else 'DIFFERS'})"))
    missing = sorted(set(PERF_BOUNDS) - set(rows.values()))
    if bad or missing:
        fail(f"kernel bounds: {bad} differ from PERF.md; rows {missing} "
             f"not computed")
    print(f"kernel bounds from ops.kernel_cost: {len(got)} cases, every "
          f"one of PERF.md §6's {len(PERF_BOUNDS)} rows as printed there "
          f"[{device_line}]")


def check_analysis(args, res, dev, device_line) -> dict:
    """(i) The analysis passes on the card (the toy bundle, then Qwen2-7B's
    ring and paged entry points at ``TWIN_LAYERS`` in bf16 and with int8
    weights and K/V), every recorded kernel call's launch geometry against
    its launcher, the whole-step accounting at 28 layers, and the kernel
    bounds against PERF.md. Returns the accounting line's numbers."""
    import torch
    from repro_torch.analysis import build_bundle
    calls = []
    toy = build_bundle(device=dev, seed=args.seed)
    calls += run_passes("toy bundle", toy, device_line)
    del toy
    spec = depth_spec(slice_spec())
    for kv, w in (("fp32", "fp32"), ("int8", "int8")):
        b = build_bundle(device=dev, arch="qwen2-7b", variant="full",
                         n_layers=TWIN_LAYERS, dtype=None, spec=spec,
                         kv_dtype=kv, weight_dtype=w, seed=args.seed)
        calls += run_passes(f"qwen2-7b, KV {kv}, weights {w}", b,
                            device_line)
        del b
        gc.collect()
        torch.cuda.empty_cache()
    # one recorded path call's arguments at a time: together they would
    # not fit on the card
    check_geometry(itertools.chain(
        ((c.name, c.args) for c in calls),
        ((name, recorded_args(c, dev))
         for name, c in PathCalls.signatures.values())), device_line)
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    acc = check_accounting(args, dev, device_line)
    check_bounds(res, device_line)
    return acc


# ----------------------- (j) tensor-parallel serving -------------------------

TP_RANKS = 2            # the (data=1, model=2) mesh of phase (j)
TP_LABEL = "2 ranks sharing one H100, gloo"
TP_F32_LAYERS = 2
TP_SIG_BUDGETS = (1.0, 0.75, 0.5)   # one request alone at each
TP_TIMEOUT_S = 900      # a collective that a rank never joins raises


def tp_requests(vocab, seed):
    """Item 3's six staggered requests (the same rng draws)."""
    rng = np.random.default_rng(seed)
    lens = [64, 512, 200, 333, 128, 450]
    budgets = [1.0, 0.75, 0.5, 1.0, 0.5, 0.75]
    return [(rng.integers(0, vocab, n).astype(np.int32), 16, b)
            for n, b in zip(lens, budgets)], budgets


def tp_engine(params, rp, cfg, spec, dev, mesh, mode="infer"):
    from repro_torch.training import ServingEngine
    return ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=4,
                         max_seq=1024, device=dev, mesh=mesh)


def tp_logits(params, rp, cfg, spec, tokens, steps, pol):
    """A prefill of ``tokens`` (1, S) and ``steps`` greedy decode steps
    through the model functions (f32 logits, on the host)."""
    import torch
    from repro_torch.models import decode_step, prefill
    lg, caches = prefill(params, rp, {"tokens": tokens}, cfg, spec,
                         mode="infer", max_cache_len=256, policy=pol)
    out = [lg.float().cpu()]
    t = torch.full((1,), tokens.shape[1], dtype=torch.int32,
                   device=tokens.device)
    for i in range(steps):
        tok = torch.argmax(lg, dim=-1)[:, None]
        lg, caches = decode_step(params, rp, tok, caches, t + i, cfg, spec,
                                 mode="infer", policy=pol)
        out.append(lg.float().cpu())
    return torch.cat(out)


def tp_f32_check(mesh, rank, dev, spec, seed, say):
    """At 2 layers in f32, full width: the TP engine's greedy tokens equal
    a one-rank engine's on the same weights and the TP prefill and decode
    logits are within 1e-4 of one rank's (rank 0 runs the one-rank
    reference on the whole tree before taking its shard)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticPolicy
    from repro_torch.models import model_init, router_init
    from repro_torch.runtime import sharding as SH
    cfg = dataclasses.replace(get_config("qwen2-7b"),
                              n_layers=TP_F32_LAYERS, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    reqs, _ = tp_requests(cfg.vocab_size, seed + 1)
    reqs = [(p[:128], 8, b) for p, b in [(r[0], r[2]) for r in reqs[:4]]]
    tokens = torch.as_tensor(reqs[1][0][None], device=dev)
    pol = ElasticPolicy.uniform(0.75, n_heads=cfg.n_heads).to(dev)
    one = None
    if rank == 0:
        with torch.no_grad():
            one_lg = tp_logits(params, rp, cfg, spec, tokens, 4, pol)
        one = serve(tp_engine(params, rp, cfg, spec, dev, None), reqs,
                    stagger=True)
    shard = SH.shard_params(params, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with mesh, torch.no_grad():
        tp_lg = tp_logits(shard, rp, cfg, spec, tokens, 4, pol)
    got = serve(tp_engine(shard, rp, cfg, spec, dev, mesh), reqs,
                stagger=True)
    if rank == 0:
        err = float((tp_lg - one_lg).abs().max())
        say(f"f32, {TP_F32_LAYERS} layers, full width: TP logits (a "
            f"128-token prefill and 4 decode steps) within {err:.3e} of "
            f"one rank's (gate 1e-4); greedy tokens of {len(reqs)} "
            f"staggered requests {'==' if got == one else '!='} one "
            f"rank's [{TP_LABEL}]")
        if not err <= 1e-4:
            fail(f"TP f32 logits differ from one rank's by {err}")
        if got != one:
            fail(f"TP f32 greedy tokens {got} != one rank's {one}")
    return {"f32_tokens": got}


def tp_rank(rank, port, outdir, a):
    """One rank of phase (j), in its own process: the f32 agreement with
    one rank, then the bf16 serving path at --layers with every gate;
    writes its numbers to ``outdir/rank{rank}.json``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import destroy, make_mesh
    from repro_torch.models import model_init, router_init
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime import sharding as SH
    from repro_torch.training import serve as serve_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    say = lambda msg: print(f"[rank {rank}] {msg}", flush=True)
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), backend="gloo",
                     rank=rank, init_method=f"tcp://localhost:{port}",
                     device=dev, timeout=TP_TIMEOUT_S)
    out = {}
    try:
        spec = slice_spec()
        out.update(tp_f32_check(mesh, rank, dev, spec, a["seed"], say))
        gc.collect()
        torch.cuda.empty_cache()

        full = get_config("qwen2-7b")
        cfg = dataclasses.replace(full, n_layers=a["layers"])
        init_cfg = dataclasses.replace(
            full, n_layers=max(a["layers"], a["train_layers"]))
        gen = torch.Generator(device=dev).manual_seed(a["seed"])
        params = model_init(gen, init_cfg, spec, device=dev)
        rp = cut(router_init(gen, init_cfg, spec, device=dev), cfg.n_layers)
        shard = SH.shard_params(cut(params, cfg.n_layers), mesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        requests, budgets = tp_requests(cfg.vocab_size, a["seed"])
        wq = shard["layers"][0]["attn"]["wq"]
        wi = shard["layers"][0]["mlp"]["wi"]
        say(f"shard: wq {tuple(wq.shape)}, wi {tuple(wi.shape)}, embed "
            f"{tuple(shard['embed'].shape)}, lm_head "
            f"{tuple(shard['lm_head'].shape)} [{TP_LABEL}]")

        # the decode step's kernel calls (ops.call_signature: the kernel,
        # its operands' shapes and dtypes, its other arguments) of each
        # run: the staggered mixed-budget one, then one request alone at
        # each budget on the same engine
        sigs, run = {}, ["staggered"]
        real_step = serve_mod.decode_step

        def recording_step(*sa, **kw):
            with ops.recording(cost=False) as calls:
                res = real_step(*sa, **kw)
            sigs.setdefault(run[0], set()).update(
                map(ops.call_signature, calls))
            return res

        engine = tp_engine(shard, rp, cfg, spec, dev, mesh)
        serve_mod.decode_step = recording_step
        try:
            ops.reset_launch_counts()            # the main path, this rank
            C.reset_stats()
            with PathCalls("flash_attention", "decode_attention",
                           "fused_mlp") as rec:
                tokens = serve(engine, requests, stagger=True)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            tm, coll = dict(engine.timing), C.stats()
            for b in TP_SIG_BUDGETS:
                run[0] = b
                serve(engine, [(requests[0][0], 4, b)], stagger=False)
        finally:
            serve_mod.decode_step = real_step
        check_launches("tp_serving", launches)
        counts = engine.compile_counts()
        differ = [b for b in TP_SIG_BUDGETS
                  if sigs.get(b) != sigs.get("staggered")]
        n_sig = {k: len(v) for k, v in sigs.items()}
        if differ or not sigs.get("staggered") or \
                counts != {"prefill": 0, "decode": 1}:
            fail(f"TP decode: the kernel calls' launch signatures at "
                 f"budgets {differ} differ from the staggered run's "
                 f"(signatures per run {n_sig}), or compile_counts {counts} "
                 f"!= prefill 0 / decode 1")
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"TP: bad generated tokens {toks}")
        teacher = serve(tp_engine(shard, rp, cfg, spec, dev, mesh, "base"),
                        requests, stagger=True)
        for i, b in enumerate(budgets):
            if b == 1.0 and tokens[i] != teacher[i]:
                fail(f"TP budget-1.0 request {i} differs from the TP "
                     f"teacher: {tokens[i]} vs {teacher[i]}")
        solo = serve(tp_engine(shard, rp, cfg, spec, dev, mesh),
                     [requests[4]], stagger=False)[0]
        if solo != tokens[4]:
            fail(f"TP request 4 alone {solo} != staggered {tokens[4]}")
        say(f"budget 1.0 == the TP teacher bit for bit, staggered == solo "
            f"(request 4), the decode step's kernel calls the same in the "
            f"staggered run and alone at budgets {TP_SIG_BUDGETS} "
            f"({n_sig['staggered']} signature(s)), compile_counts "
            f"{counts}: ok [{TP_LABEL}]")

        # warm: one admission, then 8 decode steps timed on the host
        h = engine.submit(serve_mod.GenRequest(requests[1][0], 17,
                                               budget=0.75))
        p0 = engine.timing["prefill_s"]
        engine.step()
        admit_ms = (engine.timing["prefill_s"] - p0) * 1e3
        C.reset_stats()
        t0 = time.perf_counter()
        for _ in range(8):
            engine.step()
        step_ms = (time.perf_counter() - t0) * 1e3 / 8
        warm = C.stats()
        while not h.done:
            engine.step()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        per_step = (warm["all_reduce"] + warm["all_gather"]) / 8
        say(f"launches {dict(launches)}; first run: {tm['decode_steps']} "
            f"decode steps, {tm['decode_s'] * 1e3 / tm['decode_steps']:.2f} "
            f"ms/step, {tm['prefill_tokens']} prompt tokens in "
            f"{tm['prefill_s'] * 1e3:.1f} ms of admissions; warm: decode "
            f"{step_ms:.2f} ms/step, a 512-token admission {admit_ms:.1f} "
            f"ms; collectives per decode step {per_step:.1f} "
            f"({warm['all_reduce'] / 8:.1f} all-reduce, "
            f"{warm['all_gather'] / 8:.1f} all-gather) taking "
            f"{warm['seconds'] * 1e3 / 8:.2f} ms; peak device memory "
            f"{peak:.2f} GiB [{TP_LABEL}; {a['device_line']}]")

        res = Results()
        check_path_calls(res, dev, f"TP rank {rank}", rec)
        check_geometry(((n, recorded_args(c, dev))
                        for n, c in PathCalls.signatures.values()),
                       f"{TP_LABEL}, rank {rank}")
        bodies, bounds = {}, {}           # at the rank's shapes
        for n, c in PathCalls.signatures.values():
            ra = recorded_args(c, dev)
            bodies.setdefault(n, set()).add(
                ops.launch_geometry(n, **ra)["body"])
            b = bound_ms(*ops.kernel_cost(n, **ra))[0]
            bounds[n] = max(bounds.get(n, 0.0), b)
        say(f"kernel bodies {({n: sorted(v) for n, v in bodies.items()})}, "
            f"heaviest call's bound (ops.kernel_cost) "
            f"{({n: round(v, 4) for n, v in bounds.items()})} ms "
            f"[{TP_LABEL}]")
        first = [next((j for j, (x, y) in enumerate(zip(t1, t2)) if x != y),
                      None) for t1, t2 in zip(tokens, a["ring_tokens"])]
        if rank == 0:
            say(f"bf16, {cfg.n_layers} layers: TP tokens against item 3's "
                f"one-rank run, first divergence per request {first} (None: "
                f"all 16 equal; a report, not a gate: the partial sums "
                f"round in another order) [{TP_LABEL}]")
        out.update(
            launches={k: int(v) for k, v in launches.items()},
            first_divergence=first, decode_ms=step_ms, admit_ms=admit_ms,
            first_decode_ms=tm["decode_s"] * 1e3 / tm["decode_steps"],
            collectives_per_step=per_step,
            collective_ms_per_step=warm["seconds"] * 1e3 / 8,
            collectives_first_run=coll, peak_gib=peak,
            max_abs_err={k: v["max_abs_err"] for k, v in res.rows.items()})
    finally:
        destroy(mesh)
    (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(out))


def check_tp_serving(args, dev, device_line, ring_tokens) -> dict:
    """(j) Runs the phase: spawns the ranks, waits for both (a failed rank
    fails the phase) and returns each rank's launch counts as a path."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    outdir = tempfile.mkdtemp(prefix="tp_")
    a = dict(seed=args.seed, layers=args.layers,
             train_layers=args.train_layers, device_line=device_line,
             ring_tokens=ring_tokens)
    print(f"(j) tensor-parallel serving, Qwen2-7B at {args.layers} layers, "
          f"TP {TP_RANKS} [{TP_LABEL}; {device_line}]:", flush=True)
    try:
        mp.start_processes(tp_rank, args=(port, outdir, a), nprocs=TP_RANKS,
                           start_method="spawn")
    except Exception as e:          # a rank raised or exited non-zero
        fail(f"(j) tensor-parallel serving: {e}")
    ranks = [json.loads((Path(outdir) / f"rank{r}.json").read_text())
             for r in range(TP_RANKS)]
    if ranks[0]["f32_tokens"] != ranks[1]["f32_tokens"]:
        fail("(j) the ranks' f32 tokens differ")
    for r, out in enumerate(ranks):
        print(f"  rank {r}: decode {out['decode_ms']:.2f} ms/step warm "
              f"({out['first_decode_ms']:.2f} first run), admission "
              f"{out['admit_ms']:.1f} ms, {out['collectives_per_step']:.1f} "
              f"collectives per decode step in "
              f"{out['collective_ms_per_step']:.2f} ms, peak "
              f"{out['peak_gib']:.2f} GiB [{TP_LABEL}; {device_line}]")
    return {f"tp_serving_rank{r}": out["launches"]
            for r, out in enumerate(ranks)}


# ------------------ (k) serving on a (data, model) mesh ---------------------

DP_SHAPE = (2, 2)       # the (data, model) mesh of phase (k)
DP_LABEL = "4 ranks sharing one H100, gloo"
DP_PAGED_LAYERS = 4     # the paged mesh engine's depth (chunks are eager)
DP_TIMEOUT_S = 900      # a collective that a rank never joins raises


def dp_serve(engine, requests, stagger: bool):
    """``serve`` that also returns each request's replica."""
    seen = {}
    tokens = serve(engine, requests, stagger,
                   after_step=lambda hs: seen.update(hs=hs))
    return tokens, [engine.scheduler.replica_of(h.slot) for h in seen["hs"]]


def dp_shard(mesh, rank, cfg, init_cfg, spec, seed, dev):
    """The rank's shard of the weights drawn from ``seed`` on the card
    (``init_cfg`` deep, cut to ``cfg``'s layers) and the whole routers.
    The ranks draw one at a time: a whole tree beside the others' shards
    would not fit the one card."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import model_init, router_init
    from repro_torch.runtime import sharding as SH
    shard = rp = None
    for turn in range(mesh.size):
        if turn == rank:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = model_init(gen, init_cfg, spec, device=dev)
            rp = cut(router_init(gen, init_cfg, spec, device=dev),
                     cfg.n_layers)
            shard = SH.shard_params(cut(params, cfg.n_layers), mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return shard, rp


def dp_engine(params, rp, cfg, spec, dev, mesh, mode="infer", **kw):
    from repro_torch.training import ServingEngine
    return ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=4,
                         max_seq=1024, device=dev, mesh=mesh, **kw)


def dp_f32_check(mesh, rank, dev, spec, seed, say):
    """At 2 layers in f32, full width: the greedy tokens of the ring and
    the paged (2, 2) engines, and of a ring engine re-meshed live (2, 2)
    -> (1, 2) -> None after two steps with every request in flight, equal
    a one-rank engine's on the same weights (rank 0 runs the one-rank
    references on the whole tree first); ``compile_counts()`` restarts at
    prefill 0 / decode 1 after each re-mesh."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import remesh
    from repro_torch.models import model_init, router_init
    from repro_torch.runtime import sharding as SH
    from repro_torch.training import GenRequest
    cfg = dataclasses.replace(get_config("qwen2-7b"),
                              n_layers=TP_F32_LAYERS, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    reqs, _ = tp_requests(cfg.vocab_size, seed + 1)
    reqs = [(p[:128], 8, b) for p, b in [(r[0], r[2]) for r in reqs[:4]]]
    paged = dict(kv_layout="paged", page_size=PAGE_SIZE)
    one = {}
    if rank == 0:
        one["ring"] = serve(dp_engine(params, rp, cfg, spec, dev, None),
                            reqs, stagger=True)
        one["paged"] = serve(dp_engine(params, rp, cfg, spec, dev, None,
                                       **paged), reqs, stagger=True)
    shard = SH.shard_params(params, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    got = {"ring": serve(dp_engine(shard, rp, cfg, spec, dev, mesh), reqs,
                         stagger=True),
           "paged": serve(dp_engine(shard, rp, cfg, spec, dev, mesh,
                                    **paged), reqs, stagger=True)}
    eng = dp_engine(shard, rp, cfg, spec, dev, mesh)
    hs = [eng.submit(GenRequest(p, n, budget=b)) for p, n, b in reqs]
    eng.step()
    eng.step()
    counts, t0 = [], time.perf_counter()
    eng.reshard(remesh(mesh, (1, DP_SHAPE[1])))
    remesh_s = [time.perf_counter() - t0]
    if not eng.left:
        eng.step()
        eng.step()
        counts.append(eng.compile_counts())
        t0 = time.perf_counter()
        eng.reshard(None)
        remesh_s.append(time.perf_counter() - t0)
    if not eng.left:
        while eng.has_work:
            eng.step()
        counts.append(eng.compile_counts())
        got["remesh"] = [list(h.output) for h in hs]
    if rank == 0:
        one["remesh"] = one["ring"]
        want = {"prefill": 0, "decode": 1}
        say(f"f32, {TP_F32_LAYERS} layers, full width: the (2, 2) ring and "
            f"paged engines' and the live re-mesh (2, 2) -> (1, 2) -> None's "
            f"greedy tokens of {len(reqs)} requests "
            f"{({k: got[k] == one[k] for k in one})} against one rank's; "
            f"compile_counts after each re-mesh {counts}; the re-meshes "
            f"took {[round(x, 3) for x in remesh_s]} s [{DP_LABEL}]")
        for k in one:
            if got[k] != one[k]:
                fail(f"(k) f32 {k}: greedy tokens {got[k]} != one rank's "
                     f"{one[k]}")
        if counts != [want, want]:
            fail(f"(k) compile_counts after the re-meshes {counts}, want "
                 f"prefill 0 / decode 1 after each")
    return {"f32_tokens": got["ring"], "remesh_s": remesh_s}


def dp_collectives(c) -> str:
    return (f"model axis {c['all_reduce'] + c['all_gather']} calls "
            f"{c['bytes'] / 1e6:.1f} MB {c['seconds'] * 1e3:.1f} ms, data "
            f"axis {c['data_calls']} calls {c['data_bytes']} B "
            f"{c['data_seconds'] * 1e3:.1f} ms")


def dp_paged(rank, dev, spec, a, mesh, shard, rp, requests, say):
    """The paged engine on the mesh at ``DP_PAGED_LAYERS`` (cut from the
    served depth): the staggered run with its paged_decode_attention calls
    recorded and replayed, budget 1.0 == a paged base engine, staggered
    == solo, prefix sharing on one replica."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.runtime import collectives as C
    from repro_torch.training import GenRequest
    n = min(DP_PAGED_LAYERS, a["layers"])
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n)
    params = cut(shard, n)
    mk = lambda mode="infer": dp_engine(params, rp, cfg, spec, dev, mesh,
                                        mode, kv_layout="paged",
                                        page_size=PAGE_SIZE)
    engine = mk()
    pool = engine._caches["layers"][0]["attn"]["kp"]
    say(f"paged engine on the mesh at {n} of {a['layers']} layers (cut: "
        f"every prefill chunk is an eager model call with its collectives), "
        f"page {PAGE_SIZE}, {engine.pool.n_pages} pages in 2 replica ranges "
        f"of {engine.pool.pages_per_replica}; this rank's pool "
        f"{tuple(pool.shape)} [{DP_LABEL}]")
    ops.reset_launch_counts()
    C.reset_stats()
    with PathCalls("paged_decode_attention") as rec:
        tokens, replicas = dp_serve(engine, requests, stagger=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    coll = C.stats()
    check_launches("dp_paged_serving", launches)
    H, K, Dh = cfg.n_heads // DP_SHAPE[1], cfg.n_kv_heads // DP_SHAPE[1], \
        cfg.d_head
    local = (engine.pool.n_pages // DP_SHAPE[0], PAGE_SIZE, K, Dh)
    shapes = {(c["q"][1], c["kp"][1]) for c in
              rec.calls["paged_decode_attention"]}
    want = {((2, 1, H, Dh), local), ((PAGE_SIZE, 1, H, Dh), local)}
    tables = max(int(c["table"].max()) for c in
                 rec.calls["paged_decode_attention"])
    if shapes != want or tables >= local[0]:
        fail(f"(k) paged rank {rank}: paged_decode_attention at {shapes}, "
             f"table ids up to {tables}; want {want}, ids below {local[0]}")
    st = engine.paged_stats()
    if st["allocated"] != 0 or set(replicas) != {0, 1}:
        fail(f"(k) paged rank {rank}: {st['allocated']} pages held after "
             f"the run, replicas {replicas}")
    res = Results()
    check_paged_calls(res, dev, rec.paged_cases(),
                      {2: "decode step", PAGE_SIZE: "prefill chunk"})
    teacher = serve(mk("base"), requests, stagger=True)
    for i, r in enumerate(requests):
        if r[2] == 1.0 and tokens[i] != teacher[i]:
            fail(f"(k) paged budget-1.0 request {i} differs from the paged "
                 f"base engine: {tokens[i]} vs {teacher[i]}")
    solo = serve(mk(), [requests[4]], stagger=False)[0]
    if solo != tokens[4]:
        fail(f"(k) paged request 4 alone {solo} != staggered {tokens[4]}")
    # prefix sharing: a budget-1.0 request fills replica 0, then two
    # budget-0.5 requests with a common 256-token prefix both go to the
    # less loaded replica 1
    rng = np.random.default_rng(a["seed"] + 3)
    V = cfg.vocab_size
    pre = rng.integers(0, V, 256).astype(np.int32)
    pair = [np.concatenate([pre, rng.integers(0, V, 64).astype(np.int32)])
            for _ in range(2)]
    eng = mk()
    hs = [eng.submit(GenRequest(requests[0][0], 16, budget=1.0))]
    for p in pair:
        eng.step()
        hs.append(eng.submit(GenRequest(p, 16, budget=0.5)))
    eng.step()
    shared = eng.paged_stats()["shared"]
    reps = [eng.scheduler.replica_of(h.slot) for h in hs]
    while not all(h.done for h in hs):
        if eng.step() == 0:
            fail("(k) paged engine stalled (prefix sharing)")
    if shared != 256 // PAGE_SIZE or reps[1] != reps[2] or \
            eng.paged_stats()["allocated"] != 0:
        fail(f"(k) prefix sharing: {shared} shared pages (want "
             f"{256 // PAGE_SIZE}), replicas {reps}, "
             f"{eng.paged_stats()['allocated']} pages left")
    say(f"paged: staggered == solo (request 4), budget 1.0 == the paged "
        f"base engine, replicas {replicas}, prefix sharing {shared} pages "
        f"on replica {reps[1]}, pools drained; paged_decode_attention at "
        f"{sorted(shapes)} with local ids: ok; launches {dict(launches)}; "
        f"collectives of the staggered run: {dp_collectives(coll)} "
        f"[{DP_LABEL}]")
    return {"paged_launches": {k: int(v) for k, v in launches.items()},
            "paged_max_abs_err": {k: v["max_abs_err"]
                                  for k, v in res.rows.items()}}


def dp_rank(rank, port, outdir, a):
    """One rank of phase (k), in its own process: the f32 agreement with
    one rank (ring, paged, the live re-mesh), then the bf16 ring path at
    --layers and the paged path at ``DP_PAGED_LAYERS`` with every gate;
    writes its numbers to ``outdir/rank{rank}.json``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import destroy, make_mesh
    from repro_torch.runtime import collectives as C
    from repro_torch.training import serve as serve_mod

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    say = lambda msg: print(f"[rank {rank}] {msg}", flush=True)
    mesh = make_mesh(DP_SHAPE, ("data", "model"), backend="gloo", rank=rank,
                     init_method=f"tcp://localhost:{port}", device=dev,
                     timeout=DP_TIMEOUT_S)
    out = {}
    try:
        spec = slice_spec()
        out.update(dp_f32_check(mesh, rank, dev, spec, a["seed"], say))
        gc.collect()
        torch.cuda.empty_cache()

        full = get_config("qwen2-7b")
        cfg = dataclasses.replace(full, n_layers=a["layers"])
        init_cfg = dataclasses.replace(
            full, n_layers=max(a["layers"], a["train_layers"]))
        shard, rp = dp_shard(mesh, rank, cfg, init_cfg, spec, a["seed"], dev)
        torch.cuda.reset_peak_memory_stats(dev)
        requests, budgets = tp_requests(cfg.vocab_size, a["seed"])
        say(f"replica {mesh.data_rank}, model shard {mesh.model_rank}: wq "
            f"{tuple(shard['layers'][0]['attn']['wq'].shape)}, wi "
            f"{tuple(shard['layers'][0]['mlp']['wi'].shape)} [{DP_LABEL}]")

        sigs, run = {}, ["staggered"]
        real_step = serve_mod.decode_step

        def recording_step(*sa, **kw):
            with ops.recording(cost=False) as calls:
                res = real_step(*sa, **kw)
            sigs.setdefault(run[0], set()).update(
                map(ops.call_signature, calls))
            return res

        engine = dp_engine(shard, rp, cfg, spec, dev, mesh)
        serve_mod.decode_step = recording_step
        try:
            ops.reset_launch_counts()            # the main path, this rank
            C.reset_stats()
            with PathCalls("flash_attention", "decode_attention",
                           "fused_mlp") as rec:
                tokens, replicas = dp_serve(engine, requests, stagger=True)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            tm, coll = dict(engine.timing), C.stats()
            for b in TP_SIG_BUDGETS:        # one request on each replica
                run[0] = b
                serve(engine, [(requests[0][0], 4, b),
                               (requests[2][0], 4, b)], stagger=False)
        finally:
            serve_mod.decode_step = real_step
        check_launches("dp_serving", launches)
        counts = engine.compile_counts()
        differ = [b for b in TP_SIG_BUDGETS
                  if sigs.get(b) != sigs.get("staggered")]
        if differ or not sigs.get("staggered") or \
                counts != {"prefill": 0, "decode": 1} or \
                set(replicas) != {0, 1}:
            fail(f"(k) rank {rank}: decode signatures at budgets {differ} "
                 f"differ from the staggered run's, or compile_counts "
                 f"{counts} != prefill 0 / decode 1, or admissions on "
                 f"replicas {replicas} only")
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"(k): bad generated tokens {toks}")
        teacher = serve(dp_engine(shard, rp, cfg, spec, dev, mesh, "base"),
                        requests, stagger=True)
        for i, b in enumerate(budgets):
            if b == 1.0 and tokens[i] != teacher[i]:
                fail(f"(k) budget-1.0 request {i} differs from the mesh "
                     f"teacher: {tokens[i]} vs {teacher[i]}")
        solo = serve(dp_engine(shard, rp, cfg, spec, dev, mesh),
                     [requests[4]], stagger=False)[0]
        if solo != tokens[4]:
            fail(f"(k) request 4 alone {solo} != staggered {tokens[4]}")
        say(f"ring: budget 1.0 == the mesh teacher bit for bit, staggered "
            f"== solo (request 4), replicas {replicas}, one decode "
            f"signature set across budgets {TP_SIG_BUDGETS} (a request on "
            f"each replica at each), compile_counts "
            f"{counts}: ok [{DP_LABEL}]")

        # warm: one admission, then 8 decode steps timed on the host
        h = engine.submit(serve_mod.GenRequest(requests[1][0], 17,
                                               budget=0.75))
        p0 = engine.timing["prefill_s"]
        engine.step()
        admit_ms = (engine.timing["prefill_s"] - p0) * 1e3
        C.reset_stats()
        t0 = time.perf_counter()
        for _ in range(8):
            engine.step()
        step_ms = (time.perf_counter() - t0) * 1e3 / 8
        warm = C.stats()
        while not h.done:
            engine.step()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        say(f"launches {dict(launches)}; first run {tm['decode_steps']} "
            f"decode steps at {tm['decode_s'] * 1e3 / tm['decode_steps']:.2f}"
            f" ms/step, {tm['prefill_tokens']} prompt tokens in "
            f"{tm['prefill_s'] * 1e3:.1f} ms of admissions, collectives "
            f"{dp_collectives(coll)}; warm: decode {step_ms:.2f} ms/step "
            f"(a replica with one live slot), a 512-token admission "
            f"{admit_ms:.1f} ms, collectives per decode step "
            f"{dp_collectives({k: v / 8 for k, v in warm.items()})}; peak "
            f"device memory {peak:.2f} GiB [{DP_LABEL}; {a['device_line']}]")

        res = Results()
        check_path_calls(res, dev, f"DP rank {rank}", rec)
        check_geometry(((n, recorded_args(c, dev))
                        for n, c in PathCalls.signatures.values()),
                       f"{DP_LABEL}, rank {rank}")
        first = [next((j for j, (x, y) in enumerate(zip(t1, t2)) if x != y),
                      None) for t1, t2 in zip(tokens, a["ring_tokens"])]
        if rank == 0:
            say(f"bf16, {cfg.n_layers} layers: tokens against item 3's "
                f"one-rank run, first divergence per request {first} (None: "
                f"all 16 equal; a report: the partial sums round in another "
                f"order) [{DP_LABEL}]")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        out.update(dp_paged(rank, dev, spec, a, mesh, shard, rp, requests,
                            say))
        out.update(
            launches={k: int(v) for k, v in launches.items()},
            first_divergence=first, decode_ms=step_ms, admit_ms=admit_ms,
            first_decode_ms=tm["decode_s"] * 1e3 / tm["decode_steps"],
            collectives_first_run=coll,
            collectives_per_step={k: v / 8 for k, v in warm.items()},
            peak_gib=peak, replicas=replicas,
            max_abs_err={k: v["max_abs_err"] for k, v in res.rows.items()},
            seconds=time.perf_counter() - t_rank)
    finally:
        destroy(mesh)
    (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(out))


def check_dp_serving(args, dev, device_line, ring_tokens) -> dict:
    """(k) Runs the phase: spawns the four ranks, waits for them (a failed
    rank fails the phase) and returns each rank's launch counts as paths
    (its ring and its paged run)."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    outdir = tempfile.mkdtemp(prefix="dp_")
    a = dict(seed=args.seed, layers=args.layers,
             train_layers=args.train_layers, device_line=device_line,
             ring_tokens=ring_tokens)
    n = DP_SHAPE[0] * DP_SHAPE[1]
    print(f"(k) serving on a (data, model) = {DP_SHAPE} mesh, Qwen2-7B at "
          f"{args.layers} layers (ring), {min(DP_PAGED_LAYERS, args.layers)} "
          f"(paged) [{DP_LABEL}; {device_line}]:", flush=True)
    try:
        mp.start_processes(dp_rank, args=(port, outdir, a), nprocs=n,
                           start_method="spawn")
    except Exception as e:          # a rank raised or exited non-zero
        fail(f"(k) serving on a (data, model) mesh: {e}")
    ranks = [json.loads((Path(outdir) / f"rank{r}.json").read_text())
             for r in range(n)]
    if any(r["f32_tokens"] != ranks[0]["f32_tokens"] for r in ranks):
        fail("(k) the ranks' f32 tokens differ")
    for r, out in enumerate(ranks):
        print(f"  rank {r}: decode {out['decode_ms']:.2f} ms/step warm "
              f"({out['first_decode_ms']:.2f} first run), admission "
              f"{out['admit_ms']:.1f} ms, per decode step "
              f"{dp_collectives(out['collectives_per_step'])}, peak "
              f"{out['peak_gib']:.2f} GiB, {out['seconds']:.1f} s "
              f"[{DP_LABEL}; {device_line}]")
    paths = {f"dp_serving_rank{r}": out["launches"]
             for r, out in enumerate(ranks)}
    paths.update({f"dp_paged_serving_rank{r}": out["paged_launches"]
                  for r, out in enumerate(ranks)})
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="depth of the served Qwen2-7B (width stays full)")
    ap.add_argument("--train-layers", type=int, default=28,
                    help="depth of the trained Qwen2-7B (width stays full)")
    ap.add_argument("--moe-layers", type=int, default=12,
                    help="depth of the served Qwen1.5-MoE-A2.7B (width "
                         "stays full; 24 is the model's)")
    ap.add_argument("--vlm-layers", type=int, default=20,
                    help="depth of the served and trained "
                         "Llama-3.2-Vision-11B (width stays full; 40 is the "
                         "model's; a multiple of 5 keeps whole "
                         "4 attn + 1 xattn periods)")
    ap.add_argument("--gemma-layers", type=int, default=12,
                    help="depth of the served and trained Gemma-3-27B "
                         "(width stays full; 62 is the model's; a multiple "
                         "of 6 keeps whole 5 local : 1 global periods)")
    ap.add_argument("--pages", type=int, default=None,
                    help="pages in the paged serving pool (default the "
                         "ring-equivalent 4 * 64 + 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", type=Path, metavar="PARENT",
                    help="run only the six kernels' checks and the greedy "
                         "serving engines (--layers deep) on the checkout "
                         "at PARENT and on this one in turns (p c c p): "
                         "each tree bit for bit across its turns, the "
                         "unchanged kernels and paths bit for bit across "
                         "the trees, within TOL, the timed medians and the "
                         "warm decode ms/step")
    ap.add_argument("--ab-turn", nargs=2, type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--gmm-tile-rows", action="store_true",
                    help="also time moe_gmm's heaviest call of each expert "
                         "path at 64- and at 128-row tiles")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ab_turn:
        ab_turn(*args.ab_turn, args.layers)
        return 0
    if args.ab:
        return kernel_ab(args.ab, args.layers)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    device_line = card_line()
    print(f"device: {device_line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()
    phase_s, t_phase = {}, [t_start]

    def done(phase):             # wall time since the previous phase ended
        now = time.perf_counter()
        phase_s[phase] = round(now - t_phase[0], 1)
        t_phase[0] = now

    t_build = build.build()
    print(f"kernel build (nvcc sm_90a, {len(build.SOURCES)} sources in "
          f"parallel): {t_build:.1f} s")
    print_ptxas(build)
    print_hgmma(build)

    dev = torch.device("cuda")
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    cfg = get_config("qwen2-7b")
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    print(f"kernel checks at {cfg.name} shapes [{device_line}]:")
    res = Results()
    check_flash(res, rng, dev, H, K, Dh)
    check_fused_mlp(res, dev, cfg.d_model, cfg.d_ff)
    check_fused_mlp_routed(res, rng, dev, cfg.d_model, cfg.d_ff)
    check_decode(res, rng, dev, H, K, Dh, 1024)
    check_paged_decode(res, rng, dev, H, K, Dh, 1024)
    print(f"int8 operand forms at {cfg.name} shapes [{device_line}]:")
    check_int8_decode(res, rng, dev, H, K, Dh, 1024)
    check_int8_paged(res, rng, dev, H, K, Dh, 1024)
    check_int8_mlp(res, dev, cfg.d_model, cfg.d_ff)
    torch.cuda.synchronize()
    done("build, kernel checks")

    def free():                  # engines, caches and dropped weights
        gc.collect()
        torch.cuda.empty_cache()

    paths = {}
    spec = slice_spec()
    paths["serving"], params, rp, requests, teacher, ring = check_serving(
        args, dev, device_line, spec)
    ring["teacher"] = teacher
    free()
    done("serving")
    paths["paged_serving"], paged = check_paged_serving(
        args, res, dev, device_line, spec, params, rp, requests, ring)
    free()
    done("paged serving")
    paths.update(check_quant_serving(args, res, dev, device_line, spec,
                                     params, rp, requests, ring, paged))
    free()
    check_int8_fork_preemption(params, rp, spec, dev, args.seed)
    free()
    done("int8 serving")
    paths.update(check_train_serving(args, res, dev, device_line, spec,
                                     params, rp, requests, ring))
    free()
    done("train-mode serving")
    check_gradients(params, rp, spec, dev, args.seed)
    free()
    paths["training"] = check_training(args, params, rp, spec, dev,
                                       device_line)
    free()
    done("gradients, training")
    paths.update(check_surfaces(args, dev, device_line, params))
    free()
    done("surfaces")
    depth_paths, rp_d = check_depth_serving(
        args, res, dev, device_line, spec, params, rp, requests, ring, paged)
    paths.update(depth_paths)
    free()
    done("depth serving")
    check_gradients(params, rp_d, depth_spec(spec), dev, args.seed,
                    budget=0.75, depth=0.5)
    free()
    paths["depth_training"] = check_training(
        args, params, rp_d, depth_spec(spec), dev, device_line)
    free()
    done("depth gradients, training")
    paths.update(check_controller_serving(args, res, dev, device_line, spec,
                                          params, rp_d))
    del rp_d
    free()
    done("controller serving")
    paths["sampled_serving"] = check_sampled_serving(
        args, dev, device_line, spec, params, rp, requests, ring)
    free()
    done("sampled serving")
    # moe_gmm is held to its plain version at the calls each expert path
    # made (recorded during the path, replayed after it)
    moefied = moefied_weights(dev, cfg.d_model, cfg.d_ff,
                              expert_spec(spec).mlp_n_experts)
    with PathCalls("moe_gmm") as rec:
        paths["expert_serving"], rp_e = check_expert_serving(
            args, dev, device_line, spec, params, requests, teacher)
    free()
    print(f"moe_gmm at the expert serving path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "moefied qwen2-7b serving", rec.gmm_cases(), moefied,
                  timed=True, tile_rows=args.gmm_tile_rows)
    free()
    done("expert serving")
    check_gradients(params, rp_e, expert_spec(spec), dev, args.seed)
    free()
    with PathCalls("moe_gmm") as rec:
        paths["expert_training"] = check_training(
            args, params, rp_e, expert_spec(spec), dev, device_line)
    free()
    print(f"moe_gmm at the expert training path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "moefied qwen2-7b training", rec.gmm_cases(),
                  moefied, timed=False, tile_rows=args.gmm_tile_rows)
    del params, rp, rp_e         # the Qwen2-7B weights leave the card
    free()
    done("expert gradients, training")
    with PathCalls("moe_gmm") as rec:
        paths["native_serving"], native = check_native_serving(
            args, dev, device_line)
    free()
    print(f"moe_gmm at the native MoE serving path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "native qwen1.5-moe serving", rec.gmm_cases(),
                  native_weights(dev, get_config("qwen2-moe-a2.7b")),
                  timed=False, tile_rows=args.gmm_tile_rows)
    free()
    done("native MoE serving")
    with PathCalls("moe_gmm") as rec:
        paths["native_training"] = check_native_training(
            args, dev, device_line, native)
    free()
    print(f"moe_gmm at the native MoE training path's calls "
          f"[{device_line}]:")
    check_moe_gmm(res, dev, "native qwen1.5-moe training", rec.gmm_cases(),
                  native_weights(dev, get_config("qwen2-moe-a2.7b")),
                  timed=False, tile_rows=args.gmm_tile_rows)
    free()
    done("native MoE training")
    with PathCalls("moe_gmm") as rec:
        paths["quant_native_serving"] = check_native_int8_serving(
            dev, device_line, native)
    del native
    free()
    print(f"int8 moe_gmm at the native MoE int8 path's calls "
          f"[{device_line}]:")
    check_int8_gmm(res, dev, "native int8", rec.gmm_cases(),
                   get_config("qwen2-moe-a2.7b"))
    done("native MoE int8 serving")
    free()                       # the context families: (a)-(d)
    vlm_paths, vlm = check_vlm_serving(args, res, dev, device_line)
    paths.update(vlm_paths)
    free()
    done("(a) VLM serving")
    paths.update(check_vlm_training(args, res, dev, device_line, vlm))
    del vlm
    free()
    done("(b) VLM distillation")
    paths.update(check_vit_training(args, dev, device_line))
    free()
    done("(c) ViT distillation")
    paths.update(check_encdec_serving(args, res, dev, device_line))
    free()
    done("(d) encoder-decoder serving")
    paths.update(check_hybrid(args, res, dev, device_line))
    free()
    done("(e) RecurrentGemma")
    paths.update(check_gemma(args, res, dev, device_line))
    free()
    done("(f) Gemma-3")
    paths.update(check_mamba(args, res, dev, device_line))
    free()
    done("(g) Mamba2")
    paths.update(check_attention_only(args, res, dev, device_line))
    free()
    done("(h) Granite, Phi-3, Grok-1")
    accounting = check_analysis(args, res, dev, device_line)
    free()
    done("(i) analysis and accounting")
    paths.update(check_tp_serving(args, dev, device_line, ring["tokens"]))
    done("(j) tensor-parallel serving")
    paths.update(check_dp_serving(args, dev, device_line, ring["tokens"]))
    done("(k) serving on a (data, model) mesh")
    kernels = [dict(name=n, route="cuda", source=SOURCES[n][0],
                    replaces=SOURCES[n][1],
                    launches=sum(p[n] for p in paths.values()),
                    launches_by_path={k: p[n] for k, p in paths.items()},
                    **res.rows[n]) for n in SOURCES]
    print(f"phase wall times (s): {phase_s}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"accounting": accounting}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
