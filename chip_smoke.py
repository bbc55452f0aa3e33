#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases, each printing its own lines:

  1. device  — requires ``torch.cuda.is_available()``; prints the card's name
     and power limit as ``nvidia-smi`` reports them.
  2. build   — builds the hand-written kernels (``src/repro_torch/csrc``) for
     ``sm_90a`` into ``build/torch_ext/`` and prints the build seconds.
  3. kernels — Bitpack / Bitunpack against their plain PyTorch versions on
     the same CUDA tensors (round_to 1..3; sizes 1, 127, 32,769 and fc5's
     51,380,224; special values; an unaligned view): planes byte-equal,
     unpack bit-equal, pack∘unpack equal to ``quantize_ref``. Then times
     both at fc5's size with CUDA events beside the plain versions and the
     HBM bound, and at qwen3-1.7b's per-layer lengths and its embed at
     round_to 2 with the L2 cold (a CUDA graph over input copies).
  4. main path — A²DTWP training of full-width AlexNet (224×224, 200
     classes, paper init from a seed, batch 64, default ``compress_min_size``)
     through ``Trainer``: an AWP plan that widens every 2 steps
     (8→16→24→32 bits), then ``oracle:2`` steps, then one ``make_cnn_eval``.
     Launch counts are zeroed just before and read just after; every packed
     leaf must have gone through the CUDA kernels, every ``StepRecord``'s
     wire bytes must equal the plan's ``wire_table``. A ``torch.profiler``
     trace of one more warm ``oracle:2`` step gives kernel time by name and
     the device's idle share.
  5. reference — reduced AlexNet trained 4 steps on the card and on the CPU
     (plain versions) from the same weights: losses and norms must agree.
  6. flash — the flash prefill kernel against its plain version on the card
     at qwen3-1.7b's heads (B=1, H=16, Kv=8, hd=128; Sq=Sk 128, 256, 384,
     512, 1024, 2048; a continuation Sq=128, Sk=512, q_offset=384 at B=1
     and 2; B=2 at 512) and at G=1 and G=4, unit normals from a seed, max
     |err| <= 1e-5, two calls bit-equal, and each row of a batch of 2 and 4
     bit-equal to the row alone (S 512, 256 and the continuation). Times the kernel (in a CUDA graph,
     the device time, and eager), the plain version and
     ``scaled_dot_product_attention`` (the library yardstick, in a graph
     and eager) with CUDA events beside the bound (causal FLOPs at 67
     TFLOP/s fp32, or bytes at 3.35 TB/s).
  7. serve — full-width qwen3-1.7b (28 layers, d 2048, vocab 151,936, random
     weights from seed 0) served through ``repro_torch.launch.serve``'s
     functions: ``PrecisionPlan.build(round_to=2)``, five greedy requests
     (prompts 512, 512, 384, 256, 200; 16 new tokens each), 2 slots, cache
     512 + 16. The static one-shot reference, then the engine, then the
     engine with ``weight_stationary``. Launch counts are zeroed before and
     read after each run: 28 flash launches per prefill whose length is a
     multiple of 128 (the 200-token prompt takes ``attend_tiled``, by the
     reference's rule), Bitpack/Bitunpack once per ``DIST`` leaf per
     materialization. Engine streams must equal the static streams, the
     measured ``host_device`` bytes must equal ``serve_host_device_bytes``,
     and every logit the engines sample from must be finite. The first
     flash launch at each distinct shape of these runs (B=1 at 512, 384 and
     256; B=2 at 512 in the static run) is recorded and held to the plain
     version on its own inputs within 1e-5, so a kernel fault at a main-path
     shape fails the run even though the engine and the static reference
     both go through the kernel. Prints
     admission (prefill) ms per prompt length, decode ms/step, tokens/s, the
     memory peak, and a ``torch.profiler`` trace of one 512-token admission
     and one warm decode step.

  8. paged — the paged decode kernel against its plain version on the card
     at phase 9's shape (B=2, Kv=8, G=2, hd=128, page 64, a 9-page table,
     19 pool rows; lengths 1, 63, 64, 65, 200, 528 and 0; a permuted table
     with unused entries at the trash row) and at page 8 with G = 1 and 4,
     and at the split's edges (lengths on them, a table wider than the live
     pages, B=16 at 64 pages), unit normals from a seed, max |err| <= 2e-6;
     each case again on a permuted pool, where the output must not change,
     and twice, where the bits must not; pages of 192 and 256 rows too.
     Each slot's output must be bit-equal alone, inside batches of 2 and 4
     and inside a table twice as wide (page 64 and 256). Times the kernel (in a CUDA graph
     with the L2 cold and warm, and eager), the plain version and a
     ``k_pool[table]`` gather plus fp32
     ``scaled_dot_product_attention`` with a length mask (two calls: no
     single PyTorch call reads through a page table) with CUDA events, at
     phase 9's shape and at B=16, 4096 tokens a slot in 64 pages of 64,
     beside the bound (K and V of the attended rows, q and out at 3.35 TB/s).
  9. paged serve — phase 7's weights served through
     ``ServeEngine(paged=True, page_size=64)``. Phase 7's requests (2 slots,
     capacity 528): streams equal to phase 7's static and contiguous-engine
     streams (a divergence prints the reference's top-2 logit gap and
     fails), measured ``host_device`` (the 72 B page table a decode step
     included) equal to ``serve_host_device_bytes``, a clean page audit, 3
     prefill buckets first seen and 2 seen before, and launches: flash 28
     per admission (every bucket, 512, 384 and 256, is a multiple of 128),
     ``paged_attend`` 28 per decode step, Bitpack/Bitunpack once per
     ``DIST`` leaf per forward. Then a 256-token shared prefix with tails of
     64, 100 and 128 tokens (3 slots, capacity 400): the peak equals
     ``serve_paged_kv_bytes`` (11 pages of 14,680,064 B) and streams equal
     ``generate_static`` (a divergence passes only at a reference top-2 gap
     below 1e-3, since the shared pages hold the first writer's bits). The
     first ``paged_attend`` launch at each shape and layer 0's launch of
     every decode step are recorded and held to the plain version on their
     own inputs within 2e-6. Prints decode ms/step, admission ms, tokens/s,
     the memory peak and a ``torch.profiler`` trace of one paged decode
     step.
 10. l2norm — the AWP monitor's Σw² kernel against its plain version on the
     card: unit normals from a seed at lengths 1, 127, 32,769, 20,000,000
     (the Table II/III profile size), 88,080,384 (a stacked gate of
     qwen3-1.7b), 88,936,448 (AlexNet's DIST weights) and 311,164,928
     (qwen3-1.7b's embed), an unaligned view, and the
     special values (inf and NaN where the plain version has them); rtol
     1e-5, and two calls on one input must give the same bits. Times the
     kernel, the plain version and ``torch.dot(x, x)`` (the library
     yardstick) with CUDA events at 20,000,000, a stacked gate
     (88,080,384) and the embed, beside the bound (4 B an element at
     3.35 TB/s).
 11. main path — A²DTWP training of full-width qwen3-1.7b (28 layers,
     random weights from seed 0, ``cfg.remat`` on) through ``Trainer`` and
     ``make_train_step`` on ``synthetic_lm_batch`` at batch 8 x seq 128:
     an AWP plan forced to widen every 2 steps (8→16→24→32 bits), then
     ``oracle:2`` steps. Losses finite, wire bytes equal to the plan's
     ``wire_table``, and launch counts zeroed before and read after:
     Bitpack/Bitunpack once per ``DIST`` leaf per materialization (198 a
     forward, and the 196 group leaves again in the remat backward, at
     every step below 32 bits), ``l2norm_sq`` once per ``DIST`` leaf per
     step (30). Layer group 0's first monitor call of each step is recorded
     and held to the plain version within rtol 1e-5. Prints warm step ms,
     the memory peak and a ``torch.profiler`` trace of one ``oracle:2``
     step with the monitor's and the transfer's share of kernel time.

 12. main path — A²DTWP training of full-width AlexNet (phase 4's widths and
     weights from seed 0, dropout off, default ``compress_min_size``) as 2
     gloo ranks on the one card: processes spawned by
     ``repro_torch.launch.mesh.spawn_ranks`` that meet through a
     ``FileStore`` in a temporary directory, each with 32 of the 64 images
     of every batch and its shards of the ``DIST`` weights. Through
     ``Trainer`` and ``make_cnn_train_step(mesh=...)``: two ``oracle:2``
     steps (fp32 gradient reduce-scatter), one with ``chunks`` 2, one with
     ``grad_round_to`` 2 (truncate: per-peer blocks packed), then one
     ``make_cnn_eval`` on the shards. Each rank checks (a) at step 0 every
     ``DIST`` leaf's gathered and unpacked weights bit-equal to one rank's
     ``quantize_ref`` of the whole leaf, (b) the chunked gather bit-equal to
     chunks 1's gather of the same shards, (c) its Bitpack, Bitunpack and
     ``l2norm_sq`` launch counts (zeroed before, read after) as its leaves
     require, each first launch at a (length, round_to) held to the plain
     version, and (d) the measured wire (``dist.comm``'s log through
     ``ring_wire_bytes``) equal to ``wire_table(elems, 2)`` per class at
     every step; then (e) the losses and Σw² within ``DP_LOSS_RTOL`` and
     ``DP_NORM_RTOL`` of one
     rank's run of the same steps from the same weights (the Σw² of
     monitored leaves that are not ``DIST``, conv0, counted once per rank
     as in the reference). Prints step ms, the gloo staging share, and a
     ``torch.profiler`` trace of one more step on rank 0 with the device's
     idle share, beside the card's name and power limit.

 13. main path — FSDP×TP training of qwen3-1.7b at its widths and
     ``TP_LAYERS`` (4) of its 28 layers (cut so that the script
     fits its time limit: phase 18 (a) trains the 2×2 mesh at full depth;
     phase 11's weights from seed 0 and settings: remat on,
     ``synthetic_lm_batch`` at batch 8 x seq 128, lr 0.05) on a 2×2 mesh: 4 gloo ranks on the one
     card (``spawn_ranks``), each with 4 of the 8 sequences, its model
     rank's TP half of every matrix and a quarter of the ``DIST`` weights,
     built in turn behind a barrier. Through ``Trainer`` and
     ``make_train_step(mesh=...)``, all at ``oracle:2``: two steps with fp32
     gradients and activations, one ``seq_parallel``, one ``act_round_to``
     2 and one ``grad_round_to`` 2 (both truncate, so that their planes go
     through the kernels). Each rank checks (a) at step 0 every ``DIST``
     leaf's gathered and unpacked weights bit-equal to ``quantize_ref`` of
     its TP slice of the whole leaf, (b) its Bitpack, Bitunpack and
     ``l2norm_sq`` launches (zeroed before, read after) as its leaves and
     TP boundaries require, the first launch at each (length, round_to)
     and the first monitor call at each of its shard lengths held to the
     plain versions, (c) the measured wire per class equal to
     ``step_wire_table`` (the plan's ``wire_table`` with the step's TP
     boundaries and the remat backward's collectives) at every step, the
     unpriced ``grad_sync``, ``metrics`` and ``loss`` printed beside it, and
     (d) the ``seq_parallel`` step's loss and Σw² within 1e-6 relative of
     the psum layout's step from the same state (whether the bits match is
     printed); then (e) the three uncompressed steps' losses and Σw²
     within ``TP_LOSS_RTOL`` and ``TP_NORM_RTOL`` of phase 11's one-device
     step run from the same weights in this process after the ranks exit,
     and every rank's change of each leaf block after two and three steps,
     Σ(w − w₀)², within ``TP_MOVE_RTOL`` of the same block of that run's,
     and (f) the compressed steps' losses within the reference's bar
     (``|lc − l1| < 0.05 + 0.05·|l1|``). Prints step ms, the gloo staging
     share, the wire per class a rank and a ``torch.profiler`` trace of one
     more uncompressed step on rank 0 (staging copies, GEMMs, other
     kernels, idle share), beside the card's name and power limit.

 14. main path — qwen3-1.7b at its widths and ``CUT_LAYERS`` (4) of its 28
     layers (cut, as phases 15 (a)-(d), 16, 18 (b), (c) and 19 are, so that
     the script fits its time limit; first phase 7's static run and engine
     again at that depth, one device, the reference of the cut phases)
     served at tp 2 (weights from seed 0, ``PrecisionPlan.build(round_to=
     2)``) as gloo ranks on the one card, each building its blocks in
     turn. (a) A 1×2 mesh, phase 7's requests and slots: static, engine,
     weight-stationary engine, paged
     engine (page 64); then, with the TP-region all-reduces packed at
     ``act_round_to`` 2 (truncate, so that the planes go through the
     kernels), the 512-, 384- and 256-token prompts: static runs of one
     request each, the engine at 1 slot (held to them exactly) and at 2
     slots (which may leave them only where a batch-1 run's top-2 logit gap
     is below the run's ``near_tie``: see ``TPS_RUNS_A``). (b) A
     weight-stationary 2×2 mesh: phase 7's 512- and 256-token prompts at
     ``TPS_B_GEN`` tokens, one slot a data rank: static, then the engine (the placement gathers once, every
     admission prefill gathers over the FSDP group). Each rank checks its
     launches (zeroed before and read after each run: Bitpack/Bitunpack
     once per ``DIST`` leaf per materialization and twice per packed
     all-reduce, flash 28 per prefill of a multiple of 128, ``paged_attend``
     28 per paged decode step), its wire per forward per class against
     ``serve_wire_table`` (57 TP-region exits a forward; no weights in a
     weight-stationary decode step; the placement one forward's gathers),
     its ``host_device`` bytes against ``serve_host_device_bytes``, and the
     first launch of each kernel at each new shape (flash at H 8 / Kv 4,
     ``paged_attend`` at Kv 4, Bitpack/Bitunpack at the TP slices' lengths)
     against its plain version. Here: engine streams equal to the static
     streams of the same mesh and plan (but for that 2-slot run's
     allowance); the fp32 streams equal to phase 7's
     one-device streams (a divergence prints one device's top-2 logit gap
     there and fails unless it is below the logit bound); the 512-token
     admission's logits within ``TPS_LOGIT_RTOL`` × max |logit| of phase 7's;
     the logits' hashes and streams equal on every rank. Prints admission
     and decode ms, tokens/s, the memory peak per rank, the gloo staging
     share, bytes per traffic class per forward, and a ``torch.profiler``
     trace of one 512-token admission and one warm decode step on rank 0 at
     1×2, beside the card's name and power limit.

 15. main path — qwen3-1.7b at its widths and ``CUT_LAYERS`` of its layers
     (phase 14's one-device reference: weights from seed 0 and plan,
     rebuilt) served with the features of its later slice, one card:
     (a) phase 7's prompts as sampled requests (temperature 0.8, top-p 0.95,
     top-k 40, seeds ``FEAT_SEEDS``, the last the largest uint32): static,
     contiguous engine, paged engine (page 64), held exactly; (b) phase 7's
     greedy requests with int8 KV: static, contiguous and paged engines,
     held exactly, with the first decode logits of the 512-token admission
     within ``INT8_LOGIT_RTOL`` of fp32's and the paged KV bytes a token
     equal to ``serve_paged_kv_bytes(int8_kv=True)`` (59,136 B at full
     width), then (a)'s requests with int8 KV statically, for (e); (c)
     (a)'s requests through the speculative engine (``FEAT_SPEC_K``
     proposals) with the target as its own draft and with the tiny draft
     (seed 1), then self on the paged engine: streams equal to (a)'s
     engine's, and every self-draft rejection, only where the draw lies
     within ``FEAT_NEAR_TIE`` × cw[-1] of a boundary in a batch-1 static
     run, host_device equal to ``serve_spec_decode_bytes``; (d) a
     ``FEAT_WINDOW``-token window: the static run (linear cache, window
     mask) against the ring engine, exactly; (e) (a)'s requests with int8
     KV on a 1×2 mesh of two gloo ranks (phase 14's rank function), every
     int8 KV code of both runs recorded (``kv_probe``): the engine equal to
     the 1×2 static run but where ``int8_tie`` holds (a code flipped on
     some rank, each within ``INT8_TIE_MIDPOINT`` code steps of a rounding
     midpoint, the draw within ``INT8_TIE_DRAW`` × cw[-1] of a CDF step in
     both runs;
     ``int8_probe_report`` prints each parting), both to (b)'s one-device
     run under the near-tie rule, hashes and streams equal on both ranks. The
     sampler's rows are checked alone against a batch of 8 on the card.
     Every run checks its launches (Bitpack/Bitunpack once per ``DIST``
     leaf per materialization, the draft's prefills and micro steps
     included; flash 28 per prefill of a multiple of 128 — a windowed
     prefill too, since a serve prefill attends without the window, as
     in the reference; ``paged_attend`` 28 per fp32 paged decode step and
     none for an int8 pool or a verify block) and holds the first launch at
     each new shape to its plain version. Prints times, tokens/s, rounds,
     acceptance, memory peaks and KV bytes beside the card's name and
     power limit.
 16. main path — the rest of dense-LM training on qwen3-1.7b at its widths
     and ``CUT_LAYERS`` of its layers (phase 11's weights from seed 0 and
     settings, batch 8 x seq 128, ``oracle:2``),
     each run from fresh weights: (a) ``accum_steps`` 2 against 1, two
     steps each, losses within ``ACCUM_TOL``; (b) weights at round_to 2
     stochastic, two steps with ``PRNGKey(step)``: the embed's and a
     w_gate's planes under the step's keys drawn on the card equal the
     plain version's on the host CPU (the embed at ``EMBED_EDGE`` samples),
     a rerun bit-equal, losses finite; (c) phase 12's AlexNet ranks with
     stochastic bf16 gradients, two steps twice, bit-equal, against a
     nearest-rounded run within ``DP16_LOSS_RTOL``; (d) three bf16 steps,
     the first loss within ``BF16_LOSS_RTOL`` of (a)'s fp32 one. Then the
     bf16 kernels against their plain versions at phases 6's and 8's shapes
     and flash at the tp-2 heads (each element within one bf16 step plus
     the fp32 bar; flash twice bit-equal, and each row bit-equal alone and
     in batches of 2 and 4), timed as those phases time the fp32 ones (flash
     at S 128, 512, 2048 and the tp-2 heads in a graph), beside the bf16
     bound and bf16 SDPA in a graph and eager; and
     (e) phase 7's requests under a plan with ``"dtype": "bf16"``: static,
     engine and paged engine (page 64), paged equal to contiguous exactly,
     the engine equal to static but where a batch-1 run's top-2 logits tie
     within ``BF16_TIE_STEPS`` bf16 steps, 28 bf16 flash launches a prefill
     of a multiple of 128 and 28 bf16 ``paged_attend`` a paged decode step
     counted by the wrappers (and no fp32 attention launch), each path
     shape held to the plain version, and the first logits against phase
     7's fp32 ones (relative l2, printed). Prints step times, memory peaks
     and the card's name and power limit.

 17. main path — training I/O on qwen3-1.7b at its widths and
     ``IO_LAYERS`` (4) of its 28 layers (cut as phase 13's: phase
     18 (a) saves and loads the full-width state; phase 11's weights from
     seed 0 and settings, batch 8 x seq 128, remat on), in a fresh
     temporary directory (at least 40 GB free, else the phase fails; removed
     at the end): (a) 64 LM shard records (vocab 151,936, seq 128, seed 0)
     written and read through ``ShardReader(quality=4)`` and
     ``Prefetcher(depth=2)``, each step's ``io_log`` equal to
     ``train_ingest_bytes``; (b) six steps of phase 11's AWP plan off the
     prefetcher; (c) three steps from fresh weights, an ``AsyncCheckpointer``
     save (residuals, plan, the consumed batch's data state), step 4 while it
     writes, the manifest's bytes equal to ``train_checkpoint_bytes`` and
     the files' sizes (at full depth 16,253,919,232 B), the checkpoint read back into
     fresh tensors equal to the state at submit (a hash of each leaf's
     bytes), then steps 4-6 from it and the restored reader: losses, AWP
     history, final storage and momentum bit-equal to (b); (d) the step-3
     weights exported without residuals at the wire widths (4,063,727,616
     B), loaded at ``quality="wire"`` and served (phase 7's first prompt,
     16 tokens), the stream equal to the same weights truncated in memory.
     Launch counts and the first launch of each kernel at each shape held
     to the plain version, as phase 11. Prints write / read MB/s, ingest
     steps/s, the async submit ms and save s, the load s and GB/s, the
     bytes and the phase's seconds beside the card's name and power limit.
 18. main path — the mesh finished, qwen3-1.7b. (a) A 2×2 mesh of 4 gloo
     ranks at the model's widths and ``IO_LAYERS`` (4) of its 28 layers
     (cut as phases 13 and 17, so that the script with phase 19 fits its
     time limit; phase 11's weights from seed 0 and settings, remat on,
     batch 8 x seq 128), phase 17's AWP plan
     (widening every 2 steps) off phase 17's 64 shard records, each rank
     reading the global batch through its own ``Prefetcher(depth=2)``
     (every ``io_log`` equal to ``train_ingest_bytes``, every step's wire
     to ``step_wire_table``): two steps, then the step-2 weights exported
     across ranks without residuals at the wire widths, then an
     ``AsyncCheckpointer`` save across ranks (the gather to rank 0 on the
     calling thread; residuals, plan and the consumed batch's data state),
     step 3 beside rank 0's writer, the manifest's bytes equal to
     ``train_checkpoint_bytes`` of the global storage and the files' sizes
     (16,253,919,232 B at full depth), then a load across ranks into fresh tensors (equal
     to the state at submit, a hash of each block), the export restored at
     ``quality="wire"`` through ``launch.serve``'s ``restore`` and served
     at 2×2 weight-stationary (phase 7's first prompt, ``MESH_GEN`` tokens)
     equal to the same weights truncated in memory, and step 3 again from
     the restored state and reader: the uninterrupted step's loss, AWP
     history, storage and momentum blocks, bit for bit. The steps before
     and after the save are one uninterrupted run (a save only reads).
     (b) A 1×2 mesh at phase 15's depth (``CUT_LAYERS``): phase 15's
     sampled requests (``MESH_GEN`` tokens)
     through the engine and the speculative engine (``FEAT_SPEC_K``; the
     target as its own draft, and the tiny draft built on the mesh): the
     speculative streams equal to the 1×2 engine's and all to phase 15's
     one-device streams, but where the draw lies within ``FEAT_NEAR_TIE``
     of a boundary in a batch-1 static run at the mesh. (c) At 1×2 a
     ``FEAT_WINDOW``-token window: the windowed static run equal to the
     ring engine exactly, both to phase 15 (d)'s one-device streams under
     the same rule. Each run checks its launches (zeroed before, read
     after), its wire and its host<->device bytes, and the first launch of
     each kernel at each new shape against its plain version; streams equal
     on every rank. Prints step ms and the gloo staging share, the submit
     ms, save s, load s and GB/s, the gather and scatter bytes, rounds and
     acceptance, and the phase's seconds, beside the card's name and power
     limit.
 19. main path — the serving fleet (``repro_torch.fleet``) on one card,
     qwen3-1.7b at its widths and ``CUT_LAYERS`` (4) of its 28 layers
     (phase 14's one-device reference; the full depth ran 153-168 s, over
     the script's limit beside the rest) at phase 9's geometry (round_to 2,
     page 64, 2 slots a replica): :func:`fleet_path`. (a) Weights from
     seed 0 published as a wire-only parcel (``train_checkpoint_bytes(
     residuals=False)`` bytes), 2 decode replicas and 2 prefill workers;
     phase 7's requests and (c) phase 15 (a)'s sampled ones at that
     version, a version from seed 1 published after 2 results with phase
     9's shared-prefix trio pinned to it, a replica joining and one
     leaving midway: streams equal to phase 7's static run at this depth,
     to phase 15 (a)'s engine, and the trio to ``generate_static`` under
     the weights restored from its parcel (phase 9's near-tie rule); the
     fabric's hop log equal to ``fleet_migration_bytes`` (2,097,152 B a
     migrated fp32 page; 14,680,064 at full depth). (b) An int8-KV fleet
     from the same parcel: phase 15 (b)'s paged int8 streams (1,064,960 B
     a page; 7,454,720 at full depth). Every worker prefill and replica
     tick launches what the local paged engine launches for the same work;
     the first flash and ``paged_attend`` launch at each shape is held to
     the plain version. Prints decode ms a tick, a parcel's pack, send and
     install ms, the publish encode and decode s and the memory peak,
     beside the card's name and power limit.
 20. main path — the MoE family and the dense variants at their widths
     (:func:`archs_path`), phase 7's requests at ``round_to`` 2 from seed
     0's weights. (a) chatglm3-6b at its 28 layers (H 32 / Kv 2: flash
     and ``paged_attend`` at 16 query heads a kv head): the static run,
     the engine and the paged engine at page 64. (b) qwen2.5-14b at
     ``CUT_LAYERS`` (4) of its 48 layers (59 GB of fp32 masters at full
     depth do not fit beside the rest), its QKV biases drawn from a seed
     (the reference's init leaves them zero): the static run and the paged
     engine (G 5). (c) mixtral-8x7b at ``CUT_LAYERS`` of its 32 layers
     (one layer is 5.8 GB): the static run made request by request (the
     capacity dispatch ranks a batch's tokens) and the contiguous engine
     under its 4,096-token window (no flash, no paging, by the
     reference's rules). Streams equal the static ones; launches as phase
     7 counts them (28 flash launches a prefill of a multiple of 128 in
     (a), a padded page bucket in the paged engines; a layer's
     ``paged_attend`` a paged decode step; Bitpack / Bitunpack once per
     ``DIST`` leaf, the expert leaves included, per materialization);
     ``host_device`` equal to ``serve_host_device_bytes``; the first
     flash and ``paged_attend`` launch at each shape held to the plain
     versions. (d) mixtral-8x7b at ``ARCH_TRAIN_LAYERS`` (2) layers,
     A²DTWP training at phase 11's batch, lr and forced AWP plan for five
     steps: finite losses, a positive aux loss a step (printed), wire
     bytes equal to the plan's, ``l2norm_sq`` once per monitored leaf a
     step and packing held to the plain versions at every length (the
     expert leaf of 469,762,048 elements among them). Prints each part's
     seconds and memory peak, decode ms/step and step ms, beside the
     card's name and power limit. Phases 6 and 8 also check and time flash
     at H 40 / Kv 8 and H 32 / Kv 2 (S 512) and ``paged_attend`` at Kv 8 /
     G 5 and Kv 2 / G 16 (the decode shape) beside their bounds and SDPA.
 21. main path — the recurrent families at their widths
     (:func:`recurrent_path`): xlstm-1.3b served (the chunkwise mLSTM
     beside the sequential one) and trained at 12 of its 48 layers,
     recurrentgemma-9b at 19 of its 38 layers served, xlstm-1.3b at 4
     layers on a 1×2 mesh.
 22. main path — vision cross-attention and the audio encoder at their
     widths (:func:`vision_path`). (a) llama-3.2-vision-90b at
     ``VLM_LAYERS`` (5) of its 100 layers, one whole ``(attn × 4, cross)``
     pattern (22.74 GB of fp32 masters; 4 layers leave no precision
     group), its cross gates drawn from a seed (the reference's zero init
     makes a cross block add nothing), served on the static path (the
     engine refuses image requests): phase 7's requests with request 1 on
     request 0's prompt, each with 4,096 image tokens of width 1,280 drawn
     as the serve launcher draws them. Every logit finite; requests 0 and
     1's first logits apart by more than 1e-4 of the largest |logit|;
     request 0's first decode step within 1e-4 of the largest |logit| of a
     fresh prefill of the same tokens; 4 flash launches (the
     self-attention layers, H 64 / Kv 8, G 8) a prefill of a multiple of
     128, held to the plain version; Bitpack / Bitunpack once per ``DIST``
     leaf per forward. (b) hubert-xlarge at its 48 layers (946,126,080
     parameters) in A²DTWP training at batch 4 × 512 frames of
     ``synthetic_feature_batch`` for five steps of the forced AWP plan:
     finite losses (ln 504 ≈ 6.22 is where they start), wire bytes equal
     to the plan's, ``l2norm_sq`` once per monitored leaf a step, packing
     held to the plain versions. Prints admission ms by length, decode
     ms/step, the losses, formats and step seconds and each part's memory
     peak, beside the card's name and power limit. Phase 6 also checks and
     times flash at H 64 / Kv 8 (S 512).
 23. accounting and tooling (:func:`accounting_path`), qwen3-1.7b at its
     widths and ``CUT_LAYERS`` (4) of its 28 layers. (a) Two gloo ranks on
     the card (the processes that then run (c)): the host-clock medians of a 1 KiB and a 64 MiB-a-rank u8
     ``comm.all_gather`` (the latency and the ring-wire rate behind
     ``roofline.analysis.COLLECTIVE_LATENCY`` and ``LINK_BW``), then one
     chunked weight gather of the model's largest ``DIST`` shard at full
     width (the embed, 155,582,464 fp32 a rank over 2 FSDP ranks, round_to
     2) at chunks 1, 2 and 4: the measured best beside ``pick_chunks``'s.
     (b) The training launcher's rank loop (``launch.train._train`` on its
     parsed flags) at 2×2 with ``--chunks auto`` and ``oracle:2`` for
     ``ACCT_STEPS`` (2) steps: its count equal to ``pick_chunks`` at the
     largest ``DIST`` shard, every step's measured ``weights`` wire equal
     to ``step_wire_table``, Bitpack, Bitunpack and ``l2norm_sq`` launched
     on every rank, finite losses. (c) The speculative engine (``spec_k``
     3, the tiny draft) at 1×2 over prompts ``ACCT_LENS``: every
     ``wire_log`` entry (the draft's ``draft_prefill`` and ``draft_decode``
     ones included, one a draft forward) equal to its ``wire_tables()``
     row, ``wire_summary()["wire"]`` equal to the tables' sum in every
     priced class and to ``comm.LOG`` over the run in every class, the
     streams equal on both ranks. Then the port's first MFU:
     ``model_flops_estimate`` of phase 11's step over its median warm
     step time and the fp32 peak, beside ``count_flops`` of the same step
     run on fake tensors (nothing allocated; counted on the host in a
     thread of this process while the ranks of (a)–(c) run).

Phase 4's AWP monitor goes through ``l2norm_sq`` too (one launch per
monitored leaf per step). Then one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without the last line.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3 (the rate that bounds these
# memory-bound kernels); the card's own power limit is printed beside it.
HBM_BYTES_PER_S = 3.35e12
FC5 = 51_380_224  # AlexNet fc5: 256·7·7 × 4096 weights, the largest leaf
ALEXNET_DIST = 88_936_448  # weights in DIST leaves (all but conv0)
QWEN3_EMBED = 151_936 * 2_048  # qwen3-1.7b's embed (and head): the largest leaf
# one layer's gate/up/down, wq/wo and wk/wv: the per-layer views that
# phases 7, 9 and 11 pack and unpack
QWEN3_LAYER = (2_048 * 6_144, 2_048 * 2_048, 2_048 * 1_024)
SPECIAL_BITS = (
    0x00000000, 0x80000000, 0x3F800000, 0xBF800000, 0x7F800000, 0xFF800000,
    0x00000001, 0x807FFFFF, 0x00400000, 0x7FC00000, 0x7F800001, 0xFFFFFFFF,
    0x7FBADBAD, 0x7F7FFFFF, 0xFF7FFFFF, 0x3FFFFFFF, 0x00FFFFFF, 0xFFFF0000,
)


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


T_START = time.perf_counter()


def say(msg):
    if msg.startswith("phase "):  # each phase's header carries the script's clock
        msg = f"{msg} [t+{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(torch, device):
    import numpy as np

    gen = torch.Generator(device=device).manual_seed(0)
    for n in (1, 127, 32_769, FC5, *QWEN3_LAYER, QWEN3_EMBED):
        yield f"normal n={n}", torch.randn(n, generator=gen, device=device) * 3.0
    special = np.array(SPECIAL_BITS, dtype=np.uint32).view(np.float32)
    yield "special", torch.from_numpy(np.tile(special, 37)).to(device)
    base = torch.randn(32_772, generator=gen, device=device)
    yield "unaligned view n=32768", base[1:32_769]


def word_err(torch, a, b):
    """Largest difference of two tensors over their integer views."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.numel() == 0 or torch.equal(a, b):  # no int64 copies of equal tensors
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(torch, device):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    err = {"bitpack": 0, "bitunpack": 0}
    for label, w in kernel_cases(torch, device):
        for rt in (1, 2, 3):
            planes = bitpack(w, rt)
            want = ref.bitpack_ref(w, rt)
            check(planes.shape == (rt, *w.shape), f"{label} rt={rt}: plane shape")
            err["bitpack"] = max(err["bitpack"], word_err(torch, planes, want))
            back = bitunpack(planes)
            err["bitunpack"] = max(
                err["bitunpack"], word_err(torch, back, ref.bitunpack_ref(planes))
            )
            q = word_err(torch, back, ref.quantize_ref(w, rt))
            torch.cuda.synchronize()
            check(err["bitpack"] == 0, f"{label} rt={rt}: planes differ from bitpack_ref")
            check(err["bitunpack"] == 0, f"{label} rt={rt}: unpack differs from bitunpack_ref")
            check(q == 0, f"{label} rt={rt}: pack∘unpack differs from quantize_ref")
        say(f"   {label}: planes byte-equal, unpack bit-equal (round_to 1..3)")
    return err


def time_cuda(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(torch, fns, reps=2):
    """Device time of one call, with no host dispatch in it: the calls
    ``fns`` (a rotation over input copies, which a caller sizes past the
    50 MB L2 to time it cold) captured ``reps`` times over into one CUDA
    graph and replayed; the mean per call, launch gaps included. The
    eager loop of :func:`time_cuda` measures the host instead wherever a
    call's dispatch takes longer than its kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm, on the capture stream's workspaces
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            for fn in fns:
                fn()
    torch.cuda.synchronize()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


def time_qwen3_packing(torch, device, lengths=(*QWEN3_LAYER, QWEN3_EMBED)):
    """Bitpack and Bitunpack at qwen3-1.7b's per-layer lengths and its
    embed (or ``lengths``), round_to 2 (the oracle:2 format), L2 cold: each
    times a rotation over enough copies that one pass touches >= 100 MB."""
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    gen = torch.Generator(device=device).manual_seed(3)
    for n in lengths:
        nbytes = 6 * n  # 4 B read and 2 B written an element, either way
        copies = max(1, -(-100_000_000 // nbytes))
        ws = [torch.randn(n, generator=gen, device=device) for _ in range(copies)]
        planes = [bitpack(w, 2) for w in ws]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for name, fns in (
            ("bitpack", [lambda w=w: bitpack(w, 2) for w in ws]),
            ("bitunpack", [lambda p=p: bitunpack(p) for p in planes]),
        ):
            ms = time_graph(torch, fns, reps=1 if n >= QWEN3_EMBED // 2 else 2)
            say(f"   {name} n={n} round_to=2, L2 cold ({copies} copies): {ms * 1e3:.1f} us "
                f"({nbytes / ms / 1e6:.0f} GB/s), HBM bound {bound * 1e3:.1f} us "
                f"({bound / ms:.0%} of it)")
        del ws, planes


def time_kernels(torch, device):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    gen = torch.Generator(device=device).manual_seed(1)
    w = torch.randn(FC5, generator=gen, device=device)
    out = {}
    for rt in (1, 2, 3):
        planes = bitpack(w, rt)
        nbytes = (4 + rt) * FC5  # each input read once, each output written once
        row = {
            "bitpack": (time_cuda(torch, lambda: bitpack(w, rt)),
                        time_cuda(torch, lambda: ref.bitpack_ref(w, rt), iters=5)),
            "bitunpack": (time_cuda(torch, lambda: bitunpack(planes)),
                          time_cuda(torch, lambda: ref.bitunpack_ref(planes), iters=5)),
        }
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for name, (ms, plain) in row.items():
            say(
                f"   {name} n={FC5} round_to={rt}: {ms * 1e3:.1f} us "
                f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain * 1e3:.1f} us, "
                f"HBM bound {bound * 1e3:.1f} us ({bound / ms:.0%} of peak)"
            )
            out[(name, rt)] = {"ms": ms, "plain_ms": plain, "bound_ms": bound}
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def build_run(cfg, mesh_cfg, device, seed=0, params=None):
    from repro_torch.models.cnn import init_cnn
    from repro_torch.optim.sgd import init_momentum
    from repro_torch.train.cnn_step import build_cnn_spec_tree, cnn_to_storage

    fresh, metas, groups_info = init_cnn(
        cfg, seed, device=device if params is None else "meta"
    )
    params = fresh if params is None else params
    spec_tree = build_cnn_spec_tree(params, metas, mesh_cfg)
    storage = cnn_to_storage(params, spec_tree, mesh_cfg)
    return storage, init_momentum(storage), spec_tree, groups_info


def train(trainer, storage, mom, data, steps, batch, lr, first_step=0):
    from repro_torch import random as jr

    metrics, data_s = [], 0.0
    for i in range(first_step, first_step + steps):
        t0 = time.perf_counter()
        imgs, labels = data.batch(batch, i)
        data_s += time.perf_counter() - t0
        storage, mom, m = trainer.run_step(
            storage, mom, {"images": imgs, "labels": labels}, lr, jr.PRNGKey(1000 + i)
        )
        metrics.append({k: v.detach().cpu().numpy() for k, v in m.items()})
    return storage, mom, metrics, data_s


AWP_STEPS, ORACLE_STEPS, EVAL_SIZE = 8, 3, 64


def main_path(torch, device, *, cfg=None, batch=64):
    """Full-width AlexNet A²DTWP training through the port's entry points.
    Returns the measurements; raises on a failed check."""
    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.models.cnn import ALEXNET
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.cnn_step import cnn_dist_elems, make_cnn_eval, make_cnn_train_step
    from repro_torch.train.loop import Trainer

    cfg = cfg or ALEXNET
    mesh_cfg = MeshCfg()
    t0 = time.perf_counter()
    storage, mom, spec_tree, groups_info = build_run(cfg, mesh_cfg, device)
    _, num_groups = groups_info
    elems = cnn_dist_elems(spec_tree, groups_info, mesh_cfg)
    data = SyntheticImageNet(num_classes=cfg.num_classes, hw=cfg.in_hw, device=str(device))
    setup_s = time.perf_counter() - t0
    # The paper init, N(0, 0.1²) on every weight, starts full-width AlexNet
    # at a loss of about 5e6: from there lr 0.01 and 1e-4 overflow within
    # two steps, and lr 1e-8 lowers the loss step by step.
    opt = SGDConfig(lr=1e-8 if cfg.paper_init else 0.01, momentum=0.9, weight_decay=5e-4)
    n_dist = sum(
        s.kind == "dist" for leafs in spec_tree["layers"].values() for s in leafs.values()
    )

    def trainer_for(plan):
        def builder(rts):
            return make_cnn_train_step(
                cfg, mesh_cfg, spec_tree, groups_info, opt, plan=plan.with_round_tos(rts)
            )
        return Trainer(builder, num_groups, plan=plan, dist_elems_per_group=elems)

    # AWP forced to widen: every |Δ| is below threshold 1.0, so each group
    # widens after `interval` consecutive observations
    awp_plan = PrecisionPlan.build(
        num_groups, round_to=4, schedule="awp", awp_threshold=1.0, awp_interval=2
    )
    awp = trainer_for(awp_plan)
    oracle_plan = PrecisionPlan.build(num_groups, round_to=2)
    oracle = trainer_for(oracle_plan)
    evaluate = make_cnn_eval(cfg, mesh_cfg, spec_tree, groups_info, plan=oracle_plan)
    val_imgs, val_labels = data.validation(EVAL_SIZE)

    n_monitor = sum(
        s.meta.compress for leafs in spec_tree["layers"].values() for s in leafs.values()
    )

    fc5_start = storage["layers"]["fc5"]["w"].clone() if "fc5" in storage["layers"] else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    zero_counts()
    t_run = time.perf_counter()
    storage, mom, _, awp_data_s = train(awp, storage, mom, data, AWP_STEPS, batch, opt.lr)
    storage, mom, _, orc_data_s = train(
        oracle, storage, mom, data, ORACLE_STEPS, batch, opt.lr, first_step=AWP_STEPS
    )
    top5 = float(evaluate(storage, val_imgs, val_labels))
    run_s = time.perf_counter() - t_run
    got = counts()
    launches = {k: got[k] for k in ("bitpack", "bitunpack", "l2norm_sq")}

    moved = None
    if fc5_start is not None:
        w = storage["layers"]["fc5"]["w"]
        moved = float((w - fc5_start).norm() / fc5_start.norm())
        check(moved > 0.0, "the fc5 master weights did not move")
    records = awp.records + oracle.records
    losses = [r.loss for r in records]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    check(0.0 <= top5 <= 1.0, f"top-5 error {top5} out of range")
    for r, plan in [(r, awp_plan) for r in awp.records] + [(r, oracle_plan) for r in oracle.records]:
        want = plan.with_round_tos(r.round_tos).wire_table(elems, 1)["total"]
        check(r.wire_bytes == want, f"step {r.step}: wire {r.wire_bytes} != plan {want}")
    widened = sum(1 for r in awp.records if r.round_tos[0] < 4)
    packed_steps = widened + ORACLE_STEPS + 1  # + the eval's materialization
    expect = n_dist * packed_steps
    if device.type == "cuda":
        for name in ("bitpack", "bitunpack"):
            check(launches[name] == expect, f"{name}: {launches[name]} launches, "
                                            f"expected {expect}")
        # the AWP monitor: one l2norm_sq per monitored leaf per train step
        want = n_monitor * (AWP_STEPS + ORACLE_STEPS)
        check(launches["l2norm_sq"] == want,
              f"l2norm_sq: {launches['l2norm_sq']} launches, expected {want}")
        step = make_cnn_train_step(cfg, mesh_cfg, spec_tree, groups_info, opt, plan=oracle_plan)
        profile_step(torch, step, storage, mom, data, batch, opt.lr)
    return {
        "elems": elems, "n_dist": n_dist, "n_monitor": n_monitor, "awp": awp, "oracle": oracle,
        "top5": top5, "launches": launches, "setup_s": setup_s,
        "run_s": run_s, "data_s": awp_data_s + orc_data_s, "fc5_moved": moved,
        "lr": opt.lr,
    }


def profile(torch, fn, label, top=10):
    """Kernel time by name over one call of ``fn`` (torch.profiler): device
    busy time is the sum of the CUDA kernels' own durations (one stream,
    so they do not overlap), idle share is the rest of the call's wall.
    Returns ``{kernel name: ms}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    check(busy_ms > 0, f"{label}: the profiler saw no device time")
    say(f"   profile {label}: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms "
        f"({len(rows)} kernel names, {sum(e.count for e in rows)} launches), idle share "
        f"{1 - busy_ms / wall_ms:.1%}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        say(f"   profile: {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")
    return {e.key: e.self_device_time_total / 1e3 for e in rows}


def profile_step(torch, step, storage, mom, data, batch, lr):
    """Profile one warm CNN train step (after one unprofiled warm-up)."""
    from repro_torch import random as jr

    imgs, labels = data.batch(batch, 10_000)
    b = {"images": imgs, "labels": labels}
    float(step(storage, mom, b, lr, jr.PRNGKey(7))[2]["loss"])
    by_name = profile(
        torch, lambda: float(step(storage, mom, b, lr, jr.PRNGKey(8))[2]["loss"]),
        "oracle:2 step",
    )
    packing = sum(ms for k, ms in by_name.items() if "bitpack" in k or "bitunpack" in k)
    monitor = sum(ms for k, ms in by_name.items() if "l2norm" in k)
    say(f"   profile oracle:2 step: bitpack+bitunpack {packing:.3f} ms, l2norm_sq "
        f"{monitor:.3f} ms")


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on a small input
# ---------------------------------------------------------------------------


def reference_check(torch, device):
    """Reduced AlexNet, 4 AWP steps (round_to 1, 1, 2, 3): the card's run
    (CUDA kernels, cuDNN) against the CPU's (plain versions, oneDNN) from
    the same weights. Tolerance rtol 1e-3 on the loss and Σw²: the two
    sum their fp32 convolutions in another order, and a weight that sits
    on a truncation boundary may round to the next format step on one
    side."""
    import numpy as np

    from repro_torch.models.cnn import ALEXNET, init_cnn, reduced_cnn
    from repro_torch.utils.trees import tree_map

    cfg = reduced_cnn(ALEXNET, num_classes=10, in_hw=32)
    cpu_params, _, _ = init_cnn(cfg, 3, device="cpu")
    runs = {}
    for dev in (torch.device("cpu"), device):
        params = tree_map(lambda t: t.clone().to(dev), cpu_params)
        runs[dev.type] = _small_run(torch, dev, cfg, params)
    a, b = runs["cpu"], runs[device.type]
    check(a["round_tos"] == b["round_tos"], "round_to trajectories differ")
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-3)
    np.testing.assert_allclose(b["norms"], a["norms"], rtol=1e-3)
    say(f"   reduced alexnet, 4 awp steps, round_tos {[r[1] for r in a['round_tos']]}: "
        f"losses cpu {np.round(a['losses'], 5).tolist()} gpu {np.round(b['losses'], 5).tolist()}")


def _small_run(torch, device, cfg, params):
    import numpy as np

    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.cnn_step import cnn_dist_elems, make_cnn_train_step
    from repro_torch.train.loop import Trainer

    mesh_cfg = MeshCfg(compress_min_size=256)
    storage, mom, spec_tree, groups_info = build_run(cfg, mesh_cfg, device, params=params)
    plan = PrecisionPlan.build(
        groups_info[1], round_to=4, schedule="awp", awp_threshold=1.0, awp_interval=1
    )
    opt = SGDConfig(lr=0.01, momentum=0.9, weight_decay=5e-4)
    trainer = Trainer(
        lambda rts: make_cnn_train_step(cfg, mesh_cfg, spec_tree, groups_info, opt,
                                        plan=plan.with_round_tos(rts)),
        groups_info[1], plan=plan,
        dist_elems_per_group=cnn_dist_elems(spec_tree, groups_info, mesh_cfg),
    )
    data = SyntheticImageNet(num_classes=cfg.num_classes, hw=cfg.in_hw, noise=0.1,
                             device=str(device))
    _, _, metrics, _ = train(trainer, storage, mom, data, 4, 16, opt.lr)
    return {
        "losses": [r.loss for r in trainer.records],
        "round_tos": [r.round_tos for r in trainer.records],
        "norms": np.stack([m["group_norms_sq"] for m in metrics]),
    }


# ---------------------------------------------------------------------------
# phase 6: the flash prefill kernel against its plain version
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet: 67 TFLOP/s fp32 on the CUDA cores (the kernel
# runs fp32 FMAs, TF32 off), 989 TFLOP/s bf16 on the tensor cores (the
# bound of the same work on bf16 inputs)
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# (B, H, Kv, Sq, Sk, q_offset): qwen3-1.7b's heads (hd 128), at the timed
# lengths, phase 7's prefill lengths (512 at B=1 and 2, 384, 256) and a
# continuation; then the work list's edges: the continuation at B=2 (every
# unit split into pieces), S=1024 (units of 1 to 16 tiles, those above 9
# cut in two), and G=1 and G=4 (units of one head and of four)
FLASH_SHAPES = (
    (1, 16, 8, 128, 128, 0),
    (1, 16, 8, 512, 512, 0),
    (1, 16, 8, 2048, 2048, 0),
    (1, 16, 8, 384, 384, 0),
    (1, 16, 8, 256, 256, 0),
    (1, 16, 8, 128, 512, 384),
    (2, 16, 8, 512, 512, 0),
    (2, 16, 8, 128, 512, 384),
    (1, 16, 8, 1024, 1024, 0),
    (1, 8, 8, 256, 256, 0),
    (1, 32, 8, 192, 320, 128),
)
FLASH_TIMED = (128, 512, 2048)  # Sq = Sk, B = 1, q_offset = 0
FLASH_TOL = 1e-5
# a model rank's heads at tp 2 (phase 14's flash shape), which phase 16 (e)
# also checks and times in bf16
FLASH_TP2 = (1, 8, 4, 512, 512, 0)
# phase 20's groupings at S 512, B 1: qwen2.5-14b's H 40 / Kv 8 (G 5, units
# of Gc = 1 head) and chatglm3-6b's H 32 / Kv 2 (G 16, Gc = 4); phase 22's
# llama-3.2-vision-90b self-attention, H 64 / Kv 8 (G 8)
FLASH_GQA = (("G 5", (1, 40, 8, 512, 512, 0)), ("G 16", (1, 32, 2, 512, 512, 0)),
             ("G 8", (1, 64, 8, 512, 512, 0)))


def flash_bound(B, H, Kv, Sq, Sk, q_offset, hd=128, elem=4, flop_rate=FP32_FLOP_PER_S):
    """Least time for the causal attention these inputs need: the larger
    of the FLOPs of the unmasked (q, k) pairs (2·hd for q·k and 2·hd for
    p·v each) at the peak ``flop_rate`` (fp32's, or bf16's tensor cores
    with ``elem`` 2), and q, k, v and out moved once at the HBM rate, at
    ``elem`` bytes an element. Returns (ms, "operations" or "bytes")."""
    rows = [min(q_offset + r + 1, Sk) for r in range(Sq)]
    flops = 4 * hd * B * H * sum(rows)
    nbytes = elem * hd * (2 * B * H * Sq + 2 * B * Kv * Sk)
    t_ops, t_bytes = flops / flop_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(torch, device):
    """Kernel vs plain version at every FLASH_SHAPES case; times at
    FLASH_TIMED. Returns {Sq: row} with the S = Sq = Sk numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill

    gen = torch.Generator(device=device).manual_seed(6)
    out = {}
    for B, H, Kv, Sq, Sk, off in FLASH_SHAPES:
        q = torch.randn((B, H, Sq, 128), generator=gen, device=device)
        k = torch.randn((B, Kv, Sk, 128), generator=gen, device=device)
        v = torch.randn((B, Kv, Sk, 128), generator=gen, device=device)
        got = flash_prefill(q, k, v, q_offset=off)
        again = flash_prefill(q, k, v, q_offset=off)
        # the plain version's 128-row tiles need Sq and Sk to be multiples
        block = 128 if Sq % 128 == 0 and Sk % 128 == 0 else 64
        want = ref.flash_prefill_ref(q, k, v, q_offset=off, block_q=block, block_k=block)
        err = float((got - want).abs().max())
        torch.cuda.synchronize()
        label = f"B={B} H={H} Kv={Kv} Sq={Sq} Sk={Sk} q_offset={off}"
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash {label}: max |err| {err:.3e} > {FLASH_TOL}")
        check(torch.equal(got, again), f"flash {label}: two calls gave other bits")
        line = f"   flash {label}: max |kernel - plain| {err:.3e}; two calls bit-equal"
        if B == 1 and H == 16 and Sq == Sk and off == 0 and Sq in FLASH_TIMED:
            eager = time_cuda(torch, lambda: flash_prefill(q, k, v))
            ms = time_graph(torch, [lambda: flash_prefill(q, k, v)], reps=10)
            plain = time_cuda(torch, lambda: ref.flash_prefill_ref(q, k, v),
                              iters=5)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True)
            lib_eager = time_cuda(torch, sdpa)
            lib = time_graph(torch, [sdpa], reps=10)
            bound, by = flash_bound(B, H, Kv, Sq, Sk, off)
            out[Sq] = {"ms": ms, "eager_ms": eager, "plain_ms": plain, "library_ms": lib,
                       "library_eager_ms": lib_eager, "bound_ms": bound, "bound_by": by,
                       "max_abs_err": err}
            line += (f"; kernel {ms * 1e3:.1f} us in a CUDA graph ({eager * 1e3:.1f} us "
                     f"eager), plain {plain * 1e3:.1f} us, sdpa {lib * 1e3:.1f} us in a graph "
                     f"({lib_eager * 1e3:.1f} us eager), bound {bound * 1e3:.1f} us ({by}, "
                     f"{bound / ms:.0%} of it)")
        say(line)
    for label, (B, H, Kv, Sq, Sk, off) in FLASH_GQA:
        q = torch.randn((B, H, Sq, 128), generator=gen, device=device)
        k = torch.randn((B, Kv, Sk, 128), generator=gen, device=device)
        v = torch.randn((B, Kv, Sk, 128), generator=gen, device=device)
        got = flash_prefill(q, k, v, q_offset=off)
        err = float((got - ref.flash_prefill_ref(q, k, v, q_offset=off)).abs().max())
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash {label} (H={H} Kv={Kv}): max |err| {err:.3e} > {FLASH_TOL}")
        check(torch.equal(got, flash_prefill(q, k, v, q_offset=off)),
              f"flash {label}: two calls gave other bits")
        ms = time_graph(torch, [lambda: flash_prefill(q, k, v)], reps=10)
        plain = time_cuda(torch, lambda: ref.flash_prefill_ref(q, k, v), iters=5)
        lib = time_graph(torch, [lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)], reps=10)
        bound, by = flash_bound(B, H, Kv, Sq, Sk, off)
        out[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                      "bound_by": by, "max_abs_err": err}
        say(f"   flash {label} B={B} H={H} Kv={Kv} Sq={Sq} Sk={Sk}: max |kernel - plain| "
            f"{err:.3e}; kernel {ms * 1e3:.1f} us in a CUDA graph, plain {plain * 1e3:.1f} us, "
            f"sdpa {lib * 1e3:.1f} us in a graph, bound {bound * 1e3:.1f} us ({by}, "
            f"{bound / ms:.0%} of it)")
    check_flash_rows(torch, device, gen)
    return out


# (H, Kv, Sq, Sk, q_offset) whose work list the batch used to change: the
# engine's and the static run's 512 and 256-token prefills, a continuation
FLASH_ROW_SHAPES = ((16, 8, 512, 512, 0), (16, 8, 256, 256, 0), (16, 8, 128, 512, 384))


def check_flash_rows(torch, device, gen, dtype=None):
    """A row's output is bit-equal alone and inside batches of 2 and 4 (fp32
    unit normals, or ``dtype``'s rounding of them)."""
    from repro_torch.kernels.flash_prefill import flash_prefill

    dtype = dtype or torch.float32
    for H, Kv, Sq, Sk, off in FLASH_ROW_SHAPES:
        q, k, v = (torch.randn(s, generator=gen, device=device).to(dtype) for s in
                   ((4, H, Sq, 128), (4, Kv, Sk, 128), (4, Kv, Sk, 128)))
        alone = [flash_prefill(q[b:b + 1], k[b:b + 1], v[b:b + 1], q_offset=off)
                 for b in range(4)]
        for B in (2, 4):
            batch = flash_prefill(q[:B], k[:B], v[:B], q_offset=off)
            for b in range(B):
                check(torch.equal(batch[b], alone[b][0]),
                      f"{dtype} flash H={H} Sq={Sq} Sk={Sk} q_offset={off}: row {b} differs "
                      f"alone and in a batch of {B}")
        say(f"   {str(dtype)[6:]} flash H={H} Kv={Kv} Sq={Sq} Sk={Sk} q_offset={off}: each row "
            "bit-equal alone and in batches of 2 and 4")


# ---------------------------------------------------------------------------
# phase 7: full-width qwen3-1.7b served through the continuous-batching engine
# ---------------------------------------------------------------------------

SERVE_LENS, SERVE_GEN, SERVE_SLOTS = (512, 512, 384, 256, 200), 16, 2


def kernel_layers(cfg):
    """Layers whose attention can take the CUDA kernels (flash prefill,
    paged decode): plain ``attn`` blocks without a window (none in xLSTM;
    recurrentgemma's ``local`` blocks always carry a window)."""
    if cfg.sliding_window:
        return 0
    return cfg.num_layers // len(cfg.pattern) * cfg.pattern.count("attn")


def _wrappers():
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.l2norm import l2norm_sq
    from repro_torch.kernels.paged_attend import paged_attend

    return {"bitpack": bitpack, "bitunpack": bitunpack, "flash_prefill": flash_prefill,
            "paged_attend": paged_attend, "l2norm_sq": l2norm_sq}


def counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def watch_flash(torch, seen):
    """Route the model's flash calls through a recorder that keeps the
    inputs and output of the first launch at each distinct (q shape, k
    shape, q_offset) in ``seen``; :func:`check_seen_flash` then holds them
    to the plain version. Only copies are taken inside the run, so its
    timings keep the kernel's pace. Returns the undo function."""
    from repro_torch.models import attention

    kernel = attention.flash_prefill

    def recorded(q, k, v, *, q_offset=0):
        out = kernel(q, k, v, q_offset=q_offset)
        key = (tuple(q.shape), tuple(k.shape), int(q_offset))
        if key not in seen:
            seen[key] = {"inputs": (q.clone(), k.clone(), v.clone()), "out": out.clone()}
        return out

    attention.flash_prefill = recorded
    return lambda: setattr(attention, "flash_prefill", kernel)


def check_seen_flash(seen):
    """The plain version on each recorded launch's own inputs: the main
    path's real shapes and data, within FLASH_TOL."""
    from repro_torch.kernels import ref

    for key, rec in seen.items():
        if "max_abs_err" in rec:
            continue
        (q, k, v), (_, _, off) = rec.pop("inputs"), key
        err = float((rec.pop("out") - ref.flash_prefill_ref(q, k, v, q_offset=off)).abs().max())
        rec["max_abs_err"] = err
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash on the main path, q {key[0]} k {key[1]} q_offset {off}: "
              f"max |err| {err:.3e} > {FLASH_TOL}")
        say(f"   flash on the main path, q {key[0]} k {key[1]} q_offset {off}: "
            f"max |kernel - plain| {err:.3e}")


def instrument(engine, timings):
    """Host-clock each admission and decode tick of ``engine`` (both end in
    the d2h copy of the sampled ids, which waits for the device), hold
    every logit it samples from to be finite and keep the first logits it
    samples from (the first admission's) on the host."""
    import torch

    admit, tick, sample = engine.admit, engine.decode_tick, engine._sample

    def timed_admit(req):
        t0 = time.perf_counter()
        admit(req)
        timings["admit"].append((len(req.prompt_ids), time.perf_counter() - t0))

    def timed_tick():
        active = engine.active_slots
        t0 = time.perf_counter()
        tick()
        if active:
            timings["decode"].append(time.perf_counter() - t0)

    def checked_sample(logits, *sampling):
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        timings.setdefault("first_logits", logits.detach().cpu())
        return sample(logits, *sampling)

    def checked_verify_sample(logits):
        check(bool(torch.isfinite(logits).all()), "non-finite verify logits")
        return verify_sample(logits)

    verify_sample = engine._verify_sample
    engine.admit, engine.decode_tick, engine._sample = timed_admit, timed_tick, checked_sample
    engine._verify_sample = checked_verify_sample


def top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, req, mesh=None, values=False):
    """Greedy decode of one request (batch 1) with each step's top-2 logit
    gap: what a diverging stream is checked against (on a mesh, every rank
    calls this alike). ``values``: also each step's top logit."""
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    S, dev = len(req.prompt_ids), storage["embed"].device
    pre = make_prefill_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan,
                            cache_capacity=S + req.max_new)
    dec = make_decode_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan)
    logits, caches = pre(storage, {"tokens": torch.tensor([req.prompt_ids], device=dev)})
    toks, gaps, tops = [], [], []
    for i in range(req.max_new):
        top = torch.topk(logits[0, -1, : cfg.vocab_size].float(), 2)
        toks.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))
        tops.append(float(top.values[0]))
        if i + 1 < req.max_new:
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
            pos = torch.tensor(S + i, dtype=torch.int32, device=dev)
            logits, caches = dec(storage, caches, {"tokens": tok, "pos": pos})
    return (toks, gaps, tops) if values else (toks, gaps)


def serve_path(torch, device, *, cfg=None, lens=SERVE_LENS, gen=SERVE_GEN):
    """Full-width qwen3-1.7b through the serve twin's functions. Returns
    the measurements; raises on a failed check. Launch counts, the
    memory peak and the profile are read on a card only, so that
    ``serve_path(torch, torch.device("cpu"), cfg=reduced(...), lens=...)``
    rehearses the phase on the CPU with the plain versions."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.spec import DIST
    from repro_torch.launch.serve import build_requests, check_wire, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine, generate_static
    from repro_torch.utils.trees import tree_leaves

    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    requests = build_requests(lens, gen, cfg.vocab_size)
    cap = max(lens) + gen
    n_params = sum(x.numel() for x in [storage[k] for k in storage if k != "groups"]
                   + [x for g in storage["groups"] for x in tree_leaves(g)])
    # materializations per forward: each stacked DIST leaf once per layer,
    # each top-level DIST leaf once; placement packs each leaf once, whole
    per_forward = sum(s.reps for g in spec_tree["groups"] for s in tree_leaves(g)
                      if s.kind == DIST) + sum(
        1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST)
    per_place = sum(1 for g in spec_tree["groups"] for s in tree_leaves(g)
                    if s.kind == DIST) + sum(
        1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST)
    # the reference's viability rule for these prompts (device, hd, length)
    viable = [on_card and cfg.head_dim % 128 == 0 and S % 128 == 0 for S in lens]
    say(f"   {cfg.name}: {n_params:,} fp32 parameters ({n_params * 4 / 1e9:.2f} GB), "
        f"init {setup_s:.2f} s; {per_forward} DIST materializations per forward, "
        f"{per_place} per placement")

    launches, out, seen = {}, {}, {}
    unwatch = watch_flash(torch, seen)
    zero_counts()
    t0 = time.perf_counter()
    static = generate_static(cfg, mesh_cfg, None, spec_tree, storage, requests, plan=plan)
    static_s = time.perf_counter() - t0
    launches["static"] = counts()
    check_seen_flash(seen)
    groups = sorted(set(lens))
    forwards = len(groups) + len(groups) * (gen - 1)
    want = {"flash_prefill": cfg.num_layers * sum(v for S, v in dict(zip(lens, viable)).items()),
            "bitpack": per_forward * forwards * on_card, "paged_attend": 0, "l2norm_sq": 0}
    want["bitunpack"] = want["bitpack"]
    check(launches["static"] == want, f"static: launches {launches['static']}, expected {want}")
    say(f"   static reference: {len(groups)} groups in {static_s:.2f} s; launches "
        f"{launches['static']}")

    for ws in (False, True):
        label = "engine, weight-stationary" if ws else "engine"
        timings = {"admit": [], "decode": []}
        zero_counts()
        sync()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                             max_slots=SERVE_SLOTS, cache_capacity=cap,
                             weight_stationary=ws)
        instrument(engine, timings)
        results = engine.run(requests)
        wall = time.perf_counter() - t0
        got = counts()
        launches[label] = got
        check_seen_flash(seen)
        summary = engine.wire_summary()
        analytic = check_wire(engine, plan, requests)
        diverged = [r for r in requests if results[r.rid].tokens != static[r.rid]]
        for r in diverged:
            toks, gaps = top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, r)
            t = next(i for i, (a, b) in enumerate(zip(results[r.rid].tokens, static[r.rid]))
                     if a != b)
            say(f"   DIVERGED request {r.rid} (prompt {len(r.prompt_ids)}) at step {t}: "
                f"engine {results[r.rid].tokens[t]}, static {static[r.rid][t]}, batch-1 "
                f"greedy {toks[t]}, top-2 logit gap {gaps[t]:.3e}")
        check(not diverged, f"{label}: streams of {[r.rid for r in diverged]} differ "
                            "from the static reference")
        admissions = summary["admissions"]
        packed = admissions * per_forward + (per_place if ws else
                                             summary["decode_steps"] * per_forward)
        want = {"flash_prefill": cfg.num_layers * sum(viable), "bitpack": packed * on_card,
                "bitunpack": packed * on_card, "paged_attend": 0, "l2norm_sq": 0}
        check(got == want, f"{label}: launches {got}, expected {want}")
        new_tokens = sum(len(r.tokens) for r in results.values())
        dec = sorted(timings["decode"])
        by_len = {}
        for S, t in timings["admit"]:
            by_len.setdefault(S, []).append(t * 1e3)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        say(f"   {label}: {summary['steps']} steps ({summary['decode_steps']} decode, "
            f"{admissions} admissions) in {wall:.2f} s, {new_tokens} tokens, "
            f"{new_tokens / wall:.1f} tokens/s; streams equal to the static reference")
        say(f"   {label}: admission (prefill + insert + first id) ms by prompt length "
            f"{ {S: [round(x, 2) for x in v] for S, v in sorted(by_len.items())} }")
        say(f"   {label}: decode ms/step median {dec[len(dec) // 2] * 1e3:.2f} "
            f"(min {dec[0] * 1e3:.2f}, max {dec[-1] * 1e3:.2f}, {len(dec)} steps)")
        say(f"   {label}: host_device {summary['host_device']} B == serve_host_device_bytes "
            f"{analytic['total']} B at {summary['token_width']} B/id; launches {got}; "
            f"memory peak {peak / 2**30:.2f} GiB")
        out[label] = {"wall_s": wall, "tokens": new_tokens, "decode_ms": dec[len(dec) // 2] * 1e3,
                      "admit_ms": by_len, "peak": peak, "engine": engine,
                      "streams": {k: r.tokens for k, r in results.items()},
                      "first_logits": timings["first_logits"]}

    unwatch()
    # every prefill shape the kernel took was held to the plain version
    want_shapes = {(b, S) for S, v in zip(lens, viable) if v for b in (1, lens.count(S))}
    got_shapes = {(key[0][0], key[0][2]) for key in seen}
    check(got_shapes == want_shapes,
          f"flash shapes held to the plain version {sorted(got_shapes)}, expected "
          f"{sorted(want_shapes)}")
    if on_card:
        engine = out["engine"]["engine"]  # the non-stationary engine, warm
        engine.begin_stream()
        first, second = requests[0], requests[1]  # both of the longest length
        engine.admit(first)
        by_name = profile(torch, lambda: engine.admit(second),
                          f"admission of a {len(second.prompt_ids)}-token prompt")
        say(f"   profile: flash_prefill {sum(ms for k, ms in by_name.items() if 'flash' in k):.3f}"
            " ms of the admission")
        profile(torch, engine.decode_tick, "decode step (2 slots)")
    for o in out.values():
        del o["engine"]
    return {"launches": launches, "runs": out, "static_s": static_s,
            "flash_err": max((r["max_abs_err"] for r in seen.values()), default=0.0),
            # what phase 9 reuses: the weights are built once
            "cfg": cfg, "setup": (mesh_cfg, spec_tree, storage), "plan": plan,
            "requests": requests,
            "static": static, "per_forward": per_forward}


# ---------------------------------------------------------------------------
# phase 8: the paged decode kernel against its plain version
# ---------------------------------------------------------------------------

# Another summation order than the plain version's (per-row dots, shuffle
# trees) in fp32 on O(1) outputs: on an H100 the kernel differed by at most
# 6.0e-7 on unit normals and 1.2e-6 on the main path's own inputs.
PAGED_TOL = 2e-6
# (B, Kv, G, page, table width, pool rows, lengths): phase 9's shape
# (qwen3-1.7b's heads, page 64, 9-page table, 18 pages + the trash row) at
# the lengths that cross page edges, a slot of length 0, and the largest;
# then page 8 with G = 1 and 4, so that the fold h = kv * G + g is held;
# then the split's edges: one-page splits at lengths on their edges and the
# full table, a table wider than the live pages (splits past them empty),
# and B=16 at 64 pages at and across a split's edge; then pages of 192 and
# 256 rows (walked in 32-row chunks of one pool row), at and across a page
# edge
PAGED_CASES = (
    (2, 8, 2, 64, 9, 19, (528, 0)),
    (2, 8, 2, 64, 9, 19, (1, 63)),
    (2, 8, 2, 64, 9, 19, (64, 65)),
    (2, 8, 2, 64, 9, 19, (200, 528)),
    (3, 8, 1, 8, 66, 199, (528, 9, 0)),
    (3, 8, 4, 8, 66, 199, (8, 527, 1)),
    (2, 8, 2, 64, 9, 19, (576, 128)),
    (3, 8, 2, 64, 20, 61, (65, 129, 0)),
    (16, 8, 2, 64, 64, 1025, (2048, 2049) * 8),
    (2, 8, 2, 192, 4, 9, (768, 193)),
    (2, 8, 2, 192, 4, 9, (192, 1)),
    (2, 8, 2, 256, 3, 7, (768, 257)),
    (2, 8, 2, 256, 3, 7, (256, 700)),
)
# input copies a cold-L2 timing rotates through: 10 x the main path's
# 10 MB of pools is twice the 50 MB L2
COLD_COPIES = 10
PAGED_TIMED = (
    ("main path", (2, 8, 2, 64, 9, 19, (528, 528))),
    ("4096 tokens", (16, 8, 2, 64, 64, 1025, (4096,) * 16)),
    # phase 20's groupings at the decode shape: qwen2.5-14b's Kv 8, G 5 and
    # chatglm3-6b's Kv 2, G 16 (the kernel's MAX_G)
    ("G 5", (2, 8, 5, 64, 9, 19, (528, 528))),
    ("G 16", (2, 2, 16, 64, 9, 19, (528, 528))),
)


def paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths):
    """Unit normals; each slot's live pages at distinct random pool rows
    (a permuted table), its unused entries at the trash row ``P - 1``."""
    q = torch.randn((B, Kv, G, 128), generator=gen, device=device)
    k_pool = torch.randn((P, page, Kv, 128), generator=gen, device=device)
    v_pool = torch.randn((P, page, Kv, 128), generator=gen, device=device)
    rows = torch.randperm(P - 1, generator=gen, device=device)[: B * width].reshape(B, width)
    table = torch.full((B, width), P - 1, dtype=torch.int32, device=device)
    for b, n in enumerate(lengths):
        live = -(-n // page) if n else width  # a slot of length 0 walks them all
        table[b, :live] = rows[b, :live].to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, table, lens


def paged_bound(B, Kv, G, page, width, lengths, hd=128):
    """Least time for these inputs: K and V of the rows they attend (a slot
    of length L >= 1 needs L rows, one of length 0 all ``width * page``),
    q read once and out written once, at the HBM rate; the G/2 FLOPs a
    byte are far below the fp32 ridge. Returns ms."""
    rows = sum(min(n, width * page) if n else width * page for n in lengths)
    nbytes = 4 * hd * (2 * Kv * rows + 2 * B * Kv * G)
    return nbytes / HBM_BYTES_PER_S * 1e3


def gather_sdpa(torch, q, k_pool, v_pool, table, lengths):
    """The library yardstick: ``k_pool[table]`` gather, then fp32
    ``scaled_dot_product_attention`` with a length mask (two calls; no
    single PyTorch call reads through a page table). Length >= 1 only."""
    import torch.nn.functional as F

    B, Kv, G, hd = q.shape
    idx = table.to(torch.int64)
    k = k_pool[idx].reshape(B, -1, Kv, hd).transpose(1, 2)
    v = v_pool[idx].reshape(B, -1, Kv, hd).transpose(1, 2)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < lengths[:, None].to(torch.int64)
    out = F.scaled_dot_product_attention(q.reshape(B, Kv * G, 1, hd), k, v,
                                         attn_mask=mask[:, None, None, :], enable_gqa=True)
    return out.reshape(B, Kv, G, hd)


def check_paged(torch, device):
    """Kernel vs plain version at every PAGED_CASES case (and on a permuted
    pool, where the output must not change); times at PAGED_TIMED. Returns
    {label: row}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attend import paged_attend

    gen = torch.Generator(device=device).manual_seed(8)
    err = 0.0
    for B, Kv, G, page, width, P, lengths in PAGED_CASES:
        args = paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths)
        got = paged_attend(*args)
        again = paged_attend(*args)
        e = float((got - ref.paged_attend_ref(*args)).abs().max())
        q, kp, vp, table, lens = args
        perm = torch.randperm(P, generator=gen, device=device)
        inv = torch.argsort(perm).to(torch.int32)
        moved = paged_attend(q, kp[perm], vp[perm], inv[table.to(torch.int64)], lens)
        torch.cuda.synchronize()
        label = f"B={B} Kv={Kv} G={G} page={page} width={width} lengths={list(lengths)}"
        check(math.isfinite(e) and e <= PAGED_TOL,
              f"paged_attend {label}: max |err| {e:.3e} > {PAGED_TOL}")
        check(torch.equal(moved, got), f"paged_attend {label}: a permuted pool changed the output")
        check(torch.equal(again, got), f"paged_attend {label}: two calls gave other bits")
        err = max(err, e)
        say(f"   paged_attend {label}: max |kernel - plain| {e:.3e}; permuted pool: equal; "
            "two calls bit-equal")
    out = {}
    for label, (B, Kv, G, page, width, P, lengths) in PAGED_TIMED:
        args = paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths)
        got = paged_attend(*args)
        e = float((got - ref.paged_attend_ref(*args)).abs().max())
        lib_err = float((gather_sdpa(torch, *args) - got).abs().max())
        check(math.isfinite(e) and e <= PAGED_TOL, f"paged_attend {label}: max |err| {e:.3e}")
        err = max(err, e)
        eager = time_cuda(torch, lambda: paged_attend(*args))
        warm = time_graph(torch, [lambda: paged_attend(*args)], reps=10)
        # cold: a rotation over copies of the pools (the 4096-token pools,
        # 537 MB, are cold by themselves)
        copies = [args] + [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                           for _ in range(COLD_COPIES - 1 if P < 100 else 0)]
        cold = time_graph(torch, [lambda a=a: paged_attend(*a) for a in copies])
        del copies
        plain = time_cuda(torch, lambda: ref.paged_attend_ref(*args), iters=5)
        lib = time_cuda(torch, lambda: gather_sdpa(torch, *args))
        bound = paged_bound(B, Kv, G, page, width, lengths)
        out[label] = {"ms": cold, "warm_ms": warm, "eager_ms": eager, "plain_ms": plain,
                      "gather_sdpa_ms": lib, "bound_ms": bound, "max_abs_err": e}
        say(f"   paged_attend {label} (B={B} Kv={Kv} G={G}, {width} pages of {page}, lengths "
            f"{lengths[0]}): kernel in a CUDA graph {cold * 1e3:.1f} us with the L2 cold, "
            f"{warm * 1e3:.1f} us warm ({eager * 1e3:.1f} us eager), plain {plain * 1e3:.1f} "
            f"us, gather+sdpa {lib * 1e3:.1f} us (within {lib_err:.1e} of the kernel), bound "
            f"{bound * 1e3:.1f} us (bytes, {bound / cold:.0%} of it cold); max |err| {e:.3e}")
    out["max_abs_err"] = err
    check_paged_rows(torch, device, gen)
    return out


def check_paged_rows(torch, device, gen):
    """A slot's output is bit-equal alone, inside batches of 2 and 4, and
    inside a table twice as wide (the extra entries at the trash row), at
    page 64 and page 256."""
    from repro_torch.kernels.paged_attend import paged_attend

    for page in (64, 256):
        width = 2048 // page
        q, kp, vp, table, lens = paged_inputs(torch, device, gen, 4, 8, 2, page, width,
                                              4 * width + 1, (1500, 700, 2048, 65))
        alone = [paged_attend(q[b:b + 1], kp, vp, table[b:b + 1], lens[b:b + 1])
                 for b in range(4)]
        trash = torch.full_like(table, kp.shape[0] - 1)
        runs = [(f"a batch of {B}", paged_attend(q[:B], kp, vp, table[:B], lens[:B]))
                for B in (2, 4)]
        runs.append(("a table twice as wide",
                     paged_attend(q, kp, vp, torch.cat([table, trash], 1).contiguous(), lens)))
        for what, out in runs:
            for b in range(out.shape[0]):
                check(torch.equal(out[b], alone[b][0]),
                      f"paged_attend page={page}: slot {b} differs alone and in {what}")
        say(f"   paged_attend page={page}, {width}-page table, lengths 1500/700/2048/65: each "
            "slot bit-equal alone, in batches of 2 and 4 and in a table twice as wide")


# ---------------------------------------------------------------------------
# phase 9: full-width qwen3-1.7b served through the paged engine
# ---------------------------------------------------------------------------

PAGE = 64
# a 256-token (4-page) shared prefix plus tails of 64, 100 and 128 tokens
SHARED_PREFIX, SHARED_TAILS, SHARED_CAPACITY = 256, (64, 100, 128), 400
# a shared-prefix stream may leave the static reference only where the
# reference's top-2 logits are this close (the card test's FULL_TOL): the
# shared pages hold bits the 320-token prefill (attend_tiled) wrote, not
# the ones the slot's own prefill (flash) would have
NEAR_TIE = 1e-3


def watch_paged(torch, seen, every):
    """Route the model's paged_attend calls through a recorder that keeps
    copies of the inputs and output of the first launch at each distinct
    shape and of every ``every``-th launch after it (with ``every`` a
    multiple of the layer count, layer 0 of every few decode steps, so the
    lengths a run reaches); :func:`check_seen_paged` holds them to the
    plain version. Returns the undo function."""
    from repro_torch.models import attention

    kernel, calls = attention.paged_attend, [0]

    def recorded(q, k_pool, v_pool, page_table, lengths):
        out = kernel(q, k_pool, v_pool, page_table, lengths)
        key = tuple(tuple(t.shape) for t in (q, k_pool, page_table))
        if key not in {k for k, _ in seen} or calls[0] % every == 0:
            seen.append((key, {"inputs": tuple(t.clone() for t in
                                               (q, k_pool, v_pool, page_table, lengths)),
                               "out": out.clone()}))
        calls[0] += 1
        return out

    attention.paged_attend = recorded
    return lambda: setattr(attention, "paged_attend", kernel)


def check_seen_paged(seen):
    """The plain version on each recorded launch's own inputs, within
    PAGED_TOL; returns the largest error."""
    from repro_torch.kernels import ref

    err, shapes = 0.0, set()
    for key, rec in seen:
        if "max_abs_err" not in rec:
            inputs = rec.pop("inputs")
            rec["max_abs_err"] = float((rec.pop("out") - ref.paged_attend_ref(*inputs))
                                       .abs().max())
            check(math.isfinite(rec["max_abs_err"]) and rec["max_abs_err"] <= PAGED_TOL,
                  f"paged_attend on the main path, shapes {key}: max |err| "
                  f"{rec['max_abs_err']:.3e} > {PAGED_TOL}")
        err = max(err, rec["max_abs_err"])
        shapes.add(key)
    say(f"   paged_attend on the main path: {len(seen)} launches at shapes (q, pool, table) "
        f"{sorted(shapes)} held to the plain version, max |kernel - plain| {err:.3e}")
    return err


def report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, r, got, want):
    """Print where a stream left the reference and the reference's batch-1
    top-2 logit gap there; returns that gap."""
    t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    toks, gaps = top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, r)
    say(f"   DIVERGED request {r.rid} (prompt {len(r.prompt_ids)}) at step {t}: "
        f"paged {got[t]}, reference {want[t]}, batch-1 greedy {toks[t]}, "
        f"top-2 logit gap {gaps[t]:.3e}")
    return gaps[t]


def paged_path(torch, device, phase7, *, page=PAGE, shared=SHARED_PREFIX,
               tails=SHARED_TAILS, shared_cap=SHARED_CAPACITY):
    """Full-width qwen3-1.7b through ``ServeEngine(paged=True)`` on phase
    7's weights (``phase7``, :func:`serve_path`'s result). Two runs: phase
    7's requests, held to phase 7's static and contiguous-engine streams
    exactly; and a shared-prefix run whose three requests are resident at
    once, held to ``serve_paged_kv_bytes`` and to ``generate_static`` (a
    divergence passes only at a reference top-2 gap below ``NEAR_TIE``:
    the shared pages hold the first writer's bits). Returns the
    measurements; raises on a failed check. Launch counts, the memory peak
    and the profile are read on a card only, so the phase rehearses on the
    CPU at a reduced config with a smaller ``page``, ``shared`` and
    ``tails``."""
    from repro_torch.launch.serve import build_requests, check_wire
    from repro_torch.roofline.analysis import serve_paged_kv_bytes
    from repro_torch.serve.engine import ServeEngine, generate_static

    mesh_cfg, spec_tree, storage = phase7["setup"]
    plan, per_forward = phase7["plan"], phase7["per_forward"]
    cfg = phase7["cfg"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gen = phase7["requests"][0].max_new
    flash_ok = on_card and cfg.head_dim % 128 == 0
    out, seen = {}, []
    gc.collect()  # phase 7's engines (reference cycles through instrument())
    # layer 0 of every 8th decode step: ~10 MB of copies each
    unwatch = watch_paged(torch, seen, 8 * cfg.num_layers)

    def run(label, requests, cap, slots, static):
        timings = {"admit": [], "decode": []}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        sync()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                             max_slots=slots, cache_capacity=cap, paged=True, page_size=page)
        instrument(engine, timings)
        results = engine.run(requests)  # finish() audits the pages
        wall = time.perf_counter() - t0
        got = counts()
        summary = engine.wire_summary()
        analytic = check_wire(engine, plan, requests)
        check(summary["page_table_entries"] == slots * -(-cap // page),
              f"{label}: {summary['page_table_entries']} page-table entries")
        audit = engine.pages.audit()
        check(audit["live"] == 0 and audit["allocs"] == audit["releases"],
              f"{label}: page audit {audit}")
        buckets = [-(-len(r.prompt_ids) // page) * page for r in requests]
        misses = len(set(buckets))
        check((summary["prefill_misses"], summary["prefill_hits"]) ==
              (misses, len(buckets) - misses),
              f"{label}: prefill buckets {summary['prefill_misses']} first seen, "
              f"{summary['prefill_hits']} seen before; expected {misses}")
        steps = summary["decode_steps"]
        packed = (summary["admissions"] + steps) * per_forward * on_card
        want = {"flash_prefill": cfg.num_layers * sum(flash_ok and S % 128 == 0 for S in buckets),
                "paged_attend": cfg.num_layers * steps * on_card,
                "bitpack": packed, "bitunpack": packed, "l2norm_sq": 0}
        check(got == want, f"{label}: launches {got}, expected {want}")
        new_tokens = sum(len(r.tokens) for r in results.values())
        dec = sorted(timings["decode"])
        by_len = {}
        for S, t in timings["admit"]:
            by_len.setdefault(S, []).append(t * 1e3)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        say(f"   {label}: {summary['steps']} steps ({steps} decode, "
            f"{summary['admissions']} admissions) in {wall:.2f} s, {new_tokens} tokens, "
            f"{new_tokens / wall:.1f} tokens/s")
        say(f"   {label}: admission (pad + prefill + page insert + first id) ms by prompt "
            f"length { {S: [round(x, 2) for x in v] for S, v in sorted(by_len.items())} }")
        say(f"   {label}: decode ms/step median {dec[len(dec) // 2] * 1e3:.2f} "
            f"(min {dec[0] * 1e3:.2f}, max {dec[-1] * 1e3:.2f}, {len(dec)} steps)")
        say(f"   {label}: host_device {summary['host_device']} B (page table "
            f"{summary['page_table']} B) == serve_host_device_bytes {analytic['total']} B; "
            f"buckets {summary['prefill_misses']} first seen, {summary['prefill_hits']} seen "
            f"before; launches {got}; memory peak {peak / 2**30:.2f} GiB")
        res = engine.kv_residency()
        say(f"   {label}: page audit {audit}; peak {res['pages_peak']} pages of "
            f"{res['bytes_per_page']} B ({res['kv_bytes_peak'] / 1e6:.1f} MB), pool "
            f"{(engine.num_pages + 1) * res['bytes_per_page'] / 1e6:.1f} MB")
        out[label] = {"wall_s": wall, "tokens": new_tokens, "decode_ms": dec[len(dec) // 2] * 1e3,
                      "admit_ms": by_len, "peak": peak, "launches": got, "residency": res}
        streams = {k: r.tokens for k, r in results.items()}
        diverged = [r for r in requests if streams[r.rid] != static[r.rid]]
        return engine, streams, diverged

    # run 1: phase 7's requests, 2 slots, capacity 512 + 16
    requests = phase7["requests"]
    cap = max(len(r.prompt_ids) for r in requests) + gen
    engine, streams, diverged = run("paged engine", requests, cap, SERVE_SLOTS,
                                    phase7["static"])
    for r in diverged:
        report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                          streams[r.rid], phase7["static"][r.rid])
    check(not diverged, f"paged engine: streams of {[r.rid for r in diverged]} differ from "
                        "the static reference")
    contiguous = phase7["runs"]["engine"]["streams"]
    check(streams == contiguous, "paged engine: streams differ from the contiguous engine's")
    say("   paged engine: streams equal to the static reference and the contiguous engine")

    # run 2: the shared prefix, every request resident at once
    sreqs = build_requests(tails, gen, cfg.vocab_size, shared_prefix=shared)
    t0 = time.perf_counter()
    sstatic = generate_static(cfg, mesh_cfg, None, spec_tree, storage, sreqs, plan=plan)
    say(f"   static reference for the shared-prefix requests (prompts "
        f"{[len(r.prompt_ids) for r in sreqs]}): {time.perf_counter() - t0:.2f} s")
    _, sstreams, sdiverged = run("shared-prefix engine", sreqs, shared_cap, len(sreqs), sstatic)
    for r in sdiverged:
        gap = report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                                sstreams[r.rid], sstatic[r.rid])
        check(gap < NEAR_TIE, f"shared-prefix engine: request {r.rid} diverged at a top-2 "
                              f"gap of {gap:.3e} >= {NEAR_TIE}")
    analytic = serve_paged_kv_bytes(cfg, page_size=page,
                                    requests=[(len(r.prompt_ids), gen) for r in sreqs],
                                    shared_prefix_len=shared)
    res = out["shared-prefix engine"]["residency"]
    check((res["pages_peak"], res["bytes_per_page"]) ==
          (analytic["pages"], analytic["bytes_per_page"]),
          f"shared-prefix engine: peak {res['pages_peak']} pages of {res['bytes_per_page']} B, "
          f"serve_paged_kv_bytes {analytic}")
    say(f"   shared-prefix engine: peak {res['pages_peak']} pages == serve_paged_kv_bytes "
        f"({analytic['shared_pages']} shared + {analytic['private_pages']} private, "
        f"{analytic['kv_bytes_resident']} B); {len(sreqs) - len(sdiverged)} of {len(sreqs)} "
        "streams equal to the static reference")
    unwatch()
    if on_card:
        check(seen, "no paged_attend launch was recorded")
        engine.begin_stream()  # run 1's engine, warm, without the recorder
        for r in requests[:SERVE_SLOTS]:
            engine.admit(r)
        engine.decode_tick()
        by_name = profile(torch, engine.decode_tick, f"paged decode step ({SERVE_SLOTS} slots)")
        say(f"   profile: paged_attend "
            f"{sum(ms for k, ms in by_name.items() if 'paged_attend' in k):.3f} ms of the step")
    err = check_seen_paged(seen) if seen else 0.0
    launches = {k: sum(o["launches"][k] for o in out.values()) for k in counts()}
    return {"runs": out, "launches": launches, "paged_err": err, "analytic": analytic,
            "diverged": len(sdiverged)}



# ---------------------------------------------------------------------------
# phase 10: the l2norm kernel against its plain version
# ---------------------------------------------------------------------------

# Another summation order than the plain version's (torch.sum's tree) over
# up to 311 M squares in fp32: the bar of tests/test_kernels.py.
L2_RTOL = 1e-5
QWEN3_GATE = 7 * 2_048 * 6_144  # a stacked gate of one precision group
L2_SIZES = (1, 127, 32_769, 20_000_000, QWEN3_GATE, ALEXNET_DIST, QWEN3_EMBED)
# Table II/III's profile size (benchmarks/run.py), qwen3's stacked gate, its embed
L2_TIMED = (20_000_000, QWEN3_GATE, QWEN3_EMBED)


def l2norm_cases(torch, device):
    import numpy as np

    gen = torch.Generator(device=device).manual_seed(10)
    for n in L2_SIZES:
        yield f"normal n={n}", torch.randn(n, generator=gen, device=device)
    base = torch.randn(32_772, generator=gen, device=device)
    yield "unaligned view n=32768", base[1:32_769]
    special = np.array(SPECIAL_BITS, dtype=np.uint32).view(np.float32)
    with np.errstate(invalid="ignore"):
        small = special[np.isfinite(special) & (np.abs(special) < 1e18)]
    yield "special, finite squares", torch.from_numpy(np.tile(small, 37)).to(device)
    yield "special, with inf", torch.from_numpy(special[~np.isnan(special)].copy()).to(device)
    yield "special, with nan", torch.from_numpy(np.tile(special, 37)).to(device)


def check_l2norm(torch, device):
    """Kernel vs plain version on every case (rtol L2_RTOL; inf and NaN
    where the plain version has them), two calls bit-equal; times at
    L2_TIMED beside the plain version, ``torch.dot(x, x)`` (one cuBLAS
    call computing the same Σw²) and the bound. Returns {n: row} and the
    largest |kernel - plain| over the finite cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.l2norm import l2norm_sq

    out, max_err = {}, 0.0
    for label, w in l2norm_cases(torch, device):
        got, again, want = l2norm_sq(w), l2norm_sq(w), ref.l2norm_sq_ref(w)
        torch.cuda.synchronize()
        check(bool((got.view(torch.int32) == again.view(torch.int32)).all()),
              f"l2norm {label}: two calls differ ({float(got)!r}, {float(again)!r})")
        k, p = float(got), float(want)
        if math.isfinite(p):
            err = abs(k - p)
            check(err <= L2_RTOL * abs(p), f"l2norm {label}: kernel {k!r}, plain {p!r}")
            max_err = max(max_err, err)
            line = f"   l2norm {label}: {k:.9g} vs plain {p:.9g}, rel err {err / (abs(p) or 1):.2e}"
        else:
            check(math.isnan(k) == math.isnan(p) and (math.isnan(p) or k == p),
                  f"l2norm {label}: kernel {k!r}, plain {p!r}")
            line = f"   l2norm {label}: {k!r} as the plain version"
        if w.numel() in L2_TIMED:
            n = w.numel()
            ms = time_cuda(torch, lambda: l2norm_sq(w))
            plain = time_cuda(torch, lambda: ref.l2norm_sq_ref(w), iters=5)
            lib = time_cuda(torch, lambda: torch.dot(w, w))
            bound = 4 * n / HBM_BYTES_PER_S * 1e3  # each input read once
            out[n] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound}
            line += (f"; kernel {ms * 1e3:.1f} us ({4 * n / ms / 1e6:.0f} GB/s), plain "
                     f"{plain * 1e3:.1f} us, torch.dot {lib * 1e3:.1f} us, bound "
                     f"{bound * 1e3:.1f} us ({bound / ms:.0%} of it)")
        say(line + "; two calls bit-equal")
    return out, max_err


# ---------------------------------------------------------------------------
# phase 11: full-width qwen3-1.7b A²DTWP training
# ---------------------------------------------------------------------------

LM_BATCH, LM_SEQ = 8, 128  # the training launcher's defaults
# the launcher's default rate: a 4-step baseline sweep of the launcher at
# full width kept the loss finite at 0.005, 0.05, 0.5 and 5 (PERF.md)
LM_LR = 0.05


def watch_monitor(torch, seen, every):
    """Route the AWP monitor's kernel calls through a recorder that keeps a
    copy of the input and output of every ``every``-th call: with
    ``every`` = the monitor calls of one step, layer group 0's first leaf
    of each step. Returns the undo function."""
    from repro_torch.kernels import ops

    kernel, calls = ops._l2norm_kernel, [0]

    def recorded(w):
        out = kernel(w)
        if calls[0] % every == 0:
            seen.append((w.clone(), out.clone()))
        calls[0] += 1
        return out

    ops._l2norm_kernel = recorded
    return lambda: setattr(ops, "_l2norm_kernel", kernel)


def watch_monitor_lengths(torch, seen):
    """Route the AWP monitor's kernel calls through a recorder that keeps a
    copy of the input and output of the first call at each length in
    ``seen`` (a rank's shards of every monitored leaf); the keys stay in
    ``seen`` once checked. Returns the undo function."""
    from repro_torch.kernels import ops

    kernel = ops._l2norm_kernel

    def recorded(w):
        out = kernel(w)
        if w.numel() not in seen:
            seen[w.numel()] = (w.clone(), out.clone())
        return out

    ops._l2norm_kernel = recorded
    return lambda: setattr(ops, "_l2norm_kernel", kernel)


def check_seen_monitor(seen, errs):
    """The plain version on each recorded monitor call's own input, within
    ``L2_RTOL`` relative; appends the absolute errors to ``errs``, frees
    the copies and keeps the keys."""
    from repro_torch.kernels import ref

    for n, rec in seen.items():
        if rec is None:
            continue
        w, out = rec
        p, k = float(ref.l2norm_sq_ref(w)), float(out)
        check(abs(k - p) <= L2_RTOL * abs(p), f"monitor call on the main path, n={n}: "
                                               f"kernel {k!r}, plain {p!r}")
        errs.append(abs(k - p))
        seen[n] = None


def watch_packing(torch, seen):
    """Route the materialization's Bitpack and Bitunpack launches through
    recorders that keep a copy of the input and output of the first launch
    of each kernel at each (length, round_to) in ``seen`` — qwen3's embed,
    gate/up/down, wq/wo and wk/wv at every format the run reaches; the keys
    stay in ``seen`` once checked. Returns the undo function."""
    from repro_torch.kernels import ops

    pack, unpack = ops._bitpack_kernel, ops._bitunpack_kernel

    def record(name, rt, x, out):
        key = (name, x.numel() // (rt if name == "bitunpack" else 1), rt)
        if key not in seen:
            seen[key] = (x.clone(), out.clone())

    def packed(w, rt):
        out = pack(w, rt)
        record("bitpack", rt, w, out)
        return out

    def unpacked(planes):
        out = unpack(planes)
        record("bitunpack", planes.shape[0], planes, out)
        return out

    ops._bitpack_kernel, ops._bitunpack_kernel = packed, unpacked

    def undo():
        ops._bitpack_kernel, ops._bitunpack_kernel = pack, unpack

    return undo


def check_seen_packing(torch, seen):
    """The plain versions on each recorded launch's own input: planes
    byte-equal to ``bitpack_ref``, words bit-equal to ``bitunpack_ref``.
    Frees the copies and keeps the keys."""
    from repro_torch.kernels import ref

    for key, rec in seen.items():
        if rec is None:
            continue
        (name, n, rt), (x, out) = key, rec
        want = ref.bitpack_ref(x, rt) if name == "bitpack" else ref.bitunpack_ref(x)
        check(word_err(torch, out, want) == 0,
              f"{name} on the main path, n={n} round_to={rt}: differs from its plain version")
        seen[key] = None


def lm_train_path(torch, device, *, cfg=None, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR):
    """Full-width qwen3-1.7b trained through ``Trainer`` and
    ``make_train_step``: the AWP plan forced to widen every 2 steps, then
    ``oracle:2`` steps. Returns the measurements; raises on a failed
    check. Launch counts, the monitor and packing records, the memory
    peak and the profile are read on a card only, so the phase rehearses on the CPU at
    a reduced config."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist.spec import DIST, MeshCfg, dist_elems_per_group
    from repro_torch.kernels import ref
    from repro_torch.launch.train import setup
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.loop import Trainer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.trees import tree_leaves

    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    mesh_cfg = MeshCfg()
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    nrt = cfg.num_groups + 1
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)
    group_dist = [s for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST]
    top_dist = [k for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST]
    # materializations a step: every stacked DIST leaf once per layer and
    # every top-level one once in the forward; under remat the backward
    # runs each layer again, its leaves included
    per_forward = sum(s.reps for s in group_dist) + len(top_dist)
    recomputed = sum(s.reps for s in group_dist) if cfg.remat else 0
    n_monitor = len(group_dist) + len(top_dist)
    n_params = sum(x.numel() for x in tree_leaves(storage))
    say(f"   {cfg.name}: {n_params:,} fp32 parameters, init {setup_s:.2f} s; per step "
        f"{per_forward} + {recomputed} (remat) DIST materializations, {n_monitor} monitor "
        f"calls; batch {batch} x seq {seq}, lr {lr:g}")

    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}

    def trainer_for(plan):
        def builder(rts):
            return make_train_step(cfg, mesh_cfg, None, spec_tree, opt, shapes,
                                   plan=plan.with_round_tos(rts))
        return Trainer(builder, nrt, plan=plan, dist_elems_per_group=elems)

    # forced to widen, as in phase 4: 8 -> 16 -> 24 -> 32 bits at steps 3, 5, 7
    awp_plan = PrecisionPlan.build(nrt, round_to=4, schedule="awp", awp_threshold=1.0,
                                   awp_interval=2)
    oracle_plan = PrecisionPlan.build(nrt, round_to=2)
    awp, oracle = trainer_for(awp_plan), trainer_for(oracle_plan)
    # the copies of a step's first monitor call and of its first packing
    # launches at each new (length, round_to) are held to the plain
    # versions after the step, then freed; the memory peak is read over
    # the steps that took no packing copy
    seen, packs, errs, peaks = [], {}, [], []
    unwatch = watch_monitor(torch, seen, n_monitor)
    unwatch_packing = watch_packing(torch, packs)
    data_s = check_s = 0.0
    zero_counts()
    sync()
    t_run = time.perf_counter()
    for i in range(AWP_STEPS + ORACLE_STEPS):
        t0 = time.perf_counter()
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, i, device=device)
        data_s += time.perf_counter() - t0
        trainer = awp if i < AWP_STEPS else oracle
        n_packs = len(packs)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        storage, mom, _ = trainer.run_step(storage, mom, {"tokens": tokens, "labels": labels}, lr)
        if on_card and len(packs) == n_packs:
            peaks.append(torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        for w, out in seen:
            p, k = float(ref.l2norm_sq_ref(w)), float(out)
            check(abs(k - p) <= L2_RTOL * abs(p), f"step {i}: monitor call on the main path: "
                                                  f"kernel {k!r}, plain {p!r}")
            errs.append(abs(k - p))
        seen.clear()
        check_seen_packing(torch, packs)
        check_s += time.perf_counter() - t0
    sync()
    run_s = time.perf_counter() - t_run - check_s
    got = counts()
    unwatch()
    unwatch_packing()
    peak = max(peaks, default=0)

    records = awp.records + oracle.records
    losses = [r.loss for r in records]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    for r, plan in [(r, awp_plan) for r in awp.records] + [(r, oracle_plan) for r in oracle.records]:
        want = plan.with_round_tos(r.round_tos).wire_table(elems, 1)["total"]
        check(r.wire_bytes == want, f"step {r.step}: wire {r.wire_bytes} != plan {want}")
    check(all(len(set(r.round_tos)) == 1 for r in records), "groups widened apart")
    packed = sum(r.round_tos[0] < 4 for r in records) * (per_forward + recomputed) * on_card
    want = {"bitpack": packed, "bitunpack": packed, "flash_prefill": 0, "paged_attend": 0,
            "l2norm_sq": n_monitor * len(records) * on_card}
    check(got == want, f"launches {got}, expected {want}")
    if on_card:
        check(len(errs) == len(records), f"{len(errs)} monitor calls recorded, "
                                         f"{len(records)} steps")
        # every DIST length at every packed format the run reached
        lengths = {x[0].numel() for g, gs in zip(storage["groups"], spec_tree["groups"])
                   for x, s in zip(tree_leaves(g), tree_leaves(gs)) if s.kind == DIST}
        lengths |= {storage[k].numel() for k in top_dist}
        rts = {r.round_tos[0] for r in records} - {4}
        want_keys = {(k, n, rt) for k in ("bitpack", "bitunpack") for n in lengths for rt in rts}
        check(set(packs) == want_keys, f"packing launches checked {sorted(packs)}, "
                                       f"expected {sorted(want_keys)}")
    for r in records:
        say(f"   step {r.step:2d} round_to {r.round_tos[0]} loss {r.loss:.5f} "
            f"wire {r.wire_bytes} B  {r.wall_s * 1e3:.1f} ms"
            f"{'  (first at these formats)' if r.recompiled else ''}")
    warm = sorted(r.wall_s for r in records if not r.recompiled)
    say(f"   AWP bits history {awp.bits_history}")
    say(f"   launches {got}; layer group 0's first monitor call of each step within "
        f"{max(errs, default=0.0):.3e} of its plain version ({len(errs)} steps)")
    say(f"   bitpack/bitunpack on the main path equal to their plain versions at "
        f"{len(packs)} (kernel, length, round_to): {sorted(packs)}")
    say(f"   step ms (host clock to the loss sync): median of warm steps "
        f"{warm[len(warm) // 2] * 1e3:.2f}; run {run_s:.2f} s without the checks' "
        f"{check_s:.2f} s, batch synthesis {data_s:.2f} s; memory peak of the "
        f"{len(peaks)} steps with no packing copy {peak / 2**30:.2f} GiB")
    profiled = {}
    if on_card:
        step = make_train_step(cfg, mesh_cfg, None, spec_tree, opt, shapes, plan=oracle_plan)
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, 10_000, device=device)
        b = {"tokens": tokens, "labels": labels}
        float(step(storage, mom, b, lr)[2]["loss"])  # warm
        by_name = profile(torch, lambda: float(step(storage, mom, b, lr)[2]["loss"]),
                          "qwen3-1.7b oracle:2 train step")
        busy = sum(by_name.values())
        profiled = {
            "busy_ms": busy,
            "l2norm_ms": sum(ms for k, ms in by_name.items() if "l2norm" in k),
            "packing_ms": sum(ms for k, ms in by_name.items()
                              if "bitpack" in k or "bitunpack" in k),
        }
        say(f"   profile train step: l2norm_sq {profiled['l2norm_ms']:.3f} ms "
            f"({profiled['l2norm_ms'] / busy:.2%} of kernel time), bitpack+bitunpack "
            f"{profiled['packing_ms']:.3f} ms ({profiled['packing_ms'] / busy:.2%})")
    return {"awp": awp, "oracle": oracle, "launches": got, "peak": peak,
            "monitor_err": max(errs, default=0.0), "profile": profiled,
            "warm_step_s": warm[len(warm) // 2], "cfg": cfg, "batch": batch, "seq": seq}


# ---------------------------------------------------------------------------
# phase 12: full-width AlexNet A²DTWP training across two gloo ranks
# ---------------------------------------------------------------------------

DP_RANKS = 2
# (label, PrecisionPlan.build keywords) of the phase's steps, in order, all at
# round_to 2: the paper's setting (fp32 gradients) twice, the chunked gather
# once, and last the packed gradient reduce-scatter (truncate, so that the
# per-peer blocks go through Bitpack). Last, because one rank has no
# gradient to pack: every loss (computed before the step's update) then
# compares with one rank's like for like, and only the last Σw² carries
# the packed gradient's format error.
DP_STEPS = (
    ("oracle:2", {}),
    ("oracle:2", {}),
    ("chunks 2", {"chunks": 2}),
    ("grad_round_to 2", {"grad_round_to": 2, "grad_mode": "truncate"}),
)
# (e): the two ranks' losses and Σw² against one rank's run of the same steps
# from the same weights and batches (relative). Batch 32 against 64 sums the
# convolutions in another order, and at the paper init (loss ~1e6, falling
# 10-25 % a step at lr 1e-8) the losses part by 4.6e-5 and 5.9e-5 within 4
# steps on an H100 (two runs; cuDNN's backward is not bit-reproducible),
# the Σw² by 1.9e-7 (8.4e-6 in the CPU rehearsal at reduced width, where
# the last step's truncated gradients at lr 0.01 move it): each bound is
# at least 12x the gap seen.
DP_LOSS_RTOL = 1e-3
DP_NORM_RTOL = 1e-4


def dp_config(cfg):
    """Phase 4's network with dropout off. The reference's data-parallel
    step draws every rank's dropout mask from the same key over the rank's
    own rows, so with dropout a 2-rank step is not the 1-rank step of the
    same batch, and check (e) could not compare like with like."""
    return dataclasses.replace(cfg, dropout=0.0)


def watch_materialize(seen):
    """Route the CNN step's ``materialize_leaf`` through a recorder that,
    while ``seen["on"]``, keeps a copy of every ``DIST`` leaf's gathered
    and unpacked weights in ``seen["leaves"]`` (in the step's leaf order).
    Returns the undo function."""
    from repro_torch.train import cnn_step

    mat = cnn_step.materialize_leaf

    def recorded(x, spec, mesh_cfg, round_to, grad_round_to=None, **kw):
        out = mat(x, spec, mesh_cfg, round_to, grad_round_to, **kw)
        if seen["on"] and spec.kind == "dist":
            seen["leaves"].append(out.detach().clone())
        return out

    cnn_step.materialize_leaf = recorded
    return lambda: setattr(cnn_step, "materialize_leaf", mat)


def _dp_rank(rank, device_name, cfg, batch, lr, min_size):
    """One rank of phase 12 (a process of a gloo group): its shards of
    the weights, phase 12's steps through ``Trainer``, checks (a)-(d) on
    its own view; returns its measurements."""
    import torch

    from repro_torch import fp32_math
    from repro_torch import random as jr
    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import DIST, MeshCfg, tree_to_local
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.cnn import init_cnn
    from repro_torch.optim.sgd import SGDConfig, init_momentum
    from repro_torch.plan import PrecisionPlan
    from repro_torch.plan.plan import TRAFFIC_CLASSES
    from repro_torch.train.cnn_step import (
        build_cnn_spec_tree, cnn_dist_elems, cnn_to_storage, make_cnn_eval,
        make_cnn_train_step,
    )
    from repro_torch.train.loop import Trainer
    from repro_torch.transport import CompressionPolicy
    from repro_torch.transport import transport as T

    fp32_math()
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n = torch.distributed.get_world_size()
    mesh_cfg = MeshCfg(dp=n, compress_min_size=min_size)
    mesh = make_mesh_from_cfg(mesh_cfg)
    params, metas, gi = init_cnn(cfg, 0, device=device)
    spec = build_cnn_spec_tree(params, metas, mesh_cfg)
    storage = tree_to_local(cnn_to_storage(params, spec, mesh_cfg), spec, mesh_cfg, rank)
    mom = init_momentum(storage)
    elems = cnn_dist_elems(spec, gi, mesh_cfg)
    dist_keys = [(a, b) for a, leafs in spec["layers"].items() for b, s in leafs.items()
                 if s.kind == DIST]
    # the whole initial leaves (copies: a shard may be a view of its leaf)
    first = [params["layers"][a][b].clone() for a, b in dist_keys]
    del params
    n_monitor = sum(s.meta.compress for leafs in spec["layers"].values() for s in leafs.values())
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=5e-4)
    data = SyntheticImageNet(num_classes=cfg.num_classes, hw=cfg.in_hw, device=device_name)
    val_imgs, val_labels = data.validation(EVAL_SIZE)
    plans = {label: PrecisionPlan.build(gi[1], round_to=2, **kw) for label, kw in DP_STEPS}

    def trainer_for(plan):
        return Trainer(
            lambda rts: make_cnn_train_step(cfg, mesh_cfg, spec, gi, opt,
                                            plan=plan.with_round_tos(rts), mesh=mesh),
            gi[1], plan=plan, dist_elems_per_group=elems, gather_axis_size=n)

    trainers = {label: trainer_for(plan) for label, plan in plans.items()}
    evaluate = make_cnn_eval(cfg, mesh_cfg, spec, gi, plan=plans["oracle:2"], mesh=mesh)

    seen, packs = {"on": False, "leaves": []}, {}
    unwatch = watch_materialize(seen)
    unwatch_packing = watch_packing(torch, packs) if on_card else (lambda: None)
    sync()
    zero_counts()
    records, norms = [], []
    for i, (label, _) in enumerate(DP_STEPS):
        imgs, labels = data.batch(batch, i)
        want = None
        if label == "chunks 2":  # (b): chunks 1's gather of the same shards,
            # on the plain versions (no launch) and outside the step's clock
            with torch.no_grad():
                pol = CompressionPolicy(round_to=2, impl="ref")
                want = [T.all_gather(storage["layers"][a][b].reshape(-1), None, pol)
                        [:spec["layers"][a][b].n_local] for a, b in dist_keys]
        seen["on"] = i == 0 or want is not None
        storage, mom, m = trainers[label].run_step(
            storage, mom, {"images": imgs, "labels": labels}, lr, jr.PRNGKey(1000 + i))
        records.append(trainers[label].records[-1])
        norms.append(m["group_norms_sq"].cpu().numpy())
        got_leaves, seen["on"] = seen["leaves"], False
        seen["leaves"] = []
        if i == 0:  # (a): bit-equal to one rank's quantize of the whole leaf
            check(len(got_leaves) == len(dist_keys), f"rank {rank}: recorded "
                  f"{len(got_leaves)} gathers, {len(dist_keys)} DIST leaves")
            for (a, b), g, w in zip(dist_keys, got_leaves, first):
                q = ref.quantize_ref(w, 2)
                check(torch.equal(g.reshape(-1).view(torch.int32), q.reshape(-1).view(torch.int32)),
                      f"rank {rank} step 0: gathered {a}.{b} differs from the one-rank quantize")
            del first
        if want is not None:  # (b)
            for (a, b), g, w in zip(dist_keys, got_leaves, want):
                check(torch.equal(g.reshape(-1).view(torch.int32), w.view(torch.int32)),
                      f"rank {rank}: chunks 2 gathered {a}.{b} differs from chunks 1")
        if on_card:
            check_seen_packing(torch, packs)
    top5 = float(evaluate(storage, val_imgs, val_labels))
    sync()
    got = counts()
    unwatch()
    unwatch_packing()

    # (d): measured wire == wire_table, per class, every step
    for i, ((label, _), r) in enumerate(zip(DP_STEPS, records)):
        table = plans[label].with_round_tos(r.round_tos).wire_table(elems, n)
        for k in TRAFFIC_CLASSES:
            check(r.measured_by_entry.get(k, 0) == table[k],
                  f"rank {rank} step {i} ({label}): measured {k} "
                  f"{r.measured_by_entry.get(k, 0)} B != wire_table {table[k]} B")
    # (c): launches as the leaves require, all on the CUDA kernels
    n_dist = len(dist_keys)
    chunked = sum(2 if spec["layers"][a][b].s_loc % 2 == 0 else 1 for a, b in dist_keys)
    packed = 3 * n_dist + n_dist + chunked + n_dist  # 3 gathers, grad blocks, chunks, eval
    want = {"bitpack": packed, "bitunpack": packed, "flash_prefill": 0, "paged_attend": 0,
            "l2norm_sq": n_monitor * len(DP_STEPS)}
    if not on_card:
        want = {k: 0 for k in want}
    check(got == want, f"rank {rank}: launches {got}, expected {want}")
    if on_card:
        lengths = {spec["layers"][a][b].s_loc for a, b in dist_keys}
        lengths |= {spec["layers"][a][b].s_loc // 2 for a, b in dist_keys
                    if spec["layers"][a][b].s_loc % 2 == 0}
        lengths |= {spec["layers"][a][b].pad_rep for a, b in dist_keys}
        keys = {(k, nn, 2) for k in ("bitpack", "bitunpack") for nn in lengths}
        check(packs and set(packs) <= keys, f"rank {rank}: packing launches checked "
                                            f"{sorted(packs)}, lengths {sorted(lengths)}")

    profiled = {}
    if on_card:  # one more warm oracle:2 step, profiled on rank 0
        step = make_cnn_train_step(cfg, mesh_cfg, spec, gi, opt, plan=plans["oracle:2"],
                                   mesh=mesh)
        imgs, labels = data.batch(batch, 10_000)
        b = {"images": imgs, "labels": labels}
        float(step(storage, mom, b, lr, jr.PRNGKey(7))[2]["loss"])
        run = lambda: float(step(storage, mom, b, lr, jr.PRNGKey(8))[2]["loss"])  # noqa: E731
        if rank == 0:
            by_name = profile(torch, run, "oracle:2 data-parallel step, rank 0")
            profiled = {"busy_ms": sum(by_name.values())}
        else:
            run()
    return {
        "records": [{"loss": r.loss, "wall_s": r.wall_s, "stage_s": r.stage_s,
                     "measured": r.measured_by_entry, "table": r.wire_by_entry}
                    for r in records],
        "norms": norms, "launches": got, "top5": top5, "n_dist": n_dist,
        "n_monitor": n_monitor, "packs": sorted(packs), "profile": profiled,
    }


def _one_rank_run(torch, device, cfg, batch, lr, min_size):
    """Phase 12's steps on one rank from the same weights and batches (the
    gradient format and chunks do not move anything on one device): losses,
    Σw² per group, and per group the Σw² of its monitored leaves that are
    not ``DIST`` (whole on every rank, so counted once per rank in the
    data-parallel sum, as in the reference)."""
    import numpy as np

    from repro_torch import random as jr
    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.kernels import ref
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.cnn_step import cnn_dist_elems, make_cnn_train_step
    from repro_torch.train.loop import Trainer

    mesh_cfg = MeshCfg(compress_min_size=min_size)
    storage, mom, spec, gi = build_run(cfg, mesh_cfg, device)
    elems = cnn_dist_elems(spec, gi, mesh_cfg)
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=5e-4)
    data = SyntheticImageNet(num_classes=cfg.num_classes, hw=cfg.in_hw, device=str(device))
    groups = gi[0]
    repl = [(a, b, groups[a]) for a, leafs in spec["layers"].items() for b, s in leafs.items()
            if s.meta.compress and s.kind != "dist"]
    losses, norms, repl_sq = [], [], []
    for i, (label, kw) in enumerate(DP_STEPS):
        plan = PrecisionPlan.build(gi[1], round_to=2, **kw)
        trainer = Trainer(lambda rts, plan=plan: make_cnn_train_step(
            cfg, mesh_cfg, spec, gi, opt, plan=plan.with_round_tos(rts)),
            gi[1], plan=plan, dist_elems_per_group=elems)
        imgs, labels = data.batch(batch, i)
        storage, mom, m = trainer.run_step(storage, mom, {"images": imgs, "labels": labels},
                                           lr, jr.PRNGKey(1000 + i))
        losses.append(trainer.records[-1].loss)
        norms.append(m["group_norms_sq"].cpu().numpy())
        sq = np.zeros(gi[1], np.float64)
        for a, b, g in repl:
            sq[g] += float(ref.l2norm_sq_ref(storage["layers"][a][b]))
        repl_sq.append(sq)
    return {"losses": losses, "norms": norms, "repl_sq": repl_sq}


def dp_train_path(torch, device, *, cfg=None, batch=64, min_size=None):
    """Full-width AlexNet (phase 4's widths and weights, dropout off) trained
    as ``DP_RANKS`` gloo ranks on ``device``, each a spawned process with its
    slice of the batch: ``DP_STEPS`` through ``Trainer``, then one
    ``make_cnn_eval``. Each rank checks (a) the gathered weights of step 0
    against one rank's quantize of the whole leaves, (b) chunks 2 against
    chunks 1, (c) its launch counts and (d) its measured wire against
    ``wire_table``; here (e) the losses and Σw² against one rank's run of
    the same steps. Launch counts, packing records and the profile are read
    on a card only, so the phase rehearses on the CPU at a reduced
    config. Returns the measurements; raises on a failed check."""
    import numpy as np

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.cnn import ALEXNET
    from repro_torch.models.meta import COMPRESS_MIN_SIZE

    cfg = dp_config(cfg or ALEXNET)
    min_size = min_size or COMPRESS_MIN_SIZE
    lr = 1e-8 if cfg.paper_init else 0.01  # phase 4's rates
    on_card = device.type == "cuda"
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        say(f"   {DP_RANKS} ranks on one card: {smi}")
    t0 = time.perf_counter()
    # the card's machine has 8 cores: 4 a rank for the staging copies
    outs = spawn_ranks(_dp_rank, DP_RANKS, str(device), cfg, batch, lr, min_size,
                       threads=4 if on_card else 1)
    ranks_s = time.perf_counter() - t0
    one = _one_rank_run(torch, device, cfg, batch, lr, min_size)

    r0 = outs[0]
    for r, o in enumerate(outs):
        check([x["loss"] for x in o["records"]] == [x["loss"] for x in r0["records"]],
              f"rank {r}'s losses differ from rank 0's")
        check(all(np.array_equal(a, b) for a, b in zip(o["norms"], r0["norms"])),
              f"rank {r}'s Σw² differ from rank 0's")
    losses = [x["loss"] for x in r0["records"]]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    # (e)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))
    want_norms = [o + (DP_RANKS - 1) * s for o, s in zip(one["norms"], one["repl_sq"])]
    norm_gap = max(float(np.max(np.abs(a - b) / np.abs(b)))
                   for a, b in zip(r0["norms"], want_norms))
    check(loss_gap <= DP_LOSS_RTOL, f"losses {losses} vs one rank {one['losses']}: "
                                    f"relative gap {loss_gap:.3e} > {DP_LOSS_RTOL}")
    check(norm_gap <= DP_NORM_RTOL,
          f"Σw² relative gap {norm_gap:.3e} > {DP_NORM_RTOL} against one rank")
    check(0.0 <= r0["top5"] <= 1.0, f"top-5 error {r0['top5']} out of range")
    for i, ((label, _), x) in enumerate(zip(DP_STEPS, r0["records"])):
        say(f"   step {i} {label:15s} loss {x['loss']:.6g} (one rank {one['losses'][i]:.6g}); "
            f"wire weights {x['measured']['weights']} B, gradients "
            f"{x['measured']['gradients']} B (== wire_table), grad_sync "
            f"{x['measured'].get('grad_sync', 0)} B, metrics {x['measured'].get('metrics', 0)} B; "
            f"{x['wall_s'] * 1e3:.1f} ms, gloo staging {x['stage_s'] * 1e3:.1f} ms "
            f"({x['stage_s'] / x['wall_s']:.0%})")
    warm = r0["records"][1:]
    say(f"   (e) against one rank: losses within {loss_gap:.3e} (bound {DP_LOSS_RTOL}), Σw² "
        f"within {norm_gap:.3e} (bound {DP_NORM_RTOL}), relative; top-5 error after "
        f"{len(losses)} steps {r0['top5']:.4f}")
    say(f"   launches per rank: {[o['launches'] for o in outs]} ({r0['n_dist']} DIST leaves, "
        f"{r0['n_monitor']} monitored); packing checked at {len(r0['packs'])} "
        f"(kernel, length, round_to)")
    say(f"   step ms on rank 0 after the first: "
        f"{[round(x['wall_s'] * 1e3, 1) for x in warm]}; gloo staging share "
        f"{sum(x['stage_s'] for x in warm) / sum(x['wall_s'] for x in warm):.1%}; ranks' "
        f"processes {ranks_s:.1f} s in all")
    launches = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
    return {"ranks": outs, "one": one, "launches": launches, "loss_gap": loss_gap,
            "norm_gap": norm_gap}

# ---------------------------------------------------------------------------
# phase 13: full-width qwen3-1.7b FSDP×TP training on a 2×2 mesh of gloo ranks
# ---------------------------------------------------------------------------

TP_DP, TP_TP = 2, 2  # the mesh: 2 data ranks × 2 model ranks
# the phase's depth: its widths are qwen3-1.7b's, its layers cut from 28 so
# that the whole script fits its time limit; phase 18 (a) trains the 2×2
# mesh at full depth
TP_LAYERS = 4
# (label, PrecisionPlan.build keywords) of the phase's steps, in order, all at
# round_to 2: fp32 gradients and uncompressed activations twice, the
# sequence-parallel layout, then the TP-region activations and the gradient
# reduce-scatter packed at round_to 2 in truncate mode (so that their planes
# go through Bitpack and Bitunpack: nearest rounding runs the plain version,
# by the reference's rule).
TP_STEPS = (
    ("oracle:2", {}),
    ("oracle:2", {}),
    ("seq_parallel", {"seq_parallel": True}),
    ("act_round_to 2", {"act_round_to": 2, "act_mode": "truncate"}),
    ("grad_round_to 2", {"grad_round_to": 2, "grad_mode": "truncate"}),
)
TP_UNCOMPRESSED = 3  # steps 0-2 move no rounded activation or gradient
# (d): the sequence-parallel step against the psum layout's on the same state
TP_SEQ_RTOL = 1e-6
# (e): steps 0-2 against one device's steps from the same weights and batches,
# relative. The gaps seen on an H100 were 9.3e-7 (losses) and 1.7e-7 (Σw²),
# in the CPU rehearsal 0 and 1.5e-7: each bound is about 10x the larger.
TP_LOSS_RTOL = 1e-5
TP_NORM_RTOL = 2e-6
# (e): each rank's change of every leaf block, Σ(w − w₀)² after these many
# steps (the psum layout's two, then the sequence-parallel one), against the
# same block of one device's change, relative. Losses and Σw² alone miss a
# gradient fault: in the CPU rehearsal a skipped model-group or FSDP-group
# sum of the replicated gradients kept both within 6.1e-7, and moved these
# sums by 0.64-0.66. Without a fault the gap was 3.5e-4 on an H100 and
# 2.0e-5 in the CPU rehearsal: the bound is about 14x the larger.
TP_MOVED = (2, 3)
TP_MOVE_RTOL = 5e-3


def update_sums(spec_tree, storage, start, mesh_cfg=None, rank=0):
    """Σ(w − w₀)² in fp64 of every leaf (spec-tree order) between
    ``start`` and ``storage``: a rank's blocks as they are, or, given a
    sharded ``mesh_cfg``, rank ``rank``'s block of one device's whole
    leaves (``leaf_to_local`` of the change)."""
    from repro_torch.dist.spec import leaf_to_local
    from repro_torch.utils.trees import tree_leaves, tree_map

    def moved(s, x, x0):
        d = x - x0
        if mesh_cfg is not None:
            d = leaf_to_local(d, s, mesh_cfg, rank)
        return float((d.double() ** 2).sum())

    return tree_leaves(tree_map(moved, spec_tree, storage, start))


def watch_gathers(seen, ptrs, expected):
    """Route the LM step's ``materialize_leaf`` through a recorder that,
    while ``seen["on"]``, holds each ``DIST`` leaf's gathered and unpacked
    weights (first time a step meets each (leaf, repetition), by the
    storage's address in ``ptrs``) to ``expected``: the high 16 bits of
    the rank's ``quantize_ref`` of its TP slice of the whole leaf, on the
    host; the low 16 bits must be zero. Returns the undo function."""
    import torch

    from repro_torch.train import step as tstep

    mat = tstep.materialize_leaf

    def recorded(x, spec, mesh_cfg, round_to, grad_round_to=None, **kw):
        out = mat(x, spec, mesh_cfg, round_to, grad_round_to, **kw)
        at = ptrs.get(x.data_ptr()) if seen["on"] and spec.kind == "dist" else None
        if at is not None and at not in seen["done"]:
            leaf, rep = at
            want = expected[leaf][rep] if spec.stacked else expected[leaf]
            want = want.to(out.device, torch.int32).reshape(-1) << 16
            if not torch.equal(out.detach().reshape(-1).view(torch.int32), want):
                seen["bad"].append(at)
            seen["done"].add(at)
        return out

    tstep.materialize_leaf = recorded
    return lambda: setattr(tstep, "materialize_leaf", mat)


def _tp_rank(rank, device_name, cfg, batch, seq, lr):
    """One rank of phase 13 (a process of a gloo group of 4): its blocks of
    the weights, phase 13's steps through ``Trainer``, checks (a)-(d) on
    its own view; returns its measurements."""
    import torch

    from repro_torch import fp32_math
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist.spec import DIST, MeshCfg, dist_elems_per_group, tp_slice
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.launch.train import setup
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import Trainer
    from repro_torch.utils.trees import tree_leaves, tree_map

    fp32_math()
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh_cfg = MeshCfg(tp=TP_TP, dp=TP_DP)
    mesh = make_mesh_from_cfg(mesh_cfg)
    model_rank = rank % TP_TP
    expected = []  # per DIST leaf: high halves of quantize_ref(TP slice), on the host

    def visit(x, s):
        if s.kind == DIST:
            q = ref.quantize_ref(tp_slice(x, s, mesh_cfg, model_rank), 2)
            expected.append((q.view(torch.int32) >> 16).to(torch.int16).cpu())

    t0 = time.perf_counter()
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device, rank=rank, visit=visit)
    sync()
    setup_s = time.perf_counter() - t0
    nrt = cfg.num_groups + 1
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)
    dist_leaves = [(x, s) for x, s in zip(tree_leaves(storage), tree_leaves(spec_tree))
                   if s.kind == DIST]
    ptrs = {}
    for i, (x, s) in enumerate(dist_leaves):
        for r in range(s.reps):
            ptrs[(x[r] if s.stacked else x).data_ptr()] = (i, r)
    group_dist = [s for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST]
    top_dist = [s for k, s in spec_tree.items() if k != "groups" and s.kind == DIST]
    per_forward = sum(s.reps for s in group_dist) + len(top_dist)
    recomputed = sum(s.reps for s in group_dist) if cfg.remat else 0
    boundaries = tstep.tp_boundaries(cfg)
    act_elems = (batch // TP_DP) * seq * cfg.d_model
    loss_elems = (batch // TP_DP) * seq  # the loss's two sums over the model group
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    plans = {label: PrecisionPlan.build(nrt, round_to=2, **kw) for label, kw in TP_STEPS}

    def trainer_for(plan):
        return Trainer(lambda rts: tstep.make_train_step(
            cfg, mesh_cfg, mesh, spec_tree, opt, shapes, plan=plan.with_round_tos(rts)),
            nrt, plan=plan, dist_elems_per_group=elems, gather_axis_size=TP_DP)

    trainers = {label: trainer_for(plan) for label, plan in plans.items()}
    seen = {"on": False, "done": set(), "bad": []}
    packs = {}
    unwatch = watch_gathers(seen, ptrs, expected)
    unwatch_packing = watch_packing(torch, packs) if on_card else (lambda: None)
    monitor, monitor_errs = {}, []
    unwatch_monitor = watch_monitor_lengths(torch, monitor) if on_card else (lambda: None)
    saved, records, norms, moved = None, [], [], []
    start = tree_map(lambda x: x.clone(), storage)  # (e)
    sync()
    zero_counts()
    for i, (label, _) in enumerate(TP_STEPS):
        if i in TP_MOVED:
            moved.append(update_sums(spec_tree, storage, start))
            if i == TP_MOVED[-1]:
                del start
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, i, device=device)
        if label == "seq_parallel":  # (d): the state it starts from, on the host
            saved = [[x.to("cpu", copy=True) for x in tree_leaves(t)] for t in (storage, mom)]
        seen["on"] = i == 0
        storage, mom, m = trainers[label].run_step(
            storage, mom, {"tokens": tokens, "labels": labels}, lr)
        seen["on"] = False
        records.append(trainers[label].records[-1])
        norms.append(m["group_norms_sq"].cpu().numpy())
        if i == 0:  # (a)
            want = sum(s.reps for _, s in dist_leaves)
            check(len(seen["done"]) == want, f"rank {rank}: step 0 met "
                  f"{len(seen['done'])} of its {want} DIST (leaf, repetition) gathers")
            check(not seen["bad"], f"rank {rank} step 0: gathered weights of (leaf, rep) "
                                   f"{seen['bad'][:5]} differ from quantize_ref of the TP slice")
            expected.clear()
        if on_card:
            check_seen_packing(torch, packs)
            check_seen_monitor(monitor, monitor_errs)
    sync()
    got = counts()
    unwatch()
    unwatch_packing()
    unwatch_monitor()

    # (c): measured wire == the plan's table with the step's TP boundaries
    tables = []
    for i, ((label, _), r) in enumerate(zip(TP_STEPS, records)):
        table = tstep.step_wire_table(plans[label].with_round_tos(r.round_tos), cfg,
                                      spec_tree, mesh_cfg, (batch, seq))
        tables.append(table)
        for k in tstep.COLLECTIVE_CLASSES:
            check(r.measured_by_entry.get(k, 0) == table[k],
                  f"rank {rank} step {i} ({label}): measured {k} "
                  f"{r.measured_by_entry.get(k, 0)} B != table {table[k]} B")
    # (b): launches as the leaves and the TP boundaries require
    n_steps = len(TP_STEPS)
    mats = n_steps * (per_forward + recomputed)  # every step gathers at round_to 2
    # act2 step: a packed reduce-scatter and all-gather per all-reduce (the
    # remat backward's included) and per loss sum
    act = 2 * (boundaries + tstep.remat_tp_collectives(cfg)[1]) + 2 * 2
    grads = per_forward  # grad2 step: one packed block exchange per gathered leaf
    packed = mats + act + grads
    want = {"bitpack": packed, "bitunpack": packed, "flash_prefill": 0, "paged_attend": 0,
            "l2norm_sq": len(dist_leaves) * n_steps}
    if not on_card:
        want = {k: 0 for k in want}
    check(got == want, f"rank {rank}: launches {got}, expected {want}")
    if on_card:
        pads = {s.pad_rep for _, s in dist_leaves}
        packs_n = {p // TP_DP for p in pads} | pads | {act_elems, act_elems // TP_TP,
                                                       loss_elems, loss_elems // TP_TP}
        unpacks_n = pads | {act_elems, loss_elems}
        keys = ({("bitpack", n, 2) for n in packs_n}
                | {("bitunpack", n, 2) for n in unpacks_n})
        check(set(packs) == keys, f"rank {rank}: packing launches checked {sorted(packs)}, "
                                  f"expected {sorted(keys)}")
        lengths = {x.numel() for x, _ in dist_leaves}
        check(set(monitor) == lengths, f"rank {rank}: monitor calls checked at lengths "
                                       f"{sorted(monitor)}, expected {sorted(lengths)}")

    # (d): the psum layout's step from the state the sequence-parallel step took
    for x, h in zip(tree_leaves(storage), saved[0]):
        x.copy_(h)
    for x, h in zip(tree_leaves(mom), saved[1]):
        x.copy_(h)
    del saved
    i = [label for label, _ in TP_STEPS].index("seq_parallel")
    tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, i, device=device)
    step = tstep.make_train_step(cfg, mesh_cfg, mesh, spec_tree, opt, shapes,
                                 plan=plans["oracle:2"])
    _, _, m = step(storage, mom, {"tokens": tokens, "labels": labels}, lr)
    psum = {"loss": float(m["loss"]), "norms": m["group_norms_sq"].cpu().numpy()}

    profiled = {}
    if on_card:  # one more uncompressed step, profiled on rank 0
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, 10_000, device=device)
        b = {"tokens": tokens, "labels": labels}
        run = lambda: float(step(storage, mom, b, lr)[2]["loss"])  # noqa: E731
        if rank == 0:
            by_name = profile(torch, run, "oracle:2 FSDP×TP step, rank 0")
            busy = sum(by_name.values())
            copies = sum(ms for k, ms in by_name.items() if "memcpy" in k.lower())
            gemms = sum(ms for k, ms in by_name.items()
                        if "gemm" in k.lower() or "cutlass" in k.lower())
            profiled = {"busy_ms": busy, "copies_ms": copies, "gemm_ms": gemms,
                        "other_ms": busy - copies - gemms}
            say(f"   profile FSDP×TP step, rank 0: staging copies {copies:.2f} ms, GEMMs "
                f"{gemms:.2f} ms, other kernels {busy - copies - gemms:.2f} ms")
        else:
            run()
    return {
        "records": [{"loss": r.loss, "wall_s": r.wall_s, "stage_s": r.stage_s,
                     "first": r.recompiled, "measured": r.measured_by_entry, "table": t}
                    for r, t in zip(records, tables)],
        "norms": norms, "moved": moved, "psum": psum, "launches": got, "packs": sorted(packs),
        "monitor_lengths": sorted(monitor), "monitor_err": max(monitor_errs, default=0.0),
        "profile": profiled, "setup_s": setup_s, "elems": elems, "boundaries": boundaries,
        "act_elems": act_elems, "n_dist": len(dist_leaves), "per_forward": per_forward,
        "recomputed": recomputed, "remat": tstep.remat_tp_collectives(cfg),
    }


def _one_device_lm(torch, device, cfg, batch, seq, lr):
    """Phase 13's steps on one device (phase 11's step) from the same
    weights and batches, all at ``oracle:2``: losses and Σw² per group,
    and after ``TP_MOVED`` steps each rank's ``update_sums`` of the
    change."""
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist.spec import MeshCfg, build_spec_tree
    from repro_torch.launch.train import setup
    from repro_torch.models.init import init_params
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.trees import tree_leaves, tree_map

    mesh_cfg, tp_cfg = MeshCfg(), MeshCfg(tp=TP_TP, dp=TP_DP)
    tp_spec = build_spec_tree(*init_params(cfg, device="meta", tp=TP_TP), tp_cfg)
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device)
    start = tree_map(lambda x: x.clone(), storage)
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    step = make_train_step(cfg, mesh_cfg, None, spec_tree, opt,
                           {"tokens": (batch, seq), "labels": (batch, seq)},
                           plan=PrecisionPlan.build(cfg.num_groups + 1, round_to=2))
    losses, norms, moved = [], [], []
    for i in range(len(TP_STEPS)):
        if i in TP_MOVED:
            moved.append([update_sums(tp_spec, storage, start, tp_cfg, r)
                          for r in range(TP_DP * TP_TP)])
            if i == TP_MOVED[-1]:
                del start
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, i, device=device)
        storage, mom, m = step(storage, mom, {"tokens": tokens, "labels": labels}, lr)
        losses.append(float(m["loss"]))
        norms.append(m["group_norms_sq"].cpu().numpy())
    return {"losses": losses, "norms": norms, "moved": moved,
            "leaves": [f"{s.kind} {s.logical}" for s in tree_leaves(tp_spec)]}


def tp_train_path(torch, device, *, cfg=None, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR):
    """Full-width qwen3-1.7b (phase 11's weights and settings) trained on a
    ``TP_DP`` × ``TP_TP`` mesh of gloo ranks on ``device``, each a spawned
    process with its FSDP slice of the batch and its blocks of the
    weights: ``TP_STEPS`` through ``Trainer``. Each rank checks (a) the
    gathered weights of step 0 against ``quantize_ref`` of its TP slice of
    the whole leaves, (b) its launch counts, (c) its measured wire against
    ``step_wire_table`` and (d) the sequence-parallel step against the
    psum layout's; here (e) the uncompressed steps against one device and
    (f) the compressed ones against the reference's bar. Launch counts,
    packing records and the profile are read on a card only, so the phase
    rehearses on the CPU at a reduced config. Returns the measurements;
    raises on a failed check."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import spawn_ranks

    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    ranks = TP_DP * TP_TP
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        say(f"   {ranks} ranks on one card: {smi}")
    t0 = time.perf_counter()
    # the card's machine has 8 cores: 2 a rank for the staging copies
    outs = spawn_ranks(_tp_rank, ranks, str(device), cfg, batch, seq, lr,
                       threads=2 if on_card else 1, timeout_s=900)
    ranks_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
    one = _one_device_lm(torch, device, cfg, batch, seq, lr)

    r0 = outs[0]
    for r, o in enumerate(outs):
        check([x["loss"] for x in o["records"]] == [x["loss"] for x in r0["records"]],
              f"rank {r}'s losses differ from rank 0's")
        check(all(np.array_equal(a, b) for a, b in zip(o["norms"], r0["norms"])),
              f"rank {r}'s Σw² differ from rank 0's")
    losses = [x["loss"] for x in r0["records"]]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    check([x["first"] for x in r0["records"]] == [True, False, True, True, True],
          f"first-at-format marks {[x['first'] for x in r0['records']]}")
    # (d)
    i_seq = [label for label, _ in TP_STEPS].index("seq_parallel")
    seq_loss, seq_norms = losses[i_seq], r0["norms"][i_seq]
    psum = r0["psum"]
    seq_gap = max([abs(seq_loss - psum["loss"]) / abs(psum["loss"])]
                  + list(np.abs(seq_norms - psum["norms"]) / np.abs(psum["norms"])))
    seq_bits = seq_loss == psum["loss"] and np.array_equal(seq_norms, psum["norms"])
    check(seq_gap <= TP_SEQ_RTOL, f"sequence-parallel step {seq_loss!r} / {seq_norms} against "
                                  f"the psum layout's {psum}: relative gap {seq_gap:.3e}")
    # (e)
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(losses[:TP_UNCOMPRESSED], one["losses"][:TP_UNCOMPRESSED]))
    norm_gap = max(float(np.max(np.abs(a - b) / np.abs(b))) for a, b in
                   zip(r0["norms"][:TP_UNCOMPRESSED], one["norms"][:TP_UNCOMPRESSED]))
    check(loss_gap <= TP_LOSS_RTOL, f"losses {losses} vs one device {one['losses']}: "
                                    f"relative gap {loss_gap:.3e} > {TP_LOSS_RTOL}")
    check(norm_gap <= TP_NORM_RTOL,
          f"Σw² relative gap {norm_gap:.3e} > {TP_NORM_RTOL} against one device")
    move_gap, worst = 0.0, None
    for r, o in enumerate(outs):
        for n, got, want in zip(TP_MOVED, o["moved"], one["moved"]):
            for j, (a, b) in enumerate(zip(got, want[r], strict=True)):
                check(abs(a - b) <= TP_MOVE_RTOL * b, f"rank {r}, leaf {j} "
                      f"({one['leaves'][j]}): Σ(w − w₀)² after {n} steps {a!r} against one "
                      f"device's block {b!r}")
                gap = abs(a - b) / b if b else 0.0
                if gap > move_gap:
                    move_gap, worst = gap, f"rank {r}, leaf {j} ({one['leaves'][j]}), {n} steps"
    # (f): the reference's bar (scenario_dist_train.py) for the compressed steps
    for i in range(TP_UNCOMPRESSED, len(TP_STEPS)):
        lc, l1 = losses[i], one["losses"][i]
        check(abs(lc - l1) < 0.05 + 0.05 * abs(l1), f"step {i} ({TP_STEPS[i][0]}): loss "
                                                    f"{lc} against one device's {l1}")
    for i, ((label, _), x) in enumerate(zip(TP_STEPS, r0["records"])):
        shown = ", ".join(f"{k} {x['measured'].get(k, 0)}" for k in
                          ("weights", "gradients", "activations", "seq_boundary"))
        other = ", ".join(f"{k} {v}" for k, v in x["measured"].items()
                          if k in ("grad_sync", "metrics", "loss"))
        say(f"   step {i} {label:15s} loss {x['loss']:.6g} (one device {one['losses'][i]:.6g}); "
            f"wire B a rank: {shown} (== table); not priced: {other}; "
            f"{x['wall_s'] * 1e3:.1f} ms, gloo staging {x['stage_s'] * 1e3:.1f} ms "
            f"({x['stage_s'] / x['wall_s']:.0%}){'  (first at these formats)' if x['first'] else ''}")
    say(f"   table: wire_table(elems={r0['elems']}, 2, tp={TP_TP}, act_elems={r0['act_elems']}, "
        f"act_collectives={r0['boundaries']}) + the remat backward's {r0['recomputed']} "
        f"gathers of group leaves and (enters, exits) {r0['remat']} (step_wire_table)")
    say(f"   (d) sequence-parallel step against the psum layout on the same state: within "
        f"{seq_gap:.3e} relative (bound {TP_SEQ_RTOL}); bits {'equal' if seq_bits else 'differ'}")
    say(f"   (e) steps 0-{TP_UNCOMPRESSED - 1} against one device: losses within {loss_gap:.3e} "
        f"(bound {TP_LOSS_RTOL}), Σw² within {norm_gap:.3e} (bound {TP_NORM_RTOL}), every "
        f"rank's leaf blocks' Σ(w − w₀)² after {list(TP_MOVED)} steps within {move_gap:.3e} "
        f"(bound {TP_MOVE_RTOL}; at {worst}), relative; "
        f"(f) compressed steps {losses[TP_UNCOMPRESSED:]} against one device's "
        f"{one['losses'][TP_UNCOMPRESSED:]}")
    say(f"   launches per rank: {[o['launches'] for o in outs]} ({r0['n_dist']} DIST leaves, "
        f"{r0['per_forward']} + {r0['recomputed']} gathers a step, {r0['boundaries']} TP "
        f"boundaries + {r0['remat']} in the remat backward); packing checked at {len(r0['packs'])} (kernel, length, round_to)")
    monitor_err = max(o["monitor_err"] for o in outs)
    say(f"   monitor calls on the main path within {monitor_err:.3e} of the plain version at "
        f"every rank's shard lengths (rank 0: {r0['monitor_lengths']})")
    warm = r0["records"][1:]
    say(f"   step ms on rank 0: {[round(x['wall_s'] * 1e3, 1) for x in r0['records']]}; gloo "
        f"staging share after the first {sum(x['stage_s'] for x in warm) / sum(x['wall_s'] for x in warm):.1%}; "
        f"set-up {[round(o['setup_s'], 1) for o in outs]} s; ranks' processes {ranks_s:.1f} s")
    launches = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
    return {"ranks": outs, "one": one, "launches": launches, "monitor_err": monitor_err,
            "loss_gap": loss_gap, "norm_gap": norm_gap, "move_gap": move_gap,
            "seq_gap": seq_gap, "seq_bits": seq_bits}

# ---------------------------------------------------------------------------
# phase 14: full-width qwen3-1.7b served at tp > 1 on gloo ranks
# ---------------------------------------------------------------------------

TPS_TP = 2
# phases 14, 15, 16, 18 (b), (c) and 19 serve and train qwen3-1.7b at its
# widths and this many of its 28 layers, held to one device's runs at the
# same depth (phase 7's runs again there), so that the script fits its time
# limit; phases 7, 9 and 11 run the full depth. Phase 15 (e) holds its 1×2
# int8 engine to the 1×2 static run under the int8 tie rule
# (``INT8_TIE_DRAW``), which the 4-layer run needs (request 0, token 6)
CUT_LAYERS = 4
# activations packed at round_to 2 in truncate mode, so that their planes go
# through Bitpack and Bitunpack (nearest rounding packs on the plain version,
# by the reference's rule)
TPS_ACT2 = {"act_round_to": 2, "act_mode": "truncate"}
# the runs of (a), the 1×2 mesh, in order: ``plan`` the PrecisionPlan.build
# keywords beside round_to 2, ``engine`` the ServeEngine keywords (a static
# run without; ``per_request``: one generate_static call a request, batch
# 1), ``rids`` the requests (default all), ``against`` the static run an
# engine's streams must equal. A row's GEMM bits depend on the batch's
# shape (cuBLAS picks its kernel by the row count), and activations
# truncated to bf16 at every TP-region exit carry a last-bit difference on
# as a bf16 step: an H100 run's 2-slot engine at act_round_to 2 left the
# batched static run at token 11 of request 2, where a batch-1 run's top-2
# logit gap was 3.0e-3 (PERF.md §6, PR 18). So at act_round_to 2 the exact
# pin is the 1-slot engine against batch-1 static runs, and the 2-slot
# engine may leave them only where a batch-1 run's top-2 logit gap is below
# ``near_tie`` (about 3x that reading); the fp32 engines are held exactly
TPS_RUNS_A = (
    {"label": "static"},
    {"label": "engine", "engine": {}, "against": "static"},
    {"label": "weight-stationary", "engine": {"weight_stationary": True}, "against": "static"},
    {"label": "paged", "engine": {"paged": True, "page_size": PAGE}, "against": "static"},
    {"label": "act2 static", "plan": TPS_ACT2, "rids": (0, 2, 3), "per_request": True},
    {"label": "act2 engine, 1 slot", "plan": TPS_ACT2, "engine": {"max_slots": 1},
     "rids": (0, 2, 3), "against": "act2 static"},
    {"label": "act2 engine", "plan": TPS_ACT2, "engine": {}, "rids": (0, 2, 3),
     "against": "act2 static", "near_tie": 1e-2},
)
# (b), the 2×2 mesh: phase 7's 512- and 256-token prompts, one slot a data rank
TPS_RUNS_B = (
    {"label": "static"},
    {"label": "weight-stationary", "engine": {"weight_stationary": True}, "against": "static"},
)
TPS_B_RIDS = (0, 3)
TPS_B_GEN = 4  # cut from 16: the static run gathers the weights every forward
# the 512-token admission's logits against phase 7's (one device), relative
# to their largest magnitude: the model group sums each matmul of half the
# contraction on its own rank, then adds the halves
TPS_LOGIT_RTOL = 1e-5


def static_groups(requests, per_request=False):
    """The batches ``generate_static`` runs: its prompt-length groups, or
    one request each."""
    if per_request:
        return [[r] for r in requests]
    groups = {}
    for r in requests:
        groups.setdefault(len(r.prompt_ids), []).append(r)
    return list(groups.values())


def static_wire(plan, cfg, spec_tree, mesh_cfg, groups):
    """The collectives per class that ``generate_static`` moves on a rank by
    ``serve_wire_table``: per batch of ``groups`` one prefill and ``gen -
    1`` decode steps over the batch's rows on the rank."""
    from repro_torch.serve.step import serve_wire_table
    from repro_torch.train.step import COLLECTIVE_CLASSES

    total = dict.fromkeys(COLLECTIVE_CLASSES, 0)
    for reqs in groups:
        S = len(reqs[0].prompt_ids)
        shard = mesh_cfg.dshards > 1 and len(reqs) % mesh_cfg.dshards == 0
        rows = len(reqs) // (mesh_cfg.dshards if shard else 1)
        seq = plan.seq_parallel and S % mesh_cfg.tp == 0
        gen = max(r.max_new for r in reqs)
        for tokens, n in ((S, 1), (1, gen - 1)):
            t = serve_wire_table(plan, cfg, spec_tree, mesh_cfg, rows=rows, tokens=tokens,
                                 seq_parallel=seq and tokens == S)
            for k in total:
                total[k] += n * t[k]
    return total


def _tp_serve_rank(rank, device_name, cfg, dp, all_requests, runs, profiled):
    """One rank of phase 14 (a process of a gloo group of ``dp`` × 2): its
    blocks of phase 7's weights, ``runs`` in turn with launch counts, wire
    per forward, host<->device bytes and the kernels' first launches at
    each shape checked on its own view; returns its measurements."""
    import hashlib

    import torch

    from repro_torch import fp32_math
    from repro_torch.dist import comm
    from repro_torch.dist.spec import DIST, MeshCfg
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.launch.serve import check_wire, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine, generate_static
    from repro_torch.serve.step import serve_wire_table
    from repro_torch.train.step import COLLECTIVE_CLASSES, tp_boundaries
    from repro_torch.utils.trees import tree_leaves

    fp32_math()
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh_cfg = MeshCfg(tp=TPS_TP, dp=dp)
    mesh = make_mesh_from_cfg(mesh_cfg)
    t0 = time.perf_counter()
    _, spec_tree, storage = setup(cfg, seed=0, device=device, mesh_cfg=mesh_cfg, rank=rank)
    sync()
    setup_s = time.perf_counter() - t0
    nrt = cfg.num_groups + 1
    dist_specs = ([s for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST]
                  + [s for k, s in spec_tree.items() if k != "groups" and s.kind == DIST])
    per_forward = sum(s.reps for s in dist_specs)
    per_place = len(dist_specs)
    exits = tp_boundaries(cfg) // 2
    flash_ok = on_card and kernel_layers(cfg) > 0
    cap = max(len(r.prompt_ids) for r in all_requests) + max(r.max_new for r in all_requests)
    seen_flash, seen_paged, packs = {}, [], {}
    undo = [watch_flash(torch, seen_flash)]
    if on_card:
        undo += [watch_paged(torch, seen_paged, 8 * cfg.num_layers), watch_packing(torch, packs)]
    out = {"runs": {}, "setup_s": setup_s, "per_forward": per_forward, "exits": exits}
    for run in runs:
        label, kw, eng_kw = run["label"], run.get("plan", {}), run.get("engine")
        requests = [r for r in all_requests if r.rid in run.get("rids", (r.rid,))]
        plan = PrecisionPlan.build(nrt, round_to=2, **kw)
        packed_ar = 2 * exits if kw.get("act_round_to", 4) < 4 else 0  # per forward
        timings, hashes, engine = {"admit": [], "decode": []}, [], None
        first = len(comm.LOG)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        sync()
        t0 = time.perf_counter()
        probe, unprobe = kv_probe() if run.get("probe") else (None, None)
        rows = {}
        unkeep = keep_sampled_logits(rows) if run.get("keep_logits") and rank == 0 else None
        if eng_kw is None:
            groups = static_groups(requests, run.get("per_request", False))
            streams = {}
            for g in groups:
                if probe is not None:
                    probe["tag"] = ("prefill", tuple(r.rid for r in g), len(g[0].prompt_ids))
                streams.update(generate_static(cfg, mesh_cfg, mesh, spec_tree, storage, g,
                                               plan=plan))
        else:
            engine = ServeEngine(cfg, mesh_cfg, mesh, spec_tree, storage, plan=plan,
                                 cache_capacity=cap, **{"max_slots": SERVE_SLOTS, **eng_kw})
            instrument(engine, timings)
            if probe is not None:
                probe_engine(engine, probe)
            sample = engine._sample

            def hashed(logits, *sampling, sample=sample, hashes=hashes):
                hashes.append(hashlib.sha256(logits.detach().cpu().numpy().tobytes())
                              .hexdigest())
                return sample(logits, *sampling)

            engine._sample = hashed
            streams = {k: r.tokens for k, r in engine.run(requests).items()}
        sync()
        wall = time.perf_counter() - t0
        for undo_run in (unkeep, unprobe):
            if undo_run is not None:
                undo_run()
        got = counts()
        calls = comm.LOG[first:]
        stage_s = sum(c.stage_s for c in calls)
        rec = {"streams": streams, "wall_s": wall, "stage_s": stage_s, "launches": got,
               "hashes": hashes, "peak": torch.cuda.max_memory_allocated() if on_card else 0}
        if run.get("keep_logits") and rank == 0:
            rec["logits"] = rows
        if probe is not None:
            out.setdefault("probes", {})[label] = probe["calls"]
        # launches as the run's forwards require
        if engine is None:
            forwards = sum(max(r.max_new for r in g) for g in groups)
            packed = forwards * (per_forward + packed_ar)
            prefills = [len(g[0].prompt_ids) for g in groups]
            paged_steps = 0
        else:
            summary = engine.wire_summary()
            analytic = check_wire(engine, plan, requests)  # raises on a mismatch
            rec["host_device"] = (summary["host_device"], analytic["total"])
            forwards = summary["admissions"] + summary["decode_steps"]
            packed = forwards * packed_ar + (
                summary["admissions"] * per_forward + per_place
                if engine.weight_stationary else forwards * per_forward)
            prefills = [-(-len(r.prompt_ids) // PAGE) * PAGE if engine.paged
                        else len(r.prompt_ids) for r in requests]
            paged_steps = summary["decode_steps"] if engine.paged else 0
            # wire per forward == serve_wire_table; the placement == one forward's gathers
            for r, t in zip(engine.wire_log, engine.wire_tables(), strict=True):
                for k in COLLECTIVE_CLASSES:
                    check(r["wire"].get(k, 0) == t[k],
                          f"rank {rank} {label} step {r['step']} {r['kind']}: measured {k} "
                          f"{r['wire'].get(k, 0)} B != serve_wire_table {t[k]} B")
            by_kind = {}
            for r in engine.wire_log:
                key = f"{r['kind']} {r['tokens']}" if r["kind"] == "prefill" else "decode"
                by_kind.setdefault(key, r["wire"])
            rec["wire_by_forward"] = by_kind
            if engine.weight_stationary:
                want_place = serve_wire_table(plan, cfg, spec_tree, mesh_cfg, rows=1,
                                              tokens=1)["weights"]
                check(engine.place_wire.get("weights", 0) == want_place,
                      f"rank {rank} {label}: placement moved {engine.place_wire} B, "
                      f"one forward's gathers are {want_place} B")
                check(all(r["wire"].get("weights", 0) == 0 for r in engine.wire_log
                          if r["kind"] == "decode"), f"rank {rank} {label}: a decode step "
                                                     "moved weights")
                rec["place_wire"] = engine.place_wire
            rec["decode_ms"] = [t * 1e3 for t in timings["decode"]]
            rec["admit_ms"] = [(S, t * 1e3) for S, t in timings["admit"]]
            rec["first_logits"] = timings["first_logits"] if rank == 0 else None
            # where the streams leave the static run's: the token and a batch-1
            # run's top-2 logit gap there (every rank takes this branch alike)
            rec["diverged"] = []
            for r in requests:
                a, b = streams[r.rid], out["runs"][run["against"]]["streams"][r.rid]
                if a != b:
                    t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                    _, gaps = top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                                        mesh=mesh)
                    rec["diverged"].append((r.rid, t, a[t], b[t], gaps[t]))
        if engine is None:
            measured = comm.wire_by_traffic(calls)
            want_wire = static_wire(plan, cfg, spec_tree, mesh_cfg, groups)
            for k in COLLECTIVE_CLASSES:
                check(measured.get(k, 0) == want_wire[k],
                      f"rank {rank} {label}: measured {k} {measured.get(k, 0)} B != "
                      f"serve_wire_table {want_wire[k]} B")
        rec["wire"] = comm.wire_by_traffic(calls)
        rec["forwards"] = forwards
        want = {"flash_prefill": kernel_layers(cfg) * sum(flash_ok and S % 128 == 0
                                                      for S in prefills),
                "paged_attend": kernel_layers(cfg) * paged_steps * on_card,
                "bitpack": packed * on_card, "bitunpack": packed * on_card, "l2norm_sq": 0}
        check(got == want, f"rank {rank} {label}: launches {got}, expected {want}")
        check_seen_flash(seen_flash)
        if on_card:
            check_seen_packing(torch, packs)
        out["runs"][label] = rec
        del engine
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    for u in undo:
        u()
    if "probes" in out:  # the int8 diagnosis of phase 15 (e): report, keep no tensors
        probes = out.pop("probes")
        kept = {label: out["runs"][label].get("logits") for label in probes}
        out["probe"] = int8_probe_report(
            torch, cfg, all_requests, cfg.num_layers,
            {label: out["runs"][label]["streams"] for label in probes}, probes,
            kept if rank == 0 else None)
    out["flash_err"] = max((r["max_abs_err"] for r in seen_flash.values()), default=0.0)
    out["flash_shapes"] = sorted(seen_flash)
    out["paged_err"] = check_seen_paged(seen_paged) if seen_paged else 0.0
    out["packs"] = sorted(packs)
    if on_card and profiled:  # one 512-token admission and one warm decode step, rank 0
        plan = PrecisionPlan.build(nrt, round_to=2)
        engine = ServeEngine(cfg, mesh_cfg, mesh, spec_tree, storage, plan=plan,
                             max_slots=SERVE_SLOTS, cache_capacity=cap)
        engine.begin_stream()
        longest = [r for r in all_requests if len(r.prompt_ids) == max(len(x.prompt_ids)
                                                                       for x in all_requests)]
        engine.admit(longest[0])

        def maybe(fn, label):
            return profile(torch, fn, label) if rank == 0 else fn()

        maybe(lambda: engine.admit(longest[1]),
              f"admission of a {len(longest[1].prompt_ids)}-token prompt, 1×2 rank 0")
        engine.decode_tick()
        maybe(engine.decode_tick, f"decode step ({SERVE_SLOTS} slots), 1×2 rank 0")
    return out


def time_tp_shapes(torch, device):
    """The attention kernels at a model rank's heads at tp 2 (qwen3-1.7b: 8
    query heads over 4 kv heads): flash at B=1, S 512 beside fp32 SDPA and
    the bound, ``paged_attend`` at phase 9's decode shape with Kv 4 beside
    gather + SDPA and the bound, both in a CUDA graph; then Bitpack and
    Bitunpack at the TP halves of qwen3's per-layer lengths and embed."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attend import paged_attend

    gen = torch.Generator(device=device).manual_seed(14)
    B, H, Kv, S = 1, 8, 4, 512
    q = torch.randn((B, H, S, 128), generator=gen, device=device)
    k = torch.randn((B, Kv, S, 128), generator=gen, device=device)
    v = torch.randn((B, Kv, S, 128), generator=gen, device=device)
    err = float((flash_prefill(q, k, v) - ref.flash_prefill_ref(q, k, v)).abs().max())
    check(err <= FLASH_TOL, f"flash H={H} Kv={Kv} S={S}: max |err| {err:.3e}")
    ms = time_graph(torch, [lambda: flash_prefill(q, k, v)], reps=10)
    plain = time_cuda(torch, lambda: ref.flash_prefill_ref(q, k, v), iters=5)
    lib = time_graph(torch, [lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)], reps=10)
    bound, by = flash_bound(B, H, Kv, S, S, 0)
    flash = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
             "bound_by": by, "max_abs_err": err}
    say(f"   flash B={B} H={H} Kv={Kv} S={S}: kernel {ms * 1e3:.1f} us in a CUDA graph, plain "
        f"{plain * 1e3:.1f} us, sdpa {lib * 1e3:.1f} us in a CUDA graph, bound "
        f"{bound * 1e3:.1f} us ({by}, {bound / ms:.0%} of it); max |err| {err:.3e}")
    Bp, Kvp, G, page, width, P, lengths = 2, 4, 2, 64, 9, 19, (528, 528)
    args = paged_inputs(torch, device, gen, Bp, Kvp, G, page, width, P, lengths)
    err = float((paged_attend(*args) - ref.paged_attend_ref(*args)).abs().max())
    check(err <= PAGED_TOL, f"paged_attend Kv={Kvp}: max |err| {err:.3e}")
    copies = [args] + [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                       for _ in range(COLD_COPIES - 1)]
    cold = time_graph(torch, [lambda a=a: paged_attend(*a) for a in copies])
    del copies
    warm = time_graph(torch, [lambda: paged_attend(*args)], reps=10)
    plain = time_cuda(torch, lambda: ref.paged_attend_ref(*args), iters=5)
    lib = time_cuda(torch, lambda: gather_sdpa(torch, *args))
    bound = paged_bound(Bp, Kvp, G, page, width, lengths)
    paged = {"ms": cold, "warm_ms": warm, "plain_ms": plain, "gather_sdpa_ms": lib,
             "bound_ms": bound, "max_abs_err": err}
    say(f"   paged_attend B={Bp} Kv={Kvp} G={G}, {width} pages of {page}, lengths {lengths[0]}: "
        f"kernel in a CUDA graph {cold * 1e3:.1f} us with the L2 cold, {warm * 1e3:.1f} us "
        f"warm, plain {plain * 1e3:.1f} us, gather+sdpa {lib * 1e3:.1f} us, bound "
        f"{bound * 1e3:.1f} us (bytes, {bound / cold:.0%} of it cold); max |err| {err:.3e}")
    time_qwen3_packing(torch, device, lengths=(*(n // TPS_TP for n in QWEN3_LAYER),
                                               QWEN3_EMBED // TPS_TP))
    return {"flash": flash, "paged": paged}


def tp_serve_path(torch, device, phase7, *, cfg=None, b_rids=TPS_B_RIDS, b_gen=TPS_B_GEN):
    """Full-width qwen3-1.7b (phase 7's weights, plan and requests) served
    on a 1×2 mesh (a: ``TPS_RUNS_A``) and a weight-stationary 2×2 mesh
    (b: phase 7's requests ``b_rids`` at ``b_gen`` tokens, ``TPS_RUNS_B``)
    of gloo ranks on ``device``. Each rank checks its launches, wire and
    host<->device bytes (:func:`_tp_serve_rank`); here the streams inside
    each mesh and against phase 7's one-device streams, the admission
    logits against phase 7's, and the logits' hashes across ranks.
    Launch counts, packing records and the profile are read on a card
    only, so the phase rehearses on the CPU at a reduced config. Returns
    the measurements; raises on a failed check."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.serve import setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import Request

    cfg = cfg or phase7["cfg"]
    on_card = device.type == "cuda"
    threads = 2 if on_card else 1
    one_static, one_logits = phase7["static"], phase7["runs"]["engine"]["first_logits"]
    bound = TPS_LOGIT_RTOL * float(one_logits.abs().max())
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        say(f"   gloo ranks on one card: {smi}")
    reqs_a = phase7["requests"]
    reqs_b = [Request(rid=r.rid, prompt_ids=r.prompt_ids, max_new=b_gen)
              for r in reqs_a if r.rid in b_rids]
    out = {}
    for mesh, dp, reqs, runs in (("1x2", 1, reqs_a, TPS_RUNS_A), ("2x2", 2, reqs_b, TPS_RUNS_B)):
        t0 = time.perf_counter()
        ranks = spawn_ranks(_tp_serve_rank, dp * TPS_TP, str(device), cfg, dp, reqs, runs,
                            mesh == "1x2", threads=threads, timeout_s=900)
        ranks_s = time.perf_counter() - t0
        r0 = ranks[0]["runs"]
        for r, o in enumerate(ranks):  # every rank samples the same ids from the same bits
            for label in r0:
                check(o["runs"][label]["streams"] == r0[label]["streams"],
                      f"{mesh}: rank {r}'s {label} streams differ from rank 0's")
                check(o["runs"][label]["hashes"] == r0[label]["hashes"],
                      f"{mesh}: rank {r}'s {label} logits differ from rank 0's")
        # streams inside the mesh: every engine as the static run of its plan
        for run in runs:
            if "against" in run:
                tie = run.get("near_tie", 0.0)
                for rid, t, a, b, gap in r0[run["label"]]["diverged"]:
                    say(f"   {mesh} {run['label']}: DIVERGED request {rid} at token {t}: {a} "
                        f"against {run['against']}'s {b}, batch-1 top-2 logit gap {gap:.3e}")
                    check(gap < tie, f"{mesh} {run['label']}: request {rid} left the static "
                                     f"run {run['against']} at a top-2 gap {gap:.3e} (bound "
                                     f"{tie})")
        # against one device: phase 7's streams (fp32 activations), the admission logits
        diverged = []
        for r in reqs:
            got, want = r0["static"]["streams"][r.rid], one_static[r.rid][:r.max_new]
            if got != want:
                t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
                diverged.append((r, t, got[t], want[t]))
        if diverged:  # one device's top-2 logit gap where a stream left it
            mesh_cfg1, spec1, storage1 = setup(cfg, seed=0, device=device)
            plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
            for r, t, a, b in diverged:
                _, gaps = top2_gaps(torch, cfg, mesh_cfg1, spec1, storage1, plan, r)
                say(f"   {mesh}: DIVERGED request {r.rid} at token {t}: {a} against one "
                    f"device's {b}, one device's top-2 logit gap {gaps[t]:.3e}")
                check(gaps[t] < bound, f"{mesh}: request {r.rid} left one device's stream at "
                                       f"a top-2 gap {gaps[t]:.3e} >= {bound:.3e}")
            del storage1
        label = "engine" if mesh == "1x2" else "weight-stationary"
        logits = r0[label]["first_logits"]
        gap = float((logits - one_logits).abs().max())
        check(gap <= bound, f"{mesh}: the {len(reqs[0].prompt_ids)}-token admission's logits "
                            f"{gap:.3e} from one device's (bound {bound:.3e})")
        say(f"   {mesh} ({len(ranks)} ranks, {ranks_s:.1f} s, set-up "
            f"{[round(o['setup_s'], 1) for o in ranks]} s): engines as their static runs, "
            f"streams and logits' hashes equal on every rank; "
            f"{len(reqs) - len(diverged)} of {len(reqs)} equal to one device's; "
            f"the {len(reqs[0].prompt_ids)}-token admission's logits within {gap:.3e} of one "
            f"device's (bound {bound:.3e}, {TPS_LOGIT_RTOL} × max |logit|)")
        for label, rec in r0.items():
            tokens = sum(len(s) for s in rec["streams"].values())
            peaks = [round(o["runs"][label]["peak"] / 2**30, 2) for o in ranks]
            say(f"   {mesh} {label}: {rec['wall_s']:.2f} s, {tokens} tokens, "
                f"{tokens / rec['wall_s']:.1f} tokens/s, gloo staging "
                f"{rec['stage_s'] / rec['wall_s']:.1%}, launches {rec['launches']}, "
                f"memory peak per rank {peaks} GiB")
            if "decode_ms" in rec:
                dec = sorted(rec["decode_ms"])
                by_len = {}
                for S, t in rec["admit_ms"]:
                    by_len.setdefault(S, []).append(round(t, 2))
                say(f"   {mesh} {label}: decode ms/step median {dec[len(dec) // 2]:.2f} (min "
                    f"{dec[0]:.2f}, max {dec[-1]:.2f}, {len(dec)} steps); admission ms "
                    f"{dict(sorted(by_len.items()))}; host_device {rec['host_device'][0]} B "
                    f"== serve_host_device_bytes")
                say(f"   {mesh} {label}: wire B a rank per forward (== serve_wire_table): "
                    f"{rec['wire_by_forward']}"
                    + (f"; placement {rec['place_wire']}" if "place_wire" in rec else ""))
            else:
                say(f"   {mesh} {label}: wire B a rank (== serve_wire_table) {rec['wire']}")
        say(f"   {mesh}: kernels at the new shapes held to their plain versions: flash "
            f"{ranks[0]['flash_shapes']} within {max(o['flash_err'] for o in ranks):.3e}, "
            f"paged_attend within {max(o['paged_err'] for o in ranks):.3e}, "
            f"{len(ranks[0]['packs'])} (kernel, length, round_to) of Bitpack/Bitunpack "
            "byte- and bit-equal")
        out[mesh] = ranks
    launches = {k: sum(o["runs"][label]["launches"][k] for ranks in out.values()
                       for o in ranks for label in o["runs"]) for k in counts()}
    errs = {"flash": max(o["flash_err"] for ranks in out.values() for o in ranks),
            "paged": max(o["paged_err"] for ranks in out.values() for o in ranks)}
    return {"meshes": out, "launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# phase 15: full-width qwen3-1.7b served with sampled requests, int8 KV,
# speculative decoding and a sliding window
# ---------------------------------------------------------------------------

# (a)'s sampling: phase 7's prompts at temperature 0.8, top-p 0.95, top-k 40,
# request i at seed 100 + i but request 4 at the largest uint32 seed
FEAT_SAMPLING = dict(temperature=0.8, top_p=0.95, top_k=40)
FEAT_SEEDS = (100, 101, 102, 103, 2**32 - 1)
FEAT_SPEC_K = 3
FEAT_WINDOW = 256  # (d): the 512- and 384-token prompts ring
# a stream of (c) or (e) may leave the one it is held to only where that
# run's draw lies within this share of cw[-1] of a cumulative boundary:
# a row's GEMM bits depend on the batch's row count on the card (PERF.md §6)
FEAT_NEAR_TIE = 1e-4
INT8_LOGIT_RTOL = 0.05  # scenario_perf_levers.py's bar for int8 decode logits
# (e): the 1×2 int8 engine may leave the 1×2 static run only at an int8 tie
# (``int8_tie``). The static run prefills the two 512-token prompts as one
# batch of 2, the engine each alone; cuBLAS's row bits depend on the row
# count, so every K and V differs by ulps and a code whose x / scale sits
# on a rounding midpoint moves by a step. Measured on an H100 at 4 layers
# (tools/int8_probe.py, twice, the same both times): request 0 (seed 100)
# parts at token 6; 179 and 223 codes flipped on ranks 0 and 1 over the
# 518 positions read, each within 8.4e-3 / 1.37e-2 code steps of a
# midpoint; the logits rows there 8.4e-4 apart; the draw 1.405e-4 (static)
# and 1.445e-4 (engine) of cw[-1] from its nearest CDF step. The bounds
# are those margins; at 28 layers the same pair held exactly
INT8_TIE_MIDPOINT = 1.4e-2
INT8_TIE_DRAW = 1.5e-4


def keep_sampled_logits(store):
    """Route ``generate_static``'s sampler through a recorder that keeps, on
    the host, every logits row it samples from, by ``(seed, step)`` (phase
    15's seeds name its requests). Returns the undo function."""
    import numpy as np

    from repro_torch.serve import engine as E

    sample = E.sample_tokens

    def kept(logits, vocab, temperature, top_p, top_k, seed, step):
        rows = logits.detach().float().cpu().numpy()
        for row, s, n in zip(rows, np.asarray(seed).tolist(), np.asarray(step).tolist()):
            store[(int(s), int(n))] = row[:vocab].copy()
        return sample(logits, vocab, temperature, top_p, top_k, seed, step)

    E.sample_tokens = kept
    return lambda: setattr(E, "sample_tokens", sample)


def sampled_requests(requests):
    """``requests`` with (a)'s sampling, request i at ``FEAT_SEEDS[i]``."""
    from repro_torch.plan import SamplingParams
    from repro_torch.serve.engine import Request

    return [Request(rid=r.rid, prompt_ids=r.prompt_ids, max_new=r.max_new,
                    sampling=SamplingParams(**FEAT_SAMPLING, seed=FEAT_SEEDS[i]))
            for i, r in enumerate(requests)]


def draw_distance(torch, logits_row, vocab, s, step):
    """How far the sampler's draw for ``logits_row`` (request sampling
    ``s``, emitted index ``step``) lies from its nearest cumulative
    boundary, as a share of ``cw[-1]`` (the sampler's own ops); greedy:
    the top-2 logit gap over max |logit|."""
    from repro_torch.serve.sampling import uniform_for

    lg = logits_row[:vocab].double()
    if s.greedy:
        top = torch.topk(lg, 2).values
        return float((top[0] - top[1]) / lg.abs().max())
    scaled = lg.float() / max(s.temperature, 1e-6)
    ranked = torch.sort(scaled, descending=True, stable=True).values
    e = torch.exp(ranked - ranked.max())
    probs = e / e.double().sum().float()
    keep = torch.arange(vocab, device=lg.device) < (s.top_k or vocab)
    keep &= (torch.cumsum(probs.double(), 0).float() - probs) < s.top_p
    cw = torch.cumsum((probs * keep).double(), 0)
    target = float(uniform_for([s.seed & 0xFFFFFFFF], [step])[0]) * float(cw[-1])
    return float((cw - target).abs().min() / cw[-1])


def static_trace(torch, cfg, mesh_cfg, spec_tree, storage, plan, req, mesh=None):
    """One request alone (batch 1) through the static path, keeping each
    step's logits row and the draw's distance to its nearest boundary:
    what a diverging stream is held against."""
    from repro_torch.serve.sampling import sample_tokens
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    S, dev, s = len(req.prompt_ids), storage["embed"].device, req.sampling
    pre = make_prefill_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan,
                            cache_capacity=S + req.max_new)
    dec = make_decode_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan)
    logits, caches = pre(storage, {"tokens": torch.tensor([req.prompt_ids], device=dev)})
    toks, dists, rows = [], [], []
    for i in range(req.max_new):
        row = logits[0, -1]
        rows.append(row.cpu())
        dists.append(draw_distance(torch, row, cfg.vocab_size, s, i))
        tok = sample_tokens(logits[:, -1], cfg.vocab_size, [s.temperature], [s.top_p],
                            [s.top_k], [s.seed & 0xFFFFFFFF], [i])
        toks.append(int(tok[0]))
        if i + 1 < req.max_new:
            feed = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
            pos = torch.tensor(S + i, dtype=torch.int32, device=dev)
            logits, caches = dec(storage, caches, {"tokens": feed, "pos": pos})
    return toks, dists, rows


def engine_logits(torch, cfg, mesh_cfg, spec_tree, storage, plan, req, **kw):
    """The logits rows one request samples from in a 1-slot engine."""
    from repro_torch.serve.engine import ServeEngine

    rows = []
    engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan, max_slots=1,
                         cache_capacity=len(req.prompt_ids) + req.max_new, **kw)
    sample = engine._sample

    def kept(logits, *sampling):
        rows.append(logits[0, -1].cpu())
        return sample(logits, *sampling)

    engine._sample = kept
    engine.run([req])
    return rows


def diverged_at(got, want):
    """The first index where two streams part (None when equal)."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None if len(got) == len(want) else min(len(got), len(want)))


def hold_streams(torch, label, got, want, requests, setup, plan, *, near_tie=0.0,
                 what="the reference run"):
    """``got`` against ``want`` request by request. A divergence prints its
    position, the draw's distance to its nearest boundary in a batch-1
    static run (top-2 gap for greedy) and the logits' max difference
    between a 1-slot engine and that run there; it fails unless the
    distance is below ``near_tie``. Returns the printed cases."""
    cfg, mesh_cfg, spec_tree, storage = setup
    cases = []
    for r in requests:
        t = diverged_at(got[r.rid], want[r.rid])
        if t is None:
            continue
        _, dists, rows = static_trace(torch, cfg, mesh_cfg, spec_tree, storage, plan, r)
        erows = engine_logits(torch, cfg, mesh_cfg, spec_tree, storage, plan, r)
        gap = float((erows[t] - rows[t]).abs().max()) if t < len(erows) else float("nan")
        say(f"   {label}: DIVERGED request {r.rid} (prompt {len(r.prompt_ids)}) at token {t}: "
            f"{got[r.rid][t]} against {what}'s {want[r.rid][t]}; the draw {dists[t]:.3e} of "
            f"cw[-1] from a boundary (batch-1 static), logits max |1-slot engine - static| "
            f"{gap:.3e}")
        cases.append((r.rid, t, dists[t]))
        check(dists[t] < near_tie, f"{label}: request {r.rid} left {what} at token {t}, "
                                   f"draw {dists[t]:.3e} from a boundary (bound {near_tie})")
    return cases


def check_sampler_rows(torch, device, vocab):
    """The sampler on the card at qwen3's vocabulary: each of 8 rows gives
    the same id alone as in the batch, twice."""
    from repro_torch.serve.sampling import sample_tokens

    gen = torch.Generator(device=device).manual_seed(15)
    lg = torch.randn((8, vocab), generator=gen, device=device) * 3
    args = ([0.8, 0.0, 1.5, 0.5, 0.8, 0.8, 1.0, 0.3], [0.95, 1, 0.5, 1, 0.95, 1, 0.5, 0.95],
            [40, 0, 0, 1, 0, 40, 0, 40], [100, 0, 2**32 - 1, 2**31, 7, 8, 9, 10], list(range(8)))
    batch = sample_tokens(lg, vocab, *args)
    check(torch.equal(batch, sample_tokens(lg, vocab, *args)), "sampler: two calls differ")
    for r in range(8):
        one = sample_tokens(lg[r:r + 1], vocab, *([a[r]] for a in args))
        check(int(one[0]) == int(batch[r]), f"sampler row {r}: alone {int(one[0])}, in a batch "
                                            f"of 8 {int(batch[r])}")
    two = [a[:2] for a in args]

    def per_call(fn, n=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    ms = per_call(lambda: sample_tokens(lg[:2], vocab, *two))
    argmax_ms = per_call(lambda: torch.argmax(lg[:2], dim=-1))
    say(f"   sampler on the card, vocab {vocab}: each of 8 rows the same alone as in the "
        f"batch, two calls equal; 2 rows {ms:.3f} ms a call against argmax's "
        f"{argmax_ms:.3f} ms (host clock to a sync)")
    return {"sampler_ms": ms, "argmax_ms": argmax_ms}


def int8_divergences(torch, cfg, requests, got, want, got_rows, want_rows):
    """(e)'s 1×2 streams against one device's, both with int8 KV. The TP
    halves' summation order moves K and V by ~1e-7, which moves an int8 code
    at a rounding midpoint by a whole step (amax / 127), so the near-tie
    rule of fp32 cannot hold here (PERF.md §6, PR 19). A divergence at token
    t is allowed where the two runs' logits rows at t are within int8's own
    bar of each other (relative l2 below ``INT8_LOGIT_RTOL``, the bar int8
    logits meet against fp32's) and sampling each row with the request's
    key gives exactly the two tokens seen (the divergence is the logits',
    not the sampler's or the host loop's). Prints each case; returns them."""
    from repro_torch.serve.sampling import sample_tokens

    cases = []
    for r in requests:
        t = diverged_at(got[r.rid], want[r.rid])
        if t is None:
            continue
        s = r.sampling
        key = (s.seed & 0xFFFFFFFF, t)
        a, b = (torch.from_numpy(rows[key]) for rows in (got_rows, want_rows))
        rel = float((a - b).norm() / b.norm())
        toks = [int(sample_tokens(x[None], cfg.vocab_size, [s.temperature], [s.top_p],
                                  [s.top_k], [key[0]], [t])[0]) for x in (a, b)]
        dist = draw_distance(torch, b, cfg.vocab_size, s, t)
        say(f"   (e) 1×2: DIVERGED request {r.rid} (prompt {len(r.prompt_ids)}) at token {t}: "
            f"{got[r.rid][t]} against one device's {want[r.rid][t]}; logits rows "
            f"{rel:.3e} apart (relative l2; max {float((a - b).abs().max()):.3e}), one "
            f"device's draw {dist:.3e} of cw[-1] from a boundary; resampled {toks}")
        check(rel < INT8_LOGIT_RTOL and toks == [got[r.rid][t], want[r.rid][t]],
              f"(e): request {r.rid} left one device's stream at token {t} with logits "
              f"{rel:.3e} apart (bound {INT8_LOGIT_RTOL}) and resampled ids {toks}")
        cases.append((r.rid, t, rel, dist))
    return cases


def kv_probe():
    """Record every int8 KV quantization (``models.attention._quantize_kv``)
    under the tag the caller sets in ``rec["tag"]``: ``(tag, x, codes,
    scales)`` on the host, ``x`` the fp32 K or V before the codes. A
    forward quantizes K then V at each layer in turn. Returns ``(rec,
    undo)``."""
    from repro_torch.models import attention as A

    quant, rec = A._quantize_kv, {"tag": None, "calls": []}

    def recorded(x):
        q, s = quant(x)
        rec["calls"].append((rec["tag"], x.detach().float().cpu(), q.cpu(), s.cpu()))
        return q, s

    A._quantize_kv = recorded
    return rec, lambda: setattr(A, "_quantize_kv", quant)


def probe_engine(engine, rec):
    """Tag ``kv_probe``'s records of ``engine``: an admission by its request,
    a decode tick by ``{slot: (rid, position written)}``."""
    admit, tick = engine.admit, engine.decode_tick

    def tagged_admit(req):
        rec["tag"] = ("prefill", (req.rid,), 0)
        admit(req)

    def tagged_tick():
        rec["tag"] = ("decode", {slot: (st.req.rid, int(engine._pos_host[slot]))
                                 for slot, st in engine._active.items()})
        tick()

    engine.admit, engine.decode_tick = tagged_admit, tagged_tick


def kv_by_request(calls, layers):
    """``kv_probe`` records -> ``{(rid, layer, "k" | "v"): {position: (x, codes,
    scales)}}`` (each a ``(Kv, hd)`` / ``(Kv,)`` row). Tags: ``("prefill",
    rids, S)`` a static group's calls in order (its prefill, then a decode
    a forward, writing position S + i), ``("prefill", (rid,), 0)`` an
    admission, ``("decode", {slot: (rid, position)})`` an engine tick."""
    out, per_tag = {}, {}
    for tag, x, q, s in calls:
        if x.ndim == 3:  # a per-slot decode write: (B, Kv, hd), one token a slot
            x, q, s = x[:, None], q[:, None], s[:, None]
        key = id(tag)
        j = per_tag.setdefault(key, [tag, 0])[1]
        per_tag[key][1] += 1
        layer, kv = (j % (2 * layers)) // 2, "kv"[j % 2]
        fwd = j // (2 * layers)
        if tag[0] == "decode":
            rows = {slot: (rid, pos) for slot, (rid, pos) in tag[1].items()}
        elif fwd == 0:  # a prefill: every position of each row
            rows = None
        else:  # a static group's decode step fwd - 1
            rows = {b: (rid, tag[2] + fwd - 1) for b, rid in enumerate(tag[1])}
        if rows is None:
            for b, rid in enumerate(tag[1]):
                d = out.setdefault((rid, layer, kv), {})
                for p in range(x.shape[1]):
                    d[p] = (x[b, p], q[b, p], s[b, p])
        else:
            for b, (rid, pos) in rows.items():
                out.setdefault((rid, layer, kv), {})[pos] = (x[b, 0], q[b, 0], s[b, 0])
    return out


def top2_margin(torch, row, vocab, s, step):
    """``(top-2 gap, the gap in fp32 ulps of the top logit, the draw's
    distance to its nearest cumulative boundary as a share of cw[-1])``."""
    import numpy as np

    top = torch.topk(torch.as_tensor(row)[:vocab].float(), 2).values
    gap = float(top[0] - top[1])
    return gap, gap / float(np.spacing(np.float32(top[0]))), draw_distance(
        torch, torch.as_tensor(row), vocab, s, step)


def midpoint_gap(y: float) -> float:
    """How far ``y = x / scale`` lies from the nearest rounding midpoint
    (k + 0.5), in code steps: where an int8 code can flip on an ulp."""
    return abs(abs(y) % 1.0 - 0.5)


def int8_tie(case) -> bool:
    """``INT8_TIE``'s rule on one parting of phase 15 (e): some rank saw an
    int8 code differ between the runs, every such code sat within
    ``INT8_TIE_MIDPOINT`` code steps of a rounding midpoint in one of them
    (a rank with no flip has gap ``None``), and the draw at the parting
    token lies within ``INT8_TIE_DRAW`` of ``cw[-1]`` of a CDF step in
    both runs."""
    gaps = [g for g in case["mid_gaps"] if g is not None]
    return (bool(gaps) and all(g <= INT8_TIE_MIDPOINT for g in gaps)
            and max(case["static_margin"][2], case["engine_margin"][2]) <= INT8_TIE_DRAW)


def int8_probe_report(torch, cfg, requests, layers, streams, probes, rows):
    """Where the 1×2 engine's int8 streams leave the static run's, and
    why, request by request: the token at which they part, both runs' top-2
    logit gaps there (absolute and in fp32 ulps of the top logit) and the
    draw's distance to its nearest CDF step, and the int8 KV codes and
    scales that differ between the runs over the positions that token
    reads, by layer, with ``x / scale`` on either side of each flipped
    code step. ``streams``, ``probes`` (``kv_probe`` calls) and ``rows``
    (kept logits rows by ``(seed, step)``, rank 0 only, else None) by run
    label. Returns ``{"lines", "cases"}``: printable lines, and per parting
    its numbers (``diverged`` (rid, t), the margins on rank 0,
    ``mid_gap`` the largest midpoint gap of a flipped code, ``flips``)."""
    import numpy as np

    lines, cases = [], []
    kv = None
    for r in requests:
        t = diverged_at(streams["engine"][r.rid], streams["static"][r.rid])
        if t is None:
            continue
        kv = kv or {label: kv_by_request(probes[label], layers) for label in ("static", "engine")}
        S = len(r.prompt_ids)
        case = {"diverged": (r.rid, t)}
        lines.append(f"request {r.rid} (prompt {S}) at token {t}: engine "
                     f"{streams['engine'][r.rid][t]}, static {streams['static'][r.rid][t]}")
        if rows is not None:
            key = (r.sampling.seed & 0xFFFFFFFF, t)
            for label in ("static", "engine"):
                gap, ulps, dist = top2_margin(torch, rows[label][key], cfg.vocab_size, r.sampling,
                                              t)
                case[f"{label}_margin"] = (gap, ulps, dist)
                lines.append(f"  {label}: top-2 gap {gap:.6e} ({ulps:.1f} fp32 ulps of the top "
                             f"logit), the draw {dist:.6e} of cw[-1] from its nearest CDF step")
            a, b = (torch.as_tensor(rows[label][key]) for label in ("engine", "static"))
            lines.append(f"  logits rows at token {t}: max |engine - static| "
                         f"{float((a - b).abs().max()):.6e}")
            for i in range(t + 1):
                k = (r.sampling.seed & 0xFFFFFFFF, i)
                if not np.array_equal(rows["engine"][k], rows["static"][k]):
                    d = float(np.abs(rows["engine"][k] - rows["static"][k]).max())
                    lines.append(f"  first logits row that differs: token {i} (max {d:.6e})")
                    break
        mids = []
        for layer in range(layers):
            n = {"code": 0, "scale": 0, "x": 0}
            shown = []
            for which in "kv":
                a, b = kv["engine"][(r.rid, layer, which)], kv["static"][(r.rid, layer, which)]
                for p in range(S + t):
                    xa, qa, sa = a[p]
                    xb, qb, sb = b[p]
                    n["x"] += int((xa != xb).any(dim=-1).sum())
                    n["scale"] += int((sa != sb).sum())
                    diff = (qa != qb).nonzero().tolist()
                    n["code"] += len(diff)
                    for h, e in diff:
                        ya, yb = float(xa[h, e] / sa[h]), float(xb[h, e] / sb[h])
                        mids.append(min(midpoint_gap(ya), midpoint_gap(yb)))
                        if len(shown) < 3:
                            shown.append(f"{which} pos {p} head {h} elem {e}: codes "
                                         f"{int(qa[h, e])}/{int(qb[h, e])}, x/scale "
                                         f"{ya:.7f}/{yb:.7f}, x {float(xa[h, e]):.9e}/"
                                         f"{float(xb[h, e]):.9e}")
            lines.append(f"  layer {layer}: {n['code']} int8 codes, {n['scale']} scales and "
                         f"{n['x']} (position, head) K/V rows differ over positions [0, {S + t}) "
                         f"(engine/static){'; ' + '; '.join(shown) if shown else ''}")
        case["flips"], case["mid_gap"] = len(mids), (max(mids) if mids else None)
        if mids:
            lines.append(f"  {len(mids)} flipped codes; every flip's x/scale lies within "
                         f"{max(mids):.3e} of a rounding midpoint (.5) in one run")
        cases.append(case)
    return {"lines": lines, "cases": cases}


def dist_per_forward(spec_tree):
    """Bitpack/Bitunpack launches a forward: each stacked DIST leaf once a
    layer, each top-level DIST leaf once."""
    from repro_torch.dist.spec import DIST
    from repro_torch.utils.trees import tree_leaves

    return (sum(s.reps for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST)
            + sum(1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST))


def mesh_int8_runs(device, cfg, sampled):
    """Phase 15 (e)'s 1×2 runs: ``sampled`` with int8 KV through the static
    path, then the 2-slot engine, on two gloo ranks, both probed
    (``kv_probe``) and their logits rows kept on rank 0. Where the engine
    leaves the static run, prints ``int8_probe_report``'s diagnosis of
    each rank. Returns the ranks' records."""
    from repro_torch.launch.mesh import spawn_ranks

    runs = ({"label": "static", "plan": {"int8_kv": True}, "keep_logits": True, "probe": True},
            {"label": "engine", "plan": {"int8_kv": True}, "engine": {}, "against": "static",
             "keep_logits": True, "probe": True})
    ranks = spawn_ranks(_tp_serve_rank, TPS_TP, str(device), cfg, 1, sampled, runs, False,
                        threads=2 if device.type == "cuda" else 1, timeout_s=900)
    for rank, o in enumerate(ranks):
        for line in o["probe"]["lines"]:
            say(f"   (e) int8 probe, rank {rank}: {line}")
    return ranks


def features_path(torch, device, phase7, *, cfg=None, lens=SERVE_LENS, gen=SERVE_GEN,
                  page=PAGE, window=FEAT_WINDOW, spec_k=FEAT_SPEC_K, mesh_run=True):
    """Full-width qwen3-1.7b (phase 7's weights from seed 0 and plan) served
    (a) with sampled requests, (b) with int8 KV, (c) with speculative
    decoding (self and tiny drafts), (d) with a sliding window, and (e) at
    1×2 with sampled requests and int8 KV. Every run's launches are zeroed
    before and read after, and the first launch at each new shape is held
    to its plain version. Launch counts, memory and the sampler's card
    check are read on a card only, so the phase rehearses on the CPU at a
    reduced config. Returns the measurements; raises on a failed check."""
    from repro_torch.launch.serve import check_wire, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import serve_paged_kv_bytes
    from repro_torch.serve.engine import Request, ServeEngine, generate_static
    from repro_torch.serve.spec import DraftBundle, build_draft

    cfg = cfg or phase7["cfg"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    sync()
    say(f"   weights from seed 0 in {time.perf_counter() - t0:.2f} s")
    setup4 = (cfg, mesh_cfg, spec_tree, storage)
    nrt = cfg.num_groups + 1
    plan = PrecisionPlan.build(nrt, round_to=2)
    plan8 = PrecisionPlan.build(nrt, round_to=2, int8_kv=True)
    greedy = [Request(rid=r.rid, prompt_ids=r.prompt_ids, max_new=gen)
              for r in phase7["requests"]]
    sampled = sampled_requests(greedy)
    cap = max(lens) + gen
    per_forward = dist_per_forward(spec_tree)
    flash_ok = on_card and cfg.head_dim % 128 == 0
    out = {}
    if on_card:
        out["sampler"] = check_sampler_rows(torch, device, cfg.vocab_size)
    seen_flash, seen_paged, packs = {}, [], {}
    undo = [watch_flash(torch, seen_flash)]
    if on_card:
        undo += [watch_paged(torch, seen_paged, 8 * cfg.num_layers), watch_packing(torch, packs)]

    def viable(lengths):
        return cfg.num_layers * sum(flash_ok and S % 128 == 0 for S in lengths)

    def run(label, requests, plan, *, engine=None, draft=None, **kw):
        """One run (static when ``engine`` is None, else ``ServeEngine(**engine)``)
        with its launches checked; returns its streams and record."""
        timings, rec = {"admit": [], "decode": []}, {}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        sync()
        t0 = time.perf_counter()
        if engine is None:
            streams = generate_static(cfg, mesh_cfg, None, spec_tree, storage, requests,
                                      plan=plan, **kw)
            groups = static_groups(requests)
            packed = per_forward * sum(max(r.max_new for r in g) for g in groups)
            prefills, paged_steps = [len(g[0].prompt_ids) for g in groups], 0
        else:
            eng = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                              max_slots=SERVE_SLOTS, draft=draft, **engine)
            instrument(eng, timings)
            if draft is not None:
                rec["rejections"] = watch_spec(eng)
            streams = {k: r.tokens for k, r in eng.run(requests).items()}
            summary = eng.wire_summary()
            analytic = check_wire(eng, plan, requests)  # raises on a mismatch
            rec.update(summary=summary, analytic=analytic["total"])
            steps = summary.get("spec_rounds", summary["decode_steps"])
            packed = per_forward * (summary["admissions"] + steps)
            if draft is not None:  # the draft's prefills and k + 1 micro steps a round
                packed += dist_per_forward(draft.spec_tree) * (
                    summary["admissions"] + steps * (spec_k + 1))
                # its prefills (of the unpadded prompts) take flash by the same rule
                draft_flash = draft.cfg.num_layers * sum(
                    on_card and draft.cfg.head_dim % 128 == 0 and len(r.prompt_ids) % 128 == 0
                    for r in requests)
            prefills = [-(-len(r.prompt_ids) // page) * page if eng.paged
                        else len(r.prompt_ids) for r in requests]
            paged_steps = (steps if eng.paged and not plan.int8_kv and draft is None else 0)
            if eng.paged:
                rec["residency"] = eng.kv_residency()
        sync()
        wall = time.perf_counter() - t0
        got = counts()
        want = {"flash_prefill": viable(prefills) + (draft_flash if draft is not None else 0),
                "paged_attend": cfg.num_layers * paged_steps * on_card,
                "bitpack": packed * on_card, "bitunpack": packed * on_card, "l2norm_sq": 0}
        check(got == want, f"{label}: launches {got}, expected {want}")
        check_seen_flash(seen_flash)
        if on_card:
            check_seen_packing(torch, packs)
        tokens = sum(len(s) for s in streams.values())
        dec = sorted(timings["decode"])
        by_len = {}
        for S, t in timings["admit"]:
            by_len.setdefault(S, []).append(round(t * 1e3, 2))
        eng = None  # its caches go before the next run (instrument's closures: gc)
        gc.collect()
        rec.update(streams=streams, wall_s=wall, tokens=tokens, launches=got,
                   peak=torch.cuda.max_memory_allocated() if on_card else 0,
                   decode_ms=dec[len(dec) // 2] * 1e3 if dec else None, admit_ms=by_len,
                   first_logits=timings.get("first_logits"))
        line = (f"   {label}: {wall:.2f} s, {tokens} tokens, {tokens / wall:.1f} tokens/s, "
                f"memory peak {rec['peak'] / 2**30:.2f} GiB, launches {got}")
        if dec:
            what = "ms a round" if draft is not None else "decode ms/step"
            line += (f"; {what} median {dec[len(dec) // 2] * 1e3:.2f} (min {dec[0] * 1e3:.2f}, "
                     f"max {dec[-1] * 1e3:.2f}, {len(dec)}); admission ms {by_len}")
        if engine is not None:
            line += f"; host_device {rec['summary']['host_device']} B == the model"
        say(line)
        out[label] = rec
        return streams

    # (a) sampled: static, contiguous engine, paged engine — exact
    a_static = run("(a) sampled static", sampled, plan)
    a_engine = run("(a) sampled engine", sampled, plan, engine={"cache_capacity": cap})
    hold_streams(torch, "(a) sampled engine", a_engine, a_static, sampled, setup4, plan,
                 what="the static run")
    a_paged = run("(a) sampled paged engine", sampled, plan,
                  engine={"cache_capacity": cap, "paged": True, "page_size": page})
    hold_streams(torch, "(a) sampled paged engine", a_paged, a_engine, sampled, setup4, plan,
                 what="the contiguous engine")
    say(f"   (a): engine == static and paged == contiguous for all {len(sampled)} sampled "
        f"streams (seeds {list(FEAT_SEEDS)})")

    # (b) int8 KV: greedy static, contiguous and paged engines; then (e)'s one-device run
    b_static = run("(b) int8 static", greedy, plan8)
    b_engine = run("(b) int8 engine", greedy, plan8, engine={"cache_capacity": cap})
    hold_streams(torch, "(b) int8 engine", b_engine, b_static, greedy, setup4, plan8,
                 what="the int8 static run")
    b_paged = run("(b) int8 paged engine", greedy, plan8,
                  engine={"cache_capacity": cap, "paged": True, "page_size": page})
    hold_streams(torch, "(b) int8 paged engine", b_paged, b_engine, greedy, setup4, plan8,
                 what="the int8 contiguous engine")
    fp32 = phase7["static"]
    same = sum(b_static[r.rid] == fp32[r.rid][:gen] for r in greedy)
    # the 512-token admission's first decode logits: int8 against fp32
    r0 = greedy[0]
    rows = {p.int8_kv: static_trace(torch, cfg, mesh_cfg, spec_tree, storage, p,
                                    Request(rid=0, prompt_ids=r0.prompt_ids, max_new=2))[2][1]
            for p in (plan, plan8)}
    rel = float((rows[True] - rows[False]).norm() / rows[False].norm())
    check(rel < INT8_LOGIT_RTOL, f"(b): int8 decode logits {rel:.3e} from fp32's (relative l2)")
    res = out["(b) int8 paged engine"]["residency"]
    want = serve_paged_kv_bytes(cfg, page_size=page, requests=[(len(r.prompt_ids), gen)
                                                               for r in greedy], int8_kv=True)
    fp = serve_paged_kv_bytes(cfg, page_size=1, requests=[(1, 0)])["bytes_per_page"]
    check(res["bytes_per_page"] == want["bytes_per_page"],
          f"(b): {res['bytes_per_page']} B a page, serve_paged_kv_bytes {want['bytes_per_page']}")
    say(f"   (b): int8 engine == int8 static, paged == contiguous; {same} of {len(greedy)} "
        f"streams equal to phase 7's fp32 streams; the {len(r0.prompt_ids)}-token admission's "
        f"first decode logits {rel:.3e} from fp32's (relative l2, bound {INT8_LOGIT_RTOL}); "
        f"KV {res['bytes_per_page'] // page} B a token == serve_paged_kv_bytes(int8_kv=True) "
        f"(fp32: {fp}), peak {res['pages_peak']} pages {res['kv_bytes_peak'] / 1e6:.1f} MB; "
        f"memory peak {out['(b) int8 paged engine']['peak'] / 2**30:.2f} GiB")
    one_rows = {}
    unkeep = keep_sampled_logits(one_rows)
    e_one = run("(b) sampled int8 static (for (e))", sampled, plan8)
    unkeep()

    # (c) speculative: (a)'s requests, spec_k 3, self and tiny drafts, then self paged
    drafts = {"self": DraftBundle(cfg, spec_tree, storage),
              "tiny": build_draft(cfg, mesh_cfg, "tiny", seed=1, device=device)}
    spec = {}
    for name, kw in (("self", {}), ("tiny", {}), ("self paged", {"paged": True,
                                                                 "page_size": page})):
        label = f"(c) spec {name}"
        streams = run(label, sampled, plan, engine={"cache_capacity": cap, "spec_k": spec_k,
                                                    **kw},
                      draft=drafts[name.split()[0]])
        s = out[label]["summary"]
        hold_streams(torch, label, streams, a_engine, sampled, setup4, plan,
                     near_tie=FEAT_NEAR_TIE, what="(a)'s engine")
        rej = out[label]["rejections"]
        if name.startswith("self"):  # a rejection past a request's end is moot
            by_rid = {r.rid: r for r in sampled}
            for rid, n, d, t in [x for x in rej if x[2] != x[3] and x[1] < by_rid[x[0]].max_new]:
                r = by_rid[rid]
                _, dists, _ = static_trace(torch, cfg, mesh_cfg, spec_tree, storage, plan, r)
                say(f"   {label}: self-draft proposal rejected, request {rid} token {n}: draft "
                    f"{d}, target {t}; the draw {dists[n]:.3e} of cw[-1] from a boundary")
                check(dists[n] < FEAT_NEAR_TIE, f"{label}: a self-draft rejection away from a "
                                                "boundary")
        spec[name] = s
        say(f"   {label}: {s['spec_rounds']} rounds, acceptance {s['acceptance_rate']:.4f}, "
            f"{s['tokens_per_target_step']:.3f} tokens a target step, host_device "
            f"{s['host_device']} B == serve_spec_decode_bytes")
    del drafts

    # (d) window: greedy, static (linear cache, window mask) and the ring engine
    d_static = run("(d) window static", greedy, plan, window=window)
    d_engine = run("(d) window engine", greedy, plan,
                   engine={"cache_capacity": min(cap, window), "window": window})
    hold_streams(torch, "(d) window engine", d_engine, d_static, greedy, setup4, plan,
                 what="the windowed static run")
    rings = [len(r.prompt_ids) for r in greedy if len(r.prompt_ids) + gen > window]
    say(f"   (d): window {window}, ring of {min(cap, window)}: engine == static; prompts "
        f"{rings} ring; flash on the prefills by the reference's rule (a serve prefill "
        f"attends without the window)")
    for u in undo:
        u()
    out["flash_err"] = max((r["max_abs_err"] for r in seen_flash.values()), default=0.0)
    out["paged_err"] = check_seen_paged(seen_paged) if seen_paged else 0.0
    del storage
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (e) 1×2: (a)'s requests with int8 KV, static then the engine
    if mesh_run:
        t0 = time.perf_counter()
        ranks = mesh_int8_runs(device, cfg, sampled)
        r0 = ranks[0]["runs"]
        for r, o in enumerate(ranks):
            for label in r0:
                check(o["runs"][label]["streams"] == r0[label]["streams"],
                      f"(e): rank {r}'s {label} streams differ from rank 0's")
                check(o["runs"][label]["hashes"] == r0[label]["hashes"],
                      f"(e): rank {r}'s {label} logits differ from rank 0's")
        parted = {rid for rid, *_ in r0["engine"]["diverged"]}
        cases = [dict(c, mid_gaps=[next(x["mid_gap"] for x in o["probe"]["cases"]
                                        if x["diverged"] == c["diverged"]) for o in ranks])
                 for c in ranks[0]["probe"]["cases"]]
        check({c["diverged"][0] for c in cases} == parted,
              f"(e): the probe saw partings {[c['diverged'] for c in cases]}, the engine {parted}")
        for c in cases:
            check(int8_tie(c), f"(e): the 1×2 engine left the 1×2 static run at request "
                               f"{c['diverged'][0]} token {c['diverged'][1]} outside the int8 "
                               f"tie (draws {c['static_margin'][2]:.3e} / "
                               f"{c['engine_margin'][2]:.3e}, bound {INT8_TIE_DRAW}; flips "
                               f"{c['mid_gaps']} code steps from a midpoint, bound "
                               f"{INT8_TIE_MIDPOINT})")
        out["int8_ties"] = cases
        ties = [c["diverged"] for c in out["int8_ties"]]
        cases = int8_divergences(torch, cfg, sampled, r0["static"]["streams"], e_one,
                                 r0["static"]["logits"], one_rows)
        rec = r0["engine"]
        dec = sorted(rec["decode_ms"])
        say(f"   (e) 1×2 ({time.perf_counter() - t0:.1f} s): engine == static but at int8 ties "
            f"(request, token) {ties}, streams and "
            f"logits' hashes equal on both ranks, {len(sampled) - len(cases)} of {len(sampled)} "
            f"equal to one device's; engine decode ms/step median {dec[len(dec) // 2]:.2f}, "
            f"{sum(len(s) for s in rec['streams'].values()) / rec['wall_s']:.1f} tokens/s, "
            f"launches {rec['launches']}, memory peak per rank "
            f"{[round(o['runs']['engine']['peak'] / 2**30, 2) for o in ranks]} GiB")
        out["(e)"] = ranks
    launches = {k: sum(o["launches"][k] for o in out.values() if isinstance(o, dict)
                       and "launches" in o) for k in counts()}
    if mesh_run:
        launches = {k: v + sum(o["runs"][label]["launches"][k] for o in out["(e)"]
                               for label in o["runs"]) for k, v in launches.items()}
    return {"runs": out, "launches": launches, "spec": spec, "int8_rel": rel,
            "flash_err": out["flash_err"], "paged_err": out["paged_err"]}


def watch_spec(engine):
    """Record every examined proposal of a speculative engine: ``(rid,
    emitted index, draft id, target id)``, up to and including the first
    rejection of each slot a round. Returns the list it fills."""
    seen, last = [], {}
    propose, verify = engine.draft.propose, engine._verify_sample

    def proposed(*a, **kw):
        last["drafts"] = propose(*a, **kw)
        last["nemit"] = engine._nemit.copy()
        last["active"] = {slot: st.req.rid for slot, st in engine._active.items()}
        return last["drafts"]

    def verified(logits):
        planes = verify(logits)
        from repro_torch.transport.hostdev import unpack_tokens_host

        targets = unpack_tokens_host(planes)
        for slot, rid in last["active"].items():
            for j in range(last["drafts"].shape[1]):
                d, t = int(last["drafts"][slot, j]), int(targets[slot, j])
                seen.append((rid, int(last["nemit"][slot]) + j, d, t))
                if d != t:
                    break
        return planes

    engine.draft.propose, engine._verify_sample = proposed, verified
    return seen


# ---------------------------------------------------------------------------
# phase 16: the rest of dense-LM training (accumulation, stochastic
# rounding, bf16 compute) and bf16 serving
# ---------------------------------------------------------------------------

LM16_STEPS = 2  # (a) and (b): steps a run
BF16_STEPS = 3  # (d)
# (a): accum_steps 2 against 1 from the same weights and batches, absolute
# loss gaps at steps 0 and 1: scenario_perf_levers.py's bars (its CPU test,
# tests/test_torch_lm_extras.py)
ACCUM_TOL = (2e-4, 2e-3)
# (b): the embed's stochastic planes, drawn on the card, held on the host
# CPU at its first and last EMBED_EDGE elements and EMBED_EDGE more drawn
# across the leaf (an element's noise depends on its flat index alone, and
# the host's int64 threefry over all 311 M elements would take minutes);
# the w_gate leaf is held whole
EMBED_EDGE = 1 << 20
# (c): phase 12's ranks and widths with stochastic bf16 gradients, held to
# a run with nearest-rounded ones (the reference is not on the card; its
# parity, losses within rtol 1e-4 and the noise bit-exact, is
# tests/test_torch_dist.py's): the first loss, before any update, equal;
# the second within 1e-2 relative (another rounding of the gradients:
# 4.3e-4 apart in the CPU rehearsal at reduced width and lr 0.01)
DP16_LOSS_RTOL = 1e-2
# (d): the bf16 step-0 loss against the fp32 one on the same weights and
# batch: 8-bit activations at every one of 28 layers (the CPU test saw
# 8.5e-5 at reduced width)
BF16_LOSS_RTOL = 1e-2
# (e): a bf16 engine stream may leave the bf16 static run's, and the paged
# engine's the contiguous one's, only where a batch-1 greedy decode's top-2
# logits there are within this many bf16 steps of each other: bf16 GEMMs
# round every output to 8 bits, so what moves an fp32 value by its last
# bits (cuBLAS's row bits depend on the batch's row count; paged_attend and
# the dense decode sum in another order; a page-padded prefill) moves a
# bf16 one by a step, and a tie at that resolution goes either way
BF16_TIE_STEPS = 2


def bf16_step(torch, x):
    """One bf16 step (the spacing of bf16 numbers) at each value of ``x``."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), torch.frexp(x.float())[1] - 8)


def bf16_gap(torch, got, want, tol):
    """``(max |got - want|, elements beyond one bf16 step of want plus
    tol, elements that differ at all)``: both versions compute in fp32 and
    round once, so they may part by a step; ``tol`` (the fp32 kernel's own
    bar) covers values near 0, where the fp32 sums' order moves a value by
    more than its own bf16 step."""
    gap = (got.float() - want.float()).abs()
    beyond = int((gap > bf16_step(torch, want) + tol).sum())
    return float(gap.max()), beyond, int((got != want).sum())


def counts_bf16():
    w = _wrappers()
    return {"flash_prefill_bf16": w["flash_prefill"].launches_bf16,
            "paged_attend_bf16": w["paged_attend"].launches_bf16}


def _lm_run(torch, device, cfg, plan, steps, batch, seq, lr, *, keep=False,
            profile_last=False):
    """Fresh full-width weights (seed 0) and ``steps`` steps of
    ``make_train_step`` at ``plan`` (key ``PRNGKey(step)`` where the plan
    needs one), each timed on the host clock to its loss sync. Returns the
    losses, step ms, the memory peak and the launch counts (and with
    ``keep`` the state); ``profile_last``: one more step, under
    ``torch.profiler`` (not counted)."""
    from repro_torch import random as tr
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.launch.train import setup
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.train.step import make_train_step

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    spec_tree, storage, mom = setup(cfg, MeshCfg(), device=device)
    step = make_train_step(cfg, MeshCfg(), None, spec_tree,
                           SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4),
                           {"tokens": (batch, seq), "labels": (batch, seq)}, plan=plan)
    losses, ms = [], []
    zero_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, i, device=device)
        key = (tr.PRNGKey(i),) if plan.needs_rng else ()
        sync()
        t0 = time.perf_counter()
        storage, mom, m = step(storage, mom, {"tokens": tokens, "labels": labels}, lr, *key)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": losses, "ms": ms, "launches": counts(),
           "peak": torch.cuda.max_memory_allocated() if on_card else 0}
    if profile_last:
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, steps, device=device)
        profile(torch, lambda: float(step(storage, mom, {"tokens": tokens, "labels": labels},
                                          lr)[2]["loss"]), f"{cfg.name} {plan.dtype} train step")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    if keep:
        out.update(spec_tree=spec_tree, storage=storage)
    return out


def _check_stochastic_planes(torch, device, cfg, storage, spec_tree, plan, key):
    """The planes of the embed and layer 0's w_gate under the keys the
    step gives them at ``key``, drawn on the card and by the plain version
    on the host CPU: byte-equal (the embed at a sample, ``EMBED_EDGE``).
    Drawn leaf by leaf, each freed before the next."""
    from repro_torch import random as tr
    from repro_torch.kernels import ref
    from repro_torch.train.step import fold_sites

    sites = fold_sites(cfg, spec_tree, plan.weight_policies())
    rep = None if cfg.scan_layers or cfg.remat else 0  # one traced body a group
    leaves = {"embed": (storage["embed"], sites[("top", "embed", 0)]),
              "w_gate": (storage["groups"][0]["p0"]["mix"]["w_gate"][0],
                         sites[("group", 0, rep, "p0", ("mix", "w_gate"))])}
    rt = plan.weights[0].round_to
    checked = {}
    for name, (w, i) in leaves.items():
        k = tr.fold_in(key, i)
        planes = ref.bitpack_ref(w, rt, mode="stochastic", key=k).reshape(rt, -1)
        again = ref.bitpack_ref(w, rt, mode="stochastic", key=k).reshape(rt, -1)
        check(torch.equal(planes, again), f"{name}: two draws of one key differ")
        del again
        flat = w.reshape(-1)
        n = flat.numel()
        if n > 4 * EMBED_EDGE:
            gen = torch.Generator().manual_seed(16)
            idx = torch.cat([torch.arange(EMBED_EDGE), torch.arange(n - EMBED_EDGE, n),
                             torch.randint(0, n, (EMBED_EDGE,), generator=gen)])
        else:
            idx = torch.arange(n)
        host = ref.bitpack_ref(flat[idx.to(device)].cpu(), rt, mode="stochastic", key=k,
                               index=idx)
        check(torch.equal(planes[:, idx.to(device)].cpu(), host),
              f"{name}: the card's stochastic planes differ from the host's")
        checked[name] = (n, idx.numel())
        del planes, host
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return checked


def _dp16_rank(rank, device_name, cfg, batch, lr, min_size):
    """One rank of phase 16 (c): phase 12's AlexNet shards, two steps with
    stochastic bf16 gradients (keys ``PRNGKey(1000 + step)``), the same two
    again from the same state, and two with nearest-rounded gradients.
    Returns the losses and the weights' bits."""
    import torch

    from repro_torch import fp32_math
    from repro_torch import random as jr
    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import MeshCfg, tree_to_local
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.cnn import init_cnn
    from repro_torch.optim.sgd import SGDConfig, init_momentum
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.cnn_step import (
        build_cnn_spec_tree, cnn_to_storage, make_cnn_train_step,
    )
    from repro_torch.utils.trees import tree_leaves

    fp32_math()
    torch.backends.cudnn.deterministic = True  # two runs must give the same bits
    torch.backends.cudnn.benchmark = False
    device = torch.device(device_name)
    n = torch.distributed.get_world_size()
    mesh_cfg = MeshCfg(dp=n, compress_min_size=min_size)
    mesh = make_mesh_from_cfg(mesh_cfg)
    params, metas, gi = init_cnn(cfg, 0, device=device)
    spec = build_cnn_spec_tree(params, metas, mesh_cfg)
    start = tree_to_local(cnn_to_storage(params, spec, mesh_cfg), spec, mesh_cfg, rank)
    start = [x.clone() for x in tree_leaves(start)]
    del params
    data = SyntheticImageNet(num_classes=cfg.num_classes, hw=cfg.in_hw, device=device_name)
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=5e-4)
    out = {}
    zero_counts()
    for label, mode in (("stochastic", "stochastic"), ("again", "stochastic"),
                        ("nearest", "nearest")):
        plan = PrecisionPlan.build(gi[1], round_to=2, grad_round_to=2, grad_mode=mode)
        step = make_cnn_train_step(cfg, mesh_cfg, spec, gi, opt, plan=plan, mesh=mesh)
        it = iter([x.clone() for x in start])
        storage = {"layers": {a: {b: next(it) for b in leafs}
                              for a, leafs in spec["layers"].items()}}
        mom, losses = init_momentum(storage), []
        for i in range(2):
            imgs, labels = data.batch(batch, i)
            storage, mom, m = step(storage, mom, {"images": imgs, "labels": labels}, lr,
                                   jr.PRNGKey(1000 + i))
            losses.append(float(m["loss"]))
        out[label] = {"losses": losses,
                      "bits": [x.detach().view(torch.int32).cpu() for x in tree_leaves(storage)]}
    out["launches"] = counts()
    return out


def lm_features_path(torch, device, *, cfg=None, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR,
                     dp_cfg=None, dp_batch=64, dp_min_size=None):
    """Phase 16 (a)-(d): gradient accumulation, stochastic weights and
    gradients, and bf16 training of full-width qwen3-1.7b (and phase 12's
    AlexNet ranks for (c)). Returns the measurements; raises on a failed
    check. Launch counts and memory peaks are read on a card only, so the
    phase rehearses on the CPU at reduced configs."""
    from repro_torch import random as tr
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.cnn import ALEXNET
    from repro_torch.models.meta import COMPRESS_MIN_SIZE
    from repro_torch.plan import PrecisionPlan

    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    nrt = cfg.num_groups + 1
    out = {}

    # (a) accumulation
    runs = {a: _lm_run(torch, device, cfg, PrecisionPlan.build(nrt, round_to=2, accum_steps=a),
                       LM16_STEPS, batch, seq, lr) for a in (1, 2)}
    gaps = [abs(x - y) for x, y in zip(runs[1]["losses"], runs[2]["losses"])]
    check(all(g < t for g, t in zip(gaps, ACCUM_TOL)),
          f"(a) accum 2 losses {runs[2]['losses']} vs accum 1 {runs[1]['losses']}: gaps {gaps}")
    for a, r in runs.items():
        check(not on_card or r["launches"]["bitpack"] > 0, f"(a) accum {a}: no Bitpack launch")
        say(f"   (a) accum_steps {a}: losses {r['losses']}, step ms "
            f"{[round(x, 1) for x in r['ms']]}, memory peak {r['peak'] / 2**30:.2f} GiB, "
            f"launches {r['launches']}")
    say(f"   (a) accum 2 against 1: loss gaps {[f'{g:.3e}' for g in gaps]} (bounds {ACCUM_TOL})")
    out["accum"] = runs

    # (b) stochastic weights
    plan = PrecisionPlan.build(nrt, round_to=2, mode="stochastic")
    first = _lm_run(torch, device, cfg, plan, LM16_STEPS, batch, seq, lr, keep=True)
    checked = {}
    for i in range(LM16_STEPS):
        checked = _check_stochastic_planes(torch, device, cfg, first["storage"],
                                           first["spec_tree"], plan, tr.PRNGKey(i))
    digest = [x.view(torch.int32).sum().item() for x in
              (first["storage"]["embed"], first["storage"]["head"])]
    del first["storage"]
    rerun = _lm_run(torch, device, cfg, plan, LM16_STEPS, batch, seq, lr, keep=True)
    check(rerun["losses"] == first["losses"], f"(b) a rerun's losses {rerun['losses']} "
                                              f"differ from {first['losses']}")
    check(digest == [x.view(torch.int32).sum().item() for x in
                     (rerun["storage"]["embed"], rerun["storage"]["head"])],
          "(b) a rerun's weights differ")
    del rerun["storage"]
    say(f"   (b) stochastic round_to 2: losses {first['losses']} (a rerun bit-equal), step ms "
        f"{[round(x, 1) for x in first['ms']]}, memory peak {first['peak'] / 2**30:.2f} GiB; "
        f"planes drawn on the card equal the host's for {checked} (elements, held) at "
        f"{LM16_STEPS} keys; launches {first['launches']}")
    out["stochastic"] = first

    # (c) stochastic gradients across ranks
    dcfg = dp_config(dp_cfg or ALEXNET)
    dlr = 1e-8 if dcfg.paper_init else 0.01
    t0 = time.perf_counter()
    ranks = spawn_ranks(_dp16_rank, DP_RANKS, str(device), dcfg, dp_batch, dlr,
                        dp_min_size or COMPRESS_MIN_SIZE, threads=4 if on_card else 1)
    dp_s = time.perf_counter() - t0
    for r, o in enumerate(ranks):
        check(o["again"]["losses"] == o["stochastic"]["losses"],
              f"(c) rank {r}: two stochastic runs' losses differ")
        check(all(torch.equal(a, b) for a, b in zip(o["again"]["bits"], o["stochastic"]["bits"])),
              f"(c) rank {r}: two stochastic runs' weights differ")
        check(o["stochastic"]["losses"] == ranks[0]["stochastic"]["losses"],
              f"(c) rank {r}'s losses differ from rank 0's")
    ls, ln = ranks[0]["stochastic"]["losses"], ranks[0]["nearest"]["losses"]
    check(ls[0] == ln[0], f"(c) first losses {ls[0]!r} and {ln[0]!r} (no update yet) differ")
    rel = abs(ls[1] - ln[1]) / abs(ln[1])
    check(rel <= DP16_LOSS_RTOL, f"(c) second loss {ls[1]} vs nearest {ln[1]}: {rel:.3e}")
    say(f"   (c) {DP_RANKS} ranks, stochastic bf16 gradients: losses {ls} (two runs bit-equal, "
        f"weights too), nearest {ln} (second step within {rel:.3e}, bound {DP16_LOSS_RTOL}); "
        f"launches per rank {[o['launches'] for o in ranks]}; {dp_s:.1f} s")
    out["dp"] = {"losses": ls, "nearest": ln, "launches": {
        k: sum(o["launches"][k] for o in ranks) for k in ranks[0]["launches"]}}

    # (d) bf16 training
    bf = _lm_run(torch, device, cfg, PrecisionPlan.build(nrt, round_to=2, dtype="bf16"),
                 BF16_STEPS, batch, seq, lr, profile_last=on_card)
    fp32_loss = runs[1]["losses"][0]  # (a)'s accum 1: the same plan in fp32, same weights
    rel = abs(bf["losses"][0] - fp32_loss) / abs(fp32_loss)
    check(rel <= BF16_LOSS_RTOL, f"(d) bf16 step-0 loss {bf['losses'][0]} vs fp32 {fp32_loss}")
    warm = sorted(bf["ms"][1:])
    say(f"   (d) bf16: losses {bf['losses']}; step-0 loss against fp32's {fp32_loss!r}: "
        f"{rel:.3e} (bound {BF16_LOSS_RTOL}); step ms {[round(x, 1) for x in bf['ms']]} "
        f"(warm median {warm[len(warm) // 2]:.1f}), memory peak {bf['peak'] / 2**30:.2f} GiB, "
        f"launches {bf['launches']}")
    out["bf16"] = bf
    out["launches"] = {k: sum(r["launches"][k] for r in
                              [*runs.values(), first, rerun, bf]) + out["dp"]["launches"][k]
                       for k in bf["launches"]}
    return out


def check_bf16_kernels(torch, device):
    """(e): the bf16 kernels against their plain versions at phase 6's and
    phase 8's shapes and flash at the tp-2 heads (bf16 unit normals): within
    one bf16 step plus the fp32 bar, flash twice bit-equal and each row
    bit-equal alone and in a batch; times flash at S 128, 512, 2048 and the
    tp-2 heads, and paged_attend at the decode shape, as phases 6 and 8
    time the fp32 ones, with the bf16 library calls in a graph and eager."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attend import paged_attend

    gen = torch.Generator(device=device).manual_seed(16)
    bf = torch.bfloat16
    out = {"flash_err": 0.0, "paged_err": 0.0, "differ": 0, "elements": 0, "flash_times": {}}
    for B, H, Kv, Sq, Sk, off in (*FLASH_SHAPES, FLASH_TP2):
        q, k, v = (torch.randn(s, generator=gen, device=device).to(bf) for s in
                   ((B, H, Sq, 128), (B, Kv, Sk, 128), (B, Kv, Sk, 128)))
        got = flash_prefill(q, k, v, q_offset=off)
        again = flash_prefill(q, k, v, q_offset=off)
        block = 128 if Sq % 128 == 0 and Sk % 128 == 0 else 64
        want = ref.flash_prefill_ref(q, k, v, q_offset=off, block_q=block, block_k=block)
        err, beyond, differ = bf16_gap(torch, got, want, FLASH_TOL)
        label = f"B={B} H={H} Kv={Kv} Sq={Sq} Sk={Sk} q_offset={off}"
        check(beyond == 0 and got.dtype == bf,
              f"bf16 flash {label}: {beyond} elements beyond one step")
        check(torch.equal(got, again), f"bf16 flash {label}: two calls gave other bits")
        out["flash_err"] = max(out["flash_err"], err)
        out["differ"] += differ
        out["elements"] += got.numel()
        if B == 1 and Sq == Sk and off == 0 and (
                (H, Kv) == (16, 8) and Sq in FLASH_TIMED or (B, H, Kv, Sq, Sk, off) == FLASH_TP2):
            ms = time_graph(torch, [lambda: flash_prefill(q, k, v)], reps=10)
            plain = time_cuda(torch, lambda: ref.flash_prefill_ref(q, k, v), iters=3)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True)
            lib_eager = time_cuda(torch, sdpa)
            lib = time_graph(torch, [sdpa], reps=10)
            bound, by = flash_bound(B, H, Kv, Sq, Sk, off, elem=2, flop_rate=BF16_FLOP_PER_S)
            out["flash_times"][(H, Kv, Sq)] = {
                "ms": ms, "plain_ms": plain, "library_ms": lib, "library_eager_ms": lib_eager,
                "bound_ms": bound, "bound_by": by}
            say(f"   bf16 flash H={H} Kv={Kv} S={Sq}: kernel {ms * 1e3:.2f} us in a CUDA graph, "
                f"plain {plain * 1e3:.1f} us, bf16 sdpa {lib * 1e3:.2f} us in a graph "
                f"({lib_eager * 1e3:.1f} us eager), bound {bound * 1e3:.2f} us ({by}, "
                f"{bound / ms:.0%} of it)")
    out["flash"] = out["flash_times"][(16, 8, 512)]
    check_flash_rows(torch, device, gen, bf)
    for B, Kv, G, page, width, P, lengths in PAGED_CASES:
        q, kp, vp, table, lens = paged_inputs(torch, device, gen, B, Kv, G, page, width, P,
                                              lengths)
        q, kp, vp = q.to(bf), kp.to(bf), vp.to(bf)
        got = paged_attend(q, kp, vp, table, lens)
        want = ref.paged_attend_ref(q, kp, vp, table, lens)
        err, beyond, differ = bf16_gap(torch, got, want, PAGED_TOL)
        check(beyond == 0 and got.dtype == bf,
              f"bf16 paged_attend B={B} page={page} lengths {lengths}: {beyond} beyond one step")
        out["paged_err"] = max(out["paged_err"], err)
        out["differ"] += differ
        out["elements"] += got.numel()
    label, (B, Kv, G, page, width, P, lengths) = PAGED_TIMED[0]
    args = paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths)
    args = (args[0].to(bf), args[1].to(bf), args[2].to(bf), *args[3:])
    copies = [args] + [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                       for _ in range(COLD_COPIES - 1)]
    cold = time_graph(torch, [lambda a=a: paged_attend(*a) for a in copies])
    del copies
    plain = time_cuda(torch, lambda: ref.paged_attend_ref(*args), iters=5)
    lib = time_cuda(torch, lambda: gather_sdpa(torch, *args))
    bound = paged_bound(B, Kv, G, page, width, lengths) / 2  # 2 B an element
    out["paged"] = {"ms": cold, "plain_ms": plain, "library_ms": lib, "bound_ms": bound}
    say(f"   bf16 paged_attend {label}: kernel {cold * 1e3:.1f} us in a CUDA graph with the L2 "
        f"cold, plain {plain * 1e3:.1f} us, gather + bf16 sdpa {lib * 1e3:.1f} us, bound "
        f"{bound * 1e3:.2f} us (bytes, {bound / cold:.0%} of it)")
    say(f"   bf16 kernels at phases 6 and 8's shapes: every element within one bf16 step of "
        f"the plain version (plus the fp32 bars); {out['differ']} of {out['elements']} differ "
        f"at all; max |err| flash {out['flash_err']:.3e}, paged {out['paged_err']:.3e}")
    return out


def bf16_serve_path(torch, device, phase7, *, cfg=None, page=PAGE):
    """Phase 16 (e): phase 7's requests on phase 7's weights (seed 0)
    under a plan with ``"dtype": "bf16"`` at round_to 2: the static run,
    the engine and the paged engine. Engine equals static and paged equals
    contiguous exactly; launches of the bf16 kernels counted by their
    wrappers (28 flash a prefill of a multiple of 128, 28 paged_attend a
    paged decode step) and none of the fp32 ones; each launch's first
    shape held to the plain version within one bf16 step; the first
    logits against phase 7's fp32 ones (relative l2, printed). Launch
    counts are read on a card only, so the phase rehearses on the CPU."""
    from repro_torch.launch.serve import setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine, generate_static

    cfg = cfg or phase7["cfg"]
    on_card = device.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    plan = PrecisionPlan.from_json_dict({"weights": [{"round_to": 2}], "dtype": "bf16"}) \
        .broadcast(cfg.num_groups + 1)
    requests = phase7["requests"]
    lens = [len(r.prompt_ids) for r in requests]
    gen = requests[0].max_new
    cap = max(lens) + gen
    flash_ok = on_card and cfg.head_dim % 128 == 0
    seen_f, seen_p = {}, []
    unwatch_f = watch_flash(torch, seen_f)
    unwatch_p = watch_paged(torch, seen_p, 8 * cfg.num_layers)
    zero_counts()
    static = generate_static(cfg, mesh_cfg, None, spec_tree, storage, requests, plan=plan)
    launches = {"static": counts_bf16()}
    fp32_counts = counts()  # Bitpack / Bitunpack of the weights
    runs = {}
    for label, kw in (("engine", {}), ("paged engine", {"paged": True, "page_size": page})):
        timings = {"admit": [], "decode": []}
        zero_counts()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                             max_slots=SERVE_SLOTS, cache_capacity=cap, **kw)
        instrument(engine, timings)
        results = engine.run(requests)
        wall = time.perf_counter() - t0
        launches[label] = counts_bf16()
        fp32 = counts()
        fp32_counts = {k: fp32_counts[k] + v for k, v in fp32.items()}
        summary = engine.wire_summary()
        runs[label] = {k: r.tokens for k, r in results.items()}
        dec = sorted(timings["decode"])
        check(fp32["flash_prefill"] == fp32["paged_attend"] == 0,
              f"{label}: fp32 attention launches {fp32}")
        viable = [S % 128 == 0 for S in lens] if not kw else \
            [(-(-S // page) * page) % 128 == 0 for S in lens]
        want = {"flash_prefill_bf16": cfg.num_layers * sum(viable) * flash_ok,
                "paged_attend_bf16": cfg.num_layers * summary["decode_steps"] * on_card
                if kw else 0}
        check(launches[label] == want, f"{label}: bf16 launches {launches[label]}, "
                                       f"expected {want}")
        first = timings["first_logits"].float()
        ref32 = phase7["runs"]["engine"]["first_logits"].float()
        rel = float(torch.linalg.vector_norm(first - ref32) / torch.linalg.vector_norm(ref32))
        runs[label + " stats"] = {"decode_ms": dec[len(dec) // 2] * 1e3, "rel": rel,
                                  "wall": wall, "decode_steps": summary["decode_steps"]}
        say(f"   (e) bf16 {label}: {summary['decode_steps']} decode steps, {wall:.2f} s, "
            f"decode ms/step median {dec[len(dec) // 2] * 1e3:.2f}; launches "
            f"{launches[label]}; first logits against phase 7's fp32 ones: relative l2 "
            f"{rel:.3e}")
        if on_card and not kw:  # a warm bf16 decode step, as phase 7 profiles fp32's
            engine.begin_stream()
            engine.admit(requests[0])
            engine.admit(requests[1])
            profile(torch, engine.decode_tick, "bf16 decode step (2 slots)")
            zero_counts()
    unwatch_f()
    unwatch_p()
    batch1 = {}
    for label, got_runs, want_runs in (("engine", runs["engine"], static),
                                       ("paged engine", runs["paged engine"], runs["engine"])):
        for r in requests:
            got, want = got_runs[r.rid], want_runs[r.rid]
            if got == want:
                continue
            if r.rid not in batch1:
                batch1[r.rid] = top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                                          values=True)
            toks, gaps, tops = batch1[r.rid]
            # the first token where the two streams or the batch-1 run part
            t = next(i for i, abc in enumerate(zip(got, want, toks)) if len(set(abc)) > 1)
            step = 2.0 ** (math.floor(math.log2(abs(tops[t]))) - 7) if tops[t] else 0.0
            say(f"   (e) {label}: request {r.rid} parts at token {t}: {got[t]} against "
                f"{want[t]} (batch-1 greedy {toks[t]}), batch-1 top-2 gap {gaps[t]:.4g} at "
                f"top logit {tops[t]:.4g} ({gaps[t] / step if step else 0:.1f} bf16 steps)")
            check(gaps[t] <= BF16_TIE_STEPS * step,
                  f"(e) {label}: request {r.rid} parts at token {t} at a top-2 gap of "
                  f"{gaps[t]:.4g} > {BF16_TIE_STEPS} bf16 steps")
    want_static = cfg.num_layers * len({S for S in lens if S % 128 == 0}) * flash_ok
    check(launches["static"]["flash_prefill_bf16"] == want_static,
          f"(e) static: bf16 flash launches {launches['static']}, expected {want_static}")
    from repro_torch.kernels import ref

    errs = {"flash": 0.0, "paged": 0.0}
    for key, rec in seen_f.items():
        (q, k, v), off = rec["inputs"], key[2]
        err, beyond, differ = bf16_gap(torch, rec["out"], ref.flash_prefill_ref(
            q, k, v, q_offset=off), FLASH_TOL)
        check(beyond == 0, f"(e) bf16 flash on the path q {key[0]}: {beyond} beyond a step")
        errs["flash"] = max(errs["flash"], err)
        say(f"   (e) bf16 flash on the path, q {key[0]} k {key[1]}: max |err| {err:.3e}, "
            f"{differ} of {rec['out'].numel()} elements differ")
    for key, rec in seen_p:
        err, beyond, differ = bf16_gap(torch, rec["out"], ref.paged_attend_ref(*rec["inputs"]),
                                       PAGED_TOL)
        check(beyond == 0, f"(e) bf16 paged_attend on the path {key}: {beyond} beyond a step")
        errs["paged"] = max(errs["paged"], err)
    if seen_p:
        say(f"   (e) bf16 paged_attend on the path: {len(seen_p)} launches held, max |err| "
            f"{errs['paged']:.3e}")
    total = {k: sum(v[k] for v in launches.values()) for k in launches["static"]}
    return {"runs": runs, "launches": {**fp32_counts, **total}, "errs": errs}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 17: training I/O — shards, the prefetcher, async checkpoints, resume
# ---------------------------------------------------------------------------

IO_RECORDS = 64  # LM records written, vocab 151,936, seq 128, seed 0
IO_QUALITY, IO_DEPTH = 4, 2  # the reader's tier and the prefetcher's queue
IO_STEPS, IO_SAVE_AT = 6, 3  # (b) runs 6 steps; (c) saves after 3 and resumes
IO_MIN_FREE = 40e9  # one full-width checkpoint (16.25 GB) and one export (4.06 GB)
# the phase's depth, cut from 28 layers as phase 13's (phase 18 (a) saves and
# loads the full-width state across ranks)
IO_LAYERS = 4
# full-width qwen3-1.7b's checkpoint at round_to 2 with SGD momentum and its
# weights-only export (``train_checkpoint_bytes`` over the reference's tree)
QWEN3_CKPT_BYTES, QWEN3_EXPORT_BYTES = 16_253_919_232, 4_063_727_616


class ShardFeed:
    """The prefetcher (depth ``IO_DEPTH``) over a ``ShardReader`` of
    ``shard_dir`` (tier ``IO_QUALITY``, seed 0) at data state ``state``,
    each batch's io_log held to ``train_ingest_bytes`` priced from the
    consumed position, and each batch's shape checked."""

    def __init__(self, torch, shard_dir, plan, vocab, batch, seq, device, state=None):
        from repro_torch.data.prefetch import Prefetcher
        from repro_torch.data.shards import ShardReader, batches

        self.torch, self.plan, self.vocab, self.batch, self.seq = torch, plan, vocab, batch, seq
        self.reader = ShardReader(shard_dir, quality=IO_QUALITY, seed=0)
        self.planner = ShardReader(shard_dir, quality=IO_QUALITY, seed=0)
        if state is not None:
            self.reader.load_state(state)
            self.planner.load_state(state)
        self.pf = Prefetcher(batches(self.reader, batch), kind="lm", vocab=vocab, plan=plan,
                             depth=IO_DEPTH, device=device)
        self.wait_s, self.logs = 0.0, []

    def next(self):
        from repro_torch.roofline.analysis import train_ingest_bytes

        want = train_ingest_bytes(self.plan, self.vocab, kind="lm", batch=self.batch,
                                  seq=self.seq, steps=1, reader=self.planner)
        t0 = time.perf_counter()
        b, log = self.pf.next()
        self.wait_s += time.perf_counter() - t0
        check({"shard_read": log["shard_read"], "host_device": log["host_device"]}
              == {"shard_read": want["shard_read"], "host_device": want["ingest_h2d"]},
              f"io_log {log} != train_ingest_bytes {want}")
        check(tuple(b["tokens"].shape) == (self.batch, self.seq)
              and b["tokens"].dtype == self.torch.int32, f"batch {b['tokens'].shape}")
        self.planner.load_state(log["data_state"])
        self.logs.append(log)
        return b, log

    def close(self):
        self.pf.close()
        self.reader.close()
        self.planner.close()


def tree_digest(torch, tree):
    """``{key path: (s1, s2)}``: each leaf's 32-bit words summed twice on its
    own device in int64 (wrapping), once plain and once weighted by
    position: a hash of the leaf's bytes whatever the device, exact to
    compare."""
    from repro_torch.checkpoint.sharded import leaf_entries

    out, chunk = {}, 1 << 24
    for path, x in leaf_entries(tree):
        w = x.detach().reshape(-1).view(torch.int32)
        s1 = torch.zeros((), dtype=torch.int64, device=w.device)
        s2 = torch.zeros((), dtype=torch.int64, device=w.device)
        for i in range(0, w.numel(), chunk):
            c = w[i:i + chunk].to(torch.int64)
            pos = torch.arange(i, i + c.numel(), dtype=torch.int64, device=w.device)
            s1 += c.sum()
            s2 += (c * (pos * 0x9E3779B1 + 1)).sum()
        out[path] = (int(s1), int(s2))
    return out


def truncate_tree(torch, storage, widths):
    """``storage`` with every leaf of ``widths`` (``assign_widths``'s, < 4)
    cut to its top ``width`` bytes in memory: the transport's truncation."""
    from repro_torch.checkpoint.sharded import leaf_entries, tree_from_entries

    def cut(path, x):
        w = widths.get(path, 4)
        if w >= 4:
            return x.clone()
        mask = -(1 << (32 - 8 * w))  # the top w bytes of an int32 word
        return (x.view(torch.int32) & mask).view(torch.float32)

    return tree_from_entries(storage, {p: cut(p, x) for p, x in leaf_entries(storage)})


def leaf_io_times(torch, storage, widths, root, sync):
    """Where a checkpoint's time goes, on its largest leaf: the copy to the
    host, the plane split, the tier writes, the reads, the plane join (both
    qualities) and the copy back, each with its rate over the leaf's fp32
    bytes; the leaf must come back bit-equal."""
    from repro_torch.checkpoint.sharded import (
        decode_leaf, encode_leaf, host_array, leaf_entries,
    )

    path, x = max(leaf_entries(storage), key=lambda e: e[1].numel())
    base, t, times = os.path.join(root, "leaf"), time.perf_counter(), {}

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        times[name], t = now - t, now

    sync()
    t = time.perf_counter()
    arr = host_array(x, copy=True)
    lap("copy to host")
    wire, res, info = encode_leaf(arr, widths.get(path, 4), True)
    lap("plane split")
    for suffix, buf in ((".w.bin", wire), (".r.bin", res)):
        with open(base + suffix, "wb") as f:
            f.write(buf)
    lap("write")
    del wire, res
    with open(base + ".w.bin", "rb") as f:
        wire = f.read()
    with open(base + ".r.bin", "rb") as f:
        res = f.read()
    lap("read")
    info["path"] = path
    back = decode_leaf(wire, info, "exact", res)
    lap("plane join (exact)")
    y = torch.from_numpy(back).to(x.device)
    sync()
    lap("copy to device")
    decode_leaf(wire, info, "wire")
    lap("plane join (wire)")
    check(torch.equal(y.view(torch.int32), x.view(torch.int32)), f"leaf {path} round trip")
    for suffix in (".w.bin", ".r.bin"):
        os.remove(base + suffix)
    nbytes = x.numel() * 4
    say(f"   (c) where a leaf's time goes ({path}, {nbytes} B fp32 at width {info['width']}): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms ({nbytes / v / 1e9:.2f} GB/s)"
                    for k, v in times.items()))


def io_path(torch, device, *, cfg=None, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR,
            prompt_len=SERVE_LENS[0], gen=SERVE_GEN, min_free=IO_MIN_FREE):
    """Training I/O on full-width qwen3-1.7b (phase 11's weights from seed 0
    and settings): (a) LM shards written and read through the prefetcher,
    each step's io_log equal to ``train_ingest_bytes``; (b) six steps of
    phase 11's AWP plan off the prefetcher; (c) three steps from fresh
    weights, an async save, step 4 while it writes, the checkpoint held to
    the state at submit, then resumed to step 6 bit-equal to (b); (d) the
    step-3 weights exported at the wire widths without residuals and
    served, equal to the same weights truncated in memory. Everything is
    written under a fresh temporary directory, removed at the end. Launch
    counts, the packing records and times are read on a card only, so the
    phase rehearses on the CPU at a reduced config."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt as C
    from repro_torch.checkpoint.sharded import assign_widths, manifest_bytes, read_meta
    from repro_torch.configs.registry import get_config
    from repro_torch.data.shards import ShardReader, write_lm_shards
    from repro_torch.dist.spec import DIST, MeshCfg, dist_elems_per_group
    from repro_torch.launch.serve import build_requests
    from repro_torch.launch.train import setup
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import train_checkpoint_bytes, train_ingest_bytes
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.loop import Trainer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.trees import tree_leaves

    full_width = cfg is None
    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    mesh_cfg, nrt = MeshCfg(), cfg.num_groups + 1
    plan = PrecisionPlan.build(nrt, round_to=4, schedule="awp", awp_threshold=1.0,
                               awp_interval=2)
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    width = plan.host_device_policies()[0].token_wire_width(cfg.vocab_size)
    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    seen, packs, monitor, errs = {}, {}, {}, []
    unwatch = [watch_flash(torch, seen), watch_packing(torch, packs),
               watch_monitor_lengths(torch, monitor)]
    zero_counts()
    try:
        free = shutil.disk_usage(root).free
        check(free >= min_free, f"phase 17 needs {min_free:.0f} B free under {root}, "
                                f"has {free} B")
        say(f"   working directory {root}: {free / 1e9:.1f} GB free")

        # (a) shards
        shard_dir = os.path.join(root, "shards")
        t0 = time.perf_counter()
        manifest = write_lm_shards(shard_dir, vocab=cfg.vocab_size, seq=seq,
                                   num_records=IO_RECORDS, seed=0)
        write_s = time.perf_counter() - t0
        stored = sum(s for sh in manifest["shards"] for r in sh["records"]
                     for f in r["fields"].values() for s in f["plane_sizes"])
        on_disk = sum(os.path.getsize(os.path.join(shard_dir, sh["file"]))
                      for sh in manifest["shards"])
        check(stored == on_disk, f"shards: manifest {stored} B, files {on_disk} B")
        reader = ShardReader(shard_dir, quality=IO_QUALITY, seed=0)
        t0 = time.perf_counter()
        decoded = sum(sum(a.nbytes for a in reader.next_record()[0].values())
                      for _ in range(reader.num_records))
        read_s = time.perf_counter() - t0
        check(reader.bytes_read == stored, f"one epoch read {reader.bytes_read} B of {stored}")
        reader.close()
        say(f"   (a) {IO_RECORDS} records of {seq + 1} ids, {stored} B stored "
            f"({stored / IO_RECORDS:.1f} B a record, {decoded} B decoded): write "
            f"{stored / write_s / 1e6:.3f} MB/s stored ({write_s * 1e3:.1f} ms), read "
            f"{stored / read_s / 1e6:.3f} MB/s stored, {decoded / read_s / 1e6:.3f} MB/s "
            f"decoded ({read_s * 1e3:.1f} ms)")
        say(f"   (a) the AWP plan's host_device policy (round_to "
            f"{plan.host_device_policies()[0].round_to}) stages ids at {width} B: "
            + ("it compresses" if width < 4 else "raw int32")
            + f", {batch * (seq + 1) * width} B a step")

        def trainer():
            def builder(rts):
                return make_train_step(cfg, mesh_cfg, None, spec_tree, opt, shapes,
                                       plan=plan.with_round_tos(rts))
            return Trainer(builder, nrt, plan=plan,
                           dist_elems_per_group=dist_elems_per_group(spec_tree, mesh_cfg, nrt))

        def fresh():
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            spec, storage, mom = setup(cfg, mesh_cfg, device=device)
            sync()
            return spec, storage, mom, time.perf_counter() - t0

        def Feed(state=None):
            return ShardFeed(torch, shard_dir, plan, cfg.vocab_size, batch, seq, device, state)

        def steps(tr, storage, mom, feed, n):
            losses, ms = [], []
            for _ in range(n):
                b, log = feed.next()
                sync()
                t0 = time.perf_counter()
                storage, mom, m = tr.run_step(storage, mom, b, lr, io_log=log)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                check(math.isfinite(losses[-1]), f"loss {losses[-1]}")
                check_seen_packing(torch, packs)
                check_seen_monitor(monitor, errs)
            return storage, mom, losses, ms

        # ingest alone: the prefetcher's steps/s with no training behind it,
        # after a first batch that also starts the worker and the unpack
        feed = Feed()
        t0 = time.perf_counter()
        feed.next()
        sync()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(IO_STEPS):
            feed.next()
        sync()
        ingest_s = time.perf_counter() - t0
        feed.close()
        say(f"   (a) ingest alone: {IO_STEPS / ingest_s:.1f} steps/s ({ingest_s * 1e3:.2f} ms for "
            f"{IO_STEPS} batches of {batch} x {seq} after a first one of {first_s * 1e3:.2f} ms, "
            f"depth {IO_DEPTH})")

        # (b) uninterrupted
        spec_tree, storage, mom, init_s = fresh()
        tr_b = trainer()
        feed = Feed()
        priced = train_ingest_bytes(plan, cfg.vocab_size, kind="lm", batch=batch, seq=seq,
                                    steps=IO_STEPS, reader=feed.planner)
        t0 = time.perf_counter()
        try:
            storage, mom, losses_b, ms_b = steps(tr_b, storage, mom, feed, IO_STEPS)
        finally:
            feed.close()
        run_b = time.perf_counter() - t0
        io = tr_b.summary()["io_by_entry"]
        check(io == {"shard_read": priced["shard_read"], "host_device": priced["ingest_h2d"]},
              f"(b) io_by_entry {io}, train_ingest_bytes {priced}")
        hist_b = list(tr_b.bits_history)
        rts_b = [r.round_tos[0] for r in tr_b.records]
        final_b = (tree_digest(torch, storage), tree_digest(torch, mom))
        say(f"   (b) {IO_STEPS} steps off the prefetcher (init {init_s:.2f} s): losses "
            f"{[round(x, 5) for x in losses_b]}, step ms {[round(x, 1) for x in ms_b]}, "
            f"{IO_STEPS / run_b:.2f} steps/s, {feed.wait_s * 1e3:.2f} ms waiting on the "
            f"prefetcher; AWP {hist_b}; io_by_entry {io} == train_ingest_bytes")
        del storage, mom, tr_b

        # (c) interrupted: 3 steps, async save, step 4 while it writes
        spec_tree, storage, mom, _ = fresh()
        tr_c = trainer()
        feed = Feed()
        try:
            storage, mom, losses_c, _ = steps(tr_c, storage, mom, feed, IO_SAVE_AT)
            rts = tr_c.current_round_tos()
            state = feed.logs[-1]["data_state"]  # the consumed batch's, not the reader's
            at_submit = (tree_digest(torch, storage), tree_digest(torch, mom))
            path = os.path.join(root, "ckpt")
            ac = C.AsyncCheckpointer()
            sync()
            t0 = time.perf_counter()
            C.save_checkpoint(path, storage, mom, tr_c.controller, IO_SAVE_AT, plan=plan,
                              spec_tree=spec_tree, round_tos=rts,
                              extra={"data_state": state}, async_ckpt=ac)
            submit_s = time.perf_counter() - t0
            in_flight = ac.in_flight
            storage, mom, loss4, ms4 = steps(tr_c, storage, mom, feed, 1)
            step4_s = time.perf_counter() - t0
            ac.wait()
            save_s = time.perf_counter() - t0
        finally:
            feed.close()
        check(losses_c + loss4 == losses_b[:IO_SAVE_AT + 1],
              f"(c) losses {losses_c + loss4} != (b)'s {losses_b[:IO_SAVE_AT + 1]}")
        d = C.ckpt_dir(path)
        meta = read_meta(d)
        mb = manifest_bytes(meta)
        analytic = train_checkpoint_bytes(storage, mom, spec_tree=spec_tree, round_tos=rts)
        files = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                    if f.endswith(".bin"))
        check(mb == analytic and mb["total"] == files,
              f"checkpoint bytes: manifest {mb}, train_checkpoint_bytes {analytic}, "
              f"files {files}")
        check(not full_width or mb["total"] == QWEN3_CKPT_BYTES,
              f"checkpoint {mb['total']} B, expected {QWEN3_CKPT_BYTES}")
        check(meta["extra"] == {"data_state": state} and meta["step"] == IO_SAVE_AT,
              f"checkpoint meta step {meta['step']}, extra {meta['extra']}")
        after4 = (tree_digest(torch, storage), tree_digest(torch, mom))
        check(after4[0] != at_submit[0], "step 4 left the weights unchanged")
        say(f"   (c) async save at step {IO_SAVE_AT} (round_tos {rts}): submit "
            f"{submit_s * 1e3:.1f} ms (in flight after submit: {in_flight}), step 4 "
            f"{ms4[0]:.1f} ms beside the writer, save done {save_s:.2f} s after submit "
            f"({step4_s:.2f} s to the end of step 4); {mb['total']} B = wire {mb['wire']} + "
            f"residual {mb['residual']} == train_checkpoint_bytes == the files' sizes")
        # load into fresh tensors: the state at submit, not after step 4
        ctl = trainer()
        like_s, like_m = storage, mom
        sync()
        t0 = time.perf_counter()
        storage, mom, step = C.load_checkpoint(path, like_s, like_m, ctl.controller)
        sync()
        load_s = time.perf_counter() - t0
        del like_s, like_m
        loaded = (tree_digest(torch, storage), tree_digest(torch, mom))
        check(loaded == at_submit, "the checkpoint does not read back as the state at submit")
        check(step == IO_SAVE_AT and ctl.bits_history == hist_b[:len(ctl.bits_history)],
              f"restored step {step}, AWP {ctl.bits_history}")
        say(f"   (c) sync load {load_s:.2f} s ({mb['total'] / load_s / 1e9:.2f} GB/s), equal to "
            f"the state at submit, not to the state after step 4")
        widths = assign_widths(storage, spec_tree, rts)
        leaf_io_times(torch, storage, widths, root, sync)

        # (d) the serving hand-off: the step-3 weights at the wire widths
        export = os.path.join(root, "export")
        sync()
        t0 = time.perf_counter()
        emeta = C.save_checkpoint(export, storage, None, None, IO_SAVE_AT, plan=plan,
                                  spec_tree=spec_tree, round_tos=rts, residuals=False)
        export_s = time.perf_counter() - t0
        eb = manifest_bytes(emeta)
        check(eb == train_checkpoint_bytes(storage, spec_tree=spec_tree, round_tos=rts,
                                           residuals=False)
              and eb["residual"] == 0, f"export bytes {eb}")
        check(not full_width or eb["total"] == QWEN3_EXPORT_BYTES,
              f"export {eb['total']} B, expected {QWEN3_EXPORT_BYTES}")
        t0 = time.perf_counter()
        wire_w, _ = C.load_storage(export, storage, quality="wire")
        sync()
        wire_s = time.perf_counter() - t0
        truncated = truncate_tree(torch, storage, widths)
        check(tree_digest(torch, wire_w) == tree_digest(torch, truncated),
              "the wire tier does not read back as the truncated weights")
        serve_plan = PrecisionPlan.build(nrt, round_to=2)
        req = build_requests((prompt_len,), gen, cfg.vocab_size)[0]
        per_forward = sum(s.reps for g in spec_tree["groups"] for s in tree_leaves(g)
                          if s.kind == DIST) + sum(
            1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST)
        streams, serve_ms = [], []
        for w in (wire_w, truncated):
            t0 = time.perf_counter()
            engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, w, plan=serve_plan,
                                 max_slots=1, cache_capacity=prompt_len + gen)
            streams.append(engine.run([req])[req.rid].tokens)
            serve_ms.append((time.perf_counter() - t0) * 1e3)
            del engine
        check(streams[0] == streams[1] and len(streams[0]) == gen,
              f"hand-off streams {streams[0]} != {streams[1]}")
        del wire_w, truncated
        say(f"   (d) hand-off: export {eb['total']} B in {export_s:.2f} s, wire load "
            f"{wire_s:.2f} s ({eb['total'] / wire_s / 1e9:.2f} GB/s); {prompt_len}-token "
            f"prompt +{gen}: {streams[0]} from the export equal to the weights truncated in "
            f"memory ({[round(x, 1) for x in serve_ms]} ms)")
        shutil.rmtree(C.ckpt_dir(export))  # at most one checkpoint and one export on disk

        # (c) resumed: steps 4-6 from the checkpoint and the restored reader
        feed = Feed(C.load_extra(path)["data_state"])
        try:
            storage, mom, losses_r, _ = steps(ctl, storage, mom, feed, IO_STEPS - IO_SAVE_AT)
        finally:
            feed.close()
        check(losses_c + losses_r == losses_b, f"resumed losses {losses_c + losses_r} != "
                                               f"(b)'s {losses_b}")
        check(ctl.bits_history == hist_b, f"resumed AWP {ctl.bits_history} != (b)'s {hist_b}")
        check((tree_digest(torch, storage), tree_digest(torch, mom)) == final_b,
              "resumed final storage or momentum differs from (b)'s")
        say(f"   (c) resumed at step {IO_SAVE_AT} to {IO_STEPS}: losses, AWP history, final "
            f"storage and momentum bit-equal to (b)")
        got = counts()
        check_seen_packing(torch, packs)
        check_seen_flash(seen)
    finally:
        for undo in unwatch:
            undo()
        shutil.rmtree(root, ignore_errors=True)
    # launches: every step below 32 bits packs each DIST leaf per use; the
    # monitor once a leaf a step; each serve forward packs once a leaf
    group_dist = [s for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST]
    top_dist = [k for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST]
    per_step = per_forward + (sum(s.reps for s in group_dist) if cfg.remat else 0)
    train_steps = len(rts_b) + len(tr_c.records) + len(ctl.records)
    below = sum(rt < 4 for rt in rts_b) + sum(r.round_tos[0] < 4
                                              for r in tr_c.records + ctl.records)
    serve_forwards = 2 * gen  # each run: the admission, then gen - 1 decode steps
    viable = on_card and cfg.head_dim % 128 == 0 and prompt_len % 128 == 0
    want = {"bitpack": (below * per_step + serve_forwards * per_forward) * on_card,
            "flash_prefill": 2 * cfg.num_layers * viable, "paged_attend": 0,
            "l2norm_sq": train_steps * (len(group_dist) + len(top_dist)) * on_card}
    want["bitunpack"] = want["bitpack"]
    check(got == want, f"phase 17 launches {got}, expected {want}")
    if on_card:
        check(len(monitor) > 0 and len(errs) == len(monitor) and len(packs) > 0,
              f"held to the plain versions: monitor lengths {sorted(monitor)}, packing "
              f"{sorted(packs)}")
    phase_s = time.perf_counter() - t_phase
    say(f"   launches {got} ({train_steps} train steps, {serve_forwards} serve forwards); "
        f"phase 17 took {phase_s:.1f} s")
    return {"launches": got, "phase_s": phase_s,
            "flash_err": max((r["max_abs_err"] for r in seen.values()), default=0.0),
            "monitor_err": max(errs, default=0.0), "ckpt_bytes": mb["total"],
            "export_bytes": eb["total"], "ckpt_rts": rts,
            "n_params": sum(x.numel() for x in tree_leaves(storage))}


# ---------------------------------------------------------------------------
# phase 18: the mesh finished — training I/O across ranks, speculative
# decoding and sliding windows at tp 2
# ---------------------------------------------------------------------------

MIO_STEPS, MIO_SAVE_AT = 3, 2  # (a): three steps; the checkpoint after the second
MESH_GEN = 8  # (a)'s hand-off, (b) and (c): new tokens a request


def checkpoint_wire(records):
    """Payload bytes of the ``checkpoint`` class among ``dist.comm`` records
    (a save's gathers, a load's scatters: the root's whole buffer a call)."""
    return sum(r.nbytes for r in records if r.traffic == "checkpoint")


def _mesh_io_rank(rank, device_name, cfg, batch, seq, lr, root, shard_dir, prompt, gen):
    """One rank of phase 18 (a) (a process of a gloo group of 4, a 2×2
    mesh): phase 17's AWP plan off its own prefetcher, an export and an
    async checkpoint across ranks, step 3 beside the writer, a load into
    fresh tensors, the export served at 2×2 weight-stationary against the
    weights truncated in memory, then step 3 again from the restored state
    and reader; checks on its own view, returns its measurements."""
    import torch

    from repro_torch import fp32_math
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.checkpoint.sharded import (
        assign_widths, global_like, manifest_bytes, read_meta,
    )
    from repro_torch.dist import comm
    from repro_torch.dist.spec import DIST, MeshCfg, dist_elems_per_group
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.launch.serve import restore
    from repro_torch.launch.train import setup
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import train_checkpoint_bytes
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import Trainer
    from repro_torch.utils.trees import tree_leaves

    fp32_math()
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh_cfg = MeshCfg(tp=TP_TP, dp=TP_DP)
    mesh = make_mesh_from_cfg(mesh_cfg)
    t0 = time.perf_counter()
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device, rank=rank)
    sync()
    setup_s = time.perf_counter() - t0
    nrt = cfg.num_groups + 1
    plan = PrecisionPlan.build(nrt, round_to=4, schedule="awp", awp_threshold=1.0,
                               awp_interval=2)  # phase 17's: widens every 2 steps
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)

    def trainer():
        return Trainer(lambda rts: tstep.make_train_step(
            cfg, mesh_cfg, mesh, spec_tree, opt, shapes, plan=plan.with_round_tos(rts)),
            nrt, plan=plan, dist_elems_per_group=elems, gather_axis_size=TP_DP)

    seen_flash, packs, monitor, errs = {}, {}, {}, []
    undo = [watch_flash(torch, seen_flash)]
    if on_card:
        undo += [watch_packing(torch, packs), watch_monitor_lengths(torch, monitor)]
    out = {"setup_s": setup_s, "steps": []}

    def step(tr, storage, mom, feed):
        b, log = feed.next()
        sync()
        storage, mom, m = tr.run_step(storage, mom, b, lr, io_log=log)
        r = tr.records[-1]
        table = tstep.step_wire_table(plan.with_round_tos(r.round_tos), cfg, spec_tree,
                                      mesh_cfg, (batch, seq))
        for k in tstep.COLLECTIVE_CLASSES:
            check(r.measured_by_entry.get(k, 0) == table[k],
                  f"rank {rank} step {len(out['steps'])}: measured {k} "
                  f"{r.measured_by_entry.get(k, 0)} B != step_wire_table {table[k]} B")
        out["steps"].append({"loss": r.loss, "wall_s": r.wall_s, "stage_s": r.stage_s,
                             "round_tos": r.round_tos, "io": r.io_by_entry})
        check(math.isfinite(r.loss), f"rank {rank}: loss {r.loss}")
        if on_card:
            check_seen_packing(torch, packs)
            check_seen_monitor(monitor, errs)
        return storage, mom

    zero_counts()
    tr = trainer()
    feed = ShardFeed(torch, shard_dir, plan, cfg.vocab_size, batch, seq, device)
    try:
        for _ in range(MIO_SAVE_AT):
            storage, mom = step(tr, storage, mom, feed)
        rts = tr.current_round_tos()
        state = feed.logs[-1]["data_state"]  # the consumed batch's, not the reader's
        at_submit = (tree_digest(torch, storage), tree_digest(torch, mom))
        # the hand-off export (sync, no residuals), then the async checkpoint
        export, path = os.path.join(root, "export"), os.path.join(root, "ckpt")
        first = len(comm.LOG)
        sync()
        t0 = time.perf_counter()
        emeta = C.save_checkpoint(export, storage, None, None, MIO_SAVE_AT, plan=plan,
                                  spec_tree=spec_tree, round_tos=rts, residuals=False,
                                  mesh_cfg=mesh_cfg)
        out["export_s"] = time.perf_counter() - t0
        out["export_wire"] = checkpoint_wire(comm.LOG[first:])
        ac = C.AsyncCheckpointer()
        first = len(comm.LOG)
        sync()
        t0 = time.perf_counter()
        C.save_checkpoint(path, storage, mom, tr.controller, MIO_SAVE_AT, plan=plan,
                          spec_tree=spec_tree, round_tos=rts, extra={"data_state": state},
                          async_ckpt=ac, mesh_cfg=mesh_cfg)
        out["submit_s"] = time.perf_counter() - t0
        out["gather_wire"] = checkpoint_wire(comm.LOG[first:])
        out["in_flight"] = ac.in_flight
        storage, mom = step(tr, storage, mom, feed)  # step 3, beside rank 0's writer
        out["step3_s"] = time.perf_counter() - t0
        ac.wait()
        out["save_s"] = time.perf_counter() - t0
    finally:
        feed.close()
    after3 = (tree_digest(torch, storage), tree_digest(torch, mom))
    hist = list(tr.bits_history)
    d = C.ckpt_dir(path)
    meta = read_meta(d)
    mb, eb = manifest_bytes(meta), manifest_bytes(emeta)
    analytic = train_checkpoint_bytes(global_like(storage, spec_tree, mesh_cfg),
                                      global_like(mom, spec_tree, mesh_cfg),
                                      spec_tree=spec_tree, round_tos=rts)
    files = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d) if f.endswith(".bin"))
    check(mb == analytic and mb["total"] == files,
          f"rank {rank}: checkpoint bytes: manifest {mb}, train_checkpoint_bytes {analytic}, "
          f"files {files}")
    check(eb == train_checkpoint_bytes(global_like(storage, spec_tree, mesh_cfg),
                                       spec_tree=spec_tree, round_tos=rts, residuals=False)
          and eb["residual"] == 0, f"rank {rank}: export bytes {eb}")
    check(meta["extra"] == {"data_state": state} and meta["step"] == MIO_SAVE_AT,
          f"rank {rank}: checkpoint step {meta['step']}, extra {meta['extra']}")
    check(after3[0] != at_submit[0], f"rank {rank}: step 3 left the weights unchanged")
    out.update(ckpt=mb, export=eb, rts=rts)

    # a load into fresh tensors: the state at submit, not after step 3
    ctl = trainer()
    first = len(comm.LOG)
    sync()
    t0 = time.perf_counter()
    st2, mo2, at = C.load_checkpoint(path, storage, mom, ctl.controller, spec_tree=spec_tree,
                                     mesh_cfg=mesh_cfg)
    sync()
    out["load_s"] = time.perf_counter() - t0
    out["scatter_wire"] = checkpoint_wire(comm.LOG[first:])
    check((tree_digest(torch, st2), tree_digest(torch, mo2)) == at_submit,
          f"rank {rank}: the checkpoint does not read back as the state at submit")
    check(at == MIO_SAVE_AT and ctl.bits_history == hist[:len(ctl.bits_history)],
          f"rank {rank}: restored step {at}, AWP {ctl.bits_history}")
    del storage, mom
    gc.collect()

    # the hand-off: launch.serve's restore of the export (at the wire widths),
    # served at 2×2 weight-stationary, against the weights truncated in memory
    widths = assign_widths(st2, spec_tree, rts)
    t0 = time.perf_counter()
    wire_w, _ = restore(export, st2, spec_tree, mesh_cfg)
    out["wire_load_s"] = time.perf_counter() - t0
    truncated = truncate_tree(torch, st2, widths)
    check(tree_digest(torch, wire_w) == tree_digest(torch, truncated),
          f"rank {rank}: the export does not read back as the truncated weights")
    serve_plan = PrecisionPlan.build(nrt, round_to=2)
    req = Request(rid=0, prompt_ids=prompt, max_new=gen)
    streams, serve_s = [], []
    for w in (wire_w, truncated):
        sync()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, mesh_cfg, mesh, spec_tree, w, plan=serve_plan,
                             max_slots=TP_DP, cache_capacity=len(prompt) + gen,
                             weight_stationary=True)
        streams.append(engine.run([req])[0].tokens)
        serve_s.append(time.perf_counter() - t0)
        del engine
    check(streams[0] == streams[1] and len(streams[0]) == gen,
          f"rank {rank}: hand-off streams {streams[0]} != {streams[1]}")
    out.update(stream=streams[0], serve_s=serve_s)
    del wire_w, truncated
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # step 3 again, from the restored state and the restored reader
    feed = ShardFeed(torch, shard_dir, plan, cfg.vocab_size, batch, seq, device,
                     C.load_extra(path)["data_state"])
    try:
        st2, mo2 = step(ctl, st2, mo2, feed)
    finally:
        feed.close()
    losses = [s["loss"] for s in out["steps"]]
    check(losses[-1] == losses[MIO_SAVE_AT], f"rank {rank}: resumed step 3 loss {losses[-1]!r}"
                                             f" != {losses[MIO_SAVE_AT]!r}")
    check(ctl.bits_history == hist, f"rank {rank}: resumed AWP {ctl.bits_history} != {hist}")
    check((tree_digest(torch, st2), tree_digest(torch, mo2)) == after3,
          f"rank {rank}: resumed storage or momentum differs from the uninterrupted run's")
    sync()
    got = counts()
    for u in undo:
        u()
    check_seen_flash(seen_flash)
    # launches: every training step (below 32 bits) packs each DIST leaf per
    # use, the remat backward again; the monitor once a leaf a step; each
    # weight-stationary serve run places once and gathers for its admission
    dist_specs = [s for s in tree_leaves(spec_tree) if s.kind == DIST]
    group_dist = [s for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST]
    per_forward = dist_per_forward(spec_tree)
    per_step = per_forward + (sum(s.reps for s in group_dist) if cfg.remat else 0)
    n_steps = len(out["steps"])
    check(all(min(s["round_tos"]) < 4 for s in out["steps"]), "a step ran at 32 bits")
    packed = n_steps * per_step + 2 * (per_forward + len(dist_specs))
    viable = on_card and cfg.head_dim % 128 == 0 and len(prompt) % 128 == 0
    want = {"bitpack": packed * on_card, "bitunpack": packed * on_card,
            "flash_prefill": 2 * cfg.num_layers * viable, "paged_attend": 0,
            "l2norm_sq": n_steps * len(dist_specs) * on_card}
    check(got == want, f"rank {rank}: phase 18 (a) launches {got}, expected {want}")
    out.update(launches=got, hist=hist, losses=losses,
               flash_err=max((r["max_abs_err"] for r in seen_flash.values()), default=0.0),
               monitor_err=max(errs, default=0.0), n_dist=len(dist_specs))
    return out


def hold_on_mesh(torch, label, got, want, requests, setup, plan, mesh, *, near_tie=0.0,
                 what="the reference run"):
    """``got`` against ``want`` request by request on a mesh (every rank
    alike): a divergence prints its position and the draw's distance to
    its nearest boundary (the top-2 gap for greedy) in a batch-1 static run
    at the mesh, and fails unless it is below ``near_tie``. Returns the
    cases."""
    cfg, mesh_cfg, spec_tree, storage = setup
    cases = []
    for r in requests:
        t = diverged_at(got[r.rid], want[r.rid])
        if t is None:
            continue
        _, dists, _ = static_trace(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                                   mesh=mesh)
        say(f"   {label}: DIVERGED request {r.rid} (prompt {len(r.prompt_ids)}) at token {t}: "
            f"{got[r.rid][t]} against {what}'s {want[r.rid][t]}; the draw {dists[t]:.3e} from "
            f"a boundary (batch-1 static at the mesh)")
        cases.append((r.rid, t, dists[t]))
        check(dists[t] < near_tie, f"{label}: request {r.rid} left {what} at token {t}, "
                                   f"{dists[t]:.3e} from a boundary (bound {near_tie})")
    return cases


def _mesh_serve_rank(rank, device_name, cfg, greedy, sampled, one_device, window, spec_k):
    """One rank of phase 18 (b) and (c) (a 1×2 mesh): phase 15's sampled
    requests through the engine and the speculative engine (self and tiny
    drafts, both on the mesh), then a windowed static run and the ring
    engine; launches, wire per forward and host<->device bytes checked,
    streams held to each other and to ``one_device`` (phase 15's, cut to
    these lengths). Returns the measurements."""
    import torch

    from repro_torch import fp32_math
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.launch.serve import check_wire, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine, generate_static
    from repro_torch.serve.spec import DraftBundle, build_draft
    from repro_torch.train.step import COLLECTIVE_CLASSES

    fp32_math()
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh_cfg = MeshCfg(tp=TPS_TP)
    mesh = make_mesh_from_cfg(mesh_cfg)
    t0 = time.perf_counter()
    _, spec_tree, storage = setup(cfg, seed=0, device=device, mesh_cfg=mesh_cfg, rank=rank)
    drafts = {"self": DraftBundle(cfg, spec_tree, storage),
              "tiny": build_draft(cfg, mesh_cfg, "tiny", seed=1, device=device)}
    sync()
    out = {"setup_s": time.perf_counter() - t0, "runs": {}}
    setup4 = (cfg, mesh_cfg, spec_tree, storage)
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    cap = max(len(r.prompt_ids) for r in greedy) + max(r.max_new for r in greedy)
    per_forward = dist_per_forward(spec_tree)
    flash_ok = on_card and cfg.head_dim % 128 == 0
    seen_flash, packs = {}, {}
    undo = [watch_flash(torch, seen_flash)]
    if on_card:
        undo.append(watch_packing(torch, packs))

    def run(label, requests, *, engine=None, draft=None, **kw):
        zero_counts()
        first = len(comm.LOG)
        timings = {"admit": [], "decode": []}
        sync()
        t0 = time.perf_counter()
        rec = {}
        draft_flash = 0
        if engine is None:
            streams = generate_static(cfg, mesh_cfg, mesh, spec_tree, storage, requests,
                                      plan=plan, **kw)
            groups = static_groups(requests)
            packed = per_forward * sum(max(r.max_new for r in g) for g in groups)
            prefills = [len(g[0].prompt_ids) for g in groups]
            measured = comm.wire_by_traffic(comm.LOG[first:])
            want_wire = static_wire(plan, cfg, spec_tree, mesh_cfg, groups)
            for k in COLLECTIVE_CLASSES:
                check(measured.get(k, 0) == want_wire[k], f"rank {rank} {label}: measured {k} "
                      f"{measured.get(k, 0)} B != serve_wire_table {want_wire[k]} B")
        else:
            eng = ServeEngine(cfg, mesh_cfg, mesh, spec_tree, storage, plan=plan,
                              max_slots=SERVE_SLOTS, draft=draft, **engine)
            instrument(eng, timings)
            streams = {k: r.tokens for k, r in eng.run(requests).items()}
            summary = eng.wire_summary()
            check_wire(eng, plan, requests)  # raises on a mismatch
            for r, t in zip(eng.wire_log, eng.wire_tables(), strict=True):
                for k in COLLECTIVE_CLASSES:
                    check(r["wire"].get(k, 0) == t[k],
                          f"rank {rank} {label} step {r['step']} {r['kind']}: measured {k} "
                          f"{r['wire'].get(k, 0)} B != serve_wire_table {t[k]} B")
            steps = summary.get("spec_rounds", summary["decode_steps"])
            packed = per_forward * (summary["admissions"] + steps)
            if draft is not None:  # the draft's prefills and k + 1 micro steps a round
                packed += dist_per_forward(draft.spec_tree) * (
                    summary["admissions"] + steps * (spec_k + 1))
                draft_flash = draft.cfg.num_layers * sum(
                    on_card and draft.cfg.head_dim % 128 == 0 and len(r.prompt_ids) % 128 == 0
                    for r in requests)
            prefills = [len(r.prompt_ids) for r in requests]
            rec["summary"] = summary
            eng = None
            gc.collect()
        sync()
        rec["wall_s"] = time.perf_counter() - t0
        got = counts()
        want = {"flash_prefill": cfg.num_layers * sum(flash_ok and S % 128 == 0
                                                      for S in prefills) + draft_flash,
                "paged_attend": 0, "bitpack": packed * on_card, "bitunpack": packed * on_card,
                "l2norm_sq": 0}
        check(got == want, f"rank {rank} {label}: launches {got}, expected {want}")
        check_seen_flash(seen_flash)
        if on_card:
            check_seen_packing(torch, packs)
        dec = sorted(timings["decode"])
        rec.update(streams=streams, launches=got,
                   step_ms=dec[len(dec) // 2] * 1e3 if dec else None,
                   stage_s=sum(c.stage_s for c in comm.LOG[first:]),
                   tokens=sum(len(s) for s in streams.values()))
        out["runs"][label] = rec
        return streams

    # (b) sampled: the engine, then the speculative engine with each draft
    def hold(label, got, want, requests, what):
        out["diverged"].setdefault(label, []).extend(hold_on_mesh(
            torch, label, got, want, requests, setup4, plan, mesh, near_tie=FEAT_NEAR_TIE,
            what=what))

    out["diverged"] = {}
    engine = run("(b) sampled engine", sampled, engine={"cache_capacity": cap})
    if one_device is not None:
        hold("(b) sampled engine", engine, one_device["sampled"], sampled,
             "one device's (phase 15)")
    for name in ("self", "tiny"):
        label = f"(b) spec {name}"
        streams = run(label, sampled, engine={"cache_capacity": cap, "spec_k": spec_k},
                      draft=drafts[name])
        hold(label, streams, engine, sampled, "the 1×2 engine")
        if one_device is not None:
            hold(label, streams, one_device["sampled"], sampled, "one device's (phase 15)")
    del drafts

    # (c) a window: the static run (linear cache, window mask) and the ring engine
    static = run("(c) window static", greedy, window=window)
    ring = run("(c) window engine", greedy,
               engine={"cache_capacity": min(cap, window), "window": window})
    check(ring == static, f"rank {rank}: (c) the ring engine's streams differ from the windowed "
                          "static run's")
    if one_device is not None:
        hold("(c) window", static, one_device["window"], greedy, "one device's (phase 15)")
    for u in undo:
        u()
    out["flash_err"] = max((r["max_abs_err"] for r in seen_flash.values()), default=0.0)
    out["flash_shapes"] = sorted(seen_flash)
    return out


def mesh_path(torch, device, phase15=None, *, cfg=None, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR,
              gen=MESH_GEN, window=FEAT_WINDOW, spec_k=FEAT_SPEC_K, min_free=IO_MIN_FREE,
              requests=None, a_layers=None):
    """Phase 18: (a) full-width qwen3-1.7b (phase 11's weights and settings)
    trained on a 2×2 mesh of gloo ranks from phase 17's shards, with an
    export and an async checkpoint across ranks, a load and a resume, and
    the export served at 2×2; (b) phase 15's sampled requests at 1×2
    through the engine and the speculative engine; (c) a window at 1×2.
    ``phase15`` holds phase 15's one-device streams and requests (phase 7's
    prompts); without it (a run of this phase alone) (b) and (c) are held
    to each other only. ``a_layers`` cuts (a)'s model to that many layers
    (widths unchanged), as phases 13 and 17 are cut. Launch counts, packing
    records and times are read on a card only, so the phase rehearses on the
    CPU at a reduced config. Returns the measurements; raises on a failed
    check."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.shards import write_lm_shards
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.serve import build_requests
    from repro_torch.serve.engine import Request

    full_width = cfg is None and a_layers is None
    cfg = cfg or get_config("qwen3-1.7b")
    cfg_a = dataclasses.replace(cfg, num_layers=a_layers) if a_layers else cfg
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip() if on_card else "the CPU"
    if requests is None:
        requests = phase15["requests"] if phase15 else build_requests(SERVE_LENS, gen,
                                                                      cfg.vocab_size)
    greedy = [Request(rid=r.rid, prompt_ids=r.prompt_ids, max_new=gen) for r in requests]
    sampled = sampled_requests(greedy)
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {}
    threads = 2 if on_card else 1
    try:
        free = shutil.disk_usage(root).free
        check(free >= min_free, f"phase 18 needs {min_free:.0f} B free under {root}, has {free} B")
        shard_dir = os.path.join(root, "shards")
        write_lm_shards(shard_dir, vocab=cfg.vocab_size, seq=seq, num_records=IO_RECORDS, seed=0)
        t0 = time.perf_counter()
        ranks = spawn_ranks(_mesh_io_rank, TP_DP * TP_TP, str(device), cfg_a, batch, seq, lr,
                            root, shard_dir, greedy[0].prompt_ids, gen, threads=threads,
                            timeout_s=900)
        a_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    check(not full_width or r0["ckpt"]["total"] == QWEN3_CKPT_BYTES,
          f"(a) checkpoint {r0['ckpt']['total']} B, expected {QWEN3_CKPT_BYTES} (no padding at "
          "full width: the 2×2 global storage holds the one device's elements)")
    for r, o in enumerate(ranks):
        check(o["losses"] == r0["losses"] and o["hist"] == r0["hist"]
              and o["stream"] == r0["stream"], f"(a): rank {r}'s losses, AWP history or stream "
                                               "differ from rank 0's")
    check(r0["hist"][0] == (0, (8,) * (cfg_a.num_groups + 1)), f"(a) AWP history {r0['hist']}")
    steps = r0["steps"]
    warm = steps[1:MIO_SAVE_AT] + steps[MIO_SAVE_AT + 1:]
    say(f"   (a) 2×2, {smi}: losses {[round(x, 6) for x in r0['losses']]} (the last, step "
        f"{MIO_SAVE_AT + 1} resumed, bit-equal to the uninterrupted one on every rank, as the "
        f"storage and momentum blocks and the AWP history {r0['hist']}); step ms "
        f"{[round(s['wall_s'] * 1e3, 1) for s in steps]}, gloo staging share "
        f"{sum(s['stage_s'] for s in warm) / max(sum(s['wall_s'] for s in warm), 1e-9):.1%} "
        f"after the first; io_log == train_ingest_bytes each batch on each rank; wire == "
        f"step_wire_table each step")
    ck, ex = r0["ckpt"], r0["export"]
    say(f"   (a) async checkpoint at step {MIO_SAVE_AT} (round_tos {r0['rts']}): submit "
        f"{r0['submit_s'] * 1e3:.1f} ms (the gather of {r0['gather_wire']} B to rank 0, rank "
        f"0's in flight after: {r0['in_flight']}), step {MIO_SAVE_AT + 1} beside the writer "
        f"done {r0['step3_s']:.2f} s after submit, save done {r0['save_s']:.2f} s after submit; "
        f"{ck['total']} B = wire {ck['wire']} + residual {ck['residual']} == "
        f"train_checkpoint_bytes == the files' sizes; export {ex['total']} B in "
        f"{r0['export_s']:.2f} s (gather {r0['export_wire']} B); {smi}")
    say(f"   (a) load across ranks {r0['load_s']:.2f} s ({ck['total'] / r0['load_s'] / 1e9:.2f} "
        f"GB/s, scatter {r0['scatter_wire']} B from rank 0), equal to the state at submit on "
        f"every rank; the export at the wire widths in {r0['wire_load_s']:.2f} s, served at 2×2 "
        f"weight-stationary ({len(greedy[0].prompt_ids)}-token prompt +{gen}): "
        f"{r0['stream']} == the weights truncated in memory "
        f"({[round(x, 2) for x in r0['serve_s']]} s); launches per rank "
        f"{[o['launches'] for o in ranks]}; ranks' processes {a_s:.1f} s, set-up "
        f"{[round(o['setup_s'], 1) for o in ranks]} s; {smi}")
    out["a"] = ranks

    one = None
    if phase15:  # the first gen tokens of phase 15's streams: a stream's prefix is its own
        one = {k: {rid: s[:gen] for rid, s in phase15[k].items()} for k in ("sampled", "window")}
    t0 = time.perf_counter()
    ranks = spawn_ranks(_mesh_serve_rank, TPS_TP, str(device), cfg, greedy, sampled, one,
                        window, spec_k, threads=threads, timeout_s=900)
    bc_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r, o in enumerate(ranks):
        for label in r0["runs"]:
            check(o["runs"][label]["streams"] == r0["runs"][label]["streams"],
                  f"(b)/(c): rank {r}'s {label} streams differ from rank 0's")
    for label, rec in r0["runs"].items():
        line = (f"   {label} at 1×2: {rec['wall_s']:.2f} s, {rec['tokens']} tokens, "
                f"{rec['tokens'] / rec['wall_s']:.2f} tokens/s, gloo staging "
                f"{rec['stage_s']:.2f} s, launches {rec['launches']}")
        if rec["step_ms"] is not None:
            line += f", ms a {'round' if 'spec' in label else 'decode step'} {rec['step_ms']:.1f}"
        s = rec.get("summary", {})
        if "spec_rounds" in s:
            line += (f"; {s['spec_rounds']} rounds, acceptance {s['acceptance_rate']:.4f}, "
                     f"{s['tokens_per_target_step']:.3f} tokens a target step")
        say(line + f"; {smi}")
    div = {k: v for k, v in r0["diverged"].items() if v}
    say(f"   (b), (c) held: speculative streams == the 1×2 engine's, ring == windowed static"
        + (", both == phase 15's one-device streams" if phase15 else "")
        + (f" but for near ties {div}" if div else "") + f"; ranks' processes {bc_s:.1f} s; "
        f"{smi}")
    out["bc"] = ranks
    launches = {k: sum(o["launches"][k] for o in out["a"]) for k in counts()}
    for o in ranks:
        for rec in o["runs"].values():
            for k in launches:
                launches[k] += rec["launches"][k]
    phase_s = time.perf_counter() - t_phase
    say(f"   launches over phase 18's runs {launches}; phase 18 took {phase_s:.1f} s; {smi}")
    return {"launches": launches, "phase_s": phase_s,
            "flash_err": max([o["flash_err"] for o in out["a"]]
                             + [o["flash_err"] for o in ranks]),
            "monitor_err": max(o["monitor_err"] for o in out["a"])}


# ---------------------------------------------------------------------------
# phase 19: the serving fleet — prefill workers, decode replicas, the router,
# the fabric's parcels and a rolling weight refresh
# ---------------------------------------------------------------------------

FLEET_REPLICAS, FLEET_WORKERS = 2, 2
FLEET_REFRESH_AT = 2  # results before version 1 is published
FLEET_JOIN_AT = 3  # the tick before which r2 joins and r0 leaves
FLEET_TRIO_RID, FLEET_SAMPLED_RID = 5, 10  # rids of the shared-prefix trio, the sampled five


def _fleet_watch(torch, on_card, L, per_forward, flash_ok, rec):
    """Patch the fleet's classes so that every worker prefill and every
    replica tick has its launch counts checked against the local paged
    engine's for the same work (a prefill: ``flash_prefill`` at a page-padded
    length that is a multiple of 128 and one materialization a DIST leaf;
    a tick with live slots: one ``paged_attend`` a layer on an fp32 pool and
    one materialization), and the pack, send, install, decode and publish
    times land in ``rec``. Returns the undo function."""
    from repro_torch.fleet import replica as R
    from repro_torch.fleet import router as F
    from repro_torch.transport import fabric

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    old = {"prefill": R.PrefillWorker.prefill, "tick": R.DecodeReplica.tick,
           "admit": R.DecodeReplica.admit_parcel, "pack": F.pack_kv_pages,
           "send": fabric.FabricChannel.send, "publish": F.FleetRouter.publish}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    def prefill(self, storage, req, *, n_hits=0):
        before, t0 = counts(), time.perf_counter()
        out = old["prefill"](self, storage, req, n_hits=n_hits)
        sync()
        rec["prefill"].append(time.perf_counter() - t0)
        padded = -(-len(req.prompt_ids) // self.page_size) * self.page_size
        want = {"flash_prefill": L * (flash_ok and padded % 128 == 0), "paged_attend": 0,
                "bitpack": per_forward * on_card, "bitunpack": per_forward * on_card,
                "l2norm_sq": 0}
        got = delta(before)
        check(got == want, f"worker {self.name}, request {req.rid} (padded {padded}): launches "
                           f"{got}, the local paged admission's {want}")
        rec["prefills"] += 1
        return out

    def tick(self):
        active, before, t0 = self.engine.active_slots, counts(), time.perf_counter()
        old["tick"](self)
        if active:
            rec["decode"].append(time.perf_counter() - t0)
            rec["ticks"] += 1
        paged = L * on_card * (not self.engine.plan.int8_kv)
        want = {"flash_prefill": 0, "paged_attend": paged * bool(active),
                "bitpack": per_forward * on_card * bool(active),
                "bitunpack": per_forward * on_card * bool(active), "l2norm_sq": 0}
        got = delta(before)
        check(got == want, f"replica {self.name}, a tick with {active} live slots: launches "
                           f"{got}, the local paged engine's decode step's {want}")

    def admit(self, req, parcel):
        t0 = time.perf_counter()
        old["admit"](self, req, parcel)
        sync()
        rec["install"].append(time.perf_counter() - t0)

    def pack(pages, policy, *, meta=None):
        t0 = time.perf_counter()
        out = old["pack"](pages, policy, meta=meta)
        rec["pack"].append(time.perf_counter() - t0)
        return out

    def send(self, parcel, *, cls, src, dst):
        t0 = time.perf_counter()
        out = old["send"](self, parcel, cls=cls, src=src, dst=dst)
        rec["send"].append(time.perf_counter() - t0)
        return out

    def publish(self, parcel):
        t0 = time.perf_counter()
        old["publish"](self, parcel)
        sync()
        rec["publish_decode"].append(time.perf_counter() - t0)

    R.PrefillWorker.prefill, R.DecodeReplica.tick = prefill, tick
    R.DecodeReplica.admit_parcel, F.pack_kv_pages = admit, pack
    fabric.FabricChannel.send, F.FleetRouter.publish = send, publish

    def undo():
        R.PrefillWorker.prefill, R.DecodeReplica.tick = old["prefill"], old["tick"]
        R.DecodeReplica.admit_parcel, F.pack_kv_pages = old["admit"], old["pack"]
        fabric.FabricChannel.send, F.FleetRouter.publish = old["send"], old["publish"]

    return undo


def _ms(xs):
    xs = sorted(x * 1e3 for x in xs)
    return f"median {xs[len(xs) // 2]:.2f} (min {xs[0]:.2f}, max {xs[-1]:.2f}, {len(xs)})" \
        if xs else "none"


def fleet_path(torch, device, refs, *, cfg=None, page=PAGE, shared=SHARED_PREFIX,
               tails=SHARED_TAILS):
    """qwen3-1.7b (full width) through the fleet (``repro_torch.fleet``) on
    one device, phase 9's geometry (round_to 2, page 64, 2 slots a replica,
    capacity the longest prompt + its tokens). ``refs`` holds what the
    streams are held to: ``requests`` and ``static`` (phase 7's greedy
    requests and static streams), ``sampled`` (phase 15 (a)'s engine
    streams) and ``int8`` (phase 15 (b)'s paged int8 streams), all at the
    fleet's depth.

    (a) Weights from seed 0 published as version 0 (a wire-only parcel of
    ``train_checkpoint_bytes(residuals=False)``), 2 replicas, 2 workers:
    phase 7's requests and (c) phase 15 (a)'s sampled ones pinned to it;
    after 2 results version 1 (seed 1) is published and phase 9's
    shared-prefix trio submitted; before tick 3 a replica joins and one
    leaves. Streams equal to phase 7's static ones, to phase 15 (a)'s, and
    the trio to ``generate_static`` under the weights restored from the
    version-1 parcel (a divergence passes only at a top-2 gap below
    ``NEAR_TIE``, as phase 9's shared prefix: the resident prefix pages
    hold the first writer's bits); the hop log equal to
    ``fleet_migration_bytes``. (b) An int8-KV fleet from the same version-0
    parcel: phase 7's requests equal to phase 15 (b)'s paged int8 streams.
    Every worker prefill and replica tick has its launches checked against
    the local paged engine's for the same work, and the first flash and
    ``paged_attend`` launch at each shape is held to the plain version.
    Launch counts and memory are read on a card only, so the phase
    rehearses on the CPU at a reduced config. Returns the measurements;
    raises on a failed check."""
    from repro_torch.checkpoint.sharded import manifest_bytes
    from repro_torch.configs.registry import get_config
    from repro_torch.fleet import DecodeReplica, FleetRouter, PrefillWorker, WeightPublisher
    from repro_torch.launch.serve import build_requests, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import fleet_migration_bytes, train_checkpoint_bytes
    from repro_torch.serve.engine import Request, ServeEngine, generate_static

    full_width = cfg is None
    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    setup4 = (cfg, mesh_cfg, spec_tree, storage)
    nrt, L = cfg.num_groups + 1, cfg.num_layers
    plan = PrecisionPlan.build(nrt, round_to=2)
    plan8 = PrecisionPlan.build(nrt, round_to=2, int8_kv=True)
    requests = refs["requests"]
    gen = requests[0].max_new
    cap = max(len(r.prompt_ids) for r in requests) + gen
    per_forward = dist_per_forward(spec_tree)
    flash_ok = on_card and cfg.head_dim % 128 == 0
    def new_rec():
        return {**{k: [] for k in ("prefill", "decode", "install", "pack", "send",
                                   "publish_decode")}, "prefills": 0, "ticks": 0}

    rec, rec8 = new_rec(), new_rec()

    # the two versions' parcels
    pub = WeightPublisher(cfg, spec_tree, plan=plan)
    t0 = time.perf_counter()
    p0 = pub.publish(storage)
    enc = [time.perf_counter() - t0]
    model = train_checkpoint_bytes(storage, spec_tree=spec_tree, round_tos=plan.round_tos,
                                   residuals=False)["total"]
    check(p0.nbytes == manifest_bytes(p0.manifest_meta())["total"] == model and not p0.residuals,
          f"v0 parcel {p0.nbytes} B, train_checkpoint_bytes(residuals=False) {model} B")
    check(not full_width or p0.nbytes == QWEN3_EXPORT_BYTES,
          f"v0 parcel {p0.nbytes} B, phase 17's width-2 export {QWEN3_EXPORT_BYTES} B")
    storage1 = setup(cfg, seed=1, device=device)[2]
    t0 = time.perf_counter()
    p1 = pub.publish(storage1, step=1)
    enc.append(time.perf_counter() - t0)
    del storage1
    check(p1.nbytes == p0.nbytes, f"v1 parcel {p1.nbytes} B, v0 {p0.nbytes} B")
    say(f"   publish: v0 and v1 parcels of {p0.nbytes} B each (wire tiers at round_to 2) == "
        f"train_checkpoint_bytes(residuals=False) == manifest_bytes; encode s "
        f"{[round(x, 2) for x in enc]}")

    def fleet(p, n_rep, n_wrk, names=None):
        replicas = [DecodeReplica(name, ServeEngine(
            cfg, mesh_cfg, None, spec_tree, storage, plan=p, max_slots=SERVE_SLOTS,
            cache_capacity=cap, paged=True, page_size=page))
            for name in names or [f"r{i}" for i in range(n_rep)]]
        workers = [PrefillWorker(f"w{i}", cfg, mesh_cfg, None, spec_tree, plan=p,
                                 cache_capacity=cap, page_size=page) for i in range(n_wrk)]
        return replicas, workers

    def pin(router, p, label):
        ws = router.wire_summary()
        model = fleet_migration_bytes(
            p, cfg, page_size=page, migrated_pages=ws["migrated_pages"], int8_kv=p.int8_kv,
            publish_wire_bytes=p0.nbytes, publish_installs=ws["publish_installs"])
        for cls in ("kv_migration", "weight_publish"):
            check(ws[cls] == model[cls], f"{label}: fabric {cls} {ws[cls]} B, "
                                         f"fleet_migration_bytes {model[cls]} B")
        per = 2 * page * cfg.num_kv_heads * cfg.head_dim * L
        want_page = per * (4 if not p.int8_kv else 2) + (
            2 * page * cfg.num_kv_heads * 4 * L if p.int8_kv else 0)
        check(model["page_wire_bytes"] == want_page,
              f"{label}: {model['page_wire_bytes']} B a page, expected {want_page}")
        say(f"   {label}: fabric kv_migration {ws['kv_migration']} B over "
            f"{ws['hops']['kv_migration']} hops ({ws['migrated_pages']} pages of "
            f"{model['page_wire_bytes']} B at {model['kv_width']} B/elem), weight_publish "
            f"{ws['weight_publish']} B over {ws['publish_installs']} installs == "
            f"fleet_migration_bytes; {ws['ticks']} ticks")
        return ws

    seen_flash, seen_paged = {}, []
    undo = [watch_flash(torch, seen_flash), _fleet_watch(torch, on_card, L, per_forward,
                                                         flash_ok, rec)]
    if on_card:
        undo.append(watch_paged(torch, seen_paged, 8 * L))
    try:
        # (a) + (c): version 0's greedy and sampled waves, the refresh, join and leave
        greedy = [Request(rid=r.rid, prompt_ids=r.prompt_ids, max_new=gen) for r in requests]
        sampled = sampled_requests(greedy)
        sampled_f = [dataclasses.replace(r, rid=FLEET_SAMPLED_RID + r.rid) for r in sampled]
        trio = [dataclasses.replace(r, rid=FLEET_TRIO_RID + r.rid)
                for r in build_requests(tails, gen, cfg.vocab_size, shared_prefix=shared)]
        replicas, workers = fleet(plan, FLEET_REPLICAS, FLEET_WORKERS)
        router = FleetRouter(replicas, workers)
        router.publish(p0)
        state = {"refresh": None, "join": None}

        def on_tick(r):
            if state["join"] is None and r.ticks + 1 >= FLEET_JOIN_AT:
                state["join"] = r.ticks
                joiner, _ = fleet(plan, 1, 0, names=["r2"])
                r.add_replica(joiner[0])
                r.remove_replica("r0")
            if state["refresh"] is None and len(r.results) >= FLEET_REFRESH_AT:
                state["refresh"] = r.ticks
                r.publish(p1)
                for req in trio:
                    r.submit(req)

        zero_counts()
        t0 = time.perf_counter()
        results = router.run(greedy + sampled_f, on_tick=on_tick)
        wall = time.perf_counter() - t0
        got = counts()
        check(state["refresh"] is not None and state["join"] is not None,
              f"(a): the refresh or the join never fired ({state})")
        check([r.name for r in router.replicas] == ["r1", "r2"],
              f"(a): replicas {[r.name for r in router.replicas]} after the join and leave")
        versions = {rid: m["version"] for rid, m in router.placements.items()}
        trio_rids = {r.rid for r in trio}
        check(versions == {r.rid: int(r.rid in trio_rids) for r in greedy + sampled_f + trio},
              f"(a): versions at admission {versions}")
        ws = pin(router, plan, "(a)")
        launched_a = got
        # the whole run's launches: the per-call checks, summed
        want = {"flash_prefill": L * sum(
            flash_ok and -(-len(r.prompt_ids) // page) * page % 128 == 0
            for r in greedy + sampled_f + trio),
            "paged_attend": L * rec["ticks"] * on_card,
            "bitpack": per_forward * (rec["prefills"] + rec["ticks"]) * on_card,
            "l2norm_sq": 0}
        want["bitunpack"] = want["bitpack"]
        check(got == want, f"(a): launches {got}, expected {want}")
        tokens = sum(len(r.tokens) for r in results.values())
        say(f"   (a)+(c): {len(results)} requests ({len(greedy)} greedy and {len(sampled_f)} "
            f"sampled at v0, {len(trio)} shared-prefix at v1) in {wall:.2f} s, {tokens} tokens, "
            f"{tokens / wall:.1f} tokens/s; v1 published at tick {state['refresh']}, r2 joined "
            f"and r0 left at tick {state['join']}; {rec['prefills']} worker prefills, "
            f"{rec['ticks']} replica decode ticks, launches {got} (each prefill and tick equal "
            "to the local paged engine's)")
        streams = {rid: r.tokens for rid, r in results.items()}
        bad = [r for r in greedy if streams[r.rid] != refs["static"][r.rid]]
        for r in bad:
            report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                              streams[r.rid], refs["static"][r.rid])
        check(not bad, f"(a): streams of {[r.rid for r in bad]} differ from phase 7's static")
        hold_streams(torch, "(c) sampled fleet",
                     {r.rid: streams[FLEET_SAMPLED_RID + r.rid] for r in sampled},
                     refs["sampled"], sampled, setup4, plan, what="phase 15 (a)'s engine")
        v1 = router.versions[1]
        check_seen_flash(seen_flash)
    finally:
        for u in undo:
            u()
    t0 = time.perf_counter()
    tstatic = generate_static(cfg, mesh_cfg, None, spec_tree, v1, trio, plan=plan)
    static_s = time.perf_counter() - t0
    tdiv = [r for r in trio if streams[r.rid] != tstatic[r.rid]]
    for r in tdiv:
        gap = report_divergence(torch, cfg, mesh_cfg, spec_tree, v1, plan, r, streams[r.rid],
                                tstatic[r.rid])
        check(gap < NEAR_TIE, f"(a): trio request {r.rid} diverged at a top-2 gap of {gap:.3e} "
                              f">= {NEAR_TIE}")
    say(f"   (a): phase 7's {len(greedy)} streams equal to its static reference; "
        f"{len(trio) - len(tdiv)} of {len(trio)} v1 trio streams equal to generate_static under "
        f"the weights restored from the v1 parcel ({static_s:.2f} s); (c): phase 15 (a)'s "
        f"{len(sampled)} sampled streams equal (seeds {list(FEAT_SEEDS)})")
    peak_a = torch.cuda.max_memory_allocated() if on_card else 0
    del router, replicas, workers, results, v1
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (b) int8 KV from the same version-0 parcel
    undo = [watch_flash(torch, seen_flash),
            _fleet_watch(torch, on_card, L, per_forward, flash_ok, rec8)]
    try:
        replicas, workers = fleet(plan8, FLEET_REPLICAS, FLEET_WORKERS)
        router = FleetRouter(replicas, workers)
        router.publish(p0)
        zero_counts()
        t0 = time.perf_counter()
        results = router.run(greedy)
        wall8 = time.perf_counter() - t0
        got8 = counts()
    finally:
        for u in undo:
            u()
    want = {"flash_prefill": L * sum(flash_ok and -(-len(r.prompt_ids) // page) * page % 128 == 0
                                     for r in greedy),
            "paged_attend": 0, "bitpack": per_forward * (rec8["prefills"] + rec8["ticks"]) * on_card,
            "l2norm_sq": 0}
    want["bitunpack"] = want["bitpack"]
    check(got8 == want, f"(b): launches {got8}, expected {want}")
    pin(router, plan8, "(b) int8")
    hold_streams(torch, "(b) int8 fleet", {rid: r.tokens for rid, r in results.items()},
                 refs["int8"], greedy, setup4, plan8, what="phase 15 (b)'s paged int8 engine")
    say(f"   (b) int8: {len(greedy)} streams equal to phase 15 (b)'s paged int8 streams in "
        f"{wall8:.2f} s; launches {got8}")
    del router, replicas, workers
    check_seen_flash(seen_flash)
    flash_err = max((r["max_abs_err"] for r in seen_flash.values()), default=0.0)
    paged_err = check_seen_paged(seen_paged) if seen_paged else 0.0
    peak = max(peak_a, torch.cuda.max_memory_allocated() if on_card else 0)
    for label, r in (("(a)+(c)", rec), ("(b)", rec8)):
        say(f"   {label} ms: decode a replica tick {_ms(r['decode'])}; worker prefill (pad + "
            f"prefill + export + first id) {_ms(r['prefill'])}; parcel pack {_ms(r['pack'])}, "
            f"send {_ms(r['send'])}, install (unpack + admit_pages) "
            f"{_ms(r['install'])}; publish decode s {[round(x, 2) for x in r['publish_decode']]}")
    say(f"   phase 19: {time.perf_counter() - t_phase:.1f} s; memory peak {peak / 2**30:.2f} GiB")
    launches = {k: launched_a[k] + got8[k] for k in got8}
    return {"launches": launches, "flash_err": flash_err, "paged_err": paged_err,
            "parcel_bytes": p0.nbytes, "encode_s": enc, "ws": ws, "ok": True,
            "decode_s": rec["publish_decode"] + rec8["publish_decode"]}


# ---------------------------------------------------------------------------
# phase 20: the MoE family and the dense variants at their widths
# ---------------------------------------------------------------------------

ARCH_SLOTS = SERVE_SLOTS
# (b): the QKV biases of qwen2.5-14b drawn from a seed before the run (the
# reference initialises them to zeros, which would hide a missing or
# misplaced bias)
ARCH_BIAS_STD, ARCH_BIAS_SEED = 0.1, 20
# (d): mixtral-8x7b's layers in training (3.16 B parameters; masters,
# momentum and gradients ~38 GB) and the steps of the forced AWP plan
ARCH_TRAIN_LAYERS, ARCH_TRAIN_STEPS = 2, 5


def _set_biases(torch, storage, seed):
    """Draw every layer's ``bq`` / ``bk`` / ``bv`` from ``seed`` (normal,
    std ``ARCH_BIAS_STD``) in place (trivial mesh: storage is the stacked
    logical tensor)."""
    gen = torch.Generator(device=storage["embed"].device).manual_seed(seed)
    for g in storage["groups"]:
        for key in ("bq", "bk", "bv"):
            g["p0"]["attn"][key].normal_(0.0, ARCH_BIAS_STD, generator=gen)


def arch_serve(torch, device, cfg, *, paged=True, contiguous=True, lens=SERVE_LENS,
               gen=SERVE_GEN, page=PAGE, bias_seed=None, keep=False):
    """``cfg`` served through the serve twin's functions from seed 0's
    weights at ``round_to`` 2: the static reference (request by request for
    a MoE model, as the serve launcher runs it), then the contiguous engine
    and / or the paged engine at ``page``, every stream equal to the static
    one. Launches are zeroed before and read after each run: per prefill
    whose length (padded to whole pages in the paged engine, unless the
    model has experts) is a multiple of 128, one flash launch a layer (none
    under a sliding window, by the reference's rule); one ``paged_attend``
    a layer per paged decode step; Bitpack / Bitunpack once per ``DIST``
    leaf per materialization. The first flash launch at each shape and the
    first ``paged_attend`` launch at each shape, and every 8th decode
    step's first, are held to the plain versions on their own inputs.
    ``keep`` also returns the weights (``setup``: config, mesh, specs,
    storage). Returns the measurements; raises on a failed check."""
    from repro_torch.dist.spec import DIST
    from repro_torch.launch.serve import build_requests, check_wire, run_static, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.utils.trees import tree_leaves

    on_card = device.type == "cuda"
    L = cfg.num_layers
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    if bias_seed is not None:
        _set_biases(torch, storage, bias_seed)
    setup_s = time.perf_counter() - t0
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    requests = build_requests(lens, gen, cfg.vocab_size)
    cap = max(lens) + gen
    n_params = sum(x.numel() for x in tree_leaves(storage))
    per_forward = sum(s.reps for g in spec_tree["groups"] for s in tree_leaves(g)
                      if s.kind == DIST) + sum(
        1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST)

    def viable(S):  # the reference's flash rule for a prefill of S tokens
        return on_card and S % 128 == 0 and kernel_layers(cfg) > 0

    say(f"   {cfg.name} at {L} of its layers: {n_params:,} fp32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB), H {cfg.num_heads} / Kv {cfg.num_kv_heads} "
        f"(G {cfg.num_heads // cfg.num_kv_heads}), init {setup_s:.2f} s; {per_forward} DIST "
        f"materializations per forward")
    seen_f, seen_p, launches, runs = {}, [], {}, {}
    unwatch_f = watch_flash(torch, seen_f)
    unwatch_p = watch_paged(torch, seen_p, L * 8)
    zero_counts()
    t0 = time.perf_counter()
    static = run_static(cfg, mesh_cfg, None, spec_tree, storage, requests, plan, None)
    static_s = time.perf_counter() - t0
    launches["static"] = got = counts()
    check_seen_flash(seen_f)
    prefills = [len(r.prompt_ids) for r in requests] if cfg.num_experts else sorted(set(lens))
    want = {"flash_prefill": kernel_layers(cfg) * sum(map(viable, prefills)),
            "bitpack": per_forward * len(prefills) * gen * on_card,
            "paged_attend": 0, "l2norm_sq": 0}
    want["bitunpack"] = want["bitpack"]
    check(got == want, f"{cfg.name} static: launches {got}, expected {want}")
    say(f"   {cfg.name} static ({'request by request' if cfg.num_experts else 'grouped'}): "
        f"{len(prefills)} prefills in {static_s:.2f} s; launches {got}")

    for kind in [k for k, on in (("engine", contiguous), ("paged engine", paged)) if on]:
        timings = {"admit": [], "decode": []}
        zero_counts()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                             max_slots=ARCH_SLOTS, cache_capacity=cap,
                             paged=kind == "paged engine", page_size=page)
        instrument(engine, timings)
        results = engine.run(requests)
        wall = time.perf_counter() - t0
        launches[kind] = got = counts()
        check_seen_flash(seen_f)
        streams = {k: r.tokens for k, r in results.items()}
        bad = [r.rid for r in requests if streams[r.rid] != static[r.rid]]
        for rid in bad:
            report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, requests[rid],
                              streams[rid], static[rid])
        check(not bad, f"{cfg.name} {kind}: streams of {bad} differ from the static reference")
        summary = engine.wire_summary()
        analytic = check_wire(engine, plan, requests)
        # the paged engine pads the prompts of a dense model of attention blocks only
        pad = kind == "paged engine" and not cfg.num_experts and set(cfg.pattern) == {"attn"}
        admitted = [-(-S // page) * page if pad else S for S in (len(r.prompt_ids)
                                                                  for r in requests)]
        packed = (summary["admissions"] + summary["decode_steps"]) * per_forward * on_card
        want = {"flash_prefill": kernel_layers(cfg) * sum(map(viable, admitted)),
                "bitpack": packed, "bitunpack": packed, "l2norm_sq": 0,
                "paged_attend": (kernel_layers(cfg) * summary["decode_steps"] * on_card
                                 * (kind == "paged engine"))}
        check(got == want, f"{cfg.name} {kind}: launches {got}, expected {want}")
        if kind == "paged engine":
            check(summary["prefill_misses"] == len(set(admitted)),
                  f"{cfg.name}: {summary['prefill_misses']} prefill lengths first seen, "
                  f"expected {len(set(admitted))}")
        dec = sorted(timings["decode"])
        adm = sorted(t for _, t in timings["admit"])
        new_tokens = sum(len(s) for s in streams.values())
        say(f"   {cfg.name} {kind}: {summary['steps']} steps ({summary['decode_steps']} decode) "
            f"in {wall:.2f} s, {new_tokens / wall:.1f} tokens/s; decode ms/step median "
            f"{dec[len(dec) // 2] * 1e3:.2f}, admission ms median {adm[len(adm) // 2] * 1e3:.2f}; "
            f"streams equal to the static reference; host_device {summary['host_device']} B == "
            f"serve_host_device_bytes {analytic['total']} B; launches {got}")
        runs[kind] = {"decode_ms": dec[len(dec) // 2] * 1e3, "admit_ms": adm[len(adm) // 2] * 1e3,
                      "wall_s": wall, "tokens": new_tokens}
        del engine
    unwatch_f()
    unwatch_p()
    paged_err = check_seen_paged(seen_p) if paged else 0.0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say(f"   {cfg.name}: memory peak {peak / 2**30:.2f} GiB")
    total = {k: sum(run[k] for run in launches.values()) for k in launches["static"]}
    return {"launches": total, "runs": runs, "peak": peak, "static": static,
            "flash_err": max((r["max_abs_err"] for r in seen_f.values()), default=0.0),
            "paged_err": paged_err, "flash_shapes": sorted(seen_f),
            "requests": requests, "setup": (cfg, mesh_cfg, spec_tree, storage) if keep else None}


def arch_train(torch, device, cfg, *, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR,
               steps=ARCH_TRAIN_STEPS, env_overrides=()):
    """A²DTWP training of ``cfg`` from seed 0's weights through ``Trainer``
    and ``make_train_step`` at phase 11's batch, lr and forced AWP plan
    (widening every 2 steps; ``env_overrides`` the plan's, e.g. the
    chunkwise mLSTM), on ``synthetic_lm_batch`` (an input-stub arch's on
    ``synthetic_feature_batch``'s frames): losses finite, each step's MoE aux loss (the
    layers' sum, the ``StepRecord``'s ``aux``) positive (0 without
    experts), each
    ``StepRecord``'s wire bytes equal to the plan's table, and launches:
    Bitpack / Bitunpack once per ``DIST`` leaf per materialization below 32
    bits (the remat backward's included), ``l2norm_sq`` once per monitored
    leaf a step. Each step's first monitor call and the first packing
    launch at each (length, round_to) are held to the plain versions."""
    from repro_torch.data.pipeline import synthetic_feature_batch, synthetic_lm_batch
    from repro_torch.dist.spec import DIST, MeshCfg, dist_elems_per_group
    from repro_torch.kernels import ref
    from repro_torch.launch.train import setup
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.loop import Trainer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.trees import tree_leaves

    on_card = device.type == "cuda"
    mesh_cfg = MeshCfg()
    t0 = time.perf_counter()
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device)
    setup_s = time.perf_counter() - t0
    nrt = cfg.num_groups + 1
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)
    group_dist = [s for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST]
    top_dist = [k for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST]
    per_forward = sum(s.reps for s in group_dist) + len(top_dist)
    recomputed = sum(s.reps for s in group_dist) if cfg.remat else 0
    n_monitor = len(group_dist) + len(top_dist)
    n_params = sum(x.numel() for x in tree_leaves(storage))
    biggest = max(math.prod(s.logical) for s in group_dist)
    say(f"   {cfg.name} at {cfg.num_layers} of its layers: {n_params:,} fp32 parameters, init "
        f"{setup_s:.2f} s; per step {per_forward} + {recomputed} (remat) DIST "
        f"materializations, {n_monitor} monitor calls, the largest packed leaf {biggest:,} "
        f"elements; batch {batch} x seq {seq}, lr {lr:g}")
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    stub = cfg.embed_is_input_stub
    shapes = {"features": (batch, seq, cfg.vision_dim)} if stub else {"tokens": (batch, seq)}
    shapes["labels"] = (batch, seq)
    plan = PrecisionPlan.build(nrt, round_to=4, schedule="awp", awp_threshold=1.0,
                               awp_interval=2, env_overrides=dict(env_overrides))

    def builder(rts):
        return make_train_step(cfg, mesh_cfg, None, spec_tree, opt, shapes,
                               plan=plan.with_round_tos(rts))

    trainer = Trainer(builder, nrt, plan=plan, dist_elems_per_group=elems)
    seen, packs, errs, peaks = [], {}, [], []
    unwatch = watch_monitor(torch, seen, n_monitor)
    unwatch_packing = watch_packing(torch, packs)
    zero_counts()
    try:
        for i in range(steps):
            if stub:
                x, labels = synthetic_feature_batch(cfg.vision_dim, cfg.vocab_size, batch, seq, i,
                                                    device=device)
            else:
                x, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, i, device=device)
            n_packs = len(packs)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            storage, mom, _ = trainer.run_step(
                storage, mom, {"features" if stub else "tokens": x, "labels": labels}, lr)
            if on_card and len(packs) == n_packs:
                peaks.append(torch.cuda.max_memory_allocated())
            for w, out in seen:
                p, k = float(ref.l2norm_sq_ref(w)), float(out)
                check(abs(k - p) <= L2_RTOL * abs(p), f"{cfg.name} step {i}: monitor call: "
                                                      f"kernel {k!r}, plain {p!r}")
                errs.append(abs(k - p))
            seen.clear()
            check_seen_packing(torch, packs)
    finally:
        unwatch()
        unwatch_packing()
    got = counts()
    records = trainer.records
    losses = [r.loss for r in records]
    aux_steps = [r.aux for r in records]
    check(all(math.isfinite(x) for x in losses), f"{cfg.name}: non-finite loss in {losses}")
    check(all(math.isfinite(a) and (a > 0) == bool(cfg.num_experts) for a in aux_steps),
          f"{cfg.name}: aux {aux_steps}")
    for r in records:
        want = plan.with_round_tos(r.round_tos).wire_table(elems, 1)["total"]
        check(r.wire_bytes == want, f"{cfg.name} step {r.step}: wire {r.wire_bytes} != plan "
                                    f"{want}")
    packed = sum(r.round_tos[0] < 4 for r in records) * (per_forward + recomputed) * on_card
    want = {"bitpack": packed, "bitunpack": packed, "flash_prefill": 0, "paged_attend": 0,
            "l2norm_sq": n_monitor * len(records) * on_card}
    check(got == want, f"{cfg.name} training: launches {got}, expected {want}")
    if on_card:
        check(len(errs) == len(records), f"{len(errs)} monitor calls held, {len(records)} steps")
    for r, aux in zip(records, aux_steps):
        say(f"   step {r.step} round_to {r.round_tos[0]} loss {r.loss:.5f} aux {aux:.5f} wire "
            f"{r.wire_bytes} B  {r.wall_s * 1e3:.1f} ms"
            f"{'  (first at these formats)' if r.recompiled else ''}")
    warm = sorted(r.wall_s for r in records if not r.recompiled)
    peak = max(peaks, default=0)
    say(f"   {cfg.name} training: launches {got}; monitor within {max(errs, default=0.0):.3e} "
        f"of its plain version; packing equal to its plain versions at {len(packs)} (kernel, "
        f"length, round_to); step ms median of warm steps "
        f"{warm[len(warm) // 2] * 1e3 if warm else float('nan'):.2f}; memory peak of the "
        f"{len(peaks)} steps with no packing copy {peak / 2**30:.2f} GiB")
    return {"launches": got, "losses": losses, "aux": aux_steps, "peak": peak,
            "monitor_err": max(errs, default=0.0),
            "round_tos": [r.round_tos[0] for r in records],
            "step_s": [r.wall_s for r in records],
            "step_ms": warm[len(warm) // 2] * 1e3 if warm else None}


def archs_path(torch, device, *, a_cfg=None, b_cfg=None, c_cfg=None, d_cfg=None, lens=SERVE_LENS,
               gen=SERVE_GEN, page=PAGE):
    """Phase 20: (a) chatglm3-6b at full depth (static, engine, paged
    engine; G 16), (b) qwen2.5-14b at ``CUT_LAYERS`` with seeded QKV biases
    (static, paged engine; G 5), (c) mixtral-8x7b at ``CUT_LAYERS`` (the
    per-request static run and the contiguous windowed engine), (d)
    mixtral-8x7b at ``ARCH_TRAIN_LAYERS`` in A²DTWP training. The configs
    default to the registry's at those depths (widths not cut). Returns the
    launches summed over the phase and the measurements."""
    from repro_torch.configs.registry import get_config

    def cut(name, layers):
        return dataclasses.replace(get_config(name), num_layers=layers)

    a_cfg = a_cfg or get_config("chatglm3-6b")
    b_cfg = b_cfg or cut("qwen2.5-14b", CUT_LAYERS)
    c_cfg = c_cfg or cut("mixtral-8x7b", CUT_LAYERS)
    d_cfg = d_cfg or cut("mixtral-8x7b", ARCH_TRAIN_LAYERS)
    on_card = device.type == "cuda"
    out, clock = {}, {}

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    for label, fn in (
        ("a", lambda: arch_serve(torch, device, a_cfg, lens=lens, gen=gen, page=page)),
        ("b", lambda: arch_serve(torch, device, b_cfg, contiguous=False, lens=lens, gen=gen,
                                 page=page, bias_seed=ARCH_BIAS_SEED)),
        ("c", lambda: arch_serve(torch, device, c_cfg, paged=False, lens=lens, gen=gen)),
        ("d", lambda: arch_train(torch, device, d_cfg)),
    ):
        free()
        t0 = time.perf_counter()
        say(f"   ({label})")
        out[label] = fn()
        clock[label] = time.perf_counter() - t0
    free()
    launches = {k: sum(out[x]["launches"][k] for x in out) for k in out["a"]["launches"]}
    say(f"   phase 20 launches {launches}; seconds (a) {clock['a']:.1f}, (b) {clock['b']:.1f}, "
        f"(c) {clock['c']:.1f}, (d) {clock['d']:.1f}; peaks (a) "
        f"{out['a']['peak'] / 2**30:.2f}, (b) {out['b']['peak'] / 2**30:.2f}, (c) "
        f"{out['c']['peak'] / 2**30:.2f}, (d) {out['d']['peak'] / 2**30:.2f} GiB")
    return {"launches": launches, "seconds": clock, **out,
            "flash_err": max(out[x]["flash_err"] for x in "abc"),
            "paged_err": max(out[x]["paged_err"] for x in "abc"),
            "monitor_err": out["d"]["monitor_err"]}


# ---------------------------------------------------------------------------
# phase 21: the recurrent families — xlstm-1.3b and recurrentgemma-9b
# ---------------------------------------------------------------------------

# (a) and (c): prompts shorter than phase 7's (a recurrent prefill runs its
# layers' steps one token at a time: ~20 launches a token in each sLSTM)
REC_LENS, REC_GEN = (128, 96, 64), 16
# (a): the chunkwise mLSTM's chunk (the plan's env override); its first
# logits within this share of the largest |logit| of the sequential
# form's (the CPU saw 6.6e-7 at reduced width and 1.3e-6 at d 2048, 2
# layers; 48 layers sum more steps in another order), and its greedy stream
# may leave the sequential one only where the latter's top-2 logit gap
# there is below the same share of its largest |logit|
REC_CHUNK, REC_CHUNK_RTOL = 64, 1e-4
# (b): A²DTWP steps at batch 4 x phase 11's sequence, the chunkwise mLSTM,
# at a quarter of the depth (the script's time: a step at 48 layers took
# 8.8-14.6 s, the sLSTM's per-token autograd)
REC_TRAIN_STEPS, REC_TRAIN_BATCH, REC_TRAIN_LAYERS = 5, 4, 12
# (c): recurrentgemma-9b's smallest cut: one whole pattern, 19 of 38 layers
RG_LAYERS = 19
# (d): xlstm-1.3b's depth on the 1×2 mesh
REC_MESH_LAYERS = 4


def chunkwise_check(torch, device, cfg, setup4, req, seq_stream, chunk=REC_CHUNK):
    """(a)'s chunkwise mLSTM on one prompt against the sequential form at
    ``round_to`` 2: the prefill's last-token logits within
    ``REC_CHUNK_RTOL`` of the largest |logit|, and the greedy stream (a
    static run of the request alone) equal to ``seq_stream`` or parting
    only where a batch-1 sequential decode's top-2 gap is below the same
    bar. Prints both prefills' seconds. Returns the numbers."""
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import generate_static
    from repro_torch.serve.step import make_prefill_step

    _, mesh_cfg, spec_tree, storage = setup4
    nrt = cfg.num_groups + 1
    plans = {"sequential": PrecisionPlan.build(nrt, round_to=2),
             "chunkwise": PrecisionPlan.build(nrt, round_to=2,
                                              env_overrides={"mlstm_chunk": chunk})}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    tokens = torch.tensor([req.prompt_ids], dtype=torch.int32, device=device)
    logits, secs = {}, {}
    for name, plan in plans.items():
        pre = make_prefill_step(cfg, mesh_cfg, None, spec_tree, plan=plan,
                                cache_capacity=len(req.prompt_ids) + req.max_new)
        sync()
        t0 = time.perf_counter()
        logits[name] = pre(storage, {"tokens": tokens})[0][0, -1, :cfg.vocab_size].float()
        sync()
        secs[name] = time.perf_counter() - t0
    scale = float(logits["sequential"].abs().max())
    gap = float((logits["chunkwise"] - logits["sequential"]).abs().max())
    check(gap <= REC_CHUNK_RTOL * scale, f"(a) chunkwise: first logits {gap:.3e} from the "
                                         f"sequential form's (bound {REC_CHUNK_RTOL} x {scale:.3f})")
    stream = generate_static(cfg, mesh_cfg, None, spec_tree, storage, [req],
                             plan=plans["chunkwise"])[req.rid]
    t = diverged_at(stream, seq_stream)
    line = (f"   (a) chunkwise mLSTM (chunk {chunk}) on the {len(req.prompt_ids)}-token prompt: "
            f"first logits max |chunkwise - sequential| {gap:.3e} ({gap / scale:.3e} of the "
            f"largest |logit| {scale:.3f}); prefill {secs['chunkwise'] * 1e3:.1f} ms against "
            f"{secs['sequential'] * 1e3:.1f} ms sequential (host clock, warm)")
    if t is None:
        say(line + "; greedy stream equal")
        return {"gap": gap, "scale": scale, "secs": secs, "parted": None}
    _, gaps = top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plans["sequential"], req)
    say(line + f"; greedy stream parts at token {t} where the sequential top-2 gap is "
               f"{gaps[t]:.3e}")
    check(gaps[t] <= REC_CHUNK_RTOL * scale, f"(a) chunkwise: stream left the sequential one "
                                             f"at token {t}, top-2 gap {gaps[t]:.3e}")
    return {"gap": gap, "scale": scale, "secs": secs, "parted": (t, gaps[t])}


def recurrent_path(torch, device, *, a_cfg=None, b_cfg=None, c_cfg=None, d_cfg=None,
                   lens=REC_LENS, gen=REC_GEN, chunk=REC_CHUNK, steps=REC_TRAIN_STEPS,
                   batch=REC_TRAIN_BATCH, seq=LM_SEQ):
    """Phase 21: (a) xlstm-1.3b at its widths and depth served (static, the
    2-slot contiguous engine; streams equal) and one prompt's prefill in
    the chunkwise form (``chunkwise_check``); (b) xlstm-1.3b at ``REC_TRAIN_LAYERS``
    in A²DTWP training (``arch_train``) with the plan's ``mlstm_chunk``; (c)
    recurrentgemma-9b at ``RG_LAYERS`` (static and engine, streams equal;
    the ``local`` blocks' rings at the engine's capacity); (d) xlstm-1.3b
    at ``REC_MESH_LAYERS`` on a 1×2 mesh of gloo ranks (phase 14's rank
    function: static and engine equal, wire per forward equal to
    ``serve_wire_table``), held to one device's static streams at that
    depth. The configs default to the registry's at those depths. Returns
    the launches summed over the phase and the measurements."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.serve import build_requests

    def cut(name, layers):
        return dataclasses.replace(get_config(name), num_layers=layers)

    a_cfg = a_cfg or get_config("xlstm-1.3b")
    b_cfg = b_cfg or cut("xlstm-1.3b", REC_TRAIN_LAYERS)
    c_cfg = c_cfg or cut("recurrentgemma-9b", RG_LAYERS)
    d_cfg = d_cfg or cut("xlstm-1.3b", REC_MESH_LAYERS)
    on_card = device.type == "cuda"
    out, clock = {}, {}

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def a():
        res = arch_serve(torch, device, a_cfg, paged=False, lens=lens, gen=gen, keep=True)
        req = res["requests"][0]
        zero_counts()
        res["chunk"] = chunkwise_check(torch, device, a_cfg, res.pop("setup"), req,
                                       res["static"][req.rid], chunk)
        res["launches"] = {k: v + counts()[k] for k, v in res["launches"].items()}
        return res

    def d():
        requests = build_requests(lens, gen, d_cfg.vocab_size)
        one = arch_serve(torch, device, d_cfg, paged=False, contiguous=False, lens=lens, gen=gen)
        free()
        runs = ({"label": "static"}, {"label": "engine", "engine": {}, "against": "static"})
        t0 = time.perf_counter()
        ranks = spawn_ranks(_tp_serve_rank, TPS_TP, str(device), d_cfg, 1, requests, runs,
                            False, threads=2 if on_card else 1, timeout_s=900)
        r0 = ranks[0]["runs"]
        for r, o in enumerate(ranks):
            for label in r0:
                check(o["runs"][label]["streams"] == r0[label]["streams"],
                      f"(d): rank {r}'s {label} streams differ from rank 0's")
        check(r0["engine"]["streams"] == r0["static"]["streams"],
              "(d): the 1×2 engine's streams differ from the 1×2 static run's")
        check(r0["static"]["streams"] == one["static"], "(d): the 1×2 streams differ from one "
                                                        "device's at the same depth")
        dec = sorted(r0["engine"]["decode_ms"])
        say(f"   (d) 1×{TPS_TP} ({time.perf_counter() - t0:.1f} s): engine == static == one "
            f"device's static streams, both ranks equal; wire per forward == serve_wire_table "
            f"({r0['engine']['wire_by_forward']}); engine decode ms/step median "
            f"{dec[len(dec) // 2]:.2f}; memory peak per rank "
            f"{[round(o['runs']['engine']['peak'] / 2**30, 2) for o in ranks]} GiB")
        launches = {k: one["launches"][k] + sum(o["runs"][label]["launches"][k] for o in ranks
                                                for label in o["runs"])
                    for k in one["launches"]}
        return {"launches": launches, "ranks": ranks, "one": one, "peak": one["peak"]}

    for label, fn in (
        ("a", a),
        ("b", lambda: arch_train(torch, device, b_cfg, steps=steps, batch=batch, seq=seq,
                                 env_overrides={"mlstm_chunk": chunk})),
        ("c", lambda: arch_serve(torch, device, c_cfg, paged=False, lens=lens, gen=gen)),
        ("d", d),
    ):
        free()
        t0 = time.perf_counter()
        say(f"   ({label})")
        out[label] = fn()
        clock[label] = time.perf_counter() - t0
        say(f"   ({label}) took {clock[label]:.1f} s")
    free()
    launches = {k: sum(out[x]["launches"][k] for x in out) for k in out["a"]["launches"]}
    say(f"   phase 21 launches {launches}; seconds (a) {clock['a']:.1f}, (b) {clock['b']:.1f}, "
        f"(c) {clock['c']:.1f}, (d) {clock['d']:.1f}; peaks (a) "
        f"{out['a']['peak'] / 2**30:.2f}, (b) {out['b']['peak'] / 2**30:.2f}, (c) "
        f"{out['c']['peak'] / 2**30:.2f} GiB")
    return {"launches": launches, "seconds": clock, **out,
            "monitor_err": out["b"]["monitor_err"]}

# ---------------------------------------------------------------------------
# phase 22: vision cross-attention (llama-3.2-vision-90b) and the audio encoder
# (hubert-xlarge)
# ---------------------------------------------------------------------------

# (a): llama-3.2-vision-90b's smallest cut, one whole (attn x 4, cross)
# pattern: 5 of its 100 layers (5,685,460,993 parameters, 22.74 GB fp32);
# 4 layers leave no precision group
VLM_LAYERS = 5
# (a): the cross gates drawn from this seed, uniform in (0.5, 1.0): the
# reference initialises them to zero, and tanh(0) = 0 makes a cross block
# add nothing, so a broken cross path would pass
VLM_GATE_SEED = 22
# (a): one decode step's logits against a fresh prefill of the same tokens,
# and requests 0 and 1 (one prompt, two images) apart by more than it:
# this share of the largest |logit|
VLM_DECODE_RTOL = 1e-4
# (b): hubert-xlarge at its 48 layers, A²DTWP steps at batch 4 x 512 frames
AUDIO_STEPS, AUDIO_BATCH, AUDIO_SEQ = 5, 4, 512


def _set_gates(torch, storage, seed):
    """Draw every cross block's gate from ``seed`` (uniform in (0.5, 1.0))
    in place (trivial mesh: storage is the stacked logical tensor)."""
    gen = torch.Generator(device=storage["embed"].device).manual_seed(seed)
    for g in storage["groups"]:
        for blk in g.values():
            gate = blk["attn"].get("gate")
            if gate is not None:
                gate.uniform_(0.5, 1.0, generator=gen)


def watch_static_steps(torch, rec):
    """Route ``generate_static``'s prefill and decode steps through
    recorders: every logit they return must be finite; each prefill's
    host-clocked seconds (synced) by prompt length and its logits, each
    decode step's seconds and the first decode step's logits of each
    group are kept in ``rec``. Returns the undo function."""
    from repro_torch.serve import engine

    make_pre, make_dec = engine.make_prefill_step, engine.make_decode_step
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def timed(step, kind):
        def run(*args):
            sync()
            t0 = time.perf_counter()
            logits, caches = step(*args)
            sync()
            secs = time.perf_counter() - t0
            check(bool(torch.isfinite(logits).all()), f"non-finite logits in a {kind} step")
            batch = args[-1]
            if kind == "prefill":
                S = batch["tokens"].shape[1]
                rec["prefill"].append((S, secs))
                rec["prefill_logits"][S] = logits[:, -1].float().clone()
                rec["pending"] = S
            else:
                rec["decode"].append(secs)
                if rec.get("pending") is not None:
                    rec["decode_logits"][rec.pop("pending")] = logits[:, -1].float().clone()
            return logits, caches
        return run

    engine.make_prefill_step = lambda *a, **k: timed(make_pre(*a, **k), "prefill")
    engine.make_decode_step = lambda *a, **k: timed(make_dec(*a, **k), "decode")

    def undo():
        engine.make_prefill_step, engine.make_decode_step = make_pre, make_dec
    return undo


def vlm_serve(torch, device, cfg, *, lens=SERVE_LENS, gen=SERVE_GEN):
    """(a): ``cfg`` (llama-3.2-vision-90b) from seed 0's weights, the cross
    gates from ``VLM_GATE_SEED``, served through the serve launcher's
    functions at ``round_to`` 2 on the static path (the engine refuses
    image requests): phase 7's requests, request 1's prompt made request
    0's, each with ``(num_image_tokens, vision_dim)`` image features from
    the launcher's draw. Checks: every logit finite; requests 0 and 1's
    first logits apart by more than ``VLM_DECODE_RTOL`` of the largest
    |logit| (the cross path is live); request 0's first decode step within
    that of a fresh prefill of its prompt and first token; launches: one
    flash launch a self-attention layer per prefill of a multiple of 128
    (the cross blocks never take it), Bitpack / Bitunpack once per ``DIST``
    leaf per forward (``img_proj`` in a prefill only: decode reads the
    cached image KV); the first flash launch at each shape held to the
    plain version. Returns the measurements."""
    from repro_torch.dist.spec import DIST
    from repro_torch.launch.serve import build_requests, image_features_for, run_static, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.utils.trees import tree_leaves

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    _set_gates(torch, storage, VLM_GATE_SEED)
    setup_s = time.perf_counter() - t0
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    requests = build_requests(lens, gen, cfg.vocab_size)
    requests[1] = dataclasses.replace(requests[1], prompt_ids=requests[0].prompt_ids)
    feats = image_features_for(cfg, requests)
    requests = [dataclasses.replace(r, image_features=feats[r.rid]) for r in requests]
    n_params = sum(x.numel() for x in tree_leaves(storage))
    per_forward = sum(s.reps for g in spec_tree["groups"] for s in tree_leaves(g)
                      if s.kind == DIST) + sum(
        1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST)
    say(f"   {cfg.name} at {cfg.num_layers} of its layers: {n_params:,} fp32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB), H {cfg.num_heads} / Kv {cfg.num_kv_heads} (G "
        f"{cfg.num_heads // cfg.num_kv_heads}), {cfg.num_image_tokens} image tokens of width "
        f"{cfg.vision_dim} a request, init {setup_s:.2f} s; {per_forward} DIST materializations "
        f"per forward")
    seen_f, rec = {}, {"prefill": [], "decode": [], "prefill_logits": {}, "decode_logits": {}}
    unwatch_f = watch_flash(torch, seen_f)
    unwatch_s = watch_static_steps(torch, rec)
    zero_counts()
    try:
        t0 = time.perf_counter()
        static = run_static(cfg, mesh_cfg, None, spec_tree, storage, requests, plan, None)
        static_s = time.perf_counter() - t0
        launches = counts()
        check_seen_flash(seen_f)
    finally:
        unwatch_s()
    prefills = sorted(set(lens))
    # a decode step reads the cross blocks' cached image KV: no img_proj
    per_decode = per_forward - (spec_tree["img_proj"].kind == DIST)
    want = {"flash_prefill": kernel_layers(cfg) * sum(on_card and S % 128 == 0 for S in prefills),
            "bitpack": len(prefills) * (per_forward + (gen - 1) * per_decode) * on_card,
            "paged_attend": 0, "l2norm_sq": 0}
    want["bitunpack"] = want["bitpack"]
    check(launches == want, f"{cfg.name} static: launches {launches}, expected {want}")
    S0 = len(requests[0].prompt_ids)
    first = rec["prefill_logits"][S0]  # the group of requests 0 and 1, in request order
    scale = float(first[0].abs().max())
    apart = float((first[0] - first[1]).abs().max())
    check(apart > VLM_DECODE_RTOL * scale, f"{cfg.name}: requests 0 and 1 (one prompt, two "
                                           f"images) have first logits {apart:.3e} apart, at "
                                           f"most {VLM_DECODE_RTOL} x {scale:.3f}")
    # request 0's first decode step against a fresh prefill of its prompt and
    # first token (not a multiple of 128: attend_tiled, no flash launch)
    zero_counts()
    tokens = torch.tensor([requests[0].prompt_ids + (static[0][0],)], dtype=torch.int32,
                          device=device)
    img = torch.from_numpy(feats[0][None]).to(device)
    fresh = make_prefill_step(cfg, mesh_cfg, None, spec_tree, plan=plan,
                              cache_capacity=S0 + 1)(storage, {"tokens": tokens,
                                                               "image_features": img})[0]
    fresh = fresh[0, -1].float()
    extra = counts()
    unwatch_f()
    check(extra == {"flash_prefill": 0, "bitpack": per_forward * on_card,
                    "bitunpack": per_forward * on_card, "paged_attend": 0, "l2norm_sq": 0},
          f"{cfg.name} fresh prefill: launches {extra}")
    for k in launches:
        launches[k] += extra[k]
    dscale = float(fresh.abs().max())
    dgap = float((rec["decode_logits"][S0][0] - fresh).abs().max())
    check(dgap <= VLM_DECODE_RTOL * dscale, f"{cfg.name}: decode step {dgap:.3e} from a fresh "
                                            f"prefill (bound {VLM_DECODE_RTOL} x {dscale:.3f})")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    admit = {S: round(t * 1e3, 2) for S, t in rec["prefill"]}
    dec = sorted(rec["decode"])
    say(f"   {cfg.name} static: {len(prefills)} prefills, {len(rec['decode'])} decode steps in "
        f"{static_s:.2f} s; admission ms by prompt length {admit}; decode ms/step median "
        f"{dec[len(dec) // 2] * 1e3:.2f}; launches {launches}")
    say(f"   requests 0 and 1 (one prompt, two images): first logits {apart:.3e} apart (largest "
        f"|logit| {scale:.3f}); request 0's first decode step {dgap:.3e} from a fresh prefill "
        f"(largest |logit| {dscale:.3f}); every logit finite; streams {[static[r.rid][:4] for r in requests]}")
    say(f"   {cfg.name}: memory peak {peak / 2**30:.2f} GiB")
    return {"launches": launches, "peak": peak, "static": static, "admit_ms": admit,
            "decode_ms": dec[len(dec) // 2] * 1e3, "apart": apart, "decode_gap": dgap,
            "scale": scale, "flash_err": max((r["max_abs_err"] for r in seen_f.values()),
                                             default=0.0), "flash_shapes": sorted(seen_f)}


def vision_path(torch, device, *, a_cfg=None, b_cfg=None, lens=SERVE_LENS, gen=SERVE_GEN,
                steps=AUDIO_STEPS, batch=AUDIO_BATCH, seq=AUDIO_SEQ):
    """Phase 22: (a) llama-3.2-vision-90b at ``VLM_LAYERS`` served on the
    static path (:func:`vlm_serve`); (b) hubert-xlarge at its 48 layers in
    A²DTWP training on ``synthetic_feature_batch``'s frames
    (:func:`arch_train`, the AWP monitor on ``l2norm_sq``): finite losses.
    The configs default to the registry's at those depths (widths not
    cut). Returns the launches summed over the phase and the
    measurements."""
    from repro_torch.configs.registry import get_config

    a_cfg = a_cfg or dataclasses.replace(get_config("llama-3.2-vision-90b"),
                                         num_layers=VLM_LAYERS)
    b_cfg = b_cfg or get_config("hubert-xlarge")
    on_card = device.type == "cuda"
    out, clock = {}, {}
    for label, fn in (
        ("a", lambda: vlm_serve(torch, device, a_cfg, lens=lens, gen=gen)),
        ("b", lambda: arch_train(torch, device, b_cfg, steps=steps, batch=batch, seq=seq)),
    ):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        say(f"   ({label})")
        out[label] = fn()
        clock[label] = time.perf_counter() - t0
        say(f"   ({label}) took {clock[label]:.1f} s")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    b = out["b"]
    say(f"   (b) {b_cfg.name} losses {[round(x, 5) for x in b['losses']]} (ln {b_cfg.vocab_size} = "
        f"{math.log(b_cfg.vocab_size):.3f}), formats {b['round_tos']}, step s "
        f"{[round(x, 3) for x in b['step_s']]}, memory peak {b['peak'] / 2**30:.2f} GiB")
    launches = {k: out["a"]["launches"][k] + b["launches"][k] for k in out["a"]["launches"]}
    say(f"   phase 22 launches {launches}; seconds (a) {clock['a']:.1f}, (b) {clock['b']:.1f}; "
        f"peaks (a) {out['a']['peak'] / 2**30:.2f}, (b) {b['peak'] / 2**30:.2f} GiB")
    return {"launches": launches, "seconds": clock, **out, "flash_err": out["a"]["flash_err"],
            "monitor_err": b["monitor_err"]}


# ---------------------------------------------------------------------------
# phase 23: accounting and tooling — the collective path's rates, --chunks
# auto, the draft's wire at tp 2, the first MFU
# ---------------------------------------------------------------------------

ACCT_SIZES = (1 << 10, 64 << 20)  # u8 bytes a rank: the latency, then the rate
ACCT_REPS = (30, 5)
ACCT_CHUNKS = (1, 2, 4)
ACCT_GATHER_REPS = 2
ACCT_STEPS = 2
ACCT_LENS, ACCT_GEN = (128, 64), 6


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _gloo_rank(rank, device_name, s_loc, round_to):
    """One of phase 23 (a)'s two ranks: host-clock medians of u8
    ``comm.all_gather`` at ``ACCT_SIZES`` bytes a rank, then of one
    chunked weight gather (``transport.all_gather`` of an ``s_loc`` fp32
    shard at ``round_to``) per chunk count of ``ACCT_CHUNKS``, each call
    between a barrier and a device sync."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import comm
    from repro_torch.transport import CompressionPolicy
    from repro_torch.transport import transport as T

    device = torch.device(device_name)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device)
    gen.manual_seed(23 + rank)

    def timed(fn, reps, warm=2):
        out = []
        for i in range(warm + reps):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            if i >= warm:
                out.append(time.perf_counter() - t0)
        return out

    res = {"all_gather": {}, "chunks": {}}
    for size, reps in zip(ACCT_SIZES, ACCT_REPS):
        x = torch.randint(0, 256, (size,), dtype=torch.uint8, device=device, generator=gen)
        res["all_gather"][size] = timed(lambda: comm.all_gather(x, traffic="weights"), reps)
        del x
    w = torch.randn(s_loc, device=device, generator=gen)
    with torch.no_grad():
        for c in ACCT_CHUNKS:
            pol = CompressionPolicy(round_to=round_to, chunks=c)
            res["chunks"][c] = timed(lambda: T.all_gather(w, None, pol, 0), ACCT_GATHER_REPS,
                                     warm=1)
    comm.clear_log()
    return res


def _pair_rank(rank, device_name, s_loc, round_to, cfg, lens, gen, spec_k):
    """One of the two ranks of phase 23 (a) then (c), in one process each."""
    return {"a": _gloo_rank(rank, device_name, s_loc, round_to),
            "c": _spec_wire_rank(rank, device_name, cfg, lens, gen, spec_k)}


def _auto_rank(rank, device_name, argv, cfg):
    """One rank of phase 23 (b): the training launcher's rank loop
    (``launch.train._train``) on its parsed flags at ``cfg``'s depth, with
    the kernels' launch counts zeroed before and read after."""
    from repro_torch.launch import train as T

    zero_counts()
    out = T._train(rank, T.build_parser().parse_args(argv), None, cfg)
    out["launches"] = counts()
    return out


def _spec_wire_rank(rank, device_name, cfg, lens, gen, spec_k):
    """One rank of phase 23 (c) (a 1×2 mesh): the speculative engine with the
    tiny draft; every wire_log entry against its table, the summary against
    the tables and against ``comm.LOG`` over the run."""
    import torch

    from repro_torch import fp32_math
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.launch.serve import build_requests, check_wire, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.spec import build_draft
    from repro_torch.train.step import COLLECTIVE_CLASSES

    fp32_math()
    device = torch.device(device_name)
    mesh_cfg = MeshCfg(tp=TPS_TP)
    mesh = make_mesh_from_cfg(mesh_cfg)
    _, spec_tree, storage = setup(cfg, seed=0, device=device, mesh_cfg=mesh_cfg, rank=rank)
    draft = build_draft(cfg, mesh_cfg, "tiny", seed=1, device=device)
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    requests = build_requests(lens, gen, cfg.vocab_size)
    zero_counts()
    first = len(comm.LOG)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, mesh_cfg, mesh, spec_tree, storage, plan=plan,
                      max_slots=SERVE_SLOTS, cache_capacity=max(lens) + gen, draft=draft,
                      spec_k=spec_k)
    streams = {k: r.tokens for k, r in eng.run(requests).items()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    summary = eng.wire_summary()
    check_wire(eng, plan, requests)
    tables = eng.wire_tables()
    for r, t in zip(eng.wire_log, tables, strict=True):
        for k in COLLECTIVE_CLASSES:
            check(r["wire"].get(k, 0) == t[k], f"rank {rank} (c) step {r['step']} {r['kind']}: "
                  f"measured {k} {r['wire'].get(k, 0)} B != serve_wire_table {t[k]} B")
    priced = {k: sum(t[k] for t in tables) for k in COLLECTIVE_CLASSES}
    logged = comm.wire_by_traffic(comm.LOG[first:])
    kinds = {}
    for r in eng.wire_log:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return {"streams": streams, "wire": summary["wire"], "priced": priced, "logged": logged,
            "kinds": kinds, "rounds": summary["spec_rounds"],
            "acceptance": summary["acceptance_rate"], "launches": counts(), "wall_s": wall_s}


def mfu_line(torch, cfg, batch, seq, step_s):
    """``(model_flops, counted_flops, mfu)`` of one fp32 A²DTWP step of
    ``cfg`` at ``batch`` x ``seq`` on one device taking ``step_s``:
    ``model_flops_estimate`` (6·N·D) over the step time and the fp32 peak,
    beside ``count_flops`` of the same step run on fake tensors (the remat
    backward's forward again included; nothing is allocated; the
    optimizer's update counts no FLOPs, so its settings do not matter)."""
    from repro_torch.audit.cases import build_case
    from repro_torch.audit.record import recording
    from repro_torch.configs.base import InputShape
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import PEAK_FLOPS_FP32, model_flops_estimate
    from repro_torch.roofline.cost import count_flops

    model = model_flops_estimate(cfg, InputShape("phase 11", seq, batch, "train"), 1)
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    with recording(MeshCfg()) as rec:
        case = build_case(cfg.name, "train", MeshCfg(), plan, mesh=rec.mesh, cfg=cfg,
                          seq_len=seq, global_batch=batch)
        counted = count_flops(case.step, *case.args)
    return model, counted, model / step_s / PEAK_FLOPS_FP32


def accounting_path(torch, device, *, cfg=None, steps=ACCT_STEPS, lens=ACCT_LENS, gen=ACCT_GEN,
                    spec_k=FEAT_SPEC_K, round_to=2):
    """Phase 23: (a) the gloo rates behind ``LINK_BW`` and
    ``COLLECTIVE_LATENCY`` and a chunked weight gather of qwen3-1.7b's
    largest ``DIST`` leaf at chunks 1, 2, 4 (two ranks on the card, which
    then run (c)); (b)
    the training launcher at 2×2 with ``--chunks auto`` at ``cfg``'s depth
    for ``steps`` steps: its count equal to ``pick_chunks``, the weights'
    wire equal to ``step_wire_table``, Bitpack, Bitunpack and ``l2norm_sq``
    launched; (c) the speculative engine with the tiny draft at 1×2: the
    wire summary equal to the tables' sum and to ``comm.LOG``, the draft's
    entries in both. Returns the measurements; raises on a failed check.
    Rehearses on the CPU at a reduced config (launches read on a card
    only)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.spec import MeshCfg, build_spec_tree
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import auto_chunks
    from repro_torch.models.init import param_shapes
    from repro_torch.plan import pick_chunks, sweep_chunks
    from repro_torch.roofline import analysis as A
    from repro_torch.transport.policy import ring_wire_bytes

    def chunks_at(cfg, mesh_cfg):  # (--chunks auto's count, its shard) under the constants
        shapes, metas = param_shapes(cfg, tp=mesh_cfg.tp)
        return auto_chunks(build_spec_tree(shapes, metas, mesh_cfg), mesh_cfg, round_to)

    on_card = device.type == "cuda"
    cfg = cfg or dataclasses.replace(get_config("qwen3-1.7b"), num_layers=CUT_LAYERS)
    full = dataclasses.replace(cfg, num_layers=get_config(cfg.name).num_layers)
    threads = 1 if not on_card else max(1, (os.cpu_count() or 1) // 4)
    out = {"launches": {k: 0 for k in counts()}}

    # (a) two ranks: the u8 all-gather's latency and rate, and a chunked
    # gather; then (c) in the same two processes
    t0 = time.perf_counter()
    _, s_loc = chunks_at(full, MeshCfg(dp=2))
    pair = spawn_ranks(_pair_rank, TPS_TP, str(device), s_loc, round_to, cfg, lens, gen, spec_k,
                       threads=max(1, threads * 2))
    ranks = [o["a"] for o in pair]
    lat = _median([t for r in ranks for t in r["all_gather"][ACCT_SIZES[0]]])
    big = _median([t for r in ranks for t in r["all_gather"][ACCT_SIZES[1]]])
    wire = ring_wire_bytes("all-gather", 2 * ACCT_SIZES[1], 2)
    rate = wire / max(big - lat, 1e-9)
    measured = {c: _median([t for r in ranks for t in r["chunks"][c]]) for c in ACCT_CHUNKS}
    best = min(measured, key=measured.get)
    hw_run = dict(link_bw=rate, latency=lat)
    picked = pick_chunks(s_loc, 2, round_to, candidates=ACCT_CHUNKS)
    picked_run = pick_chunks(s_loc, 2, round_to, candidates=ACCT_CHUNKS, **hw_run)
    model = sweep_chunks(s_loc, 2, round_to, candidates=ACCT_CHUNKS)
    say(f"   (a) gloo u8 comm.all_gather, 2 ranks on {device.type}: {ACCT_SIZES[0]} B a rank median "
        f"{lat * 1e6:.1f} us ({ACCT_REPS[0]} x 2 ranks), {ACCT_SIZES[1]} B a rank median "
        f"{big * 1e3:.2f} ms -> {rate / 1e9:.4f} GB/s of ring wire; constants "
        f"COLLECTIVE_LATENCY {A.COLLECTIVE_LATENCY * 1e6:.1f} us, LINK_BW "
        f"{A.LINK_BW / 1e9:.4f} GB/s")
    say(f"   (a) chunked weight gather of qwen3-1.7b's largest DIST shard (s_loc {s_loc:,} fp32 "
        f"a rank, 2 FSDP ranks, round_to {round_to}): measured ms "
        f"{ {c: round(v * 1e3, 2) for c, v in measured.items()} } -> best {best}; modeled ms "
        f"{ {c: round(v * 1e3, 3) for c, v in model.items()} } -> pick_chunks {picked} "
        f"(constants), {picked_run} (this run's rates)")
    out["a"] = {"latency_s": lat, "big_s": big, "link_bw": rate, "measured": measured,
                "best": best, "picked": picked, "picked_run": picked_run, "s_loc": s_loc}

    # (c) the draft's wire at tp 2
    ranks = [o["c"] for o in pair]
    for r, o in enumerate(ranks):
        check(o["streams"] == ranks[0]["streams"], f"rank {r}: streams differ from rank 0's")
        check(o["kinds"].get("draft_prefill") == len(lens) and o["kinds"].get("draft_decode")
              == o["rounds"] * (spec_k + 1), f"rank {r}: wire_log kinds {o['kinds']}")
        check(o["wire"] == o["logged"], f"rank {r}: wire_summary {o['wire']} != comm.LOG "
                                        f"{o['logged']}")
        for k, v in o["priced"].items():
            check(o["wire"].get(k, 0) == v, f"rank {r}: wire_summary {k} "
                                            f"{o['wire'].get(k, 0)} B != wire_tables {v} B")
        for k, v in o["launches"].items():
            out["launches"][k] += v
    say(f"   (c) spec_k {spec_k} with the tiny draft at 1x{TPS_TP}, prompts {list(lens)} "
        f"+{gen}: {ranks[0]['rounds']} rounds, acceptance {ranks[0]['acceptance']:.3f}; "
        f"wire_log kinds {ranks[0]['kinds']}; wire_summary {ranks[0]['wire']} B = comm.LOG = "
        f"wire_tables (priced {ranks[0]['priced']}); (a) and (c) "
        f"{time.perf_counter() - t0:.1f} s")
    out["c"] = {"wire": ranks[0]["wire"], "kinds": ranks[0]["kinds"]}

    # (b) the launcher's rank loop at 2x2, --chunks auto
    t0 = time.perf_counter()
    mesh_cfg = MeshCfg(dp=TP_DP, tp=TP_TP)
    argv = ["--arch", cfg.name, "--mesh", f"{TP_DP}x{TP_TP}", "--steps", str(steps),
            "--policy", f"oracle:{round_to}", "--chunks", "auto", "--batch", str(LM_BATCH),
            "--seq", str(LM_SEQ), "--device", device.type]
    runs = spawn_ranks(_auto_rank, TP_DP * TP_TP, str(device), argv, cfg, threads=threads)
    want_chunks, s_loc_b = chunks_at(cfg, mesh_cfg)
    launches_b = {k: 0 for k in out["launches"]}
    for r, o in enumerate(runs):
        check(o["chunks"] == want_chunks, f"rank {r}: --chunks auto took {o['chunks']}, "
                                          f"pick_chunks gives {want_chunks}")
        for i, (rec, table) in enumerate(zip(o["records"], o["step_tables"], strict=True)):
            got = rec["measured"].get("weights", 0)
            check(got == table["weights"], f"rank {r} step {i}: measured weights {got} B != "
                                           f"step_wire_table {table['weights']} B")
        for k in ("bitpack", "bitunpack", "l2norm_sq"):
            check(o["launches"][k] > 0 or not on_card, f"rank {r}: no {k} launch")
        for k, v in o["launches"].items():
            launches_b[k] += v
            out["launches"][k] += v
    losses = [rec["loss"] for rec in runs[0]["records"]]
    check(all(math.isfinite(x) for x in losses), f"(b) losses {losses}")
    say(f"   (b) launch.train --chunks auto at {TP_DP}x{TP_TP}, {cfg.num_layers} layers: "
        f"chunks {runs[0]['chunks']} (pick_chunks at s_loc {s_loc_b:,}: {want_chunks}); "
        f"weights wire a step {[rec['measured'].get('weights', 0) for rec in runs[0]['records']]}"
        f" B = step_wire_table; losses {losses}; launches over the 4 ranks "
        f"{ {k: v for k, v in launches_b.items() if v} }; "
        f"{time.perf_counter() - t0:.1f} s")
    out["b"] = {"chunks": runs[0]["chunks"], "losses": losses}

    return out


def main() -> int:
    import torch

    say("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    say(smi[0])
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    say(f"   torch {torch.__version__} cuda {torch.version.cuda} on {device_name}")

    from repro_torch import fp32_math
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build

    fp32_math()
    say("phase 2: build")
    t0 = time.perf_counter()
    lib = build.library()
    say(f"   built {', '.join(build.SOURCES)} for sm_90a into "
        f"{os.path.relpath(build.BUILD_DIR, ROOT)} in {time.perf_counter() - t0:.1f} s ({lib._name})")

    say("phase 3: kernels vs plain versions on the card")
    err = check_kernels(torch, device)
    times = time_kernels(torch, device)
    time_qwen3_packing(torch, device)

    say("phase 4: main path — full-width AlexNet A²DTWP training, batch 64")
    run = main_path(torch, device)
    awp, oracle = run["awp"], run["oracle"]
    check(sum(run["elems"]) == ALEXNET_DIST, f"DIST elements {sum(run['elems'])}")
    bits = [(s, b[0]) for s, b in awp.bits_history]
    check(bits == [(0, 8), (3, 16), (5, 24), (7, 32)], f"bits history {awp.bits_history}")
    check(all(len(set(b)) == 1 for _, b in awp.bits_history), "groups widened apart")
    rts = [r.round_tos[0] for r in awp.records + oracle.records]
    check(rts == [1, 1, 1, 2, 2, 3, 3, 4, 2, 2, 2], f"round_to per step {rts}")
    wire = [r.wire_bytes for r in awp.records + oracle.records]
    check(wire[0] == ALEXNET_DIST, f"8-bit step moved {wire[0]} B")
    for r in awp.records + oracle.records:
        say(f"   step {r.step:2d} round_to {r.round_tos[0]} loss {r.loss:.5f} "
            f"wire {r.wire_bytes} B  {r.wall_s * 1e3:.1f} ms"
            f"{'  (first at these formats)' if r.recompiled else ''}")
    warm = [r.wall_s for r in awp.records + oracle.records if not r.recompiled]
    say(f"   AWP bits history {awp.bits_history}")
    say(f"   launches: bitpack {run['launches']['bitpack']}, bitunpack "
        f"{run['launches']['bitunpack']} ({run['n_dist']} packed leaves per step), "
        f"l2norm_sq {run['launches']['l2norm_sq']} ({run['n_monitor']} monitored leaves "
        "per step)")
    say(f"   top-5 error after {len(rts)} steps: {run['top5']:.4f}; fc5 master moved by "
        f"{run['fc5_moved']:.3e} of its norm (lr {run['lr']:g})")
    say(f"   step ms (host clock to the loss sync): median of warm steps "
        f"{sorted(warm)[len(warm) // 2] * 1e3:.2f}, all {[round(r.wall_s * 1e3, 2) for r in awp.records + oracle.records]}")
    say(f"   set-up {run['setup_s']:.2f} s, run {run['run_s']:.2f} s of which batch "
        f"synthesis on the host {run['data_s']:.2f} s")

    say("phase 5: reference — reduced AlexNet on the card vs the CPU")
    reference_check(torch, device)

    say("phase 6: flash prefill kernel vs its plain version on the card")
    flash = check_flash(torch, device)

    say(f"phase 7: main path — full-width qwen3-1.7b served, prompts {list(SERVE_LENS)}, "
        f"+{SERVE_GEN} tokens, {SERVE_SLOTS} slots")
    serve = serve_path(torch, device)
    served = {k: sum(run[k] for run in serve["launches"].values())
              for k in ("bitpack", "bitunpack", "flash_prefill")}
    # what phase 14 holds its meshes to: phase 7's one-device streams and logits
    serve7 = {"cfg": serve["cfg"], "static": serve["static"], "requests": serve["requests"],
              "runs": {"engine": {"first_logits": serve["runs"]["engine"]["first_logits"]}}}
    say(f"   launches over phase 7's three runs: {served}; flash on the main path within "
        f"{serve['flash_err']:.3e} of its plain version")

    say("phase 8: paged decode kernel vs its plain version on the card")
    paged = check_paged(torch, device)

    say(f"phase 9: main path — full-width qwen3-1.7b served through the paged engine, "
        f"page {PAGE}: phase 7's requests, then a {SHARED_PREFIX}-token shared prefix with "
        f"tails {list(SHARED_TAILS)}")
    paged_run = paged_path(torch, device, serve)
    del serve
    for k in served:
        served[k] += paged_run["launches"][k]
    say(f"   launches over phase 9's two runs: {paged_run['launches']}")

    say("phase 10: l2norm kernel vs its plain version on the card")
    l2, l2_err = check_l2norm(torch, device)

    gc.collect()  # phases 7 and 9's weights and engines
    torch.cuda.empty_cache()
    say(f"phase 11: main path — full-width qwen3-1.7b A²DTWP training, batch {LM_BATCH} x "
        f"seq {LM_SEQ}")
    lm = lm_train_path(torch, device)
    bits = [(s, b[0]) for s, b in lm["awp"].bits_history]
    check(bits == [(0, 8), (3, 16), (5, 24), (7, 32)], f"bits history {lm['awp'].bits_history}")
    for k in served:
        served[k] += lm["launches"][k]

    say(f"phase 12: main path — full-width AlexNet A²DTWP training on {DP_RANKS} gloo ranks, "
        f"batch 64 ({64 // DP_RANKS} a rank), steps {[label for label, _ in DP_STEPS]}")
    dp = dp_train_path(torch, device)
    for k in ("bitpack", "bitunpack"):
        served[k] += dp["launches"][k]

    say(f"phase 13: main path — qwen3-1.7b at its widths and {TP_LAYERS} of its layers, FSDP×TP "
        f"training on a {TP_DP}×{TP_TP} mesh "
        f"of gloo ranks, batch {LM_BATCH} ({LM_BATCH // TP_DP} a data rank) x seq {LM_SEQ}, "
        f"steps {[label for label, _ in TP_STEPS]}")
    gc.collect()
    torch.cuda.empty_cache()
    tp = tp_train_path(torch, device, cfg=dataclasses.replace(get_config("qwen3-1.7b"),
                                                              num_layers=TP_LAYERS))
    for k in ("bitpack", "bitunpack"):
        served[k] += tp["launches"][k]

    say(f"phase 14: main path — qwen3-1.7b at its widths and {CUT_LAYERS} of its layers served "
        f"at tp {TPS_TP} on gloo ranks: "
        f"(a) a 1×{TPS_TP} mesh, phase 7's requests, runs {[r['label'] for r in TPS_RUNS_A]}; "
        f"(b) a 2×{TPS_TP} mesh, prompts "
        f"{[len(serve7['requests'][i].prompt_ids) for i in TPS_B_RIDS]} +{TPS_B_GEN} tokens, "
        f"runs {[r['label'] for r in TPS_RUNS_B]}")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"   one device at {CUT_LAYERS} layers (phase 7's runs at this depth), what phases 14-16 "
        "and 18 (b), (c) are held to:")
    cut = serve_path(torch, device, cfg=dataclasses.replace(get_config("qwen3-1.7b"),
                                                            num_layers=CUT_LAYERS))
    for k in served:
        served[k] += sum(run[k] for run in cut["launches"].values())
    serve_cut = {"cfg": cut["cfg"], "static": cut["static"], "requests": cut["requests"],
                 "runs": {"engine": {"first_logits": cut["runs"]["engine"]["first_logits"]}}}
    cut_flash_err = cut["flash_err"]
    del cut
    gc.collect()
    torch.cuda.empty_cache()
    tps = tp_serve_path(torch, device, serve_cut)
    for k in served:
        served[k] += tps["launches"][k]
    say(f"   the kernels at a model rank's shapes at tp {TPS_TP}:")
    time_tp_shapes(torch, device)

    say(f"phase 15: main path — qwen3-1.7b at its widths and {CUT_LAYERS} of its layers served "
        f"with (a) sampled requests "
        f"(seeds {list(FEAT_SEEDS)}), (b) int8 KV, (c) speculative decoding (spec_k "
        f"{FEAT_SPEC_K}, self and tiny drafts), (d) a {FEAT_WINDOW}-token window, (e) sampled "
        f"int8 requests at 1×{TPS_TP} (engine == static but at an int8 tie); {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    feats = features_path(torch, device, serve_cut)
    for k in served:
        served[k] += feats["launches"][k]
    say(f"   launches over phase 15's runs: {feats['launches']}; phase 15 took "
        f"{time.perf_counter() - t15:.1f} s")

    say(f"phase 16: main path — qwen3-1.7b at its widths and {CUT_LAYERS} of its layers, "
        f"training at batch {LM_BATCH} x seq "
        f"{LM_SEQ}: (a) accum_steps 2 against 1, (b) stochastic weights at round_to 2, (c) "
        f"{DP_RANKS} AlexNet ranks with stochastic gradients, (d) bf16 compute; (e) phase 7's "
        f"requests served under a bf16 plan (static, engine, paged engine at page {PAGE}); "
        f"{smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    lmf = lm_features_path(torch, device, cfg=serve_cut["cfg"])
    bfk = check_bf16_kernels(torch, device)
    bfs = bf16_serve_path(torch, device, serve_cut)
    for k in served:
        served[k] += lmf["launches"][k] + bfs["launches"][k]
    say(f"   launches over phase 16's runs: training {lmf['launches']}, bf16 serving "
        f"{bfs['launches']}; phase 16 took {time.perf_counter() - t16:.1f} s")

    say(f"phase 17: main path — training I/O on qwen3-1.7b at its widths and {IO_LAYERS} of its "
        f"layers, batch {LM_BATCH} x seq "
        f"{LM_SEQ}: (a) {IO_RECORDS} shard records through the prefetcher (depth {IO_DEPTH}), "
        f"(b) {IO_STEPS} AWP steps, (c) {IO_SAVE_AT} steps + an async checkpoint + resume, "
        f"(d) the wire-tier serving hand-off; {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    io = io_path(torch, device, cfg=dataclasses.replace(get_config("qwen3-1.7b"),
                                                        num_layers=IO_LAYERS))
    for k in served:
        served[k] += io["launches"][k]

    say(f"phase 18: main path — the mesh finished, qwen3-1.7b: (a) at its widths and {IO_LAYERS} "
        f"of its layers, a {TP_DP}×{TP_TP} mesh training off phase 17's shards, batch {LM_BATCH} x "
        f"seq {LM_SEQ}, with an async checkpoint across ranks, a load and a resume, the export "
        f"served at 2×2; (b) at {CUT_LAYERS} layers phase 15's "
        f"sampled requests at 1×{TPS_TP} through the speculative engine (self and tiny drafts, "
        f"spec_k {FEAT_SPEC_K}); (c) a {FEAT_WINDOW}-token window at 1×{TPS_TP}; {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    mesh18 = mesh_path(torch, device, {
        "requests": serve_cut["requests"],
        "sampled": feats["runs"]["(a) sampled engine"]["streams"],
        "window": feats["runs"]["(d) window engine"]["streams"]}, cfg=serve_cut["cfg"],
        a_layers=IO_LAYERS)
    for k in served:
        served[k] += mesh18["launches"][k]

    say(f"phase 19: main path — qwen3-1.7b at its widths and {CUT_LAYERS} of its layers served "
        f"by the fleet at page {PAGE}, "
        f"{FLEET_REPLICAS} replicas of {SERVE_SLOTS} slots and {FLEET_WORKERS} prefill workers: "
        f"(a) phase 7's requests at v0 (seed 0), a v1 (seed 1) refresh after "
        f"{FLEET_REFRESH_AT} results with phase 9's shared-prefix trio, a join and a leave; "
        f"(b) int8 KV; (c) phase 15 (a)'s sampled requests; {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    fleet19 = fleet_path(torch, device, {
        "requests": serve_cut["requests"], "static": serve_cut["static"],
        "sampled": feats["runs"]["(a) sampled engine"]["streams"],
        "int8": feats["runs"]["(b) int8 paged engine"]["streams"]}, cfg=serve_cut["cfg"])
    for k in served:
        served[k] += fleet19["launches"][k]

    say(f"phase 20: main path — the MoE family and the dense variants at their widths: (a) "
        f"chatglm3-6b at its 28 layers served (static, engine, paged engine at page {PAGE}; "
        f"G 16), (b) qwen2.5-14b at {CUT_LAYERS} of its 48 layers with seeded QKV biases "
        f"(static, paged engine; G 5), (c) mixtral-8x7b at {CUT_LAYERS} of its 32 layers "
        f"(static request by request, the windowed engine), (d) mixtral-8x7b at "
        f"{ARCH_TRAIN_LAYERS} layers in A²DTWP training, batch {LM_BATCH} x seq {LM_SEQ}; "
        f"phase 7's requests; {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    archs = archs_path(torch, device)
    for k in served:
        served[k] += archs["launches"][k]
    say(f"   phase 20 took {time.perf_counter() - t20:.1f} s on {smi[0]}")

    say(f"phase 21: main path — the recurrent families at their widths: (a) xlstm-1.3b at its "
        f"48 layers served (static, engine; prompts {list(REC_LENS)} +{REC_GEN} tokens), one "
        f"prefill chunkwise (chunk {REC_CHUNK}); (b) xlstm-1.3b at {REC_TRAIN_LAYERS} layers in "
        f"A²DTWP training, batch {REC_TRAIN_BATCH} x seq {LM_SEQ}, {REC_TRAIN_STEPS} steps, mlstm_chunk {REC_CHUNK}; (c) "
        f"recurrentgemma-9b at {RG_LAYERS} of its 38 layers served (static, engine); (d) "
        f"xlstm-1.3b at {REC_MESH_LAYERS} layers on a 1×{TPS_TP} mesh; {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    rec21 = recurrent_path(torch, device)
    for k in served:
        served[k] += rec21["launches"][k]
    say(f"   phase 21 took {time.perf_counter() - t21:.1f} s on {smi[0]}")

    say(f"phase 22: main path — vision cross-attention and the audio encoder at their widths: "
        f"(a) llama-3.2-vision-90b at {VLM_LAYERS} of its 100 layers served on the static path "
        f"(cross gates from seed {VLM_GATE_SEED}; phase 7's requests, 0 and 1 on one prompt, "
        f"each with 4,096 image tokens of width 1,280); (b) hubert-xlarge at its 48 layers in "
        f"A²DTWP training, batch {AUDIO_BATCH} x {AUDIO_SEQ} frames, {AUDIO_STEPS} steps; {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    vis22 = vision_path(torch, device)
    for k in served:
        served[k] += vis22["launches"][k]
    say(f"   phase 22 took {time.perf_counter() - t22:.1f} s on {smi[0]}")

    say(f"phase 23: accounting and tooling at {CUT_LAYERS} of qwen3-1.7b's layers: (a) the gloo "
        f"all-gather's latency and rate and a chunked weight gather at chunks "
        f"{list(ACCT_CHUNKS)} (2 ranks), (b) launch.train --chunks auto at {TP_DP}x{TP_TP} for "
        f"{ACCT_STEPS} steps, (c) spec_k {FEAT_SPEC_K} with the tiny draft at 1x{TPS_TP}; the "
        f"first MFU; {smi[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    # the MFU's FLOP count runs on fake tensors in a thread while the ranks run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        mfu_job = pool.submit(mfu_line, torch, lm["cfg"], lm["batch"], lm["seq"],
                              lm["warm_step_s"])
        acct = accounting_path(torch, device)
        model_flops, counted, mfu = mfu_job.result()
    for k in served:
        served[k] += acct["launches"][k]
    say(f"   MFU of phase 11's step (full-width qwen3-1.7b, fp32, batch {lm['batch']} x seq "
        f"{lm['seq']}, oracle:2, remat on): model_flops_estimate {model_flops:.4e} FLOP / "
        f"median warm step {lm['warm_step_s'] * 1e3:.2f} ms / PEAK_FLOPS_FP32 67e12 = "
        f"{mfu:.4f}; count_flops of the same step {counted:.4e} FLOP "
        f"({counted / model_flops:.3f}x the estimate); {smi[0]}")
    say(f"   phase 23 took {time.perf_counter() - t23:.1f} s on {smi[0]}")

    kernels = []
    for name, src, replaces in (
        ("bitpack", "src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/bitpack.py:52"),
        ("bitunpack", "src/repro_torch/csrc/bitunpack.cu", "src/repro/kernels/bitunpack.py:30"),
    ):
        t = times[(name, 2)]  # fc5 at round_to=2 (bf16), the oracle:2 format
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": run["launches"][name] + served[name], "max_abs_err": float(err[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
    f512 = flash[512]
    kernels.append({
        "name": "flash_prefill", "route": "cuda", "source": "src/repro_torch/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:110",
        "launches": served["flash_prefill"],
        "max_abs_err": max(f512["max_abs_err"], cut_flash_err, tps["errs"]["flash"],
                           feats["flash_err"], io["flash_err"], mesh18["flash_err"],
                           fleet19["flash_err"], archs["flash_err"], vis22["flash_err"],
                           flash["G 5"]["max_abs_err"], flash["G 16"]["max_abs_err"],
                           flash["G 8"]["max_abs_err"]),
        "ms": f512["ms"], "plain_ms": f512["plain_ms"], "bound_ms": f512["bound_ms"],
        "bound_by": f512["bound_by"], "library_ms": f512["library_ms"],
    })
    pm = paged["main path"]  # no single PyTorch call reads through a page table
    kernels.append({
        "name": "paged_attend", "route": "cuda", "source": "src/repro_torch/csrc/paged_attend.cu",
        "replaces": "src/repro/kernels/paged_attention.py:98",
        "launches": (paged_run["launches"]["paged_attend"] + tps["launches"]["paged_attend"]
                     + feats["launches"]["paged_attend"] + fleet19["launches"]["paged_attend"]
                     + archs["launches"]["paged_attend"] + rec21["launches"]["paged_attend"]),
        "max_abs_err": max(paged["max_abs_err"], paged_run["paged_err"], tps["errs"]["paged"],
                           feats["paged_err"], fleet19["paged_err"], archs["paged_err"]),
        "ms": pm["ms"], "plain_ms": pm["plain_ms"], "bound_ms": pm["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
    })
    t = l2[QWEN3_EMBED]  # the main path's largest monitored leaf
    kernels.append({
        "name": "l2norm_sq", "route": "cuda", "source": "src/repro_torch/csrc/l2norm.cu",
        "replaces": "src/repro/kernels/l2norm.py:31",
        "launches": (run["launches"]["l2norm_sq"] + lm["launches"]["l2norm_sq"]
                     + dp["launches"]["l2norm_sq"] + tp["launches"]["l2norm_sq"]
                     + lmf["launches"]["l2norm_sq"] + io["launches"]["l2norm_sq"]
                     + mesh18["launches"]["l2norm_sq"] + archs["launches"]["l2norm_sq"]
                     + rec21["launches"]["l2norm_sq"] + vis22["launches"]["l2norm_sq"]
                     + acct["launches"]["l2norm_sq"]),
        "max_abs_err": max(l2_err, lm["monitor_err"], tp["monitor_err"], io["monitor_err"],
                           mesh18["monitor_err"], archs["monitor_err"], rec21["monitor_err"],
                           vis22["monitor_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["library_ms"],
    })
    kernels.append({
        "name": "flash_prefill_bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_prefill_bf16.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:110",
        "launches": bfs["launches"]["flash_prefill_bf16"],
        "max_abs_err": max(bfk["flash_err"], bfs["errs"]["flash"]),
        "ms": bfk["flash"]["ms"], "plain_ms": bfk["flash"]["plain_ms"],
        "bound_ms": bfk["flash"]["bound_ms"], "bound_by": bfk["flash"]["bound_by"],
        "library_ms": bfk["flash"]["library_ms"],
    })
    kernels.append({
        "name": "paged_attend_bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attend.cu",
        "replaces": "src/repro/kernels/paged_attention.py:98",
        "launches": bfs["launches"]["paged_attend_bf16"],
        "max_abs_err": max(bfk["paged_err"], bfs["errs"]["paged"]),
        "ms": bfk["paged"]["ms"], "plain_ms": bfk["paged"]["plain_ms"],
        "bound_ms": bfk["paged"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call reads through a page table
    })
    say(f"   script: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
